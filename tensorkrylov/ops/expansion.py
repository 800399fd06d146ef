"""Exact-EFT f32 expansion arithmetic — certified solves on hardware whose
f64 is emulated or slow.

Where f64 elementwise ops are emulated, their rounding (~2^-47 relative)
sets an arithmetic floor for the Lanczos recurrence at cancellation events.
Native f32 ops are IEEE round-to-nearest, and the classical error-free
transformations (TwoSum, Dekker TwoProd) hold EXACTLY op by op, so f32
expansions carry the recurrence below that floor.

Compilers can rewrite composed EFT chains: they may keep f32 intermediates
at excess precision, drop a rounding f64 → f32 → f64 convert pair (XLA:GPU
does inside fusions unless the program is compiled with
ops/precision.EXACT_ROUNDING), or contract mul+add into an FMA (GPU code
generators do; the mask-based split in two_prod is immune to it). The
solver therefore treats the effective elementwise epsilon as a MEASURED
per-backend quantity (`eft_selfcheck`, run in-process and recorded as
certificate evidence), never an exactness assumption.

Representation: a value x is an unevaluated sum hi + md + lo of f32 arrays,
|md| <= ulp(hi), |lo| <= ulp(md) after renormalization (a "triple", eps ~
2^-71 relative). Pairs (hi, md) are the 48-bit storage format of the df64
basis (deflate.py); triples are the recurrence carry.

Every algorithm below is textbook (Knuth TwoSum, Dekker split/TwoProd,
Priest/Shewchuk renormalization) — implemented on jnp f32 so XLA vectorizes
them; no Pallas needed (elementwise chains fuse).

Reference provenance: the reference runs plain CPU f64
(/root/reference/src/orthogonal_bases.jl:39-67) and never needed this; the
capability it preserves is "certify 1e-9-class solves" on hardware without
native f64.
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .precision import EXACT_ROUNDING

__all__ = [
    "Triple", "two_sum", "two_prod", "renorm3", "triple_from_f64",
    "triple_to_f64", "pair_from_f64", "triple_add", "triple_add_pair_prod",
    "triple_scale_pair", "triple_sub_f64", "triple_scale_f64",
    "triple_round_pair", "eft_selfcheck", "triple_neg", "triple_sub",
    "pair_scale_f64", "triple_spmv_pairs",
]


class Triple(NamedTuple):
    """Unevaluated f32 sum hi + md + lo (~2^-71 relative after renorm3)."""

    hi: jax.Array
    md: jax.Array
    lo: jax.Array


_SHIELD_ON = os.environ.get("TK_EFT_SHIELD", "0") == "1"


def _shield(*xs):
    """(Optionally) fence operands against compiler rewrites of the EFT
    chains. Barriers fragment each expansion chain into many kernels with
    forced (d, n) materializations, and the XLA CPU pipeline drops them
    outright; the certificate consumes the measured per-backend epsilon
    from eft_selfcheck instead. Barriers are therefore OFF by default; set
    TK_EFT_SHIELD=1 to re-enable for compiler-behavior experiments."""
    if not _SHIELD_ON:
        return xs if len(xs) > 1 else xs[0]
    out = jax.lax.optimization_barrier(xs)
    return out if len(xs) > 1 else out[0]


def two_sum(a, b):
    """Knuth TwoSum: s + e == a + b EXACTLY. Every intermediate can be
    fenced with an optimization barrier (see _shield) against a compiler
    that reassociates the error path."""
    a, b = _shield(a, b)
    s = _shield(a + b)
    bb = _shield(s - a)
    t1 = _shield(s - bb)
    t2 = _shield(a - t1)
    t3 = _shield(b - bb)
    e = t2 + t3
    return s, e


def _fast_two_sum(a, b):
    """Dekker FastTwoSum — exact when |a| >= |b| (used post-ordering)."""
    a, b = _shield(a, b)
    s = _shield(a + b)
    e = b - _shield(s - a)
    return s, e


_SPLIT_MASK = np.uint32(0xFFFFF000)  # keeps sign, exponent, 11+1 mantissa bits


def _split(a):
    """a == hi + lo EXACTLY with hi and lo of at most 12 significant bits
    each, by truncating the mantissa with a bit mask. Unlike Veltkamp's
    `c - (c - a)` with c = 4097·a, no product enters the split, so a
    compiler that contracts mul+sub into an FMA (GPU code generators do)
    cannot change it."""
    bits = jax.lax.bitcast_convert_type(a, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(bits & _SPLIT_MASK, jnp.float32)
    return hi, _shield(a - hi)


def two_prod(a, b):
    """Dekker TwoProd: p + e == a * b EXACTLY (no FMA required). Every
    intermediate of the error term is exact, so FMA contraction of its
    mul+add pairs cannot change it either; p is shielded so downstream
    adds cannot contract through it."""
    a, b = _shield(a, b)
    p = _shield(a * b)
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((_shield(ah * bh) - p) + ah * bl + al * bh) + al * bl
    p, e = _shield(p, e)
    return p, e


def renorm3(c0, c1, c2, c3=None):
    """Renormalize 3 (or 4) unordered components into a canonical Triple.

    Bottom-up TwoSum distillation (exact) followed by a top-down
    canonicalization. Error model: the result equals the exact input sum to
    within ~2^-72 of the LARGEST component (absolute) — equivalently 2^-71
    relative except under catastrophic cancellation of the inputs, where
    the absolute model is the meaningful one (and is exactly what the
    solver's eta bound consumes)."""
    if c3 is not None:
        c2, t3 = two_sum(c2, c3)
    else:
        t3 = None
    t1, r2 = two_sum(c1, c2)
    t0, r1 = two_sum(c0, t1)
    # value == t0 + r1 + r2 (+ t3) exactly; |r1| <= ulp(t0)
    hi, u = _fast_two_sum(t0, r1)
    rest = r2 if t3 is None else r2 + t3
    md, lo = two_sum(u, rest)
    hi, md = _fast_two_sum(hi, md)
    md, lo = _fast_two_sum(md, lo)
    return Triple(hi, md, lo)


def triple_from_f64(x) -> Triple:
    """Exact f64 -> Triple (f64 has 53 bits; three f32 carry up to 72)."""
    hi = x.astype(jnp.float32)
    r = x - hi.astype(x.dtype)
    md = r.astype(jnp.float32)
    lo = (r - md.astype(x.dtype)).astype(jnp.float32)
    return Triple(hi, md, lo)


def triple_to_f64(t: Triple):
    """Value to f64 (exact pairwise sums in f64 — 53-bit result)."""
    return (t.lo.astype(jnp.float64) + t.md.astype(jnp.float64)
            + t.hi.astype(jnp.float64))


def pair_from_f64(x) -> Tuple[jax.Array, jax.Array]:
    """f64 -> (hi, lo) f32 pair (48-bit; the df64 storage format)."""
    hi = x.astype(jnp.float32)
    lo = (x - hi.astype(x.dtype)).astype(jnp.float32)
    return hi, lo


def triple_add(a: Triple, b: Triple) -> Triple:
    """a + b, both triples -> renormalized triple (error ~2^-71 of result)."""
    # merge component-wise by magnitude order hi>md>lo, then distill
    s0, e0 = two_sum(a.hi, b.hi)
    s1, e1 = two_sum(a.md, b.md)
    s2 = a.lo + b.lo
    # fold: s0 + (s1+e0) + (s2+e1)
    t1, f1 = two_sum(s1, e0)
    t2 = (s2 + e1) + f1
    return renorm3(s0, t1, t2)


def triple_add_pair_prod(z: Triple, ah, al, bh, bl, sign=1.0) -> Triple:
    """z + sign * (ah+al)*(bh+bl) for f32 pairs — the recurrence's
    band-times-vector workhorse. The three significant cross products are
    expanded exactly (TwoProd); the al*bl term (~2^-48 of the product) is
    added in plain f32 (its own rounding is ~2^-72 of the product)."""
    sg = jnp.float32(sign)
    p0, e0 = two_prod(ah, bh)
    p1, e1 = two_prod(ah, bl)
    p2, e2 = two_prod(al, bh)
    tail = al * bl + e1 + e2
    # accumulate into z: z + sg*(p0 + (p1+p2+e0) + tail)
    s0, f0 = two_sum(z.hi, sg * p0)
    m1, g1 = two_sum(p1, p2)
    m2, g2 = two_sum(m1, e0)
    s1, f1 = two_sum(z.md, sg * m2)
    s2 = z.lo + sg * (tail + g1 + g2)
    t1, h1 = two_sum(s1, f0)
    t2 = s2 + f1 + h1
    return renorm3(s0, t1, t2)


def triple_scale_pair(v: Triple, sh, sl) -> Triple:
    """v * (sh + sl) for a scalar (or broadcastable) f32 pair."""
    p0, e0 = two_prod(v.hi, sh)
    p1, e1 = two_prod(v.hi, sl)
    p2, e2 = two_prod(v.md, sh)
    tail = v.md * sl + v.lo * sh + e1 + e2
    m1, g1 = two_sum(p1, p2)
    m2, g2 = two_sum(m1, e0)
    return renorm3(p0, m2, tail + g1 + g2)


def triple_sub_f64(z: Triple, x) -> Triple:
    """z - x where x is an f64 array (e.g. a GEMM-computed correction).
    x is split exactly into a triple first, so nothing of x is lost."""
    t = triple_from_f64(-x)
    return triple_add(z, t)


def triple_scale_f64(v: Triple, s) -> Triple:
    """v * s for an f64 scalar, split EXACTLY into three f32 components
    (a 48-bit pair split of s would drop 2^-48 * |s| * |v| — measurably
    short of f64; the third component st rides in the tail at full f32
    rate since its contribution is already ~2^-48 of the product)."""
    sh = s.astype(jnp.float32)
    r = s - sh.astype(s.dtype)
    sl = r.astype(jnp.float32)
    st = (r - sl.astype(s.dtype)).astype(jnp.float32)
    p0, e0 = two_prod(v.hi, sh)
    p1, e1 = two_prod(v.hi, sl)
    p2, e2 = two_prod(v.md, sh)
    tail = v.md * sl + v.lo * sh + e1 + e2 + v.hi * st
    m1, g1 = two_sum(p1, p2)
    m2, g2 = two_sum(m1, e0)
    return renorm3(p0, m2, tail + g1 + g2)


def triple_neg(t: Triple) -> Triple:
    return Triple(-t.hi, -t.md, -t.lo)


def triple_sub(a: Triple, b: Triple) -> Triple:
    return triple_add(a, triple_neg(b))


def pair_scale_f64(vh, vl, s) -> Triple:
    """(vh + vl) * s for an f32 pair and an f64 scalar (broadcastable) —
    the beta*v_prev / alpha*v terms of the recurrence. s split exactly into
    three f32 components; all significant cross products expanded."""
    sh = s.astype(jnp.float32)
    r = s - sh.astype(s.dtype)
    sl = r.astype(jnp.float32)
    st = (r - sl.astype(s.dtype)).astype(jnp.float32)
    p0, e0 = two_prod(vh, sh)
    p1, e1 = two_prod(vh, sl)
    p2, e2 = two_prod(vl, sh)
    tail = vl * sl + e1 + e2 + vh * st
    m1, g1 = two_sum(p1, p2)
    m2, g2 = two_sum(m1, e0)
    return renorm3(p0, m2, tail + g1 + g2)


def _shift(v, off: int):
    """Circular shift matching ops/banded.spmv's convention (out-of-range
    band entries are stored as zeros, so wrapped lanes multiply to zero)."""
    if off == 0:
        return v
    return jnp.roll(v, -off, axis=-1)


def triple_spmv_pairs(bands_h, bands_l, offsets, vh, vl) -> Triple:
    """A @ v in expansion arithmetic: bands and v both f32 pairs (exact
    48-bit operand values), result a Triple. Mirrors ops/banded.spmv's
    shift-multiply-accumulate over (d, nb, n) bands and (d, n) v, with
    every product expanded error-free — the elementwise noise that set the
    r3 flagship's eps*lambda_max/beta floor simply never enters."""
    d, nb, n = bands_h.shape
    z = Triple(jnp.zeros_like(vh), jnp.zeros_like(vh), jnp.zeros_like(vh))
    for b, off in enumerate(offsets):
        vsh = _shift(vh, off)
        vsl = _shift(vl, off)
        z = triple_add_pair_prod(z, bands_h[:, b], bands_l[:, b], vsh, vsl)
    return z


def eft_selfcheck(n: int = 4096, seed: int = 0) -> dict:
    """Measure EFT exactness of THIS backend on composed patterns.

    Compilers can silently break error-free transformations in ways that
    per-op tests miss (excess precision inside fusions, dropped convert
    pairs, FMA contraction; see tests/test_expansion.py). The programs here
    compile with EXACT_ROUNDING like the solver's. The solver MEASURES the
    property at runtime and records it as certificate evidence instead of
    assuming it. Returns max defects (0.0 = exact) for: standalone TwoSum/
    TwoProd, and the composed pair-product accumulate that the recurrence
    actually executes. Keys: 'two_sum', 'two_prod', 'composed_acc_rel'."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n).astype(np.float32)
    b = (rng.standard_normal(n) * 1e-6).astype(np.float32)
    jit = functools.partial(jax.jit, compiler_options=EXACT_ROUNDING)
    s, e = jit(two_sum)(jnp.asarray(a), jnp.asarray(b))
    d_sum = float(np.max(np.abs(
        (np.asarray(s, np.float64) + np.asarray(e, np.float64))
        - (a.astype(np.float64) + b.astype(np.float64)))))
    p, e2 = jit(two_prod)(jnp.asarray(a), jnp.asarray(b))
    d_prod = float(np.max(np.abs(
        (np.asarray(p, np.float64) + np.asarray(e2, np.float64))
        - a.astype(np.float64) * b.astype(np.float64))))

    av = rng.standard_normal(n) * 1e5
    bv = rng.standard_normal(n)
    z0 = rng.standard_normal(n)

    def g(z, x, y):
        xh, xl = pair_from_f64(x)
        yh, yl = pair_from_f64(y)
        return triple_add_pair_prod(triple_from_f64(z), xh, xl, yh, yl)

    t = jit(g)(jnp.asarray(z0), jnp.asarray(av), jnp.asarray(bv))
    ld = np.longdouble
    xh = np.float32(av); xl = np.float32(av - np.float64(xh))
    yh = np.float32(bv); yl = np.float32(bv - np.float64(yh))
    ex_ = z0.astype(ld) + (xh.astype(ld) + xl.astype(ld)) * (
        yh.astype(ld) + yl.astype(ld))
    got = (np.asarray(t.hi, ld) + np.asarray(t.md, ld)
           + np.asarray(t.lo, ld))
    scale = np.maximum(np.abs(ex_ - z0.astype(ld)), np.abs(z0)).astype(ld)
    d_acc = float(np.max(np.abs(got - ex_) / scale))
    return {"two_sum": d_sum, "two_prod": d_prod, "composed_acc_rel": d_acc}


def triple_round_pair(v: Triple):
    """Triple -> storage pair (hi, md') plus the dropped f64 remainder
    norm input: returns ((hi, md'), dropped) where dropped = lo' as f64 —
    the EXACT per-element storage rounding (hi + md' + dropped == value)."""
    hi, t = _fast_two_sum(v.hi, v.md)
    md, lo = _fast_two_sum(t, v.lo)
    hi2, md2 = _fast_two_sum(hi, md)
    return (hi2, md2), lo.astype(jnp.float64)
