"""f32 expansion arithmetic (ops/expansion.py) vs numpy longdouble oracles.

These run on CPU (conftest) where f32 ops are IEEE; on the GPU the same
exactness is measured by eft_selfcheck in chip_smoke.py's phase 4."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tensorkrylov.ops import expansion as ex

ld = np.longdouble
rng = np.random.default_rng(42)


def _tval(t):
    """Triple -> longdouble value (exact)."""
    return (np.asarray(t.hi, ld) + np.asarray(t.md, ld) + np.asarray(t.lo, ld))


def test_two_sum_two_prod_exact():
    a = rng.standard_normal(4096).astype(np.float32)
    b = (rng.standard_normal(4096) * 1e-5).astype(np.float32)
    s, e = jax.jit(ex.two_sum)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(s, np.float64) + np.asarray(e, np.float64),
        a.astype(np.float64) + b.astype(np.float64))
    p, e2 = jax.jit(ex.two_prod)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(p, np.float64) + np.asarray(e2, np.float64),
        a.astype(np.float64) * b.astype(np.float64))


def test_triple_roundtrip_f64():
    x = rng.standard_normal(1000) * np.exp(rng.uniform(-30, 30, 1000))
    t = ex.triple_from_f64(jnp.asarray(x))
    back = np.asarray(ex.triple_to_f64(t))
    np.testing.assert_array_equal(back, x)   # f64 fits in 3 f32s exactly


def test_triple_add_relerr():
    x = rng.standard_normal(2000)
    y = rng.standard_normal(2000)
    t = jax.jit(lambda a, b: ex.triple_add(
        ex.triple_from_f64(a), ex.triple_from_f64(b)))(
        jnp.asarray(x), jnp.asarray(y))
    exact = x.astype(ld) + y.astype(ld)
    err = np.abs(_tval(t) - exact)
    scale = np.maximum(np.abs(x), np.abs(y)).astype(ld)
    assert float(np.max(err / scale)) < 2.0**-70


def test_triple_add_cancellation():
    """(big + tiny) - big recovers tiny to ~2^-71 of BIG (the eta model):
    far beyond f64, which loses tiny entirely at 2^-52 of big."""
    big = np.exp(rng.uniform(0, 10, 1000))
    tiny = rng.standard_normal(1000) * 1e-18
    f = jax.jit(lambda b, t: ex.triple_add(
        ex.triple_add(ex.triple_from_f64(b), ex.triple_from_f64(t)),
        ex.triple_from_f64(-b)))
    t = f(jnp.asarray(big), jnp.asarray(tiny))
    err = np.abs(_tval(t) - tiny.astype(ld))
    assert float(np.max(err / big)) < 2.0**-70


def test_pair_prod_accumulate():
    """z + (a_pair)*(b_pair) — the SpMV workhorse — to ~2^-70 of |a*b|."""
    a = rng.standard_normal(2000) * 1e5
    b = rng.standard_normal(2000)
    z0 = rng.standard_normal(2000)

    def f(z, av, bv):
        ah, al = ex.pair_from_f64(av)
        bh, bl = ex.pair_from_f64(bv)
        return ex.triple_add_pair_prod(ex.triple_from_f64(z), ah, al, bh, bl)

    t = jax.jit(f)(jnp.asarray(z0), jnp.asarray(a), jnp.asarray(b))
    # oracle: z + round48(a)*round48(b) — the pair values are the operands
    ah, al = np.float32(a), np.float32(a - np.float64(np.float32(a)))
    bh, bl = np.float32(b), np.float32(b - np.float64(np.float32(b)))
    av = ah.astype(ld) + al.astype(ld)
    bv = bh.astype(ld) + bl.astype(ld)
    exact = z0.astype(ld) + av * bv
    scale = np.maximum(np.abs(av * bv), np.abs(z0)).astype(ld) + 1e-300
    # threshold = max(2^-69, ~2 eps_longdouble): the 80-bit oracle's own
    # product rounding (1.1e-19) is the measurement floor here
    assert float(np.max(np.abs(_tval(t) - exact) / scale)) < 2.5e-19


def test_triple_scale_and_sub():
    v = rng.standard_normal(1000)
    s = np.float64(3.14159e3)
    c = rng.standard_normal(1000) * 1e-8

    def f(vv, cc):
        t = ex.triple_scale_f64(ex.triple_from_f64(vv), jnp.asarray(s))
        return ex.triple_sub_f64(t, cc)

    exact = v.astype(ld) * ld(s) - c.astype(ld)
    scale = np.abs(v.astype(ld) * ld(s)) + np.abs(c)
    # eager: the ALGORITHM is exact to the longdouble oracle's floor
    te = f(jnp.asarray(v), jnp.asarray(c))
    assert float(np.max(np.abs(_tval(te) - exact) / scale)) < 2.5e-19
    # jit: this CPU jaxlib evaluates f32 chains at f64 excess precision
    # (measured, unfixable by flags/barriers) — still >= pair-grade. Each
    # backend's composed accuracy is measured by eft_selfcheck.
    tj = jax.jit(f)(jnp.asarray(v), jnp.asarray(c))
    assert float(np.max(np.abs(_tval(tj) - exact) / scale)) < 1e-14


def test_round_pair_exact_remainder():
    """triple_round_pair: hi + md + dropped == value EXACTLY, and (hi, md)
    is a 48-bit representation (dropped <= 2^-47 of value)."""
    x = rng.standard_normal(1000) * np.exp(rng.uniform(-10, 10, 1000))
    t = ex.triple_from_f64(jnp.asarray(x))
    (hi, md), dropped = jax.jit(ex.triple_round_pair)(t)
    recon = (np.asarray(hi, ld) + np.asarray(md, ld)
             + np.asarray(dropped, ld))
    np.testing.assert_array_equal(np.asarray(recon, np.float64), x)
    assert float(np.max(np.abs(np.asarray(dropped)) / np.abs(x))) < 2.0**-46


def test_triple_spmv_pairs_vs_dense():
    """Expansion SpMV vs longdouble dense oracle on a random tridiag."""
    import tensorkrylov as tk

    op = tk.laplace(2, 64, shift=3.0)
    bands = np.asarray(op.bands, np.float64)
    bh = bands.astype(np.float32)
    bl = (bands - bh.astype(np.float64)).astype(np.float32)
    v = rng.standard_normal((2, 64))
    vh = v.astype(np.float32)
    vl = (v - vh.astype(np.float64)).astype(np.float32)
    t = jax.jit(lambda B, L, H, W: ex.triple_spmv_pairs(B, L, op.offsets, H, W))(
        jnp.asarray(bh), jnp.asarray(bl), jnp.asarray(vh), jnp.asarray(vl))
    # oracle: dense matvec of the PAIR-valued operator on the PAIR-valued v
    bv = bh.astype(ld) + bl.astype(ld)
    vv = vh.astype(ld) + vl.astype(ld)
    out = np.zeros((2, 64), ld)
    n = 64
    for bidx, off in enumerate(op.offsets):
        col = bv[:, bidx, :]
        if off == 0:
            out += col * vv
        elif off > 0:
            out[:, : n - off] += col[:, : n - off] * vv[:, off:]
        else:
            out[:, -off:] += col[:, -off:] * vv[:, : n + off]
    got = _tval(t)
    scale = np.max(np.abs(out)) + 1.0
    assert float(np.max(np.abs(got - out) / scale)) < 1e-18


def test_pair_scale_f64():
    v = rng.standard_normal(500) * 1e4
    vh = v.astype(np.float32)
    vl = (v - vh.astype(np.float64)).astype(np.float32)
    s = np.float64(-1.7320508075688772e2)
    exact = (vh.astype(ld) + vl.astype(ld)) * ld(s)
    # eager exact; jit bounded by the CPU backend's excess-precision floor
    te = ex.pair_scale_f64(jnp.asarray(vh), jnp.asarray(vl), jnp.asarray(s))
    assert float(np.max(np.abs(_tval(te) - exact) / np.abs(exact))) < 2.5e-19
    tj = jax.jit(lambda a, b: ex.pair_scale_f64(a, b, jnp.asarray(s)))(
        jnp.asarray(vh), jnp.asarray(vl))
    assert float(np.max(np.abs(_tval(tj) - exact) / np.abs(exact))) < 1e-14
