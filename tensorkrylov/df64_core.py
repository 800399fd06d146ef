"""storage='df64' v2 core — the noise-RECORDING expansion Lanczos.

Split out of deflate.py (VERDICT r4 #8). The recurrence kernel
(_df64_advance), the full-Gram evidence chunks, the device-final assembly
chunks, and the recorded-relation host evaluation live here; the
solve_deflated driver (deflate.py) orchestrates them. See _Df64State and
the DESIGN.md r4 addendum for the design.

Every f32 contraction here pins precision=HIGHEST: the 3-product pair GEMMs
assume exact f32 products, which a TF32 dot (the GPU default for f32
operands) would silently break.
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .ops.orth import bdot
from .ops.precision import EXACT_ROUNDING, einsum

_EFT_EPS_CACHE: dict = {}


def _eft_eps() -> float:
    """Measured composed-EFT elementwise epsilon of the CURRENT backend
    (ops/expansion.eft_selfcheck), x4 safety, floored at the algorithmic
    2^-71. Cached per backend per process; recorded on results."""
    be = jax.default_backend()
    if be not in _EFT_EPS_CACHE:
        from .ops.expansion import eft_selfcheck

        chk = eft_selfcheck()
        _EFT_EPS_CACHE[be] = max(float(chk["composed_acc_rel"]), 2.0 ** -71) * 4.0
    return _EFT_EPS_CACHE[be]


# columns per chunk of the df64 sweeps: chunked fori bodies bound the
# temporaries of each f32-operand, f64-output pair GEMM to O(C·d·n)
_DF64_SWEEP_COLS = 16


def _split32(x):
    """f64 → (hi, lo) f32 pair: hi = fl32(x), lo = fl32(x − hi). Represents
    x to ~48 bits (rel. 7e-15) as two f32 arrays."""
    hi = x.astype(jnp.float32)
    lo = (x - hi.astype(x.dtype)).astype(jnp.float32)
    return hi, lo


class _Df64State(NamedTuple):
    """storage='df64' v2 state — the noise-RECORDING expansion Lanczos.

    Design: on hardware without native f64, the recurrence noise of an
    emulated-f64 Lanczos is removed from the vectors by the per-step full
    reorthogonalization but never seen by the projected tridiagonal. v2
    makes the bookkeeping exact instead of fighting the noise:

      * the recurrence runs in f32-EXPANSION arithmetic (ops/expansion.py:
        triples inside the step; the elementwise error is measured at
        runtime by eft_selfcheck), with the basis CARRIED as the
        stored 48-bit pair — so "stored column" and "recurrence operand"
        are the same exact value and storage rounding never enters the
        relation;
      * every sweep coefficient (W), deflation-projection coefficient (C)
        and commit deviation (dev_k = ‖z − β_k v_k^stored‖) is RECORDED.
        The exact relation per step is then
          A v_{k-1} = V w + U c + α v_{k-1} + β_{k-1} v_{k-2}
                      + β_k v_k + dev_vec − η,
        with η only the expansion arithmetic's elementwise rounding. The
        projected solve inverts the PERTURBED per-factor matrices
        (T + W is still a Kronecker-sum factor!) so W and C leave the
        error budget entirely; dev and η enter the certificate as a
        measured/modeled term (see _evaluate_host_recorded).

    All big buffers are f32 (no X64-split jit-boundary tax); the f64
    arrays are k-sized."""

    dg: jax.Array      # (d, K) f64
    od: jax.Array      # (d, K) f64
    btil: jax.Array    # (d, K) f64 — drift telemetry (RHS uses β₀ e₀)
    vp_h: jax.Array    # (d, n) f32  v_{k-1} (stored-pair carry)
    vp_l: jax.Array    # (d, n) f32
    vq_h: jax.Array    # (d, n) f32  v_{k-2}
    vq_l: jax.Array    # (d, n) f32
    beta: jax.Array    # (d,) f64
    leak: jax.Array    # () f64 max pre-projection |Uᵀz|/‖z‖
    sweep_overlap: jax.Array  # () f64 max pre-sweep |⟨z, v_j⟩|/‖z‖
    Vh: jax.Array      # (Kp*d, n) f32 basis pair, k-major rows
    Vl: jax.Array      # (Kp*d, n) f32
    W: jax.Array       # (d, Kp, Kp) f32 — W[s, j, k-1] = sweep coeff of
    #                    column j recorded at step k (relation column k-1)
    C: jax.Array       # (d, m, Kp) f32 — projection coeffs at step k
    dev: jax.Array     # (d, K) f64 — ‖z − β_k v_k^stored‖₂ per step


@functools.partial(
    jax.jit, donate_argnums=(3,), compiler_options=EXACT_ROUNDING,
    static_argnames=("offsets", "S", "project_every", "sweep_every"),
)
def _df64_advance(bands_h, bands_l, offsets, state: _Df64State, b_perp,
                  Uh, Ul, k0, S: int = 32, project_every: int = 1,
                  sweep_every: int = 1):
    """Run S full-reorth recording steps k0..k0+S-1 in ONE device call.

    One call per S steps keeps per-call dispatch out of the step time. The
    sweep/projection chunking lives inside fori_loops, so the largest
    pair-GEMM temporary stays bounded."""
    from .ops import expansion as ex

    d, n = state.vp_h.shape
    m_ = Uh.shape[-1]   # U pair: (n, m) shared or (d, n, m) distinct
    Kp = state.W.shape[1]
    C_ = _DF64_SWEEP_COLS
    nch_max = state.Vh.shape[0] // (C_ * d)
    # projection chunk width: the serial fori over m/Cm tall-skinny GEMMs
    # dominates the step at large m; a wider chunk trades temporary memory
    # (O(n·Cm)) for fewer, better-shaped GEMMs. Env-tunable so a benchmark
    # can A/B it without changing the default HLO (the persistent compile
    # cache keys on HLO).
    Cm = min(m_, int(os.environ.get("TK_DF64_PROJ_CHUNK", "128")))
    while m_ % Cm:
        # non-dividing chunks would clamp the dynamic_slice and project
        # the tail columns twice — halve down to a divisor
        Cm //= 2
    nchm = m_ // Cm
    pdt = state.dg.dtype
    eye_d = jnp.eye(d, dtype=pdt)

    def body(i, st: _Df64State) -> _Df64State:
        k = k0 + jnp.asarray(i, jnp.int32)
        z32 = jnp.zeros((), jnp.int32)
        # ---- expansion recurrence core (elementwise; triple headroom) ----
        z = ex.triple_spmv_pairs(bands_h, bands_l, offsets, st.vp_h, st.vp_l)
        z = ex.triple_sub(
            z, ex.pair_scale_f64(st.vq_h, st.vq_l, st.beta[:, None]))
        zf = ex.triple_to_f64(z)
        vpf = st.vp_h.astype(pdt) + st.vp_l.astype(pdt)
        alpha = bdot(zf, vpf, pdt)
        z = ex.triple_sub(
            z, ex.pair_scale_f64(st.vp_h, st.vp_l, alpha[:, None]))

        # ---- deflation projection (recorded coefficients) ----
        def do_proj(z):
            zf = ex.triple_to_f64(z)
            un = jnp.sqrt(bdot(zf, zf, pdt))
            cbuf = jnp.zeros((d, m_), pdt)
            wmax = jnp.zeros((d,), pdt)

            def pbody(ci, carry):
                z, cbuf, wmax = carry
                c0 = ci * Cm
                zf = ex.triple_to_f64(z)
                zh, zl = _split32(zf)
                if Uh.ndim == 2:     # shared deflation basis (n, m)
                    Uhc = lax.dynamic_slice(Uh, (0, c0), (n, Cm))
                    Ulc = lax.dynamic_slice(Ul, (0, c0), (n, Cm))
                    w = (einsum("nm,dn->dm", Uhc, zh, preferred_element_type=pdt)
                         + einsum("nm,dn->dm", Uhc, zl, preferred_element_type=pdt)
                         + einsum("nm,dn->dm", Ulc, zh, preferred_element_type=pdt))
                    wh, wl = _split32(w)
                    corr = (einsum("nm,dm->dn", Uhc, wh, preferred_element_type=pdt)
                            + einsum("nm,dm->dn", Uhc, wl, preferred_element_type=pdt)
                            + einsum("nm,dm->dn", Ulc, wh, preferred_element_type=pdt))
                else:                # distinct factors: U (d, n, m) (r5, VERDICT r4 #6)
                    Uhc = lax.dynamic_slice(Uh, (0, 0, c0), (d, n, Cm))
                    Ulc = lax.dynamic_slice(Ul, (0, 0, c0), (d, n, Cm))
                    w = (einsum("dnm,dn->dm", Uhc, zh, preferred_element_type=pdt)
                         + einsum("dnm,dn->dm", Uhc, zl, preferred_element_type=pdt)
                         + einsum("dnm,dn->dm", Ulc, zh, preferred_element_type=pdt))
                    wh, wl = _split32(w)
                    corr = (einsum("dnm,dm->dn", Uhc, wh, preferred_element_type=pdt)
                            + einsum("dnm,dm->dn", Uhc, wl, preferred_element_type=pdt)
                            + einsum("dnm,dm->dn", Ulc, wh, preferred_element_type=pdt))
                z = ex.triple_sub_f64(z, corr)
                cbuf = lax.dynamic_update_slice(
                    cbuf, w, (z32, jnp.asarray(ci * Cm, jnp.int32)))
                return (z, cbuf, jnp.maximum(wmax, jnp.max(jnp.abs(w), axis=1)))

            z, cbuf, wmax = lax.fori_loop(0, nchm, pbody, (z, cbuf, wmax))
            return z, cbuf, jnp.max(wmax / (un + 1e-300))

        if project_every > 1:
            z, cvec, leak = lax.cond(
                k % project_every == 0, do_proj,
                lambda z: (z, jnp.zeros((d, m_), pdt), jnp.zeros((), pdt)), z)
        else:
            z, cvec, leak = do_proj(z)

        # ---- CGS sweep vs stored columns < k (recorded; optionally
        # strided — the recording keeps the relation exact either way, so
        # striding trades measured Gram slack for the dominant pair-GEMM
        # traffic at large k; see solve_deflated's sweep_every) ----
        def do_sweep(z):
            zf = ex.triple_to_f64(z)
            un = jnp.sqrt(bdot(zf, zf, pdt))
            zh0, zl0 = _split32(zf)
            nch = jnp.minimum(
                jnp.asarray((k + C_ - 1) // C_, jnp.int32), nch_max)

            def wbody(ci, w):
                ci = jnp.asarray(ci, jnp.int32)
                r0 = ci * (C_ * d)
                Vhc = lax.dynamic_slice(st.Vh, (r0, z32), (C_ * d, n))
                Vlc = lax.dynamic_slice(st.Vl, (r0, z32), (C_ * d, n))
                full = (einsum("Kn,dn->Kd", Vhc, zh0, preferred_element_type=pdt)
                        + einsum("Kn,dn->Kd", Vhc, zl0, preferred_element_type=pdt)
                        + einsum("Kn,dn->Kd", Vlc, zh0, preferred_element_type=pdt))
                wc = jnp.einsum("kid,id->ki", full.reshape(C_, d, d), eye_d)
                return lax.dynamic_update_slice(w, wc, (ci * C_, z32))

            w = lax.fori_loop(0, nch, wbody,
                              jnp.zeros((nch_max * C_, d), pdt))
            w = w * (jnp.arange(nch_max * C_)[:, None] < k).astype(pdt)
            overlap = jnp.max(jnp.max(jnp.abs(w), axis=0) / (un + 1e-300))
            wh, wl = _split32(w)

            def cbody(ci, corr):
                ci = jnp.asarray(ci, jnp.int32)
                r0 = ci * (C_ * d)
                Vhc = lax.dynamic_slice(st.Vh, (r0, z32), (C_ * d, n))
                Vlc = lax.dynamic_slice(st.Vl, (r0, z32), (C_ * d, n))
                whc = lax.dynamic_slice(wh, (ci * C_, z32), (C_, d))
                wlc = lax.dynamic_slice(wl, (ci * C_, z32), (C_, d))
                Wh_full = (whc[:, :, None] * eye_d).reshape(C_ * d, d).astype(jnp.float32)
                Wl_full = (wlc[:, :, None] * eye_d).reshape(C_ * d, d).astype(jnp.float32)
                return corr + (
                    einsum("Kn,Kd->dn", Vhc, Wh_full, preferred_element_type=pdt)
                    + einsum("Kn,Kd->dn", Vhc, Wl_full, preferred_element_type=pdt)
                    + einsum("Kn,Kd->dn", Vlc, Wh_full, preferred_element_type=pdt))

            corr = lax.fori_loop(0, nch, cbody, jnp.zeros((d, n), pdt))
            return ex.triple_sub_f64(z, corr), w, overlap

        if sweep_every > 1:
            z, w, overlap = lax.cond(
                k % sweep_every == 0, do_sweep,
                lambda z: (z, jnp.zeros((nch_max * C_, d), pdt),
                           jnp.zeros((), pdt)), z)
        else:
            z, w, overlap = do_sweep(z)

        # ---- β, breakdown guard, commit (recorded deviation) ----
        zf = ex.triple_to_f64(z)
        beta_sq = bdot(zf, zf, pdt)
        ub = bdot(zf, b_perp, pdt)
        beta_new = jnp.sqrt(jnp.maximum(beta_sq, 0.0))
        lucky = beta_new < 256.0 * jnp.finfo(pdt).eps * (
            jnp.abs(alpha) + st.beta + 1e-300)
        beta_new = jnp.where(lucky, 0.0, beta_new)
        safe = jnp.where(beta_new > 0, beta_new, 1.0)
        v_new = ex.triple_scale_f64(z, (1.0 / safe)[:, None])
        (vh2, vl2), _ = ex.triple_round_pair(v_new)
        vh2 = jnp.where(lucky[:, None], jnp.float32(0), vh2)
        vl2 = jnp.where(lucky[:, None], jnp.float32(0), vl2)
        # exact commit deviation: z − β·(stored pair), in expansion arith
        devv = ex.triple_sub(
            z, ex.pair_scale_f64(vh2, vl2, beta_new[:, None]))
        devf = ex.triple_to_f64(devv)
        dev_k = jnp.sqrt(bdot(devf, devf, pdt))

        Vh = lax.dynamic_update_slice(st.Vh, vh2, (k * d, z32))
        Vl = lax.dynamic_update_slice(st.Vl, vl2, (k * d, z32))
        dg = lax.dynamic_update_slice(st.dg, alpha[:, None], (z32, k - 1))
        od = lax.dynamic_update_slice(st.od, beta_new[:, None], (z32, k))
        btil = lax.dynamic_update_slice(st.btil, (ub / safe)[:, None], (z32, k))
        dev = lax.dynamic_update_slice(st.dev, dev_k[:, None], (z32, k))
        W = lax.dynamic_update_slice(
            st.W, w[:Kp].T[:, :, None].astype(jnp.float32), (z32, z32, k - 1))
        Cb = lax.dynamic_update_slice(
            st.C, cvec[:, :, None].astype(jnp.float32), (z32, z32, k - 1))
        return _Df64State(dg, od, btil, vh2, vl2, st.vp_h, st.vp_l, beta_new,
                          jnp.maximum(st.leak, leak),
                          jnp.maximum(st.sweep_overlap, overlap),
                          Vh, Vl, W, Cb, dev)

    return lax.fori_loop(0, S, body, state)


@functools.partial(jax.jit, static_argnames=("d", "rows"),
                   compiler_options=EXACT_ROUNDING)
def _df64_gram_row_chunk(Vh, Vl, r0, k, d: int, rows: int = _DF64_SWEEP_COLS):
    """max |(VᵀV − I)[rows r0..r0+C·d)| against ALL columns — one bounded
    device call; the host-chunked outer loop keeps each call short instead
    of one monolithic double-fori call over the whole basis."""
    pdt = jnp.float64
    C_ = rows
    total_rows = Vh.shape[0]
    n = Vh.shape[1]
    nch = total_rows // (_DF64_SWEEP_COLS * d)
    z32 = jnp.zeros((), jnp.int32)
    r0 = jnp.minimum(r0, jnp.asarray(total_rows - C_ * d, jnp.int32))
    Ah = lax.dynamic_slice(Vh, (r0, z32), (C_ * d, n))
    Al = lax.dynamic_slice(Vl, (r0, z32), (C_ * d, n))

    Cb = _DF64_SWEEP_COLS
    def inner(cj, acc):
        r1 = jnp.asarray(cj * (Cb * d), jnp.int32)
        Bh = lax.dynamic_slice(Vh, (r1, z32), (Cb * d, n))
        Bl = lax.dynamic_slice(Vl, (r1, z32), (Cb * d, n))
        G = (einsum("an,bn->ab", Ah, Bh, preferred_element_type=pdt)
             + einsum("an,bn->ab", Ah, Bl, preferred_element_type=pdt)
             + einsum("an,bn->ab", Al, Bh, preferred_element_type=pdt)
             + einsum("an,bn->ab", Al, Bl, preferred_element_type=pdt))
        ia = r0 + jnp.arange(C_ * d)
        jb = r1 + jnp.arange(Cb * d)
        same_s = (ia[:, None] % d) == (jb[None, :] % d)
        active = ((ia[:, None] // d) < k) & ((jb[None, :] // d) < k) & same_s
        dev = jnp.abs(G - (ia[:, None] == jb[None, :]).astype(pdt))
        return jnp.maximum(acc, jnp.max(jnp.where(active, dev, 0.0)))

    return lax.fori_loop(0, nch, inner, jnp.zeros((), pdt))


def _df64_gram_deviation_host(Vh, Vl, k: int, d: int) -> float:
    """Full-basis max|VᵀV − I| via bounded row-chunk calls (host loop).
    Row width 2x the sweep chunk: halves the call count (each call reads
    the full active basis)."""
    C_ = min(2 * _DF64_SWEEP_COLS, Vh.shape[0] // d)
    nch = -(-Vh.shape[0] // (C_ * d))
    dev = 0.0
    kk = jnp.asarray(k, jnp.int32)
    done = 0
    try:
        for ci in range(nch):
            if ci * C_ >= k:
                break
            v = _df64_gram_row_chunk(
                Vh, Vl, jnp.asarray(ci * C_ * d, jnp.int32), kk, d, rows=C_)
            jax.block_until_ready(v)
            dev = max(dev, float(v))
            done = ci + 1
    except jax.errors.JaxRuntimeError as e:
        # a device fault mid-measurement must not lose the SOLVE: return
        # the partial maximum (still genuine evidence over `done` chunks)
        print(f"[gram] device fault after {done}/{nch} row chunks "
              f"({type(e).__name__}) — partial measurement kept", flush=True)
    return dev


@functools.partial(jax.jit, donate_argnums=(0,), static_argnames=("rows",),
                   compiler_options=EXACT_ROUNDING)
def _df64_assemble_chunk(acc, Vh, Vl, r0, Ych, Ycl, rows: int):
    """acc (d, n, t) f64 += Σ_k V_pair[k, s, :]·Yv_pair[s, k, t] over one
    row chunk of the stored basis. All big operands enter as f32; the
    3-product pair GEMM accumulates in f64 (~7.5e-15 relative, given exact
    f32 products). Part of the final='device' assembly that replaces the
    host basis pull (~4 GB at flagship size)."""
    d, n, t = acc.shape
    f64 = jnp.float64
    z32 = jnp.zeros((), jnp.int32)
    Vhc = lax.dynamic_slice(Vh, (r0, z32), (rows * d, n)).reshape(rows, d, n)
    Vlc = lax.dynamic_slice(Vl, (r0, z32), (rows * d, n)).reshape(rows, d, n)
    acc = acc + (
        einsum("kdn,dkt->dnt", Vhc, Ych, preferred_element_type=f64)
        + einsum("kdn,dkt->dnt", Vhc, Ycl, preferred_element_type=f64)
        + einsum("kdn,dkt->dnt", Vlc, Ych, preferred_element_type=f64))
    return acc


@functools.partial(jax.jit, donate_argnums=(0,),
                   compiler_options=EXACT_ROUNDING)
def _df64_ulift_chunk(acc, Uhc, Ulc, Yuh, Yul):
    """acc (d, n, t) f64 += U_pair[:, chunk]·Yu_pair[d, chunk, t] — U chunk
    (n, m) shared or (d, n, m) distinct; same 3-product pair form as
    _df64_assemble_chunk."""
    f64 = jnp.float64
    spec = "nm,dmt->dnt" if Uhc.ndim == 2 else "dnm,dmt->dnt"
    acc = acc + (
        einsum(spec, Uhc, Yuh, preferred_element_type=f64)
        + einsum(spec, Uhc, Yul, preferred_element_type=f64)
        + einsum(spec, Ulc, Yuh, preferred_element_type=f64))
    return acc


def _evaluate_host_recorded(dg, od, btil, beta, k, lam, c, b_norm, lam_min,
                            omega, alpha, t_mask, W, Cm, dev, b0_norms,
                            dev0, eps_elem, lam_gersh_f, gram_dev,
                            frechet: bool = True):
    """Host evaluation for the v2 (noise-recording) df64 solve.

    The projected per-factor operator is the RECORDED perturbed matrix

        H~_s = [[Lambda_s, C_s], [0, T_s + W_s]]

    (still a Kronecker-sum factor — the sweep/projection coefficients are
    per-factor, so the exp-sum inverts the recorded operator at the SAME
    CP rank; the r3 flagship's 9.8e-6 unrecorded-sweep gap does not exist
    in this formulation). The solve applies exp(-gamma H~_s) via the exact
    symmetric eigendecomposition of T plus a first-order Frechet
    correction in (W, C) with an explicit second-order remainder charged
    to the certificate (r2_term; (gamma rho)^2-scale — negligible at the
    measured noise levels but accounted).

    Returns (rel_estimate, boundary_rel_sq, Yu, Yv, weights, components)
    where components is the certificate decomposition:
      sup        — analytic exp-sum sup|1 - x g(x)| on [1, kappa] (passed
                   in by the caller via components later; 0.0 here)
      boundary   — sqrt(sum beta^2 ||y_L||^2)/||b|| (measured, positive)
      dev_term   — the recorded commit deviations' triangle bound
      eta_term   — expansion-arithmetic elementwise noise triangle bound
                   (eps_elem MEASURED in-process by eft_selfcheck)
      r2_term    — second-order Frechet remainder bound
      rho        — max_s ||[C_s; W_s]||_F (perturbation magnitude evidence)
    All Gram contractions run in longdouble (~1e-19 floor, DESIGN.md §6).

    Behavioural reference for the residual algebra:
    /root/reference/src/utils.jl:255-324,402-443."""
    from scipy.linalg import eigh_tridiagonal

    ld = np.longdouble
    d, K = dg.shape
    m = lam.shape[1]
    tmax = omega.shape[0]
    act = np.flatnonzero(t_mask > 0)
    t = act.size
    gam = alpha[act] / lam_min                                  # (t,)
    w_t = (omega[act] / lam_min)                                # (t,)

    Yv_k = np.zeros((d, k, t))
    Zv_k = np.zeros((d, k, t))
    Yu_k = np.zeros((d, m, t))
    Zu_k = np.zeros((d, m, t))
    rho = 0.0
    for s in range(d):
        T_w, Q = eigh_tridiagonal(dg[s, :k], od[s, 1:k])
        Ws = np.asarray(W[s, :k, :k], np.float64)
        Cs = np.asarray(Cm[s, :, :k], np.float64)
        # SPECTRAL norm of the recorded perturbation [C_s; W_s]: the
        # second-order Frechet remainder is bounded by the operator
        # 2-norm, not Frobenius. At flagship scale the distinction is the
        # certificate: ||P||_F = 5.6e-3 vs sigma_max = 1.3e-3 measured at
        # k=400 (C entries are lambda_max*2^-48-scale — irreducible with
        # 48-bit pair storage — so the r2 charge must be tight, r5).
        rho_s = float(np.linalg.svd(np.vstack([Cs, Ws]),
                                    compute_uv=False)[0])
        rho = max(rho, rho_s)
        g = Q.T[:, 0] * b0_norms[s]                             # Qᵀ(β₀e₀)
        Wt = Q.T @ Ws @ Q                                       # (k, k)
        Ct = Cs @ Q                                             # (m, k)
        ex = np.exp(-np.clip(T_w[:, None] * gam[None, :], -700.0, 700.0))
        Yv0 = Q @ (ex * g[:, None])                             # (k, t)
        ex_u = np.exp(-np.clip(lam[s][:, None] * gam[None, :], -700.0, 700.0))
        Yu0 = ex_u * c[s][:, None]                              # (m, t)
        dYv = np.zeros((k, t))
        dYu = np.zeros((m, t))
        # divided differences from the PRECOMPUTED exponentials (ex, ex_u):
        # the naive per-(j, pair) exp evaluation costs m*k*t exps — minutes
        # of host time per flagship checkpoint. The separated
        # form needs only the (k+m)*t exps already computed; the small-gap
        # branch falls back to the stable sinhc form per pair.
        if frechet:
            # GEMM-separated divided differences: with Gw = M_pert ∘ g-row,
            #   Σ_l Gw[i,l]·(ex[i,j] − ex[l,j])/dT[i,l]
            #     = ex[i,j]·rowsum(Gw/dT)[i] − (Gw/dT) @ ex
            # — two dense GEMMs over ALL exp-sum terms at once instead of a
            # k²-temp per term (the per-term loop was ~1 min of host time per
            # flagship checkpoint). Phi multiplies the TINY
            # recorded perturbation, so the direct quotient's cancellation
            # error (~eps/|γ·dT| relative) is harmless for all but (near-)
            # coincident pairs, which are patched with the sinhc limit.
            dT = T_w[:, None] - T_w[None, :]
            dU = lam[s][:, None] - T_w[None, :]
            scale_T = np.abs(T_w).max() + 1.0
            Gw = Wt * g[None, :]
            deg = np.abs(dT) < 1e-8 * scale_T             # incl. the diagonal
            M = np.where(deg, 0.0, Gw) / np.where(deg, 1.0, dT)
            dYv_c = ex * M.sum(axis=1)[:, None] - M @ ex  # (k, t)
            # (near-)degenerate pairs: phi -> -γ·sqrt(ex_i·ex_l)·sinhc
            for i, l in zip(*np.nonzero(deg)):
                h = 0.5 * gam * (T_w[i] - T_w[l])
                dYv_c[i] += Gw[i, l] * (-gam * np.sqrt(ex[i] * ex[l])
                                        * (1.0 + h * h / 6.0))
            dYv = Q @ dYv_c
            Gu = Ct * g[None, :]
            degU = np.abs(dU) < 1e-8 * scale_T
            MU = np.where(degU, 0.0, Gu) / np.where(degU, 1.0, dU)
            dYu = ex_u * MU.sum(axis=1)[:, None] - MU @ ex
            for i, l in zip(*np.nonzero(degU)):
                h = 0.5 * gam * (lam[s][i] - T_w[l])
                dYu[i] += Gu[i, l] * (-gam * np.sqrt(ex_u[i] * ex[l])
                                      * (1.0 + h * h / 6.0))
        Yv_k[s] = Yv0 + dYv
        Yu_k[s] = Yu0 + dYu
        # Z = H~ Y with the FULL recorded relation
        Tf = np.zeros((k, k))
        idx = np.arange(k)
        Tf[idx, idx] = dg[s, :k]
        Tf[idx[1:], idx[1:] - 1] = od[s, 1:k]
        Tf[idx[1:] - 1, idx[1:]] = od[s, 1:k]
        Zv_k[s] = (Tf + Ws) @ Yv_k[s]
        Zu_k[s] = lam[s][:, None] * Yu_k[s] + Cs @ Yv_k[s]

    # ---- longdouble Gram algebra over the joint factors ----
    Y = np.concatenate([Yu_k, Yv_k], axis=1)                    # (d, m+k, t)
    Z = np.concatenate([Zu_k, Zv_k], axis=1)
    bt = np.zeros((d, m + k))
    bt[:, :m] = c
    bt[:, m] = b0_norms                                         # β₀ e₀
    Gy = np.einsum("dpi,dpj->dij", Y, Y).astype(ld)
    Gz = np.einsum("dpi,dpj->dij", Z, Z).astype(ld)
    Xg = np.einsum("dpi,dpj->dij", Y, Z).astype(ld)
    yb = np.einsum("dpi,dp->di", Y, bt).astype(ld)
    zb = np.einsum("dpi,dp->di", Z, bt).astype(ld)
    b2 = np.prod(np.einsum("dp,dp->d", bt, bt).astype(ld))
    wl = np.asarray(w_t, ld)

    hy2 = ld(0.0)
    for s in range(d):
        for sp in range(d):
            P = np.ones((t, t), ld)
            for mo in range(d):
                if mo == s and mo == sp:
                    P *= Gz[mo]
                elif mo == s:
                    P *= Xg[mo].T
                elif mo == sp:
                    P *= Xg[mo]
                else:
                    P *= Gy[mo]
            hy2 += wl @ P @ wl
    ip = ld(0.0)
    for s in range(d):
        P = np.ones((t,), ld)
        for mo in range(d):
            P *= zb[mo] if mo == s else yb[mo]
        ip += wl @ P
    r_comp_sq = hy2 - 2.0 * ip + b2

    yr = Yv_k[:, k - 1, :].astype(ld)
    boundary = ld(0.0)
    for s in range(d):
        E = np.ones((t, t), ld)
        for mo in range(d):
            if mo != s:
                E *= Gy[mo]
        bg = np.outer(yr[s], yr[s]) * ld(beta[s]) ** 2
        boundary += wl @ (bg * E) @ wl
    boundary = float(boundary)

    # ---- relation-error terms (dev measured; eta from measured eps) ----
    # per-step bounds b_k on the unrecorded relation error ||e_k||:
    #   dev[s, k]                     measured commit deviation (exact)
    #   8*eps_elem*(lam_g + |a| + b)  expansion elementwise rounding
    #   2^-24*(||w||_1 + ||c||_1)     f32 rounding of the RECORDED W, C
    kk = np.arange(1, k + 1)
    absW1 = np.abs(np.asarray(W[:, :, :k], np.float64)).sum(axis=1)  # (d, k)
    absC1 = np.abs(np.asarray(Cm[:, :, :k], np.float64)).sum(axis=1)
    eta_hat = (8.0 * eps_elem
               * (lam_gersh_f[:, None] + np.abs(dg[:, :k]) + od[:, kk - 1]
                  + od[:, kk])
               + 2.0 ** -24 * (absW1 + absC1))                  # (d, k)
    dev_b = dev[:, 1 : k + 1]                                   # (d, k)
    # RHS-side representation term: b⊥_s = β₀ v₀ + dev0_s (host split,
    # eps64-grade) — charged relative to each factor's own b⊥ norm
    b0_term = float(np.sum(dev0 / np.maximum(b0_norms, 1e-300)))
    # column norms of Y per mode (for the off-mode products), with the
    # measured Gram slack of the stored basis folded in multiplicatively
    slack = float(np.sqrt(1.0 + min(k, 1e9) * max(gram_dev, 0.0)))
    # per-mode column norms ||y_i||_r from the joint Gram diagonals
    ynorm = np.sqrt(np.maximum(
        np.einsum("dii->di", np.asarray(Gy, np.float64)), 0.0))  # (d, t)
    off_prod = np.ones((d, t))
    for s in range(d):
        for r in range(d):
            if r != s:
                off_prod[s] *= ynorm[r] * slack

    def tri_term(bmat):
        tot = 0.0
        for s in range(d):
            Dsi = np.abs(Yv_k[s]).T @ bmat[s]                   # (t,) via (k,t)ᵀ(k,)
            tot += float(np.sum(np.abs(w_t) * Dsi * off_prod[s]))
        return tot

    dev_term = tri_term(dev_b) * slack / b_norm + b0_term
    eta_term = tri_term(eta_hat) * slack / b_norm
    # Second-order Frechet remainder (r5 tightening — the r4 form
    # d*lambda_max_tot*sum w (gam*rho_F)^2/2 floored the flagship bound at
    # ~7.6e-7). Derivation: the computed x keeps per-factor corrected
    # columns Y_s = (exp + DF_s) b~_s, so the only representation error is
    # the per-factor exp remainder R_s^t with ||R_s^t||_2 <=
    # (gam_t*rho_2)^2/2 * e^{gam_t*rho_2} (rho_2 = SPECTRAL norm of the
    # recorded [C_s; W_s]). The residual charge is ||A * sum_s R_s (x)
    # others||: the mode-s'' factor of A hits
    #   s'' = s   : ||A_s R_s^t||       <= lam_max_s * ||R_s^t||
    #   s'' != s  : ||A_s'' E_s''^t||   <= sup_l l*e^{-gam_t l} +
    #               perturbation slack  =  1/(e*gam_t)
    #               + lam_max_s''*gam_t*rho_2*e^{gam_t*rho_2}
    # so per factor s the multiplier is lam_max_s + sum_{s''!=s}(...)
    # instead of d*lam_max_tot — at d=10 flagship scale a ~100x tighter,
    # still fully rigorous envelope (PSD factors, Gershgorin lam_max_s).
    # s''=s term: ||A_s R_s^t|| via the heat-kernel smoothing argument —
    # R = gam^2 ∫₀¹∫₀^u e^{-gam(1-u)S} P e^{-gam(u-v)S} P e^{-gam v(S+P)},
    # ||A e^{-gam(1-u)S}|| <= min(lam_max, 1/(e*gam*(1-u))); splitting the
    # u-integral at delta = 1/(e*gam*lam_max) gives
    #   ||A_s R_s^t|| <= gam*rho^2*(1 + ln(e*gam*lam_s))/e * e^{gam*rho}
    # (min'd with the direct lam_s*(gam*rho)^2/2 bound — both rigorous).
    # s''!=s term: ||A_s'' E_s''|| <= 1/(e*gam) + ||A(DF+R)|| with the
    # same smoothing on DF: gam*rho*(1+ln(e*gam*lam))/e * e^{gam*rho}.
    gr = gam * rho                                      # (t,), rho = max_s
    egr = np.exp(np.minimum(gr, 50.0))
    R_t = 0.5 * gr * gr * egr                           # ||R_s^t|| bound
    r2_term = 0.0
    for s in range(d):
        Ls = 1.0 + np.log(np.maximum(np.e * gam * lam_gersh_f[s], 1.0))
        AR_s = np.minimum(lam_gersh_f[s] * R_t,
                          gam * rho * rho * Ls / np.e * egr)
        off = np.zeros_like(gam)
        for sp in range(d):
            if sp == s:
                continue
            Lsp = 1.0 + np.log(np.maximum(np.e * gam * lam_gersh_f[sp], 1.0))
            off += (1.0 / (np.e * gam)
                    + gam * rho * Lsp / np.e * egr * (1.0 + 0.5 * gr * egr))
        r2_term += float(np.sum(w_t * (AR_s + off * R_t)))

    rel = float(np.sqrt(boundary + max(float(r_comp_sq), 0.0))) / b_norm
    brs = boundary / (b_norm * b_norm)

    Yv = np.zeros((d, K, tmax))
    Yu = np.zeros((d, m, tmax))
    Yv[:, :k, act] = Yv_k
    Yu[:, :, act] = Yu_k
    weights = np.zeros((tmax,))
    weights[act] = w_t
    components = {
        "boundary": float(np.sqrt(max(boundary, 0.0))) / b_norm,
        "dev_term": dev_term,
        "eta_term": eta_term,
        "r2_term": r2_term,
        "rho": float(rho),
        "gram_dev": float(gram_dev),
        "eps_elem": float(eps_elem),
    }
    return rel, brs, Yu, Yv, weights, components


