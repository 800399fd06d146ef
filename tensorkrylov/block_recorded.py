"""Noise-RECORDING block Krylov for rank-R tensor-product RHS (r5).

Port of the df64 v2 recording design (deflate.py, DESIGN.md r4 addendum)
to the block recurrence. On hardware without native f64, the plain
`solve_block` path's true residual floors at the emulated-f64 dot-noise
scale, because its basis/coefficients carry dot noise that the projected
solve never sees. Recording that noise makes the certificate hold there.
Every f32 contraction pins precision=HIGHEST: the pair products assume
exact f32 products, which a TF32 dot would silently break.

Design (same contract as storage='df64'):
  * the block recurrence runs in f32-EXPANSION arithmetic
    (ops/expansion.py; elementwise error measured by eft_selfcheck), the
    basis is CARRIED as the stored f32 hi/lo pair, so "stored column" and
    "recurrence operand" are the same exact value;
  * every CGS coefficient is RECORDED exactly as applied (the f64 sum of
    the applied f32 split pair), giving the exact per-column relation
        A_s v_c = Σ_j H_s[j, c] v_j + dev_c − η_c,
    with dev measured exactly in expansion arithmetic and η only the
    elementwise rounding;
  * the projected solve inverts the RECORDED per-factor matrices: the
    symmetric part S_s = sym(H_s) by exact host eigendecomposition, the
    (tiny, recorded) asymmetric defect E_s = H_s − S_s by a first-order
    Frechet correction with an explicit second-order remainder charged to
    the certificate — exactly the W-treatment of
    deflate._evaluate_host_recorded, with E in place of W;
  * host-DRIVEN segment loop: S block steps per jitted device call
    instead of the plain path's monolithic while_loop, so the per-segment
    graph is small, compiles quickly and is reused.

The RHS representation is recorded too: the R start vectors are
orthonormalized among themselves in expansion arithmetic (a recorded QR),
so b_r = Σ_j Rfac[j, r] v_j + dev0 exactly — the projected RHS is the
recorded Rfac, not an orthonormality-conditional V^T b.

Behavioural reference for the block algebra: block generalization of
Kressner–Tobler as in block.py; residual algebra reference
/root/reference/src/utils.jl:255-324 (Lemma 3.4), block boundary as in
ops/gram.py:residual_norm_sq.
"""
from __future__ import annotations

import dataclasses
import functools
import time as _time
from typing import List, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .coeffs.tables import BHTables, load_tables, select_bh
from .deflate import (
    _DF64_SWEEP_COLS,
    _df64_assemble_chunk,
    _df64_gram_deviation_host,
    _eft_eps,
    _gershgorin_per_factor,
    expsum_sup_error,
)
from .ops.orth import bdot
from .types import CPTensor, KroneckerSumOperator, SolverConfig, Status
from .ops.precision import EXACT_ROUNDING, einsum

__all__ = ["solve_block_recorded", "BlockRecordedResult"]


@dataclasses.dataclass(frozen=True)
class BlockRecordedResult:
    """Result of the recording block solve (mirrors DeflatedResult)."""

    x: Optional[CPTensor]
    status: int
    niterations: int            # block iterations (columns = niterations·R)
    R: int
    relative_residual: List[float]
    certified_bound: List[float]
    checkpoints: List[int]
    expsum_sup: float
    expsum_rank: int
    lambda_min: float
    lambda_max: float
    measured_cp_residual: Optional[float] = None
    cp_residual_floor: Optional[float] = None
    sweep_overlap: Optional[float] = None
    gram_deviation: Optional[float] = None
    relation_dev_term: Optional[float] = None
    relation_eta_term: Optional[float] = None
    relation_r2_term: Optional[float] = None
    perturbation_rho: Optional[float] = None
    eft_eps_measured: Optional[float] = None
    converged: bool = False


class _BlockRecState(NamedTuple):
    """Device state of the recording block recurrence. All big buffers are
    f32 pairs (no X64-split jit-boundary tax); H/btil/dev are column-sized
    f64 (exact records)."""

    H: jax.Array       # (d, Kp, Kp) f64 — H[s, j, c] = recorded coefficient
    #                    of column j in the relation for A·v (column c);
    #                    rows <= c+R populated (block upper Hessenberg)
    btil: jax.Array    # (d, R, R) f64 — recorded QR factor of the start
    #                    block (b_r = Σ_j btil[s, j, r] v_j + dev0)
    dev: jax.Array     # (d, Kp) f64 — exact commit deviation per column
    dev0: jax.Array    # (d, R) f64 — start-block representation deviation
    Vh: jax.Array      # (Kp·d, n) f32 basis pair, column-major rows
    Vl: jax.Array      # (Kp·d, n) f32
    sweep_overlap: jax.Array   # () f64 — max pre-(2nd)-sweep overlap
    eta_w: jax.Array   # (d, Kp) f64 — Σ|applied coefficients| per column
    #                    (the η model's ||H_col||_1, incl. both CGS passes)
    C: jax.Array       # (d, m, Kp) f64 — recorded deflation-projection
    #                    coefficients per relation column (m = 0 when the
    #                    solve is undeflated; zero-size arrays are free)


def _sweep_pair(Vh, Vl, z, kc, nch_max, d, pdt):
    """One CGS pass of the expansion vector z (triple, (d, n)) against the
    stored pair columns < kc. Returns (z_corrected, w (Kp, d) f64 applied
    coefficients = exact f32-split sums, overlap telemetry). Chunked like
    deflate._df64_advance's do_sweep (bounded pair-GEMM temps)."""
    from .ops import expansion as ex

    C_ = _DF64_SWEEP_COLS
    n = Vh.shape[1]
    eye_d = jnp.eye(d, dtype=pdt)
    z32 = jnp.zeros((), jnp.int32)
    zf = ex.triple_to_f64(z)
    un = jnp.sqrt(bdot(zf, zf, pdt))
    zh0 = zf.astype(jnp.float32)
    zl0 = (zf - zh0.astype(pdt)).astype(jnp.float32)
    nch = jnp.minimum(jnp.asarray((kc + C_ - 1) // C_, jnp.int32), nch_max)

    def wbody(ci, w):
        ci = jnp.asarray(ci, jnp.int32)
        r0 = ci * (C_ * d)
        Vhc = lax.dynamic_slice(Vh, (r0, z32), (C_ * d, n))
        Vlc = lax.dynamic_slice(Vl, (r0, z32), (C_ * d, n))
        full = (einsum("Kn,dn->Kd", Vhc, zh0, preferred_element_type=pdt)
                + einsum("Kn,dn->Kd", Vhc, zl0, preferred_element_type=pdt)
                + einsum("Kn,dn->Kd", Vlc, zh0, preferred_element_type=pdt))
        wc = jnp.einsum("kid,id->ki", full.reshape(C_, d, d), eye_d)
        return lax.dynamic_update_slice(w, wc, (ci * C_, z32))

    w = lax.fori_loop(0, nch, wbody, jnp.zeros((nch_max * C_, d), pdt))
    w = w * (jnp.arange(nch_max * C_)[:, None] < kc).astype(pdt)
    overlap = jnp.max(jnp.max(jnp.abs(w), axis=0) / (un + 1e-300))
    wh = w.astype(jnp.float32)
    wl = (w - wh.astype(pdt)).astype(jnp.float32)

    def cbody(ci, corr):
        ci = jnp.asarray(ci, jnp.int32)
        r0 = ci * (C_ * d)
        Vhc = lax.dynamic_slice(Vh, (r0, z32), (C_ * d, n))
        Vlc = lax.dynamic_slice(Vl, (r0, z32), (C_ * d, n))
        whc = lax.dynamic_slice(wh, (ci * C_, z32), (C_, d))
        wlc = lax.dynamic_slice(wl, (ci * C_, z32), (C_, d))
        Wh_full = (whc[:, :, None] * eye_d).reshape(C_ * d, d).astype(jnp.float32)
        Wl_full = (wlc[:, :, None] * eye_d).reshape(C_ * d, d).astype(jnp.float32)
        return corr + (
            einsum("Kn,Kd->dn", Vhc, Wh_full, preferred_element_type=pdt)
            + einsum("Kn,Kd->dn", Vhc, Wl_full, preferred_element_type=pdt)
            + einsum("Kn,Kd->dn", Vlc, Wh_full, preferred_element_type=pdt))

    corr = lax.fori_loop(0, nch, cbody, jnp.zeros_like(zf))
    # the APPLIED value is exactly wh + wl (both f32; their f64 sum is exact)
    w_applied = wh.astype(pdt) + wl.astype(pdt)
    return ex.triple_sub_f64(z, corr), w_applied, overlap


def _project_pair_recorded(Uh, Ul, z, pdt):
    """Deflation projection of the expansion vector z (triple, (d, n))
    against the shared pair basis U (n, m), with the applied coefficients
    returned EXACTLY (f64 sums of the applied f32 splits) — the block twin
    of deflate._df64_advance's recorded do_proj. Chunked over U columns."""
    from .ops import expansion as ex

    n, m_ = Uh.shape
    d = z[0].shape[0]
    z32 = jnp.zeros((), jnp.int32)
    Cm = min(m_, 256)
    while m_ % Cm:
        Cm //= 2
    nchm = m_ // Cm

    def pbody(ci, carry):
        z, cbuf = carry
        c0 = jnp.asarray(ci * Cm, jnp.int32)
        Uhc = lax.dynamic_slice(Uh, (z32, c0), (n, Cm))
        Ulc = lax.dynamic_slice(Ul, (z32, c0), (n, Cm))
        zf = ex.triple_to_f64(z)
        zh = zf.astype(jnp.float32)
        zl = (zf - zh.astype(pdt)).astype(jnp.float32)
        w = (einsum("nm,dn->dm", Uhc, zh, preferred_element_type=pdt)
             + einsum("nm,dn->dm", Uhc, zl, preferred_element_type=pdt)
             + einsum("nm,dn->dm", Ulc, zh, preferred_element_type=pdt))
        wh = w.astype(jnp.float32)
        wl = (w - wh.astype(pdt)).astype(jnp.float32)
        corr = (einsum("nm,dm->dn", Uhc, wh, preferred_element_type=pdt)
                + einsum("nm,dm->dn", Uhc, wl, preferred_element_type=pdt)
                + einsum("nm,dm->dn", Ulc, wh, preferred_element_type=pdt))
        z = ex.triple_sub_f64(z, corr)
        w_applied = wh.astype(pdt) + wl.astype(pdt)
        cbuf = lax.dynamic_update_slice(cbuf, w_applied, (z32, c0))
        return z, cbuf

    z, cbuf = lax.fori_loop(0, nchm, pbody,
                            (z, jnp.zeros((d, m_), pdt)))
    return z, cbuf


def _commit_column(st: _BlockRecState, z, col, rel_col, w_applied, d, pdt):
    """Normalize, round to the stored pair, record the exact commit
    deviation and the H column (coefficients + norm at row `col`)."""
    from .ops import expansion as ex

    z32 = jnp.zeros((), jnp.int32)
    zf = ex.triple_to_f64(z)
    nrm_sq = bdot(zf, zf, pdt)
    nrm = jnp.sqrt(jnp.maximum(nrm_sq, 0.0))
    scale = jnp.sum(jnp.abs(w_applied), axis=0) + 1e-300
    lucky = nrm < 256.0 * jnp.finfo(pdt).eps * scale
    nrm = jnp.where(lucky, 0.0, nrm)
    safe = jnp.where(nrm > 0, nrm, 1.0)
    v_new = ex.triple_scale_f64(z, (1.0 / safe)[:, None])
    (vh2, vl2), _ = ex.triple_round_pair(v_new)
    vh2 = jnp.where(lucky[:, None], jnp.float32(0), vh2)
    vl2 = jnp.where(lucky[:, None], jnp.float32(0), vl2)
    devv = ex.triple_sub(z, ex.pair_scale_f64(vh2, vl2, nrm[:, None]))
    devf = ex.triple_to_f64(devv)
    dev_c = jnp.sqrt(bdot(devf, devf, pdt))

    Kp = st.H.shape[1]
    hcol = w_applied[:Kp].T                                   # (d, Kp)
    hcol = lax.dynamic_update_slice(hcol, nrm[:, None], (z32, col))
    H = lax.dynamic_update_slice(st.H, hcol[:, :, None], (z32, z32, rel_col))
    Vh = lax.dynamic_update_slice(st.Vh, vh2, (col * d, z32))
    Vl = lax.dynamic_update_slice(st.Vl, vl2, (col * d, z32))
    dev = lax.dynamic_update_slice(st.dev, dev_c[:, None], (z32, col))
    eta_w = lax.dynamic_update_slice(
        st.eta_w, (jnp.sum(jnp.abs(w_applied), axis=0) + nrm)[:, None],
        (z32, rel_col))
    return st._replace(H=H, Vh=Vh, Vl=Vl, dev=dev, eta_w=eta_w), nrm, dev_c


@functools.partial(
    jax.jit, donate_argnums=(3,), compiler_options=EXACT_ROUNDING,
    static_argnames=("offsets", "S", "R", "deflated"),
)
def _block_rec_advance(bands_h, bands_l, offsets, state: _BlockRecState,
                       k0, Uh, Ul, S: int, R: int, deflated: bool = False):
    """Run S recording block steps k0..k0+S-1 in ONE device call (the
    host-driven segment loop, in place of the plain block path's
    monolithic while_loop). With deflated=True the U-projection runs (and
    is recorded) on every new column."""
    from .ops import expansion as ex

    d = bands_h.shape[0]
    n = state.Vh.shape[1]
    Kp = state.H.shape[1]
    nch_max = state.Vh.shape[0] // (_DF64_SWEEP_COLS * d)
    pdt = state.H.dtype

    def body(i, st: _BlockRecState) -> _BlockRecState:
        k = k0 + jnp.asarray(i, jnp.int32)
        for r in range(R):          # static unroll: R is small
            src = (k - 1) * R + r
            col = k * R + r
            rel_col = (k - 1) * R + r
            z32 = jnp.zeros((), jnp.int32)
            vh = lax.dynamic_slice(st.Vh, (src * d, z32), (d, n))
            vl = lax.dynamic_slice(st.Vl, (src * d, z32), (d, n))
            z = ex.triple_spmv_pairs(bands_h, bands_l, offsets, vh, vl)
            if deflated:
                z, cvec = _project_pair_recorded(Uh, Ul, z, pdt)
                st = st._replace(C=lax.dynamic_update_slice(
                    st.C, cvec[:, :, None], (z32, z32, rel_col)))
            z, w1, _ = _sweep_pair(st.Vh, st.Vl, z, col, nch_max, d, pdt)
            z, w2, ov = _sweep_pair(st.Vh, st.Vl, z, col, nch_max, d, pdt)
            st = st._replace(
                sweep_overlap=jnp.maximum(st.sweep_overlap, ov))
            st, _, _ = _commit_column(
                st, z, col, rel_col, w1 + w2, d, pdt)
        return st

    return lax.fori_loop(0, S, body, state)


@functools.partial(jax.jit, donate_argnums=(1,), static_argnames=("R",),
                   compiler_options=EXACT_ROUNDING)
def _block_rec_init(B, state: _BlockRecState, R: int):
    """Recorded QR of the R start vectors per factor (expansion
    arithmetic): b_r = Σ_{j<=r} btil[s, j, r] v_j + dev0_r exactly."""
    from .ops import expansion as ex

    d, n = B.shape[1], B.shape[2]
    Kp = state.H.shape[1]
    nch_max = state.Vh.shape[0] // (_DF64_SWEEP_COLS * d)
    pdt = state.H.dtype
    z32 = jnp.zeros((), jnp.int32)
    for r in range(R):
        z = ex.triple_from_f64(B[r].astype(pdt))
        col = jnp.asarray(r, jnp.int32)
        z, w1, _ = _sweep_pair(state.Vh, state.Vl, z, col, nch_max, d, pdt)
        z, w2, _ = _sweep_pair(state.Vh, state.Vl, z, col, nch_max, d, pdt)
        w = w1 + w2
        zf = ex.triple_to_f64(z)
        nrm = jnp.sqrt(jnp.maximum(bdot(zf, zf, pdt), 0.0))
        safe = jnp.where(nrm > 0, nrm, 1.0)
        v_new = ex.triple_scale_f64(z, (1.0 / safe)[:, None])
        (vh2, vl2), _ = ex.triple_round_pair(v_new)
        devv = ex.triple_sub(z, ex.pair_scale_f64(vh2, vl2, nrm[:, None]))
        devf = ex.triple_to_f64(devv)
        dev0_r = jnp.sqrt(bdot(devf, devf, pdt))
        bt_col = lax.dynamic_update_slice(
            w[:R].T, nrm[:, None], (z32, col))              # (d, R)
        state = state._replace(
            btil=lax.dynamic_update_slice(
                state.btil, bt_col[:, :, None], (z32, z32, col)),
            Vh=lax.dynamic_update_slice(state.Vh, vh2, (col * d, z32)),
            Vl=lax.dynamic_update_slice(state.Vl, vl2, (col * d, z32)),
            dev0=lax.dynamic_update_slice(
                state.dev0, dev0_r[:, None], (z32, col)),
        )
    return state


def _evaluate_block_recorded(H, btil, dev, eta_hat, dev0, kc, R, b_norm,
                             lam_min, omega, alpha, t_mask, eps_elem,
                             lam_gersh_f, gram_dev, frechet: bool = True,
                             lam=None, C_rec=None, c_u=None):
    """Host evaluation of the recorded block solve at kc active columns.

    Mirrors deflate._evaluate_host_recorded with:
      tridiagonal T + recorded sweep matrix W  →  sym(H) + asym defect E
      rank-1 β₀e₀ RHS                          →  recorded R-column QR btil
      scalar β boundary                        →  R×R boundary block
    With deflation (lam (d, m), C_rec (d, m, kc), c_u (d, m, R)): the
    recorded per-factor operator is [[Λ, C], [0, sym(H) + E]] — Λ applied
    exactly (diagonal), C and E via first-order Frechet with the
    second-order remainder charged (rho = max_s ||[C_s; E_s]||_F).
    Returns (rel_estimate, Yu (d, m, t·R), Yv (d, kc, t·R), weights,
    components)."""
    ld = np.longdouble
    d = H.shape[0]
    m = 0 if lam is None else lam.shape[1]
    act = np.flatnonzero(t_mask > 0)
    t = act.size
    gam = alpha[act] / lam_min                                  # (t,)
    w_t = omega[act] / lam_min

    Hk = np.asarray(H[:, : kc + R, :kc], np.float64)
    Ha = Hk[:, :kc, :]                                          # active block
    B_blk = Hk[:, kc: kc + R, kc - R: kc]                       # (d, R, R)
    bt = np.zeros((d, kc, R))
    bt[:, :R, :] = btil

    Y = np.zeros((d, kc, t * R))
    Z = np.zeros((d, kc, t * R))
    Yu = np.zeros((d, m, t * R))
    Zu = np.zeros((d, m, t * R))
    rho = 0.0
    for s in range(d):
        S_s = 0.5 * (Ha[s] + Ha[s].T)
        E_s = Ha[s] - S_s
        Cs = np.zeros((0, kc)) if m == 0 else np.asarray(C_rec[s], np.float64)
        rho = max(rho, float(np.sqrt((E_s ** 2).sum() + (Cs ** 2).sum())))
        T_w, Q = np.linalg.eigh(S_s)
        ex = np.exp(-np.clip(T_w[:, None] * gam[None, :], -700.0, 700.0))
        Et = Q.T @ E_s @ Q
        Ct = Cs @ Q if m else None                              # (m, kc)
        ex_u = (np.exp(-np.clip(lam[s][:, None] * gam[None, :], -700., 700.))
                if m else None)
        scale_T = np.abs(T_w).max() + 1.0
        dT = T_w[:, None] - T_w[None, :]
        deg = np.abs(dT) < 1e-8 * scale_T
        if m:
            dU = lam[s][:, None] - T_w[None, :]
            degU = np.abs(dU) < 1e-8 * scale_T
        for r in range(R):
            g = Q.T @ bt[s, :, r]                               # (kc,)
            Y0 = Q @ (ex * g[:, None])                          # (kc, t)
            dY = np.zeros((kc, t))
            dYu = np.zeros((m, t))
            Yu0 = ex_u * c_u[s][:, r][:, None] if m else None   # (m, t)
            if frechet:
                # GEMM-separated divided differences (see
                # deflate._evaluate_host_recorded for the derivation)
                Gw = Et * g[None, :]
                M = np.where(deg, 0.0, Gw) / np.where(deg, 1.0, dT)
                dY_c = ex * M.sum(axis=1)[:, None] - M @ ex
                for i, l in zip(*np.nonzero(deg)):
                    h = 0.5 * gam * (T_w[i] - T_w[l])
                    dY_c[i] += Gw[i, l] * (-gam * np.sqrt(ex[i] * ex[l])
                                           * (1.0 + h * h / 6.0))
                dY = Q @ dY_c
                if m:
                    Gu = Ct * g[None, :]
                    MU = np.where(degU, 0.0, Gu) / np.where(degU, 1.0, dU)
                    dYu = ex_u * MU.sum(axis=1)[:, None] - MU @ ex
                    for i, l in zip(*np.nonzero(degU)):
                        h = 0.5 * gam * (lam[s][i] - T_w[l])
                        dYu[i] += Gu[i, l] * (-gam * np.sqrt(ex_u[i] * ex[l])
                                              * (1.0 + h * h / 6.0))
            Y[s, :, r * t: (r + 1) * t] = Y0 + dY
            if m:
                Yu[s, :, r * t: (r + 1) * t] = Yu0 + dYu
        Z[s] = Ha[s] @ Y[s]
        if m:
            Zu[s] = lam[s][:, None] * Yu[s] + Cs @ Y[s]

    w_full = np.tile(w_t, R)                                    # (t·R,)
    wl = np.asarray(w_full, ld)
    # joint factors: [U-block rows | Krylov rows] — the Gram algebra runs
    # over the concatenation exactly as deflate._evaluate_host_recorded
    Yj = np.concatenate([Yu, Y], axis=1)
    Zj = np.concatenate([Zu, Z], axis=1)
    btj = np.concatenate(
        [np.zeros((d, m, R)) if c_u is None else c_u, bt], axis=1)
    Gy = np.einsum("dpi,dpj->dij", Yj, Yj).astype(ld)
    Gz = np.einsum("dpi,dpj->dij", Zj, Zj).astype(ld)
    Xg = np.einsum("dpi,dpj->dij", Yj, Zj).astype(ld)
    yb = np.einsum("dpi,dpr->dir", Yj, btj).astype(ld)          # (d, tR, R)
    zb = np.einsum("dpi,dpr->dir", Zj, btj).astype(ld)
    Gb = np.einsum("dpr,dpq->drq", btj, btj).astype(ld)
    b2 = float(np.sum(np.prod(Gb, axis=0)))

    hy2 = ld(0.0)
    for s in range(d):
        for sp in range(d):
            P = np.ones((t * R, t * R), ld)
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
        P = np.ones((t * R, R), ld)
        for mo in range(d):
            P *= zb[mo] if mo == s else yb[mo]
        ip += wl @ P.sum(axis=1)
    r_comp_sq = float(hy2 - 2.0 * ip + b2)

    # block boundary (Lemma 3.4, block form): unaccounted term per mode s
    # is V_newblock · (B_s Y_last_s) ⊗ off-modes; cross-mode terms are
    # orthogonality-slack-second-order (folded into `slack` below)
    Y_last = Y[:, kc - R: kc, :]                                # (d, R, tR)
    boundary = ld(0.0)
    for s in range(d):
        E_off = np.ones((t * R, t * R), ld)
        for mo in range(d):
            if mo != s:
                E_off *= Gy[mo]
        Wb = (B_blk[s] @ Y_last[s]).astype(ld)                  # (R, tR)
        boundary += wl @ ((Wb.T @ Wb) * E_off) @ wl
    boundary = float(boundary)

    # relation-error terms: dev measured exactly; η from the measured
    # elementwise ε and the applied-coefficient mass (||H col||_1 incl.
    # both CGS passes enters via eta_w, passed in dev's companion below)
    slack = float(np.sqrt(1.0 + min(kc, 1e9) * max(gram_dev, 0.0)))
    ynorm = np.sqrt(np.maximum(
        np.einsum("dii->di", np.asarray(Gy, np.float64)), 0.0))
    off_prod = np.ones((d, t * R))
    for s in range(d):
        for r_ in range(d):
            if r_ != s:
                off_prod[s] *= ynorm[r_] * slack

    def tri_term(bmat):         # bmat (d, kc) per-column relation bounds
        tot = 0.0
        for s in range(d):
            Dsi = np.abs(Y[s]).T @ bmat[s]
            tot += float(np.sum(np.abs(w_full) * Dsi * off_prod[s]))
        return tot

    # dev[:, c] must already be the deviation of RELATION column c (the
    # commit of column c+R) — the driver shifts by R before calling
    dev_term = tri_term(dev[:, :kc]) * slack / b_norm
    # start-block representation deviation: b_r − Σ_j btil[j,r] v_j has
    # norm dev0[s, r] in factor s; its full-tensor contribution carries the
    # off-mode ||b_{mo,r}|| products (b_norms_dr passed via dev0's second
    # row block — see driver)
    eta_term = tri_term(eta_hat[:, :kc]) * slack / b_norm
    dev_term += float(np.sum(dev0)) / b_norm
    lam_max_tot = float(np.sum(lam_gersh_f))
    gr = gam * rho
    r2_term = float(d * lam_max_tot * np.sum(
        w_t * 0.5 * gr * gr * np.exp(np.minimum(gr, 50.0)))) if frechet \
        else 0.0

    rel = float(np.sqrt(max(boundary, 0.0) + max(r_comp_sq, 0.0))) / b_norm
    components = {
        "boundary": float(np.sqrt(max(boundary, 0.0))) / b_norm,
        "dev_term": dev_term,
        "eta_term": eta_term,
        "r2_term": r2_term,
        "rho": float(rho),
        "gram_dev": float(gram_dev),
        "eps_elem": float(eps_elem),
    }
    return rel, Yu, Y, w_full, components


def solve_block_recorded(
    op: KroneckerSumOperator,
    B,
    config: Optional[SolverConfig] = None,
    tables: Optional[BHTables] = None,
    checkpoints: Optional[Sequence[int]] = None,
    lam_min: Optional[float] = None,
    segment: int = 8,
    certify: bool = True,
    final: str = "auto",
    m: int = 0,
    basis=None,
    verbose: bool = False,
) -> BlockRecordedResult:
    """Certifying block Krylov solve for a rank-R RHS b = Σ_r ⊗_s B[r, s]
    — the noise-recording counterpart of solve_block (BASELINE config 4).

    lam_min: exact/analytic lower spectral bound of the JOINT operator
    (e.g. d·λ_min(A_s) for identical SPD factors). Required for a rigorous
    certificate; if None, the minimum Ritz value at each checkpoint is
    used (estimate-grade — Ritz converges to λ_min from above) and the
    result is labelled accordingly via `certified_bound` still being
    reported (the sup component may be optimistic by the Ritz gap).

    final: 'host' pulls the pair basis for assembly; 'device' assembles
    x = V·Y on device and runs the rank-R basis-free cross-check there
    (only a small Gram is pulled). 'auto' → 'host'.

    m / basis: per-factor spectral deflation composed with the block
    recurrence: the rank-R
    RHS is host-projected into the U-complement (recorded coefficients
    c_u), every new block column is U-projected with RECORDED coefficients
    (C), and the projected solve inverts the recorded [[Λ, C], [0, H]]
    factor — the κ_eff reduction that makes deep rank-1 flagships feasible
    now applies to rank-R RHS. Requires a shared deflation basis
    (identical factors), like storage='df64'.
    """
    config = config or SolverConfig()
    B = jnp.asarray(B)
    if B.ndim != 3 or B.shape[1] != op.d or B.shape[2] != op.n:
        raise ValueError(f"B must be (R, d, n) = (R, {op.d}, {op.n}), "
                         f"got {B.shape}")
    if not op.symmetric:
        raise ValueError("solve_block_recorded requires a symmetric operator")
    R = int(B.shape[0])
    d, n = op.d, op.n
    pdt = jnp.float64
    tables = tables or load_tables(dtype=pdt)
    if final == "auto":
        final = "host"
    if final not in ("host", "device"):
        raise ValueError(f"final must be 'auto'|'host'|'device', got {final!r}")

    # deflation setup (host): project B into the U-complement with exact
    # host-f64 recorded coefficients c_u; the recurrence then keeps every
    # column out of span(U) via the recorded per-column projection
    Uh = Ul = None
    lam_np = c_u_np = None
    if basis is not None:
        m = basis.m
    elif m > 0:
        from .deflate import deflation_basis

        basis = deflation_basis(op, m)
        m = basis.m
    B_np = np.asarray(B, np.float64)
    B_work = B_np
    if m > 0:
        U_np = np.asarray(basis.U, np.float64)
        if U_np.shape[0] != 1:
            raise ValueError("solve_block_recorded deflation requires a "
                             "shared basis (identical factors), like "
                             "storage='df64'")
        lam_np = np.asarray(basis.lam, np.float64)
        c_u_np = np.einsum("nm,rdn->dmr", U_np[0], B_np)        # (d, m, R)
        B_work = B_np - np.einsum(
            "nm,dmr->rdn", U_np[0], c_u_np)
        Uh_np = U_np[0].astype(np.float32)
        Uh = jnp.asarray(Uh_np)
        Ul = jnp.asarray((U_np[0] - Uh_np.astype(np.float64))
                         .astype(np.float32))
        del U_np, Uh_np
        if lam_min is None:
            lam_min = float(lam_np[:, 0].sum())   # exact joint λ_min

    kmax = min(config.kmax, max((n - m) // R - 1, 1))           # block its
    Kb = (kmax + 1) * R
    C_ = _DF64_SWEEP_COLS
    Kp = -(-Kb // C_) * C_

    lam_gersh_f = _gershgorin_per_factor(op)
    lam_max = float(lam_gersh_f.sum())

    Gb0 = np.einsum("rdn,qdn->drq", B_np, B_np)
    b_norm = float(np.sqrt(max(np.sum(np.prod(Gb0, axis=0)), 0.0)))

    if checkpoints is None:
        checkpoints, ck = [], 8
        while ck < kmax:
            checkpoints.append(ck)
            ck *= 2
        checkpoints.append(kmax)
    checkpoints = sorted({min(int(c_), kmax) for c_ in checkpoints})

    # coefficient selection: fixed interval when lam_min is given (exact),
    # else refreshed per checkpoint from the Ritz minimum
    def _coeffs_for(lmin):
        kappa = lam_max / lmin
        half_tol = 0.5 * config.tol
        coeff_tol = (half_tol / kappa if config.coeff_tol_scale == "kappa"
                     else half_tol)
        co = jax.jit(select_bh, static_argnames=("tmax", "row_select"))(
            jnp.asarray(kappa, pdt), coeff_tol, tables, tmax=config.tmax,
            row_select=config.bh_row_select)
        return co, expsum_sup_error(co.omega, co.alpha, kappa), kappa

    bnp = np.asarray(op.bands, np.float64)
    bh_np = bnp.astype(np.float32)
    bands_h = jnp.asarray(bh_np)
    bands_l = jnp.asarray((bnp - bh_np.astype(np.float64)).astype(np.float32))
    del bnp, bh_np

    state = _BlockRecState(
        H=jnp.zeros((d, Kp, Kp), pdt),
        btil=jnp.zeros((d, R, R), pdt),
        dev=jnp.zeros((d, Kp), pdt),
        dev0=jnp.zeros((d, R), pdt),
        Vh=jnp.zeros((Kp * d, n), jnp.float32),
        Vl=jnp.zeros((Kp * d, n), jnp.float32),
        sweep_overlap=jnp.zeros((), pdt),
        eta_w=jnp.zeros((d, Kp), pdt),
        C=jnp.zeros((d, m, Kp), pdt),
    )
    state = _block_rec_init(jnp.asarray(B_work), state, R)

    rel_hist: List[float] = []
    bound_hist: List[float] = []
    status = int(Status.MAXITER)
    k_prev = 1
    k_done = 0
    Y_np = w_np = None
    cert = None
    eps_elem = _eft_eps()
    lam_min_eff = lam_min

    for ck in checkpoints:
        while k_prev <= ck:
            S_eff = min(segment, ck + 1 - k_prev)
            state = _block_rec_advance(
                bands_h, bands_l, op.offsets, state,
                jnp.asarray(k_prev, jnp.int32), Uh, Ul,
                S=S_eff, R=R, deflated=m > 0)
            k_prev += S_eff
        kc = ck * R
        H_np = np.zeros((d, Kp, Kp), np.float64)
        H_np[:, : kc + R, :kc] = np.asarray(state.H[:, : kc + R, :kc])
        btil_np = np.asarray(state.btil)
        # relation column c's commit deviation was recorded at column c+R
        dev_np = np.asarray(state.dev)[:, R: kc + R]
        # start-block representation: measured QR commit deviation + the
        # init sweeps' elementwise rounding, weighted by the off-mode
        # ||b_{mo,r}|| products so the sum is in absolute b-units
        b_col_norms = np.linalg.norm(B_np, axis=2).T            # (d, R)
        dev0_np = (np.asarray(state.dev0)
                   + 8.0 * eps_elem * np.abs(np.asarray(state.btil)).sum(axis=1))
        off_b = np.ones((d, R))
        for s_ in range(d):
            for mo in range(d):
                if mo != s_:
                    off_b[s_] *= b_col_norms[mo]
        dev0_np = dev0_np * off_b
        eta_w_np = np.asarray(state.eta_w)
        if lam_min is None:
            # Ritz lower estimate from the symmetrized joint blocks
            lmins = [float(np.linalg.eigvalsh(
                0.5 * (H_np[s, :kc, :kc] + H_np[s, :kc, :kc].T))[0])
                for s in range(d)]
            lam_min_eff = max(sum(lmins), 1e-300)
        coeffs, sup_err, kappa = _coeffs_for(lam_min_eff)

        proxy = float(state.sweep_overlap)
        C_np = None
        if m > 0:
            C_np = np.asarray(state.C[:, :, :kc])               # (d, m, kc)
        # per-column η model: elementwise expansion rounding through the
        # spmv + sweeps + commit (measured eps_elem; pair-GEMM coefficient
        # application ~1e-15 relative to the applied mass eta_w, plus the
        # recorded-projection mass when deflated)
        eta_hat = (8.0 * eps_elem * lam_gersh_f[:, None]
                   * np.ones((1, Kp))
                   + 1e-15 * eta_w_np)                         # (d, Kp)
        if m > 0:
            eta_hat[:, :kc] += 1e-15 * np.abs(C_np).sum(axis=1)

        def _eval(gram_dev, frechet):
            rel, Yu, Y, w_full, cert = _evaluate_block_recorded(
                H_np, btil_np, dev_np, eta_hat,
                dev0_np, kc, R, b_norm, lam_min_eff,
                np.asarray(coeffs.omega), np.asarray(coeffs.alpha),
                np.asarray(coeffs.t_mask), eps_elem, lam_gersh_f,
                gram_dev, frechet=frechet,
                lam=lam_np, C_rec=C_np, c_u=c_u_np)
            cert["sup"] = sup_err
            bound = (sup_err + cert["boundary"] + cert["dev_term"]
                     + cert["eta_term"] + cert["r2_term"])
            return rel, Yu, Y, w_full, cert, bound

        rel, Yu_np, Y_np, w_np, cert, bound = _eval(proxy, frechet=True)
        if bound < 100.0 * config.tol or ck == checkpoints[-1]:
            gram_dev = _df64_gram_deviation_host(state.Vh, state.Vl, kc, d)
            rel, Yu_np, Y_np, w_np, cert, bound = _eval(
                gram_dev, frechet=True)
            cert["gram_source"] = "measured full Gram"
        else:
            cert["gram_source"] = "proxy sweep_overlap"
        rel_hist.append(rel)
        bound_hist.append(bound)
        k_done = ck
        if verbose:
            print(f"  [solve_block_recorded {_time.strftime('%H:%M:%S')}] "
                  f"k={ck} ({kc} cols): estimate {rel:.3e}, certified bound "
                  f"{bound:.3e} [sup {sup_err:.1e} bnd {cert['boundary']:.1e} "
                  f"dev {cert['dev_term']:.1e} rho {cert['rho']:.1e} "
                  f"gram {cert['gram_dev']:.1e}]", flush=True)
        if bound < config.tol:
            status = int(Status.CONVERGED)
            break

    # ---- assembly + basis-free rank-R cross-check ----
    kc = k_done * R
    x = None
    measured = measured_floor = None
    if final == "device":
        t_all = Y_np.shape[2]
        ROWS = C_
        nch_a = min(-(-kc // ROWS), Kp // ROWS)
        Y_pad = np.zeros((d, nch_a * ROWS, t_all))
        Y_pad[:, :kc, :] = Y_np
        Yh_np = Y_pad.astype(np.float32)
        Yl_np = (Y_pad - Yh_np.astype(np.float64)).astype(np.float32)
        acc = jnp.zeros((d, n, t_all), jnp.float64)
        for ci in range(nch_a):
            c0 = ci * ROWS
            acc = _df64_assemble_chunk(
                acc, state.Vh, state.Vl, jnp.asarray(c0 * d, jnp.int32),
                jnp.asarray(Yh_np[:, c0:c0 + ROWS, :]),
                jnp.asarray(Yl_np[:, c0:c0 + ROWS, :]), rows=ROWS)
        if m > 0:
            from .deflate import _df64_ulift_chunk

            Yuh_np = Yu_np.astype(np.float32)
            Yul_np = (Yu_np - Yuh_np.astype(np.float64)).astype(np.float32)
            CM_U = min(256, m)
            c0_ = 0
            while c0_ < m:
                c1_ = min(c0_ + CM_U, m)
                acc = _df64_ulift_chunk(
                    acc, Uh[:, c0_:c1_], Ul[:, c0_:c1_],
                    jnp.asarray(Yuh_np[:, c0_:c1_, :]),
                    jnp.asarray(Yul_np[:, c0_:c1_, :]))
                c0_ = c1_
        xf = acc
        x = CPTensor(jnp.asarray(w_np), xf)
        if certify:
            from .utils.cp import cp_residual_cross_check_device

            try:
                check = cp_residual_cross_check_device(
                    op, w_np, xf, jnp.asarray(B_np))
                measured = check.value / b_norm
                measured_floor = check.floor / b_norm
            except jax.errors.JaxRuntimeError as e:
                print("[solve_block_recorded] device cross-check failed "
                      f"({type(e).__name__})", flush=True)
    else:
        Vfull = (np.asarray(state.Vh[: kc * d], np.float64)
                 + np.asarray(state.Vl[: kc * d], np.float64))
        xf = np.einsum("kdn,dkt->dnt", Vfull.reshape(kc, d, n), Y_np)
        if m > 0:
            xf = xf + np.einsum("nm,dmt->dnt",
                                np.asarray(basis.U, np.float64)[0], Yu_np)
        x = CPTensor(jnp.asarray(w_np), jnp.asarray(xf))
        if certify:
            from .utils.cp import cp_residual_cross_check_host_rankR

            check = cp_residual_cross_check_host_rankR(
                np.asarray(op.bands, np.float64), op.offsets, w_np, xf, B_np)
            measured = check.value / b_norm
            measured_floor = check.floor / b_norm

    return BlockRecordedResult(
        x=x,
        status=status,
        niterations=k_done,
        R=R,
        relative_residual=rel_hist,
        certified_bound=bound_hist,
        checkpoints=list(checkpoints[: len(rel_hist)]),
        expsum_sup=float(cert["sup"]) if cert else 0.0,
        expsum_rank=int(np.sum(np.asarray(coeffs.t_mask) > 0)),
        lambda_min=float(lam_min_eff),
        lambda_max=lam_max,
        measured_cp_residual=measured,
        cp_residual_floor=measured_floor,
        sweep_overlap=float(state.sweep_overlap),
        gram_deviation=None if cert is None else cert["gram_dev"],
        relation_dev_term=None if cert is None else cert["dev_term"],
        relation_eta_term=None if cert is None else cert["eta_term"],
        relation_r2_term=None if cert is None else cert["r2_term"],
        perturbation_rho=None if cert is None else cert["rho"],
        eft_eps_measured=eps_elem,
        converged=status == int(Status.CONVERGED),
    )
