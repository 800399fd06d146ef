"""Batched Krylov orthogonalization steps — hot kernel #2.

Batched rebuild of the reference's per-factor Arnoldi/Lanczos steps
(/root/reference/src/orthogonal_bases.jl). The d factors are a leading batch
axis: one step advances all d recurrences at once (replacing the @sync/@async
task loop at /root/reference/src/orthogonal_bases.jl:142-180). All state is
kmax-padded; masks select the active prefix.

Deviations (see DESIGN.md §1):
  * Reorthogonalized Lanczos: always-on single extra classical-GS sweep
    (two masked GEMMs) instead of the reference's conditional
    loss-triggered MGS fallback (/root/reference/src/orthogonal_bases.jl:98-139).
  * Arnoldi: CGS2 (two classical sweeps as GEMMs) instead of sequential
    MGS x2 (/root/reference/src/orthogonal_bases.jl:15-37) — same
    two-pass stability class, GEMM-shaped.

Every contraction goes through ops/precision.einsum (precision=HIGHEST):
on GPUs an f32 dot_general may otherwise run in TF32 (10-bit mantissa),
which would floor the f32-basis projections far above f32 roundoff.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..types import KroneckerSumOperator
from .banded import spmv
from .precision import einsum

__all__ = [
    "KrylovState",
    "init_state",
    "lanczos_step",
    "arnoldi_step",
    "orthogonality_loss",
    "lanczos_algorithm",
    "arnoldi_algorithm",
]


class KrylovState(NamedTuple):
    """Padded Krylov decomposition state for all d factors.

    V: (K, d, n) orthonormal bases — the Krylov index LEADS so each step's
    basis-vector write is one contiguous slab (updating the middle axis of
    a (d, K, n) layout is a strided read-modify-write). K = kmax + 1.
    H: (d, K, K) projected matrices (proj dtype, f64): H[s, i, j] = v_i^T A v_j.
    btil: (d, K) compressed RHS entries <v_j, b_s>.
    beta: (d,) last subdiagonal (Lanczos recurrence carry).
    """

    V: jax.Array
    H: jax.Array
    btil: jax.Array
    beta: jax.Array


def init_state(
    op: KroneckerSumOperator, b: jax.Array, kmax: int, proj_dtype, basis_dtype=None
) -> Tuple[KrylovState, jax.Array]:
    """Normalize b per factor into V[:, 0]; returns (state, b_norms (d,)).

    Mirrors the k=1 step of the reference (initialize_decomp!,
    /root/reference/src/decompositions.jl:112-118).

    basis_dtype: storage dtype of V (defaults to op.dtype) — may be narrower
    (bf16) than the operator/compute dtype.
    """
    d, n = b.shape
    K = kmax + 1
    dtype = basis_dtype if basis_dtype is not None else op.dtype
    acc = _acc_dtype(dtype, proj_dtype)
    b = b.astype(acc)
    b_norms = jnp.linalg.norm(b, axis=1).astype(proj_dtype)
    v0 = b / b_norms.astype(acc)[:, None]
    V = jnp.zeros((K, d, n), dtype)
    V = V.at[0].set(v0.astype(dtype))
    H = jnp.zeros((d, K, K), proj_dtype)
    btil = jnp.zeros((d, K), proj_dtype)
    btil = btil.at[:, 0].set(
        bdot(v0, b, acc).astype(proj_dtype)
    )
    beta = jnp.zeros((d,), proj_dtype)
    return KrylovState(V, H, btil, beta), b_norms


def _col(V: jax.Array, j) -> jax.Array:
    """V[j] with a traced index → (d, n)."""
    return lax.dynamic_slice_in_dim(V, j, 1, axis=0)[0]


def _acc_dtype(basis_dtype, proj_dtype):
    """Accumulation/compute dtype for length-n work: f64 only when the basis
    itself is f64 — for f32/bf16 bases XLA's tree reduction in f32 already
    bounds the error at ~log(n)·eps_f32, consistent with the basis
    precision, at half the bytes. Results are cast to proj_dtype afterwards.

    For sub-f32 STORAGE (bf16 basis — halves the HBM traffic of the
    V-prefix GEMMs, the large-n bandwidth bottleneck) this is also the
    compute dtype: the working vector u lives in f32; V/bands are read in
    bf16 and promoted on the fly."""
    if basis_dtype == jnp.float64:
        return proj_dtype
    return jnp.float32


def _prefix_mask(K: int, k, dtype) -> jax.Array:
    """(K,) mask of columns < k."""
    return (jnp.arange(K) < k).astype(dtype)


# Columns per chunk of the active-prefix GEMVs. The padded basis is (K, d, n)
# but only k < K columns are live at step k; touching the whole buffer (a
# plain masked einsum) reads K·d·n from HBM every sweep — the dominant
# traffic of the reorthogonalized/Arnoldi paths at large n. Chunking with a
# data-dependent trip count ceil(k/C) reads only ~k·d·n. 32 columns keeps
# per-chunk slabs ≥ 16 MB at flagship sizes (launch overhead amortized)
# while wasting < C/2 columns on the last partial chunk.
_PREFIX_CHUNK = 32


def _prefix_chunks(K: int, k):
    """(chunk width C, traced number of chunks covering columns [0, k))."""
    C = min(_PREFIX_CHUNK, K)
    return C, (jnp.asarray(k, jnp.int32) + C - 1) // C


def _chunk_cols(V, c, C):
    """Chunk c of the basis: columns [start, start+C) with start clamped to
    K−C (dynamic_slice semantics). Returns (Vc (C, d, n), chunk start,
    global column ids, dedupe mask selecting only ids ≥ c·C — clamped tail
    chunks overlap their predecessor and must not double-count)."""
    K = V.shape[0]
    c = jnp.asarray(c, jnp.int32)
    start = jnp.minimum(c * C, K - C)
    Vc = lax.dynamic_slice_in_dim(V, start, C, axis=0)
    cols = start + jnp.arange(C, dtype=jnp.int32)
    fresh = cols >= c * C
    return Vc, start, cols, fresh


def _project_coeffs(V, u, k, proj_dtype):
    """w = V[:k]^T u over the active prefix only: (d, K), zero beyond k.

    Chunked masked GEMVs — O(k·d·n) HBM traffic instead of O(K·d·n)."""
    K, d, n = V.shape
    acc = _acc_dtype(V.dtype, proj_dtype)
    C, nb = _prefix_chunks(K, k)

    def body(c, w):
        Vc, start, cols, fresh = _chunk_cols(V, c, C)
        wc = einsum(
            "kdn,dn->dk", Vc, u, preferred_element_type=acc
        ).astype(proj_dtype)
        # merge with what's already there: a clamped tail chunk overlaps its
        # predecessor, and its non-fresh lanes must keep the earlier values
        existing = lax.dynamic_slice(w, (jnp.zeros((), jnp.int32), start), (d, C))
        wc = jnp.where((fresh & (cols < k))[None, :], wc, existing)
        return lax.dynamic_update_slice(w, wc, (jnp.zeros((), jnp.int32), start))

    return lax.fori_loop(0, nb, body, jnp.zeros((d, K), proj_dtype))


def _subtract_span(V, u, w, k):
    """u -= Σ_{j<k} w_j V[:, j] (w already masked beyond k). The correction
    accumulates in u's (compute) dtype — V may be stored narrower (bf16).
    Chunked over the active prefix like _project_coeffs."""
    K = V.shape[0]
    C, nb = _prefix_chunks(K, k)

    def body(c, u):
        Vc, start, cols, fresh = _chunk_cols(V, c, C)
        zero = jnp.zeros((), jnp.int32)
        wc = lax.dynamic_slice(w, (zero, start), (w.shape[0], C))
        wc = wc * fresh.astype(w.dtype)[None, :]
        corr = einsum(
            "kdn,dk->dn", Vc, wc.astype(u.dtype), preferred_element_type=u.dtype
        )
        return u - corr

    return lax.fori_loop(0, nb, body, u)


def _replace_lucky(V, v_new, lucky, k, proj_dtype, deflate_U=None):
    """Lucky-breakdown restart: for factors whose new Krylov vector vanished
    (β ≈ 0 — the space is A-invariant), continue with a fresh deterministic
    pseudo-random direction orthogonalized against the existing basis.

    For symmetric A the complement of an invariant subspace is invariant, so
    the restarted three-term recurrence stays exact (H becomes block
    tridiagonal); Arnoldi's full-column projections handle the nonsymmetric
    case automatically. This strictly improves on the reference's
    write-a-zero-vector handling (/root/reference/src/orthogonal_bases.jl:59),
    which poisons the projected spectrum with spurious zero eigenvalues.

    Cost is paid only when a breakdown actually occurs (lax.cond).
    """
    K, d, n = V.shape
    cdt = _acc_dtype(V.dtype, proj_dtype)

    def build(v_new):
        i = jnp.arange(n, dtype=cdt)
        s = jnp.arange(d, dtype=cdt)[:, None]
        kf = jnp.asarray(k, cdt)
        vr = jnp.cos((i[None, :] + 0.7) * (1.0 + 0.01 * s) + 0.37 * kf)
        nrm0 = jnp.sqrt(jnp.sum(vr.astype(proj_dtype) ** 2, axis=1))
        for _ in range(2):  # CGS twice against the existing prefix
            if deflate_U is not None:  # the restart must stay in U-complement
                vr = deflation_project(vr, deflate_U, cdt)
            w = _project_coeffs(V, vr, k, proj_dtype)
            vr = _subtract_span(V, vr, w, k)
        nrm = jnp.sqrt(jnp.sum(vr.astype(proj_dtype) ** 2, axis=1))
        # exhausted space: if the fresh direction is (numerically) inside the
        # existing span, normalizing would amplify cancellation noise into a
        # non-orthogonal junk vector — write a zero column instead (zero
        # columns are self-consistently inert: A·0 = 0, ⟨·,0⟩ = 0)
        ok = nrm > jnp.asarray(2.0**-12, proj_dtype) * nrm0
        vr = jnp.where(
            ok[:, None], vr / jnp.where(nrm > 0, nrm, 1.0).astype(vr.dtype)[:, None], 0.0
        )
        return jnp.where(lucky[:, None], vr.astype(v_new.dtype), v_new)

    return lax.cond(jnp.any(lucky), build, lambda v: v, v_new)


def _gate_col(V, v_new, k, active):
    """Column to write at slot k: the step's result, or (for frozen vmap
    lanes) the existing value — gating BEFORE the single dynamic update so
    the basis sees exactly one write per step."""
    if active is None:
        return v_new
    return jnp.where(active, v_new, _col(V, k))


def bdot(a, b, acc=None):
    """Batched per-factor dot ⟨a_s, b_s⟩ → (..., d,)-leading shape, in the
    accumulation dtype `acc` (default: the operands' common dtype)."""
    if acc is None:
        acc = jnp.result_type(a.dtype, b.dtype)
    return einsum("...n,...n->...", a, b, preferred_element_type=acc)


# Max einsum-operand elements per column chunk of the deflation projection
# (2^25 f64 = 256 MB per slice). It bounds the temporaries of one projection
# GEMM; small problems never chunk (single-einsum path unchanged).
_PROJ_CHUNK_ELEMS = 1 << 25


def _proj_col_chunk(n: int, m: int) -> int:
    c = max(1, _PROJ_CHUNK_ELEMS // max(n, 1))
    return m if c >= m else c


def deflation_project(u: jax.Array, U: jax.Array, acc) -> jax.Array:
    """u − U (Uᵀ u) per factor. U: (1, n, m) shared across factors (one GEMM
    pass over U regardless of d — the identical-factor fast path) or
    (d, n, m) distinct. Large U is processed in static column chunks
    (sequential block projection — exactly the full projection for
    orthonormal U, and it bounds the per-GEMM temporaries)."""
    Ua = U.astype(acc)
    n, m = Ua.shape[1], Ua.shape[2]
    if Ua.shape[0] == 1:
        C = _proj_col_chunk(n, m)
        for c0 in range(0, m, C):
            Uc = Ua[0, :, c0:c0 + C]
            coeff = einsum("nm,dn->dm", Uc, u, preferred_element_type=acc)
            u = u - einsum("nm,dm->dn", Uc, coeff, preferred_element_type=acc)
        return u
    # distinct factors: the einsum operand slice is (d, n, C) — budget the
    # chunk d-aware so it stays within the same cap as the shared branch
    C = _proj_col_chunk(Ua.shape[0] * n, m)
    for c0 in range(0, m, C):
        Uc = Ua[:, :, c0:c0 + C]
        coeff = einsum("snm,sn->sm", Uc, u, preferred_element_type=acc)
        u = u - einsum("snm,sm->sn", Uc, coeff, preferred_element_type=acc)
    return u


def lanczos_step(op: KroneckerSumOperator, state: KrylovState, b: jax.Array, k, *, reorth, proj_dtype, active=None, reorth_tol: float = 0.0, deflate_U=None):
    """One three-term-recurrence step producing basis vector k (all factors).

    Behavioural reference: /root/reference/src/orthogonal_bases.jl:39-139.
    Returns (state', orth_loss_estimate (scalar f64)). `active` (optional
    scalar bool) gates the state writes — see _apply_writes.

    reorth: False (plain TTR) | True (always-on extra CGS sweep) | 'auto'
    (loss-probe-triggered sweep via lax.cond — the reference's on-demand
    semantics at /root/reference/src/orthogonal_bases.jl:119-131, with the
    O(K·d·n) basis kept OUT of the conditional: only u (d, n) crosses it).
    The probe is |⟨v_k, v_0⟩| = |⟨u, b⟩| / (β·‖b_s‖) — genuine measured
    drift against the oldest basis vector, free because ⟨u, b⟩ is the b̃_k
    entry every path computes anyway. reorth_tol: trigger threshold; 0 →
    √eps of the compute dtype (reference uses √eps,
    /root/reference/src/orthogonal_bases.jl:125).
    """
    V, H, btil, beta = state
    dtype = V.dtype
    K, d, n = V.shape
    acc = _acc_dtype(dtype, proj_dtype)
    mode = "auto" if reorth == "auto" else ("always" if reorth else "plain")

    # the working vector u lives in the compute dtype; V is read in its
    # (possibly narrower, bf16) storage dtype and promoted on-chip
    v_prev = _col(V, k - 1)
    v_pprev = _col(V, jnp.maximum(k - 2, 0))

    loss = None
    u = spmv(op, v_prev.astype(acc))

    # subtract beta * v_{k-2} (zero contribution at k == 1 since beta == 0)
    u = u - beta.astype(acc)[:, None] * v_pprev.astype(acc)

    alpha = bdot(u, v_prev.astype(acc), acc).astype(proj_dtype)
    u = u - alpha.astype(acc)[:, None] * v_prev.astype(acc)

    if deflate_U is not None:
        # deflated Lanczos (deflate.py): keep the recurrence in the
        # orthogonal complement of the deflated invariant subspace —
        # without this per-step re-projection, roundoff re-grows the
        # deflated low modes, which exp(−γ_j·) then amplifies
        u = deflation_project(u, deflate_U, acc)

    if mode == "always":
        # one extra classical-GS sweep against the whole active prefix
        w = _project_coeffs(V, u, k, proj_dtype)
        u = _subtract_span(V, u, w, k)
        # loss estimate: how non-orthogonal the raw vector was (excluding the
        # intentional alpha/beta components already removed)
        loss = jnp.linalg.norm(w)

    beta_sq = bdot(u, u, acc).astype(proj_dtype)
    ub = bdot(u, b.astype(acc), acc).astype(proj_dtype)

    # v_0-drift probe: |⟨u, b⟩|/(β‖b_s‖) = |⟨v_k, v_0⟩| (b̃[:, 0] = ‖b_s‖)
    b_norms = btil[:, 0]
    beta_pre = jnp.sqrt(jnp.maximum(beta_sq, jnp.asarray(1e-300, proj_dtype)))
    probe = jnp.max(jnp.abs(ub) / (b_norms * beta_pre + jnp.asarray(1e-300, proj_dtype)))
    if loss is None:
        loss = probe

    if mode == "auto":
        import numpy as _np

        thresh = reorth_tol if reorth_tol > 0.0 else float(_np.sqrt(_np.finfo(_np.dtype(acc)).eps))

        def _sweep(u):
            w = _project_coeffs(V, u, k, proj_dtype)
            u2 = _subtract_span(V, u, w, k)
            bs = bdot(u2, u2, acc).astype(proj_dtype)
            ub2 = bdot(u2, b.astype(acc), acc).astype(proj_dtype)
            return u2, bs, ub2

        trigger = probe > jnp.asarray(thresh, proj_dtype)
        if active is not None:
            trigger = trigger & active
        u, beta_sq, ub = lax.cond(trigger, _sweep, lambda u: (u, beta_sq, ub), u)

    beta_new = jnp.sqrt(jnp.maximum(beta_sq, 0.0))
    # lucky breakdown: the factor's Krylov space is invariant — restart with
    # a fresh orthogonal direction (see _replace_lucky); β stays 0 in H,
    # which is the genuine coupling. Threshold on the COMPUTE dtype's eps
    # (the recurrence runs in u.dtype even when V is stored narrower).
    scale = jnp.abs(alpha) + beta + jnp.asarray(1e-300, proj_dtype)
    lucky = beta_new < 256.0 * jnp.finfo(u.dtype).eps * scale
    beta_new = jnp.where(lucky, 0.0, beta_new)
    safe = jnp.where(beta_new > 0, beta_new, 1.0)
    v_new = u / safe.astype(u.dtype)[:, None]
    v_new = _replace_lucky(V, v_new, lucky, k, proj_dtype, deflate_U=deflate_U)
    v_write = _gate_col(V, v_new, k, active)

    V = lax.dynamic_update_slice_in_dim(V, v_write.astype(dtype)[None], k, axis=0)
    # b̃_k = ⟨u/β, b⟩ = ub/β — no extra pass over n. A lucky restart
    # replaced v_new, so recompute then (cost paid only on actual breakdown).
    bt_new = ub / safe
    bt_new = lax.cond(
        jnp.any(lucky),
        lambda: bdot(v_new, b.astype(u.dtype), u.dtype).astype(proj_dtype),
        lambda: bt_new,
    )
    if active is not None:
        keep = lambda new, old: jnp.where(active, new, old)
        H_new = _set_entry(_set_entry(_set_entry(H, k - 1, k - 1, alpha), k, k - 1, beta_new), k - 1, k, beta_new)
        H = keep(H_new, H)
        btil = keep(_set_vec_entry(btil, k, bt_new), btil)
        beta_new = keep(beta_new, beta)
    else:
        H = _set_entry(H, k - 1, k - 1, alpha)
        H = _set_entry(H, k, k - 1, beta_new)
        H = _set_entry(H, k - 1, k, beta_new)
        btil = _set_vec_entry(btil, k, bt_new)
    return KrylovState(V, H, btil, beta_new), loss


def arnoldi_step(op: KroneckerSumOperator, state: KrylovState, b: jax.Array, k, *, proj_dtype, active=None):
    """One CGS2 Arnoldi step producing basis vector k (all factors).

    Behavioural reference: MGS x2 at /root/reference/src/orthogonal_bases.jl:15-37.
    """
    V, H, btil, beta = state
    dtype = V.dtype
    K, d, n = V.shape
    acc = _acc_dtype(dtype, proj_dtype)

    v_prev = _col(V, k - 1)
    u = spmv(op, v_prev.astype(acc))

    w1 = _project_coeffs(V, u, k, proj_dtype)
    u = _subtract_span(V, u, w1, k)
    w2 = _project_coeffs(V, u, k, proj_dtype)
    u = _subtract_span(V, u, w2, k)
    h = w1 + w2  # (d, K) Hessenberg column entries 0..k-1

    h_new = jnp.sqrt(bdot(u, u, acc).astype(proj_dtype))
    scale = jnp.sum(jnp.abs(h), axis=1) + jnp.asarray(1e-300, proj_dtype)
    lucky = h_new < 256.0 * jnp.finfo(u.dtype).eps * scale
    h_new = jnp.where(lucky, 0.0, h_new)
    safe = jnp.where(h_new > 0, h_new, 1.0)
    v_new = u / safe.astype(u.dtype)[:, None]
    v_new = _replace_lucky(V, v_new, lucky, k, proj_dtype)
    v_write = _gate_col(V, v_new, k, active)

    V = lax.dynamic_update_slice_in_dim(V, v_write.astype(dtype)[None], k, axis=0)
    # write the whole Hessenberg column j = k-1: rows 0..k-1 from h, row k = h_new
    col = h + _set_vec_entry(jnp.zeros_like(h), k, h_new)  # (d, K)
    zero = jnp.zeros((), jnp.int32)
    H_new = lax.dynamic_update_slice(H, col[:, :, None], (zero, zero, jnp.asarray(k - 1, jnp.int32)))
    bt_new = bdot(v_new, b.astype(acc), acc).astype(proj_dtype)
    if active is not None:
        keep = lambda new, old: jnp.where(active, new, old)
        H = keep(H_new, H)
        btil = keep(_set_vec_entry(btil, k, bt_new), btil)
        h_new = keep(h_new, beta)
    else:
        H = H_new
        btil = _set_vec_entry(btil, k, bt_new)
    loss = jnp.linalg.norm(w2)
    return KrylovState(V, H, btil, h_new), loss


def _set_entry(H, i, j, vals):
    """H[:, i, j] = vals with traced i, j."""
    zero = jnp.zeros((), jnp.int32)
    i = jnp.asarray(i, jnp.int32)
    j = jnp.asarray(j, jnp.int32)
    return lax.dynamic_update_slice(H, vals.astype(H.dtype)[:, None, None], (zero, i, j))


def _set_vec_entry(btil, j, vals):
    zero = jnp.zeros((), jnp.int32)
    j = jnp.asarray(j, jnp.int32)
    return lax.dynamic_update_slice(btil, vals.astype(btil.dtype)[:, None], (zero, j))


def _batch_algorithm(op, b, k, stepper, proj_dtype):
    b = jnp.asarray(b)
    if b.ndim == 1:
        b = b[None, :]
    state, _ = init_state(op, b, k, proj_dtype)

    def body(j, st):
        st2, _ = stepper(op, st, b, j)
        return st2

    return lax.fori_loop(1, k + 1, body, state)


def lanczos_algorithm(op: KroneckerSumOperator, b, k: int, *, reorth: bool = False, proj_dtype=jnp.float64) -> KrylovState:
    """Run k Lanczos steps for every factor; standalone driver (analogue of
    /root/reference/src/orthogonal_bases.jl:199-229). b: (d, n) or (n,)."""
    return _batch_algorithm(
        op, b, k,
        lambda o, st, bb, j: lanczos_step(o, st, bb, j, reorth=reorth, proj_dtype=proj_dtype),
        proj_dtype,
    )


def arnoldi_algorithm(op: KroneckerSumOperator, b, k: int, *, proj_dtype=jnp.float64) -> KrylovState:
    """Run k Arnoldi (CGS2) steps for every factor; standalone driver
    (analogue of /root/reference/src/orthogonal_bases.jl:182-197)."""
    return _batch_algorithm(
        op, b, k,
        lambda o, st, bb, j: arnoldi_step(o, st, bb, j, proj_dtype=proj_dtype),
        proj_dtype,
    )


def orthogonality_loss(V: jax.Array, k, proj_dtype=jnp.float64) -> jax.Array:
    """‖V_k^T V_k − I‖_F over the active prefix, maximized over factors.

    Diagnostic analogue of /root/reference/src/orthogonal_bases.jl:246-262.
    O(d·n·K²) — telemetry, not in the solver hot path by default.
    """
    K, d, n = V.shape
    G = einsum("kdn,ldn->dkl", V, V, preferred_element_type=proj_dtype)
    m = _prefix_mask(K, k, G.dtype)
    eye = jnp.eye(K, dtype=G.dtype)
    E = (G - eye) * m[None, :, None] * m[None, None, :]
    return jnp.max(jnp.sqrt(jnp.sum(E * E, axis=(1, 2))))
