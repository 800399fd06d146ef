"""Per-factor spectral deflation — the κ-barrier breaker for huge modes.

Capability beyond the reference (which has nothing like it): the iteration
count of the exp-sum tensor-Krylov solve scales like k* ≈ c·√κ(A_s)
(measured c ≈ 2.8 on shifted-Laplace systems — see docs/northstar.md), so a
production-size mode (n_s ~ 1e5) is out of reach for a plain Krylov basis
even when the certified tolerance is attainable in f64. Deflating the
lowest m eigenpairs of each (tridiagonal) factor:

    A_s U_s = U_s Λ_s,  U_s ∈ ℝ^{n×m} orthonormal  (host LAPACK, O(n·m))

splits every exponential action exactly:

    exp(−γ_j A_s) b_s = U_s exp(−γ_j Λ_s) (U_sᵀ b_s)            [exact]
                      + exp(−γ_j A_s) b⊥_s,   b⊥_s = b_s − U_s U_sᵀ b_s

and the Krylov recurrence only has to approximate the second term, whose
spectral interval is [λ_{m+1}, λ_max] — an effective condition number
κ_eff = κ·λ_1/λ_{m+1}. For the shifted Laplacian, λ_{m+1} ≈ σ + π²(m+1)²
grows quadratically in m, so a modest m collapses k* by orders of magnitude
(d=10, n=131072, κ=1e6: k* ≈ 2800 plain → ≈ 230 with m=1024).

The recurrence stays in the U-complement by re-projecting the working
vector every step (ops/orth.py:deflation_project — one GEMM pass over U per
step, shared across factors when they are identical). The exponential-sum
coefficients are still selected for the FULL interval [λ_min(A), λ_max(A)]
(cross-factor eigenvalue sums mix deflated and undeflated components), with
λ_min now EXACT from the deflated pairs.

Residual evaluation is the Lemma-3.4 algebra in the joint per-factor basis
B_s = [U_s | V_s | v_{k+1}]: the operator action closes exactly there
(A_s U = U Λ;  A_s V y = V T y + β_k y_k v_{k+1}), so `residual_norm_sq`
applied to the block-diagonal joint projection equals the TRUE full
residual ‖A x − b‖ (up to basis orthonormality drift) with no separate
boundary term. The final certificate re-evaluates ‖b − A x‖ from the raw
CP vectors (basis-free) with the rank-pair contraction in extended
precision (utils/cp.py:cp_norm_accurate).

Behavioural reference for everything this builds on:
/root/reference/src/tensor_krylov_method.jl:10-34 (exp-sum solve),
/root/reference/src/utils.jl:402-443 (residual algebra). The deflation
itself has no reference counterpart.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .coeffs.tables import BHTables, load_tables, select_bh
from .ops.eigen import masked_eigh, masked_eigh_tridiag_mixed
from .ops.expsum import cp_solve_sym
from .ops.gram import residual_norm_sq
from .ops.orth import bdot, deflation_project
from .df64_core import (  # split out (VERDICT r4 #8); same contracts
    _DF64_SWEEP_COLS,
    _Df64State,
    _df64_advance,
    _df64_assemble_chunk,
    _df64_gram_deviation_host,
    _df64_gram_row_chunk,
    _df64_ulift_chunk,
    _eft_eps,
    _evaluate_host_recorded,
    _split32,
)
from .deflate_light import (
    _LightState,
    _advance_light,
    _advance_light_store,
    _boundary_reorth,
    _pass2_accumulate,
    _pass2_host,
    _project_and_renorm,
    _project_with_leak,
    _sweep_block,
    Pass2Audit,
)
from .types import CPTensor, KroneckerSumOperator, SolverConfig, Status
from .utils.cp import cp_residual_cross_check
from .ops.precision import einsum

__all__ = ["DeflationBasis", "deflation_basis", "solve_deflated", "DeflatedResult"]


class DeflationBasis(NamedTuple):
    """Lowest-m eigenpairs of every factor. U: (1, n, m) when all factors are
    identical (shared — one projection GEMM per step regardless of d) or
    (d, n, m); lam: (d, m) ascending."""

    U: jax.Array
    lam: jax.Array

    @property
    def m(self) -> int:
        return self.U.shape[2]


def _tridiag_parts(bands: np.ndarray, offsets: Tuple[int, ...]):
    """(diag (d, n), offdiag e (d, n-1)) with e[i] coupling rows i, i+1.

    A symmetric tridiagonal operator may be stored with either the -1 band,
    the +1 band, or both; read whichever is present and cross-check that a
    doubly-stored coupling is actually symmetric (ADVICE r2: an operator
    with only the +1 band used to silently yield e ≡ 0)."""
    d, nb, n = bands.shape
    diag = np.zeros((d, n))
    e_lo = e_hi = None
    for bidx, off in enumerate(offsets):
        if off == 0:
            diag += bands[:, bidx, :]
        elif off == -1:
            e_lo = bands[:, bidx, 1:].copy()  # bands[s,b,i] = A[i, i-1], i ≥ 1
        elif off == 1:
            e_hi = bands[:, bidx, :-1].copy()  # bands[s,b,i] = A[i, i+1], i < n-1
    if e_lo is not None and e_hi is not None:
        if not np.allclose(e_lo, e_hi, rtol=0.0, atol=0.0):
            raise ValueError(
                "offsets (-1, +1) bands disagree: operator marked symmetric "
                "but A[i, i-1] != A[i-1, i]"
            )
        return diag, e_lo
    if e_lo is not None:
        return diag, e_lo
    if e_hi is not None:
        return diag, e_hi
    return diag, np.zeros((d, n - 1))


def _toeplitz_lowest_m(n: int, m: int, a: float, b: float):
    """Analytic lowest-m eigenpairs of the symmetric tridiagonal *Toeplitz*
    matrix tridiag(b, a, b): λ_j = a + 2b·cos(jπ/(n+1)), v_j(i) =
    √(2/(n+1))·sin(ijπ/(n+1)) — the reference's analytic Laplace spectrum
    (/root/reference/src/eigenvalues.jl:226-265) generalized to any constant
    diagonal shift. O(n·m) sin evaluations (~seconds at the flagship
    n=131072, m=1024) where LAPACK stebz/stein takes minutes. The integer
    phase i·j is reduced mod 2(n+1) exactly before the float multiply, so
    every sin argument stays in [0, 2π) with ~ulp error."""
    j_all = np.arange(1, n + 1, dtype=np.int64)
    # b ≤ 0 → λ increases with j (lowest at j=1); b > 0 → reversed
    js = j_all[:m] if b <= 0 else j_all[::-1][:m]
    lam = a + 2.0 * b * np.cos(js * (np.pi / (n + 1)))
    i = np.arange(1, n + 1, dtype=np.int64)
    phase = (i[:, None] * js[None, :]) % (2 * (n + 1))
    U = np.sqrt(2.0 / (n + 1)) * np.sin(phase * (np.pi / (n + 1)))
    return lam.astype(np.float64), U


def deflation_basis(
    op: KroneckerSumOperator, m: int, dtype=None
) -> DeflationBasis:
    """Host-side setup (one-time, off the hot path — the analogue of the
    reference's coefficient-file loading): lowest-m eigenpairs per factor.

    Constant-coefficient tridiagonal factors (Laplace / reaction–diffusion,
    the flagship family) take the analytic Toeplitz path (`_toeplitz_lowest_m`,
    sin eigenvectors — seconds at n=1e5); other tridiagonal symmetric factors
    use LAPACK stebz/stein via scipy.linalg.eigh_tridiagonal (O(n·m));
    anything else falls back to a dense eigh of the materialized factor
    (small-n path). Identical factors are detected and computed once
    (U shape (1, n, m)).
    """
    if not op.symmetric:
        raise ValueError("deflation requires a symmetric (SPD) operator")
    bands = np.asarray(op.bands, np.float64)
    d, nb, n = bands.shape
    if not 0 < m < n:
        raise ValueError(f"need 0 < m < n, got m={m}, n={n}")
    dtype = dtype or op.dtype

    shared = all(np.array_equal(bands[0], bands[s]) for s in range(1, d))
    tridiag = set(op.offsets) <= {-1, 0, 1}

    def lowest_m(s: int):
        if tridiag:
            diag, e = _tridiag_parts(bands[s : s + 1], op.offsets)
            a, off = diag[0], e[0]
            if (
                off.size
                and np.all(a == a[0])
                and np.all(off == off[0])
                and off[0] != 0.0
            ):
                return _toeplitz_lowest_m(n, m, float(a[0]), float(off[0]))
            from scipy.linalg import eigh_tridiagonal

            w, U = eigh_tridiagonal(
                diag[0], e[0], select="i", select_range=(0, m - 1)
            )
        else:
            from .models.gallery import bands_to_dense

            A = bands_to_dense(
                KroneckerSumOperator(jnp.asarray(bands[s : s + 1]), op.offsets, True)
            )[0]
            w, U = np.linalg.eigh(A)
            w, U = w[:m], U[:, :m]
        return w, U

    if shared:
        w0, U0 = lowest_m(0)
        lam = np.broadcast_to(w0, (d, m))
        U = U0[None]
    else:
        pairs = [lowest_m(s) for s in range(d)]
        lam = np.stack([p[0] for p in pairs])
        U = np.stack([p[1] for p in pairs])
    # host-resident (numpy) on purpose: solve_deflated controls WHEN U goes
    # to the device (after the big basis allocation)
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    return DeflationBasis(np.asarray(U, np_dtype), np.asarray(lam, np.float64))


@dataclasses.dataclass(frozen=True)
class DeflatedResult:
    """Solution + the three-tier residual evidence:

      * relative_residual — Lemma-3.4 estimate per checkpoint (floors at
        ~√eps·(CP term mass)/‖b‖, DESIGN.md §6; informative above ~1e-8).
      * certified_bound — RIGOROUS per-checkpoint bound (modulo f64 basis
        orthonormality): sup|1−x·g(x)| over the certified spectral interval
        (analytic exp-sum error, extended precision) + √(Σ_s β²‖y_𝔏‖²)/‖b‖
        (measured Krylov boundary, a cancellation-free sum of positives).
        Convergence is declared on THIS bound.
      * measured_cp_residual — basis-free ‖b − A x‖/‖b‖ from the raw CP
        vectors (utils/cp.py:cp_residual_cross_check); independent of every
        solver assumption — a cross-check, not a bound. Only meaningful
        above its own floor `cp_residual_floor` (√(eps64·Gram-mass)/‖b‖):
        a reading ≤ floor is the statement "residual ≤ floor", nothing
        finer.
    """

    x: CPTensor
    status: int
    niterations: int                  # Krylov steps taken (excl. deflated part)
    m: int                            # deflation rank
    relative_residual: List[float]    # Lemma-3.4 estimate per checkpoint
    certified_bound: List[float]      # rigorous bound per checkpoint
    checkpoints: List[int]
    measured_cp_residual: Optional[float]
    expsum_sup: float                 # sup|1−x g(x)| component of the bound
    expsum_rank: int
    lambda_min: float                 # exact (deflated) λ_min of A
    lambda_max: float                 # Gershgorin upper bound on λ_max of A
    # measured orthonormality drift of the basis: max_k |⟨v_k, v₀⟩| (the
    # free b̃ probe) — quantifies the certificate's basis slack
    orthogonality_drift: float = 0.0
    # validity floor of measured_cp_residual (same ‖b‖ normalization)
    cp_residual_floor: Optional[float] = None
    # storage='twopass' replay audit (Pass2Audit): sampled pairwise
    # |⟨v_k, probe⟩| max, and the replayed-vs-recorded β deviation
    pass2_gram_max: Optional[float] = None
    pass2_beta_rel_dev: Optional[float] = None
    # max measured pre-projection U-leak max|Uᵀu|/‖u‖ (evidence for
    # project_every > 1; always measured on the twopass path)
    projection_leak: Optional[float] = None
    # storage='segmented': max measured pre-correction overlap |⟨v, V⟩| at
    # the segment-boundary full reorthogonalizations — the drift that WAS
    # there and was removed
    boundary_drift_max: Optional[float] = None
    # storage='df64' v2 (noise-recording) certificate decomposition at the
    # final checkpoint: bound = expsum_sup + boundary + dev + eta + r2
    # (see _evaluate_host_recorded). All measured except eta, whose
    # eps_elem constant is itself measured in-process (eft_selfcheck).
    relation_dev_term: Optional[float] = None     # recorded commit devs
    relation_eta_term: Optional[float] = None     # expansion elementwise
    relation_r2_term: Optional[float] = None      # 2nd-order Frechet tail
    perturbation_rho: Optional[float] = None      # max_s ||[C_s; W_s]||_F
    # FULL-basis orthonormality bound max|VᵀV − I| (r4: supersedes the
    # sampled Pass2Audit probes for the df64 path — VERDICT r3 #5)
    gram_deviation: Optional[float] = None
    eft_eps_measured: Optional[float] = None      # composed-EFT selfcheck

    @property
    def converged(self):
        return self.status == Status.CONVERGED


def _gershgorin_per_factor(op: KroneckerSumOperator) -> np.ndarray:
    """Per-factor Gershgorin upper bounds on λ_max(A_s) from the band rows."""
    bands = np.asarray(op.bands, np.float64)
    d, nb, n = bands.shape
    per_factor = np.zeros(d)
    for s in range(d):
        rows = np.zeros(n)
        for bidx, off in enumerate(op.offsets):
            col = bands[s, bidx]
            if off == 0:
                rows += col
            else:
                rows += np.abs(col)
        per_factor[s] = rows.max()
    return per_factor


def _gershgorin_max(op: KroneckerSumOperator) -> float:
    """Exact upper bound on λ_max(A) = Σ_s λ_max(A_s) from the band rows."""
    return float(_gershgorin_per_factor(op).sum())



class _DeflState(NamedTuple):
    """Deflated-Lanczos state in the (d, K, n) layout.

    The generic KrylovState stores V as (K, d, n) — optimal for the f32
    small-step writes. Here V is (d, K, n) and is WRITE-ONLY in the hot
    loop: the three-term
    recurrence carries v_{k-1}, v_{k-2} explicitly, and T is stored as
    diag/offdiag vectors instead of a dense (d, K, K) matrix.

    r3 layout fix: V is stored 2-D as (K·d, n) in k-major row order (step k
    owns the contiguous row block [k·d, (k+1)·d)). The 3-D (d, K, n) layout
    let XLA pick d as the sublane dimension (minor-to-major {2,0,1}), which
    pads 10 → 16 — a 1.6× expansion that, with the f64 X64Combine temp,
    OOM'd the m=2048 flagship at 16.5 GB. A 2-D buffer's sublane dim is
    K·d, which pads by < 8 rows. Reshape to (K, d, n) is free for reads
    (same memory order)."""

    V: jax.Array     # (K*d, n), row k*d+s = basis column k of factor s
    dg: jax.Array    # (d, K) T diagonal: dg[:, j] = α for column j
    od: jax.Array    # (d, K) T offdiag: od[:, j] couples columns j-1, j
    btil: jax.Array  # (d, K) ⟨v_j, b⊥⟩ (≈ β₀ e₀; the rest is drift telemetry)
    vp: jax.Array    # (d, n) v_{k-1}
    vpp: jax.Array   # (d, n) v_{k-2}
    beta: jax.Array  # (d,) last offdiagonal


@functools.partial(jax.jit, static_argnames=("K", "pdt"))
def _init_defl_state(b_perp, K: int, pdt) -> Tuple[_DeflState, jax.Array]:
    """jitted so the zeros→first-column write fuses into ONE (d, K, n)
    allocation — the eager zeros + dynamic_update_slice pair materialized
    the flagship basis TWICE (2 × 7.4 GB) and OOM'd the chip."""
    d, n = b_perp.shape
    b_norms = jnp.linalg.norm(b_perp.astype(pdt), axis=1)
    # b⊥_s = 0 (b_s entirely inside span(U_s)) is legal: freeze that factor's
    # recurrence at zero instead of poisoning the state with NaN
    v0 = (b_perp.astype(pdt) / jnp.where(b_norms > 0, b_norms, 1.0)[:, None]).astype(pdt)
    V = jnp.zeros((K * d, n), pdt)
    V = lax.dynamic_update_slice(V, v0, (0, 0))
    # distinct buffers (dg/od/btil feed a donated argument — aliased zeros
    # would be donated twice)
    dg = jnp.zeros((d, K), pdt)
    od = jnp.zeros((d, K), pdt)
    btil = jnp.zeros((d, K), pdt).at[:, 0].set(b_norms)
    return (
        _DeflState(V, dg, od, btil, v0, jnp.zeros_like(v0), jnp.zeros((d,), pdt)),
        b_norms,
    )


@functools.partial(
    jax.jit,
    static_argnames=("reorth", "reorth_tol", "project_every"),
    donate_argnums=(1,),
)
def _advance(op, state: _DeflState, b_perp, U, k0, k1, *, reorth,
             reorth_tol: float = 0.0, project_every: int = 1):
    """Run Lanczos steps k0..k1-1 (step k writes basis column k) with
    per-step (or strided — see _advance_light) deflation projection; f64
    throughout (proj dtype = V dtype)."""
    from .ops.banded import spmv

    pdt = state.V.dtype
    d, n = state.vp.shape
    K = state.dg.shape[1]
    thresh = reorth_tol if reorth_tol > 0.0 else float(np.sqrt(np.finfo(np.float64).eps))

    def body(k, st: _DeflState) -> _DeflState:
        u = spmv(op, st.vp) - st.beta[:, None] * st.vpp
        alpha = bdot(u, st.vp, pdt)
        u = u - alpha[:, None] * st.vp
        if project_every > 1:
            u = lax.cond(
                k % project_every == 0,
                lambda u: deflation_project(u, U, pdt),
                lambda u: u,
                u,
            )
        else:
            u = deflation_project(u, U, pdt)

        def sweep(u):
            # block-sequential CGS over static column chunks: each chunk's
            # einsum operand stays under the f64-emulation splat budget
            # (ops/orth.py:_PROJ_CHUNK_ELEMS); small K ⇒ one chunk, the
            # original single-sweep path
            from .ops.orth import _proj_col_chunk

            C = _proj_col_chunk(d * n, K)
            for c0 in range(0, K, C):
                Cc = min(C, K - c0)
                Vc = st.V[c0 * d:(c0 + Cc) * d].reshape(Cc, d, n)
                mask = ((c0 + jnp.arange(Cc))[:, None] < k).astype(pdt)
                w = einsum("kdn,dn->kd", Vc, u,
                               preferred_element_type=pdt) * mask
                u = u - einsum("kdn,kd->dn", Vc, w,
                                   preferred_element_type=pdt)
            return u

        if reorth == "always":
            u = sweep(u)
        beta_sq = bdot(u, u, pdt)
        ub = bdot(u, b_perp.astype(pdt), pdt)
        if reorth == "auto":
            # v₀-drift probe |⟨v_k, v₀⟩| = |⟨u, b⊥⟩|/(β‖b⊥_s‖)
            bn = st.btil[:, 0]
            probe = jnp.max(
                jnp.abs(ub) / (bn * jnp.sqrt(jnp.maximum(beta_sq, 1e-300)) + 1e-300)
            )

            def do_sweep(u):
                u2 = sweep(u)
                return (
                    u2,
                    bdot(u2, u2, pdt),
                    bdot(u2, b_perp.astype(pdt), pdt),
                )

            u, beta_sq, ub = lax.cond(
                probe > thresh, do_sweep, lambda u: (u, beta_sq, ub), u
            )

        beta_new = jnp.sqrt(jnp.maximum(beta_sq, 0.0))
        # exhaustion/breakdown: an (near-)invariant deflated subspace makes
        # β ≈ 0 — freeze with an inert zero column (A·0 = 0, ⟨·,0⟩ = 0)
        lucky = beta_new < 256.0 * jnp.finfo(pdt).eps * (jnp.abs(alpha) + st.beta + 1e-300)
        beta_new = jnp.where(lucky, 0.0, beta_new)
        safe = jnp.where(beta_new > 0, beta_new, 1.0)
        v_new = jnp.where(lucky[:, None], 0.0, u / safe[:, None])

        zero = jnp.zeros((), k.dtype) if hasattr(k, "dtype") else 0
        V = lax.dynamic_update_slice(st.V, v_new, (k * d, zero))
        dg = lax.dynamic_update_slice(st.dg, alpha[:, None], (zero, k - 1))
        od = lax.dynamic_update_slice(st.od, beta_new[:, None], (zero, k))
        btil = lax.dynamic_update_slice(st.btil, (ub / safe)[:, None], (zero, k))
        return _DeflState(V, dg, od, btil, v_new, st.vp, beta_new)

    return lax.fori_loop(k0, k1, body, state)


def expsum_sup_error(omega, alpha, kappa: float, n_grid: int = 200_000) -> float:
    """sup_{x ∈ [1, κ]} |1 − x·Σ_j ω_j e^{−α_j x}| — the analytic relative-
    residual bound of the exponential-sum inverse, evaluated on host in
    extended precision (the quantity itself is stable: 1 − x·g cancels only
    at the eps level, so longdouble gives ~1e-19 absolute accuracy — far
    below any certifiable target). Log-spaced grid; the error function's
    finest oscillation scale near x = 1 is ~1/α_max ≫ the grid spacing for
    the table's α ranges."""
    om = np.asarray(omega, np.float64).astype(np.longdouble)
    al = np.asarray(alpha, np.float64).astype(np.longdouble)
    x = np.exp(np.linspace(0.0, np.log(np.longdouble(kappa)), n_grid))
    g = np.zeros_like(x)
    for w_, a_ in zip(om, al):
        if w_ != 0.0:
            g += w_ * np.exp(-a_ * x)
    return float(np.max(np.abs(1.0 - x * g)))


@functools.partial(jax.jit, static_argnames=("eigh_impl",))
def _evaluate(
    dg, od, btil, beta,  # (d, K) T diag/offdiag, compressed RHS, (d,) β_k
    k,
    lam,            # (d, m) deflated eigenvalues
    c,              # (d, m) U-coefficients of b
    b_norm,         # scalar ‖b‖ = Π_s ‖b_s‖
    lam_min,        # exact Σ_s λ_1 (scalar)
    omega, alpha, t_mask,  # (tmax,) exp-sum coefficients (fixed per solve)
    eigh_impl: str = "dense",
):
    """Projected solve + joint-basis residual at Krylov size k.

    Returns (rel_est, boundary_rel_sq, Yu (d, m, tmax), Yv (d, K, tmax),
    weights (tmax,)). boundary_rel_sq is the cancellation-free part of the
    Lemma-3.4 residual (Σ_s β_k²‖y_𝔏‖² — a sum of positives), used by the
    rigorous certificate; rel_est additionally includes the compressed part,
    which floors at ~√eps·(term mass) (DESIGN.md §6)."""
    d, K = dg.shape
    m = lam.shape[1]
    pdt = dg.dtype

    # dense padded T from the diag/offdiag vectors (k-sized work only)
    idx = jnp.arange(K)
    H = jnp.zeros((d, K, K), pdt)
    H = H.at[:, idx, idx].set(dg)
    H = H.at[:, idx[1:], idx[1:] - 1].set(od[:, 1:])
    H = H.at[:, idx[1:] - 1, idx[1:]].set(od[:, 1:])

    # V-block: exp(−γ_j T_s) b̃ via eigh of the masked tridiagonal minor
    # (dense eigh, or on request the mixed-precision tridiagonal solver —
    # T is tridiagonal by construction).
    if eigh_impl == "tridiag_mixed":
        w, Q = masked_eigh_tridiag_mixed(H, k)
    else:
        w, Q = masked_eigh(H, k)
    weights, Yv = cp_solve_sym(w, Q, btil, k, omega, alpha, t_mask, lam_min)

    # U-block: exp(−γ_j Λ_s) c_s — exact diagonal scaling
    gam = (alpha / lam_min)[None, None, :]                            # (1,1,t)
    ex_u = jnp.exp(-jnp.clip(lam[:, :, None] * gam, -700.0, 700.0))
    Yu = (ex_u * c[:, :, None]) * t_mask[None, None, :]               # (d,m,t)

    # joint projection: blockdiag(Λ_s, T_s). The operator action closes in
    # the joint basis [U_s | V_s | v_{k+1}] (module docstring), so the
    # Lemma-3.4 evaluation over it is the TRUE full residual: compressed
    # part over the active prefix m+k, boundary via subdiag = β_k.
    P = m + K
    Hj = jnp.zeros((d, P, P), pdt)
    im = jnp.arange(m)
    Hj = Hj.at[:, im, im].set(lam.astype(pdt))
    Hj = lax.dynamic_update_slice(Hj, H, (0, m, m))
    Yj = jnp.concatenate([Yu.astype(pdt), Yv], axis=1)                # (d,P,t)
    btil_j = jnp.concatenate([c.astype(pdt), btil], axis=1)           # (d,P)

    terms = residual_norm_sq(Hj, Yj, btil_j, m + k, weights, beta)
    rel_est = jnp.sqrt(terms.r_norm_sq) / b_norm
    boundary_rel_sq = terms.boundary_sq / (b_norm * b_norm)
    return rel_est, boundary_rel_sq, Yu, Yv, weights


def _evaluate_host(dg, od, btil, beta, k, lam, c, b_norm, lam_min,
                   omega, alpha, t_mask):
    """Host (numpy) twin of `_evaluate` — exact-size, no padding.

    Rationale: the checkpoint algebra is tiny (k ≤ ~1e3), so `eigh_impl='host'` runs it in
    scipy/numpy between jitted segments: per-factor tridiagonal eigh, then
    the O(d²t²) rank-pair contraction in longdouble — the reference's own
    MVnorm strategy (/root/reference/src/utils.jl:255-324), which on host
    costs microseconds and gains ~3 decades on the cancellation floor.
    Returns (rel, boundary_rel_sq, Yu, Yv, weights) with device-compatible
    padded shapes."""
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
    for s in range(d):
        w_s, Q_s = eigh_tridiagonal(dg[s, :k], od[s, 1:k])
        g = Q_s.T @ btil[s, :k]
        ex = np.exp(-np.clip(w_s[:, None] * gam[None, :], -700.0, 700.0))
        Yv_k[s] = Q_s @ (ex * g[:, None])
        Zv_k[s] = Q_s @ ((w_s[:, None] * ex) * g[:, None])      # T_s @ Yv

    ex_u = np.exp(-np.clip(lam[:, :, None] * gam[None, None, :], -700.0, 700.0))
    Yu_k = ex_u * c[:, :, None]                                 # (d, m, t)
    Zu_k = lam[:, :, None] * Yu_k

    # joint per-mode factors [U-block; V-block] and their Grams (longdouble)
    Y = np.concatenate([Yu_k, Yv_k], axis=1)                    # (d, m+k, t)
    Z = np.concatenate([Zu_k, Zv_k], axis=1)
    bt = np.concatenate([c, btil[:, :k]], axis=1)               # (d, m+k)
    Gy = np.einsum("dpi,dpj->dij", Y, Y).astype(ld)
    Gz = np.einsum("dpi,dpj->dij", Z, Z).astype(ld)
    Xg = np.einsum("dpi,dpj->dij", Y, Z).astype(ld)             # YᵀZ
    yb = np.einsum("dpi,dp->di", Y, bt).astype(ld)
    zb = np.einsum("dpi,dp->di", Z, bt).astype(ld)
    b2 = np.prod(np.einsum("dp,dp->d", bt, bt).astype(ld))
    wl = np.asarray(w_t, ld)

    # ‖Hy‖²: modes contribute Gz (s=s'=mode), X (one of them), Gy (neither)
    hy2 = ld(0.0)
    for s in range(d):
        for sp in range(d):
            P = np.ones((t, t), ld)
            for mo in range(d):
                if mo == s and mo == sp:
                    P *= Gz[mo]
                elif mo == s:
                    P *= Xg[mo].T                                # ⟨Z_i, Y_j⟩
                elif mo == sp:
                    P *= Xg[mo]                                  # ⟨Y_i, Z_j⟩
                else:
                    P *= Gy[mo]
            hy2 += wl @ P @ wl
    # ⟨Hy, b̃⟩
    ip = ld(0.0)
    for s in range(d):
        P = np.ones((t,), ld)
        for mo in range(d):
            P *= zb[mo] if mo == s else yb[mo]
        ip += wl @ P
    r_comp_sq = hy2 - 2.0 * ip + b2

    # boundary: last V-row of each mode, excluded-product Grams
    yr = Yv_k[:, k - 1, :].astype(ld)                           # (d, t)
    boundary = ld(0.0)
    for s in range(d):
        E = np.ones((t, t), ld)
        for mo in range(d):
            if mo != s:
                E *= Gy[mo]
        bg = np.outer(yr[s], yr[s]) * ld(beta[s]) ** 2
        boundary += wl @ (bg * E) @ wl
    boundary = float(boundary)

    rel = float(np.sqrt(boundary + max(float(r_comp_sq), 0.0))) / b_norm
    brs = boundary / (b_norm * b_norm)

    # pad back to device conventions: (d, K, tmax) columns masked by t_mask
    Yv = np.zeros((d, K, tmax))
    Yu = np.zeros((d, m, tmax))
    Yv[:, :k, act] = Yv_k
    Yu[:, :, act] = Yu_k
    weights = np.zeros((tmax,))
    weights[act] = w_t
    return rel, brs, Yu, Yv, weights


def _u_lift(U, Yu):
    """U·Yu → (d, n, t); U is (1, n, m) shared or (d, n, m) distinct.
    Chunked over U columns (f64-emulation splat budget, ops/orth.py)."""
    from .ops.orth import _proj_col_chunk

    n, m = U.shape[1], U.shape[2]
    # distinct-factor U slices are (d, n, C): budget d-aware (ADVICE r3)
    C = _proj_col_chunk(U.shape[0] * n, m)
    out = None
    for c0 in range(0, m, C):
        if U.shape[0] == 1:
            term = jnp.einsum("nm,dmt->dnt", U[0, :, c0:c0 + C].astype(Yu.dtype),
                              Yu[:, c0:c0 + C, :])
        else:
            term = jnp.einsum("dnm,dmt->dnt", U[:, :, c0:c0 + C].astype(Yu.dtype),
                              Yu[:, c0:c0 + C, :])
        out = term if out is None else out + term
    return out


@functools.partial(jax.jit, static_argnames=())
def _assemble(U, V, Yu, Yv, k):
    """Real-space CP factors: U·Yu + V·Yv (V (K·d, n) k-major, columns < k).
    Chunked over V columns for the same f64-emulation splat budget as the
    sweep; the U-lift goes through the chunked deflation-project-style
    einsums implicitly (small Yu)."""
    from .ops.orth import _proj_col_chunk

    d, K = Yv.shape[0], Yv.shape[1]
    n = V.shape[1]
    mask = (jnp.arange(K) < k).astype(Yv.dtype)
    Yvm = Yv * mask[None, :, None]
    C = _proj_col_chunk(d * n, K)
    xv = jnp.zeros((d, n, Yv.shape[2]), Yv.dtype)
    for c0 in range(0, K, C):
        Cc = min(C, K - c0)
        Vc = V[c0 * d:(c0 + Cc) * d].reshape(Cc, d, n)
        xv = xv + jnp.einsum(
            "kdn,dkt->dnt", Vc.astype(Yv.dtype), Yvm[:, c0:c0 + Cc, :]
        )
    return _u_lift(U, Yu) + xv


def solve_deflated(
    op: KroneckerSumOperator,
    b,
    config: Optional[SolverConfig] = None,
    *,
    m: int = 64,
    basis: Optional[DeflationBasis] = None,
    tables: Optional[BHTables] = None,
    checkpoints: Optional[Sequence[int]] = None,
    certify: bool = True,
    storage: str = "auto",
    mesh=None,
    comm: str = "gspmd",
    state_cache: Optional[str] = None,
    project_every: int = 1,
    verbose: bool = False,
    pass2_impl: str = "auto",
    segment: int = 32,
    sweep_every: int = 1,
    final: str = "auto",
    save_state: bool = True,
    save_every: int = 0,
    advance_budget: Optional[int] = None,
) -> DeflatedResult:
    """Solve A x = b (SPD Kronecker sum, rank-1 b) with per-factor spectral
    deflation of rank m. Host-orchestrated: jitted Lanczos segments between
    geometric checkpoints, a jitted joint-basis residual at each checkpoint,
    stop when `config.tol` is certified or `config.kmax` is exhausted.

    `basis`: pass a precomputed DeflationBasis to amortize the setup across
    solves (m is then ignored).

    storage: 'full' keeps the (K·d, n) f64 basis on device (enables auto-
    reorth; one pass). 'twopass' never materializes the
    basis — the recurrence is rerun once after convergence to accumulate
    the solution (O(d·n·t) memory, no kmax ceiling, crash-resumable via
    state_cache; NO reorthogonalization — estimates only at large k).
    'segmented' stores per-segment
    blocks with boundary reorth (intermediate). 'df64' is the
    noise-recording expansion Lanczos for hardware without native f64:
    basis stored as f32 hi/lo pairs, the recurrence in f32-expansion
    arithmetic (its elementwise epsilon measured at runtime by
    eft_selfcheck), per-step
    full reorthogonalization with every sweep/projection coefficient and
    commit deviation RECORDED; the projected solve inverts the recorded
    perturbed per-factor operator, and the certificate is sup + measured
    boundary/dev/eta/r2 components with a full-Gram orthonormality bound
    at the deciding checkpoint (see _Df64State and DESIGN.md r4 addendum).
    'auto' → 'full'.

    mesh: a ('factor', 'mode') jax.sharding.Mesh (parallel.make_mesh) to
    shard the solve: every n-sized array — b⊥, the deflation basis U, the
    recurrence vectors, the stored/replayed Krylov columns, the solution
    accumulator — shards its mode axis; the SpMV halo exchanges and every
    U-projection/dot reduction become XLA collectives over 'mode' (psum /
    collective-permute). The k-sized checkpoint algebra stays
    replicated (or on host, eigh_impl='host'), exactly like solve_sharded.
    comm: 'gspmd' (XLA chooses collectives from the shardings) or 'ring'
    (every SpMV runs the explicit shard_map + ppermute halo path,
    parallel/halo.py). SURVEY.md §2.14.2; BASELINE.json config 5.

    state_cache (storage='twopass' or 'df64'): path to an .npz where the
    recurrence state is persisted after every completed checkpoint segment,
    and resumed from on the next call with matching shapes/strides. For
    twopass that is the tridiagonal + the two live vectors (~45 MB at
    flagship size); for df64 it is the FULL recording state including the
    active f32-pair basis prefix (~2·k·d·n·4 bytes — ~2.6 GB at the
    flagship deciding checkpoint; f32 transfers, no X64-split tax), so a
    resumed certified solve continues bit-exactly: a crashed or interrupted
    flagship solve restarts from its last
    checkpoint instead of step 0 (reference analogue: experiment
    persistence, /root/reference/experiments/experiment_common.jl:115-143).

    project_every (storage='twopass'): run the U-projection every p-th step
    only (see _advance_light — the projection GEMM dominates the flagship
    step; drift control does not need it every step). The measured
    pre-projection leak is returned as DeflatedResult.projection_leak.

    final ('auto'|'host'|'device', storage='df64' or 'full'): where the
    solution assembly (df64) and the certify cross-check run. 'host' pulls the
    full f32-pair basis to numpy (~4 GB at flagship size). 'device'
    assembles x = U·Yu + V·Yv in
    chunked pair-GEMMs on device and runs the basis-free CP cross-check
    there too (utils/cp.py:cp_residual_cross_check_device), pulling only
    the (d, 1+2t, 1+2t) small Gram (~2.6 MB); the result's x keeps its
    factors on device. 'auto' → 'host'.

    save_state: set False to use state_cache as resume-only (no writes).
    The df64 state save pulls the ~k·d·n·8-byte basis prefix.
    """
    config = config or SolverConfig()
    b = jnp.asarray(b)
    if b.ndim != 2 or b.shape[0] != op.d or b.shape[1] != op.n:
        raise ValueError(f"b must be (d, n) = ({op.d}, {op.n}), got {b.shape}")
    if not op.symmetric:
        raise ValueError("solve_deflated requires a symmetric operator")
    if config.orth == "arnoldi":
        raise ValueError("solve_deflated is a Lanczos-family solver")
    basis = basis or deflation_basis(op, m, dtype=config.basis_dtype)
    m = basis.m
    tables = tables or load_tables(dtype=config.proj_dtype)
    pdt = config.proj_dtype
    reorth = {
        "lanczos": "never",
        "lanczos_reorth": "always",
        "lanczos_reorth_auto": "auto",
    }[config.orth]
    eigh_impl = config.eigh_impl
    if eigh_impl == "auto":
        eigh_impl = "dense"

    lam_np = np.asarray(basis.lam, np.float64)
    lam_min = float(lam_np[:, 0].sum())
    lam_gersh_f = _gershgorin_per_factor(op)
    lam_max = float(lam_gersh_f.sum())

    # the spectral interval is FIXED for the whole solve (exact λ_min from
    # the deflated pairs, Gershgorin λ_max) → select the exp-sum
    # coefficients once, and price the analytic sup bound once (f128 host).
    # Selection targets tol/2 so the sup component leaves room for the
    # measured boundary part in the certificate tol = sup + boundary.
    kappa = lam_max / lam_min
    half_tol = 0.5 * config.tol
    coeff_tol = half_tol / kappa if config.coeff_tol_scale == "kappa" else half_tol
    coeffs = jax.jit(
        select_bh, static_argnames=("tmax", "row_select")
    )(jnp.asarray(kappa, pdt), coeff_tol, tables, tmax=config.tmax,
      row_select=config.bh_row_select)
    sup_err = expsum_sup_error(coeffs.omega, coeffs.alpha, kappa)

    # the deflated Krylov space lives in the U-complement: dimension ≤ n − m
    kmax = min(config.kmax, op.n - m)
    if checkpoints is None:
        checkpoints, ck = [], 32
        while ck < kmax:
            checkpoints.append(ck)
            ck *= 2
        checkpoints.append(kmax)
    checkpoints = sorted({min(int(c_), kmax) for c_ in checkpoints})

    # the deflated driver runs fully in the projected dtype (f64): the
    # certificate's orthonormality slack is eps(basis); narrower storage
    # cannot certify 1e-8-class targets (docs/northstar.md §4).
    # Split b on HOST (numpy — avoids device temporaries before the big
    # state allocation) and allocate the (d, K, n) basis BEFORE anything
    # else device-side, while the allocator's arena is still unfragmented.
    bands_host = np.asarray(op.bands, np.float64)   # for host certify
    U_np = np.asarray(basis.U, np.float64)
    b_np = np.asarray(b, np.float64)
    b_host = b_np.copy()
    if U_np.shape[0] == 1:
        c_np = np.einsum("nm,dn->dm", U_np[0], b_np)
        b_perp_np = b_np - np.einsum("nm,dm->dn", U_np[0], c_np)
    else:
        c_np = np.einsum("dnm,dn->dm", U_np, b_np)
        b_perp_np = b_np - np.einsum("dnm,dm->dn", U_np, c_np)
    b_norm = float(np.prod(np.linalg.norm(b_np, axis=1)))

    if storage == "auto":
        storage = "full"
    if storage not in ("full", "twopass", "segmented", "df64"):
        raise ValueError(
            "storage must be 'auto'|'full'|'twopass'|'segmented'|'df64', "
            f"got {storage!r}"
        )
    if storage == "df64":
        # per-step FULL reorthogonalization against the df64-pair basis
        # happens inside the advance kernel
        reorth = "never"
        if mesh is not None and comm == "ring":
            # the expansion-arithmetic SpMV (triple_spmv_pairs) shifts via
            # jnp.roll — GSPMD lowers that to collective-permutes over
            # 'mode'; the explicit shard_map ring has no pair variant
            raise ValueError("storage='df64' with mesh supports comm='gspmd' "
                             "only (the pair SpMV shards via GSPMD)")
    if storage == "twopass":
        # no basis to sweep against; drift is measured (btil probe) instead
        reorth = "never"
    if storage == "segmented":
        # in-segment steps are sweep-free; FULL reorthogonalization happens
        # at every segment boundary against the stored segment list
        reorth = "never"
        if mesh is not None:
            raise ValueError("storage='segmented' does not support mesh yet")
        segment = int(segment)
        if segment < 1:
            raise ValueError(f"segment must be >= 1, got {segment}")
        # never RAISE kmax above config.kmax / the Krylov-space dimension
        # (ADVICE r3: kmax < segment used to round UP into exhausted steps)
        segment = min(segment, kmax)
        kmax = (kmax // segment) * segment
        checkpoints = sorted({
            min(max(segment, (ck // segment) * segment), kmax)
            for ck in checkpoints
        })

    if project_every > 1 or sweep_every > 1:
        # the stride escapes are measured-UNSOUND at production spectra
        # (U-leak and Gram overlap grow exponentially outside the deflation
        # window).
        # The certificate stays honest either way (leak/overlap telemetry
        # is measured and folded), but convergence can stall; make the
        # regime boundary LOUD instead of a documented footgun.
        import warnings

        warnings.warn(
            f"project_every={project_every}/sweep_every={sweep_every} > 1: "
            "measured-unsound at production spectra (U-leak/Gram grow "
            "exponentially outside the deflation window); "
            "validated only on small-kappa oracles. The certificate folds "
            "the measured leak/overlap, but expect stalls at scale.",
            RuntimeWarning, stacklevel=2)
    if final == "auto":
        final = "host"
    if final not in ("host", "device"):
        raise ValueError(f"final must be 'auto'|'host'|'device', got {final!r}")
    if final == "device" and storage not in ("df64", "full"):
        raise ValueError("final='device' is implemented for storage='df64' "
                         "and 'full'")
    if comm not in ("gspmd", "ring"):
        raise ValueError(f"comm must be 'gspmd' or 'ring', got {comm!r}")
    if pass2_impl == "auto":
        pass2_impl = (
            "host"
            if eigh_impl == "host" and storage == "twopass" and mesh is None
            else "device"
        )
    if pass2_impl not in ("host", "device"):
        raise ValueError(f"pass2_impl must be 'auto'|'host'|'device', got {pass2_impl!r}")
    if pass2_impl == "host" and (storage != "twopass" or mesh is not None):
        raise ValueError("pass2_impl='host' requires storage='twopass' and no mesh")

    # resume BEFORE any device work: a fully-resumed twopass solve with host
    # checkpoint algebra and host pass-2 never touches the device at all.
    if state_cache is not None and storage not in ("twopass", "df64"):
        raise ValueError("state_cache requires storage='twopass' or 'df64'")
    # problem fingerprint (ADVICE r4 medium): the shape/m/stride check alone
    # accepts a cache from a solve with different kappa/shift/seed/b — same
    # n, d, m, kmax — and silently resumes it into a wrong-but-'certified'
    # result. Saved caches carry this hash; loads reject a mismatch.
    # Legacy (r4) caches lack the field and load with a warning.
    import hashlib as _hashlib

    _fp_h = _hashlib.sha256()
    _fp_h.update(bands_host.tobytes())
    _fp_h.update(np.asarray(op.offsets, np.int64).tobytes())
    _fp_h.update(b_perp_np.tobytes())
    _fp_h.update(lam_np.tobytes())
    problem_fp = _fp_h.hexdigest()
    del _fp_h
    resume_np = None
    resume_df64_np = None
    resumed_k_prev = 1
    if state_cache is not None and storage == "df64" and os.path.exists(state_cache):
        # df64 crash-resume: the full recording state (incl. the f32-pair
        # basis prefix) persisted at checkpoint boundaries, so an
        # interrupted attempt only loses its last checkpoint segment.
        z = np.load(state_cache)
        ok = (
            z.get("storage", None) is not None
            and str(z["storage"]) == "df64"
            and z["od"].shape == (op.d, kmax + 1)
            and int(z["n"]) == op.n
            and int(z["m"]) == basis.m
            and int(z["project_every"]) == project_every
            and int(z["sweep_every"]) == sweep_every
        )
        if not ok:
            raise ValueError(
                f"state_cache {state_cache} does not match this df64 solve "
                "(storage/shape/m/stride mismatch — stale cache?)"
            )
        if "fingerprint" in z.files:
            if str(z["fingerprint"]) != problem_fp:
                raise ValueError(
                    f"state_cache {state_cache} was recorded for a DIFFERENT "
                    "problem (operator/RHS/deflation fingerprint mismatch) — "
                    "same shapes, different kappa/shift/seed/b. Refusing to "
                    "resume it into a wrong-but-certified result."
                )
        else:
            print(f"[solve_deflated] WARNING: legacy state_cache "
                  f"{state_cache} has no problem fingerprint; shape checks "
                  "passed but operator/RHS identity is unverified", flush=True)
        resume_df64_np = {f: np.asarray(z[f]) for f in (
            "dg", "od", "btil", "vp_h", "vp_l", "vq_h", "vq_l", "beta",
            "leak", "sweep_overlap", "Vh_act", "Vl_act", "W", "C", "dev",
        )}
        resumed_k_prev = int(z["k_prev"])
    elif state_cache is not None and os.path.exists(state_cache):
        z = np.load(state_cache)
        # ADVICE r4: a twopass solve pointed at a df64-written cache must
        # fall through to the clean stale-cache error, not KeyError on 'vp'
        if ("vp" in z.files and "fingerprint" in z.files
                and str(z["fingerprint"]) != problem_fp):
            raise ValueError(
                f"state_cache {state_cache} was recorded for a different "
                "problem (fingerprint mismatch) — refusing to resume"
            )
        if ("vp" in z.files and z["od"].shape == (op.d, kmax + 1)
                and z["vp"].shape == (op.d, op.n)):
            resume_np = {f: np.asarray(z[f]) for f in
                         ("dg", "od", "btil", "vp", "vpp", "beta")}
            resume_np["leak"] = (
                np.asarray(float(z["leak"])) if "leak" in z else np.asarray(0.0)
            )
            resumed_k_prev = int(z["k_prev"])
            cached_pe = int(z["project_every"]) if "project_every" in z else 1
            if cached_pe != project_every:
                raise ValueError(
                    f"state_cache was recorded with project_every={cached_pe} "
                    f"but this call uses {project_every}: pass-2 must replay "
                    "the exact pass-1 projection schedule"
                )
        else:
            raise ValueError(
                f"state_cache {state_cache} shape mismatch: "
                f"{z['od'].shape} vs {(op.d, kmax + 1)} — stale cache?"
            )
    needs_advance = (max(checkpoints) + 1) > resumed_k_prev
    needs_device = (
        storage in ("full", "segmented", "df64") or mesh is not None
        or needs_advance or pass2_impl == "device"
    )

    mode_sh = basis_sh = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .parallel.sharding import _factor_spec

        if "mode" not in mesh.shape:
            raise ValueError("solve_deflated mesh needs a 'mode' axis")
        fs = _factor_spec(mesh, op.d) if "factor" in mesh.shape else None
        mode_sh = NamedSharding(mesh, P(fs, "mode"))           # (d, n)
        basis_sh = NamedSharding(mesh, P(None, "mode"))        # (K*d, n)
        u_sh = NamedSharding(
            mesh, P(None if basis.U.shape[0] == 1 else fs, "mode", None)
        )
        band_sh = NamedSharding(mesh, P(fs, None, "mode"))

    def _put(x, sh):
        return x if sh is None else jax.device_put(x, sh)

    b_perp = U = op_c = state = None
    if needs_device:
        b_perp = _put(jnp.asarray(b_perp_np, pdt), mode_sh)  # shared with init
        if storage == "full":
            state, _ = _init_defl_state(b_perp, kmax + 1, pdt)
            if basis_sh is not None:
                state = state._replace(V=_put(state.V, basis_sh))
        op_c = op.astype(pdt)
        if mesh is not None:
            op_c = dataclasses.replace(
                op_c,
                bands=_put(op_c.bands, band_sh),
                halo=(mesh, "mode", fs) if comm == "ring" else op_c.halo,
            )
        # one explicit transfer (jitted calls re-upload a numpy U per call);
        # the df64 path only touches the f32 pair — skip the f64 copy
        U = None
        if storage != "df64":
            U = _put(jnp.asarray(np.asarray(basis.U), pdt),
                     None if mesh is None else u_sh)
        Uh = Ul = bands_h = bands_l = None
        b0_norms_np = dev0_np = None
        df64_pair_sh = df64_basis_sh = df64_rep_sh = None
        if storage == "df64" and mesh is not None:
            # GSPMD mode sharding of the pair recurrence: every n-sized pair
            # buffer shards its mode axis; the sweep / projection einsums
            # contract over n and become psums over 'mode';
            # the pair SpMV's rolls lower to collective-permutes. The
            # k-sized recorded algebra (W, C, dg, od, btil, dev) stays
            # replicated — same layout story as solve_sharded.
            from jax.sharding import NamedSharding as _NS, PartitionSpec as _P

            df64_u_sh = _NS(mesh, _P("mode", None))          # (n, m)
            df64_pair_sh = mode_sh                            # (d, n)
            df64_basis_sh = _NS(mesh, _P(None, "mode"))      # (Kp·d, n)
            df64_band_sh = _NS(mesh, _P(fs, None, "mode"))   # (d, nb, n)
            df64_rep_sh = _NS(mesh, _P())                    # small arrays
        if storage == "df64":
            # everything big enters jit as f32 (pairs): no X64-split tax.
            # Shared basis → (n, m) pair; distinct factors (r5, VERDICT r4
            # #6) → (d, n, m) pair, same recording contract per factor.
            U_pair_np = np.asarray(basis.U, np.float64)
            U_pair_np = U_pair_np[0] if U_pair_np.shape[0] == 1 else U_pair_np
            Uh_np = U_pair_np.astype(np.float32)
            Ul_np = (U_pair_np - Uh_np.astype(np.float64)).astype(np.float32)
            if mesh is not None and Uh_np.ndim == 3:
                from jax.sharding import NamedSharding as _NS2, \
                    PartitionSpec as _P2

                df64_u_sh = _NS2(mesh, _P2(fs, "mode", None))
            Uh = _put(jnp.asarray(Uh_np),
                      None if mesh is None else df64_u_sh)
            Ul = _put(jnp.asarray(Ul_np),
                      None if mesh is None else df64_u_sh)
            del U_pair_np, Uh_np, Ul_np
            bnp = np.asarray(op.bands, np.float64)
            bh_np = bnp.astype(np.float32)
            bands_h = _put(jnp.asarray(bh_np),
                           None if mesh is None else df64_band_sh)
            bands_l = _put(
                jnp.asarray((bnp - bh_np.astype(np.float64)).astype(np.float32)),
                None if mesh is None else df64_band_sh)
            del bnp, bh_np
            # host-exact init: v0 pair + the exact representation deviation
            # dev0 = ||b_perp - beta0 * (vh0 + vl0)||  (charged to dev_term)
            b0_norms_np = np.linalg.norm(b_perp_np, axis=1)
            v0_np = b_perp_np / np.where(b0_norms_np > 0, b0_norms_np, 1.0)[:, None]
            vh0_np = v0_np.astype(np.float32)
            vl0_np = (v0_np - vh0_np.astype(np.float64)).astype(np.float32)
            pair0 = vh0_np.astype(np.longdouble) + vl0_np.astype(np.longdouble)
            dev0_np = np.asarray(np.linalg.norm(
                b_perp_np.astype(np.longdouble)
                - b0_norms_np[:, None] * pair0, axis=1), np.float64)
            d_, n_ = b_perp_np.shape
            K_pad = -(-(kmax + 1) // _DF64_SWEEP_COLS) * _DF64_SWEEP_COLS
            _bsh = None if mesh is None else df64_basis_sh
            _psh = None if mesh is None else df64_pair_sh
            _rsh = None if mesh is None else df64_rep_sh
            Vh0 = _put(jnp.zeros((K_pad * d_, n_), jnp.float32), _bsh)
            Vl0 = _put(jnp.zeros((K_pad * d_, n_), jnp.float32), _bsh)
            Vh0 = lax.dynamic_update_slice(
                Vh0, _put(jnp.asarray(vh0_np), _psh), (0, 0))
            Vl0 = lax.dynamic_update_slice(
                Vl0, _put(jnp.asarray(vl0_np), _psh), (0, 0))
            state = _Df64State(
                _put(jnp.zeros((d_, kmax + 1), pdt), _rsh),
                _put(jnp.zeros((d_, kmax + 1), pdt), _rsh),
                _put(jnp.zeros((d_, kmax + 1), pdt).at[:, 0].set(
                    jnp.asarray(b0_norms_np, pdt)), _rsh),
                _put(jnp.asarray(vh0_np), _psh),
                _put(jnp.asarray(vl0_np), _psh),
                _put(jnp.zeros((d_, n_), jnp.float32), _psh),
                _put(jnp.zeros((d_, n_), jnp.float32), _psh),
                _put(jnp.zeros((d_,), pdt), _rsh),
                _put(jnp.zeros((), pdt), _rsh),
                _put(jnp.zeros((), pdt), _rsh),
                Vh0, Vl0,
                _put(jnp.zeros((d_, K_pad, K_pad), jnp.float32), _rsh),
                _put(jnp.zeros((d_, basis.m, K_pad), jnp.float32), _rsh),
                _put(jnp.zeros((d_, kmax + 1), pdt), _rsh),
            )
            if resume_df64_np is not None:
                r_ = resume_df64_np
                rows_act = r_["Vh_act"].shape[0]
                if rows_act != resumed_k_prev * op.d:
                    raise ValueError(
                        f"state_cache basis prefix has {rows_act} rows but "
                        f"k_prev={resumed_k_prev} implies "
                        f"{resumed_k_prev * op.d} — corrupt cache?"
                    )
                Vh0 = lax.dynamic_update_slice(
                    state.Vh, _put(jnp.asarray(r_["Vh_act"]), _bsh), (0, 0))
                Vl0 = lax.dynamic_update_slice(
                    state.Vl, _put(jnp.asarray(r_["Vl_act"]), _bsh), (0, 0))
                state = _Df64State(
                    _put(jnp.asarray(r_["dg"], pdt), _rsh),
                    _put(jnp.asarray(r_["od"], pdt), _rsh),
                    _put(jnp.asarray(r_["btil"], pdt), _rsh),
                    _put(jnp.asarray(r_["vp_h"]), _psh),
                    _put(jnp.asarray(r_["vp_l"]), _psh),
                    _put(jnp.asarray(r_["vq_h"]), _psh),
                    _put(jnp.asarray(r_["vq_l"]), _psh),
                    _put(jnp.asarray(r_["beta"], pdt), _rsh),
                    _put(jnp.asarray(r_["leak"], pdt), _rsh),
                    _put(jnp.asarray(r_["sweep_overlap"], pdt), _rsh),
                    Vh0, Vl0,
                    _put(jnp.asarray(r_["W"]), _rsh),
                    _put(jnp.asarray(r_["C"]), _rsh),
                    _put(jnp.asarray(r_["dev"], pdt), _rsh),
                )
                del resume_df64_np, r_
        if storage in ("twopass", "segmented"):
            b_norms_d = jnp.linalg.norm(b_perp, axis=1)
            v0 = b_perp / jnp.where(b_norms_d > 0, b_norms_d, 1.0)[:, None]
            # independent buffer: the state (which aliases v0) is DONATED
            # into the advance jit; v0 itself must outlive it for the
            # boundary sweeps and the segmented assembly
            v0_dev = jnp.array(v0, copy=True)
            d_ = op.d
            state = _LightState(
                jnp.zeros((d_, kmax + 1), pdt),
                jnp.zeros((d_, kmax + 1), pdt),
                jnp.zeros((d_, kmax + 1), pdt).at[:, 0].set(b_norms_d),
                v0,
                jnp.zeros_like(v0),
                jnp.zeros((d_,), pdt),
                jnp.zeros((), pdt),
            )
    c = jnp.asarray(c_np, pdt)
    del c_np, b_np

    rel_hist: List[float] = []
    bound_hist: List[float] = []
    status = int(Status.MAXITER)
    k_prev, k_done = 1, 0
    Yu = Yv = weights = None
    if resume_np is not None:
        if needs_device:
            state = _LightState(
                *(jnp.asarray(resume_np[f], pdt)
                  for f in ("dg", "od", "btil", "vp", "vpp", "beta")),
                jnp.asarray(resume_np["leak"], pdt),
            )
        else:
            # host-only recovery path: the state never leaves numpy
            state = _LightState(
                resume_np["dg"], resume_np["od"], resume_np["btil"],
                resume_np["vp"], resume_np["vpp"], resume_np["beta"],
                resume_np["leak"],
            )
        k_prev = resumed_k_prev
    elif resumed_k_prev > 1 and storage == "df64":
        k_prev = resumed_k_prev  # state fields already restored above

    def _save_state(st: _LightState, k_prev: int):
        if state_cache is None or not save_state:
            return
        tmp = state_cache + ".tmp.npz"
        np.savez(
            tmp,
            dg=np.asarray(st.dg), od=np.asarray(st.od),
            btil=np.asarray(st.btil), vp=np.asarray(st.vp),
            vpp=np.asarray(st.vpp), beta=np.asarray(st.beta),
            k_prev=np.asarray(k_prev), leak=np.asarray(st.leak),
            project_every=np.asarray(project_every),
            fingerprint=np.asarray(problem_fp),
        )
        os.replace(tmp, state_cache)

    def _pull_rows_chunked(arr, r0: int, r1: int, max_bytes: int = 1 << 24):
        """Device→host pull of rows [r0, r1) in bounded slices (at most
        max_bytes per transfer), which also bounds what an interruption
        can lose mid-save."""
        import time as _time

        n_cols = arr.shape[1]
        step = max(1, max_bytes // (n_cols * arr.dtype.itemsize))
        parts = []
        r = r0
        rates = []
        while r < r1:
            r2 = min(r + step, r1)
            t0_ = _time.perf_counter()
            parts.append(np.asarray(arr[r:r2]))
            dt_ = _time.perf_counter() - t0_
            rates.append(parts[-1].nbytes / 1e6 / max(dt_, 1e-9))
            r = r2
        if verbose and rates:
            print(f"  [pull] {len(rates)} chunks, MB/s: "
                  + " ".join(f"{x:.1f}" for x in rates[:8]), flush=True)
        return (np.concatenate(parts, axis=0) if parts
                else np.zeros((0, n_cols), arr.dtype))

    def _save_state_df64(st: _Df64State, k_prev: int):
        """Persist the full df64 recording state at a checkpoint boundary.
        Only the ACTIVE basis-prefix rows (< k_prev·d, k-major) are written
        — f32 transfers, no X64-split tax; the small f64 arrays are exact.
        INCREMENTAL (r5): stored basis rows are immutable once written, so
        rows already in the existing cache file are reused from disk and
        only rows [cached_k·d, k_prev·d) are pulled — a flagship save
        fetches ~10 MB/step instead of the whole prefix. Atomic replace."""
        if state_cache is None or not save_state:
            return
        import time as _time

        t0 = _time.perf_counter()
        rows_act = k_prev * op.d
        prev_rows = 0
        prev_k = 0
        if os.path.exists(state_cache):
            try:
                if int(np.load(state_cache)["k_prev"]) == k_prev:
                    return      # nothing new since the last save
            except Exception:
                pass
        prev_Vh = prev_Vl = prev_W = prev_C = None
        if os.path.exists(state_cache):
            try:
                z = np.load(state_cache)
                if (str(z.get("storage", "")) == "df64"
                        and "fingerprint" in z.files
                        and str(z["fingerprint"]) == problem_fp
                        and int(z["k_prev"]) <= k_prev):
                    prev_Vh = np.asarray(z["Vh_act"])
                    prev_Vl = np.asarray(z["Vl_act"])
                    prev_rows = min(prev_Vh.shape[0], rows_act)
                    prev_k = int(z["k_prev"])
                    if (z["W"].shape == tuple(st.W.shape)
                            and z["C"].shape == tuple(st.C.shape)):
                        prev_W = np.asarray(z["W"])
                        prev_C = np.asarray(z["C"])
            except Exception:   # unreadable/corrupt cache → full save
                prev_rows = 0
                prev_W = prev_C = None
        new_h = _pull_rows_chunked(st.Vh, prev_rows, rows_act)
        new_l = _pull_rows_chunked(st.Vl, prev_rows, rows_act)
        Vh_act = (np.concatenate([prev_Vh[:prev_rows], new_h])
                  if prev_rows else new_h)
        Vl_act = (np.concatenate([prev_Vl[:prev_rows], new_l])
                  if prev_rows else new_l)
        del prev_Vh, prev_Vl
        # W/C columns are write-once too (column c recorded at step c+1):
        # re-pull only [prev_k-2, k_prev) with the disk copy as the prefix
        if prev_W is not None:
            c0 = max(prev_k - 2, 0)
            prev_W[:, :, c0:k_prev] = np.asarray(st.W[:, :, c0:k_prev])
            prev_C[:, :, c0:k_prev] = np.asarray(st.C[:, :, c0:k_prev])
            W_np, C_np = prev_W, prev_C
        else:
            W_np, C_np = np.asarray(st.W), np.asarray(st.C)
        tmp = state_cache + ".tmp.npz"
        np.savez(
            tmp,
            storage=np.asarray("df64"),
            n=np.asarray(op.n), m=np.asarray(basis.m),
            k_prev=np.asarray(k_prev),
            project_every=np.asarray(project_every),
            sweep_every=np.asarray(sweep_every),
            dg=np.asarray(st.dg), od=np.asarray(st.od),
            btil=np.asarray(st.btil), beta=np.asarray(st.beta),
            vp_h=np.asarray(st.vp_h), vp_l=np.asarray(st.vp_l),
            vq_h=np.asarray(st.vq_h), vq_l=np.asarray(st.vq_l),
            leak=np.asarray(st.leak),
            sweep_overlap=np.asarray(st.sweep_overlap),
            Vh_act=Vh_act, Vl_act=Vl_act,
            W=W_np, C=C_np, dev=np.asarray(st.dev),
            fingerprint=np.asarray(problem_fp),
        )
        os.replace(tmp, state_cache)
        if verbose:
            print(f"  [solve_deflated] df64 state saved (k={k_prev - 1}, "
                  f"incremental rows {rows_act - prev_rows}, "
                  f"{_time.perf_counter() - t0:.1f}s)", flush=True)

    segs: List[jax.Array] = []
    boundary_drift = None
    cert = None
    budget_exhausted = False
    for ck in checkpoints:
        if budget_exhausted:
            break
        if ck + 1 > k_prev:
            if storage == "full":
                state = _advance(
                    op_c, state, b_perp, U, jnp.asarray(k_prev, jnp.int32),
                    jnp.asarray(ck + 1, jnp.int32), reorth=reorth,
                    reorth_tol=config.reorth_tol, project_every=project_every,
                )
                k_prev = ck + 1
            elif storage == "df64":
                # noise-recording segments: S steps per device call
                S_SEG = 32
                while k_prev <= ck:
                    if (advance_budget is not None
                            and k_prev - resumed_k_prev >= advance_budget):
                        # budgeted runs advance a bounded leg, save, and
                        # exit cleanly; the next call resumes from the cache
                        budget_exhausted = True
                        break
                    S_eff = min(S_SEG, ck + 1 - k_prev)
                    if advance_budget is not None:
                        S_eff = min(
                            S_eff,
                            advance_budget - (k_prev - resumed_k_prev))
                    state = _df64_advance(
                        bands_h, bands_l, op.offsets, state, b_perp,
                        Uh, Ul, jnp.asarray(k_prev, jnp.int32),
                        S=S_eff, project_every=project_every,
                        sweep_every=sweep_every,
                    )
                    k_prev += S_eff
                    if (save_every and state_cache is not None and save_state
                            and (k_prev - 1) % save_every == 0
                            and k_prev <= ck):
                        # intra-checkpoint incremental save: bounds what an
                        # interruption can cost to one save_every leg
                        _save_state_df64(state, k_prev)
                _save_state_df64(state, k_prev)
                if budget_exhausted:
                    break
            elif storage == "segmented":
                while k_prev <= ck:
                    state, Vseg = _advance_light_store(
                        op_c, state, b_perp, U,
                        jnp.asarray(k_prev, jnp.int32),
                        project_every=project_every, S=segment,
                    )
                    segs.append(Vseg)
                    k_prev += segment
                    state, bd = _boundary_reorth([v0_dev] + segs, state, U)
                    boundary_drift = max(boundary_drift or 0.0, bd)
            else:
                state = _advance_light(
                    op_c, state, b_perp, U, jnp.asarray(k_prev, jnp.int32),
                    jnp.asarray(ck + 1, jnp.int32),
                    project_every=project_every,
                )
                k_prev = ck + 1
            _save_state(state, k_prev) if storage == "twopass" else None
        if storage == "df64":
            # pull only the ACTIVE W/C columns (recorded at steps <= ck) and
            # zero-pad on host instead of pulling the full (d, m, Kp) buffer
            Kp_ = state.W.shape[1]
            W_np = np.zeros(state.W.shape, np.float32)
            W_np[:, :, : ck + 1] = np.asarray(state.W[:, :, : ck + 1])
            C_np2 = np.zeros(state.C.shape, np.float32)
            C_np2[:, :, : ck + 1] = np.asarray(state.C[:, :, : ck + 1])

            def _eval_df64(gram_dev, frechet):
                out = _evaluate_host_recorded(
                    np.asarray(state.dg), np.asarray(state.od),
                    np.asarray(state.btil), np.asarray(state.beta), ck,
                    np.asarray(basis.lam), np.asarray(c), b_norm, lam_min,
                    np.asarray(coeffs.omega), np.asarray(coeffs.alpha),
                    np.asarray(coeffs.t_mask),
                    W_np, C_np2,
                    np.asarray(state.dev), b0_norms_np, dev0_np,
                    _eft_eps(), lam_gersh_f, gram_dev, frechet=frechet,
                )
                cert = out[-1]
                cert["sup"] = sup_err
                if frechet:
                    bound = (sup_err + cert["boundary"] + cert["dev_term"]
                             + cert["eta_term"] + cert["r2_term"])
                else:
                    # uncorrected y: the measured longdouble estimate (which
                    # contains the W/C defect) replaces sup + boundary
                    bound = (out[0] + cert["dev_term"] + cert["eta_term"]
                             + cert["r2_term"])
                return out, bound

            # interim checkpoints run the CHEAP evaluation (no Frechet
            # correction — host time saved per checkpoint — and proxy
            # slack from the
            # measured sweep-overlap/leak); the full treatment (corrected
            # solve + chunked full Gram) runs at the deciding checkpoint
            proxy = max(float(state.sweep_overlap), float(state.leak))
            out, bound = _eval_df64(proxy, frechet=False)
            if bound < 100.0 * config.tol or ck == checkpoints[-1]:
                gram_dev = _df64_gram_deviation_host(
                    state.Vh, state.Vl, ck + 1, op.d)
                out, bound = _eval_df64(gram_dev, frechet=True)
                out[-1]["gram_source"] = "measured full Gram"
            else:
                out[-1]["gram_source"] = "proxy max(sweep_overlap, leak)"
            rel, brs, Yu, Yv, weights, cert = out
        elif eigh_impl == "host":
            rel, brs, Yu, Yv, weights = _evaluate_host(
                np.asarray(state.dg), np.asarray(state.od),
                np.asarray(state.btil), np.asarray(state.beta), ck,
                np.asarray(basis.lam), np.asarray(c), b_norm, lam_min,
                np.asarray(coeffs.omega), np.asarray(coeffs.alpha),
                np.asarray(coeffs.t_mask),
            )
            bound = sup_err + float(np.sqrt(max(float(brs), 0.0)))
        else:
            rel, brs, Yu, Yv, weights = _evaluate(
                state.dg, state.od, state.btil, state.beta,
                jnp.asarray(ck, jnp.int32), basis.lam, c,
                jnp.asarray(b_norm, pdt), jnp.asarray(lam_min, pdt),
                coeffs.omega, coeffs.alpha, coeffs.t_mask,
                eigh_impl=eigh_impl,
            )
            bound = sup_err + float(np.sqrt(max(float(brs), 0.0)))
        rel_hist.append(float(rel))
        bound_hist.append(bound)
        k_done = ck
        if verbose:
            import time as _time

            extra = ""
            if cert is not None:
                extra = (f" [sup {sup_err:.1e} bnd {cert['boundary']:.1e} "
                         f"dev {cert['dev_term']:.1e} eta {cert['eta_term']:.1e} "
                         f"rho {cert['rho']:.1e} gram {cert['gram_dev']:.1e}]")
            print(f"  [solve_deflated {_time.strftime('%H:%M:%S')}] k={ck}: "
                  f"estimate {rel_hist[-1]:.3e}, "
                  f"certified bound {bound_hist[-1]:.3e}{extra}", flush=True)
        if bound_hist[-1] < config.tol:
            status = int(Status.CONVERGED)
            break

    if budget_exhausted:
        # budgeted march: state persisted at k_prev-1; no evaluation, no
        # assembly — the caller's campaign loop resumes the next leg
        return DeflatedResult(
            x=None, status=int(Status.RUNNING), niterations=k_prev - 1,
            m=m, relative_residual=[], certified_bound=[], checkpoints=[],
            measured_cp_residual=None, expsum_sup=sup_err,
            expsum_rank=int(coeffs.rank), lambda_min=lam_min,
            lambda_max=lam_max, orthogonality_drift=0.0,
            cp_residual_floor=None,
        )

    # compress to the ACTIVE exp-sum columns before assembly: the padded
    # (tmax,) buffers carry ~3× dead columns (t_mask zeros) that would
    # otherwise triple the pass-2 accumulator and the certificate's Gram.
    # All small state is materialized to HOST first, so a device fault in
    # pass-2 can no longer lose the recorded solve.
    act = np.flatnonzero(np.asarray(coeffs.t_mask) > 0)
    Yu_np = np.asarray(Yu)[:, :, act]
    Yv_np = np.asarray(Yv)[:, :, act]
    weights = np.asarray(weights)[act]
    od_np = np.asarray(state.od)
    btil_np = np.asarray(state.btil)
    leak_val = float(state.leak) if hasattr(state, "leak") else None
    n_probes = min(16, max(k_done - 1, 1))
    audit = None
    device_check = None
    if storage == "full":
        xf = _assemble(U, state.V, jnp.asarray(Yu_np), jnp.asarray(Yv_np),
                       jnp.asarray(k_done, jnp.int32))
        if certify and final == "device":
            # basis-free cross-check on device: only the small Gram is pulled
            from .utils.cp import cp_residual_cross_check_device

            state = None      # release the basis before the Gram's temps
            check = cp_residual_cross_check_device(
                op, np.asarray(weights, np.float64), xf,
                _put(jnp.asarray(b_host, jnp.float64), mode_sh))
            device_check = (check.value / b_norm, check.floor / b_norm)
    elif storage == "df64" and final == "device":
        # device assembly + device cross-check: instead of pulling the basis
        # (~4 GB at flagship size), x = U·Yu + V·Yv is accumulated on device
        # in bounded pair-GEMM chunks, the basis-free CP residual Gram runs
        # on device (cp_residual_cross_check_device), and only the
        # (d, 1+2t, 1+2t) small Gram (~2.6 MB) is pulled to the host.
        K_ = od_np.shape[1]
        d_, n_ = b_perp_np.shape
        mask = (np.arange(K_)[None, :, None] < k_done)
        Yv_m = Yv_np * mask
        boundary_drift = float(state.sweep_overlap)
        t_act = Yv_m.shape[2]
        Kp_rows = state.Vh.shape[0] // d_
        ROWS = _DF64_SWEEP_COLS
        nch_a = min(-(-k_done // ROWS), Kp_rows // ROWS)
        Yv_pad = np.zeros((d_, nch_a * ROWS, Yv_m.shape[2]), np.float64)
        Yv_pad[:, : min(K_, nch_a * ROWS), :] = Yv_m[:, : nch_a * ROWS, :]
        Yvh_np = Yv_pad.astype(np.float32)
        Yvl_np = (Yv_pad - Yvh_np.astype(np.float64)).astype(np.float32)
        acc_sh = None
        if mesh is not None:
            from jax.sharding import NamedSharding as _NS, PartitionSpec as _P

            acc_sh = _NS(mesh, _P(fs, "mode", None))
        Yuh_np = Yu_np.astype(np.float32)
        Yul_np = (Yu_np - Yuh_np.astype(np.float64)).astype(np.float32)
        CM_U = min(256, m)
        # chunk the assembly over exp-sum columns t: each chunk's f64
        # accumulator is bounded to 2^28 bytes (~8 columns at flagship
        # shape), which bounds the pair-GEMM temporaries.
        TC = max(1, (1 << 28) // max(d_ * n_ * 8, 1))
        acc_parts = []
        for tc0 in range(0, t_act, TC):
            tc1 = min(tc0 + TC, t_act)
            acc_t = _put(jnp.zeros((d_, n_, tc1 - tc0), jnp.float64), acc_sh)
            for ci in range(nch_a):
                k0_ = ci * ROWS
                acc_t = _df64_assemble_chunk(
                    acc_t, state.Vh, state.Vl,
                    jnp.asarray(k0_ * d_, jnp.int32),
                    jnp.asarray(Yvh_np[:, k0_:k0_ + ROWS, tc0:tc1]),
                    jnp.asarray(Yvl_np[:, k0_:k0_ + ROWS, tc0:tc1]),
                    rows=ROWS)
            c0_ = 0
            while c0_ < m:
                c1_ = min(c0_ + CM_U, m)
                Uhc_ = Uh[:, c0_:c1_] if Uh.ndim == 2 else Uh[:, :, c0_:c1_]
                Ulc_ = Ul[:, c0_:c1_] if Ul.ndim == 2 else Ul[:, :, c0_:c1_]
                acc_t = _df64_ulift_chunk(
                    acc_t, Uhc_, Ulc_,
                    jnp.asarray(Yuh_np[:, c0_:c1_, tc0:tc1]),
                    jnp.asarray(Yul_np[:, c0_:c1_, tc0:tc1]))
                c0_ = c1_
            acc_parts.append(acc_t)
        acc = (acc_parts[0] if len(acc_parts) == 1
               else jnp.concatenate(acc_parts, axis=2))
        del acc_parts
        state = None          # release the 2·Kp·d·n f32 basis before the
        Uh = Ul = None        # cross-check Gram materializes its temps
        xf = acc
        if certify:
            from .utils.cp import cp_residual_cross_check_device

            try:
                check = cp_residual_cross_check_device(
                    op, np.asarray(weights, np.float64), xf,
                    _put(jnp.asarray(b_host, jnp.float64), mode_sh))
                device_check = (check.value / b_norm, check.floor / b_norm)
            except jax.errors.JaxRuntimeError as e:
                print("[solve_deflated] device cross-check failed "
                      f"({type(e).__name__}) — certificate evidence kept, "
                      "measured_cp_residual=None", flush=True)
    elif storage == "df64":
        # host assembly from the f32 pair: pull the basis in bounded row
        # chunks (f32 transfers — no split tax), free nothing early (the
        # pair is one buffer) but do all math in numpy f64
        K_ = od_np.shape[1]
        d_, n_ = b_perp_np.shape
        mask = (np.arange(K_)[None, :, None] < k_done)
        Yv_m = Yv_np * mask
        xv = np.zeros((d_, n_, Yv_m.shape[2]))
        rows_per_chunk = max(d_, (1 << 25) // max(n_, 1) // d_ * d_)
        total_rows = (k_done) * d_   # columns 0..k_done-1 suffice (mask)
        r0 = 0
        while r0 < total_rows:
            r1 = min(r0 + rows_per_chunk, total_rows)
            Vc = (np.asarray(state.Vh[r0:r1], np.float64)
                  + np.asarray(state.Vl[r0:r1], np.float64))
            kk0, kk1 = r0 // d_, r1 // d_
            xv += np.einsum("kdn,dkt->dnt", Vc.reshape(kk1 - kk0, d_, n_),
                            Yv_m[:, kk0:kk1, :])
            r0 = r1
        U_host = np.asarray(basis.U, np.float64)
        if U_host.shape[0] == 1:
            xf = np.einsum("nm,dmt->dnt", U_host[0], Yu_np) + xv
        else:
            xf = np.einsum("dnm,dmt->dnt", U_host, Yu_np) + xv
        boundary_drift = float(state.sweep_overlap)
    elif storage == "segmented":
        # assembly fully ON HOST: at convergence the device holds every
        # segment (~8-11 GB at flagship size) and adding jit-call split
        # temps on top is exactly what OOMs; instead each segment is pulled
        # once, freed on device, and accumulated in numpy — memory falls
        # monotonically and a worker fault cannot lose the solve
        K_ = od_np.shape[1]
        mask = (np.arange(K_)[None, :, None] < k_done)
        Yv_m = Yv_np * mask
        d_, n_ = b_perp_np.shape
        bn_ = np.linalg.norm(b_perp_np, axis=1)
        v0_np = b_perp_np / np.where(bn_ > 0, bn_, 1.0)[:, None]
        xv = v0_np[:, :, None] * Yv_m[:, 0, :][:, None, :]
        for j in range(len(segs)):
            seg_np = np.asarray(segs[j], np.float64).reshape(segment, d_, n_)
            segs[j] = None                       # free the device block
            c0 = 1 + j * segment
            sl = Yv_m[:, c0:c0 + segment, :]
            xv += np.einsum("kdn,dkt->dnt", seg_np[:sl.shape[1]], sl)
        U_host = np.asarray(basis.U, np.float64)
        if U_host.shape[0] == 1:
            xf = np.einsum("nm,dmt->dnt", U_host[0], Yu_np) + xv
        else:
            xf = np.einsum("dnm,dmt->dnt", U_host, Yu_np) + xv
    else:
        K_ = od_np.shape[1]
        mask = (np.arange(K_)[None, :, None] < k_done)
        Yv_m = Yv_np * mask
        if pass2_impl == "device":
            try:
                X, audit = _pass2_accumulate(
                    op_c, b_perp, U, state.od, jnp.asarray(Yv_m),
                    jnp.asarray(k_done - 1, jnp.int32),
                    n_probes=n_probes, project_every=project_every,
                )
                xf = np.asarray(_u_lift(U, jnp.asarray(Yu_np)) + X)
                audit = Pass2Audit(float(audit.gram_max),
                                   float(audit.beta_rel_dev))
            except jax.errors.JaxRuntimeError as e:
                print("[solve_deflated] device pass-2 failed "
                      f"({type(e).__name__}); falling back to host replay",
                      flush=True)
                pass2_impl = "host"
        if pass2_impl == "host":
            X, audit = _pass2_host(
                np.asarray(op.bands, np.float64), op.offsets, b_perp_np,
                np.asarray(basis.U, np.float64), od_np, Yv_m, k_done - 1,
                project_every=project_every, n_probes=n_probes,
                verbose=verbose,
            )
            U_host = np.asarray(basis.U, np.float64)
            if U_host.shape[0] == 1:
                xf = np.einsum("nm,dmt->dnt", U_host[0], Yu_np) + X
            else:
                xf = np.einsum("dnm,dmt->dnt", U_host, Yu_np) + X
    x = CPTensor(weights, xf)
    kk = np.arange(btil_np.shape[1])
    live = (kk >= 1) & (kk <= k_done)
    drift = float(
        np.max(np.abs(btil_np[:, live]) / (btil_np[:, :1] + 1e-300))
    )
    del state  # release the (K, d, n) basis before the certificate's
    # rank-(1+d·t) CP residual materializes (flagship HBM headroom)
    measured = measured_floor = None
    if device_check is not None:
        measured, measured_floor = device_check
    elif certify and final != "device":
        # structured Gram evaluation, fully on host: O(d·n·t) memory, and
        # the only device interaction is pulling xf when it was assembled
        # on-device (host pass-2 produces numpy xf directly)
        from .utils.cp import cp_residual_cross_check_host

        check = cp_residual_cross_check_host(
            bands_host, op.offsets, np.asarray(weights, np.float64),
            np.asarray(xf, np.float64), b_host,
        )
        measured = check.value / b_norm
        measured_floor = check.floor / b_norm
    return DeflatedResult(
        x=x,
        status=status,
        niterations=k_done,
        m=m,
        relative_residual=rel_hist,
        certified_bound=bound_hist,
        checkpoints=list(checkpoints[: len(rel_hist)]),
        measured_cp_residual=measured,
        expsum_sup=sup_err,
        expsum_rank=int(coeffs.rank),
        lambda_min=lam_min,
        lambda_max=lam_max,
        orthogonality_drift=drift,
        cp_residual_floor=measured_floor,
        pass2_gram_max=None if audit is None else float(audit.gram_max),
        pass2_beta_rel_dev=None if audit is None else float(audit.beta_rel_dev),
        projection_leak=(
            float(leak_val) if leak_val is not None else None
        ),
        boundary_drift_max=boundary_drift,
        relation_dev_term=None if cert is None else cert["dev_term"],
        relation_eta_term=None if cert is None else cert["eta_term"],
        relation_r2_term=None if cert is None else cert["r2_term"],
        perturbation_rho=None if cert is None else cert["rho"],
        gram_deviation=None if cert is None else cert["gram_dev"],
        eft_eps_measured=None if cert is None else cert["eps_elem"],
    )
