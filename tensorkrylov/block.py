"""Block / global tensorized Krylov for rank-R tensor-product RHS.

Solves A x = b with b = Σ_{r=1..R} ⊗_s b_{s,r} in ONE shared Krylov
subspace per factor: K_k(A_s, [b_{s,1} … b_{s,R}]) — the block-Krylov
capability the reference lacks entirely (its `multiple_rhs`,
/root/reference/src/system.jl:13, is a list of separate experiment systems,
and `solve_multi_rhs` in solver.py runs R independent vmapped solves).
A shared subspace converges in at most as many block iterations as the worst
single RHS needs, while paying one batched recurrence.

Method (block generalization of Kressner–Tobler, SIAM 31(4) 2010):
  * per factor s, build an orthonormal basis of the block Krylov space with
    blocked SpMV + column-sequential CGS2 against the full prefix (block
    Arnoldi with full orthogonalization; for SPD factors this is block
    Lanczos with full reorthogonalization — H_s comes out numerically
    symmetric block-tridiagonal),
  * the projected system (Σ_s ⊕ H_s) y = Σ_r ⊗_s b̃_{s,r} is solved by the
    SAME exponential-sum machinery (`projected_step` in solver.py — single
    source of truth), which already accepts rank-R compressed RHS
    b̃ (d, K, R) and returns a rank-(t·R) CP solution,
  * the residual uses the block Lemma 3.4: A_s V_s = V_s H_s + Q_s B_s E_Rᵀ
    with an R×R boundary block B_s = H_s[kR:(k+1)R, (k-1)R:kR]
    (ops/gram.py:residual_norm_sq handles the block Gram BᵀB).

Deflation: if a new block column is (numerically) inside the current space,
the lucky-breakdown restart of ops/orth.py substitutes a fresh orthogonal
direction — the basis stays full-rank and b̃ records the true projections,
so the projected solve is unaffected (the extra direction simply enriches
the space).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from .coeffs.tables import BHTables, load_tables
from .ops.banded import spmv
from .ops.orth import (
    bdot,
    KrylovState,
    _acc_dtype,
    _project_coeffs,
    _replace_lucky,
    _subtract_span,
)
from .solver import _check_identical_factors, _resolve_config, projected_step
from .types import CPTensor, KroneckerSumOperator, SolveResult, SolverConfig, Status
from .ops.precision import einsum

__all__ = ["solve_block", "block_krylov_step", "init_block_state"]


def _orthonormalize_column(V, u, kc, b_block, proj_dtype):
    """CGS2 of u (d, n) against basis columns < kc; returns the coefficient
    column, the new unit vector (with lucky-breakdown replacement, in the
    compute dtype), the norm (0 on breakdown), and the new b̃ row
    ⟨q, b_r⟩ (d, R)."""
    acc = _acc_dtype(V.dtype, proj_dtype)
    u = u.astype(acc)
    w1 = _project_coeffs(V, u, kc, proj_dtype)
    u = _subtract_span(V, u, w1, kc)
    w2 = _project_coeffs(V, u, kc, proj_dtype)
    u = _subtract_span(V, u, w2, kc)
    h = w1 + w2  # (d, Kb)

    h_new = jnp.sqrt(bdot(u, u, acc).astype(proj_dtype))
    scale = jnp.sum(jnp.abs(h), axis=1) + jnp.asarray(1e-300, proj_dtype)
    lucky = h_new < 256.0 * jnp.finfo(acc).eps * scale
    h_new = jnp.where(lucky, 0.0, h_new)
    safe = jnp.where(h_new > 0, h_new, 1.0)
    q = u / safe.astype(acc)[:, None]
    q = _replace_lucky(V, q, lucky, kc, proj_dtype)
    bt_row = einsum(
        "dn,rdn->dr", q, b_block.astype(acc), preferred_element_type=acc
    ).astype(proj_dtype)
    return h, q, h_new, bt_row


def init_block_state(
    op: KroneckerSumOperator, B: jax.Array, kmax: int, R: int, proj_dtype,
    basis_dtype=None,
) -> Tuple[KrylovState, jax.Array]:
    """Orthonormalize the R starting vectors per factor into V[0:R] and
    compute b̃ rows; returns (state, b_norm of the full rank-R RHS).

    Block analogue of initialize_decomp!
    (/root/reference/src/decompositions.jl:112-118).
    """
    d, n = B.shape[1], B.shape[2]
    Kb = (kmax + 1) * R
    dtype = basis_dtype if basis_dtype is not None else op.dtype
    acc = _acc_dtype(dtype, proj_dtype)
    B = B.astype(acc)

    V = jnp.zeros((Kb, d, n), dtype)
    H = jnp.zeros((d, Kb, Kb), proj_dtype)
    btil = jnp.zeros((d, Kb, R), proj_dtype)

    for r in range(R):
        _, q, _, bt_row = _orthonormalize_column(V, B[r], r, B, proj_dtype)
        V = V.at[r].set(q.astype(dtype))
        btil = btil.at[:, r, :].set(bt_row)

    Gb = einsum("rdn,qdn->drq", B, B, preferred_element_type=acc).astype(proj_dtype)
    b_norm = jnp.sqrt(jnp.maximum(jnp.sum(jnp.prod(Gb, axis=0)), 0.0))
    beta = jnp.zeros((d,), proj_dtype)
    return KrylovState(V, H, btil, beta), b_norm


def block_krylov_step(
    op: KroneckerSumOperator,
    state: KrylovState,
    B: jax.Array,
    k,
    R: int,
    *,
    proj_dtype,
):
    """One block step: basis columns [kR, (k+1)R) from A × block k−1.

    One batched SpMV over the R block columns, then column-sequential CGS2
    against the full prefix (R is small and static — the loop unrolls)."""
    V, H, btil, _ = state
    kc = jnp.asarray(k, jnp.int32) * R  # first new column index
    acc = _acc_dtype(V.dtype, proj_dtype)

    W_prev = lax.dynamic_slice_in_dim(V, kc - R, R, axis=0)    # (R, d, n)
    U = spmv(op, jnp.swapaxes(W_prev, 0, 1).astype(acc))       # (d, R, n)

    zero = jnp.zeros((), jnp.int32)
    for r in range(R):
        hcol, q, h_new, bt_row = _orthonormalize_column(
            V, U[:, r, :], kc + r, B, proj_dtype
        )
        # H column (k-1)R + r: CGS coefficients + the norm at row kc + r
        col_vals = lax.dynamic_update_slice(hcol, h_new[:, None], (zero, kc + r))
        H = lax.dynamic_update_slice(H, col_vals[:, :, None], (zero, zero, kc - R + r))
        V = lax.dynamic_update_slice_in_dim(V, q.astype(V.dtype)[None], kc + r, axis=0)
        btil = lax.dynamic_update_slice(btil, bt_row[:, None, :], (zero, kc + r, zero))

    return KrylovState(V, H, btil, state.beta)


class _BlockCarry(NamedTuple):
    state: KrylovState
    k: jax.Array
    small: "_SmallB"


class _SmallB(NamedTuple):
    """Sub-carry that crosses the check conditional (the O(d·Kb·n) basis
    stays outside — same trick as solver._Small)."""

    status: jax.Array
    weights: jax.Array      # (tmax·R,)
    Y: jax.Array            # (d, Kb, tmax·R)
    rel_res: jax.Array      # (kmax+1,)
    r_comp: jax.Array
    orth_h: jax.Array       # (kmax+1,) max |⟨q_new, b_r⟩|/‖b_r‖ drift probe
    lmin_h: jax.Array
    lmax_h: jax.Array
    rank_h: jax.Array


@functools.partial(jax.jit, static_argnames=("config", "R"))
def _solve_block_jit(
    op: KroneckerSumOperator,
    B: jax.Array,
    tables: Optional[BHTables],
    config: SolverConfig,
    R: int,
) -> SolveResult:
    d, n = B.shape[1], B.shape[2]
    K = config.kmax + 1
    tmax = config.tmax
    pdt = config.proj_dtype

    op_c = op.astype(_acc_dtype(config.basis_dtype, pdt))
    state0, b_norm = init_block_state(op_c, B, config.kmax, R, pdt, config.basis_dtype)
    sym = op.symmetric

    def _evaluate(args):
        sm, H, btil, k = args
        kc = k * R
        zero = jnp.zeros((), jnp.int32)
        # boundary block H[kc:kc+R, kc-R:kc] (block Lemma 3.4)
        B_blk = lax.dynamic_slice(H, (zero, kc, kc - R), (d, R, R))
        ev = projected_step(H, btil, B_blk, kc, b_norm, config, tables, sym, n, None)
        if config.debug:
            jax.debug.print(
                "block k={k}  rel_res={r:.3e}  λ∈[{a:.3e},{b:.3e}]  t={t}",
                k=k, r=ev.rel, a=ev.lmin, b=ev.lmax, t=ev.rank,
            )
        status = jnp.where(
            ev.breakdown,
            Status.BREAKDOWN,
            jnp.where(ev.rel < config.tol, Status.CONVERGED, Status.RUNNING),
        ).astype(jnp.int32)
        weights = jnp.where(ev.breakdown, sm.weights, ev.weights)
        Y = jnp.where(ev.breakdown, sm.Y, ev.Y)
        return sm._replace(
            status=status,
            weights=weights,
            Y=Y,
            rel_res=sm.rel_res.at[k].set(ev.rel),
            r_comp=sm.r_comp.at[k].set(ev.r_comp),
            lmin_h=sm.lmin_h.at[k].set(ev.lmin),
            lmax_h=sm.lmax_h.at[k].set(ev.lmax),
            rank_h=sm.rank_h.at[k].set(ev.rank),
        )

    # per-term RHS norms for the orthogonality probe: (d, 1, R)
    Bn = jnp.moveaxis(
        jnp.linalg.norm(B.astype(pdt), axis=2), 0, 1
    )[:, None, :] + jnp.asarray(1e-300, pdt)

    def body(c: _BlockCarry) -> _BlockCarry:
        k = c.k
        state = block_krylov_step(op_c, c.state, B, k, R, proj_dtype=pdt)
        # drift probe: the new block's b̃ rows ⟨q, b_r⟩ are 0 in exact
        # arithmetic for k ≥ 1 (b_r spans block 0) — their measured size is
        # genuine orthogonality loss, free from the step's own outputs
        zero = jnp.zeros((), jnp.int32)
        rows = lax.dynamic_slice(state.btil, (zero, k * R, zero), (d, R, R))
        probe = jnp.max(jnp.abs(rows) / Bn)
        sm = c.small._replace(orth_h=c.small.orth_h.at[k].set(probe))
        do_check = ((k % config.check_every) == 0) | (k >= config.kmax)
        small = lax.cond(
            do_check, _evaluate, lambda args: args[0], (sm, state.H, state.btil, k)
        )
        return _BlockCarry(state=state, k=k + 1, small=small)

    init = _BlockCarry(
        state=state0,
        k=jnp.asarray(1, jnp.int32),
        small=_SmallB(
            status=jnp.asarray(Status.RUNNING, jnp.int32),
            weights=jnp.zeros((tmax * R,), pdt),
            Y=jnp.zeros((d, K * R, tmax * R), pdt),
            rel_res=jnp.full((K,), jnp.inf, pdt),
            r_comp=jnp.full((K,), jnp.inf, pdt),
            orth_h=jnp.zeros((K,), pdt),
            lmin_h=jnp.zeros((K,), pdt),
            lmax_h=jnp.zeros((K,), pdt),
            rank_h=jnp.zeros((K,), jnp.int32),
        ),
    )

    def cond(c: _BlockCarry):
        return (c.k <= config.kmax) & (c.small.status == Status.RUNNING)

    final = lax.while_loop(cond, body, init)

    sm = final.small
    status = jnp.where(
        sm.status == Status.RUNNING, Status.MAXITER, sm.status
    ).astype(jnp.int32)
    x_factors = jnp.einsum("kdn,dkt->dnt", final.state.V.astype(pdt), sm.Y)
    return SolveResult(
        x=CPTensor(sm.weights, x_factors),
        status=status,
        niterations=final.k - 1,
        relative_residual=sm.rel_res,
        projected_residual=sm.r_comp,
        orthogonality=sm.orth_h,
        lambda_min=sm.lmin_h,
        lambda_max=sm.lmax_h,
        expsum_rank=sm.rank_h,
        config=config,
    )


def solve_block(
    op: KroneckerSumOperator,
    B,
    config: Optional[SolverConfig] = None,
    tables: Optional[BHTables] = None,
) -> SolveResult:
    """Solve A x = b for a rank-R RHS b = Σ_r ⊗_s B[r, s] in one SHARED
    block Krylov subspace (global tensorized Krylov).

    Args:
      B: (R, d, n) — factor vectors of each rank-1 RHS term.

    Returns a SolveResult whose x is a rank-(t·R) CPTensor;
    relative_residual is of the FULL rank-R system. `kmax` counts block
    iterations (each adds R basis vectors per factor).
    """
    config = _resolve_config(config or SolverConfig(), op)
    B = jnp.asarray(B)
    if B.ndim != 3 or B.shape[1] != op.d or B.shape[2] != op.n:
        raise ValueError(f"B must be (R, d, n) = (R, {op.d}, {op.n}), got {B.shape}")
    _check_identical_factors(config, op, B)
    R = B.shape[0]
    if not op.symmetric and config.orth != "arnoldi":
        raise ValueError("nonsymmetric operators require orth='arnoldi'")
    if config.spectral_source == "analytic_laplace":
        raise ValueError("block solves need spectral_source 'H' or 'A_minor'")
    if op.symmetric and tables is None:
        tables = load_tables(dtype=config.proj_dtype)
    if config.eigh_impl == "tridiag_mixed":
        # block H is block-tridiagonal, not tridiagonal
        config = dataclasses.replace(config, eigh_impl="dense")
    # each factor's space has dimension n — at k·R = n active columns the
    # Galerkin solve is exact; iterating past that would activate
    # exhausted-space columns
    if config.kmax * R > op.n:
        config = dataclasses.replace(config, kmax=max(op.n // R, 1))
    return _solve_block_jit(op, B, tables, config, R)
