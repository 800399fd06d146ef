"""Exponential-sum solve of the projected (compressed) system.

H y = b̃ with H = Σ_s ⊕ H_s is solved in rank-t CP form via
1/x ≈ Σ_j ω_j exp(−α_j x) on [λ_min, λ_max]:

    y = Σ_j (ω_j/λ_min) ⊗_s exp(−(α_j/λ_min) H_s) b̃_s

Behavioural reference: /root/reference/src/tensor_krylov_method.jl:10-34 and
/root/reference/src/utils.jl:501-546.

Formulation (DESIGN.md §3):
  * SPD: one eigh per factor per iteration (shared with spectral
    estimation), then ALL t exponential terms are a single diagonal-scaled
    GEMM — cheaper than the reference's t dense matrix exponentials.
  * Nonsymmetric: one complex eigendecomposition per factor and t diagonal
    scalings (cp_solve_nonsym_eig), or on request an LU-free f64 matrix
    exponential (scaling-and-squaring + Taylor) scanned over the t terms.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["cp_solve_sym", "cp_solve_nonsym", "cp_solve_nonsym_eig", "expm_taylor_ss"]


def cp_solve_sym(
    w: jax.Array,        # (d, K) eigenvalues of padded H_s minors
    Q: jax.Array,        # (d, K, K) eigenvectors
    btil: jax.Array,     # (d, K) compressed RHS, or (d, K, R) rank-R block
    k,                   # active size
    omega: jax.Array,    # (tmax,) exp-sum weights (masked 0 beyond rank)
    alpha: jax.Array,    # (tmax,) exp-sum exponents (masked 0 beyond rank)
    t_mask: jax.Array,   # (tmax,) 1.0 for active terms
    lam_min: jax.Array,  # scalar: λ_min of the projected Kronecker sum
) -> Tuple[jax.Array, jax.Array]:
    """Returns (weights (tmax·R,), factors (d, K, tmax·R)) of the CP
    solution (R = 1 for the scalar rank-1 RHS path).

    factors[s, :, j·R+r] = exp(−(α_j/λ_min) H_s) b̃_{s,r}, computed as
    Q (exp(−w α_j/λ_min) ∘ (Qᵀ b̃)) — exact for the active block because the
    padding is decoupled and b̃ is zero on padded rows.
    """
    K = w.shape[1]
    if btil.ndim == 2:
        btil = btil[:, :, None]
    R = btil.shape[2]
    m = (jnp.arange(K) < k).astype(btil.dtype)
    btil_m = btil * m[None, :, None]
    g = jnp.einsum("dkj,dkr->djr", Q, btil_m)                # Qᵀ b̃, (d, K, R)
    # exponents: (d, K, tmax); clamp to avoid overflow on padded/masked slots
    ex = jnp.exp(-jnp.clip(w[:, :, None] * (alpha / lam_min)[None, None, :], -700.0, 700.0))
    factors = jnp.einsum("dkj,djt,djr->dktr", Q, ex, g)      # (d, K, tmax, R)
    factors = factors * t_mask[None, None, :, None]
    factors = factors.reshape(factors.shape[0], K, -1)
    weights = jnp.repeat((omega / lam_min) * t_mask, R)
    return weights, factors


def expm_taylor_ss(A: jax.Array, order: int = 18, max_squarings: int = 32) -> jax.Array:
    """exp(A) via scaling-and-squaring + Taylor — matmuls only (no LU
    solve, unlike Padé). A: (..., K, K).

    With ‖A/2^s‖₁ ≤ 1/2, an order-18 Taylor series has remainder
    < 1/2^19/19! ~ 1e-23 — below f64 roundoff.
    """
    norm = jnp.max(jnp.sum(jnp.abs(A), axis=-1), axis=-1)  # (...,) inf-norm
    # s such that norm / 2^s <= 0.5
    s = jnp.ceil(jnp.log2(jnp.maximum(norm, 1e-300) * 2.0))
    s = jnp.clip(s, 0, max_squarings).astype(jnp.int32)
    scale = jnp.exp2(-s.astype(A.dtype))
    As = A * scale[..., None, None]

    K = A.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(K, dtype=A.dtype), A.shape)

    # Horner evaluation of Σ As^i / i!
    out = eye + As / order
    for i in range(order - 1, 0, -1):
        out = eye + (As @ out) / i

    def square_body(i, val):
        return jnp.where((i < s)[..., None, None], val @ val, val)

    out = lax.fori_loop(0, max_squarings, square_body, out)
    return out


def cp_solve_nonsym_eig(
    H: jax.Array,        # (d, K, K) Hessenberg factors (padded)
    btil: jax.Array,     # (d, K) or (d, K, R)
    k,
    omega: jax.Array,
    alpha: jax.Array,
    t_mask: jax.Array,
    lam_min: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    """Nonsymmetric projected solve via ONE complex eigendecomposition per
    factor: y_j = S exp(−γ_j Λ) S⁻¹ b̃ — replaces the t-term expm chain
    (t ≈ 200 Stenger terms at tol = 1e-9) with one O(K³) eig plus t diagonal
    scalings: ~t× fewer matmuls per residual check, which is what makes the
    full reference-scale nonsym reproduction (n = 200, d ≤ 100) tractable.

    jnp.linalg.eig lowers on the CPU and on NVIDIA GPUs (cuSOLVER);
    SolverConfig.nonsym_solve_impl = 'auto' selects it. Diagonalization
    accuracy rests
    on the Arnoldi Hessenberg being non-defective (generic for the
    convection–diffusion family; validated against the expm path in
    tests/test_ops.py)."""
    d, K, _ = H.shape
    tmax = alpha.shape[0]
    if btil.ndim == 2:
        btil = btil[:, :, None]
    R = btil.shape[2]
    m = (jnp.arange(K) < k).astype(H.dtype)
    Hm = H * m[None, :, None] * m[None, None, :]
    # decoupled positive padding keeps the padded eigenvalues simple (the
    # corner Rayleigh value, same trick as masked_eigh) — b̃ is zero there
    idx = jnp.arange(K)
    Hm = Hm.at[:, idx, idx].add((1.0 - m)[None, :] * H[:, 0, 0][:, None])
    btil_m = btil * m[None, :, None]

    w, S = jnp.linalg.eig(Hm)                       # complex (d, K), (d, K, K)
    g = jnp.linalg.solve(S, btil_m.astype(S.dtype))  # (d, K, R)
    gam = (alpha / lam_min)[None, None, :].astype(S.dtype)
    expw = jnp.exp(-w[:, :, None] * gam)            # (d, K, tmax)
    factors = jnp.einsum("dkj,djt,djr->dktr", S, expw, g).real.astype(H.dtype)
    factors = factors * t_mask[None, None, :, None] * m[None, :, None, None]
    factors = factors.reshape(d, K, tmax * R)
    weights = jnp.repeat((omega / lam_min) * t_mask, R)
    return weights, factors


def cp_solve_nonsym(
    H: jax.Array,        # (d, K, K) Hessenberg factors (padded)
    btil: jax.Array,     # (d, K) or (d, K, R) rank-R block
    k,
    omega: jax.Array,    # (tmax,)
    alpha: jax.Array,    # (tmax,)
    t_mask: jax.Array,   # (tmax,)
    lam_min: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    """Nonsymmetric projected solve: scan the t exponential terms, each a
    batched (over d) LU-free expm. Reference: the dense `exp` path at
    /root/reference/src/utils.jl:501-523 (which assumes identical factors;
    we batch over distinct factors). Returns (weights (tmax·R,),
    factors (d, K, tmax·R)); R = 1 for the scalar path.
    """
    d, K, _ = H.shape
    tmax = alpha.shape[0]
    if btil.ndim == 2:
        btil = btil[:, :, None]
    R = btil.shape[2]
    m = (jnp.arange(K) < k).astype(H.dtype)
    Hm = H * m[None, :, None] * m[None, None, :]
    btil_m = btil * m[None, :, None]
    n_terms = jnp.sum(t_mask).astype(jnp.int32)

    def term(carry):
        factors, j = carry
        gamma = -alpha[j] / lam_min
        E = expm_taylor_ss(Hm * gamma)
        cols = jnp.einsum("dij,djr->dir", E, btil_m)  # (d, K, R)
        factors = lax.dynamic_update_slice(
            factors, cols[:, :, None, :],
            (jnp.zeros((), jnp.int32),) * 2 + (j, jnp.zeros((), jnp.int32)),
        )
        return factors, j + 1

    # while_loop (not scan): only the ACTIVE terms pay their expm — with a
    # large tmax grid the masked tail would otherwise dominate the check
    factors0 = jnp.zeros((d, K, tmax, R), H.dtype)
    factors, _ = lax.while_loop(
        lambda c: c[1] < n_terms, term, (factors0, jnp.zeros((), jnp.int32))
    )
    factors = factors * t_mask[None, None, :, None]
    factors = factors.reshape(d, K, tmax * R)
    weights = jnp.repeat((omega / lam_min) * t_mask, R)
    return weights, factors
