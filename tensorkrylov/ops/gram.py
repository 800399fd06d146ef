"""Low-rank (Lemma 3.4) residual-norm algebra.

Evaluates ‖r‖² = Σ_s |h^{(s)}_{k+1,k}|²·‖y_𝔏‖²_s + ‖H y − b̃‖² for a CP
tensor y without materializing anything of size k^d.

Behavioural reference: /root/reference/src/utils.jl:132-443 (maskprod /
MVnorm / tensorinnerprod / compressed_residual / residualnorm!).

Formulation (DESIGN.md §5): instead of the reference's O(d²·t²)
masked-product double loop, a *transfer-matrix scan over the d modes*. For
each (i, j) rank pair, Σ_{s,r} Π_m G_m^{(s,r)} is a polynomial in the
per-mode Gram matrices; scanning modes with the carry

    p   = Π_m g_m                     (no H anywhere)
    pa  = Σ_s a_s Π_{m≠s} g_m        (H on the left argument, one mode)
    pb  = Σ_r b_r Π_{m≠r} g_m        (H on the right argument, one mode)
    pc  = Σ_s c_s Π_{m≠s} g_m        (H on both arguments, same mode)
    pab = Σ_{s≠r} a_s b_r Π_{m∉{s,r}} g_m

(all t×t, elementwise products) gives the exact sum division-free in
O(d·t²) elementwise work after O(d·t²·k) GEMM Grams. Everything here is f64:
‖Hy‖² − 2⟨Hy,b̃⟩ + ‖b̃‖² is catastrophically cancellative (the reference
dedicates a breakdown exception to it, /root/reference/src/utils.jl:7-14).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "ResidualTerms",
    "cp_gram_matrices",
    "mv_norm_sq",
    "tensor_inner_prod",
    "residual_norm_sq",
    "excluded_products",
]


def _mask_yz(H, Y, btil, k):
    K = H.shape[1]
    m = (jnp.arange(K) < k).astype(H.dtype)
    Hm = H * m[None, :, None] * m[None, None, :]
    Ym = Y * m[None, :, None]
    if btil.ndim == 2:
        btil_m = btil * m[None, :]
    else:  # block RHS (d, K, R)
        btil_m = btil * m[None, :, None]
    return Hm, Ym, btil_m


def cp_gram_matrices(Hm, Ym):
    """Z = H_s Y_s and the three t×t Gram families (all (d, t, t))."""
    Z = jnp.einsum("dij,djt->dit", Hm, Ym)
    Gy = jnp.einsum("dkt,dks->dts", Ym, Ym)
    Gz = jnp.einsum("dkt,dks->dts", Z, Z)
    X = jnp.einsum("dkt,dks->dts", Ym, Z)  # X[i,j] = <y_i, H y_j>
    return Z, Gy, Gz, X


def mv_norm_sq(Gy, Gz, X, weights):
    """‖H y‖² via the transfer composition over modes. Reference: MVnorm,
    /root/reference/src/utils.jl:255-324 (O(d²t²) there; O(dt²) work and
    O(log d) depth here).

    Per mode m the carry map (p, pa, pb, pc, pab) → ... is linear with
    elementwise t×t coefficients; compositions stay in the closed family
    (g, a, b, c, e) with

        g12 = g2∘g1                 (p path)
        a12 = a2∘g1 + g2∘a1         (p → pa)
        b12 = b2∘g1 + g2∘b1         (p → pb)
        c12 = c2∘g1 + g2∘c1         (p → pc)
        e12 = b2∘a1 + a2∘b1 + g2∘e1 + e2∘g1 (p → pab)

    — an associative combine, evaluated with lax.associative_scan so the
    d-mode reduction is log-depth (a sequential scan is latency-bound at
    large d)."""
    a_all = jnp.swapaxes(X, 1, 2)   # <H y_i, y_j> — H on left (term s=m)
    b_all = X                       # <y_i, H y_j> — H on right (term r=m)
    e_all = jnp.zeros_like(Gy)

    def combine(m1, m2):
        g1, a1, b1, c1, e1 = m1
        g2, a2, b2, c2, e2 = m2
        return (
            g2 * g1,
            a2 * g1 + g2 * a1,
            b2 * g1 + g2 * b1,
            c2 * g1 + g2 * c1,
            b2 * a1 + a2 * b1 + g2 * e1 + e2 * g1,
        )

    g, a, b, c, e = lax.associative_scan(combine, (Gy, a_all, b_all, Gz, e_all))
    T = e[-1] + c[-1]  # applied to the init (p=1, rest 0)
    return weights @ T @ weights


def tensor_inner_prod(Ym, Z, btil_m, weights):
    """⟨H y, b̃⟩ via the single-excluded-index scan. Reference:
    tensorinnerprod, /root/reference/src/utils.jl:326-368 (which hard-codes
    b̃ = ‖b‖e₁; we use the actual b̃ vectors, supporting drift, general
    starting vectors, and rank-R block RHS b̃ (d, K, R))."""
    if btil_m.ndim == 2:
        btil_m = btil_m[:, :, None]
    g = jnp.einsum("dkt,dkr->dtr", Ym, btil_m)  # <y_i, b̃_r>_m
    a = jnp.einsum("dkt,dkr->dtr", Z, btil_m)   # <H y_i, b̃_r>_m

    def combine(m1, m2):
        g1, a1 = m1
        g2, a2 = m2
        return (g2 * g1, a2 * g1 + g2 * a1)

    gc, ac = lax.associative_scan(combine, (g, a))
    return weights @ jnp.sum(ac[-1], axis=1)


def excluded_products(Gy):
    """E_s = Π_{m≠s} Gy_m elementwise, via exclusive forward/backward
    cumulative products (division-free). (d, t, t)."""
    ones = jnp.ones_like(Gy[:1])
    pre = jnp.concatenate([ones, jnp.cumprod(Gy, axis=0)[:-1]], axis=0)
    rev = jnp.flip(jnp.cumprod(jnp.flip(Gy, axis=0), axis=0), axis=0)
    suf = jnp.concatenate([rev[1:], ones], axis=0)
    return pre * suf


class ResidualTerms(NamedTuple):
    r_norm_sq: jax.Array      # full Lemma-3.4 squared residual
    r_comp_sq: jax.Array      # ‖Hy − b̃‖² (compressed part; may go negative)
    boundary_sq: jax.Array    # Σ_s h²‖y_𝔏‖² term
    cancel_scale: jax.Array   # ‖Hy‖² + ‖b̃‖² — the magnitude against which
                              # the cancellation error of r_comp_sq scales


def residual_norm_sq(H, Y, btil, k, weights, subdiag) -> ResidualTerms:
    """Full residual evaluation. Reference: residualnorm!,
    /root/reference/src/utils.jl:402-443.

    Args:
      H: (d, K, K) projected factors (padded). Y: (d, K, T) CP factors
      (masked columns). btil: (d, K) or block (d, K, R). k: active column
      count. weights: (T,).
      subdiag: (d,) entries h^{(s)}_{k+1,k}, or the block-Krylov boundary
      blocks (d, R, R) = H_s[k:k+R, k-R:k] (scalar case is R = 1).
    """
    Hm, Ym, btil_m = _mask_yz(H, Y, btil, k)
    Z, Gy, Gz, X = cp_gram_matrices(Hm, Ym)

    hy2 = mv_norm_sq(Gy, Gz, X, weights)
    ip = tensor_inner_prod(Ym, Z, btil_m, weights)
    if btil_m.ndim == 2:
        b2 = jnp.prod(jnp.sum(btil_m * btil_m, axis=1))
    else:
        # ‖Σ_r ⊗_s b̃_{s,r}‖² = Σ_{r,q} Π_s ⟨b̃_{s,r}, b̃_{s,q}⟩
        Gb = jnp.einsum("dkr,dkq->drq", btil_m, btil_m)
        b2 = jnp.sum(jnp.prod(Gb, axis=0))
    r_comp_sq = hy2 - 2.0 * ip + b2

    # boundary terms: the trailing R-row slice of y in mode s across all
    # ranks, weighted by the boundary block Gram BᵀB (block Lemma 3.4:
    # A_s V_s = V_s H_s + Q_s B_s E_Rᵀ with Q_s ⟂ V_s orthonormal)
    if subdiag.ndim == 1:
        subdiag = subdiag[:, None, None]  # (d, 1, 1)
    R = subdiag.shape[1]
    yrows = lax.dynamic_slice_in_dim(Y, k - R, R, axis=1)           # (d, R, T)
    M = jnp.einsum("dri,drj->dij", subdiag, subdiag)                # BᵀB (d, R, R)
    bg = jnp.einsum("drt,drq,dqu->dtu", yrows, M, yrows)            # (d, T, T)
    E = excluded_products(Gy)                                       # (d, T, T)
    per_mode = jnp.einsum("i,dij,j->d", weights, bg * E, weights)
    boundary = jnp.sum(per_mode)

    r_comp_clamped = jnp.maximum(r_comp_sq, 0.0)
    return ResidualTerms(boundary + r_comp_clamped, r_comp_sq, boundary, hy2 + b2)
