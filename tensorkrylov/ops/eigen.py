"""Spectral estimation for the projected Kronecker-sum operator.

Batched rebuild of /root/reference/src/eigenvalues.jl. The per-iteration
job: bound [λ_min, λ_max] of Σ_s ⊕ H_s (k×k minors) to drive exponential-sum
rank/coefficient selection. Sources (DESIGN.md §2):

  * 'H'        — eigh of the masked H_s minors (Ritz values; exact extremes of
                 the projected operator, and the eigendecomposition is reused
                 by the compressed solve).
  * 'A_minor'  — eigh of the k×k leading minors of the A_s factors
                 (reference semantics, /root/reference/src/eigenvalues.jl:326-333).
  * 'analytic_laplace' — closed form (/root/reference/src/eigenvalues.jl:226-265).

Also here: a branch-free Sturm-sequence bisection eigensolver for symmetric
tridiagonals (the reference ships one at /root/reference/src/eigenvalues.jl:33-138;
ours is vectorized over all eigenvalue indices and factors and needs no
f64 LAPACK since it uses only elementwise ops).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..types import KroneckerSumOperator

__all__ = [
    "dense_minor_window",
    "masked_eigh",
    "masked_eigh_tridiag_mixed",
    "sym_extremes_from_eigs",
    "analytic_laplace_extremes",
    "bendixson_lambda_min",
    "tridiag_eigvalsh_sturm",
]


def dense_minor_window(op: KroneckerSumOperator, K: int) -> jax.Array:
    """Top-left K×K dense window of each factor: (d, K, K).

    The source of the reference's spectral minors
    (/root/reference/src/eigenvalues.jl:329). Cheap: built once per solve.
    """
    d, nb, n = op.bands.shape
    Kc = min(K, n)
    W = jnp.zeros((d, K, K), op.bands.dtype)
    for b, off in enumerate(op.offsets):
        if abs(off) >= Kc:
            continue
        length = Kc - abs(off)
        if off >= 0:
            vals = op.bands[:, b, :length]  # rows 0..length-1
            rows = jnp.arange(length)
            cols = rows + off
        else:
            vals = op.bands[:, b, -off : -off + length]
            rows = jnp.arange(length) - off
            cols = jnp.arange(length)
        W = W.at[:, rows, cols].add(vals)
    return W


def masked_eigh(W: jax.Array, k, pad_with_corner: bool = True) -> Tuple[jax.Array, jax.Array]:
    """eigh of the active k×k block of each (K, K) matrix in W (d, K, K).

    Padding trick: zero the coupling outside the block and put W[s,0,0] on the
    padded diagonal. W[0,0] is the k=1 Ritz/Rayleigh value, which interlacing
    places inside [λ_min, λ_max] of every leading minor — so min/max over the
    *padded* spectrum equal the true block extremes, and matrix functions of
    the padded matrix applied to block-supported vectors are exact (the pad
    block is decoupled).

    Returns (w (d, K), Q (d, K, K)) ascending.
    """
    d, K, _ = W.shape
    m = (jnp.arange(K) < k).astype(W.dtype)
    Wm = W * m[None, :, None] * m[None, None, :]
    Wm = 0.5 * (Wm + jnp.swapaxes(Wm, 1, 2))
    corner = W[:, 0, 0][:, None] if pad_with_corner else jnp.ones((d, 1), W.dtype)
    pad_diag = (1.0 - m)[None, :] * corner  # (d, K)
    idx = jnp.arange(K)
    Wm = Wm.at[:, idx, idx].add(pad_diag)
    return jnp.linalg.eigh(Wm)


def sym_extremes_from_eigs(w: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Kronecker-sum extremes from per-factor spectra: λ_min = Σ_s min_s, etc.

    Generalizes the reference's d·extreme(first factor)
    (/root/reference/src/eigenvalues.jl:321-324) to distinct factors.
    """
    return jnp.sum(jnp.min(w, axis=1)), jnp.sum(jnp.max(w, axis=1))


def analytic_laplace_extremes(d: int, n: int, k, dtype=jnp.float64) -> Tuple[jax.Array, jax.Array]:
    """Closed-form extremes of the Kronecker-sum of k×k Laplacian minors.

    λ_j of the k×k minor of (1/h²)tridiag(-1,2,-1) is (4/h²)sin²(jπ/(2(k+1)));
    the sum over d identical factors scales by d.
    Reference: /root/reference/src/eigenvalues.jl:226-265.
    """
    h2inv = jnp.asarray((n + 1) ** 2, dtype)
    kf = k.astype(dtype) if hasattr(k, "astype") else jnp.asarray(k, dtype)
    arg = jnp.pi / (2.0 * (kf + 1.0))
    lam_min = d * 4.0 * h2inv * jnp.sin(arg) ** 2
    lam_max = d * 4.0 * h2inv * jnp.sin(kf * arg) ** 2
    return lam_min, lam_max


def laplace_eigenvector(n: int, j: int, dtype=jnp.float64) -> jax.Array:
    """Analytic (unit-norm) eigenvector j (1-based) of the n×n Dirichlet
    Laplacian minor: v_j(i) ∝ sin(i·j·π/(n+1))
    (/root/reference/src/eigenvalues.jl:226-244)."""
    i = jnp.arange(1, n + 1, dtype=dtype)
    v = jnp.sin(i * j * jnp.pi / (n + 1))
    return v / jnp.linalg.norm(v)


def laplace_eigenspace(n: int, dtype=jnp.float64) -> jax.Array:
    """(n, n) matrix whose columns are the analytic Laplacian eigenvectors."""
    i = jnp.arange(1, n + 1, dtype=dtype)
    V = jnp.sin(jnp.outer(i, i) * jnp.pi / (n + 1))
    return V / jnp.linalg.norm(V, axis=0, keepdims=True)


def bendixson_lambda_min(W: jax.Array, k) -> jax.Array:
    """Lower bound on min Re λ of the active minors via the symmetric part
    (Bendixson). Jit-compatible replacement for the reference's host
    nonsymmetric eigvals (/root/reference/src/eigenvalues.jl:344-350);
    conservative (≤ true min real part), so exp-sum accuracy is preserved.

    Returns the Kronecker-sum bound Σ_s λ_min(sym(W_s minor)).
    """
    w, _ = masked_eigh(W, k)
    return jnp.sum(jnp.min(w, axis=1))


# ---------------------------------------------------------------------------
# Mixed-precision tridiagonal eigendecomposition (f64 without f64 LAPACK)


def _thomas_solve(bdiag, asub, csup, rhs, mask):
    """Batched tridiagonal solve via the Thomas algorithm.

    bdiag/asub/csup/rhs/mask: (..., K); asub[..., 0] and csup[..., K-1]
    unused. Masked rows are decoupled (b=1, a=c=rhs=0 effective). Pivots are
    magnitude-guarded so near-singular shifts (inverse iteration!) blow the
    solution up in the eigen-direction instead of producing NaNs.
    """
    dtype = bdiag.dtype
    tiny = jnp.asarray(1e-30, dtype)
    b = jnp.where(mask > 0, bdiag, 1.0)
    a = asub * mask * jnp.concatenate([jnp.zeros_like(mask[..., :1]), mask[..., :-1]], -1)
    c = csup * mask * jnp.concatenate([mask[..., 1:], jnp.zeros_like(mask[..., :1])], -1)
    r = rhs * mask

    def fwd(carry, inp):
        cp_prev, dp_prev = carry
        bi, ai, ci, ri = inp
        denom = bi - ai * cp_prev
        denom = jnp.where(jnp.abs(denom) < tiny, jnp.where(denom < 0, -tiny, tiny), denom)
        cp = ci / denom
        dp = (ri - ai * dp_prev) / denom
        return (cp, dp), (cp, dp)

    K = b.shape[-1]
    mv = lambda x: jnp.moveaxis(x, -1, 0)
    init = (jnp.zeros(b.shape[:-1], dtype), jnp.zeros(b.shape[:-1], dtype))
    _, (cps, dps) = lax.scan(fwd, init, (mv(b), mv(a), mv(c), mv(r)))

    def bwd(x_next, inp):
        cp, dp = inp
        x = dp - cp * x_next
        return x, x

    _, xs = lax.scan(bwd, jnp.zeros(b.shape[:-1], dtype), (cps, dps), reverse=True)
    return jnp.moveaxis(xs, 0, -1) * mask


def masked_eigh_tridiag_mixed(
    H: jax.Array, k, refine_vectors: bool = True
) -> Tuple[jax.Array, jax.Array]:
    """eigh of the active k×k blocks of SYMMETRIC TRIDIAGONAL matrices stored
    in padded (d, K, K) form — f64 results without LAPACK-style f64 eigh
    (for hardware whose f64 eigh is emulated):

      1. f32 dense eigh for seed eigenpairs,
      2. Sturm-bisection refinement of each eigenvalue in f64 (a few
         elementwise sweeps inside ±O(eps32·‖T‖) brackets),
      3. one f64 inverse-iteration step (batched Thomas solves) from the f32
         eigenvectors,
      4. Newton–Schulz re-orthonormalization (f64 GEMMs, K×K).

    Same padding contract as masked_eigh (corner value on the padded
    diagonal). Intended for the Lanczos path where H is tridiagonal by
    construction.
    """
    d, K, _ = H.shape
    pdt = H.dtype
    m = (jnp.arange(K) < k).astype(pdt)
    idx = jnp.arange(K)
    diag = H[:, idx, idx]
    sub = jnp.concatenate(
        [jnp.zeros((d, 1), pdt), H[:, idx[1:], idx[1:] - 1]], axis=1
    )  # sub[i] couples rows i-1, i
    sub = sub * m[None, :] * jnp.roll(m, 1)[None, :]
    # pad the inactive diagonal ABOVE the active spectrum so the padded
    # eigenpairs sort last (columns k..K-1) — unlike masked_eigh's corner
    # padding, this keeps the sorted bookkeeping trivial; padded eigenvalues
    # are folded back to the minimum before returning.
    gersh_hi = jnp.max(
        jnp.where(m[None, :] > 0, jnp.abs(diag) + 2.0 * jnp.abs(sub), -jnp.inf),
        axis=1, keepdims=True,
    )
    pad_val = 2.0 * gersh_hi + 1.0
    diag = jnp.where(m[None, :] > 0, diag, pad_val)

    # 1. f32 seed
    Wm = jnp.zeros((d, K, K), jnp.float32)
    Wm = Wm.at[:, idx, idx].set(diag.astype(jnp.float32))
    Wm = Wm.at[:, idx[1:], idx[1:] - 1].set(sub[:, 1:].astype(jnp.float32))
    Wm = Wm.at[:, idx[1:] - 1, idx[1:]].set(sub[:, 1:].astype(jnp.float32))
    w32, Q32 = jnp.linalg.eigh(Wm)

    # 2. f64 Rayleigh-quotient refinement of the seed eigenvalues —
    # fully vectorized (reductions only; a Sturm-bisection refinement is
    # latency-bound: ~30 rounds × K sequential recurrence steps)
    def rayleigh(Qcols):  # Qcols: (d, K rows, j) f64, assumed unit columns
        Tq_diag = diag[:, :, None] * Qcols
        Tq_up = jnp.concatenate([sub[:, 1:, None] * Qcols[:, 1:, :], jnp.zeros((d, 1, K), pdt)], axis=1)
        Tq_dn = jnp.concatenate([jnp.zeros((d, 1, K), pdt), sub[:, 1:, None] * Qcols[:, :-1, :]], axis=1)
        Tq = Tq_diag + Tq_up + Tq_dn
        return jnp.sum(Qcols * Tq, axis=1)  # (d, j)

    Q64 = Q32.astype(pdt)
    nrm0 = jnp.sqrt(jnp.sum(Q64 * Q64, axis=1, keepdims=True))
    Q64 = Q64 / jnp.where(nrm0 > 0, nrm0, 1.0)
    w = rayleigh(Q64)

    if refine_vectors:
        # 3. one inverse-iteration step per eigenpair in f64 (the only
        # sequential part — a batched Thomas solve over K rows). Skip when
        # the caller's basis is ≤ f32: the f32-seed vectors are already at
        # the precision of the data feeding H.
        bd = diag[:, None, :] - w[:, :, None]                  # (d, j, K rows)
        asub_l = jnp.broadcast_to(sub[:, None, :], bd.shape)
        csup_l = jnp.broadcast_to(
            jnp.concatenate([sub[:, 1:], jnp.zeros((d, 1), pdt)], 1)[:, None, :], bd.shape
        )
        rhs = jnp.swapaxes(Q64, 1, 2)                          # (d, j, K rows)
        mask_l = jnp.broadcast_to(m[None, None, :], bd.shape)
        x = _thomas_solve(bd, asub_l, csup_l, rhs, mask_l)
        nrm = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True))
        x = x / jnp.where(nrm > 0, nrm, 1.0)
        Q = jnp.swapaxes(x, 1, 2)                              # (d, K rows, j)
        # second Rayleigh quotient from the refined vectors → eigenvalues to
        # ~(vector error)² i.e. full f64 for well-separated pairs; clustered
        # pairs keep small residual ‖Tq − λq‖, which is what matrix-function
        # accuracy needs
        w = rayleigh(Q)
    else:
        Q = Q64
    # restore padded-block eigenvectors exactly (decoupled identity block)
    pad_cols = (jnp.arange(K)[None, :] >= k).astype(pdt)
    eye = jnp.eye(K, dtype=pdt)
    Q = Q * (1.0 - pad_cols)[:, None, :] + eye[None] * pad_cols[:, None, :]

    # 4. Newton–Schulz orthonormalization (two steps)
    for _ in range(2):
        G = jnp.einsum("dij,dik->djk", Q, Q)
        Q = 1.5 * Q - 0.5 * jnp.einsum("dij,djk->dik", Q, G)

    # fold padded eigenvalues back to the active minimum: harmless for
    # matrix functions (their eigenvector components of b̃ are zero) and
    # keeps min/max over w equal to the ACTIVE extremes
    w = jnp.where(jnp.arange(K)[None, :] < k, w, w[:, :1])
    return w, Q


# ---------------------------------------------------------------------------
# Sturm-sequence bisection (vectorized tridiagonal eigenvalues)


def _sturm_count(diag: jax.Array, off2: jax.Array, x: jax.Array, mask: jax.Array) -> jax.Array:
    """#eigenvalues < x of the masked symmetric tridiagonal(s).

    diag: (..., K), off2: (..., K) squared off-diagonals with off2[..., 0] = 0,
    x: (..., 1)-broadcastable shift, mask: (..., K) active rows.
    LAPACK-dstebz-style recurrence q_i = (d_i - x) - e_{i-1}^2 / q_{i-1},
    counting negative q_i, with zero-safeguarding. Masked rows contribute a
    fixed positive q (no count, no coupling).
    """
    dtype = diag.dtype
    eps = jnp.finfo(dtype).tiny * 1e8

    def body(carry, inp):
        q_prev, count = carry
        di, e2, mi = inp
        q = (di - x) - e2 / q_prev
        q = jnp.where(jnp.abs(q) < eps, -eps, q)
        q = jnp.where(mi > 0, q, jnp.ones_like(q))
        count = count + jnp.where((q < 0) & (mi > 0), 1, 0)
        return (q, count), None

    K = diag.shape[-1]
    init_q = jnp.ones_like(x)
    init_c = jnp.zeros(x.shape, jnp.int32)
    (q, count), _ = lax.scan(
        body,
        (init_q, init_c),
        (
            jnp.moveaxis(diag, -1, 0)[..., None],
            jnp.moveaxis(off2, -1, 0)[..., None],
            jnp.moveaxis(mask, -1, 0)[..., None],
        ),
    )
    return count[..., 0]


def tridiag_eigvalsh_sturm(diag: jax.Array, offdiag: jax.Array, k=None, n_iter: int = 80) -> jax.Array:
    """All eigenvalues of batched symmetric tridiagonals via bisection.

    diag: (d, K), offdiag: (d, K) with offdiag[:, 0] unused (e_i couples rows
    i-1, i). If k is given, only the leading k×k minor is active; inactive
    eigenvalue slots return the upper Gershgorin bound.

    Branch-free: every eigenvalue index for every factor bisects in parallel
    (K·d independent bisections, ~n_iter elementwise sweeps of the Sturm
    scan). Needs no LAPACK.
    """
    d, K = diag.shape
    if k is None:
        k = K
    mask = (jnp.arange(K)[None, :] < k).astype(diag.dtype)
    e = jnp.concatenate([jnp.zeros((d, 1), diag.dtype), offdiag[:, 1:]], axis=1)
    e = e * mask * jnp.roll(mask, 1, axis=1)  # decouple masked rows
    e2 = e * e

    # Gershgorin bounds over active rows
    radius = jnp.abs(e) + jnp.abs(jnp.roll(e, -1, axis=1)) * jnp.roll(mask, -1, axis=1)
    lo = jnp.min(jnp.where(mask > 0, diag - radius, jnp.inf), axis=1, keepdims=True)
    hi = jnp.max(jnp.where(mask > 0, diag + radius, -jnp.inf), axis=1, keepdims=True)
    lo = jnp.broadcast_to(lo, (d, K))
    hi = jnp.broadcast_to(hi, (d, K))

    # eigenvalue index j (ascending): find x with count(x) <= j < count-at-hi
    targets = jnp.arange(K)[None, :]

    def body(i, carry):
        lo_i, hi_i = carry
        mid = 0.5 * (lo_i + hi_i)
        cnt = _sturm_count(diag[:, None, :] * jnp.ones((1, K, 1), diag.dtype),
                           jnp.broadcast_to(e2[:, None, :], (d, K, K)),
                           mid[..., None],
                           jnp.broadcast_to(mask[:, None, :], (d, K, K)))
        go_right = cnt <= targets
        lo_i = jnp.where(go_right, mid, lo_i)
        hi_i = jnp.where(go_right, hi_i, mid)
        return (lo_i, hi_i)

    lo_f, hi_f = lax.fori_loop(0, n_iter, body, (lo, hi))
    return 0.5 * (lo_f + hi_f)
