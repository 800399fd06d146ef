"""Problem gallery — the "model families" of the framework.

Batched rebuild of the reference's MatrixGallery
(/root/reference/src/tensor_struct.jl:18-79): each constructor returns a
:class:`KroneckerSumOperator` with stacked DIA bands instead of per-factor
Julia sparse/dense matrices. Matrices are assembled on host in numpy
(float64) — assembly is not a hot path — and shipped to device once.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ..types import KroneckerSumOperator

__all__ = [
    "laplace",
    "reaction_diffusion",
    "conv_diff",
    "eigval_matrix",
    "rand_spd",
    "dense_to_bands",
    "bands_to_dense",
    "operator_from_dense_factors",
    "operator_from_ragged_factors",
    "pad_ragged_rhs",
    "operator_from_scipy",
]


def _banded_operator(diags: dict, d: int, n: int, dtype, symmetric: bool) -> KroneckerSumOperator:
    """Build an operator whose d factors are all equal to the banded matrix
    described by {offset: values or scalar}."""
    offsets = tuple(sorted(diags.keys()))
    bands = np.zeros((len(offsets), n), dtype=np.float64)
    for b, off in enumerate(offsets):
        length = n - abs(off)
        vals = diags[off]
        vals = np.broadcast_to(np.asarray(vals, dtype=np.float64), (length,))
        if off >= 0:
            bands[b, :length] = vals
        else:
            bands[b, -off:] = vals
    stacked = np.broadcast_to(bands, (d, len(offsets), n))
    return KroneckerSumOperator(jnp.asarray(stacked, dtype=dtype), offsets, symmetric)


def laplace(d: int, n: int, dtype=jnp.float64, shift: float = 0.0) -> KroneckerSumOperator:
    """1-D Dirichlet Laplacian factors: (1/h²)·tridiag(-1, 2, -1), h = 1/(n+1),
    plus an optional diagonal shift σ·I per factor.

    Reference: LaplaceDense/Laplace, /root/reference/src/tensor_struct.jl:48-57
    (dense vs sparse storage is a non-distinction here — both map to bands).
    The shift is the diagonal-α device of the reference's parameterized
    condition-number experiments (/root/reference/experiments/parameterized_systems.jl:3-71).
    """
    h2inv = float((n + 1) ** 2)
    return _banded_operator(
        {-1: -h2inv, 0: 2.0 * h2inv + float(shift), 1: -h2inv}, d, n, dtype, symmetric=True
    )


def reaction_diffusion(d: int, n: int, sigma: float, dtype=jnp.float64) -> KroneckerSumOperator:
    """σu − Δu factors: the shifted Laplacian (σ + 4/h²·sin²)·spectrum.

    One implicit-Euler step of a d-dimensional heat/reaction equation with
    time step Δt = 1/σ on an n^d tensor grid — the physically standard way a
    Kronecker-sum system with a *controlled* condition number arises in
    production (κ ≈ (σ + 4(n+1)²)/(σ + π²)). Same family as the reference's
    diagonal-shift parameterized systems
    (/root/reference/experiments/parameterized_systems.jl:3-41).
    """
    return laplace(d, n, dtype=dtype, shift=float(sigma))


def conv_diff(d: int, n: int, c: float = 10.0, dtype=jnp.float64,
              shift: float = 0.0) -> KroneckerSumOperator:
    """Convection–diffusion factors: Laplacian + (c/4h)·diags(+1 @ -1, +3 @ 0,
    -5 @ +1, +1 @ +2) — nonsymmetric, bandwidth (1 lower, 2 upper) — plus an
    optional diagonal shift σ·I per factor (the reaction term that sets the
    condition number for the at-scale nonsym runs, exactly like laplace's).

    Reference: ConvDiff, /root/reference/src/tensor_struct.jl:60-68; the β
    convection sweep of /root/reference/experiments/parameterized_systems.jl.
    """
    h = 1.0 / (n + 1)
    h2inv = 1.0 / h**2
    cv = c / (4.0 * h)
    return _banded_operator(
        {
            -1: -h2inv + cv,
            0: 2.0 * h2inv + 3.0 * cv + shift,
            1: -h2inv - 5.0 * cv,
            2: cv,
        },
        d,
        n,
        dtype,
        symmetric=False,
    )


def eigval_matrix(eigenvalues, d: Optional[int] = None, dtype=jnp.float64) -> KroneckerSumOperator:
    """Diagonal factors with a prescribed spectrum (synthetic-spectrum model).

    Reference: EigValMat, /root/reference/src/tensor_struct.jl:70.
    Accepts one (n,) vector (replicated over d) or a (d, n) array.
    """
    ev = np.asarray(eigenvalues, dtype=np.float64)
    if ev.ndim == 1:
        assert d is not None, "pass d when giving a single eigenvalue vector"
        ev = np.broadcast_to(ev, (d, ev.shape[0]))
    bands = ev[:, None, :]  # (d, 1, n), offset 0
    return KroneckerSumOperator(jnp.asarray(bands, dtype=dtype), (0,), symmetric=True)


def rand_spd(d: int, n: int, seed: int = 0, dtype=jnp.float64) -> KroneckerSumOperator:
    """Random dense SPD factors A_s = R_s^T R_s (distinct per factor, unlike
    the reference which replicates one draw).

    Reference: RandSPD, /root/reference/src/tensor_struct.jl:73-79. Dense
    matrices are stored as full bands (offsets -(n-1)..(n-1)); for dense
    problems prefer `operator_from_dense_factors`.
    """
    rng = np.random.default_rng(seed)
    mats = []
    for _ in range(d):
        r = rng.random((n, n))
        mats.append(r.T @ r)
    return operator_from_dense_factors(np.stack(mats), symmetric=True, dtype=dtype)


# ---------------------------------------------------------------------------
# Conversions


def dense_to_bands(mats: np.ndarray, offsets: Optional[Sequence[int]] = None):
    """(d, n, n) dense factors → ((d, nb, n) bands, offsets tuple).

    If offsets is None, detects nonzero diagonals across all factors.
    """
    mats = np.asarray(mats)
    d, n, _ = mats.shape
    if offsets is None:
        offsets = [
            off
            for off in range(-(n - 1), n)
            if any(np.any(np.diagonal(mats[s], off)) for s in range(d))
        ]
        if not offsets:
            offsets = [0]
    offsets = tuple(offsets)
    bands = np.zeros((d, len(offsets), n), dtype=mats.dtype)
    for b, off in enumerate(offsets):
        length = n - abs(off)
        for s in range(d):
            diag = np.diagonal(mats[s], off)
            if off >= 0:
                bands[s, b, :length] = diag
            else:
                bands[s, b, -off:] = diag
    return bands, offsets


def bands_to_dense(op: KroneckerSumOperator) -> np.ndarray:
    """(d, nb, n) bands → (d, n, n) dense factors (test/debug oracle)."""
    bands = np.asarray(op.bands)
    d, nb, n = bands.shape
    out = np.zeros((d, n, n), dtype=bands.dtype)
    for b, off in enumerate(op.offsets):
        for i in range(n):
            j = i + off
            if 0 <= j < n:
                out[:, i, j] = bands[:, b, i]
    return out


def operator_from_dense_factors(mats, symmetric: bool, dtype=jnp.float64) -> KroneckerSumOperator:
    if isinstance(mats, (list, tuple)):
        shapes = {np.asarray(A).shape for A in mats}
        if len(shapes) > 1:
            raise ValueError(
                f"factors have different sizes {sorted(shapes)}; use "
                "operator_from_ragged_factors (pad-to-max, exact) for "
                "per-mode dimensions"
            )
        mats = np.stack([np.asarray(A, np.float64) for A in mats])
    bands, offsets = dense_to_bands(np.asarray(mats, dtype=np.float64))
    return KroneckerSumOperator(jnp.asarray(bands, dtype=dtype), offsets, symmetric)


def operator_from_scipy(factors, symmetric: bool, dtype=jnp.float64) -> KroneckerSumOperator:
    """Build the operator from a list of scipy.sparse factor matrices
    (interoperability path for users coming from sparse ecosystems —
    the reference consumes SparseArrays matrices directly)."""
    import scipy.sparse as sp

    mats = [sp.dia_matrix(A) for A in factors]
    if len({A.shape for A in mats}) > 1:
        raise ValueError(
            f"scipy factors have different sizes {sorted({A.shape for A in mats})}; "
            "use operator_from_ragged_factors (pad-to-max, exact)"
        )
    n = mats[0].shape[0]
    offsets = sorted({int(o) for A in mats for o in A.offsets})
    bands = np.zeros((len(mats), len(offsets), n))
    for s, A in enumerate(mats):
        dense_diags = {int(o): A.data[i] for i, o in enumerate(A.offsets)}
        for b, off in enumerate(offsets):
            if off not in dense_diags:
                continue
            row = dense_diags[off]
            # scipy DIA stores data[k, j] = A[j - off, j]: column-indexed
            length = n - abs(off)
            if off >= 0:
                bands[s, b, :length] = row[off : off + length]
            else:
                bands[s, b, -off:] = row[: length]
    return KroneckerSumOperator(jnp.asarray(bands, dtype=dtype), tuple(offsets), symmetric)


def operator_from_ragged_factors(factors, symmetric: bool, dtype=jnp.float64):
    """Build an operator from factors of DIFFERENT sizes n_s (the reference's
    factor list admits arbitrary per-mode sizes,
    /root/reference/src/tensor_struct.jl:168-231; the stacked (d, nb, n)
    layout needs equal n — this is the pad-to-max bridge).

    Construction (exact, not approximate): factor A_s is embedded as the
    leading block of an n_max-sized block-diagonal matrix
    blockdiag(A_s, c_s·I), c_s = A_s[0, 0]. With the RHS padded by ZEROS
    (`pad_ragged_rhs`), the Krylov recurrences, the projected algebra and
    the solution never touch the pad block (it is invariant and b has no
    component there), so the padded solve IS the ragged solve; solution
    factor rows ≥ n_s are identically zero. The pad constant is a diagonal
    entry of A_s — a Rayleigh quotient, hence inside [λ_min(A_s),
    λ_max(A_s)] — so the padded spectrum has the SAME extremes: Gershgorin
    bounds, deflation intervals and exp-sum coefficient selection stay
    valid.

    Returns (op, sizes) with sizes the tuple of true per-mode dimensions.
    """
    mats = [np.asarray(A, np.float64) for A in factors]
    for s, A in enumerate(mats):
        if A.ndim != 2 or A.shape[0] != A.shape[1]:
            raise ValueError(f"factor {s} is not square: {A.shape}")
    sizes = tuple(A.shape[0] for A in mats)
    n_max = max(sizes)
    padded = np.zeros((len(mats), n_max, n_max))
    for s, A in enumerate(mats):
        ns = sizes[s]
        padded[s, :ns, :ns] = A
        if ns < n_max:
            padded[s, range(ns, n_max), range(ns, n_max)] = A[0, 0]
    return (
        operator_from_dense_factors(padded, symmetric=symmetric, dtype=dtype),
        sizes,
    )


def pad_ragged_rhs(b_factors, n_max: Optional[int] = None, dtype=jnp.float64):
    """Stack per-mode RHS vectors of different lengths into the (d, n_max)
    layout by zero-padding (the exactness condition of
    operator_from_ragged_factors)."""
    vecs = [np.asarray(v, np.float64).ravel() for v in b_factors]
    n_max = n_max or max(v.size for v in vecs)
    out = np.zeros((len(vecs), n_max))
    for s, v in enumerate(vecs):
        if v.size > n_max:
            raise ValueError(f"rhs factor {s} longer than n_max: {v.size} > {n_max}")
        out[s, : v.size] = v
    return jnp.asarray(out, dtype)
