"""Ragged (per-mode) factor sizes — the reference's factor list admits
arbitrary n_s per mode (/root/reference/src/tensor_struct.jl:168-231);
the stacked layout supports them exactly via pad-to-max
(models/gallery.py:operator_from_ragged_factors). Densify-oracle tests."""
import numpy as np
import pytest
import jax.numpy as jnp

import tensorkrylov as tk


def _lap(n, shift=0.0):
    h = 1.0 / (n + 1)
    A = (np.diag(np.full(n, 2.0)) + np.diag(np.full(n - 1, -1.0), 1)
         + np.diag(np.full(n - 1, -1.0), -1)) / h**2
    return A + shift * np.eye(n)


def _ragged_dense_solve(mats, b_factors):
    """True ragged Kronecker-sum solve by full materialization."""
    d = len(mats)
    sizes = [A.shape[0] for A in mats]
    N = int(np.prod(sizes))
    A_full = np.zeros((N, N))
    for s in range(d):
        term = np.array([[1.0]])
        for r in range(d):
            term = np.kron(term, mats[r] if r == s else np.eye(sizes[r]))
        A_full += term
    b_full = np.array([1.0])
    for v in b_factors:
        b_full = np.kron(b_full, v)
    return np.linalg.solve(A_full, b_full), b_full, A_full


def test_ragged_solve_matches_dense_oracle():
    rng = np.random.default_rng(7)
    sizes = (8, 12, 10)
    mats = [_lap(n, shift=1.0) for n in sizes]
    b_fac = [rng.standard_normal(n) for n in sizes]

    op, got_sizes = tk.operator_from_ragged_factors(mats, symmetric=True)
    assert got_sizes == sizes and op.n == 12
    b = tk.pad_ragged_rhs(b_fac)

    res = tk.solve(op, b, tk.SolverConfig(kmax=12, tol=1e-10))
    x_exact, b_full, _ = _ragged_dense_solve(mats, b_fac)

    # padded CP solution: pad rows are dead to roundoff (exact zeros except
    # for denormal-scale lucky-restart noise; the pad block is inert so any
    # such component decays with the residual)
    xf = np.asarray(res.x.factors)
    for s, ns in enumerate(sizes):
        if ns < xf.shape[1]:
            assert np.abs(xf[s, ns:, :]).max() < 1e-14
    # restrict to the true prefixes and compare against the ragged oracle
    x_cp = np.zeros_like(x_exact)
    w = np.asarray(res.x.weights)
    for j in range(w.size):
        t = np.array([1.0])
        for s, ns in enumerate(sizes):
            t = np.kron(t, xf[s, :ns, j])
        x_cp += w[j] * t
    rel = np.linalg.norm(x_cp - x_exact) / np.linalg.norm(x_exact)
    assert rel < 1e-7, rel


def test_ragged_pad_preserves_spectrum_extremes():
    sizes = (6, 9)
    mats = [_lap(n, shift=2.0) for n in sizes]
    op, _ = tk.operator_from_ragged_factors(mats, symmetric=True)
    from tensorkrylov.models.gallery import bands_to_dense

    padded = bands_to_dense(op)
    for s, A in enumerate(mats):
        w_true = np.linalg.eigvalsh(A)
        w_pad = np.linalg.eigvalsh(padded[s])
        assert np.isclose(w_pad.min(), w_true.min())
        assert np.isclose(w_pad.max(), w_true.max())


def test_ragged_deflated_solve():
    """Deflation on a ragged operator: U columns of the pad block are pad
    eigenvectors, but b-perp is zero there so they are inert."""
    rng = np.random.default_rng(3)
    sizes = (20, 14)
    mats = [_lap(n, shift=30.0) for n in sizes]
    b_fac = [rng.standard_normal(n) for n in sizes]
    op, _ = tk.operator_from_ragged_factors(mats, symmetric=True)
    b = tk.pad_ragged_rhs(b_fac)
    res = tk.solve_deflated(op, b, tk.SolverConfig(kmax=14, tol=1e-9), m=4)
    x_exact, b_full, _ = _ragged_dense_solve(mats, b_fac)
    xf = np.asarray(res.x.factors)
    w = np.asarray(res.x.weights)
    x_cp = np.zeros_like(x_exact)
    for j in range(w.size):
        t = np.array([1.0])
        for s, ns in enumerate(sizes):
            t = np.kron(t, xf[s, :ns, j])
        x_cp += w[j] * t
    rel = np.linalg.norm(x_cp - x_exact) / np.linalg.norm(x_exact)
    assert rel < 1e-6, rel


def test_equal_size_constructors_reject_ragged():
    mats = [_lap(4), _lap(6)]
    with pytest.raises(ValueError, match="ragged"):
        tk.operator_from_dense_factors(mats, symmetric=True)
    import scipy.sparse as sp

    from tensorkrylov.models.gallery import operator_from_scipy
    with pytest.raises(ValueError, match="ragged"):
        operator_from_scipy([sp.csr_matrix(m) for m in mats], symmetric=True)
