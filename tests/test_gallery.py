"""Gallery assembly vs explicit dense constructions.

Mirrors the reference's matrix definitions
(/root/reference/src/tensor_struct.jl:48-79) as independent numpy oracles.
"""
import numpy as np
import jax.numpy as jnp
import pytest

import tensorkrylov as tk
from tensorkrylov.models.gallery import bands_to_dense, dense_to_bands


def dense_laplace(n):
    h2 = (n + 1) ** 2
    A = np.zeros((n, n))
    np.fill_diagonal(A, 2.0 * h2)
    idx = np.arange(n - 1)
    A[idx, idx + 1] = -h2
    A[idx + 1, idx] = -h2
    return A


def dense_conv_diff(n, c=10.0):
    h = 1.0 / (n + 1)
    A = dense_laplace(n)
    cv = c / (4 * h)
    idx = np.arange(n)
    A[idx[:-1] + 1, idx[:-1]] += cv * 1.0
    A[idx, idx] += cv * 3.0
    A[idx[:-1], idx[:-1] + 1] += cv * -5.0
    A[idx[:-2], idx[:-2] + 2] += cv * 1.0
    return A


def test_laplace_bands():
    op = tk.laplace(3, 17)
    dense = bands_to_dense(op)
    oracle = dense_laplace(17)
    for s in range(3):
        np.testing.assert_allclose(dense[s], oracle, rtol=1e-14)
    assert op.symmetric
    assert op.nnz_per_factor == 3 * 17 - 2


def test_conv_diff_bands():
    op = tk.conv_diff(2, 13, c=7.5)
    dense = bands_to_dense(op)
    oracle = dense_conv_diff(13, c=7.5)
    np.testing.assert_allclose(dense[0], oracle, rtol=1e-14)
    assert not op.symmetric


def test_eigval_matrix():
    ev = np.linspace(1, 9, 9)
    op = tk.eigval_matrix(ev, d=4)
    dense = bands_to_dense(op)
    np.testing.assert_allclose(dense[2], np.diag(ev))


def test_rand_spd_is_spd():
    op = tk.rand_spd(2, 12, seed=3)
    dense = bands_to_dense(op)
    for s in range(2):
        np.testing.assert_allclose(dense[s], dense[s].T, rtol=1e-13)
        assert np.all(np.linalg.eigvalsh(dense[s]) > 0)
    # distinct factors (generalizes the reference's replicated draw)
    assert not np.allclose(dense[0], dense[1])


def test_dense_to_bands_roundtrip(rng):
    A = rng.standard_normal((2, 10, 10))
    A[:, np.abs(np.subtract.outer(np.arange(10), np.arange(10))) > 3] = 0.0
    bands, offsets = dense_to_bands(A)
    op = tk.KroneckerSumOperator(jnp.asarray(bands), offsets, symmetric=False)
    np.testing.assert_allclose(bands_to_dense(op), A, rtol=1e-15)


def test_operator_from_scipy():
    import scipy.sparse as sp
    from tensorkrylov.models.gallery import operator_from_scipy

    rng = np.random.default_rng(11)
    n = 15
    dense = rng.standard_normal((2, n, n))
    dense[:, np.abs(np.subtract.outer(np.arange(n), np.arange(n))) > 2] = 0.0
    op = operator_from_scipy([sp.csr_matrix(dense[s]) for s in range(2)], symmetric=False)
    np.testing.assert_allclose(bands_to_dense(op), dense, rtol=1e-14)
