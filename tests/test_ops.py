"""Unit tests for the compute kernels: banded SpMV, orthogonalization,
eigen estimation, exponential-sum solves. Densify-oracle pattern per
SURVEY.md §4."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.linalg

import tensorkrylov as tk
from tensorkrylov.models.gallery import bands_to_dense
from tensorkrylov.ops.banded import spmv
from tensorkrylov.ops.orth import (
    init_state,
    lanczos_step,
    arnoldi_step,
    orthogonality_loss,
)
from tensorkrylov.ops.eigen import (
    masked_eigh,
    sym_extremes_from_eigs,
    analytic_laplace_extremes,
    dense_minor_window,
    tridiag_eigvalsh_sturm,
)
from tensorkrylov.ops.expsum import cp_solve_sym, cp_solve_nonsym, expm_taylor_ss


# ---------------------------------------------------------------- banded SpMV


def test_spmv_vs_dense():
    op = tk.conv_diff(3, 29)
    dense = bands_to_dense(op)
    rng = np.random.default_rng(0)
    v = rng.standard_normal((3, 29))
    u = np.asarray(spmv(op, jnp.asarray(v)))
    oracle = np.einsum("dij,dj->di", dense, v)
    np.testing.assert_allclose(u, oracle, rtol=1e-13)


def test_spmv_block():
    op = tk.laplace(2, 21)
    dense = bands_to_dense(op)
    rng = np.random.default_rng(1)
    v = rng.standard_normal((2, 4, 21))  # 4 block vectors per factor
    u = np.asarray(spmv(op, jnp.asarray(v)))
    oracle = np.einsum("dij,dmj->dmi", dense, v)
    np.testing.assert_allclose(u, oracle, rtol=1e-13)


# ------------------------------------------------------------ orthogonalization


def _run_steps(op, b, kmax, stepper):
    state, _ = init_state(op, jnp.asarray(b), kmax, jnp.float64)
    for k in range(1, kmax + 1):
        state, _ = stepper(state, k)
    return state


@pytest.mark.parametrize("reorth", [False, True])
@pytest.mark.slow
def test_lanczos_orthonormal_and_projects(reorth):
    d, n, kmax = 2, 40, 15
    op = tk.laplace(d, n)
    dense = bands_to_dense(op)
    rng = np.random.default_rng(2)
    b = rng.standard_normal((d, n))
    state = _run_steps(
        op, b, kmax,
        lambda st, k: lanczos_step(op, st, jnp.asarray(b), k, reorth=reorth, proj_dtype=jnp.float64),
    )
    V = np.asarray(state.V).transpose(1, 0, 2)[:, : kmax + 1, :]
    for s in range(d):
        G = V[s] @ V[s].T
        np.testing.assert_allclose(G, np.eye(kmax + 1), atol=1e-8)
        # H equals the projection V^T A V on the active block
        Hproj = V[s, :kmax] @ dense[s] @ V[s, :kmax].T
        np.testing.assert_allclose(
            np.asarray(state.H)[s, :kmax, :kmax], Hproj, atol=1e-7
        )
    assert float(orthogonality_loss(state.V, kmax + 1)) < 1e-7


@pytest.mark.slow
def test_arnoldi_orthonormal_and_hessenberg():
    d, n, kmax = 2, 40, 15
    op = tk.conv_diff(d, n)
    dense = bands_to_dense(op)
    rng = np.random.default_rng(3)
    b = rng.standard_normal((d, n))
    state = _run_steps(
        op, b, kmax,
        lambda st, k: arnoldi_step(op, st, jnp.asarray(b), k, proj_dtype=jnp.float64),
    )
    V = np.asarray(state.V).transpose(1, 0, 2)[:, : kmax + 1, :]
    H = np.asarray(state.H)
    for s in range(d):
        np.testing.assert_allclose(V[s] @ V[s].T, np.eye(kmax + 1), atol=1e-10)
        Hproj = V[s, :kmax] @ dense[s] @ V[s, :kmax].T
        np.testing.assert_allclose(H[s, :kmax, :kmax], Hproj, atol=1e-8)
        # Hessenberg structure: zero below first subdiagonal
        low = np.tril(H[s, : kmax + 1, :kmax], -2)
        np.testing.assert_allclose(low, 0.0, atol=1e-10)


@pytest.mark.slow
def test_lanczos_btil_tracks_rhs():
    d, n, kmax = 2, 30, 10
    op = tk.laplace(d, n)
    rng = np.random.default_rng(4)
    b = rng.standard_normal((d, n))
    state = _run_steps(
        op, b, kmax,
        lambda st, k: lanczos_step(op, st, jnp.asarray(b), k, reorth=True, proj_dtype=jnp.float64),
    )
    V = np.asarray(state.V).transpose(1, 0, 2)
    btil = np.asarray(state.btil)
    for s in range(d):
        np.testing.assert_allclose(btil[s], V[s] @ b[s], atol=1e-10)


# ------------------------------------------------------------------ eigen


def test_masked_eigh_matches_minor():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((2, 12, 12))
    A = (A + A.transpose(0, 2, 1)) / 2
    k = 7
    w, Q = masked_eigh(jnp.asarray(A), k)
    for s in range(2):
        oracle = np.linalg.eigvalsh(A[s, :k, :k])
        ws = np.asarray(w[s])
        assert abs(ws.min() - oracle.min()) < 1e-10
        assert abs(ws.max() - oracle.max()) < 1e-10
        # function application exactness: exp(-M)b via padded eigh
        b = np.zeros(12)
        b[:k] = rng.standard_normal(k)
        f = np.asarray(Q[s]) @ (np.exp(-ws) * (np.asarray(Q[s]).T @ b))
        oracle_f = scipy.linalg.expm(-A[s, :k, :k]) @ b[:k]
        np.testing.assert_allclose(f[:k], oracle_f, atol=1e-10)
        np.testing.assert_allclose(f[k:], 0.0, atol=1e-12)


@pytest.mark.slow
def test_analytic_laplace_extremes():
    d, n = 3, 25
    op = tk.laplace(d, n)
    W = dense_minor_window(op, n)
    dense = np.asarray(bands_to_dense(op))
    for k in (1, 5, 24):
        lmin, lmax = analytic_laplace_extremes(d, n, jnp.asarray(float(k)))
        ev = np.linalg.eigvalsh(dense[0][:k, :k])
        np.testing.assert_allclose(float(lmin), d * ev.min(), rtol=1e-10)
        np.testing.assert_allclose(float(lmax), d * ev.max(), rtol=1e-10)


def test_sturm_bisection():
    rng = np.random.default_rng(6)
    d, K, k = 2, 16, 11
    diag = rng.standard_normal((d, K))
    off = rng.standard_normal((d, K))
    w = np.asarray(tridiag_eigvalsh_sturm(jnp.asarray(diag), jnp.asarray(off), k))
    for s in range(d):
        T = np.diag(diag[s, :k])
        for i in range(1, k):
            T[i, i - 1] = T[i - 1, i] = off[s, i]
        oracle = np.linalg.eigvalsh(T)
        np.testing.assert_allclose(np.sort(w[s])[:k], oracle, atol=1e-9)


# ------------------------------------------------------------------ expsum


def test_expm_taylor_ss_matches_scipy():
    rng = np.random.default_rng(7)
    A = rng.standard_normal((3, 9, 9)) * 3.0
    E = np.asarray(expm_taylor_ss(jnp.asarray(A)))
    for s in range(3):
        np.testing.assert_allclose(E[s], scipy.linalg.expm(A[s]), rtol=1e-11, atol=1e-11)


def test_cp_solve_sym_columns():
    """Each CP column j must equal exp(-(α_j/λ) H_s) b̃_s on the active block."""
    rng = np.random.default_rng(8)
    d, K, k, t, tmax = 2, 10, 6, 3, 5
    H = rng.standard_normal((d, K, K))
    H = (H + H.transpose(0, 2, 1)) / 2
    btil = rng.standard_normal((d, K))
    btil[:, k:] = 0
    omega = np.abs(rng.standard_normal(tmax)); omega[t:] = 0
    alpha = np.abs(rng.standard_normal(tmax)); alpha[t:] = 0
    mask = (np.arange(tmax) < t).astype(float)
    lam = jnp.asarray(2.5)
    w, Q = masked_eigh(jnp.asarray(H), k)
    weights, Y = cp_solve_sym(w, Q, jnp.asarray(btil), k, jnp.asarray(omega), jnp.asarray(alpha), jnp.asarray(mask), lam)
    np.testing.assert_allclose(np.asarray(weights), omega / 2.5 * mask)
    Y = np.asarray(Y)
    for s in range(d):
        for j in range(t):
            oracle = scipy.linalg.expm(-(alpha[j] / 2.5) * H[s, :k, :k]) @ btil[s, :k]
            np.testing.assert_allclose(Y[s, :k, j], oracle, atol=1e-10)
    np.testing.assert_allclose(Y[:, k:, :], 0.0, atol=1e-12)
    np.testing.assert_allclose(Y[:, :, t:], 0.0)


def test_cp_solve_nonsym_columns():
    rng = np.random.default_rng(9)
    d, K, k, t, tmax = 2, 8, 5, 3, 4
    H = rng.standard_normal((d, K, K))
    btil = rng.standard_normal((d, K)); btil[:, k:] = 0
    omega = np.abs(rng.standard_normal(tmax)); omega[t:] = 0
    alpha = np.abs(rng.standard_normal(tmax)) * 0.7; alpha[t:] = 0
    mask = (np.arange(tmax) < t).astype(float)
    lam = jnp.asarray(1.8)
    weights, Y = cp_solve_nonsym(jnp.asarray(H), jnp.asarray(btil), k, jnp.asarray(omega), jnp.asarray(alpha), jnp.asarray(mask), lam)
    Y = np.asarray(Y)
    for s in range(d):
        for j in range(t):
            oracle = scipy.linalg.expm(-(alpha[j] / 1.8) * H[s, :k, :k]) @ btil[s, :k]
            np.testing.assert_allclose(Y[s, :k, j], oracle, atol=1e-9)


@pytest.mark.slow
def test_standalone_algorithm_drivers():
    """Single-matrix batch drivers (reference test/decompositions.jl:4-19
    pattern: long single-factor recurrences stay orthonormal)."""
    from tensorkrylov.ops.orth import lanczos_algorithm, arnoldi_algorithm

    n, k = 300, 120
    op = tk.laplace(1, n)
    rng = np.random.default_rng(10)
    b = rng.standard_normal(n)
    st = lanczos_algorithm(op, b, k, reorth=True)
    assert float(orthogonality_loss(st.V, k + 1)) < 1e-8
    # Jacobi matrix is SPD (reference asserts isposdef(H))
    H = np.asarray(st.H)[0, :k, :k]
    assert np.all(np.linalg.eigvalsh((H + H.T) / 2) > 0)

    op2 = tk.conv_diff(1, n)
    st2 = arnoldi_algorithm(op2, b, k)
    assert float(orthogonality_loss(st2.V, k + 1)) < 1e-8


def test_laplace_eigenvectors_analytic():
    from tensorkrylov.ops.eigen import laplace_eigenvector, laplace_eigenspace

    n = 20
    op = tk.laplace(1, n)
    A = np.asarray(bands_to_dense(op))[0]
    w, Q = np.linalg.eigh(A)
    V = np.asarray(laplace_eigenspace(n))
    # columns diagonalize A
    D = V.T @ A @ V
    np.testing.assert_allclose(D - np.diag(np.diag(D)), 0.0, atol=1e-6)
    v3 = np.asarray(laplace_eigenvector(n, 3))
    resid = A @ v3 - (np.sort(np.diag(D))[2]) * v3
    assert np.linalg.norm(resid) < 1e-6


@pytest.mark.slow
def test_nonsym_eig_matches_expm_projected_solve():
    """cp_solve_nonsym_eig (one complex eig + diagonal scalings) must match
    the expm-chain path on the oracle problem to near-f64."""
    import tensorkrylov as tk
    from tensorkrylov.types import SolverConfig

    op = tk.conv_diff(3, 24)
    b = tk.random_rhs(3, 24, seed=5)
    outs = {}
    for impl in ("expm", "eig"):
        cfg = SolverConfig(kmax=20, tol=1e-7, orth="arnoldi", tmax=121,
                           nonsym_solve_impl=impl)
        r = tk.solve(op, b, cfg)
        ni = int(r.niterations)
        outs[impl] = (ni, float(np.asarray(r.relative_residual)[ni]),
                      np.asarray(r.x.factors))
    assert outs["expm"][0] == outs["eig"][0]
    np.testing.assert_allclose(outs["expm"][1], outs["eig"][1], rtol=1e-5)
    np.testing.assert_allclose(outs["expm"][2], outs["eig"][2], atol=1e-9, rtol=1e-5)
