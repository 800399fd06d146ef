"""Two-pass (basis-free) solve: densify-oracle equivalence with the standard
driver and true-residual assertions."""
import numpy as np
import jax.numpy as jnp
import pytest

import tensorkrylov as tk
from tensorkrylov.types import SolverConfig, Status


def _normalized_rhs(d, n, seed, identical=True):
    b = tk.random_rhs(d, n, seed=seed, identical=identical)
    return b / jnp.linalg.norm(b, axis=1, keepdims=True)


def test_two_pass_matches_standard_solve():
    op = tk.laplace(3, 30)
    b = _normalized_rhs(3, 30, 7)
    cfg = SolverConfig(kmax=30, tol=1e-8, orth="lanczos")
    r_std = tk.solve(op, b, cfg)
    r_tp = tk.solve_two_pass(op, b, cfg)
    assert int(r_tp.status) == Status.CONVERGED
    assert int(r_tp.niterations) == int(r_std.niterations)
    ni = int(r_tp.niterations)
    np.testing.assert_allclose(
        np.asarray(r_tp.relative_residual[ni]),
        np.asarray(r_std.relative_residual[ni]),
        rtol=1e-10,
    )
    # lifted solutions agree (the regenerated basis reproduces the stored one)
    x_std = np.asarray(r_std.x.factors)
    x_tp = np.asarray(r_tp.x.factors)
    np.testing.assert_allclose(x_tp, x_std, atol=1e-10)


def test_two_pass_true_residual():
    op = tk.laplace(3, 40)
    b = _normalized_rhs(3, 40, 3)
    res = tk.solve_two_pass(op, b, SolverConfig(kmax=40, tol=1e-8, orth="lanczos"))
    assert int(res.status) == Status.CONVERGED
    assert tk.kron_residual_dense(op, res.x, np.asarray(b)) < 1e-8


@pytest.mark.slow  # distinct factors covered fast by deflate/solver tests
def test_two_pass_distinct_factors():
    # distinct synthetic spectra per factor, moderate conditioning (plain
    # Lanczos — no reorthogonalization — must still converge)
    ev1 = np.linspace(1.0, 40.0, 24)
    ev2 = np.linspace(2.0, 55.0, 24)
    op = tk.eigval_matrix(np.stack([ev1, ev2]))
    b = _normalized_rhs(2, 24, 10, identical=False)
    cfg = SolverConfig(kmax=24, tol=1e-8, orth="lanczos")
    res = tk.solve_two_pass(op, b, cfg)
    assert int(res.status) == Status.CONVERGED
    assert tk.kron_residual_dense(op, res.x, np.asarray(b)) < 1e-8
    # trajectory equals the standard (basis-storing) driver's
    r_std = tk.solve(op, b, cfg)
    ni = int(res.niterations)
    assert ni == int(r_std.niterations)
    np.testing.assert_allclose(
        np.asarray(res.relative_residual[: ni + 1]),
        np.asarray(r_std.relative_residual[: ni + 1]),
        rtol=1e-9,
    )


def test_two_pass_check_every():
    op = tk.laplace(3, 30)
    b = _normalized_rhs(3, 30, 5)
    res = tk.solve_two_pass(
        op, b, SolverConfig(kmax=30, tol=1e-8, orth="lanczos", check_every=4)
    )
    assert int(res.status) == Status.CONVERGED
    assert tk.kron_residual_dense(op, res.x, np.asarray(b)) < 1e-8


def test_two_pass_rejects_bad_config():
    op = tk.laplace(2, 16)
    b = _normalized_rhs(2, 16, 1)
    with pytest.raises(ValueError):
        tk.solve_two_pass(op, b, SolverConfig(orth="lanczos_reorth"))
    nonsym = tk.conv_diff(2, 16)
    with pytest.raises(ValueError):
        tk.solve_two_pass(nonsym, b, SolverConfig(orth="lanczos"))
