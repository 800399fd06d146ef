"""Restarted CP-refinement solve + the CP algebra it builds on, vs dense
Kronecker oracles."""
import numpy as np
import jax.numpy as jnp
import pytest

import tensorkrylov as tk
from tensorkrylov.types import CPTensor, SolverConfig, Status
from tensorkrylov.utils.cp import cp_full, cp_round, kron_apply_cp, kron_matvec_dense


def _normalized_rhs(d, n, seed, identical=True):
    b = tk.random_rhs(d, n, seed=seed, identical=identical)
    return b / jnp.linalg.norm(b, axis=1, keepdims=True)


def test_kron_apply_cp_oracle():
    rng = np.random.default_rng(0)
    d, n, t = 3, 10, 4
    op = tk.laplace(d, n)
    x = CPTensor(jnp.asarray(rng.standard_normal(t)), jnp.asarray(rng.standard_normal((d, n, t))))
    ax = kron_apply_cp(op, x)
    assert ax.rank == d * t
    ref = kron_matvec_dense(op, cp_full(x))
    np.testing.assert_allclose(cp_full(ax), ref, rtol=1e-12, atol=1e-9 * np.abs(ref).max())


def test_cp_round_exact_rank_recovery():
    rng = np.random.default_rng(1)
    d, n = 3, 12
    F = rng.standard_normal((d, n, 3))
    w = np.array([3.0, 2.0, 1.0])
    exact = CPTensor(jnp.asarray(w), jnp.asarray(F))
    padded = CPTensor(
        jnp.asarray(np.r_[w, 1e-13 * np.ones(3)]),
        jnp.asarray(np.concatenate([F, rng.standard_normal((d, n, 3))], axis=2)),
    )
    y = cp_round(padded, 3, iters=20)
    err = np.linalg.norm(cp_full(y) - cp_full(exact)) / np.linalg.norm(cp_full(exact))
    assert err < 1e-8  # floor set by the default ridge regularization


@pytest.mark.slow
def test_cp_residual_matches_dense():
    op = tk.laplace(3, 20)
    b = _normalized_rhs(3, 20, 2)
    res = tk.solve(op, b, SolverConfig(kmax=10, tol=1e-30))
    r_cp = tk.cp_residual(op, res.x, b)
    rel = float(tk.cp_norm(r_cp)) / 1.0  # b normalized per factor → ‖b‖ = 1
    dense = tk.kron_residual_dense(op, res.x, np.asarray(b))
    np.testing.assert_allclose(rel, dense, rtol=1e-6)


@pytest.mark.slow
def test_refined_beats_single_shot_at_same_kmax():
    """With kmax too small for one-shot convergence, restarts must reach the
    target anyway — bounded-memory capability."""
    op = tk.laplace(3, 32)
    b = _normalized_rhs(3, 32, 3)
    cfg = SolverConfig(kmax=10, tol=1e-5)
    one_shot = tk.solve(op, b, cfg)
    assert int(one_shot.status) != Status.CONVERGED  # genuinely hard at kmax=10
    ref = tk.solve_refined(op, b, cfg, max_restarts=5, residual_rank=4, inner_tol=1e-4)
    assert ref.converged, ref.residual_history
    assert ref.true_relative_residual < 1e-5
    assert tk.kron_residual_dense(op, ref.x, np.asarray(b)) < 1e-5
    # residual history decreases across cycles
    h = ref.residual_history
    assert h[-1] < h[0] * 1e-3


@pytest.mark.slow
def test_refined_solution_rank_bound():
    """Rounding the accumulated solution bounds its CP rank; attainable tol
    is limited by ‖A‖ × the rank-fit error (see refine.py docstring)."""
    op = tk.laplace(3, 32)
    b = _normalized_rhs(3, 32, 4)
    cfg = SolverConfig(kmax=12, tol=1e-3)
    ref = tk.solve_refined(
        op, b, cfg, max_restarts=4, residual_rank=4, solution_rank=24, inner_tol=1e-3
    )
    assert ref.converged, ref.residual_history
    assert ref.x.rank <= 24
    assert tk.kron_residual_dense(op, ref.x, np.asarray(b)) < 1e-3
