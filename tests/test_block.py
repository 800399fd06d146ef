"""Block / global tensorized Krylov (rank-R RHS, shared subspace) — a
capability beyond the reference (its multiple_rhs is a list of separate
systems, /root/reference/src/system.jl:13). Densify-oracle pattern."""
import numpy as np
import jax.numpy as jnp
import pytest

import tensorkrylov as tk
from tensorkrylov.types import SolverConfig, Status
from tensorkrylov.models.gallery import bands_to_dense
from tensorkrylov.utils.cp import cp_full


def _dense_system(op, B):
    d, n = op.d, op.n
    A1 = np.asarray(bands_to_dense(op))
    Afull = 0
    for s in range(d):
        terms = [np.eye(n)] * d
        terms[s] = A1[s]
        M = terms[0]
        for t in terms[1:]:
            M = np.kron(M, t)
        Afull = Afull + M
    bfull = 0
    for r in range(B.shape[0]):
        v = B[r, 0]
        for s in range(1, d):
            v = np.kron(v, B[r, s])
        bfull = bfull + v
    return Afull, bfull


def _true_rel(op, B, res):
    Afull, bfull = _dense_system(op, np.asarray(B))
    x = cp_full(res.x)
    return np.linalg.norm(Afull @ x - bfull) / np.linalg.norm(bfull)


def _rand_block(R, d, n, seed):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((R, d, n))
    return B / np.linalg.norm(B, axis=2, keepdims=True)


@pytest.mark.slow
def test_block_spd_oracle():
    op = tk.laplace(2, 30)
    B = _rand_block(3, 2, 30, 5)
    res = tk.solve_block(op, B, SolverConfig(kmax=18, tol=1e-9, check_every=1))
    assert int(res.status) == Status.CONVERGED
    assert _true_rel(op, B, res) < 1e-8
    # certified estimate bounds the truth (within slack)
    est = float(res.relative_residual[int(res.niterations)])
    assert est >= _true_rel(op, B, res) * 0.5


def test_block_nonsym_oracle():
    op = tk.conv_diff(2, 24)
    B = _rand_block(2, 2, 24, 6)
    res = tk.solve_block(
        op, B, SolverConfig(kmax=12, tol=1e-6, orth="arnoldi", tmax=151, check_every=1)
    )
    assert int(res.status) == Status.CONVERGED
    assert _true_rel(op, B, res) < 1e-6


def test_block_deflation_duplicate_rhs():
    """Linearly dependent block columns deflate (fresh orthogonal directions
    are substituted); the solve stays exact."""
    op = tk.laplace(2, 24)
    rng = np.random.default_rng(7)
    b1 = rng.standard_normal((2, 24))
    b1 /= np.linalg.norm(b1, axis=1, keepdims=True)
    B = np.stack([b1, b1])
    res = tk.solve_block(op, B, SolverConfig(kmax=12, tol=1e-9, check_every=1))
    assert int(res.status) == Status.CONVERGED
    assert _true_rel(op, B, res) < 1e-8


@__import__("pytest").mark.slow
def test_block_r1_matches_scalar_arnoldi():
    """R = 1 block solve is scalar CGS2 Arnoldi — traces must agree."""
    op = tk.laplace(2, 20)
    B = _rand_block(1, 2, 20, 8)
    cfg = SolverConfig(kmax=20, tol=1e-9, orth="arnoldi", check_every=1)
    r_blk = tk.solve_block(op, B, cfg)
    r_sca = tk.solve(op, jnp.asarray(B[0]), cfg)
    ni = int(r_sca.niterations)
    assert int(r_blk.niterations) == ni
    np.testing.assert_allclose(
        np.asarray(r_blk.relative_residual)[1 : ni + 1],
        np.asarray(r_sca.relative_residual)[1 : ni + 1],
        rtol=1e-8,
    )


@pytest.mark.slow  # 1.6 s edge case; core block coverage stays fast
def test_block_kmax_clamped_to_space():
    """kmax·R is clamped to the factor dimension n — no junk iterations."""
    op = tk.laplace(2, 20)
    B = _rand_block(3, 2, 20, 9)
    res = tk.solve_block(op, B, SolverConfig(kmax=50, tol=1e-12, check_every=1))
    assert int(res.niterations) <= 20 // 3
    rr = np.asarray(res.relative_residual)[1 : int(res.niterations) + 1]
    assert np.all(np.isfinite(rr))


@pytest.mark.slow
def test_block_shares_subspace_fewer_matvecs():
    """The shared subspace converges in no more block iterations than the
    worst independent solve needs scalar iterations (same per-factor matvec
    count per iteration unit: R matvecs/block step vs 1/scalar step ×R
    solves)."""
    op = tk.laplace(2, 30)
    B = _rand_block(2, 2, 30, 10)
    cfg = SolverConfig(kmax=30, tol=1e-8, check_every=1)
    r_blk = tk.solve_block(op, B, cfg)
    _, r_ind = tk.solve_multi_rhs(op, jnp.asarray(B), cfg)
    worst = int(np.max(np.asarray(r_ind.niterations)))
    # block step k spans ⊇ the union of the individual degree-k spaces,
    # so certified convergence shouldn't take (materially) more block steps
    # than the worst individual solve takes scalar steps
    assert int(r_blk.niterations) <= worst + 1
