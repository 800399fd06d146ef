"""End-to-end solver tests with asserted true residuals (the reference's e2e
test asserts nothing, /root/reference/test/tensor_krylov_method.jl:31-45)."""
import numpy as np
import jax.numpy as jnp
import pytest

import tensorkrylov as tk
from tensorkrylov.types import SolverConfig, Status


def _normalized_rhs(d, n, seed, identical=True):
    b = tk.random_rhs(d, n, seed=seed, identical=identical)
    return b / jnp.linalg.norm(b, axis=1, keepdims=True)


def test_spd_laplace_e2e():
    op = tk.laplace(3, 30)
    b = _normalized_rhs(3, 30, 7)
    res = tk.solve(op, b, SolverConfig(kmax=30, tol=1e-8))
    assert int(res.status) == Status.CONVERGED
    true_r = tk.kron_residual_dense(op, res.x, np.asarray(b))
    assert true_r < 1e-8
    # estimate is an upper bound on the truth (within slack)
    est = float(res.relative_residual[int(res.niterations)])
    assert est >= true_r * 0.5
    # monotone-ish decrease over the tail
    rr = np.asarray(res.relative_residual)[3 : int(res.niterations) + 1]
    assert rr[-1] < rr[0]


@pytest.mark.slow
def test_nonsym_convdiff_e2e():
    op = tk.conv_diff(3, 30)
    b = _normalized_rhs(3, 30, 8)
    res = tk.solve(op, b, SolverConfig(kmax=30, tol=1e-6, orth="arnoldi", tmax=151))
    true_r = tk.kron_residual_dense(op, res.x, np.asarray(b))
    assert true_r < 1e-6, true_r


def test_eigval_gallery_e2e():
    ev = np.linspace(1.0, 50.0, 30)
    op = tk.eigval_matrix(ev, d=3)
    b = _normalized_rhs(3, 30, 9)
    res = tk.solve(op, b, SolverConfig(kmax=30, tol=1e-8))
    assert int(res.status) == Status.CONVERGED
    assert tk.kron_residual_dense(op, res.x, np.asarray(b)) < 1e-8


def test_distinct_factors_and_rhs():
    """Generalization beyond the reference's identical-factor assumption."""
    op = tk.rand_spd(2, 24, seed=4)
    b = _normalized_rhs(2, 24, 10, identical=False)
    res = tk.solve(op, b, SolverConfig(kmax=24, tol=1e-8))
    assert int(res.status) == Status.CONVERGED
    assert tk.kron_residual_dense(op, res.x, np.asarray(b)) < 1e-8


@pytest.mark.parametrize("source", [
    "H",
    pytest.param("A_minor", marks=pytest.mark.slow),  # same consistency path
    "analytic_laplace",
])
def test_spectral_sources_consistent(source):
    op = tk.laplace(3, 25)
    b = _normalized_rhs(3, 25, 11)
    res = tk.solve(op, b, SolverConfig(kmax=25, tol=1e-7, spectral_source=source))
    assert tk.kron_residual_dense(op, res.x, np.asarray(b)) < 1e-7, source


def test_identical_factors_guard_rejects_distinct_rhs():
    """identical_factors=True with per-factor-distinct b silently stalled
    before the guard (the fast path broadcasts factor 0's projected
    eigendecomposition, which depends on b_s): must raise, not stall."""
    op = tk.laplace(3, 25)
    b = _normalized_rhs(3, 25, 12, identical=False)
    with pytest.raises(ValueError, match="identical_factors"):
        tk.solve(op, b, SolverConfig(kmax=25, tol=1e-7, identical_factors=True))
    B = jnp.stack([b, b])  # rank-2 RHS, distinct rows inside each term
    with pytest.raises(ValueError, match="identical_factors"):
        tk.solve_block(op, B, SolverConfig(kmax=8, identical_factors=True))


def test_identical_factors_fast_path():
    op = tk.laplace(3, 25)
    b = _normalized_rhs(3, 25, 12)
    r1 = tk.solve(op, b, SolverConfig(kmax=25, tol=1e-7))
    r2 = tk.solve(op, b, SolverConfig(kmax=25, tol=1e-7, identical_factors=True))
    ni = int(r1.niterations)
    assert int(r2.niterations) == ni
    np.testing.assert_allclose(
        np.asarray(r1.relative_residual[ni]), np.asarray(r2.relative_residual[ni]), rtol=1e-6
    )


def test_plain_lanczos_variant():
    op = tk.laplace(3, 25)
    b = _normalized_rhs(3, 25, 13)
    res = tk.solve(op, b, SolverConfig(kmax=25, tol=1e-7, orth="lanczos"))
    assert tk.kron_residual_dense(op, res.x, np.asarray(b)) < 1e-7


def test_reference_selection_modes():
    """Reference-parity selection semantics still converge (to its floor)."""
    op = tk.laplace(3, 30)
    b = _normalized_rhs(3, 30, 14)
    res = tk.solve(
        op, b,
        SolverConfig(kmax=30, tol=1e-6, coeff_tol_scale="reference", bh_row_select="reference"),
    )
    assert tk.kron_residual_dense(op, res.x, np.asarray(b)) < 1e-4


def test_solution_shape_and_lift():
    op = tk.laplace(2, 20)
    b = _normalized_rhs(2, 20, 15)
    res = tk.solve(op, b, SolverConfig(kmax=20, tol=1e-8))
    x = res.x
    # lifted factors live in R^n: (d, n, tmax)
    assert x.factors.shape[0] == 2 and x.factors.shape[1] == op.n
    assert x.weights.shape[0] == x.factors.shape[2]


def test_input_validation():
    op = tk.laplace(3, 30)
    with pytest.raises(ValueError):
        tk.solve(op, jnp.ones((4, 30)))
    with pytest.raises(ValueError):
        tk.solve(tk.conv_diff(2, 10), jnp.ones((2, 10)))  # nonsym needs arnoldi


@pytest.mark.slow
def test_multi_rhs_rank2():
    """Rank-2 tensor-product RHS via batched solves (capability beyond the
    reference)."""
    import tensorkrylov as tk
    from tensorkrylov.solver import solve_multi_rhs
    from tensorkrylov.utils.cp import cp_full, kron_matvec_dense

    d, n, R = 3, 20, 2
    op = tk.laplace(d, n)
    rng = np.random.default_rng(21)
    B = rng.standard_normal((R, d, n))
    x, res = solve_multi_rhs(op, B, SolverConfig(kmax=20, tol=1e-8))
    assert res.status.shape == (R,)
    # dense oracle: residual of the combined solution against the summed RHS
    bfull = 0.0
    for r in range(R):
        acc = np.array([1.0])
        for s in range(d):
            acc = np.kron(acc, B[r, s])
        bfull = bfull + acc
    xfull = cp_full(x)
    rnorm = np.linalg.norm(kron_matvec_dense(op, xfull) - bfull) / np.linalg.norm(bfull)
    assert rnorm < 1e-7, rnorm

    # MultiRhsResult aggregate view: all lanes CONVERGED → aggregate
    # CONVERGED; still unpacks like the old (x, results) tuple
    mr = solve_multi_rhs(op, B, SolverConfig(kmax=20, tol=1e-8))
    assert int(mr.status) == int(Status.CONVERGED)
    assert bool(mr.converged)
    x2, res2 = mr
    assert res2.status.shape == (R,)
    # a lane that cannot converge (kmax too small) degrades the aggregate
    mr_bad = solve_multi_rhs(op, B, SolverConfig(kmax=4, tol=1e-12))
    assert int(mr_bad.status) == int(Status.MAXITER)


@pytest.mark.slow
def test_resumable_matches_and_resumes(tmp_path):
    """Segmented+checkpointed solve must match the single-shot solve exactly,
    and resuming from disk must continue bit-for-bit."""
    from tensorkrylov.solver import solve_resumable

    op = tk.laplace(3, 30)
    b = _normalized_rhs(3, 30, 17)
    cfg = SolverConfig(kmax=30, tol=1e-8)
    ref = tk.solve(op, b, cfg)
    ckpt = str(tmp_path / "carry.npz")

    seg = solve_resumable(op, b, cfg, chunk=7, checkpoint_path=ckpt)
    ni = int(ref.niterations)
    assert int(seg.niterations) == ni
    np.testing.assert_array_equal(
        np.asarray(seg.relative_residual), np.asarray(ref.relative_residual)
    )

    # simulate a crash mid-solve: run 2 chunks only, then resume from disk
    from tensorkrylov.solver import _init_carry_jit, _segment_jit, _finalize_jit
    from tensorkrylov.coeffs.tables import load_tables
    import jax.numpy as jnp
    tables = load_tables()
    carry = _init_carry_jit(op, b, tables, cfg)
    carry = _segment_jit(op, b, tables, cfg, carry, jnp.asarray(14, jnp.int32))
    from tensorkrylov.utils.checkpoint import save_carry
    save_carry(ckpt, carry)
    resumed = solve_resumable(op, b, cfg, checkpoint_path=ckpt, resume=True, chunk=9)
    assert int(resumed.niterations) == ni
    np.testing.assert_array_equal(
        np.asarray(resumed.relative_residual), np.asarray(ref.relative_residual)
    )


def test_check_every_cadence():
    """Sparse residual checking reaches the same converged answer."""
    op = tk.laplace(3, 30)
    b = _normalized_rhs(3, 30, 18)
    r1 = tk.solve(op, b, SolverConfig(kmax=30, tol=1e-8, check_every=1))
    r5 = tk.solve(op, b, SolverConfig(kmax=30, tol=1e-8, check_every=5))
    assert int(r5.status) == int(r1.status) == Status.CONVERGED
    assert tk.kron_residual_dense(op, r5.x, np.asarray(b)) < 1e-8
    # checked iterations agree where both evaluated
    rr1 = np.asarray(r1.relative_residual)
    rr5 = np.asarray(r5.relative_residual)
    for k in range(5, int(r5.niterations) + 1, 5):
        if np.isfinite(rr5[k]):
            np.testing.assert_allclose(rr5[k], rr1[k], rtol=1e-9)


def test_single_mode_d1():
    """d=1 degenerates to ordinary CG-like Lanczos solve — must still work."""
    op = tk.laplace(1, 40)
    b = _normalized_rhs(1, 40, 19)
    res = tk.solve(op, b, SolverConfig(kmax=40, tol=1e-8))
    assert int(res.status) == Status.CONVERGED
    assert tk.kron_residual_dense(op, res.x, np.asarray(b)) < 1e-8


@pytest.mark.slow
def test_host_projected_matches_device():
    """Hybrid host-projected mode must match the all-device solve."""
    from tensorkrylov.solver import solve_host_projected

    op = tk.laplace(3, 30)
    b = _normalized_rhs(3, 30, 20)
    cfg = SolverConfig(kmax=30, tol=1e-8, check_every=5)
    r_dev = tk.solve(op, b, cfg)
    r_host = solve_host_projected(op, b, cfg)
    assert int(r_host.status) == int(r_dev.status)
    assert int(r_host.niterations) == int(r_dev.niterations)
    ni = int(r_dev.niterations)
    rr_d = np.asarray(r_dev.relative_residual)
    rr_h = np.asarray(r_host.relative_residual)
    mask = np.isfinite(rr_h[: ni + 1])
    np.testing.assert_allclose(rr_h[: ni + 1][mask], rr_d[: ni + 1][mask], rtol=1e-9)
    assert tk.kron_residual_dense(op, r_host.x, np.asarray(b)) < 1e-8


def test_tridiag_mixed_eigh_solve_matches_dense():
    """Forcing the mixed tridiagonal eigensolver gives the same solve."""
    op = tk.laplace(3, 30)
    b = _normalized_rhs(3, 30, 22)
    r_dense = tk.solve(op, b, SolverConfig(kmax=30, tol=1e-8, eigh_impl="dense"))
    r_mixed = tk.solve(op, b, SolverConfig(kmax=30, tol=1e-8, eigh_impl="tridiag_mixed"))
    assert int(r_mixed.status) == int(r_dense.status)
    ni = int(r_dense.niterations)
    assert int(r_mixed.niterations) == ni
    np.testing.assert_allclose(
        np.asarray(r_mixed.relative_residual[1 : ni + 1]),
        np.asarray(r_dense.relative_residual[1 : ni + 1]),
        rtol=1e-7,
    )
    assert tk.kron_residual_dense(op, r_mixed.x, np.asarray(b)) < 1e-8


def test_lucky_breakdown_restart():
    """RHS aligned with an eigenvector triggers lucky breakdown; the restart
    (fresh orthogonal direction) must keep the solve exact — the reference's
    zero-vector handling poisons its spectral estimates here."""
    from tensorkrylov.solver import solve_multi_rhs
    from tensorkrylov.utils.cp import cp_full, kron_matvec_dense
    from tensorkrylov.types import CPTensor

    d, n = 2, 24
    op = tk.eigval_matrix(np.linspace(1.0, 30.0, n), d=d)
    b = np.zeros((d, n))
    b[:, 0] = 1.0  # exact eigenvector of each factor
    res = tk.solve(op, jnp.asarray(b), SolverConfig(kmax=24, tol=1e-8, check_every=2))
    assert int(res.status) == Status.CONVERGED
    assert int(res.niterations) <= 4
    bfull = np.array([1.0])
    for s in range(d):
        bfull = np.kron(bfull, b[s])
    rn = np.linalg.norm(
        kron_matvec_dense(op, cp_full(res.x)) - bfull
    ) / np.linalg.norm(bfull)
    assert rn < 1e-8


def test_cp_compress():
    from tensorkrylov.utils.cp import cp_compress, cp_full

    op = tk.laplace(2, 20)
    b = _normalized_rhs(2, 20, 23)
    res = tk.solve(op, b, SolverConfig(kmax=20, tol=1e-8))
    xc = cp_compress(res.x)
    assert xc.rank < res.x.rank  # padded zero-weight columns dropped
    np.testing.assert_allclose(cp_full(xc), cp_full(res.x), rtol=1e-12, atol=1e-12)



@pytest.mark.slow
def test_monotone_Anorm_error():
    """Galerkin property: the A-norm error is non-increasing in the subspace
    size (the reference intended but never ran this check,
    /root/reference/test/test_utils.jl:192-247)."""
    from tensorkrylov.utils.cp import cp_full, kron_matvec_dense
    from tensorkrylov.models.gallery import bands_to_dense

    d, n = 2, 12
    op = tk.laplace(d, n)
    b = _normalized_rhs(d, n, 25)
    # dense exact solution
    A1 = np.asarray(bands_to_dense(op))
    Afull = np.kron(A1[0], np.eye(n)) + np.kron(np.eye(n), A1[1])
    bfull = np.kron(np.asarray(b)[0], np.asarray(b)[1])
    xstar = np.linalg.solve(Afull, bfull)

    errs = []
    for kmax in (2, 4, 6, 8, 10):
        res = tk.solve(op, b, SolverConfig(kmax=kmax, tol=1e-14, tmax=201))
        e = cp_full(res.x) - xstar
        errs.append(float(np.sqrt(e @ (Afull @ e))))
    for a, bb in zip(errs, errs[1:]):
        assert bb <= a * (1 + 1e-6), errs


@pytest.mark.slow
def test_host_projected_nonsym_exact_lmin():
    """Nonsym host-projected mode uses exact host eigenvalues for λ_min —
    the chosen Stenger rank must not exceed the device (Bendixson-bound)
    rank, and the solve still certifies the true residual."""
    from tensorkrylov.solver import solve_host_projected

    op = tk.conv_diff(3, 30)
    b = _normalized_rhs(3, 30, 26)
    cfg = SolverConfig(kmax=30, tol=1e-6, orth="arnoldi", tmax=151, check_every=5)
    r_dev = tk.solve(op, b, cfg)
    r_host = solve_host_projected(op, b, cfg)
    assert tk.kron_residual_dense(op, r_host.x, np.asarray(b)) < 1e-6
    ni_h = int(r_host.niterations)
    ni_d = int(r_dev.niterations)
    # exact λ_min ≥ Bendixson bound → same-or-smaller exp-sum rank at the
    # common checked iteration, and convergence at least as early
    assert ni_h <= ni_d
    k_common = min(ni_h, ni_d)
    t_h = int(np.asarray(r_host.expsum_rank)[k_common])
    t_d = int(np.asarray(r_dev.expsum_rank)[k_common])
    if t_h and t_d:
        assert t_h <= t_d, (t_h, t_d)


def test_bf16_basis_storage():
    """bf16 basis storage with f32 compute: converges to the bf16
    orthogonality floor (~1e-1 true residual). Storage is halved; the
    recurrence/reductions run in f32 (ops/orth.py:_acc_dtype)."""
    op = tk.laplace(3, 40)
    b = _normalized_rhs(3, 40, 27)
    res = tk.solve(
        op, b, SolverConfig(kmax=40, tol=3e-2, basis_dtype=jnp.bfloat16)
    )
    assert int(res.status) == Status.CONVERGED
    assert res.x.factors.dtype == jnp.float64  # lifted in proj dtype
    assert tk.kron_residual_dense(op, res.x, np.asarray(b)) < 0.15
