"""Deflated solver tests — densify-oracle pattern (d ≤ 3, n ≤ 40).

The deflation capability has no reference counterpart (it is what makes the
production-size flagship feasible, see deflate.py docstring); correctness is
asserted against the dense np.kron oracle and the rigorous-bound contract
true ‖r‖ ≤ certified_bound.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

import tensorkrylov as tk
from tensorkrylov.deflate import expsum_sup_error
from tensorkrylov.models.gallery import bands_to_dense
from tensorkrylov.types import KroneckerSumOperator


def _distinct_shifted(d, n, base_shift=50.0):
    op = tk.laplace(d, n, shift=base_shift)
    bands = np.asarray(op.bands).copy()
    for s in range(d):
        bands[s, 1, :] += 5.0 * s
    return KroneckerSumOperator(jnp.asarray(bands), op.offsets, True)


def test_deflation_basis_tridiag_eigenpairs():
    op = tk.laplace(3, 30, shift=7.0)
    basis = tk.deflation_basis(op, 6)
    assert basis.U.shape == (1, 30, 6)  # identical factors → shared
    U = np.asarray(basis.U)[0]
    lam = np.asarray(basis.lam)
    A = bands_to_dense(op)[0]
    assert np.abs(U.T @ U - np.eye(6)).max() < 1e-12
    assert np.abs(A @ U - U * lam[0][None, :]).max() < 1e-9
    w = np.linalg.eigvalsh(A)
    np.testing.assert_allclose(lam[0], w[:6], rtol=1e-10)


def test_deflation_basis_distinct_and_dense_fallback():
    op = _distinct_shifted(3, 20)
    basis = tk.deflation_basis(op, 4)
    assert basis.U.shape == (3, 20, 4)
    A = bands_to_dense(op)
    for s in range(3):
        w = np.linalg.eigvalsh(A[s])
        np.testing.assert_allclose(np.asarray(basis.lam)[s], w[:4], rtol=1e-10)

    # pentadiagonal SPD → dense eigh fallback path
    n = 16
    T = np.diag(np.full(n, 4.0)) + np.diag(np.full(n - 1, -1.0), 1) \
        + np.diag(np.full(n - 1, -1.0), -1) + np.diag(np.full(n - 2, -0.3), 2) \
        + np.diag(np.full(n - 2, -0.3), -2)
    op5 = tk.operator_from_dense_factors(np.stack([T] * 2), symmetric=True)
    b5 = tk.deflation_basis(op5, 3)
    w = np.linalg.eigvalsh(T)
    np.testing.assert_allclose(np.asarray(b5.lam)[0], w[:3], rtol=1e-10)


def test_deflation_basis_toeplitz_analytic_branches():
    """Analytic sin-eigenvector path: both off-diagonal signs, and the
    LAPACK path for a non-constant tridiagonal, all vs dense eigh."""
    from scipy.linalg import eigh_tridiagonal

    from tensorkrylov.deflate import _toeplitz_lowest_m

    n, m = 37, 6
    for a, b in ((2.0 * 38.0**2 + 5.0, -(38.0**2)), (3.0, 1.7)):
        lam, U = _toeplitz_lowest_m(n, m, a, b)
        w, V = eigh_tridiagonal(
            np.full(n, a), np.full(n - 1, b), select="i", select_range=(0, m - 1)
        )
        np.testing.assert_allclose(lam, w, rtol=1e-13)
        assert np.abs(np.abs(U.T @ V) - np.eye(m)).max() < 1e-11
        assert np.all(np.diff(lam) > 0)  # ascending, both orderings

    # non-constant diagonal → must take the LAPACK tridiag branch and agree
    diag = 100.0 + np.linspace(0.0, 9.0, n)
    T = np.diag(diag) + np.diag(np.full(n - 1, -3.0), 1) + np.diag(
        np.full(n - 1, -3.0), -1
    )
    op = tk.operator_from_dense_factors(T[None], symmetric=True)
    basis = tk.deflation_basis(op, m)
    w = np.linalg.eigvalsh(T)
    np.testing.assert_allclose(np.asarray(basis.lam)[0], w[:m], rtol=1e-10)


@pytest.mark.slow
def test_host_evaluate_matches_device():
    """eigh_impl='host' (numpy/longdouble checkpoint algebra) must agree
    with the device evaluate: bounds tightly, estimates up to the f64
    cancellation floor (the host contraction is the MORE accurate one)."""
    op = tk.reaction_diffusion(3, 36, sigma=500.0)
    b = tk.random_rhs(3, 36, seed=3)
    b = b / np.linalg.norm(np.asarray(b), axis=1, keepdims=True)
    basis = tk.deflation_basis(op, 8)
    cks = [8, 16, 36]
    rd = tk.solve_deflated(
        op, b, tk.SolverConfig(kmax=36, tol=1e-9, eigh_impl="dense"),
        basis=basis, checkpoints=cks,
    )
    rh = tk.solve_deflated(
        op, b, tk.SolverConfig(kmax=36, tol=1e-9, eigh_impl="host"),
        basis=basis, checkpoints=cks,
    )
    assert rd.converged and rh.converged
    for a, h in zip(rd.certified_bound, rh.certified_bound):
        assert abs(a - h) <= 1e-6 * a + 1e-14
    for a, h in zip(rd.relative_residual, rh.relative_residual):
        assert abs(a - h) <= 1e-4 * max(a, h) + 1e-7  # f64 floor slack
    tr = tk.kron_residual_dense(op, rh.x, np.asarray(b))
    assert tr <= rh.certified_bound[-1] + 1e-12


@pytest.mark.slow
def test_structured_residual_norm_matches_materialized():
    """cp_residual_norm_accurate (indexed-Gram, memory-bounded) must equal
    cp_norm_accurate(cp_residual(...)) — the flagship-size certify path."""
    from tensorkrylov.refine import cp_residual
    from tensorkrylov.utils.cp import (
        cp_norm_accurate,
        cp_residual_norm_accurate,
    )

    op = tk.reaction_diffusion(3, 24, sigma=300.0)
    b = tk.random_rhs(3, 24, seed=0)
    b = b / np.linalg.norm(np.asarray(b), axis=1, keepdims=True)
    basis = tk.deflation_basis(op, 5)
    # unconverged solve → nonzero residual with nontrivial CP weights
    r = tk.solve_deflated(op, b, tk.SolverConfig(kmax=4, tol=1e-10), basis=basis)
    old = float(cp_norm_accurate(cp_residual(op, r.x, b)))
    new = cp_residual_norm_accurate(op, r.x, b)
    assert abs(new - old) <= 1e-10 * old
    assert abs(new - tk.kron_residual_dense(op, r.x, np.asarray(b))) < 1e-8  # ||b||=1


def test_deflated_solve_certified_vs_dense_oracle():
    op = tk.laplace(3, 30, shift=50.0)
    b = tk.random_rhs(3, 30, seed=7)
    res = tk.solve_deflated(
        op, b, tk.SolverConfig(kmax=30, tol=1e-7), m=6, checkpoints=[8, 16, 24, 30]
    )
    assert res.converged
    true_r = float(tk.kron_residual_dense(op, res.x, np.asarray(b)))
    assert true_r <= res.certified_bound[-1] + 1e-14  # the bound is a bound
    assert true_r < 1e-7
    # estimates decrease and the boundary part actually converged
    assert res.relative_residual[0] > res.relative_residual[-1]


def test_deflated_solve_distinct_factors():
    op = _distinct_shifted(3, 30)
    b = tk.random_rhs(3, 30, seed=3)
    res = tk.solve_deflated(
        op, b, tk.SolverConfig(kmax=30, tol=1e-7), m=5, checkpoints=[10, 20, 30]
    )
    assert res.converged
    true_r = float(tk.kron_residual_dense(op, res.x, np.asarray(b)))
    assert true_r <= res.certified_bound[-1] + 1e-14


@pytest.mark.slow
def test_deflation_reduces_iterations():
    """The point of deflation: fewer Krylov steps to the same certificate on
    a stiff (large-κ) problem."""
    n, d = 40, 2
    op = tk.laplace(d, n, shift=1.0)  # κ ~ 2.6e3
    b = tk.random_rhs(d, n, seed=11)
    cks = list(range(4, n + 1, 4))
    plain = tk.solve_deflated(op, b, tk.SolverConfig(kmax=n, tol=1e-6), m=1,
                              checkpoints=cks, certify=False)
    defl = tk.solve_deflated(op, b, tk.SolverConfig(kmax=n, tol=1e-6), m=12,
                             checkpoints=cks, certify=False)
    assert defl.converged
    assert defl.niterations < plain.niterations


@pytest.mark.slow
def test_deflated_basis_stays_U_orthogonal():
    """The per-step re-projection keeps the Krylov basis in the U-complement
    (drift would poison the joint-basis residual algebra)."""
    from tensorkrylov.ops.orth import init_state, lanczos_step

    op = tk.laplace(2, 30, shift=5.0)
    basis = tk.deflation_basis(op, 5)
    b = tk.random_rhs(2, 30, seed=1)
    U = basis.U
    pdt = jnp.float64
    c = jnp.einsum("nm,dn->dm", U[0].astype(pdt), b.astype(pdt))
    b_perp = b.astype(pdt) - jnp.einsum("nm,dm->dn", U[0].astype(pdt), c)
    state, _ = init_state(op, b_perp, 8, pdt)
    for k in range(1, 9):
        state, _ = lanczos_step(
            op, state, b_perp, k, reorth=False, proj_dtype=pdt, deflate_U=U
        )
    V = np.asarray(state.V)  # (K, d, n)
    drift = np.abs(np.einsum("nm,kdn->kdm", np.asarray(U)[0], V)).max()
    assert drift < 1e-12


def test_expsum_sup_error_matches_table_scale():
    """sup|1 − x g(x)| on [1, κ] is ~ ε·κ for the selected table row."""
    from tensorkrylov.coeffs.tables import load_tables, select_bh

    tables = load_tables()
    kappa = 1e3
    coeffs = select_bh(jnp.asarray(kappa), 1e-10, tables)
    sup = expsum_sup_error(coeffs.omega, coeffs.alpha, kappa)
    err = float(coeffs.err)
    assert sup <= err * kappa * 1.2
    assert sup >= err * 0.5  # not absurdly below the tabulated accuracy


def test_deflated_input_validation():
    op = tk.conv_diff(2, 16)
    with pytest.raises(ValueError):
        tk.solve_deflated(op, tk.random_rhs(2, 16, seed=0), m=2)
    ops = tk.laplace(2, 16)
    with pytest.raises(ValueError):
        tk.deflation_basis(ops, 0)
    with pytest.raises(ValueError):
        tk.deflation_basis(ops, 16)


@pytest.mark.slow
def test_twopass_storage_matches_full():
    """storage='twopass' (basis-free; pass-2 replay accumulation) must
    reproduce the stored-basis solve essentially exactly."""
    op = tk.laplace(3, 30, shift=50.0)
    b = tk.random_rhs(3, 30, seed=7)
    # orth='lanczos': replay equivalence holds only for identical recurrences
    # (reorth sweeps need the stored basis, so 'full' would diverge from the
    # sweep-free twopass recurrence at the roundoff level)
    cfg = tk.SolverConfig(kmax=30, tol=1e-7, orth="lanczos")
    r_full = tk.solve_deflated(op, b, cfg, m=6, checkpoints=[8, 16, 24],
                               storage="full", certify=False)
    r_two = tk.solve_deflated(op, b, cfg, m=6, checkpoints=[8, 16, 24],
                              storage="twopass", certify=False)
    assert r_two.status == r_full.status
    assert r_two.niterations == r_full.niterations
    np.testing.assert_allclose(r_two.certified_bound, r_full.certified_bound, rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(r_two.x.factors), np.asarray(r_full.x.factors),
        atol=1e-12, rtol=1e-10,
    )
    true_r = float(tk.kron_residual_dense(op, r_two.x, np.asarray(b)))
    assert true_r <= r_two.certified_bound[-1] + 1e-14


def test_advance_reorth_always_orthogonalizes():
    """Regression: orth='lanczos_reorth' must actually run the CGS sweep in
    the deflated driver (it was silently mapped to a no-op once)."""
    from tensorkrylov.deflate import _advance, _init_defl_state
    import jax.numpy as jnp

    op = tk.laplace(2, 40, shift=0.1)  # kappa ~ 7e2: Ritz pairs converge
    basis = tk.deflation_basis(op, 2)
    b = np.asarray(tk.random_rhs(2, 40, seed=5), np.float64)
    U0 = np.asarray(basis.U, np.float64)[0]
    c = np.einsum("nm,dn->dm", U0, b)
    b_perp = b - np.einsum("nm,dm->dn", U0, c)

    k = 30
    grams = {}
    for mode in ("never", "always"):
        state, _ = _init_defl_state(jnp.asarray(b_perp), k + 1, jnp.float64)
        state = _advance(
            op.astype(jnp.float64), state, jnp.asarray(b_perp),
            jnp.asarray(basis.U, jnp.float64),
            jnp.asarray(1, jnp.int32), jnp.asarray(k + 1, jnp.int32),
            reorth=mode,
        )
        V = np.asarray(state.V).reshape(k + 1, 2, -1)[:k].transpose(1, 0, 2)
        G = np.einsum("dkn,djn->dkj", V, V)
        grams[mode] = np.abs(G - np.eye(k)[None]).max()
    assert grams["always"] < 1e-13
    assert grams["always"] < grams["never"] / 10.0


@pytest.mark.slow
def test_deflated_solve_b_in_span_U():
    """b_s entirely inside span(U_s) (zero deflated complement) must not
    poison the state with NaN — the factor's recurrence freezes at zero and
    the U-block solves it exactly."""
    op = tk.laplace(2, 20, shift=5.0)
    basis = tk.deflation_basis(op, 4)
    U0 = np.asarray(basis.U, np.float64)[0]
    b = np.zeros((2, 20))
    b[0] = U0[:, 0] + 0.5 * U0[:, 2]
    b[1] = np.random.default_rng(0).standard_normal(20)
    for storage in ("full", "twopass"):
        r = tk.solve_deflated(op, jnp.asarray(b), tk.SolverConfig(kmax=20, tol=1e-7),
                              basis=basis, checkpoints=[6, 12, 18], storage=storage)
        assert r.converged
        assert np.isfinite(np.asarray(r.x.factors)).all()
        assert np.isfinite(r.certified_bound).all()
        true_r = float(tk.kron_residual_dense(op, r.x, b))
        assert true_r <= r.certified_bound[-1] + 1e-12


def test_deflated_eigh_impl_tridiag_mixed_matches_dense():
    """The mixed-precision tridiagonal eigh checkpoint evaluation must
    match the dense-eigh evaluation to f64 working accuracy."""
    op = tk.laplace(3, 30, shift=50.0)
    b = tk.random_rhs(3, 30, seed=7)
    r_d = tk.solve_deflated(op, b, tk.SolverConfig(kmax=30, tol=1e-7, eigh_impl="dense"),
                            m=6, checkpoints=[8, 16, 24], certify=False)
    r_m = tk.solve_deflated(op, b,
                            tk.SolverConfig(kmax=30, tol=1e-7, eigh_impl="tridiag_mixed"),
                            m=6, checkpoints=[8, 16, 24], certify=False)
    assert r_m.status == r_d.status
    np.testing.assert_allclose(r_m.certified_bound, r_d.certified_bound, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(r_m.x.factors), np.asarray(r_d.x.factors),
                               atol=1e-10)
    true_r = float(tk.kron_residual_dense(op, r_m.x, np.asarray(b)))
    assert true_r <= r_m.certified_bound[-1] + 1e-12


@pytest.mark.slow
def test_pass2_audit_and_cross_check_floor():
    """storage='twopass' must return the replay audit (sampled pairwise Gram
    + replayed-vs-recorded beta deviation) and the cross-check's validity
    floor (VERDICT r2 weak #1/#5)."""
    op = tk.laplace(2, 36, shift=30.0)
    b = tk.random_rhs(2, 36, seed=5)
    b = b / jnp.linalg.norm(b, axis=1, keepdims=True)
    r = tk.solve_deflated(op, b, tk.SolverConfig(kmax=16, tol=1e-10),
                          m=6, storage="twopass")
    # audit present and at f64 roundoff scale for this tiny well-conditioned
    # problem: the replay is bit-deterministic and drift is benign
    assert r.pass2_gram_max is not None and r.pass2_beta_rel_dev is not None
    assert r.pass2_beta_rel_dev < 1e-12          # replay premise holds
    assert r.pass2_gram_max < 1e-8               # sampled orthonormality
    # cross-check floor is recorded and the measurement is interpretable
    assert r.cp_residual_floor is not None and r.cp_residual_floor > 0.0
    true_r = float(tk.kron_residual_dense(op, r.x, np.asarray(b)))
    # either the measurement resolves the true residual, or it is floored
    if r.measured_cp_residual > r.cp_residual_floor:
        assert abs(r.measured_cp_residual - true_r) < 10 * r.cp_residual_floor
    else:
        assert true_r < 10 * max(r.cp_residual_floor, 1e-15)
    # full storage path reports no pass-2 audit (no replay happens)
    rf = tk.solve_deflated(op, b, tk.SolverConfig(kmax=16, tol=1e-10),
                           m=6, storage="full")
    assert rf.pass2_gram_max is None


def test_tridiag_parts_plus_band_only():
    """A symmetric tridiagonal operator stored with offsets (0, +1) must
    yield the same deflation basis as the (-1, 0) storage (ADVICE r2: the
    +1-only layout used to silently produce e=0 → a diagonal-matrix basis)."""
    from tensorkrylov.deflate import _tridiag_parts

    n = 18
    rng = np.random.default_rng(3)
    diag = 8.0 + rng.uniform(0.5, 1.0, n)
    e = -rng.uniform(0.2, 0.4, n - 1)

    lo = np.zeros((1, 2, n)); lo[0, 0] = diag; lo[0, 1, 1:] = e   # (0, -1)
    hi = np.zeros((1, 2, n)); hi[0, 0] = diag; hi[0, 1, :-1] = e  # (0, +1)
    d_lo, e_lo = _tridiag_parts(lo, (0, -1))
    d_hi, e_hi = _tridiag_parts(hi, (0, 1))
    np.testing.assert_array_equal(d_lo, d_hi)
    np.testing.assert_array_equal(e_lo, e_hi)

    op_hi = KroneckerSumOperator(jnp.asarray(hi), (0, 1), True)
    basis = tk.deflation_basis(op_hi, 4)
    A = np.diag(diag) + np.diag(e, 1) + np.diag(e, -1)
    w = np.linalg.eigvalsh(A)
    np.testing.assert_allclose(np.asarray(basis.lam)[0], w[:4], rtol=1e-10)

    # disagreeing double-stored bands are rejected, not silently averaged
    bad = np.zeros((1, 3, n)); bad[0, 0] = diag
    bad[0, 1, 1:] = e; bad[0, 2, :-1] = 2.0 * e
    with pytest.raises(ValueError, match="disagree"):
        _tridiag_parts(bad, (0, -1, 1))


@pytest.mark.slow
def test_project_every_stride_matches_per_step():
    """Strided U-projection (a flagship step-cost optimization) must
    reproduce the per-step-projected solve and keep the measured U-leak at
    the amplified-roundoff level."""
    op = tk.laplace(2, 64, shift=30.0)
    b = tk.random_rhs(2, 64, seed=5)
    b = b / jnp.linalg.norm(b, axis=1, keepdims=True)
    cfg = tk.SolverConfig(kmax=20, tol=1e-12)
    r1 = tk.solve_deflated(op, b, cfg, m=6, storage="twopass", project_every=1)
    r8 = tk.solve_deflated(op, b, cfg, m=6, storage="twopass", project_every=8)
    t1 = tk.kron_residual_dense(op, r1.x, np.asarray(b))
    t8 = tk.kron_residual_dense(op, r8.x, np.asarray(b))
    assert abs(t8 - t1) / max(t1, 1e-300) < 1e-4
    assert r1.projection_leak < 1e-13          # per-step: pure roundoff
    assert r8.projection_leak < 1e-8           # strided: amplified roundoff
    # full storage supports the stride too (leak telemetry is twopass-only)
    rf = tk.solve_deflated(op, b, cfg, m=6, storage="full", project_every=4)
    tf = tk.kron_residual_dense(op, rf.x, np.asarray(b))
    assert abs(tf - t1) / max(t1, 1e-300) < 1e-4


@pytest.mark.slow
def test_segmented_storage_matches_full():
    """storage='segmented' (per-segment basis blocks + boundary full
    reorthogonalization: big f64 buffers never cross a jit boundary)
    must match storage='full' and keep the measured
    boundary drift at roundoff on a well-conditioned problem."""
    op = tk.laplace(2, 64, shift=30.0)
    b = tk.random_rhs(2, 64, seed=5)
    b = b / jnp.linalg.norm(b, axis=1, keepdims=True)
    cfg = tk.SolverConfig(kmax=24, tol=1e-12)
    rf = tk.solve_deflated(op, b, cfg, m=6, storage="full")
    rs = tk.solve_deflated(op, b, cfg, m=6, storage="segmented", segment=8)
    tf = tk.kron_residual_dense(op, rf.x, np.asarray(b))
    ts = tk.kron_residual_dense(op, rs.x, np.asarray(b))
    assert abs(ts - tf) / tf < 1e-3
    assert ts <= rs.certified_bound[-1] + 1e-12
    assert rs.boundary_drift_max is not None and rs.boundary_drift_max < 1e-10
    # checkpoints snap to segment multiples
    r2 = tk.solve_deflated(op, b, tk.SolverConfig(kmax=24, tol=1e-12), m=6,
                           storage="segmented", segment=8, checkpoints=[13])
    assert all(c % 8 == 0 for c in r2.checkpoints)


def test_df64_storage_matches_full_and_certifies():
    """storage='df64' (f32 hi/lo pair basis + in-kernel per-step full
    reorthogonalization — the certifying mode without native f64) must
    match storage='full',
    keep the measured pre-sweep overlap at roundoff, and produce a
    cross-check that AGREES with the dense-oracle truth (the property the
    twopass/segmented modes measurably lack at scale)."""
    op = tk.laplace(2, 64, shift=30.0)
    b = tk.random_rhs(2, 64, seed=5)
    b = b / jnp.linalg.norm(b, axis=1, keepdims=True)
    cfg = tk.SolverConfig(kmax=24, tol=1e-12)
    rf = tk.solve_deflated(op, b, cfg, m=6, storage="full")
    rd = tk.solve_deflated(op, b, cfg, m=6, storage="df64")
    tf = tk.kron_residual_dense(op, rf.x, np.asarray(b))
    td = tk.kron_residual_dense(op, rd.x, np.asarray(b))
    assert abs(td - tf) / tf < 1e-3
    assert td <= rd.certified_bound[-1] + 1e-12
    assert rd.boundary_drift_max < 1e-9           # pre-sweep overlap
    # the basis-free cross-check resolves the true residual
    assert abs(rd.measured_cp_residual - td) < 1e-3 * td + rd.cp_residual_floor
    # v2 noise-recording evidence: full-Gram orthonormality bound, recorded
    # perturbation magnitude, measured relation terms, in-process EFT eps
    assert rd.gram_deviation is not None and rd.gram_deviation < 1e-12
    assert rd.perturbation_rho is not None and rd.perturbation_rho < 1e-8
    assert 0.0 <= rd.relation_dev_term < 1e-10
    assert 0.0 <= rd.relation_eta_term < 1e-10
    assert rd.eft_eps_measured is not None
    # the recorded-relation bound is TIGHT: within 2x of the truth (the r3
    # blockdiag bound could only be loose-or-violated at scale)
    assert rd.certified_bound[-1] <= 2.0 * td + 1e-12


@pytest.mark.slow  # ADVICE-regression variant of the fast df64 core test
def test_df64_project_every_strided():
    """project_every > 1 on df64 storage (ADVICE r3: the parameter used to
    be accepted-but-ignored): the projection runs on the stride, skipped
    steps record zero C-columns, and the result still certifies."""
    op = tk.laplace(2, 64, shift=30.0)
    b = tk.random_rhs(2, 64, seed=5)
    b = b / jnp.linalg.norm(b, axis=1, keepdims=True)
    cfg = tk.SolverConfig(kmax=24, tol=1e-12)
    r1 = tk.solve_deflated(op, b, cfg, m=6, storage="df64")
    r4 = tk.solve_deflated(op, b, cfg, m=6, storage="df64", project_every=4)
    t1 = tk.kron_residual_dense(op, r1.x, np.asarray(b))
    t4 = tk.kron_residual_dense(op, r4.x, np.asarray(b))
    assert abs(t4 - t1) / t1 < 1e-2
    assert t4 <= r4.certified_bound[-1] + 1e-12
    # strided projection leaks between projections — measured, nonzero
    assert r4.projection_leak is not None


def test_evaluate_host_recorded_inverts_perturbed_operator():
    """The noise-recording evaluation must solve the PERTURBED projected
    system: with an artificially large recorded W (1e-4-scale), the
    Frechet-corrected y must drive the measured joint defect ~|W|^2/gap
    below the uncorrected level by orders of magnitude (the r3 flagship
    gap was exactly an uncorrected-W term)."""
    from tensorkrylov.deflate import _evaluate_host_recorded

    rng = np.random.default_rng(3)
    d, k, m, Kp = 2, 12, 3, 16
    # SPD tridiagonal T per factor, spectrum ~ [1, 10]
    dg = np.zeros((d, k + 1))
    od = np.zeros((d, k + 1))
    dg[:, :k] = 5.0 + rng.standard_normal((d, k))
    od[:, 1:k] = 0.5 * np.abs(rng.standard_normal((d, k - 1)))
    beta = np.abs(rng.standard_normal(d)) * 0.0        # no boundary term
    lam = np.sort(np.abs(rng.standard_normal((d, m)))) + 0.5
    c = rng.standard_normal((d, m)) * 0.3
    b0 = np.ones(d)
    lam_min = float(lam[:, 0].sum() + 0.0) * 0 + float(lam[:, 0].sum())
    # exp-sum coefficients for 1/x on [1, kappa]: use the BH table loader
    import tensorkrylov as tk2
    from tensorkrylov.coeffs.tables import load_tables, select_bh
    tables = load_tables()
    lam_tot_max = float(lam[:, -1].sum() + 2 * (dg.max() + 2 * od.max()))
    kappa = lam_tot_max / lam_min
    co = select_bh(jnp.asarray(kappa), 1e-10 / kappa, tables)
    omega, alpha, t_mask = (np.asarray(co.omega), np.asarray(co.alpha),
                            np.asarray(co.t_mask))

    W = np.zeros((d, Kp, Kp), np.float32)
    W[:, :k, :k] = (rng.standard_normal((d, k, k)) * 1e-4).astype(np.float32)
    Cm = np.zeros((d, m, Kp), np.float32)
    dev = np.zeros((d, k + 1))

    def run(frechet):
        return _evaluate_host_recorded(
            dg, od, np.zeros((d, k + 1)), beta, k, lam, c, 1.0, lam_min,
            omega, alpha, t_mask, W, Cm, dev, b0, np.zeros(d),
            1e-20, np.full(d, lam_tot_max / d), 0.0, frechet=frechet)

    rel_un, *_ = run(False)
    rel_co, *_ = run(True)
    # uncorrected defect ~ |W|-scale; corrected ~ |W|^2-scale
    assert rel_un > 1e-6
    assert rel_co < rel_un / 50.0, (rel_un, rel_co)
