"""final='device' for storage='df64': on-device assembly + on-device
basis-free cross-check.

The host assembly pulls the full f32-pair basis (~4 GB at flagship size).
The device path assembles x = U·Yu + V·Yv in chunked pair-GEMMs and
computes the CP residual Gram on device, pulling only the small Gram.
These tests pin: (a) equivalence of the assembled solution against the
host path, (b) the device cross-check agreeing with the host one and with
the dense kron oracle."""
import jax.numpy as jnp
import numpy as np

import tensorkrylov as tk
from tensorkrylov.utils.cp import (
    cp_residual_cross_check_device,
    cp_residual_cross_check_host,
)


def _problem(d=2, n=48):
    op = tk.laplace(d, n, shift=25.0)
    b = tk.random_rhs(d, n, seed=7)
    return op, b / jnp.linalg.norm(b, axis=1, keepdims=True)


def test_device_final_matches_host_final():
    op, b = _problem()
    cfg = tk.SolverConfig(kmax=24, tol=1e-10)
    r_host = tk.solve_deflated(op, b, cfg, m=6, storage="df64",
                               final="host", certify=True)
    r_dev = tk.solve_deflated(op, b, cfg, m=6, storage="df64",
                              final="device", certify=True)
    assert r_dev.checkpoints == r_host.checkpoints
    np.testing.assert_array_equal(
        np.asarray(r_dev.certified_bound), np.asarray(r_host.certified_bound))
    # same recorded recurrence → identical Yu/Yv; assembly differs only by
    # the pair-GEMM rounding (~1e-15 relative)
    xh = np.asarray(r_host.x.factors, np.float64)
    xd = np.asarray(r_dev.x.factors, np.float64)
    np.testing.assert_allclose(xd, xh, rtol=0, atol=1e-12 * np.abs(xh).max())
    # device cross-check resolves the same residual (both may sit at their
    # floors; they must agree to floor-scale)
    assert r_dev.measured_cp_residual is not None
    tol_band = 2.0 * max(r_dev.cp_residual_floor, r_host.cp_residual_floor)
    assert abs(r_dev.measured_cp_residual - r_host.measured_cp_residual) \
        <= tol_band + 1e-12


def test_device_cross_check_vs_dense_oracle():
    op, b = _problem(d=3, n=20)
    cfg = tk.SolverConfig(kmax=18, tol=1e-9)
    res = tk.solve_deflated(op, b, cfg, m=4, storage="df64",
                            final="device", certify=True)
    # dense kron oracle for the true residual
    from tensorkrylov.utils.cp import cp_full, kron_matvec_dense

    x_full = cp_full(res.x)
    b_full = np.array([1.0])
    for s in range(op.d):
        b_full = np.kron(b_full, np.asarray(b[s], np.float64))
    r_true = np.linalg.norm(b_full - kron_matvec_dense(op, x_full))
    b_norm = float(np.prod(np.linalg.norm(np.asarray(b, np.float64), axis=1)))
    rel_true = r_true / b_norm
    meas = res.measured_cp_residual
    floor = res.cp_residual_floor
    # the device measurement matches truth to floor-scale
    assert abs(meas - rel_true) <= 4.0 * floor + 1e-12


def test_device_cross_check_function_matches_host():
    rng = np.random.default_rng(3)
    op = tk.laplace(2, 32, shift=10.0)
    X = rng.standard_normal((2, 32, 3))
    w = rng.standard_normal(3)
    b = rng.standard_normal((2, 32))
    host = cp_residual_cross_check_host(
        np.asarray(op.bands, np.float64), op.offsets, w, X, b)
    dev = cp_residual_cross_check_device(
        op, w, jnp.asarray(X), jnp.asarray(b), n_chunk=16)
    np.testing.assert_allclose(dev.value, host.value,
                               rtol=1e-10, atol=1e-12 * max(host.value, 1.0))


def test_save_state_false_leaves_cache_untouched(tmp_path):
    op, b = _problem()
    cfg = tk.SolverConfig(kmax=16, tol=1e-30)
    cache = str(tmp_path / "state.npz")
    tk.solve_deflated(op, b, cfg, m=6, storage="df64", checkpoints=[8],
                      state_cache=cache)
    before = open(cache, "rb").read()
    tk.solve_deflated(op, b, cfg, m=6, storage="df64", checkpoints=[8, 16],
                      state_cache=cache, save_state=False)
    assert open(cache, "rb").read() == before  # resume-only: no rewrite


def test_fingerprint_rejects_different_problem(tmp_path):
    op, b = _problem()
    cfg = tk.SolverConfig(kmax=16, tol=1e-30)
    cache = str(tmp_path / "state.npz")
    tk.solve_deflated(op, b, cfg, m=6, storage="df64", checkpoints=[8],
                      state_cache=cache)
    # same shapes/m/kmax, different operator (shift) → must refuse
    op2 = tk.laplace(2, 64, shift=31.0)
    b2 = tk.random_rhs(2, 64, seed=5)
    b2 = b2 / jnp.linalg.norm(b2, axis=1, keepdims=True)
    import pytest

    with pytest.raises(ValueError, match="fingerprint|DIFFERENT"):
        tk.solve_deflated(op2, b2, cfg, m=6, storage="df64",
                          checkpoints=[8, 16], state_cache=cache)


def test_df64_distinct_factors_oracle():
    """VERDICT r4 #6: storage='df64' with DISTINCT factor matrices (per-
    factor deflation basis U (d, n, m)) — certified bound must dominate the
    dense-kron true residual, and the device-final path must agree."""
    import dataclasses

    d, n = 2, 40
    base = tk.laplace(d, n, shift=25.0)
    bands = np.asarray(base.bands, np.float64).copy()
    bands[1] *= 1.37            # factor 1 is a different SPD tridiagonal
    bands[1, np.asarray(base.offsets) == 0, :] += 11.0
    op = dataclasses.replace(base, bands=jnp.asarray(bands))
    b = tk.random_rhs(d, n, seed=9, identical=False)
    b = b / jnp.linalg.norm(b, axis=1, keepdims=True)
    cfg = tk.SolverConfig(kmax=20, tol=1e-10, identical_factors=False)
    res = tk.solve_deflated(op, b, cfg, m=5, storage="df64", final="host",
                            certify=True)
    from tensorkrylov.deflate import deflation_basis

    assert deflation_basis(op, 5).U.shape[0] == d  # genuinely distinct
    from tensorkrylov.utils.cp import cp_full, kron_matvec_dense

    x_full = cp_full(res.x)
    b_full = np.array([1.0])
    for s in range(d):
        b_full = np.kron(b_full, np.asarray(b[s], np.float64))
    rel_true = float(np.linalg.norm(b_full - kron_matvec_dense(op, x_full)))
    bound = res.certified_bound[-1]
    assert rel_true <= 1.05 * bound + 1e-15, (rel_true, bound)
    # device-final agrees
    rd = tk.solve_deflated(op, b, cfg, m=5, storage="df64", final="device",
                           certify=True)
    np.testing.assert_array_equal(np.asarray(rd.certified_bound),
                                  np.asarray(res.certified_bound))
    xd = np.asarray(rd.x.factors, np.float64)
    xh = np.asarray(res.x.factors, np.float64)
    np.testing.assert_allclose(xd, xh, rtol=0, atol=1e-12 * np.abs(xh).max())
