"""'auto' settings resolve from the problem and the driver, never from the
backend's name: with jax.default_backend() reporting 'cpu', 'gpu' or 'tpu'
every default comes out the same — dense eigh, eig for the nonsymmetric
projected solve, full storage and host assembly for the deflated and
recorded block solvers, and an einsum for the per-factor dots."""
import jax
import jax.numpy as jnp
import pytest

import tensorkrylov as tk
from tensorkrylov.ops.orth import bdot
from tensorkrylov.solver import NONSYM_SOLVE_AUTO, _resolve_config
from tensorkrylov.types import SolverConfig


@pytest.fixture(params=["cpu", "gpu", "tpu"])
def backend_name(request, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: request.param)
    return request.param


def test_auto_resolution_ignores_backend_name(backend_name, monkeypatch):
    spd = tk.laplace(2, 24)
    cfg = _resolve_config(SolverConfig(kmax=12), spd)
    assert cfg.eigh_impl == "dense"
    nonsym = tk.conv_diff(2, 24)
    cfg = _resolve_config(SolverConfig(kmax=12, orth="arnoldi"), nonsym)
    assert cfg.nonsym_solve_impl == NONSYM_SOLVE_AUTO == "eig"
    # the host-projected driver runs its projected stage on the CPU backend
    cfg = _resolve_config(SolverConfig(kmax=12, orth="arnoldi"), nonsym,
                          host_projected=True)
    assert cfg.nonsym_solve_impl == "eig"
    assert "dot_general" in str(jax.make_jaxpr(bdot)(jnp.ones((2, 8)),
                                                     jnp.ones((2, 8))))

    b = tk.random_rhs(2, 24, seed=2)
    # storage='auto' → 'full': no two-pass replay audit
    rd = tk.solve_deflated(spd, b, SolverConfig(kmax=16, tol=1e-6), m=4)
    assert rd.pass2_beta_rel_dev is None and rd.pass2_gram_max is None
    # final='auto' → 'host': assembly and cross-check run on the host
    import tensorkrylov.utils.cp as cp

    host_checks = []
    real = cp.cp_residual_cross_check_host_rankR
    monkeypatch.setattr(cp, "cp_residual_cross_check_host_rankR",
                        lambda *a, **k: host_checks.append(1) or real(*a, **k))
    B = jnp.stack([b, 0.5 * b + 0.1])
    rr = tk.solve_block_recorded(spd, B, SolverConfig(kmax=4, tol=1e-3))
    assert host_checks and rr.measured_cp_residual is not None
