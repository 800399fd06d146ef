"""chip_smoke.py's phase 2 (the deflated flagship recipe) and phase 3 (the
one-jit solver plus the SpMV/step timers) at tiny sizes on the CPU."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def test_phase_flagship_tiny():
    out = cs.phase_flagship(d=3, n=512, kappa=1e3, m=32, kmax=200)
    assert out["certified_bound"] < cs.TOL
    assert out["measured_cp_residual"] <= max(cs.TOL, out["cp_residual_floor"])


def test_phase_real_width_tiny():
    out = cs.phase_real_width(d=3, n=512, kappa=1e3, kmax=250,
                              spmv_shape=dict(d=2, n=4096),
                              step_shape=dict(d=2, n=4096), spmv_iters=5)
    assert out["status"] == 1 and out["estimate"] < cs.TOL
    assert out["memory_analysis"]["argument_bytes"] > 0
    assert out["spmv_s_per_apply"] > 0 and out["lanczos_step_s"] > 0
