"""chip_smoke.py's phase 4 (every solver path once) at tiny sizes on the
CPU."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def test_phase_paths_tiny():
    out = cs.phase_paths(
        nonsym=dict(d=3, n=256, kappa=1e2, kmax=200, tmax=401, check_every=8),
        block=dict(d=3, n=256, kappa=1e2, rank=2, kmax=100),
        df64=dict(d=3, n=256, kappa=1e3, m=8, kmax=64),
        block_recorded=dict(d=3, n=128, kappa=1e2, rank=2, kmax=24))
    assert out["block"]["status"] == 1
    for key in ("nonsym", "df64", "block_recorded"):
        assert out[key]["measured_cp_residual"] is not None
