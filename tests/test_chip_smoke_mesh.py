"""chip_smoke.py's phase 5 (`--four`: the sharded solves against their
one-card runs) on four of the suite's virtual CPU devices."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def test_phase_four_on_four_virtual_devices():
    from tensorkrylov.parallel import make_mesh

    mesh = make_mesh(4, factor_parallel=2)
    out = cs.phase_four(mesh, real_width=dict(d=4, n=256, kappa=1e2, kmax=120),
                        flagship=dict(d=4, n=256, kappa=1e3, m=16, kmax=128))
    assert out["gspmd"]["iterations"] == out["ring"]["iterations"]
    assert out["flagship_mesh"]["certified_bound"] < cs.TOL
