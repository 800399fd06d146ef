"""chip_smoke.py on the CPU: its phase functions at tiny sizes, and its
refusal to run anywhere but on a GPU. The full sizes run on the card with
`python chip_smoke.py` (and `--four` on four cards)."""
import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def test_main_exits_nonzero_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_phase_small():
    out = cs.phase_small()
    for label in ("spd", "nonsym"):
        assert out[label]["true_residual"] <= cs.TOL
        assert out[label]["iterations"] == out[label]["cpu_iterations"]


def test_exactness_guards_cpu():
    assert cs.tf32_guard()["f32_projection_rel_err"] < 1e-5
    assert cs.eft_guard()["composed_acc_rel"] < 1e-12


@pytest.mark.gpu
def test_exactness_guards_gpu(gpu_device):
    """On the card: f32 contractions are not TF32 and the f32 expansion
    arithmetic is exact (chip_smoke.py phase 4 runs the same guards)."""
    with jax.default_device(gpu_device):
        cs.tf32_guard()
        cs.eft_guard()
