"""CLI smoke tests (subprocess, CPU-forced)."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "tensorkrylov", *args],
        capture_output=True, text=True, cwd=REPO, timeout=timeout,
    )


@pytest.mark.slow
def test_cli_info():
    r = _run("info", "--cpu")
    assert r.returncode == 0
    payload = json.loads(r.stdout[r.stdout.index("{"):])
    assert payload["backend"] == "cpu"


@pytest.mark.slow
def test_cli_solve(tmp_path):
    out = tmp_path / "traces.json"
    r = _run("solve", "--gallery", "laplace", "--d", "3", "--n", "40",
             "--tol", "1e-8", "--cpu", "--json", str(out))
    assert r.returncode == 0, r.stderr[-500:]
    assert "CONVERGED" in r.stdout
    payload = json.loads(out.read_text())
    assert payload["status"] == "CONVERGED"
