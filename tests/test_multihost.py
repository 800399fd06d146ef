"""Multi-host harness tests: pod-mesh construction policy + a genuine
2-process CPU smoke (subprocesses with jax.distributed over localhost)."""
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax

from tensorkrylov.parallel.multihost import make_pod_mesh


def test_pod_mesh_axis_policy():
    """'factor' must span the process-major dimension, 'mode' each
    process's local devices — jax.devices() is process-major, so rows of the grid
    are contiguous device ranges."""
    devs = jax.devices()[:8]
    mesh = make_pod_mesh(factor_parallel=2, devices=devs)
    assert mesh.axis_names == ("factor", "mode")
    grid = np.asarray(mesh.devices)
    assert grid.shape == (2, 4)
    ids = np.asarray([[d.id for d in row] for row in grid])
    # rows contiguous: factor groups own contiguous (same-host) device spans
    assert (np.diff(ids, axis=1) == 1).all()
    with pytest.raises(ValueError):
        make_pod_mesh(factor_parallel=3, devices=devs)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_cpu_smoke():
    """Spawn a real 2-process jax.distributed group (gloo over localhost),
    each with 2 virtual CPU devices, and run a sharded end-to-end solve on
    the ('factor' x 'mode') pod mesh. Both processes must converge to the
    same residual, matching a local single-process solve."""
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    procs = [
        subprocess.Popen(
            [
                sys.executable, "-m", "tensorkrylov.parallel._smoke",
                "--coordinator", f"localhost:{port}",
                "--num-processes", "2", "--process-id", str(i),
                "--local-devices", "2", "--cpu",
            ],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True, env=env, cwd=os.path.dirname(os.path.dirname(__file__)),
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    lines = [re.search(r"SMOKE (\d+) (\d+) ([0-9.e+-]+)", o) for o in outs]
    assert all(lines), outs
    stats = [(int(m.group(1)), int(m.group(2)), float(m.group(3))) for m in lines]
    assert stats[0] == stats[1]          # both processes agree bit-for-bit
    status, ni, rel = stats[0]
    assert status == 1 and rel < 1e-6    # CONVERGED under tol

    # cross-check against the same solve single-process
    import tensorkrylov as tk

    op = tk.laplace(4, 32)
    b = tk.random_rhs(4, 32, seed=1)
    b = b / np.linalg.norm(np.asarray(b), axis=1, keepdims=True)
    res = tk.solve(op, b, tk.SolverConfig(kmax=32, tol=1e-6))
    rel_local = float(np.asarray(res.relative_residual)[int(res.niterations)])
    assert abs(rel - rel_local) < 1e-2 * max(rel, rel_local) + 1e-9
