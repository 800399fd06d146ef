"""Multi-device solve over a ('factor', 'mode') mesh.

On a CPU host this demonstrates with 8 virtual devices; on a multi-GPU host
the same code shards over the real cards (mode-axis halos ride NVLink).

Run: python examples/03_sharded.py
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))  # repo-root import without install

import os

flag = "--xla_force_host_platform_device_count=8"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " " + flag).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import tensorkrylov as tk
from tensorkrylov.parallel import make_mesh, solve_sharded

d, n = 4, 256
mesh = make_mesh(8, factor_parallel=2)  # 2-way factor × 4-way mode
print("mesh:", mesh)

op = tk.laplace(d, n)
b = tk.random_rhs(d, n, seed=0)
b = b / jnp.linalg.norm(b, axis=1, keepdims=True)

res = solve_sharded(op, b, tk.SolverConfig(kmax=128, tol=1e-8), mesh)
ni = int(res.niterations)
print(f"status={int(res.status)} niter={ni} rel_res={float(res.relative_residual[ni]):.2e}")
