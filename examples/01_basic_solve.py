"""Basic SPD solve: d-dimensional Laplace Kronecker sum.

Run: python examples/01_basic_solve.py [--cpu]
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))  # repo-root import without install

import sys

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import tensorkrylov as tk
from tensorkrylov.convergence import summarize

d, n = 5, 200
op = tk.laplace(d, n)                       # A = Σ_s I⊗…⊗A_s⊗…⊗I, N = 200^5
b = tk.random_rhs(d, n, seed=0)
system = tk.TensorizedSystem.create(op, b)  # normalizes b per factor

result = tk.solve_tensorized_system(system, nmax=n, tol=1e-9)
print(summarize(result, every=25))

x = result.x  # CPTensor: weights (t,), factors (d, n, t) — never n^d entries
print(f"solution CP rank: {int(jnp.sum(x.weights != 0))}")
