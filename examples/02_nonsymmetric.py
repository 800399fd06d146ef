"""Nonsymmetric convection–diffusion solve: Arnoldi + Stenger sinc
coefficients (more terms than the Braess–Hackbusch cap → tmax=201).

Run: python examples/02_nonsymmetric.py [--cpu]
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

d, n = 3, 100
op = tk.conv_diff(d, n, c=10.0)
b = tk.random_rhs(d, n, seed=1)
b = b / jnp.linalg.norm(b, axis=1, keepdims=True)

cfg = tk.SolverConfig(kmax=n, tol=1e-8, orth="arnoldi", tmax=201)
result = tk.solve(op, b, cfg)
print(summarize(result, every=20))
