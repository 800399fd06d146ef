"""Certified rank-R solve with the noise-recording block solver (r5).

A rank-3 tensor-product RHS solved in ONE shared block-Krylov space per
factor, with per-factor spectral deflation composing the kappa_eff
reduction, a rigorous certificate (sup + boundary + recorded dev/eta +
Frechet remainder), and a basis-free cross-check of the result.

Run: python examples/04_certified_block.py
"""
import jax

jax.config.update("jax_enable_x64", True)   # f64 projected algebra

import numpy as np

import tensorkrylov as tk

d, n, R = 3, 256, 3
op = tk.laplace(d, n, shift=2e4)            # shift controls conditioning
rng = np.random.default_rng(0)
B = rng.standard_normal((R, d, n))          # rank-R RHS: sum of R products

res = tk.solve_block_recorded(
    op, B,
    tk.SolverConfig(kmax=40, tol=1e-8),
    m=16,                                   # deflate 16 eigenpairs/factor
    verbose=True,
)
print(f"converged={res.converged} in {res.niterations} block iterations "
      f"({res.niterations * R} columns/factor)")
print(f"certified bound : {res.certified_bound[-1]:.3e}")
print(f"cross-check     : {res.measured_cp_residual:.3e} "
      f"(validity floor {res.cp_residual_floor:.3e})")
x = res.x                                   # CPTensor (rank t*R)
