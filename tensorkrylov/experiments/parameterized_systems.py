"""Condition-number parameter sweeps.

Rebuild of /root/reference/experiments/parameterized_systems.jl: SPD factors
(1/h²)·tridiag(−1, α, −1) parameterized by the diagonal shift α (κ grows as
α → 2), and nonsymmetric convection–diffusion factors with a parameterized
first superdiagonal β.

Run: python -m tensorkrylov.experiments.parameterized_systems --alpha 2.2 --beta -4.0
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .. import random_rhs, solve
from ..convergence import trim
from ..models.gallery import _banded_operator
from ..types import KroneckerSumOperator, SolverConfig

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "data")

__all__ = [
    "parameterized_spd",
    "parameterized_nonsym",
    "parameterized_cond",
    "parameterized_experiment",
]


def parameterized_spd(d: int, n: int, alpha: float, dtype=jnp.float64) -> KroneckerSumOperator:
    """(1/h²)·tridiag(−1, α, −1) — /root/reference/experiments/parameterized_systems.jl:3-10."""
    h2inv = float((n + 1) ** 2)
    return _banded_operator(
        {-1: -h2inv, 0: alpha * h2inv, 1: -h2inv}, d, n, dtype, symmetric=True
    )


def parameterized_nonsym(d: int, n: int, beta: float, c: float = 10.0, dtype=jnp.float64) -> KroneckerSumOperator:
    """Laplacian + (c/4h)·diags(1 @ −1, 3 @ 0, β @ +1, 1 @ +2)
    — /root/reference/experiments/parameterized_systems.jl:12-20."""
    h = 1.0 / (n + 1)
    h2inv = 1.0 / h**2
    cv = c / (4.0 * h)
    return _banded_operator(
        {-1: -h2inv + cv, 0: 2.0 * h2inv + 3.0 * cv, 1: -h2inv + beta * cv, 2: cv},
        d, n, dtype, symmetric=False,
    )


def parameterized_cond(n: int, alpha: float) -> float:
    """κ of one SPD factor (host oracle,
    /root/reference/experiments/parameterized_systems.jl:22)."""
    from ..models.gallery import bands_to_dense

    op = parameterized_spd(1, n, alpha)
    ev = np.linalg.eigvalsh(np.asarray(bands_to_dense(op))[0])
    return float(ev[-1] / ev[0])


def parameterized_experiment(
    alpha: float = 2.2,
    beta: float = -5.0,
    dims: Sequence[int] = (5, 10, 50, 100),
    n: int = 200,
    tol: float = 1e-9,
    nmax: Optional[int] = None,
    seed: int = 1234,
    verbose: bool = True,
):
    results = {"alpha": alpha, "beta": beta, "spd": {}, "nonsym": {}}
    for d in dims:
        b = random_rhs(d, n, seed=seed)
        b = b / jnp.linalg.norm(b, axis=1, keepdims=True)

        op = parameterized_spd(d, n, alpha)
        cfg = SolverConfig(kmax=nmax or n, tol=tol, orth="lanczos_reorth")
        t0 = time.perf_counter()
        res = solve(op, b, cfg)
        tr = trim(res)
        results["spd"][d] = {
            "status": int(res.status),
            "niterations": int(res.niterations),
            "wall_s": time.perf_counter() - t0,
            "final_relative_residual": float(tr["relative_residual"][-1]),
            "relative_residual": tr["relative_residual"].tolist(),
        }

        op2 = parameterized_nonsym(d, n, beta)
        cfg2 = SolverConfig(kmax=nmax or n, tol=tol, orth="arnoldi", tmax=601, identical_factors=True)
        t0 = time.perf_counter()
        res2 = solve(op2, b, cfg2)
        tr2 = trim(res2)
        results["nonsym"][d] = {
            "status": int(res2.status),
            "niterations": int(res2.niterations),
            "wall_s": time.perf_counter() - t0,
            "final_relative_residual": float(tr2["relative_residual"][-1]),
            "relative_residual": tr2["relative_residual"].tolist(),
        }
        if verbose:
            print(
                f"d={d}: spd final={results['spd'][d]['final_relative_residual']:.2e} "
                f"nonsym final={results['nonsym'][d]['final_relative_residual']:.2e}"
            )
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--alpha", type=float, default=2.2)
    p.add_argument("--beta", type=float, default=-5.0)
    p.add_argument("--dims", type=int, nargs="+", default=[5, 10])
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--tol", type=float, default=1e-9)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    results = parameterized_experiment(args.alpha, args.beta, args.dims, args.n, args.tol)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"parameterized_a{args.alpha}_b{args.beta}.json")
    with open(path, "w") as f:
        json.dump(results, f)
    print("saved", path)
