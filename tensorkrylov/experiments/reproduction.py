"""Paper-reproduction experiment harness.

Rebuild of the reference's NumericalExperiments reproduction config
(/root/reference/experiments/reproduction.jl:9-23): SPD d ∈ {5,10,50,100},
n = 200, tol = 1e-9, Laplace + reorthogonalized Lanczos; nonsymmetric
ConvDiff + Arnoldi. Results are saved as JSON traces (the reference uses
opaque Julia Serialization blobs, /root/reference/experiments/experiment_common.jl:115-143).

Run: python -m tensorkrylov.experiments.reproduction [--dims 5 10] [--n 200]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import conv_diff, laplace, random_rhs, solve
from ..convergence import summarize, trim
from ..types import SolverConfig

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "data")


def run_reproduction(
    dims: List[int] = (5, 10, 50, 100),
    n: int = 200,
    tol: float = 1e-9,
    nmax: Optional[int] = None,
    symmetric: bool = True,
    seed: int = 1234,
    out_dir: Optional[str] = None,
    verbose: bool = True,
    tmax: int = 601,
):
    nmax = nmax or n
    results = {}
    for d in dims:
        if symmetric:
            op = laplace(d, n)
            # identical factors + identical RHS (the reference's setup,
            # /root/reference/src/system.jl:5-11) → shared-eigh fast path
            cfg = SolverConfig(
                kmax=nmax, tol=tol, orth="lanczos_reorth", identical_factors=True
            )
        else:
            op = conv_diff(d, n)
            # identical factors + replicated RHS (the reference's setup) →
            # the projected eig/expm chain runs once and broadcasts
            # tmax=601: the rank-~400 sinc quadrature is what reaches the
            # reference's tol=1e-9 (the reference itself never did - its
            # recorded nonsym floors are 2.6e-2..3.5e-6); at n=200 the f64
            # ceiling eps*kappa_eff ~ 4e-9 sits just below the target
            cfg = SolverConfig(
                kmax=nmax, tol=tol, orth="arnoldi", tmax=tmax, identical_factors=True
            )
        b = random_rhs(d, n, seed=seed)
        b = b / jnp.linalg.norm(b, axis=1, keepdims=True)
        t0 = time.perf_counter()
        res = solve(op, b, cfg)
        ni = int(res.niterations)
        wall = time.perf_counter() - t0
        traces = trim(res)
        results[d] = {
            "d": d,
            "n": n,
            "tol": tol,
            "status": int(res.status),
            "niterations": ni,
            "wall_s": wall,
            "final_relative_residual": float(traces["relative_residual"][-1]),
            "relative_residual": traces["relative_residual"].tolist(),
            "expsum_rank": traces["expsum_rank"].tolist(),
        }
        if verbose:
            print(f"--- d={d} n={n} {'SPD' if symmetric else 'nonsym'} "
                  f"({wall:.1f}s, {ni/wall:.1f} it/s)", flush=True)
            print(summarize(res, every=max(ni // 8, 1)), flush=True)
        if out_dir:
            # incremental save: a long sweep interrupted mid-way keeps the
            # finished dimensions
            os.makedirs(out_dir, exist_ok=True)
            tag = "laplace" if symmetric else "convdiff"
            path = os.path.join(out_dir, f"reproduction_{tag}_n{n}.json")
            with open(path, "w") as f:
                json.dump(results, f)
            if verbose:
                print("saved", path)
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--dims", type=int, nargs="+", default=[5, 10, 50, 100])
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--tol", type=float, default=1e-9)
    p.add_argument("--nmax", type=int, default=None)
    p.add_argument("--nonsym", action="store_true")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--tmax", type=int, default=601)
    args = p.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    run_reproduction(
        args.dims, args.n, args.tol, args.nmax, not args.nonsym, out_dir=args.out,
        tmax=args.tmax,
    )
