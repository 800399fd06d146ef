"""Synthetic-spectrum (eigenvalue-distribution) experiments.

Rebuild of /root/reference/experiments/eigenvalue_distribution.jl: study how
Krylov convergence depends on the spectrum of the factors, using diagonal
(EigValMat) operators with prescribed eigenvalue families:

  * clusterzero: λ_j = j²/n²          (cluster at 0, κ = n²)
  * clusterone : λ_1 = 1/n², λ_j = log j / log n  (cluster at 1)
  * uniform    : λ_j equispaced on an interval, with per-factor shifts of
                 (s−1)·Δ/d so the d factors interleave

plus the perturbed-spectrum variant (factor s shifted by s·ε) and explicit
Kronecker-sum spectrum enumeration for the histograms.

Run: python -m tensorkrylov.experiments.eigenvalue_distribution
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import time
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import eigval_matrix, random_rhs, solve
from ..convergence import trim
from ..types import SolverConfig

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "data")

__all__ = [
    "clusterzero",
    "clusterone",
    "uniform_eigenvalues",
    "perturb_eigenvalues",
    "kronsum_spectrum",
    "eigenvalue_experiment",
    "uniform_experiment",
]


def clusterzero(n: int) -> np.ndarray:
    """λ_j = j²/n² — /root/reference/experiments/eigenvalue_distribution.jl:105-111."""
    j = np.arange(1, n + 1, dtype=np.float64)
    return j**2 / n**2


def clusterone(n: int) -> np.ndarray:
    """λ_1 = 1/n², λ_j = log j/log n — /root/reference/experiments/eigenvalue_distribution.jl:113-133."""
    vals = np.log(np.arange(1, n + 1, dtype=np.float64)) / np.log(n)
    vals[0] = 1.0 / n**2
    return vals


def uniform_eigenvalues(n: int, d: int, interval: Tuple[float, float]) -> np.ndarray:
    """(d, n) interleaved uniform spectra — factor s shifted by (s−1)·Δ/d
    (/root/reference/experiments/eigenvalue_distribution.jl:155-187)."""
    base = np.linspace(interval[0], interval[1], n)
    step = base[1] - base[0]
    return np.stack([base + (s * step / d) for s in range(d)])


def perturb_eigenvalues(eigenvalues, d: int, eps: float) -> np.ndarray:
    """(d, n): factor s gets λ + (s+1)·ε
    (/root/reference/experiments/eigenvalue_distribution.jl:44-58, 1-based)."""
    ev = np.asarray(eigenvalues, dtype=np.float64)
    return np.stack([ev + (s + 1) * eps for s in range(d)])


def kronsum_spectrum_multiset(eigenvalues, d: int):
    """Distinct Kronecker-sum eigenvalues for d IDENTICAL factors, as
    (values, multiplicities) — the multiset-combination enumeration the
    reference uses (possiblesums/EVC/EVReps,
    /root/reference/src/eigenvalues.jl:208-224): C(n+d-1, d) entries instead
    of n^d."""
    import itertools
    import math

    ev = np.asarray(eigenvalues, dtype=np.float64)
    n = len(ev)
    values = []
    counts = []
    for combo in itertools.combinations_with_replacement(range(n), d):
        values.append(ev[list(combo)].sum())
        # multiplicity = multinomial coefficient d! / Π m_i!
        mult = math.factorial(d)
        for _, g in itertools.groupby(combo):
            mult //= math.factorial(len(list(g)))
        counts.append(mult)
    order = np.argsort(values)
    return np.asarray(values)[order], np.asarray(counts)[order]


def kronsum_spectrum(per_factor: np.ndarray, limit: int = 2_000_000) -> np.ndarray:
    """Explicit spectrum of the Kronecker sum: all Σ_s λ^{(s)}_{i_s}
    (n^d values — histogram/analysis use only;
    /root/reference/experiments/eigenvalue_distribution.jl:35-41,189-196)."""
    d, n = per_factor.shape
    if n**d > limit:
        raise ValueError(f"n^d = {n**d} exceeds limit {limit}")
    total = np.zeros((1,))
    for s in range(d):
        total = (total[:, None] + per_factor[s][None, :]).reshape(-1)
    return total


def _run_family(name, eigenvalues_fn, dims, n, tol, nmax, seed, verbose):
    out = {}
    for d in dims:
        ev = eigenvalues_fn(d)
        op = eigval_matrix(ev if ev.ndim == 2 else ev, d=None if ev.ndim == 2 else d)
        b = random_rhs(d, n, seed=seed)
        b = b / jnp.linalg.norm(b, axis=1, keepdims=True)
        cfg = SolverConfig(kmax=nmax or n, tol=tol, orth="lanczos_reorth")
        t0 = time.perf_counter()
        res = solve(op, b, cfg)
        wall = time.perf_counter() - t0
        ni = int(res.niterations)
        tr = trim(res)
        out[d] = {
            "status": int(res.status),
            "niterations": ni,
            "wall_s": wall,
            "final_relative_residual": float(tr["relative_residual"][-1]),
            "relative_residual": tr["relative_residual"].tolist(),
        }
        if verbose:
            print(
                f"{name} d={d}: status={int(res.status)} niter={ni} "
                f"final={out[d]['final_relative_residual']:.2e} ({wall:.1f}s)"
            )
    return out


def eigenvalue_experiment(
    dims: Sequence[int] = (5, 10, 50, 100),
    n: int = 200,
    tol: float = 1e-9,
    nmax: Optional[int] = None,
    eps: float = 0.0,
    seed: int = 1234,
    verbose: bool = True,
):
    """clusterzero + clusterone families, optionally perturbed per factor
    (/root/reference/experiments/eigenvalue_distribution.jl:135-151)."""
    results = {}
    for name, fam in (("clusterzero", clusterzero), ("clusterone", clusterone)):
        base = fam(n)

        def ev_fn(d, base=base):
            return perturb_eigenvalues(base, d, eps) if eps else base

        results[name] = _run_family(name, ev_fn, dims, n, tol, nmax, seed, verbose)
    return results


def uniform_experiment(
    dims: Sequence[int] = (5, 10, 50, 100),
    n: int = 200,
    interval: Tuple[float, float] = (1.0, 100.0),
    tol: float = 1e-9,
    nmax: Optional[int] = None,
    seed: int = 1234,
    verbose: bool = True,
):
    """Interleaved-uniform spectra
    (/root/reference/experiments/eigenvalue_distribution.jl:219-233)."""
    return {
        "uniform": _run_family(
            "uniform",
            lambda d: uniform_eigenvalues(n, d, interval),
            dims, n, tol, nmax, seed, verbose,
        )
    }


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--dims", type=int, nargs="+", default=[5, 10, 50, 100])
    p.add_argument("--n", type=int, default=200)
    p.add_argument("--tol", type=float, default=1e-9)
    p.add_argument("--eps", type=float, default=0.0)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    results = eigenvalue_experiment(args.dims, args.n, args.tol, eps=args.eps)
    results.update(uniform_experiment(args.dims, args.n))
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"eigenvalue_distribution_n{args.n}.json")
    with open(path, "w") as f:
        json.dump(results, f)
    print("saved", path)
