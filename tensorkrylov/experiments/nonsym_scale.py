"""Nonsymmetric (convection–diffusion) solve at scale.

d=10, n >= 1e4 shifted ConvDiff, Arnoldi (CGS2) + Stenger sinc-quadrature
exp-sum, certified by the analytic eps*kappa bound (solver.py:projected_step:
below the f64 cancellation floor the compressed residual is replaced by
||Hy-b~|| <= eps*kappa*||b~||, a rigorous nonsym exp-sum bound). The
reference's nonsym experiments stop at n=200 (/root/reference/experiments/
reproduction.jl:16-20); the shift sigma is the reaction term that makes an
n>=1e4 mode reachable by ANY Krylov method (unshifted ConvDiff at n=1e4 has
kappa ~ 4e7 -> k* ~ 2e4; the reference never faced this because n=200 caps
kappa at ~1.6e4).

Arnoldi memory strategy: FULL basis storage. The (K, d, n) f64 basis costs
K*d*n*8 bytes: at the largest planned nonsym shape (d=10, n=1e5, K<=512)
that is 4.1 GB resident — well inside one accelerator's memory, so no
restart scheme is needed at target scales. Restarted
Arnoldi (thick restart / FOM-restart) is REJECTED for now: a restarted
projected operator is no longer one Hessenberg matrix of the full space,
which breaks the exp-sum residual identity the certificate is built on;
a two-pass Arnoldi analogue does not exist (the recurrence needs the full
prefix). If n beyond ~1e6 is ever needed, mode-sharding the basis
(parallel/sharding.py) is the supported scaling axis, not restarts.

Run (GPU):  python -m tensorkrylov.experiments.nonsym_scale
CPU smoke:  python -m tensorkrylov.experiments.nonsym_scale --cpu --n 512 --kappa 1e3 --kmax 120

`nonsym_problem` and `solve_nonsym` are the recipe; `main` is its CLI and
`chip_smoke.py` calls the same functions.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .northstar import interpret_cross_check, sigma_for_kappa


def nonsym_problem(d: int, n: int, c: float, kappa: float, seed: int):
    """(op, b, sigma): shifted ConvDiff at condition number ~kappa with a
    rank-1 random RHS normalized per factor."""
    import jax.numpy as jnp

    import tensorkrylov as tk

    sigma = sigma_for_kappa(n, kappa)
    op = tk.conv_diff(d, n, c=c, shift=sigma)
    b = tk.random_rhs(d, n, seed=seed)
    b = b / jnp.linalg.norm(b, axis=1, keepdims=True)
    return op, b, sigma


def solve_nonsym(op, b, *, kmax: int, tol: float, tmax: int,
                 check_every: int, host_projected: bool = False):
    """Arnoldi + Stenger solve and its basis-free cross-check (on device,
    pulling only the small residual Gram). Returns a dict with the result,
    the last recorded estimate, the cross-check and its floor."""
    import jax

    import tensorkrylov as tk
    from tensorkrylov.utils.cp import cp_residual_cross_check_device

    cfg = tk.SolverConfig(kmax=kmax, tol=tol, orth="arnoldi", tmax=tmax,
                          check_every=check_every)
    t0 = time.perf_counter()
    solver = tk.solve_host_projected if host_projected else tk.solve
    res = solver(op, b, cfg)
    jax.block_until_ready(res.x.weights)
    t_solve = time.perf_counter() - t0
    k = int(res.niterations)
    # residuals are recorded at check_every cadence — take the last finite
    hist = np.asarray(res.relative_residual)[: k + 1]
    fin = np.flatnonzero(np.isfinite(hist))
    k_rec = int(fin[-1]) if fin.size else k
    check = cp_residual_cross_check_device(
        op, np.asarray(res.x.weights, np.float64), res.x.factors, b)
    b_norm = float(np.prod(np.linalg.norm(np.asarray(b), axis=1)))
    return {
        "result": res, "niterations": k, "solve_s": t_solve,
        "relative_residual": float(hist[k_rec]),
        "expsum_rank": int(np.asarray(res.expsum_rank)[k_rec]),
        "measured_cp_residual": check.value / b_norm,
        "cp_residual_floor": check.floor / b_norm,
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--d", type=int, default=10)
    p.add_argument("--n", type=int, default=16384)
    p.add_argument("--c", type=float, default=10.0, help="convection strength")
    p.add_argument("--kappa", type=float, default=1e4,
                   help="target condition number of the shifted operator")
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--kmax", type=int, default=384)
    p.add_argument("--tmax", type=int, default=801)
    p.add_argument("--check-every", type=int, default=16)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--host-projected", action="store_true",
                   help="run via solve_host_projected (host-driven "
                        "check_every segments, projected stage on the "
                        "host CPU)")
    p.add_argument("--out", default=None)
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from tensorkrylov.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    print("backend:", jax.default_backend(), flush=True)

    op, b, sigma = nonsym_problem(args.d, args.n, args.c, args.kappa,
                                  args.seed)
    r = solve_nonsym(op, b, kmax=args.kmax, tol=args.tol, tmax=args.tmax,
                     check_every=args.check_every,
                     host_projected=args.host_projected)
    res, k, t_solve = r["result"], r["niterations"], r["solve_s"]
    rel = r["relative_residual"]
    print(f"status={res.status} k={k} rel={rel:.3e} rank={r['expsum_rank']} "
          f"{t_solve:.1f}s ({k / t_solve:.1f} it/s)", flush=True)
    meas, floor = r["measured_cp_residual"], r["cp_residual_floor"]
    interp = interpret_cross_check(meas, floor, rel, args.tol)
    print(f"cross-check {meas:.3e} (floor {floor:.3e}; {interp})", flush=True)

    out = args.out or os.path.join(
        os.path.dirname(__file__), "data",
        f"nonsym_scale_d{args.d}_n{args.n}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump({
            "problem": {"family": "conv_diff + sigma*I", "d": args.d,
                        "n": args.n, "c": args.c, "sigma": sigma,
                        "kappa_target": args.kappa, "tol": args.tol,
                        "seed": args.seed},
            "recipe": {"orth": "arnoldi (CGS2, full basis)",
                       "expsum": "stenger sinc", "tmax": args.tmax,
                       "kmax": args.kmax,
                       "memory_strategy": "full basis (see module docstring: "
                       "restarts rejected — they break the exp-sum residual "
                       "identity; mode sharding is the scaling axis)"},
            "result": {"status": int(res.status), "converged":
                       int(res.status) == 1, "niterations": k,
                       "relative_residual": rel,
                       "expsum_rank": r["expsum_rank"],
                       "measured_cp_residual": meas,
                       "cp_residual_floor": floor,
                       "cp_residual_interpretation": interp},
            "timing": {"backend": jax.default_backend(), "solve_s": t_solve,
                       "iterations_per_s": k / t_solve},
        }, f, indent=1)
    print("saved", out, flush=True)


if __name__ == "__main__":
    main()
