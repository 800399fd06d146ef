"""BASELINE.json config 4: rank-R tensor-product RHS at scale via
block/global tensorized Krylov (d=10, n_s=1e4).

Runs solve_block (ONE shared block-Krylov space per factor) against the
separable comparison solve_multi_rhs (R independent vmapped rank-1 solves)
on the same system, records matvec counts, wall-clock, the Lemma-3.4
estimates and the basis-free CP cross-check for both, and writes a JSON
artifact.

Why no deflation here: solve_deflated is a rank-1-RHS solver; composing it
with the block path would need per-step U-projection inside the block
recurrence (not implemented — documented gap). Instead the problem's
condition number is set via the reaction-diffusion shift so the NON-deflated
block Krylov converges in f64 (k* ~ 2.8 sqrt(kappa) block iterations), which
is the regime config 4 describes.

Run (GPU):  python -m tensorkrylov.experiments.config4_block --n 10240
CPU smoke:  python -m tensorkrylov.experiments.config4_block --cpu --n 512 --kappa 1e3 --kmax 120
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .northstar import interpret_cross_check, sigma_for_kappa


def block_problem(d: int, n: int, kappa: float, rank: int, seed: int):
    """(op, B, sigma): reaction–diffusion at condition number kappa and a
    rank-R RHS B (R, d, n) with unit factor rows."""
    import jax.numpy as jnp

    import tensorkrylov as tk

    sigma = sigma_for_kappa(n, kappa)
    op = tk.reaction_diffusion(d, n, sigma=sigma)
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((rank, d, n))
    B /= np.linalg.norm(B, axis=2, keepdims=True)
    return op, jnp.asarray(B), sigma


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--d", type=int, default=10)
    p.add_argument("--n", type=int, default=10_000)
    p.add_argument("--kappa", type=float, default=1e4)
    p.add_argument("--rank", type=int, default=4)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--kmax", type=int, default=360, help="block iterations")
    p.add_argument("--check-every", type=int, default=8,
                   help="residual-evaluation cadence (each check pays a "
                        "dense eigh of the (d, kR, kR) projected batch)")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--skip-multi", action="store_true",
                   help="skip the vmapped-comparison run")
    p.add_argument("--recorded", action="store_true",
                   help="use solve_block_recorded: the noise-recording "
                        "block recurrence with a certified bound, run in "
                        "host-driven segments")
    p.add_argument("--final", default="auto",
                   choices=["auto", "host", "device"],
                   help="(--recorded) assembly/cross-check location")
    p.add_argument("--segment", type=int, default=8,
                   help="(--recorded) block steps per device call")
    p.add_argument("--m", type=int, default=0,
                   help="(--recorded) per-factor deflation rank composed "
                        "with the block recurrence (r5: kappa_eff "
                        "reduction for rank-R RHS)")
    p.add_argument("--out", default=None)
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import tensorkrylov as tk
    from tensorkrylov.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    print("backend:", jax.default_backend(), flush=True)

    op, B, sigma = block_problem(args.d, args.n, args.kappa, args.rank,
                                 args.seed)

    cfg = tk.SolverConfig(kmax=args.kmax, tol=args.tol,
                          check_every=args.check_every,
                          orth="lanczos_reorth", spectral_source="H")

    # ‖b‖ of the rank-R RHS via the per-mode Gram (host longdouble)
    B_np = np.asarray(B, np.float64)
    Gb = np.einsum("rsn,qsn->srq", B_np, B_np).astype(np.longdouble)
    b_norm = float(np.sqrt(max(float(np.prod(Gb, axis=0).sum()), 0.0)))

    def evidence(x, label):
        from tensorkrylov.utils.cp import cp_residual_cross_check_host_rankR

        check = cp_residual_cross_check_host_rankR(
            np.asarray(op.bands, np.float64), op.offsets,
            np.asarray(x.weights, np.float64),
            np.asarray(x.factors, np.float64), B_np,
        )
        meas, floor = check.value / b_norm, check.floor / b_norm
        print(f"{label}: cross-check {meas:.3e} (floor {floor:.3e})",
              flush=True)
        return meas, floor

    # ---- block / global tensorized Krylov ----
    cert_extra = {}
    t0 = time.perf_counter()
    if args.recorded:
        # exact joint lambda_min: sigma shifts the analytic 1-D Laplace
        # spectrum, so lambda_min = d*(sigma + lmin_1d) — same closed form
        # sigma_for_kappa inverts
        n_ = args.n
        lmin_1d = 4.0 * (n_ + 1) ** 2 * np.sin(np.pi / (2 * (n_ + 1))) ** 2
        lam_min = args.d * (sigma + lmin_1d)
        rb = tk.solve_block_recorded(
            op, B, cfg, lam_min=lam_min, segment=args.segment,
            final=args.final, m=args.m, verbose=True)
        t_block = time.perf_counter() - t0
        est_b = rb.relative_residual[-1]
        mv_block = int(rb.niterations) * args.rank * args.d
        print(f"block(recorded): status={rb.status} k={rb.niterations} "
              f"blocks ({mv_block} matvecs) est={est_b:.3e} certified "
              f"{rb.certified_bound[-1]:.3e} {t_block:.1f}s", flush=True)
        meas_b, floor_b = rb.measured_cp_residual, rb.cp_residual_floor
        print(f"block(recorded): cross-check {meas_b} (floor {floor_b})",
              flush=True)
        cert_extra = {
            "certified_bound": rb.certified_bound,
            "checkpoints": rb.checkpoints,
            "expsum_sup": rb.expsum_sup,
            "sweep_overlap": rb.sweep_overlap,
            "gram_deviation": rb.gram_deviation,
            "relation_dev_term": rb.relation_dev_term,
            "relation_eta_term": rb.relation_eta_term,
            "relation_r2_term": rb.relation_r2_term,
            "perturbation_rho": rb.perturbation_rho,
            "lam_min_exact": lam_min,
            "deflation_m": args.m,
        }
    else:
        rb = tk.solve_block(op, B, cfg)
        jax.block_until_ready(rb.x.weights)
        t_block = time.perf_counter() - t0
        # the final evaluated entry: convergence lands ON a check step, so
        # index niterations is set; earlier non-check steps hold inf
        est_b = float(np.asarray(rb.relative_residual)[int(rb.niterations)])
        mv_block = int(rb.niterations) * args.rank * args.d
        print(f"block: status={rb.status} k={int(rb.niterations)} blocks "
              f"({mv_block} matvecs) est={est_b:.3e} {t_block:.1f}s",
              flush=True)
        meas_b, floor_b = evidence(rb.x, "block")

    out = {
        "problem": {
            "family": "reaction_diffusion", "d": args.d, "n": args.n,
            "sigma": sigma, "kappa": args.kappa, "rank": args.rank,
            "tol": args.tol, "seed": args.seed,
        },
        "block": {
            "solver": ("solve_block_recorded" if args.recorded
                       else "solve_block"),
            "status": int(rb.status), "block_iterations": int(rb.niterations),
            "matvecs": mv_block, "estimate": est_b,
            "measured_cp_residual": meas_b, "cp_residual_floor": floor_b,
            "interpretation": interpret_cross_check(
                meas_b, floor_b,
                cert_extra.get("certified_bound", [None])[-1], args.tol),
            "wall_s": t_block,
            **cert_extra,
        },
        "backend": jax.default_backend(),
        "note": ("kappa set so the block space at kmax covers convergence; "
                 + ("--recorded runs the noise-recording recurrence"
                    if args.recorded else "plain f64 block path")),
    }

    # persist the block evidence BEFORE the comparison run: a device fault
    # during the (optional) multi-RHS solve must not lose the artifact
    path = args.out or os.path.join(
        os.path.dirname(__file__), "data",
        f"config4_block_d{args.d}_n{args.n}_r{args.rank}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("saved (block-only)", path, flush=True)

    # ---- comparison: R independent vmapped rank-1 solves ----
    if not args.skip_multi:
        t0 = time.perf_counter()
        xm, rm = tk.solve_multi_rhs(op, B, cfg)
        jax.block_until_ready(xm.weights)
        t_multi = time.perf_counter() - t0
        iters = np.asarray(rm.niterations).astype(int)
        mv_multi = int(iters.sum()) * args.d
        print(f"multi: iters={iters.tolist()} ({mv_multi} matvecs) "
              f"{t_multi:.1f}s", flush=True)
        meas_m, floor_m = evidence(xm, "multi")
        out["multi_rhs"] = {
            "status": np.asarray(rm.status).astype(int).tolist(),
            "iterations": iters.tolist(), "matvecs": mv_multi,
            "measured_cp_residual": meas_m, "cp_residual_floor": floor_m,
            "wall_s": t_multi,
        }
        out["block_vs_multi_matvec_ratio"] = mv_block / max(mv_multi, 1)

    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print("saved", path, flush=True)


if __name__ == "__main__":
    main()
