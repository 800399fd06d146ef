"""Command-line interface.

    python -m tensorkrylov solve --gallery laplace --d 5 --n 200 --tol 1e-9
    python -m tensorkrylov reproduce --dims 5 10 --n 200
    python -m tensorkrylov info
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _common(p):
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    p.add_argument("--f32", action="store_true", help="f32 basis (projected algebra stays f64)")


def cmd_solve(args):
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import tensorkrylov as tk
    from tensorkrylov.convergence import summarize, to_json

    if args.gallery == "laplace":
        op = tk.laplace(args.d, args.n)
        orth = args.orth or "lanczos_reorth"
    elif args.gallery == "convdiff":
        op = tk.conv_diff(args.d, args.n, c=args.convection)
        orth = "arnoldi"
    elif args.gallery == "randspd":
        op = tk.rand_spd(args.d, args.n, seed=args.seed)
        orth = args.orth or "lanczos_reorth"
    else:
        raise SystemExit(f"unknown gallery {args.gallery!r}")

    b = tk.random_rhs(args.d, args.n, seed=args.seed)
    b = b / jnp.linalg.norm(b, axis=1, keepdims=True)
    cfg = tk.SolverConfig(
        kmax=args.kmax or args.n,
        tol=args.tol,
        orth=orth,
        check_every=args.check_every,
        tmax=args.tmax,
        basis_dtype=jnp.float32 if args.f32 else jnp.float64,
    )
    t0 = time.perf_counter()
    res = tk.solve(op, b, cfg)
    int(res.status)
    wall = time.perf_counter() - t0
    print(summarize(res))
    print(f"wall: {wall:.2f}s")
    if args.json:
        with open(args.json, "w") as f:
            f.write(to_json(res))
        print("traces written to", args.json)
    return 0 if int(res.status) == 1 else 2


def cmd_reproduce(args):
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from tensorkrylov.experiments.reproduction import run_reproduction

    run_reproduction(args.dims, args.n, args.tol, symmetric=not args.nonsym, out_dir=args.out)
    return 0


def cmd_info(args):
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import tensorkrylov as tk
    from tensorkrylov import native

    print(
        json.dumps(
            {
                "version": tk.__version__,
                "backend": jax.default_backend(),
                "devices": [str(d) for d in jax.devices()],
                "native_runtime": native.available(),
            },
            indent=2,
        )
    )
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="tensorkrylov")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("solve", help="solve a gallery Kronecker-sum system")
    ps.add_argument("--gallery", default="laplace", choices=["laplace", "convdiff", "randspd"])
    ps.add_argument("--d", type=int, default=5)
    ps.add_argument("--n", type=int, default=200)
    ps.add_argument("--tol", type=float, default=1e-9)
    ps.add_argument("--kmax", type=int, default=None)
    ps.add_argument("--orth", default=None, choices=[None, "lanczos", "lanczos_reorth", "arnoldi"])
    ps.add_argument("--check-every", type=int, default=1)
    ps.add_argument("--tmax", type=int, default=63)
    ps.add_argument("--convection", type=float, default=10.0)
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--json", default=None, help="write traces to this path")
    _common(ps)
    ps.set_defaults(fn=cmd_solve)

    pr = sub.add_parser("reproduce", help="reference reproduction sweep")
    pr.add_argument("--dims", type=int, nargs="+", default=[5, 10, 50, 100])
    pr.add_argument("--n", type=int, default=200)
    pr.add_argument("--tol", type=float, default=1e-9)
    pr.add_argument("--nonsym", action="store_true")
    pr.add_argument("--out", default=None)
    _common(pr)
    pr.set_defaults(fn=cmd_reproduce)

    pi = sub.add_parser("info", help="environment info")
    _common(pi)
    pi.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
