"""SpMV throughput and mode-axis scaling measurement.

Methodology: lax.scan of dependent applies (prevents cross-apply stencil
fusion), two-point slope (m and 4m iterations) to cancel fixed dispatch
overhead — required when the device sits behind a high-latency link.

Run: python benchmarks/spmv_scaling.py [--cpu] [--devices N]
"""
import argparse
import time

import numpy as np


def measure(fn, op, v, iters, jax, jnp):
    def many(o, x, m):
        c = jnp.asarray(1.0 / (4.0 * (op.n + 1) ** 2), x.dtype)

        def body(xc, _):
            return fn(o, xc) * c, ()

        out, _ = jax.lax.scan(body, x, None, length=m)
        return out

    def timed(m):
        g = jax.jit(lambda o, x: many(o, x, m))
        g(op, v).block_until_ready()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            g(op, v).block_until_ready()
            best = min(best, time.perf_counter() - t0)
        return best

    dt1, dt2 = timed(iters), timed(4 * iters)
    nnz = op.d * op.nnz_per_factor
    return nnz * 3 * iters / max(dt2 - dt1, 1e-12)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--devices", type=int, default=0, help="also measure sharded over N devices")
    p.add_argument("--d", type=int, default=8)
    p.add_argument("--log2n", type=int, default=20)
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--weak-scaling", action="store_true", help="weak-scaling efficiency sweep over 1..all devices")
    p.add_argument("--comm", default="gspmd", choices=["gspmd", "ring"],
                   help="sharded SpMV lowering: GSPMD-inferred collectives or "
                        "the explicit overlapped shard_map+ppermute halo path")
    p.add_argument("--out", default=None, help="write the sweep to this JSON file")
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from tensorkrylov.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import jax.numpy as jnp
    import tensorkrylov as tk
    from tensorkrylov.ops.banded import spmv

    d, n = args.d, 1 << args.log2n
    op = tk.laplace(d, n, dtype=jnp.float32)
    v = jnp.asarray(np.random.default_rng(0).standard_normal((d, n)), jnp.float32)

    g = measure(spmv, op, v, args.iters, jax, jnp)
    print(f"single-device: {g/1e9:.1f} Gnnz/s", flush=True)

    if args.devices > 1:
        from tensorkrylov.parallel import make_mesh, shard_operator, shard_rhs

        mesh = make_mesh(args.devices)
        op_s = shard_operator(op, mesh)
        v_s = shard_rhs(v, mesh)
        gs = measure(spmv, op_s, v_s, args.iters, jax, jnp)
        print(
            f"{args.devices}-device GSPMD: {gs/1e9:.1f} Gnnz/s "
            f"({gs/g/args.devices*100:.0f}% scaling efficiency)"
        )

    if args.weak_scaling:
        weak_scaling(args, jax, jnp, tk, spmv)


def weak_scaling(args, jax, jnp, tk, spmv):
    """Weak-scaling protocol (BASELINE.json config 5, ≥80% target): per-mode
    rows per device held constant at n = 2^log2n, total problem grows with
    the device count; report nnz/s and efficiency vs 1 device × D.

    On several GPUs this measures real halo overlap; on the CPU backend (8
    virtual devices) it validates the protocol and the collective layout.
    """
    import dataclasses
    import json

    import numpy as np

    from tensorkrylov.parallel import make_mesh, shard_operator, shard_rhs

    d, n_per = args.d, 1 << args.log2n
    base = None
    results = {}
    D = 1
    while D <= len(jax.devices()):
        n = n_per * D
        op = tk.laplace(d, n, dtype=jnp.float32)
        v = jnp.asarray(
            np.random.default_rng(0).standard_normal((d, n)), jnp.float32
        )
        mesh = make_mesh(D)
        op_s = shard_operator(op, mesh)
        if args.comm == "ring" and D > 1:
            op_s = dataclasses.replace(op_s, halo=(mesh, "mode", None))
        gs = measure(spmv, op_s, shard_rhs(v, mesh), args.iters, jax, jnp)
        if base is None:
            base = gs
        eff = gs / (base * D)
        results[D] = (gs, eff)
        print(f"weak-scaling D={D}: n={n} {gs/1e9:.1f} Gnnz/s "
              f"(eff {eff*100:.0f}%)", flush=True)
        D *= 2
    if args.out:
        payload = {
            "protocol": "weak-scaling: rows/device fixed at 2^log2n, problem "
                        "grows with D; efficiency = nnz/s / (D * 1-device nnz/s)",
            "backend": jax.default_backend(),
            "comm": args.comm,
            "d": d, "log2n_per_device": args.log2n, "iters": args.iters,
            "results": {
                str(D): {"nnz_per_s": g, "efficiency": e}
                for D, (g, e) in results.items()
            },
        }
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
        print("saved", args.out, flush=True)
    return results


if __name__ == "__main__":
    main()
