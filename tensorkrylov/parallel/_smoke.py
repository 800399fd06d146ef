"""Multi-process smoke worker: one process of an N-process CPU pod running a
small sharded solve end-to-end. Used by tests/test_multihost.py (2-process
CPU smoke) and runnable by hand against a real pod (omit the explicit
process flags — init_distributed auto-discovers):

    python -m tensorkrylov.parallel._smoke \
        --coordinator localhost:12356 --num-processes 2 --process-id 0 \
        --local-devices 2

Prints one machine-readable line: SMOKE status niter rel_residual.
"""
from __future__ import annotations

import argparse


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--local-devices", type=int, default=None)
    p.add_argument("--d", type=int, default=4)
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--kmax", type=int, default=32)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()

    import jax

    if args.cpu:
        # before distributed init (which touches the backend): force the
        # CPU backend in-process
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from .multihost import init_distributed, make_pod_mesh

    init_distributed(
        args.coordinator, args.num_processes, args.process_id, args.local_devices
    )
    import jax.numpy as jnp
    import numpy as np

    import tensorkrylov as tk
    from .sharding import solve_sharded

    mesh = make_pod_mesh()  # 'factor' across processes, 'mode' on local devices
    op = tk.laplace(args.d, args.n)
    b = tk.random_rhs(args.d, args.n, seed=1)
    b = b / np.linalg.norm(np.asarray(b), axis=1, keepdims=True)

    res = solve_sharded(op, b, tk.SolverConfig(kmax=args.kmax, tol=args.tol), mesh)
    ni = int(res.niterations)
    rel = float(np.asarray(res.relative_residual)[ni])
    print(
        f"SMOKE {int(res.status)} {ni} {rel:.12e} "
        f"procs={jax.process_count()} devices={len(jax.devices())}",
        flush=True,
    )


if __name__ == "__main__":
    main()
