"""Factor-SpMV and Lanczos-step throughput — prints ONE JSON line.

Metric: batched factor SpMV throughput (Gnnz/s) on the accelerator — hot
kernel #1 of the tensorized Krylov solver (the reference's per-factor sparse
mul!, /root/reference/src/orthogonal_bases.jl:20,45) — as XLA compiles the
plain jnp stencil. vs_baseline compares against the native multithreaded
banded SpMV on this host's CPU (csrc/tkcore.cpp — a stand-in for the
reference's single-process CPU execution model).

Extra fields: the XLA Lanczos step loop (SpMV + reductions + axpys +
normalize) at the same shape, achieved bytes/s counted as 5·d·n f32 per SpMV
apply, and solver iteration throughput (full pipeline incl. eigh + exp-sum +
residual, f64). Everything runs in this one process; with no accelerator the
script exits non-zero.

Run:  python bench.py
"""
import json
import sys
import time

import numpy as np


SPMV_D, SPMV_N = 8, 1 << 20


def spmv_bytes(d: int, n: int, elem: int = 4) -> int:
    """HBM bytes of one streamed tridiagonal SpMV apply: 3 bands + v in,
    u out (5 arrays of d·n elements)."""
    return 5 * d * n * elem


def two_point_slope(timed, m1: int, m2: int):
    """Seconds per iteration from two iteration counts (cancels fixed
    dispatch/launch cost). Falls back to the total-time estimate at m2 when
    the slope is degenerate (dispatch noise ≈ kernel time)."""
    dt1, dt2 = timed(m1), timed(m2)
    if dt2 > 1.2 * dt1:
        return (dt2 - dt1) / (m2 - m1)
    return dt2 / m2


def bench_spmv(tk, jax, jnp, d=SPMV_D, n=SPMV_N, iters=200):
    """Seconds per apply of the XLA banded SpMV (f32 Laplace, d×n) and the
    nonzeros per apply."""
    from tensorkrylov.ops.banded import spmv

    op = tk.laplace(d, n, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.standard_normal((d, n)), jnp.float32)

    # lax.scan keeps iterations as separate kernel invocations (no
    # cross-apply stencil fusion) — an honest repeated-SpMV measurement
    def many(o, x, m):
        c = jnp.asarray(1.0 / (4.0 * (n + 1) ** 2), x.dtype)  # ~1/λ_max

        def body(xc, _):
            # constant rescale (fuses into the adds) keeps values finite
            return spmv(o, xc) * c, ()

        out, _ = jax.lax.scan(body, x, None, length=m)
        return out

    def timed(m):
        g = jax.jit(lambda o, x: jnp.sum(many(o, x, m)[:, :: 1 << 12]))
        float(g(op, v))  # compile
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            float(g(op, v))
            best = min(best, time.perf_counter() - t0)
        return best

    return two_point_slope(timed, iters, 4 * iters), d * op.nnz_per_factor


def bench_lanczos_step(tk, jax, jnp, d=SPMV_D, n=SPMV_N, S1=8, S2=64):
    """Seconds per complete plain f32 Lanczos step (SpMV + α/β reductions +
    axpys + normalize), XLA-compiled scan, two-point slope over steps."""
    from tensorkrylov.ops.banded import spmv
    from tensorkrylov.ops.orth import bdot

    op = tk.laplace(d, n, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    b = rng.standard_normal((d, n)).astype(np.float32)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    vp = jnp.asarray(b)
    vpp = jnp.zeros_like(vp)
    beta = jnp.zeros((d,), jnp.float32)

    def steps(vp, vpp, beta, S):
        def body(carry, _):
            vp, vpp, beta = carry
            u = spmv(op, vp) - beta[:, None] * vpp
            alpha = bdot(u, vp)
            u = u - alpha[:, None] * vp
            bnew = jnp.sqrt(bdot(u, u))
            return (u / bnew[:, None], vp, bnew), ()

        (vp, _, beta), _ = jax.lax.scan(body, (vp, vpp, beta), None, length=S)
        return vp, beta

    run = jax.jit(steps, static_argnames=("S",))

    def timed(S):
        jax.block_until_ready(run(vp, vpp, beta, S))
        t0 = time.perf_counter()
        for _ in range(3):
            out = run(vp, vpp, beta, S)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / 3

    return two_point_slope(timed, S1, S2)


def _bench_spmv_cpu(d=SPMV_D, n=SPMV_N, iters=10):
    """Host-CPU baseline: the native (C++, multithreaded) banded SpMV from
    csrc/tkcore.cpp. Falls back to numpy if the toolchain is absent."""
    from tensorkrylov import native

    rng = np.random.default_rng(0)
    h2 = np.float32((n + 1) ** 2)
    bands = np.zeros((d, 3, n), np.float32)
    bands[:, 0, 1:] = -h2
    bands[:, 1, :] = 2 * h2
    bands[:, 2, :-1] = -h2
    v = rng.standard_normal((d, n)).astype(np.float32)

    native.banded_spmv(bands, (-1, 0, 1), v)  # warm up / build
    t0 = time.perf_counter()
    x = v
    for _ in range(iters):
        x = native.banded_spmv(bands, (-1, 0, 1), x)
    dt = time.perf_counter() - t0
    nnz = d * (3 * n - 2)
    return nnz * iters / dt / 1e9


def _bench_solver_iterations(tk, jax, jnp):
    """Full solver pipeline iterations/sec (d=5 Laplace, f64, kmax=64)."""
    from tensorkrylov.types import SolverConfig

    d, n = 5, 4096
    # force kmax iterations; production cadence (check_every=8)
    cfg = SolverConfig(kmax=64, tol=1e-30, check_every=8, identical_factors=True)
    op = tk.laplace(d, n)
    b = tk.random_rhs(d, n, seed=0)
    b = b / jnp.linalg.norm(b, axis=1, keepdims=True)
    r = tk.solve(op, b, cfg)  # compile + run
    int(r.status)
    t0 = time.perf_counter()
    r = tk.solve(op, b, cfg)
    ni = int(r.niterations)
    dt = time.perf_counter() - t0
    return ni / dt


def main():
    import jax

    from tensorkrylov.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import tensorkrylov as tk

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        print("bench.py: no accelerator found (jax.devices() is CPU only)",
              file=sys.stderr)
        sys.exit(2)
    t_spmv, nnz = bench_spmv(tk, jax, jnp)
    t_step = bench_lanczos_step(tk, jax, jnp)
    cpu_gnnz = _bench_spmv_cpu()
    iters_per_s = _bench_solver_iterations(tk, jax, jnp)
    gnnz = nnz / t_spmv / 1e9
    nbytes = spmv_bytes(SPMV_D, SPMV_N)

    print(
        json.dumps(
            {
                "metric": "factor_spmv_throughput",
                "value": gnnz,
                "unit": "Gnnz/s",
                "vs_baseline": gnnz / cpu_gnnz,
                "extra": {
                    "device": {"platform": dev.platform,
                               "kind": dev.device_kind,
                               "count": len(jax.devices())},
                    "spmv_config": "d=8 tridiag n=2^20 f32",
                    "spmv_s_per_apply": t_spmv,
                    "spmv_bytes_per_s": nbytes / t_spmv,
                    "lanczos_step_s": t_step,
                    "lanczos_step_gnnz_s": nnz / t_step / 1e9,
                    "cpu_native_gnnz_s": cpu_gnnz,
                    "solver_iters_per_s_f64": iters_per_s,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
