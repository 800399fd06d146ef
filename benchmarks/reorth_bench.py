"""Reorthogonalization cadence cost at flagship scale: plain vs auto vs
always-on (VERDICT r1 item 6 — record which wins at n ≥ 1e5).

Steps-only segments at a mid-buffer k (so the always-on/auto prefix sweeps
pay a realistic k·d·n GEMM), two-point slope timing.

Run (GPU): python benchmarks/reorth_bench.py
"""
import time

import numpy as np


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import tensorkrylov as tk
    from tensorkrylov.ops.orth import init_state, lanczos_step
    from tensorkrylov.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    print("backend:", jax.default_backend(), flush=True)

    d, n, K = 10, 131072, 64
    op = tk.laplace(d, n, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal((d, n)), jnp.float32)
    b = b / jnp.linalg.norm(b, axis=1, keepdims=True)

    results = {}
    for mode, reorth in (("plain", False), ("auto", "auto"), ("always", True)):

        @jax.jit
        def seg(op, b, state, m):
            def body(i, st):
                k = 1 + (K // 2 + i) % (K // 2)  # stay mid-buffer: k ∈ [K/2, K)
                st2, _ = lanczos_step(
                    op, st, b, k, reorth=reorth, proj_dtype=jnp.float64
                )
                return st2

            return jax.lax.fori_loop(0, m, body, state)

        state0, _ = init_state(op, b, K, jnp.float64, jnp.float32)

        def timed(m):
            mj = jnp.asarray(m, jnp.int32)
            float(jnp.sum(seg(op, b, state0, mj).beta))
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                float(jnp.sum(seg(op, b, state0, mj).beta))
                best = min(best, time.perf_counter() - t0)
            return best

        m1, m2 = 32, 128
        dt1, dt2 = timed(m1), timed(m2)
        per_step = (dt2 - dt1) / (m2 - m1) if dt2 > 1.2 * dt1 else dt2 / m2
        results[mode] = per_step
        print(f"{mode}: {per_step*1e3:.3f} ms/step ({1/per_step:.0f} steps/s)",
              flush=True)

    base = results["plain"]
    for mode in ("auto", "always"):
        print(f"{mode} overhead vs plain: {results[mode]/base:.2f}x", flush=True)


if __name__ == "__main__":
    main()
