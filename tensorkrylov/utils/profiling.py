"""Profiling hooks.

The reference has no tracing/profiling (SURVEY.md §5 — BenchmarkTools is an
unused dependency). Here: a context manager around jax.profiler for
TensorBoard-viewable device traces, and a compiled-cost introspection helper.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import jax

__all__ = ["device_trace", "timed_block", "compiled_cost"]


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a device trace viewable in TensorBoard/XProf:

        with device_trace('/tmp/tk_trace'):
            tk.solve(op, b, cfg).status.block_until_ready()
    """
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed_block(label: str, results: Optional[dict] = None):
    """Wall-clock a block (blocks on async dispatch only if the caller does)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if results is not None:
            results[label] = dt
        else:
            print(f"[{label}] {dt:.4f}s")


def compiled_cost(fn, *args, static_argnames=()):
    """FLOP/bytes estimates from XLA's cost analysis for a jitted call."""
    lowered = jax.jit(fn, static_argnames=static_argnames).lower(*args)
    compiled = lowered.compile()
    try:
        ca = compiled.cost_analysis()
        if isinstance(ca, list):
            ca = ca[0]
        return {
            "flops": ca.get("flops"),
            "bytes_accessed": ca.get("bytes accessed"),
        }
    except Exception as e:  # cost analysis unsupported on some backends
        return {"error": str(e)}
