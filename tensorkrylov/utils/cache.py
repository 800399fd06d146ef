"""Persistent XLA compilation cache helper.

Solver programs take seconds to minutes to compile; the persistent cache
makes re-runs (tests, benchmarks, experiments, resumed jobs) start warm.

Where the cache lives: `JAX_COMPILATION_CACHE_DIR` if it is set (JAX itself
reads that variable, and no other directory is set here); otherwise a fixed
`.jax_cache/` at the checkout root. A fixed path matters: the path is part of
the cache's key, so a directory that moves never hits.
"""
from __future__ import annotations

import os

import jax

__all__ = ["cache_dir", "enable_compilation_cache", "DEFAULT_DIR"]

CHECKOUT_DIR = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT_DIR, ".jax_cache")


def cache_dir() -> str:
    """The compile-cache directory this process uses (see module doc)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compilation_cache(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent compilation cache at cache_dir(); programs
    that compile faster than min_compile_secs are not cached. Returns the
    directory."""
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    return path
