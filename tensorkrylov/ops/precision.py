"""The solver's contractions, with their precision pinned.

Two properties of GPUs make a bare jnp.einsum unsafe for this solver:

  * an f32 dot_general may run in TF32 (10-bit mantissa) unless it asks for
    precision=HIGHEST — which would silently break every algorithm here that
    assumes exact f32 products (the df64 and recorded-block pair GEMMs, the
    f32-basis projections);
  * XLA:GPU has no GEMM with f32 operands and an f64 result
    ("Unexpected GEMM dtype: f32 f32 f64").

`einsum` below is jnp.einsum with precision=HIGHEST whose narrower floating
operands are first promoted to a wider preferred_element_type. The
promotion is exact (f32 → f64), and so is the f64 product of two f32
values, so the pair GEMMs keep their exact-product semantics on every
backend.

A third property breaks the f32-pair and expansion arithmetic itself: by
default XLA may drop a rounding convert pair such as f64 → f32 → f64 as
"excess precision" (XLA:GPU does inside fusions), which zeroes the low word
of every hi/lo split. Programs built from that arithmetic compile with
EXACT_ROUNDING, which forbids it.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

__all__ = ["einsum", "HIGHEST", "EXACT_ROUNDING"]

HIGHEST = lax.Precision.HIGHEST

# jax.jit(..., compiler_options=EXACT_ROUNDING): every convert rounds
EXACT_ROUNDING = {"xla_allow_excess_precision": False}


def einsum(spec: str, *operands, preferred_element_type=None):
    if preferred_element_type is not None:
        wide = jnp.dtype(preferred_element_type)
        operands = tuple(
            o.astype(wide)
            if jnp.issubdtype(o.dtype, jnp.floating)
            and jnp.dtype(o.dtype).itemsize < wide.itemsize else o
            for o in operands)
    return jnp.einsum(spec, *operands,
                      preferred_element_type=preferred_element_type,
                      precision=HIGHEST)
