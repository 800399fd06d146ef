"""Batched banded (DIA) SpMV — the framework's hot kernel #1.

Replaces the reference's per-factor sparse ``mul!``
(/root/reference/src/orthogonal_bases.jl:20,45,103) with one fused
shift-multiply-accumulate over all d factors. Out-of-range band entries are
stored as zeros (see KroneckerSumOperator), so circular shifts need no edge
masking: wrapped lanes are multiplied by zero.

The chain is elementwise, so XLA fuses it into one memory-bound loop; under
GSPMD with the mode axis sharded, the rolls lower to collective-permutes
(halo exchange).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..types import KroneckerSumOperator

__all__ = ["spmv", "spmv_dense_oracle"]


def _shift(v: jax.Array, off: int) -> jax.Array:
    """v'[..., i] = v[..., i + off] (circular; garbage lanes get zero bands)."""
    if off == 0:
        return v
    return jnp.roll(v, -off, axis=-1)


def spmv(op: KroneckerSumOperator, v: jax.Array) -> jax.Array:
    """u[s] = A_s @ v[s] for all d factors at once.

    Args:
      op: operator with bands (d, nb, n).
      v: (d, n) or (d, m, n) — m extra block/batch vectors per factor.

    Returns: same shape as v.
    """
    if op.halo is not None:
        return _spmv_halo(op, v)
    bands = op.bands
    if v.ndim == 3:
        bands = bands[:, :, None, :]  # (d, nb, 1, n)
    terms = [
        bands[:, b] * _shift(v, off) for b, off in enumerate(op.offsets)
    ]
    u = terms[0]
    for t in terms[1:]:
        u = u + t
    return u


def _spmv_halo(op: KroneckerSumOperator, v: jax.Array) -> jax.Array:
    """Explicit shard_map + ppermute halo-exchange SpMV (op.halo is set).

    The op carries its communication layout as static aux data, so every
    caller — the Krylov steps, kron_apply_cp, the residual algebra — gets
    the explicit-collective path without plumbing a mesh through each API.
    """
    from jax.sharding import PartitionSpec as P

    from ..parallel.halo import spmv_halo_local

    mesh, mode_ax, factor_ax = op.halo
    mid = (None,) * (v.ndim - 2)
    vspec = P(factor_ax, *mid, mode_ax)
    bspec = P(factor_ax, None, mode_ax)
    offsets = op.offsets

    f = jax.shard_map(
        lambda bands, vv: spmv_halo_local(bands, offsets, vv, mode_ax),
        mesh=mesh,
        in_specs=(bspec, vspec),
        out_specs=vspec,
    )
    return f(op.bands, v)


def spmv_dense_oracle(dense_factors, v):
    """Reference oracle: (d, n, n) @ (d, n) via einsum (tests only)."""
    return jnp.einsum("dij,dj->di", dense_factors, v)
