"""Explicit shard_map banded SpMV with ppermute halo exchange.

GSPMD (parallel/sharding.py) already parallelizes the solver by propagating
named shardings; this module is the explicit-control path for the mode axis:
each device owns a contiguous slice of every factor's length-n axis, sends
its H-deep edges to its neighbours with `lax.ppermute` (NCCL on GPUs), and
computes the banded SpMV locally with the received halos. Halo volume is
H·d elements per neighbour (H = bandwidth ≤ 2 for the gallery), so the
exchange is latency-, not bandwidth-, bound — the design target for ≥80%
multi-host scaling (BASELINE.json config 5).

Layout contract: arrays are sharded on their LAST axis over `axis_name`,
n % n_devices == 0, and shard width ≥ H.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..types import KroneckerSumOperator

__all__ = ["spmv_halo_local", "spmv_halo", "make_halo_spmv"]


def _exchange_halos(v: jax.Array, H: int, axis_name: str):
    """Returns (left_halo, right_halo): the H last columns of the left
    neighbour and H first columns of the right neighbour (zeros at the
    chain ends)."""
    p = lax.axis_index(axis_name)
    np_ = lax.axis_size(axis_name)
    right_edge = v[..., -H:]
    left_edge = v[..., :H]
    # send my right edge to my right neighbour → arrives as its left halo
    left_halo = lax.ppermute(
        right_edge, axis_name, [(i, i + 1) for i in range(np_ - 1)]
    )
    # send my left edge to my left neighbour → arrives as its right halo
    right_halo = lax.ppermute(
        left_edge, axis_name, [(i + 1, i) for i in range(np_ - 1)]
    )
    left_halo = jnp.where(p == 0, jnp.zeros_like(left_halo), left_halo)
    right_halo = jnp.where(p == np_ - 1, jnp.zeros_like(right_halo), right_halo)
    return left_halo, right_halo


def spmv_halo_local(bands: jax.Array, offsets: Tuple[int, ...], v: jax.Array, axis_name: str):
    """Per-shard body: batched DIA SpMV on the local slice with halo
    exchange, structured for COMM/COMPUTE OVERLAP. bands (d, nb, n_local),
    v (d, n_local) or (d, m, n_local) (extra block/batch columns per factor,
    same contract as ops.banded.spmv).

    The interior stencil (all n_local columns, using zero-filled local
    shifts) carries NO data dependency on the ppermute results; only the
    O(H)-column edge corrections consume the halos. XLA's scheduler can
    therefore run the collective-permute pair asynchronously under the full
    interior product (collective-permute-start … interior … -done), hiding
    the link latency that a concatenate-then-slice structure would
    serialize."""
    H = max((abs(o) for o in offsets), default=0)
    if H == 0:
        return bands[:, 0, :] * v if bands.shape[1] == 1 else _local_apply(bands, offsets, v)
    # kick off the exchange first; nothing below depends on it until the
    # edge corrections at the very end
    left_halo, right_halo = _exchange_halos(v, H, axis_name)

    n_local = v.shape[-1]
    zeros_of = lambda w: jnp.zeros(v.shape[:-1] + (w,), v.dtype)
    u = None
    for b, off in enumerate(offsets):
        # interior: v shifted within the shard, zero-filled at the edge —
        # exactly the rows whose stencil stays local
        if off == 0:
            sl = v
        elif off > 0:
            sl = jnp.concatenate(
                [lax.slice_in_dim(v, off, n_local, axis=-1), zeros_of(off)],
                axis=-1,
            )
        else:
            sl = jnp.concatenate(
                [zeros_of(-off), lax.slice_in_dim(v, 0, n_local + off, axis=-1)],
                axis=-1,
            )
        bb = bands[:, b, :] if v.ndim == 2 else bands[:, b, None, :]
        term = bb * sl
        u = term if u is None else u + term
    # edge corrections: the O(|off|) boundary columns that need neighbour
    # data. |off| ≤ H ≤ 2 for the gallery — negligible FLOPs, applied after
    # the interior product has already been issued.
    for b, off in enumerate(offsets):
        if off == 0:
            continue
        bb = bands[:, b, :] if v.ndim == 2 else bands[:, b, None, :]
        if off > 0:
            # rows i ≥ n_local − off read v[i+off] from the right neighbour
            corr = bb[..., n_local - off:] * right_halo[..., :off]
            u = u.at[..., n_local - off:].add(corr)
        else:
            # rows i < −off read v[i+off] from the left neighbour
            corr = bb[..., : -off] * left_halo[..., H + off : H]
            u = u.at[..., : -off].add(corr)
    return u


def _local_apply(bands, offsets, v):
    from ..ops.banded import spmv as _spmv
    from ..types import KroneckerSumOperator as _Op

    return _spmv(_Op(bands, offsets, True), v)


def make_halo_spmv(mesh: Mesh, offsets: Tuple[int, ...], axis_name: str = "mode"):
    """Build a jitted shard_map SpMV over `mesh` for fixed band offsets.

    Returned fn(bands (d, nb, n), v (d, n)) → (d, n), all sharded on the
    last axis over `axis_name` (other mesh axes replicate).
    """
    spec_b = P(None, None, axis_name)
    spec_v = P(None, axis_name)

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec_b, spec_v),
        out_specs=spec_v,
    )
    def fn(bands, v):
        return spmv_halo_local(bands, offsets, v, axis_name)

    return fn


def spmv_halo(op: KroneckerSumOperator, v: jax.Array, mesh: Mesh, axis_name: str = "mode"):
    """One-shot convenience wrapper around make_halo_spmv."""
    return make_halo_spmv(mesh, op.offsets, axis_name)(op.bands, v)
