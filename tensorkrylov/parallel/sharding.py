"""Device-mesh parallelism: factor × mode sharding.

The reference's only intra-solve parallelism is cooperative @async tasks over
the d factors (/root/reference/src/orthogonal_bases.jl:142-180). The
device-mesh replacement (SURVEY.md §2.14):

  * 'factor' axis — shards the d independent Krylov recurrences across
    devices (the analogue of model sharding over modes).
  * 'mode' axis — shards each factor's length-n dimension (the long-context
    axis): banded SpMV halo exchanges become XLA collective-permutes of the
    DIA shifts, dot/Gram products become psums.

The k-sized projected algebra (eigh, exp-sum, Lemma-3.4 scans) is replicated
— it is O(k³ + d·t²·k), negligible next to the n-sized work.

This module uses GSPMD: inputs are placed with NamedShardings and the jitted
solver is compiled with sharding propagation; XLA inserts the collectives.
comm='ring' instead runs the mode-axis SpMV as an explicit shard_map with
ppermute halos (parallel/halo.py).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..types import KroneckerSumOperator, SolverConfig, SolveResult

__all__ = ["make_mesh", "shard_operator", "shard_rhs", "solve_sharded"]


def make_mesh(
    n_devices: Optional[int] = None,
    factor_parallel: int = 1,
    devices=None,
) -> Mesh:
    """Build a ('factor', 'mode') mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    assert n_devices % factor_parallel == 0, (n_devices, factor_parallel)
    grid = devices.reshape(factor_parallel, n_devices // factor_parallel)
    return Mesh(grid, axis_names=("factor", "mode"))


def _factor_spec(mesh: Mesh, d: int) -> Optional[str]:
    fp = mesh.shape["factor"]
    return "factor" if fp > 1 and d % fp == 0 else None


def shard_operator(op: KroneckerSumOperator, mesh: Mesh) -> KroneckerSumOperator:
    """bands (d, nb, n): n over 'mode', d over 'factor' when divisible."""
    spec = P(_factor_spec(mesh, op.d), None, "mode")
    bands = jax.device_put(op.bands, NamedSharding(mesh, spec))
    return KroneckerSumOperator(bands, op.offsets, op.symmetric, op.halo)


def shard_rhs(b: jax.Array, mesh: Mesh, d: Optional[int] = None) -> jax.Array:
    spec = P(_factor_spec(mesh, d or b.shape[0]), "mode")
    return jax.device_put(b, NamedSharding(mesh, spec))


def solve_sharded(
    op: KroneckerSumOperator,
    b,
    config: Optional[SolverConfig] = None,
    mesh: Optional[Mesh] = None,
    comm: str = "gspmd",
) -> SolveResult:
    """Solve with the operator/RHS/bases sharded over the mesh.

    The Krylov basis V (d, K, n) inherits (factor, —, mode) sharding from the
    inputs via GSPMD propagation; SpMV shifts lower to collective-permutes
    and reductions to psums over 'mode'.

    comm: 'gspmd' — XLA chooses the SpMV collectives from the shardings;
          'ring'  — every SpMV in the solve runs the explicit shard_map +
                    ppermute halo-exchange path (parallel/halo.py), the
                    latency-hiding layout for multi-host mode sharding.
    """
    import dataclasses

    from ..solver import solve  # local import to avoid cycle

    if comm not in ("gspmd", "ring"):
        raise ValueError(f"comm must be 'gspmd' or 'ring', got {comm!r}")
    if mesh is None:
        mesh = make_mesh()
    config = config or SolverConfig()
    if jax.process_count() > 1:
        # multi-process: every process holds the host copy; placement must
        # go through addressable-shard construction (device_put cannot
        # target non-addressable devices)
        from .multihost import distribute_problem

        op, b = distribute_problem(op, jnp.asarray(b), mesh)
    else:
        op = shard_operator(op, mesh)
        b = shard_rhs(jnp.asarray(b), mesh)
    if comm == "ring":
        op = dataclasses.replace(
            op, halo=(mesh, "mode", _factor_spec(mesh, op.d))
        )
    return solve(op, b, config)
