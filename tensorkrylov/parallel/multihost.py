"""Multi-process execution harness: process init, process-aware meshes,
data placement.

The reference is single-process (SURVEY.md §2.14: its entire parallelism is
cooperative @async over factors, /root/reference/src/orthogonal_bases.jl:149-180).
This module is the multi-process replacement: `jax.distributed.initialize`
for the process group, a mesh builder that routes each solver axis onto the
right level of the machine, and helpers that turn host-replicated problem
data into global sharded arrays.

Axis → placement policy (the whole point of the builder):

  * 'factor' — the d Krylov recurrences are independent: ZERO intra-solve
    communication crosses this axis (only the tiny replicated projected
    algebra). It therefore spans processes, whose devices are the furthest
    apart.
  * 'mode'   — shards each factor's length-n axis: the banded-SpMV halo
    (nearest-neighbor ppermute) and the dot/Gram psums live here, so it
    stays within one process's local devices.

`jax.devices()` orders devices process-major, so a (num_processes,
local_device_count) reshape puts 'factor' across processes and 'mode' over
each process's local devices exactly. `factor_parallel` > num_processes
additionally splits factors within a process; `factor_parallel` <
num_processes spans 'mode' across processes (useful when d is small and n
is enormous — halo latency then crosses processes, which the overlapped
ring SpMV is designed to hide). With one process (e.g. four GPUs of one
host, all-to-all over NVLink) the mesh is (1, local devices) unless
`factor_parallel` says otherwise.
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..types import KroneckerSumOperator

__all__ = [
    "init_distributed",
    "make_pod_mesh",
    "global_array",
    "distribute_problem",
]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_count: Optional[int] = None,
) -> int:
    """Initialize the JAX process group. Returns the process index.

    Pass the coordinator, process count and process id explicitly or via
    the TK_COORDINATOR / TK_NUM_PROCESSES / TK_PROCESS_ID environment
    variables. With none of them configured this is a single-process run
    and nothing is initialized. `local_device_count` forces that many
    virtual CPU devices per process (must be set before the backend
    initializes).
    """
    if local_device_count is not None:
        flag = f"--xla_force_host_platform_device_count={local_device_count}"
        if flag not in os.environ.get("XLA_FLAGS", ""):
            os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " " + flag).strip()
    coordinator_address = coordinator_address or os.environ.get("TK_COORDINATOR")
    if num_processes is None and "TK_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["TK_NUM_PROCESSES"])
    if process_id is None and "TK_PROCESS_ID" in os.environ:
        process_id = int(os.environ["TK_PROCESS_ID"])
    if coordinator_address is not None or num_processes is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index()


def make_pod_mesh(
    factor_parallel: Optional[int] = None,
    devices=None,
) -> Mesh:
    """('factor', 'mode') mesh with 'factor' spanning processes and 'mode'
    each process's local devices — see the module docstring.

    Default factor_parallel = number of processes (each host owns a factor
    group; no cross-host traffic in the Krylov recurrences).
    """
    if devices is None:
        devices = jax.devices()
    n_dev = len(devices)
    if factor_parallel is None:
        factor_parallel = max(jax.process_count(), 1)
    if n_dev % factor_parallel != 0:
        raise ValueError(f"{n_dev} devices not divisible by factor_parallel={factor_parallel}")
    # jax.devices() is process-major: this reshape puts 'factor' across
    # processes first, then 'mode' over each process's local devices
    grid = np.asarray(devices).reshape(factor_parallel, n_dev // factor_parallel)
    return Mesh(grid, axis_names=("factor", "mode"))


def global_array(x: np.ndarray, mesh: Mesh, spec: P) -> jax.Array:
    """Host-replicated numpy → global sharded jax.Array (multi-process safe:
    every process hands XLA only its addressable shards)."""
    x = np.asarray(x)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])


def distribute_problem(op: KroneckerSumOperator, b, mesh: Mesh):
    """Shard (operator, rhs) over the pod mesh: bands/rhs n-axis over 'mode',
    d-axis over 'factor' when divisible. Problem assembly is O(d·n) — every
    process builds the same host copy, placement scatters it."""
    d = op.d
    fspec = "factor" if mesh.shape["factor"] > 1 and d % mesh.shape["factor"] == 0 else None
    bands = global_array(np.asarray(op.bands), mesh, P(fspec, None, "mode"))
    b_g = global_array(np.asarray(b), mesh, P(fspec, "mode"))
    return KroneckerSumOperator(bands, op.offsets, op.symmetric, op.halo), b_g
