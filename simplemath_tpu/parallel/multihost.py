"""Multi-process orchestration helpers.

A cluster runs one python process per host, each seeing its local devices;
``jax.distributed.initialize`` stitches them into one global device list.
``pod_mesh`` lays the devices out as (process, local device), so the
scenario axis stays within a host and only the outer axis crosses hosts.

On one host the same code paths are exercised on a CPU mesh with
``--xla_force_host_platform_device_count=N`` (tests) and via
``__graft_entry__.dryrun_multichip``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

from .mesh import make_mesh


def initialize_from_env() -> None:
    """Initialize the JAX distributed runtime from standard env vars
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID), no-op when unset or
    single-process."""
    coord = os.environ.get("COORDINATOR_ADDRESS")
    nproc = int(os.environ.get("NUM_PROCESSES", "1"))
    if coord and nproc > 1:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=nproc,
            process_id=int(os.environ.get("PROCESS_ID", "0")),
        )


def pod_mesh(
    device_axis: str = "scenario", host_axis: str = "host"
) -> Mesh:
    """(n_processes, devices_per_process) mesh, hosts outer; 1-D over the
    devices when there is one process."""
    n_proc = jax.process_count()
    n_dev = jax.device_count()
    per_host = n_dev // max(n_proc, 1)
    if n_proc <= 1:
        return make_mesh((n_dev,), (device_axis,))
    return make_mesh((n_proc, per_host), (host_axis, device_axis))


def host_local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """(start, size) of this host's slice of a globally-sharded batch."""
    n_proc = max(jax.process_count(), 1)
    if global_batch % n_proc:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n_proc} hosts"
        )
    per = global_batch // n_proc
    return jax.process_index() * per, per


def scaling_efficiency(t_1dev: float, t_ndev: float, n: int) -> float:
    """Weak-scaling efficiency: n-device time vs 1-device time at n x the
    work (1.0 = perfect)."""
    return t_1dev / t_ndev if t_ndev > 0 else 0.0
