"""Device mesh construction — runtime topology discovery.

The reference's analog is compile-time ISA probing: CMake runs a cpuid
prober and picks -mavx512f/-mavx2/-mavx flags (cmake/avx_utils.cmake:5-146).
Here the "detect then specialize" step happens at runtime: ``jax.devices()``
exposes the devices, and the mesh follows the algorithm (the cards of one
host reach each other all to all over NVLink, so no layout is preferred).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import config


def device_info() -> dict:
    """Topology summary (the runtime cpuid analog)."""
    devs = jax.devices()
    return {
        "backend": jax.default_backend(),
        "n_devices": len(devs),
        "n_local": jax.local_device_count(),
        "n_processes": jax.process_count(),
        "platforms": sorted({d.platform for d in devs}),
    }


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Optional[Sequence[str]] = None,
    devices=None,
) -> Mesh:
    """Build a mesh.

    Default: 1-D mesh over all devices named after ``config.data_axis``
    (the scenario axis of the batched solvers).  Pass ``axis_sizes`` /
    ``axis_names`` for 2-D layouts, e.g. ``((n_hosts, devices_per_host),
    ("host", "scenario"))`` so the scenario axis stays within a host.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    if axis_sizes is None:
        axis_sizes = (devices.size,)
        axis_names = (config.data_axis,)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if int(np.prod(axis_sizes)) != devices.size:
        raise ValueError(
            f"mesh axes {axis_sizes} do not match device count {devices.size}"
        )
    if axis_names is None or len(axis_names) != len(axis_sizes):
        raise ValueError("axis_names must match axis_sizes")
    return Mesh(devices.reshape(axis_sizes), tuple(axis_names))


def scenario_sharding(mesh: Mesh, axis_name: Optional[str] = None) -> NamedSharding:
    """Sharding that splits the leading (scenario) axis over the mesh."""
    axis_name = axis_name or config.data_axis
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
