"""Weak-scaling measurement harness.

Measures weak scaling (same per-device work, growing device count) and
sharding overhead (same total work) of the sharded solver on whatever mesh
is available.  On real cards the times are device times; on the CPU backend
with ``--xla_force_host_platform_device_count=N`` the virtual devices share
the host's cores, so only the collective structure is exercised there.
"""

from __future__ import annotations

import time
from typing import Dict, Sequence

import jax
import jax.numpy as jnp

from ..models import dynamics as _dyn
from ..models import ilqr as _ilqr
from . import sharded as _sharded
from .mesh import make_mesh
from .multihost import scaling_efficiency


def _time_step(step_fn, x0s, us, repeats: int = 3) -> float:
    """Median wall time of a jitted sharded step (compile excluded)."""
    result, stats = step_fn(x0s, us)
    jax.block_until_ready(stats["total_cost"])
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        result, stats = step_fn(x0s, us)
        jax.block_until_ready(stats["total_cost"])
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def weak_scaling_report(
    per_device_batch: int = 64,
    horizon: int = 40,
    iterations: int = 3,
    device_counts: Sequence[int] = (1, 2, 4, 8),
    system_name: str = "cartpole",
) -> Dict:
    """Weak-scaling efficiencies of the sharded cartpole solve.

    For each n in ``device_counts`` (clamped to the available devices):
    mesh over the first n devices, batch = n * per_device_batch, time one
    sharded solve step; efficiency_n = t_1 / t_n (1.0 = perfect weak
    scaling).  Returns {"times_s": {n: t}, "efficiency": {n: e}, ...}.
    """
    system = _dyn.SYSTEMS[system_name]()
    devs = jax.devices()
    counts = [n for n in device_counts if n <= len(devs)]
    cfg = _ilqr.ILQRConfig(iterations=iterations)
    times: Dict[int, float] = {}
    for n in counts:
        mesh = make_mesh((n,), ("scenario",), devices=devs[:n])
        step = _sharded.make_sharded_train_step(system, mesh, cfg, "scenario")
        batch = n * per_device_batch
        x0s = 0.2 * jax.random.normal(
            jax.random.PRNGKey(n), (batch, system.nx), dtype=jnp.float32
        )
        us = jnp.zeros((batch, horizon, system.nu), jnp.float32)
        times[n] = _time_step(step, x0s, us)
    t1 = times[counts[0]]
    eff = {n: scaling_efficiency(t1, t, n) for n, t in times.items()}
    return {
        "system": system_name,
        "per_device_batch": per_device_batch,
        "horizon": horizon,
        "iterations": iterations,
        "backend": jax.default_backend(),
        "device_counts": counts,
        "times_s": times,
        "efficiency": eff,
        # On virtual CPU devices the "devices" share physical cores, so
        # weak-scaling efficiency is NOT meaningful there (n x the work on
        # fixed silicon must slow down) — it validates the collective
        # structure only.  Real efficiency requires real chips.
        "efficiency_meaningful": jax.default_backend() != "cpu",
    }


def sharding_overhead_report(
    total_batch: int = 256,
    horizon: int = 40,
    iterations: int = 3,
    n_devices: int = None,
    system_name: str = "cartpole",
) -> Dict:
    """Sharding-machinery overhead at CONSTANT total work: the same batch
    solved unsharded on one device vs shard_map'd over n devices.  On the
    virtual CPU mesh this IS meaningful (same silicon either way): a ratio
    near/below 1.0 means the partitioning + collectives add no cost."""
    system = _dyn.SYSTEMS[system_name]()
    devs = jax.devices()
    n = n_devices or len(devs)
    if total_batch % n:
        total_batch = (total_batch // n) * n
    cfg = _ilqr.ILQRConfig(iterations=iterations)
    x0s = 0.2 * jax.random.normal(
        jax.random.PRNGKey(0), (total_batch, system.nx), dtype=jnp.float32
    )
    us = jnp.zeros((total_batch, horizon, system.nu), jnp.float32)

    plain = jax.jit(
        lambda x, u: _ilqr.solve_batched(system, x, u, cfg).cost
    )
    jax.block_until_ready(plain(x0s, us))
    import time as _t

    ts = []
    for _ in range(3):
        t0 = _t.perf_counter()
        jax.block_until_ready(plain(x0s, us))
        ts.append(_t.perf_counter() - t0)
    t_plain = sorted(ts)[1]

    mesh = make_mesh((n,), ("scenario",), devices=devs[:n])
    step = _sharded.make_sharded_train_step(system, mesh, cfg, "scenario")
    t_shard = _time_step(step, x0s, us)
    return {
        "total_batch": total_batch,
        "n_devices": n,
        "unsharded_s": t_plain,
        "sharded_s": t_shard,
        "sharded_over_unsharded": t_shard / t_plain,
    }
