"""Sharded batched solving: the scenario axis over the device mesh.

Replacement for the reference's intra-op OpenMP loop
(include/math/calculate.h:47-48): instead of threads over 1024-element
chunks, ``shard_map`` splits the scenario batch across chips, each chip
vmaps its shard, and cross-chip ``psum``/``pmax`` collectives aggregate
global solver statistics (cost sums, convergence criteria — the "QP/KKT
block reductions" of BASELINE.json configs 4-5).

``axis_name`` may be a single mesh axis or a tuple (e.g. ``("host",
"scenario")`` on a 2-D multi-host mesh): the batch shards over the axis
product, and the stat reductions run over the inner axis first, so only a
scalar crosses hosts.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..config import config
from ..models.dynamics import System
from ..models import ilqr as _ilqr
from . import collectives, mesh as _mesh

AxisNames = Union[str, Tuple[str, ...]]


def _as_tuple(axis_name: AxisNames) -> Tuple[str, ...]:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def solve_batched_sharded(
    system: System,
    x0_batch,
    us_init_batch,
    ilqr_config: _ilqr.ILQRConfig = _ilqr.ILQRConfig(),
    mesh: Optional[Mesh] = None,
    axis_name: Optional[AxisNames] = None,
):
    """Solve a scenario batch sharded over mesh axes.

    Returns (result, stats) where stats carries globally-reduced metrics:
    total cost (psum), max gradient norm (pmax), mean cost.  The batch's
    leading dim must divide by the product of the named axis sizes.
    """
    mesh = mesh if mesh is not None else _mesh.make_mesh()
    axes = _as_tuple(axis_name or config.data_axis)

    n = x0_batch.shape[0]
    axis_size = 1
    for ax in axes:
        axis_size *= mesh.shape[ax]
    if n % axis_size != 0:
        raise ValueError(
            f"scenario batch {n} not divisible by mesh axes "
            f"{axes}={axis_size}"
        )

    def shard_fn(x0s, uss):
        result = _ilqr.solve_batched(system, x0s, uss, ilqr_config)
        # Cross-device KKT/convergence reductions, over the axis tuple in
        # inner-to-outer order, so only a scalar crosses hosts.
        total_cost = jnp.sum(result.cost)
        max_grad = jnp.max(result.grad_norm)
        for ax in reversed(axes):
            total_cost = collectives.psum(total_cost, ax)
            max_grad = collectives.pmax(max_grad, ax)
        mean_cost = total_cost / n
        return result, {
            "total_cost": total_cost,
            "mean_cost": mean_cost,
            "max_grad_norm": max_grad,
        }

    spec = P(axes if len(axes) > 1 else axes[0])
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=(
            _ilqr.ILQRResult(
                xs=spec, us=spec, cost=spec, cost_trace=spec, grad_norm=spec
            ),
            {"total_cost": P(), "mean_cost": P(), "max_grad_norm": P()},
        ),
        check_vma=False,
    )
    return fn(x0_batch, us_init_batch)


def make_sharded_train_step(
    system: System,
    mesh: Mesh,
    ilqr_config: _ilqr.ILQRConfig = _ilqr.ILQRConfig(),
    axis_name: Optional[AxisNames] = None,
):
    """A jitted sharded solve step (the framework's "training step")."""
    axes = _as_tuple(axis_name or config.data_axis)

    @jax.jit
    def step(x0_batch, us_batch):
        return solve_batched_sharded(
            system, x0_batch, us_batch, ilqr_config, mesh, axes
        )

    return step
