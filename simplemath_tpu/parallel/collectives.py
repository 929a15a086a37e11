"""Collective communication layer.

The reference's only parallelism is shared-memory OpenMP threads
(include/math/calculate.h:47,152) — there is no communication backend
(SURVEY §2.3).  This module IS the framework's communication backend:
XLA collectives over the device mesh (NCCL on GPUs), used by the
distributed solvers for
QP/KKT block reductions and convergence checks.  They work inside
``shard_map`` regions over named mesh axes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map  # noqa: F401  (re-export)


def psum(x, axis_name: str):
    """Sum-reduce across a mesh axis."""
    return jax.lax.psum(x, axis_name)


def pmean(x, axis_name: str):
    return jax.lax.pmean(x, axis_name)


def pmax(x, axis_name: str):
    return jax.lax.pmax(x, axis_name)


def pmin(x, axis_name: str):
    return jax.lax.pmin(x, axis_name)


def all_gather(x, axis_name: str, axis: int = 0, tiled: bool = True):
    return jax.lax.all_gather(x, axis_name, axis=axis, tiled=tiled)


def ppermute_ring(x, axis_name: str, shift: int = 1):
    """Ring shift along a mesh axis (building block for pipelined exchanges)."""
    n = jax.lax.axis_size(axis_name)
    perm = [(i, (i + shift) % n) for i in range(n)]
    return jax.lax.ppermute(x, axis_name, perm)


def reduce_scatter(x, axis_name: str, axis: int = 0):
    return jax.lax.psum_scatter(x, axis_name, scatter_dimension=axis, tiled=True)


def axis_index(axis_name: str):
    return jax.lax.axis_index(axis_name)
