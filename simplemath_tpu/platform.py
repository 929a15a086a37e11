"""The one place that asks which platform this is, and routes by it.

Every operation is plain JAX, which XLA compiles for the CPU or the GPU.
One choice depends on the platform: an iterated ``sm.fuse(...,
iterations=L)`` runs as a Pallas kernel through Triton on a GPU
(ops/fuse_loop.py), where it keeps the loop carry in registers, and as an
XLA ``fori_loop`` everywhere else.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def fuse_loop_route(
    out_shape, operand_shapes, out_dtype, iterations: int, platform=None
) -> str:
    """``"triton"`` or ``"xla"`` for an iterated fused recurrence.

    The kernel takes a GPU, ``iterations > 1``, a carry dtype it supports,
    and operands that are each full-shape or a single element.  ``platform``
    defaults to ``jax.default_backend()``."""
    from .ops import fuse_loop

    if iterations <= 1:
        return "xla"
    if (platform or jax.default_backend()) != "gpu":
        return "xla"
    if jnp.dtype(out_dtype) not in fuse_loop.DTYPES or math.prod(out_shape) == 0:
        return "xla"
    if not fuse_loop.operands_ok(out_shape, operand_shapes):
        return "xla"
    return "triton"
