"""Iterated fused recurrence as one Pallas kernel through Triton.

``sm.fuse(fn, iterations=L)`` runs ``acc = fn(acc, ...)`` L times.  XLA
lowers that to a ``while`` loop whose body is one fusion: every iteration
launches once and reads and writes the carry in device memory.  This
kernel keeps the carry in registers for all L iterations instead, so each
operand is read once and the result written once — 1/L of the bytes, one
launch.

Layout: every operand is flattened to 1-D and cut into power-of-two
blocks, one block per program; the tail block is masked.  Operands must
be full-shape (the output's shape) or hold a single element, which is
read as a scalar.  Any other broadcast pattern stays on XLA
(``platform.fuse_loop_route``).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import dispatch

# Carry dtypes the kernel takes.  Others (64-bit, complex, bool) go to XLA.
DTYPES = frozenset(
    jnp.dtype(d) for d in (jnp.float32, jnp.bfloat16, jnp.float16, jnp.int32)
)

# Largest block; smaller when the array would leave SMs idle.  132 SMs on
# the H100 SXM, and a few blocks each keep them all busy.
_MAX_BLOCK = 1024
_MIN_BLOCK = 128
_MIN_PROGRAMS = 4 * 132


def block_size(n: int) -> int:
    """Power-of-two block for ``n`` elements: ``_MAX_BLOCK`` unless that
    gives fewer than ``_MIN_PROGRAMS`` programs."""
    block = min(_MAX_BLOCK, max(_MIN_BLOCK, pl.next_power_of_2(n)))
    while block > _MIN_BLOCK and -(-n // block) < _MIN_PROGRAMS:
        block //= 2
    return block


def operands_ok(out_shape, operand_shapes) -> bool:
    """Whether every operand is full-shape or a single element."""
    out_shape = tuple(out_shape)
    return all(
        tuple(s) == out_shape or math.prod(s) == 1 for s in operand_shapes
    )


def _kernel(*refs, tile_fn, iterations, carry, n, block, full, out_dtype):
    *in_refs, out_ref = refs
    # Masked-off lanes of the tail block load undefined values; they are
    # computed on but never stored.
    idx = pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)
    mask = idx < n
    vals = [
        plgpu.load(r, mask=mask) if f else r[0]
        for r, f in zip(in_refs, full)
    ]

    def body(_, c):
        args = list(vals)
        args[carry] = c
        return tile_fn(*args).astype(out_dtype)

    acc = jax.lax.fori_loop(0, iterations, body, vals[carry].astype(out_dtype))
    plgpu.store(out_ref, acc, mask=mask)


@functools.lru_cache(maxsize=256)
def _build(tile_fn, iterations, carry, n, full, out_dtype, donate, interpret):
    block = block_size(n)
    grid = (pl.cdiv(n, block),)

    def spec(f):
        if f:
            return pl.BlockSpec((block,), lambda i: (i,))
        return pl.BlockSpec((1,), lambda i: (np.int32(0),))

    kernel = functools.partial(
        _kernel, tile_fn=tile_fn, iterations=iterations, carry=carry, n=n,
        block=block, full=full, out_dtype=out_dtype,
    )
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((n,), out_dtype),
        grid=grid,
        in_specs=[spec(f) for f in full],
        out_specs=pl.BlockSpec((block,), lambda i: (i,)),
        input_output_aliases={} if donate is None else {donate: 0},
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="sm_fuse_loop",
    )


def iterate(
    tile_fn, out_shape, out_dtype, operands, *, iterations: int, carry: int,
    donate=None, interpret: bool = False,
):
    """``tile_fn`` applied ``iterations`` times, its result fed back as
    operand ``carry``, in one kernel.  ``tile_fn`` must be a stable object
    (the build cache keys on it).  ``donate=i`` writes the output over
    full-shape operand ``i``.  ``interpret`` runs the Pallas interpreter
    instead (tests on the CPU set it)."""
    out_shape = tuple(int(s) for s in out_shape)
    out_dtype = jnp.dtype(out_dtype)
    n = math.prod(out_shape)
    shapes = [tuple(jnp.shape(o)) for o in operands]
    if not operands_ok(out_shape, shapes) or shapes[carry] != out_shape:
        raise ValueError(
            f"fuse_loop operands must be full-shape {out_shape} or single "
            f"elements, with a full-shape carry; got {shapes}"
        )
    full = tuple(s == out_shape for s in shapes)
    flat = [jnp.reshape(jnp.asarray(o), (-1,)) for o in operands]
    dispatch.record("fuse_loop", "triton")
    call = _build(
        tile_fn, iterations, carry, n, full, out_dtype, donate, interpret
    )
    return jnp.reshape(call(*flat), out_shape)
