"""Integer and quantized matrix products.

``int8_matmul`` is s8 x s8 -> s32 with exact integer accumulation — the
quantized analog of the reference's int32 SIMD dot (product.h:26-69).  XLA
hands ``jnp.matmul(int8, int8, preferred_element_type=int32)`` to the
card's int8 tensor cores (cuBLASLt IMMA on the H100); float products go
through ``ops/engine.py``.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import dispatch


def int8_matmul(a, b, out_dtype=jnp.int32, scale=None):
    """s8 x s8 -> s32 matmul, exact integer accumulation.  Rank-2 or
    batched rank-3 int8/uint8 operands.

    ``scale`` (a scalar, or per-channel scales broadcastable to the output,
    typically ``scale_a * scale_b`` from ``quantize_int8``) dequantizes the
    i32 result to f32; under jit XLA fuses the scale into the GEMM's
    output."""
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    for x in (a, b):
        if jnp.dtype(x.dtype) not in (jnp.dtype(jnp.int8), jnp.dtype(jnp.uint8)):
            raise TypeError(
                f"int8_matmul requires int8/uint8 operands, got {x.dtype}"
            )
    dispatch.record("matmul", "int8")
    out = jnp.matmul(a, b, preferred_element_type=jnp.int32)
    if scale is not None:
        return out.astype(jnp.float32) * jnp.asarray(scale, jnp.float32)
    return out.astype(out_dtype)


def quantize_int8(x, scale=None, axis=None):
    """Symmetric int8 quantization: ``q = clip(round(x / scale), -127,
    127)``; default ``scale = max|x| / 127``.  ``axis`` computes
    PER-CHANNEL scales by reducing over the given axis/axes (keepdims), the
    production-quantization shape — e.g. ``axis=0`` on a (K, N) weight
    gives per-output-channel (1, N) scales, which ``int8_matmul``'s
    ``scale`` takes directly.  Returns ``(q, scale)``."""
    x = jnp.asarray(x)
    if scale is None:
        if axis is None:
            scale = jnp.max(jnp.abs(x)) / 127.0
        else:
            scale = jnp.max(jnp.abs(x), axis=axis, keepdims=True) / 127.0
    scale = jnp.asarray(scale, jnp.float32)
    safe = jnp.where(scale > 0, scale, jnp.float32(1.0))
    q = jnp.clip(jnp.round(x / safe), -127, 127).astype(jnp.int8)
    return q, scale


def dequantize_int8(q, scale):
    """Inverse of ``quantize_int8`` (also rescales i32 matmul results:
    pass ``scale_a * scale_b``)."""
    return jnp.asarray(q).astype(jnp.float32) * jnp.asarray(scale, jnp.float32)
