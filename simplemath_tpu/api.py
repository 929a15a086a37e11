"""User-facing factories and free functions.

Parity layer for include/UserFunctions.h: ``empty`` (:8-15), ``ones``
(:18-30; the reference parallelizes the fill above 100k elements with
``std::execution::par_unseq`` — here fills are single fused XLA broadcasts on
device, which is strictly stronger), ``zeros`` (:33-40), free ``sm::pow``
(:42-48), and the ostream pretty-printer (:54-57) which maps to
``str(Array)``.
"""

from __future__ import annotations

from typing import Union

import jax.numpy as jnp

from . import dtypes as _dtypes
from .array import Array, asarray
from .ops import engine


def _shape_args(shape):
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        return tuple(int(s) for s in shape[0])
    return tuple(int(s) for s in shape)


def empty(*shape, dtype=jnp.float32) -> Array:
    """Uninitialized-array factory (UserFunctions.h:8-15).  XLA has no
    uninitialized allocation; a zero fill costs one fused kernel."""
    return zeros(*shape, dtype=dtype)


def zeros(*shape, dtype=jnp.float32) -> Array:
    return Array(jnp.zeros(_shape_args(shape), dtype=_dtypes.canonicalize(dtype)))


def ones(*shape, dtype=jnp.float32) -> Array:
    return Array(jnp.ones(_shape_args(shape), dtype=_dtypes.canonicalize(dtype)))


def full(*shape, fill_value, dtype=jnp.float32) -> Array:
    return Array(
        jnp.full(_shape_args(shape), fill_value, dtype=_dtypes.canonicalize(dtype))
    )


def arange(*args, dtype=None) -> Array:
    return Array(jnp.arange(*args, dtype=dtype))


def eye(n, m=None, dtype=jnp.float32) -> Array:
    return Array(jnp.eye(n, m, dtype=_dtypes.canonicalize(dtype)))


def linspace(start, stop, num=50, dtype=jnp.float32) -> Array:
    return Array(
        jnp.linspace(start, stop, num, dtype=_dtypes.canonicalize(dtype))
    )


def zeros_like(a) -> Array:
    return Array(jnp.zeros_like(asarray(a).jax()))


def ones_like(a) -> Array:
    return Array(jnp.ones_like(asarray(a).jax()))


def full_like(a, fill_value) -> Array:
    return Array(jnp.full_like(asarray(a).jax(), fill_value))


def array(data, dtype=None) -> Array:
    return Array(data, dtype=dtype)


def pow(a, exponent) -> Array:
    """Free-function pow (UserFunctions.h:42-48) with working float pow and
    the reference's integer-pow edge semantics (tests/pow.cpp:62-99)."""
    return engine.pow(a, exponent)


def dot(a, b):
    from .ops import fusion

    if fusion.is_fused(a) or fusion.is_fused(b):
        # Fused 2-D dot == the fused-matmul epilogue root.
        return fusion.matmul_node(a, b)
    return engine.dot(a, b)


def add(a, b) -> Array:
    return engine.binary("add", a, b)


def subtract(a, b) -> Array:
    return engine.binary("subtract", a, b)


def multiply(a, b) -> Array:
    return engine.binary("multiply", a, b)


def divide(a, b) -> Array:
    return engine.binary("divide", a, b)


def _transcendental_unary(name: str, a) -> Array:
    from .ops import fusion, lazy, transcendental

    if fusion.is_fused(a):
        return fusion.unary_node(name, a)
    out = lazy.defer_trans(name, a)
    if out is not None:
        return out
    return Array(getattr(transcendental, name)(asarray(a).jax()))


def exp(a) -> Array:
    return _transcendental_unary("exp", a)


def log(a) -> Array:
    return _transcendental_unary("log", a)


def exp2(a) -> Array:
    return _transcendental_unary("exp2", a)


def log2(a) -> Array:
    return _transcendental_unary("log2", a)


def fuse(fn, donate=None, iterations=1, carry=0):
    """Fuse a chain of sm ops into one program (ops/fusion.py).
    ``donate=i`` lets the output overwrite input ``i``; ``iterations=L``
    iterates the chain L times with input ``carry`` as the loop carry —
    on a GPU as one Triton kernel that keeps the carry in registers."""
    from .ops import fusion

    return fusion.fuse(fn, donate=donate, iterations=iterations, carry=carry)


# --------------------------------------------------------------------------
# NumPy-style free functions over Array (the rest of a complete ndarray
# surface; all honor views and lower to XLA).  Ops with a registry tile go
# through _unary_engine / engine.binary instead — those compose with
# sm.fuse; everything wrapped here deliberately does not.


def _wrap1(fn):
    def wrapped(a, *args, **kwargs):
        from .ops import fusion

        if fusion.is_fused(a):
            raise TypeError(
                f"sm.{fn.__name__} is not supported inside sm.fuse"
            )
        return Array(fn(asarray(a).jax(), *args, **kwargs))

    return wrapped


transpose = _wrap1(jnp.transpose)
reshape = _wrap1(jnp.reshape)
repeat = _wrap1(jnp.repeat)


def _reduce_free(name):
    """Free-function reductions route through the SAME path as the Array
    methods (``sm.sum(a)`` and ``a.sum()`` are one path)."""

    def fn(a, axis=None, keepdims=False):
        from .ops import fusion

        if fusion.is_fused(a):
            # A reduction may be the ROOT of a fused function: the chain
            # and the reduction compile together (fusion.FusedReduction) —
            # full reductions to a scalar, or a single-axis reduction.
            return fusion.reduce_node(name, a, axis=axis, keepdims=keepdims)
        return getattr(asarray(a), name)(axis=axis, keepdims=keepdims)

    fn.__name__ = name
    return fn


sum = _reduce_free("sum")  # noqa: A001 - numpy-style namespace
mean = _reduce_free("mean")
max = _reduce_free("max")  # noqa: A001
min = _reduce_free("min")  # noqa: A001
argmax = _wrap1(jnp.argmax)
argmin = _wrap1(jnp.argmin)


def prod(a, axis=None, keepdims=False) -> Array:
    from .ops import fusion

    if fusion.is_fused(a):
        raise TypeError("sm.prod is not supported inside sm.fuse")
    return Array(jnp.prod(asarray(a).jax(), axis=axis, keepdims=keepdims))


def var(a, axis=None, keepdims=False, ddof=0) -> Array:
    from .ops import fusion

    if fusion.is_fused(a):
        raise TypeError("sm.var is not supported inside sm.fuse")
    return Array(
        jnp.var(asarray(a).jax(), axis=axis, keepdims=keepdims, ddof=ddof)
    )


def std(a, axis=None, keepdims=False, ddof=0) -> Array:
    from .ops import fusion

    if fusion.is_fused(a):
        raise TypeError("sm.std is not supported inside sm.fuse")
    return Array(
        jnp.std(asarray(a).jax(), axis=axis, keepdims=keepdims, ddof=ddof)
    )
# Unary ops with a registry entry go through the SAME engine as the Array
# operators — one path per op, and they compose with sm.fuse.
def _unary_engine(name):
    def fn(a):
        return engine.unary(name, a)

    fn.__name__ = name
    return fn


abs = _unary_engine("abs")  # noqa: A001
sqrt = _unary_engine("sqrt")
square = _unary_engine("square")
negative = _unary_engine("negative")


# Trig rides the transcendental accuracy contract (ops/transcendental.py):
# "auto" picks native or crafted per op by measured accuracy.
def sin(a) -> Array:
    return _transcendental_unary("sin", a)


def cos(a) -> Array:
    return _transcendental_unary("cos", a)


def tan(a) -> Array:
    return _transcendental_unary("tan", a)


def tanh(a) -> Array:
    return _transcendental_unary("tanh", a)
sign = _unary_engine("sign")


def clip(a, a_min=None, a_max=None) -> Array:
    """NumPy ``clip``; with both bounds it is a registered ternary
    elementwise op (composes with sm.fuse and the deferred-eager queue)."""
    if a_min is None or a_max is None:
        from .ops import fusion

        if fusion.is_fused(a):
            raise TypeError(
                "sm.clip inside sm.fuse requires both bounds"
            )
        return Array(jnp.clip(asarray(a).jax(), a_min, a_max))
    return engine.ternary("clip", a, a_min, a_max)
cumsum = _wrap1(jnp.cumsum)
sort = _wrap1(jnp.sort)
floor = _wrap1(jnp.floor)
ceil = _wrap1(jnp.ceil)
round = _wrap1(jnp.round)  # noqa: A001 - numpy-style namespace
log10 = _wrap1(jnp.log10)
log1p = _wrap1(jnp.log1p)
expm1 = _wrap1(jnp.expm1)
sinh = _wrap1(jnp.sinh)
cosh = _wrap1(jnp.cosh)
arcsin = _wrap1(jnp.arcsin)
arccos = _wrap1(jnp.arccos)
arctan = _wrap1(jnp.arctan)
isnan = _wrap1(jnp.isnan)
isinf = _wrap1(jnp.isinf)
isfinite = _wrap1(jnp.isfinite)


def arctan2(a, b) -> Array:
    from .ops import fusion

    if fusion.is_fused(a) or fusion.is_fused(b):
        raise TypeError("sm.arctan2 is not supported inside sm.fuse")
    return Array(jnp.arctan2(asarray(a).jax(), asarray(b).jax()))
expand_dims = _wrap1(jnp.expand_dims)
squeeze = _wrap1(jnp.squeeze)
def maximum(a, b) -> Array:
    return engine.binary("maximum", a, b)


def minimum(a, b) -> Array:
    return engine.binary("minimum", a, b)


def matmul(a, b) -> Array:
    """``numpy.matmul`` semantics (ops/engine.py states the precision).
    Inside ``sm.fuse``, a matmul of direct arguments becomes a root whose
    elementwise consumers run as its epilogue, fused by XLA."""
    from .ops import fusion

    if fusion.is_fused(a) or fusion.is_fused(b):
        return fusion.matmul_node(a, b)
    return engine.matmul(a, b)


def int8_matmul(a, b, scale=None) -> Array:
    """s8 x s8 -> s32 matmul on the int8 tensor cores (exact i32
    accumulation — the quantized analog of the reference's int32 SIMD dot,
    include/math/product.h:26-69).  ``scale`` (typically ``scale_a *
    scale_b``, scalar or per-channel) dequantizes and returns f32."""
    from .ops import matmul as _mm
    from .array import as_jax

    return Array(
        _mm.int8_matmul(
            as_jax(a), as_jax(b),
            scale=as_jax(scale) if scale is not None else None,
        )
    )


def quantize(x, scale=None, axis=None):
    """Symmetric int8 quantization: ``(q, scale)`` with
    ``q = clip(round(x/scale), -127, 127)`` (default scale max|x|/127).
    ``axis`` computes PER-CHANNEL scales (keepdims) — e.g. ``axis=0`` on
    a (K, N) weight gives (1, N) per-output-channel scales that
    ``int8_matmul``'s ``scale`` takes directly."""
    from .ops import matmul as _mm
    from .array import as_jax

    q, s = _mm.quantize_int8(as_jax(x), scale, axis=axis)
    return Array(q), Array(s)


def dequantize(q, scale) -> Array:
    """Inverse of ``quantize``; for ``int8_matmul`` results pass
    ``scale_a * scale_b``."""
    from .ops import matmul as _mm
    from .array import as_jax

    return Array(_mm.dequantize_int8(as_jax(q), as_jax(scale)))


def where(cond, x, y) -> Array:
    """Elementwise select — a registered ternary op: composes with
    sm.fuse and the deferred-eager queue like the binary arithmetic."""
    return engine.ternary("where", cond, x, y)


def concatenate(arrays, axis=0) -> Array:
    return Array(jnp.concatenate([asarray(a).jax() for a in arrays], axis=axis))


def stack(arrays, axis=0) -> Array:
    return Array(jnp.stack([asarray(a).jax() for a in arrays], axis=axis))


def allclose(a, b, rtol=1e-5, atol=1e-8) -> bool:
    import numpy as np

    return bool(
        np.allclose(asarray(a).numpy(), asarray(b).numpy(), rtol=rtol, atol=atol)
    )
