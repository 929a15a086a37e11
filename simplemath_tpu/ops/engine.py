"""Dispatch engine: broadcast check, deferral, and the XLA op.

Analog of the reference's call path for ``c = a + b`` (SURVEY §3.2):
``operator+`` -> ``sm::broadcast`` -> ``element_wise_op``
(include/SMArray.h:217-225, include/SMUtils.h:34-99,
include/math/calculate.h:5-99).  Here: operator -> ``engine.binary`` ->
``broadcast_shapes`` (shape check with NumPy error semantics) -> the
deferred-eager queue (ops/lazy.py), which hands XLA the whole chain as one
program; a lone op runs as its jnp function.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from ..array import Array, as_jax
from ..broadcast import broadcast_shapes
from . import dispatch, registry


def _is_arraylike(x) -> bool:
    return isinstance(x, (Array, jax.Array, jax.core.Tracer)) or hasattr(x, "shape")


def _operand_info(x):
    """(shape, result_type_arg) without materializing view Arrays."""
    if isinstance(x, Array):
        return x.shape, x.dtype
    return jnp.shape(x), x


def _transpose_operand(x, rank: int):
    """(buffer, transposed) for a dot/matmul operand: a pure (batched)
    transpose view of matching rank — 2-D ``a.T`` or rank-3 ``(0, 2, 1)``
    — contributes its BASE buffer with a flag; ``lax.dot_general``
    contracts either orientation natively, so ``a.T @ b`` costs
    NO relayout copy (the reference's dot reads flat buffers and got
    views wrong, SURVEY §2.4-3; XLA's dimension numbers do it right for
    free).  Everything else materializes as before."""
    from ..viewspec import Span

    want_perm = (1, 0) if rank == 2 else (0, 2, 1)
    if isinstance(x, Array) and x.is_view:
        spec = x._spec
        if (
            spec.ndim == rank
            and len(spec.base_shape) == rank
            and spec.perm == want_perm
            and all(
                isinstance(e, Span)
                and e.start == 0
                and e.step == 1
                and e.length == s
                for e, s in zip(spec.entries, spec.base_shape)
            )
        ):
            return x._storage.buf, True
    return jnp.asarray(as_jax(x)), False


def _dot_general_t(av, ta, bv, tb, preferred, prec, rank: int):
    """(Batched) contraction with per-operand transposition folded into
    the dimension numbers (no transpose copies)."""
    if rank == 2:
        dims = (((0 if ta else 1,), (1 if tb else 0,)), ((), ()))
    else:
        dims = (((1 if ta else 2,), (2 if tb else 1,)), ((0,), (0,)))
    return jax.lax.dot_general(
        av, bv, dims, preferred_element_type=preferred, precision=prec
    )


def _dot_transposed_views(a, b, batched_ok: bool = False):
    """The no-copy route for 2-D (and, from ``matmul``, batched rank-3)
    contractions with transpose-view operands, or None when it does not
    apply (other ranks, or no transposed operand)."""
    a_shape, a_rt = _operand_info(a)
    b_shape, b_rt = _operand_info(b)
    rank = len(a_shape)
    if len(b_shape) != rank or rank not in ((2, 3) if batched_ok else (2,)):
        return None
    if rank == 3 and a_shape[0] != b_shape[0]:
        return None
    out_dtype = jnp.result_type(a_rt, b_rt)
    av, ta = _transpose_operand(a, rank)
    bv, tb = _transpose_operand(b, rank)
    if not (ta or tb):
        return None
    dispatch.record("matmul", "mm" if rank == 2 else "bmm")
    preferred, prec = _fallback_precision(a_shape, b_shape, out_dtype)
    return Array(_dot_general_t(av, ta, bv, tb, preferred, prec, rank))


def binary(name: str, a: Any, b: Any) -> Array:
    from . import fusion, lazy

    if fusion.is_fused(a) or fusion.is_fused(b):
        return fusion.binary_node(name, a, b)
    dispatch.record("engine", name)
    out = lazy.defer_binary(name, a, b)
    if out is not None:
        return out
    return binary_eager(name, a, b)


def binary_eager(name: str, a: Any, b: Any) -> Array:
    """The non-deferring compute path (also the lazy queue's single-op
    flush; ``binary`` records the engine dispatch before deferring)."""
    op = registry.get_op(name)
    a_shape, _ = _operand_info(a)
    b_shape, _ = _operand_info(b)
    broadcast_shapes(a_shape, b_shape)  # raises ValueError on mismatch
    dispatch.record("elementwise", name)
    return Array(op.fn(as_jax(a), as_jax(b)))


def unary(name: str, a: Any) -> Array:
    from . import fusion, lazy

    if fusion.is_fused(a):
        return fusion.unary_node(name, a)
    dispatch.record("engine", name)
    out = lazy.defer_unary(name, a)
    if out is not None:
        return out
    return unary_eager(name, a)


def unary_eager(name: str, a: Any) -> Array:
    """Non-deferring compute path (also the lazy single-op flush)."""
    dispatch.record("elementwise", name)
    return Array(registry.get_op(name).fn(as_jax(a)))


def ternary(name: str, a: Any, b: Any, c: Any) -> Array:
    from . import fusion, lazy

    if fusion.is_fused(a) or fusion.is_fused(b) or fusion.is_fused(c):
        return fusion.ternary_node(name, a, b, c)
    dispatch.record("engine", name)
    out = lazy.defer_ternary(name, a, b, c)
    if out is not None:
        return out
    return ternary_eager(name, a, b, c)


def ternary_eager(name: str, a: Any, b: Any, c: Any) -> Array:
    """Non-deferring compute path (also the lazy single-op flush)."""
    infos = [_operand_info(v) for v in (a, b, c)]
    broadcast_shapes(
        broadcast_shapes(infos[0][0], infos[1][0]).result_shape, infos[2][0]
    )
    dispatch.record("elementwise", name)
    return Array(registry.get_op(name).fn(as_jax(a), as_jax(b), as_jax(c)))


def apply_op(name: str, *operands) -> Array:
    """Public entry for registered (incl. user) ops — the reference's custom
    operator hook (README.md:119-133)."""
    op = registry.get_op(name)
    if op.arity == 1:
        return unary(name, *operands)
    if op.arity == 3:
        return ternary(name, *operands)
    return binary(name, *operands)


# ----------------------------------------------------------------- pow
def _int_pow(base, exponent):
    """Integer pow with the reference's documented edge semantics
    (include/math/simd/crafted_pow.h:35-51, tests/pow.cpp:62-99):
    nonnegative exponents are exact square-and-multiply results; negative
    exponents truncate to 0 except bases +1/-1 (and 1^x == 1, (-1)^e = ±1 by
    parity)."""
    base = jnp.asarray(base)
    exponent = jnp.asarray(exponent)
    e = jnp.abs(exponent)
    pos = jnp.power(base, e)
    parity = jnp.where(e % 2 == 0, 1, -1).astype(base.dtype)
    neg = jnp.where(
        base == 1,
        jnp.ones_like(base),
        jnp.where(base == -1, parity, jnp.zeros_like(base)),
    )
    return jnp.where(exponent < 0, neg, pos)


def _static_int_pow(x, e: int):
    """x**e for a STATIC integer exponent by repeated squaring — exact,
    memory-bound (a handful of fused multiplies), no transcendentals."""
    if e == 0:
        return jnp.ones_like(x)
    inv = e < 0
    e = -e if inv else e
    result = None
    base = x
    while e:
        if e & 1:
            result = base if result is None else result * base
        base = base * base
        e >>= 1
    return 1.0 / result if inv else result


def pow(a: Any, b: Any) -> Array:
    """Elementwise power — reference ``sm::pow`` (include/UserFunctions.h:42-48,
    include/math/pow.h).  Unlike the reference (flat-buffer iteration,
    SURVEY §2.4-3), views are honored; float pow uses the transcendental
    path with correct range reduction (the reference's admitted
    failure, README.md:8-10).  Static integer exponents (the benchmark's
    ``pow(a, 2)`` shape) specialize to repeated squaring — exact and
    memory-bound instead of transcendental-bound."""
    from . import fusion, lazy

    if fusion.is_fused(a) or fusion.is_fused(b):
        return fusion.pow_node(a, b)
    out = lazy.defer_pow(a, b)
    if out is not None:
        return out
    return pow_eager(a, b)


def pow_eager(a: Any, b: Any) -> Array:
    """Non-deferring compute path (also the lazy single-op flush)."""
    a_shape, a_rt = _operand_info(a)
    b_shape, b_rt = _operand_info(b)
    broadcast_shapes(a_shape, b_shape)
    a_dt = jnp.result_type(a_rt)
    b_dt = jnp.result_type(b_rt)
    if jnp.issubdtype(a_dt, jnp.integer) and jnp.issubdtype(b_dt, jnp.integer):
        dispatch.record("elementwise", "ipow")
        return Array(_int_pow(as_jax(a), as_jax(b)))
    if (
        isinstance(b, (int, float))
        and float(b) == int(b)
        and abs(int(b)) <= 64
        and jnp.issubdtype(a_dt, jnp.floating)
    ):
        dispatch.record("elementwise", "powi")
        return Array(_static_int_pow(jnp.asarray(as_jax(a)), int(b)))
    from . import transcendental

    return Array(transcendental.pow(as_jax(a), as_jax(b)))


# ----------------------------------------------------------------- dot
def dot(a: Any, b: Any):
    """Dot product — reference ``operator%`` / ``dot_product``
    (include/SMArray.h:213-215, include/math/product.h:8-224).

    Follows ``numpy.dot`` semantics (1-D·1-D inner product, 2-D matmul,
    N-D contraction of last axis with second-to-last), honoring views —
    fixing the reference's flat-buffer/totalSize-of-rhs behavior
    (SURVEY §2.4-3).  2-D TRANSPOSE-view operands fold into the
    contraction's dimension numbers (``a.T @ b`` pays no relayout copy).
    Precision follows ``_fallback_precision``."""
    out = _dot_transposed_views(a, b)
    if out is not None:
        return out
    av, bv = jnp.asarray(as_jax(a)), jnp.asarray(as_jax(b))
    out_dtype = jnp.result_type(av, bv)
    if av.ndim == 1 and bv.ndim == 1:
        dispatch.record("dot1d")
    else:
        dispatch.record("matmul", "mm")
    preferred, prec = _fallback_precision(av.shape, bv.shape, out_dtype)
    return Array(jnp.dot(av, bv, preferred_element_type=preferred, precision=prec))


# Contractions with every one of M, N and K at least this large run at the
# platform's default precision; smaller ones are latency-bound, where the
# extra passes of exact f32 cost nothing.
LARGE_CONTRACTION = 256


def _large_contraction(a_shape, b_shape) -> bool:
    if len(a_shape) != len(b_shape) or len(a_shape) not in (2, 3):
        return False
    if len(a_shape) == 3 and a_shape[0] != b_shape[0]:
        return False
    m, k = a_shape[-2:]
    n = b_shape[-1]
    return min(m, n, k) >= LARGE_CONTRACTION


def _fallback_precision(a_shape, b_shape, out_dtype):
    """(preferred_element_type, precision) for a float contraction.

    The reference's dot is exact f32 SIMD (product.h:74-116).  Contract:
    f32 and complex64 contractions below ``LARGE_CONTRACTION`` (and every
    1-D or N-D ``dot``) run at HIGHEST precision — reference-exact, and
    on a GPU it keeps them off TF32.  Large 2-D and batched f32 products
    run at the platform's default precision, which on the H100 is TF32
    on the tensor cores (about 1e-3 relative error, 10 mantissa bits of
    each operand), the same trade ``jnp.dot`` makes by default."""
    preferred = None
    if jnp.issubdtype(out_dtype, jnp.floating):
        preferred = jnp.promote_types(out_dtype, jnp.float32)
    prec = None
    if jnp.dtype(out_dtype) in (
        jnp.dtype(jnp.float32), jnp.dtype(jnp.complex64)
    ) and not _large_contraction(a_shape, b_shape):
        prec = jax.lax.Precision.HIGHEST
    return preferred, prec


def matmul(a: Any, b: Any) -> Array:
    """``numpy.matmul`` semantics (batched matrix product over leading
    dims).  2-D and batched rank-3 transpose-view operands fold into
    dimension numbers (no relayout copy); everything else lowers through
    ``jnp.matmul`` at the precision ``_fallback_precision`` gives."""
    out = _dot_transposed_views(a, b, batched_ok=True)
    if out is not None:
        return out
    av, bv = jnp.asarray(as_jax(a)), jnp.asarray(as_jax(b))
    out_dtype = jnp.result_type(av, bv)
    dispatch.record("matmul", "bmm" if av.ndim == bv.ndim == 3 else "mm")
    preferred, prec = _fallback_precision(av.shape, bv.shape, out_dtype)
    return Array(jnp.matmul(av, bv, preferred_element_type=preferred, precision=prec))
