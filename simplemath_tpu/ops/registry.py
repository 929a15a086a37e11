"""Op registry — the extension mechanism of the framework.

Reference pattern (README.md:86-133): a new op is a functor with a scalar
``apply`` plus per-ISA ``apply_simd`` specializations, wired into an operator
on ``SMArray``.  Here an op is a name + a jnp-level function (the "scalar"
definition, automatically vectorized by XLA) + an optional ``tile_fn``, the
form composed into fused chains (ops/lazy.py, ``sm.fuse``) and the
iterated-fuse kernel (the "SIMD specialization"; defaults to the jnp
function).  ``register_op`` is the public hook:

    import simplemath_tpu as sm
    sm.register_op("my_op", lambda a, b: (a + b) * 2)
    c = sm.apply_op("my_op", x, y)          # broadcast + dispatch

matching the reference's MyOp example (README.md:94-133) without any
per-dtype/per-ISA boilerplate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    fn: Callable  # jnp-level function (arity operands, broadcast done by caller)
    arity: int = 2
    # Function composed into fused chains and kernels; defaults to fn.
    tile_fn: Optional[Callable] = None

    def tile(self) -> Callable:
        return self.tile_fn if self.tile_fn is not None else self.fn


_REGISTRY: Dict[str, Op] = {}


def register_op(
    name: str,
    fn: Callable,
    *,
    arity: int = 2,
    tile_fn: Callable = None,
    overwrite: bool = False,
) -> Op:
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"op {name!r} already registered")
    op = Op(name=name, fn=fn, arity=arity, tile_fn=tile_fn)
    _REGISTRY[name] = op
    return op


def get_op(name: str) -> Op:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown op {name!r}; register it with sm.register_op"
        ) from None


def registered_ops():
    return dict(_REGISTRY)


# ---------------------------------------------------------------- built-ins
# Binary arithmetic (reference include/math/{add,subtract,multiply,division}.h)
register_op("add", lambda a, b: a + b)
register_op("subtract", lambda a, b: a - b)
register_op("multiply", lambda a, b: a * b)
# True division: NumPy semantics (int/int -> float), diverging from the
# reference's C++ truncating int division (include/math/division.h:67-70) on
# purpose; use floor_divide for integer division.
register_op("divide", lambda a, b: a / b)
register_op("floor_divide", lambda a, b: a // b)
register_op("remainder", lambda a, b: a % b)
register_op("maximum", jnp.maximum)
register_op("minimum", jnp.minimum)

# Comparisons.
register_op("equal", lambda a, b: a == b)
register_op("not_equal", lambda a, b: a != b)
register_op("less", lambda a, b: a < b)
register_op("less_equal", lambda a, b: a <= b)
register_op("greater", lambda a, b: a > b)
register_op("greater_equal", lambda a, b: a >= b)

# Unary.
register_op("negative", lambda a: -a, arity=1)
register_op("abs", jnp.abs, arity=1)
register_op("sqrt", jnp.sqrt, arity=1)
register_op("square", jnp.square, arity=1)
# Trig/hyperbolic ride the same engine as the arithmetic ops and compose
# under sm.fuse.
register_op("sin", jnp.sin, arity=1)
register_op("cos", jnp.cos, arity=1)
register_op("tan", jnp.tan, arity=1)
register_op("tanh", jnp.tanh, arity=1)
register_op("sign", jnp.sign, arity=1)

# Ternary elementwise: select and clamp (NumPy where/clip semantics).
# These ride the same engine/fusion/lazy machinery as the binary ops.
register_op("where", lambda c, x, y: jnp.where(c, x, y), arity=3)
register_op("clip", lambda a, lo, hi: jnp.clip(a, lo, hi), arity=3)
