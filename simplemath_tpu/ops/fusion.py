"""Fused elementwise expressions: chain sm ops into one program.

The reference's op chain ``sm::pow`` then exp costs one full pass over the
data per op (each ``element_wise_op`` call is its own OpenMP/SIMD loop,
include/math/calculate.h:5-99).

``sm.fuse`` traces a user function built from sm ops over symbolic
``FusedExpr`` nodes and composes their TILE-level implementations (the same
``tile_fn``s the registry/transcendental layer defines) into a single jnp
function, which XLA compiles as one fusion — one read of each operand, one
write of the output, broadcast operands read with stride 0::

    fused = sm.fuse(lambda a, e: sm.exp(sm.pow(a, e)))
    y = fused(a, e_row)        # one fusion; e_row (1, n) broadcasts

The composed expression is cached per input signature (shapes + dtypes), so
repeated calls reuse the same tile function object.

Supported inside a fused function: the registered elementwise ops
(+ - * / // % maximum minimum negative abs sqrt square, comparisons),
``sm.exp/log/exp2/log2``, ``sm.sin/cos/tan/tanh`` and ``sm.pow``
(static-integer exponents specialize to repeated squaring, exactly like the
public path), with Python scalars as constants.  Array-valued constants
must be passed as arguments to the fused function — every array the
program reads has to be an operand.  A ``sm.sum/mean/max/min`` (full or
single-axis) may be the ROOT of the fused function: the chain and the
reduction then compile together (``FusedReduction``)::

    sqdist = sm.fuse(lambda a, b: sm.sum(sm.square(a - b)))
    d = sqdist(x, y)           # (x-y)^2 never stored

``iterations=L`` iterates the chain with one input as the loop carry; on a
GPU that runs as the Triton kernel of ops/fuse_loop.py.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..array import Array, as_jax
from ..config import config


def _leaf_fn(i: int) -> Callable:
    def leaf(*args):
        return args[i]

    return leaf


class FusedExpr:
    """Symbolic node of a fused elementwise expression.

    ``fn(*all_operands)`` computes this node's value from the fused
    function's input arrays (or their blocks, inside a kernel); all
    nodes of one trace share the same operand signature ``specs``.

    ``leaf`` is the operand index for direct-argument leaves (None for
    composed nodes), ``used`` the set of leaf indices this node reads
    elementwise, and ``mm`` the (a_leaf, b_leaf) pair when the expression
    contains a matmul root (at most one per fused function) — in that case
    every node ``fn`` takes one extra trailing argument, the matmul
    product."""

    __slots__ = ("fn", "specs", "_aval", "leaf", "used", "mm")

    def __init__(
        self,
        fn: Callable,
        specs: Tuple[jax.ShapeDtypeStruct, ...],
        leaf: int = None,
        used: frozenset = frozenset(),
        mm: tuple = None,
    ):
        self.fn = fn
        self.specs = specs
        self._aval = None
        self.leaf = leaf
        self.used = used
        self.mm = mm

    @property
    def aval(self) -> jax.ShapeDtypeStruct:
        if self._aval is None:
            self._aval = jax.eval_shape(lambda args: self.fn(*args), self.specs)
        return self._aval

    @property
    def shape(self):
        return self.aval.shape

    @property
    def dtype(self):
        return self.aval.dtype

    # ------------------------------------------------------------ operators
    def __add__(self, o):
        return binary_node("add", self, o)

    def __radd__(self, o):
        return binary_node("add", o, self)

    def __sub__(self, o):
        return binary_node("subtract", self, o)

    def __rsub__(self, o):
        return binary_node("subtract", o, self)

    def __mul__(self, o):
        return binary_node("multiply", self, o)

    def __rmul__(self, o):
        return binary_node("multiply", o, self)

    def __truediv__(self, o):
        return binary_node("divide", self, o)

    def __rtruediv__(self, o):
        return binary_node("divide", o, self)

    def __floordiv__(self, o):
        return binary_node("floor_divide", self, o)

    def __mod__(self, o):
        return binary_node("remainder", self, o)

    def __pow__(self, o):
        return pow_node(self, o)

    def __matmul__(self, o):
        return matmul_node(self, o)

    def __rmatmul__(self, o):
        return matmul_node(o, self)

    def __neg__(self):
        return unary_node("negative", self)

    def __abs__(self):
        return unary_node("abs", self)

    # Comparisons build bool-valued nodes (for sm.where conditions etc.).
    def __eq__(self, o):
        return binary_node("equal", self, o)

    def __ne__(self, o):
        return binary_node("not_equal", self, o)

    def __lt__(self, o):
        return binary_node("less", self, o)

    def __le__(self, o):
        return binary_node("less_equal", self, o)

    def __gt__(self, o):
        return binary_node("greater", self, o)

    def __ge__(self, o):
        return binary_node("greater_equal", self, o)

    def __hash__(self):
        return id(self)

    # ---------------------------------------------------------- materialize
    def materialize(self, operands, donate=None, iterations=1, carry=0) -> Array:
        from . import dispatch, fuse_loop
        from .. import platform

        out_shape = self.shape
        out_dtype = self.dtype
        if donate is not None and (
            tuple(operands[donate].shape) != tuple(out_shape)
            or jnp.dtype(operands[donate].dtype) != jnp.dtype(out_dtype)
        ):
            raise ValueError(
                f"donated operand {donate} must match output shape/dtype; got "
                f"{operands[donate].shape}/{operands[donate].dtype} vs "
                f"{out_shape}/{out_dtype}"
            )
        if iterations == 1:
            dispatch.record("elementwise", "fused")
            out = jnp.broadcast_to(jnp.asarray(self.fn(*operands)), out_shape)
            return Array(out.astype(out_dtype))
        route = platform.fuse_loop_route(
            out_shape, [o.shape for o in operands], out_dtype, iterations
        )
        if route == "triton":
            return Array(
                fuse_loop.iterate(
                    self.fn, out_shape, out_dtype, operands,
                    iterations=iterations, carry=carry, donate=donate,
                )
            )
        dispatch.record("fuse_loop", "xla")

        def body(_, c):
            args = list(operands)
            args[carry] = c
            return jnp.asarray(self.fn(*args)).astype(out_dtype)

        return Array(
            jax.lax.fori_loop(
                0, iterations, body, operands[carry].astype(out_dtype)
            )
        )

    # --------------------------------------------------- matmul epilogue
    def materialize_matmul(self, operands) -> Array:
        """A matmul-rooted expression: the product, then the traced
        elementwise epilogue on it; XLA fuses the epilogue into the
        GEMM's output under jit."""
        from . import dispatch, engine

        a_i, b_i = self.mm
        if a_i in self.used or b_i in self.used:
            raise TypeError(
                "the matmul operands cannot also be used elementwise in "
                "the fused epilogue; pass a separate argument"
            )
        A = jnp.asarray(operands[a_i])
        B = jnp.asarray(operands[b_i])
        mm_dtype = jnp.result_type(A, B)
        dispatch.record("matmul", "bmm_epilogue" if A.ndim == 3 else "mm_epilogue")
        preferred, prec = engine._fallback_precision(A.shape, B.shape, mm_dtype)
        prod = jnp.matmul(A, B, preferred_element_type=preferred, precision=prec)
        return Array(jnp.asarray(self.fn(*operands, prod)).astype(self.dtype))


class FusedReduction:
    """Root node: a reduction over a fused elementwise expression.

    ``sm.sum/mean/max/min`` applied to a FusedExpr produce one of these;
    ``sm.fuse`` materializes the mapped expression and its reduction as one
    jnp program, which XLA's reduction emitter fuses into a single pass (the
    mapped expression is never stored).  Full (axis=None) and single-axis
    reductions are supported.  Reduction results cannot be composed
    further inside the same fused function."""

    __slots__ = ("kind", "expr", "axis", "keepdims")

    def __init__(self, kind: str, expr: FusedExpr, axis=None, keepdims=False):
        self.kind = kind
        self.expr = expr
        self.axis = axis
        self.keepdims = keepdims

    def _no_compose(self, *_a, **_k):
        raise TypeError(
            "reduction results cannot be composed further inside sm.fuse; "
            "make the reduction the LAST op of the fused function"
        )

    __add__ = __radd__ = __sub__ = __rsub__ = _no_compose
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = _no_compose
    __floordiv__ = __mod__ = __pow__ = __neg__ = __abs__ = _no_compose

    def materialize(self, operands) -> Array:
        from . import dispatch

        expr = self.expr
        shape = expr.shape
        dtype = expr.dtype
        kind = "sum" if self.kind == "mean" else self.kind
        jnp_fn = {"sum": jnp.sum, "max": jnp.max, "min": jnp.min}[kind]
        mapped = jnp.broadcast_to(jnp.asarray(expr.fn(*operands)), shape)
        if jnp.issubdtype(dtype, jnp.floating) and dtype != jnp.dtype(jnp.float64):
            # f32 accumulation for narrow floats, as np.float32 sums do.
            mapped = mapped.astype(jnp.float32)
        if self.axis is None:
            dispatch.record("reduce_fused", kind)
            total = jnp_fn(mapped)
            count = mapped.size
        else:
            dispatch.record("reduce_axis", f"{kind}{self.axis}")
            total = jnp_fn(mapped, axis=self.axis)
            count = shape[self.axis]
        if self.kind == "mean":
            total = total / count
        if jnp.issubdtype(dtype, jnp.floating):
            total = total.astype(dtype)
        if self.keepdims:
            total = jnp.expand_dims(total, self.axis)
        return Array(total)


def reduce_node(kind: str, a, axis=None, keepdims=False) -> FusedReduction:
    """api._reduce_free hook: (full or single-axis) reduction rooting a
    fused expression."""
    if isinstance(a, FusedReduction):
        raise TypeError(
            "a reduction result cannot be reduced again inside sm.fuse"
        )
    if not isinstance(a, FusedExpr):
        raise TypeError(f"sm.{kind} fused-reduction requires a fused expression")
    if axis is not None:
        if isinstance(axis, (tuple, list)):
            raise TypeError(
                f"sm.{kind} inside sm.fuse supports a single int axis, "
                f"got {axis!r}"
            )
        nd = len(a.shape)
        ax = int(axis) + nd if int(axis) < 0 else int(axis)
        if not (0 <= ax < nd):
            raise ValueError(
                f"axis {axis} out of bounds for fused expression of rank {nd}"
            )
        return FusedReduction(kind, a, axis=ax, keepdims=keepdims)
    if keepdims:
        raise TypeError(
            f"sm.{kind}(keepdims=True) without an axis is not supported "
            "inside sm.fuse"
        )
    return FusedReduction(kind, a)


def _reject_reduction(*xs):
    if any(isinstance(x, FusedReduction) for x in xs):
        raise TypeError(
            "reduction results cannot be composed further inside sm.fuse; "
            "make the reduction the LAST op of the fused function"
        )


def is_fused(x) -> bool:
    return isinstance(x, (FusedExpr, FusedReduction))


def _lift(x, specs) -> FusedExpr:
    """Coerce a python scalar to a constant node; reject array constants."""
    if isinstance(x, FusedExpr):
        return x
    if isinstance(x, (bool, int, float, complex, np.number)):
        const = x

        def fn(*args):
            return const

        return FusedExpr(fn, specs)
    if isinstance(x, (np.ndarray, jax.Array, Array)) and np.ndim(x) == 0:
        const = jnp.asarray(as_jax(x))

        def fn(*args):
            return const

        return FusedExpr(fn, specs)
    raise TypeError(
        "fused expressions only accept Python scalars as constants; pass "
        f"array values (got {type(x).__name__}) as arguments to the fused "
        "function so the program reads them as operands"
    )


def _merge_meta(*xs):
    """(specs, used, mm) merged over the FusedExpr children of a node:
    union of elementwise-used leaves, the unique matmul root (at most one
    per fused function), and the longest specs (matmul-descendant nodes
    carry one extra trailing spec — the product)."""
    used = frozenset()
    mm = None
    specs = None
    for x in xs:
        if isinstance(x, FusedExpr):
            used |= x.used
            if x.mm is not None:
                if mm is not None and mm != x.mm:
                    raise TypeError(
                        "sm.fuse supports at most one matmul per fused "
                        "function"
                    )
                mm = x.mm
            if specs is None or len(x.specs) > len(specs):
                specs = x.specs
    return specs, used, mm


def binary_node(name: str, a, b) -> FusedExpr:
    from . import registry

    _reject_reduction(a, b)
    if name == "pow":
        return pow_node(a, b)
    specs, used, mm = _merge_meta(a, b)
    a = _lift(a, specs)
    b = _lift(b, specs)
    tile = registry.get_op(name).tile()
    fa, fb = a.fn, b.fn

    def fn(*args):
        return tile(fa(*args), fb(*args))

    return FusedExpr(fn, specs, used=used, mm=mm)


# f64 nodes fall back to the jnp op — the tile implementations are
# f32-grade, matching transcendental._dispatch_unary.
_TRANS_F64 = {
    "exp": jnp.exp,
    "log": jnp.log,
    "exp2": jnp.exp2,
    "log2": jnp.log2,
    "sin": jnp.sin,
    "cos": jnp.cos,
    "tan": jnp.tan,
    "tanh": jnp.tanh,
}


def unary_node(name: str, a: FusedExpr) -> FusedExpr:
    from . import registry, transcendental

    _reject_reduction(a)
    if not isinstance(a, FusedExpr):
        raise TypeError(f"unary fused op {name!r} requires a FusedExpr")
    if name in _TRANS_F64:
        if a.dtype == jnp.dtype(jnp.float64):
            tile = _TRANS_F64[name]
        else:
            out_dt = (
                a.dtype
                if jnp.issubdtype(a.dtype, jnp.floating)
                else jnp.dtype(jnp.float32)
            )
            # Same impl selection (native vs crafted) as the public
            # dispatchers; the tile object is the dispatcher's own cached
            # closure, so fused and unfused paths share compiled programs.
            tile = transcendental._unary_tile(
                name, jnp.dtype(out_dt).name, config.transcendental_impl
            )
    else:
        tile = registry.get_op(name).tile()
    fa = a.fn

    def fn(*args):
        return tile(fa(*args))

    return FusedExpr(fn, a.specs, used=a.used, mm=a.mm)


def pow_node(a, b) -> FusedExpr:
    """Fused ``sm.pow`` — same specialization ladder as the public
    ``engine.pow``: int^int takes the crafted square-and-multiply,
    float with a static small-integer exponent takes exact repeated
    squaring, everything else the correct-range-reduction float pow."""
    from . import engine, transcendental

    _reject_reduction(a, b)
    specs, used, mm = _merge_meta(a, b)
    a = _lift(a, specs)
    a_float = jnp.issubdtype(a.dtype, jnp.floating)
    if (
        isinstance(b, (int, float))
        and not isinstance(b, bool)
        and float(b) == int(b)
        and abs(int(b)) <= 64
        and a_float
    ):
        e = int(b)
        fa = a.fn

        def fn(*args):
            return engine._static_int_pow(fa(*args), e)

        return FusedExpr(fn, specs, used=used, mm=mm)
    b = _lift(b, specs)
    if jnp.issubdtype(a.dtype, jnp.integer) and jnp.issubdtype(b.dtype, jnp.integer):
        fa, fb = a.fn, b.fn

        def fn(*args):
            return transcendental.ipow_tile(fa(*args), fb(*args))

        return FusedExpr(fn, specs, used=used, mm=mm)
    out_dt = jnp.promote_types(a.dtype, b.dtype)
    if not jnp.issubdtype(out_dt, jnp.floating):
        out_dt = jnp.dtype(jnp.float32)
    if out_dt == jnp.dtype(jnp.float64):
        fa, fb = a.fn, b.fn

        def fn(*args):
            return jnp.power(fa(*args), fb(*args))

        return FusedExpr(fn, specs, used=used, mm=mm)
    fa, fb = a.fn, b.fn
    tile = transcendental._pow_tile(
        jnp.dtype(out_dt).name, config.transcendental_impl
    )

    def fn(*args):
        return tile(fa(*args), fb(*args))

    return FusedExpr(fn, specs, used=used, mm=mm)


def ternary_node(name: str, a, b, c) -> FusedExpr:
    from . import registry

    _reject_reduction(a, b, c)
    specs, used, mm = _merge_meta(a, b, c)
    a = _lift(a, specs)
    b = _lift(b, specs)
    c = _lift(c, specs)
    tile = registry.get_op(name).tile()
    fa, fb, fc = a.fn, b.fn, c.fn

    def fn(*args):
        return tile(fa(*args), fb(*args), fc(*args))

    return FusedExpr(fn, specs, used=used, mm=mm)


def matmul_node(a, b) -> FusedExpr:
    """``x @ W`` inside a fused function: a matmul ROOT whose elementwise
    consumers become its epilogue, which XLA fuses into the GEMM's output.
    Reference analog: the per-op extension story (README.md:86-133)
    composed with the reduction engine (product.h).

    Both operands must be DIRECT arguments of the fused function, and at
    most one matmul per fused function.  The matmul operands cannot also
    be used elementwise in the epilogue."""
    _reject_reduction(a, b)
    if not (
        isinstance(a, FusedExpr)
        and isinstance(b, FusedExpr)
        and a.leaf is not None
        and b.leaf is not None
    ):
        raise TypeError(
            "matmul inside sm.fuse requires direct arguments of the fused "
            "function (not composed expressions)"
        )
    if a.mm is not None or b.mm is not None:
        raise TypeError(
            "sm.fuse supports at most one matmul per fused function"
        )
    rank = len(a.shape)
    ok = (
        len(b.shape) == rank
        and rank in (2, 3)
        and a.shape[-1] == b.shape[-2]
        and (rank == 2 or a.shape[0] == b.shape[0])
    )
    if not ok:
        raise TypeError(
            f"fused matmul requires 2-D (M,K) @ (K,N) or batched "
            f"(B,M,K) @ (B,K,N) arguments; got {a.shape} @ {b.shape}"
        )
    out_dt = jnp.result_type(a.dtype, b.dtype)
    out_shape = (
        (a.shape[0], b.shape[1])
        if rank == 2
        else (a.shape[0], a.shape[1], b.shape[2])
    )
    prod_spec = jax.ShapeDtypeStruct(out_shape, out_dt)
    specs = a.specs + (prod_spec,)

    def fn(*args):
        return args[-1]

    return FusedExpr(fn, specs, used=frozenset(), mm=(a.leaf, b.leaf))


def apply_by_name(name: str, *args) -> FusedExpr:
    """Dispatch hook for the free-function layer (api._wrap1/_wrap2)."""
    if len(args) == 1:
        return unary_node(name, args[0])
    if len(args) == 3:
        return ternary_node(name, *args)
    return binary_node(name, *args)


def fuse(
    fn: Callable,
    donate: int | None = None,
    iterations: int = 1,
    carry: int = 0,
) -> Callable:
    """Wrap ``fn`` (built from sm ops) so calls execute as one program.

    The returned function accepts Arrays / jax arrays / numpy arrays; the
    expression is traced once per input signature and cached, so the fused
    tile function is a stable object across calls.

    ``donate=i`` declares input ``i`` (which must match the output
    shape/dtype) dead after the call, so the iterated kernel may write the
    output over it.

    ``iterations=L`` runs the WHOLE chain L times, feeding the result back
    as input ``carry`` each pass — iterated elementwise recurrences like
    ``acc = f(acc, ...)``.  On a GPU, when every input is full-shape or a
    single element, it runs as one Triton kernel that keeps the carry in
    registers for all L iterations (ops/fuse_loop.py); otherwise as an
    XLA ``fori_loop`` (``platform.fuse_loop_route``).  The expression's
    output must match input ``carry``'s shape/dtype, and input ``carry``
    cannot be a broadcast operand.
    """
    if iterations < 1:
        raise ValueError(f"iterations must be >= 1, got {iterations}")
    cache = {}

    @functools.wraps(fn)
    def fused(*arrays):
        ops = [jnp.asarray(as_jax(a)) for a in arrays]
        key = tuple(
            (tuple(o.shape), jnp.dtype(o.dtype).name,
             bool(getattr(o, "weak_type", False)))
            for o in ops
        ) + (config.transcendental_impl,)
        expr = cache.get(key)
        if expr is None:
            # weak_type must survive into the specs: a weak 0-d scalar
            # argument would otherwise promote the whole chain (f32 chain +
            # weak-f64 scalar under x64 -> f64 nodes — the same bug class
            # fixed in ops/lazy.py::_compose).
            specs = tuple(
                jax.ShapeDtypeStruct(
                    o.shape, o.dtype,
                    weak_type=bool(getattr(o, "weak_type", False)),
                )
                for o in ops
            )
            leaves = [
                FusedExpr(_leaf_fn(i), specs, leaf=i, used=frozenset((i,)))
                for i in range(len(ops))
            ]
            expr = fn(*leaves)
            if not isinstance(expr, (FusedExpr, FusedReduction)):
                raise TypeError(
                    "the function passed to sm.fuse must return a fused "
                    f"expression built from sm ops; got {type(expr).__name__}"
                )
            if isinstance(expr, FusedReduction):
                if iterations != 1:
                    raise ValueError(
                        "sm.fuse(iterations=...) does not compose with a "
                        "reduction root (the result is a scalar)"
                    )
                if expr.expr.mm is not None:
                    raise TypeError(
                        "a reduction over a fused matmul epilogue is not "
                        "supported; materialize the epilogue first"
                    )
                expr.expr.aval  # force shape/dtype inference at trace time
            else:
                if expr.mm is not None and iterations != 1:
                    raise ValueError(
                        "sm.fuse(iterations=...) does not compose with a "
                        "matmul root"
                    )
                expr.aval  # force shape/dtype inference at trace time
            if iterations != 1 and (
                expr.shape != tuple(ops[carry].shape)
                or jnp.dtype(expr.dtype) != jnp.dtype(ops[carry].dtype)
            ):
                raise ValueError(
                    f"sm.fuse(iterations={iterations}): the expression "
                    f"result ({expr.shape}, {expr.dtype}) must match carry "
                    f"input {carry} ({tuple(ops[carry].shape)}, "
                    f"{ops[carry].dtype}) so it can feed back"
                )
            cache[key] = expr
        if isinstance(expr, FusedReduction):
            return expr.materialize(ops)
        if expr.mm is not None:
            return expr.materialize_matmul(ops)
        return expr.materialize(
            ops, donate=donate, iterations=iterations, carry=carry
        )

    fused._cache = cache  # traced expressions, by input signature
    return fused
