"""Deferred-eager elementwise queue: chains of eager ops flush as ONE program.

The reference's eager ops each cost one full pass: ``sm.sqrt(sm.add(
sm.pow(a, 2), b))`` is three loops over the data (benchmark/pow.cpp:5-28
times them one by one).  Dispatching each op to the device separately
costs a launch and a pass over device memory each.  Instead, eager
elementwise/transcendental ops return a ``LazyArray`` that records the
expression, chains extend the recorded tree, and the first
materialization (``.jax()``/``numpy()``/print/reduction/indexing/jit
boundary) composes the tree's TILE functions — the machinery ``sm.fuse``
uses (ops/fusion.py) — into one jnp function that XLA compiles as one
fusion.

Semantics are preserved:

* operand VALUES are snapshotted at defer time (immutable jax arrays), so
  later in-place writes to an operand cannot change an already-recorded op;
* broadcast shape errors still raise at the op call (``broadcast_shapes``
  runs eagerly);
* result dtypes follow the same promotion the eager engine uses, including
  NumPy weak-scalar rules (a Python scalar operand promotes via
  ``jnp.result_type`` with the RAW scalar, then rides the program as a 0-d
  operand — no recompile per scalar value);
* a single-op tree flushes through the ORIGINAL eager code path (same tile
  object, same dispatch counter), so deferral is invisible unless a chain
  actually forms.

The composed expression is cached by tree structure + operand signature, so
eager loops re-running the same chain hit the same tile-function object —
no per-call retracing.

Disable with ``SM_DEFERRED_EAGER=0`` (config.deferred_eager).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..array import Array, as_jax
from ..broadcast import broadcast_shapes
from ..config import config

# Bounds on recorded chains: past these, the lazy operand is flushed first
# (one launch) and the chain restarts from its value.
_MAX_OPERANDS = 10
_MAX_NODES = 64


def _scalarlike(x) -> bool:
    return isinstance(x, (bool, int, float, complex, np.number))


class LazyArray(Array):
    """An ``Array`` whose value is a recorded elementwise expression.

    ``_pending`` is ``(tree, operands, shape, dtype, n_nodes)`` until the
    first materialization, after which the instance behaves exactly like the
    ``Array`` it flushed into.
    """

    __slots__ = ("_pending",)

    def __init__(self, tree, operands, shape, dtype, n_nodes):
        self._pending = (tree, tuple(operands), tuple(shape), dtype, n_nodes)
        self._storage = None
        self._spec = None

    # ------------------------------------------------------------- metadata
    @property
    def shape(self):
        p = self._pending
        return p[2] if p is not None else super().shape

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def dtype(self):
        p = self._pending
        return p[3] if p is not None else super().dtype

    @property
    def strides(self):
        self._flush()
        return super().strides

    @property
    def is_view(self):
        return False if self._pending is not None else super().is_view

    # ---------------------------------------------------------------- flush
    def _flush(self) -> "LazyArray":
        p = self._pending
        if p is not None:
            arr = _materialize(p)
            self._storage = arr._storage
            self._spec = arr._spec
            self._pending = None
        return self

    def jax(self):
        return self._flush()._spec.read(self._storage.buf)

    def __getitem__(self, key):
        self._flush()
        return super().__getitem__(key)

    def __setitem__(self, key, value):
        self._flush()
        super().__setitem__(key, value)

    def transpose(self, *axes):
        self._flush()
        return super().transpose(*axes)

    def fill(self, value):
        self._flush()
        super().fill(value)

    # ------------------------------------------------------- fused reduce
    def _lazy_reduce(self, kind: str, axis=None, keepdims=False):
        """Reduction of a pending chain WITHOUT flushing it: compose the
        recorded tree and run map+reduce as one program
        (fusion.FusedReduction) — `sm.sum(sm.square(a - b))` through the
        plain eager API never stores the mapped intermediate.  Axis
        reductions of 2-D chains take the same route."""
        from . import fusion

        tree, operands, shape, dtype, _ = self._pending
        specs = tuple(
            (tuple(o.shape), jnp.dtype(o.dtype).name,
             bool(getattr(o, "weak_type", False)))
            for o in operands
        )
        expr = _compose(tree, specs, config.transcendental_impl)
        return fusion.reduce_node(
            kind, expr, axis=axis, keepdims=keepdims
        ).materialize(operands)

    def _reducible(self, axis, keepdims) -> bool:
        if self._pending is None:
            return False
        if axis is None:
            return not keepdims
        shape = self._pending[2]
        return isinstance(axis, int) and len(shape) == 2

    def sum(self, axis=None, keepdims=False):
        if self._reducible(axis, keepdims):
            return self._lazy_reduce("sum", axis, keepdims)
        return super().sum(axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        if self._reducible(axis, keepdims):
            return self._lazy_reduce("mean", axis, keepdims)
        return super().mean(axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        if self._reducible(axis, keepdims):
            return self._lazy_reduce("max", axis, keepdims)
        return super().max(axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        if self._reducible(axis, keepdims):
            return self._lazy_reduce("min", axis, keepdims)
        return super().min(axis=axis, keepdims=keepdims)


def _flatten_lazy(a: LazyArray):
    return (a.jax(),), None


def _unflatten_lazy(aux, children):
    return Array(children[0])


jax.tree_util.register_pytree_node(LazyArray, _flatten_lazy, _unflatten_lazy)


# ---------------------------------------------------------------- recording
def _as_operand(x):
    """(tree_fragment, operands, shape, raw_for_promotion, n_nodes) for one
    input.  ``raw_for_promotion`` is the Python scalar itself (weak typing)
    or the operand dtype."""
    if isinstance(x, LazyArray) and x._pending is not None:
        tree, ops, shape, dtype, n = x._pending
        if len(ops) >= _MAX_OPERANDS or n >= _MAX_NODES:
            x._flush()
        else:
            return tree, list(ops), shape, dtype, n
    if _scalarlike(x):
        v = jnp.asarray(x)
        return ("leaf", 0), [v], (), x, 1
    v = jnp.asarray(as_jax(x))
    return ("leaf", 0), [v], tuple(v.shape), v.dtype, 1


def _merge(*frags):
    """Concatenate the fragments' operand lists (deduping identical
    objects) and remap each fragment's leaf indices into the merged list.
    Returns ``(ops, tree_0, tree_1, ...)``."""
    ops: list = []
    index: dict = {}
    out_trees = []
    for tree, f_ops, *_ in frags:
        remap = []
        for o in f_ops:
            i = index.get(id(o))
            if i is None:
                i = len(ops)
                ops.append(o)
                index[id(o)] = i
            remap.append(i)

        def rewrite(t, remap=remap):
            if t[0] == "leaf":
                return ("leaf", remap[t[1]])
            return t[:1] + tuple(
                rewrite(x, remap) if isinstance(x, tuple) else x
                for x in t[1:]
            )

        out_trees.append(rewrite(tree))
    return (ops, *out_trees)


def enabled() -> bool:
    return config.deferred_eager


# Representative scalar per weak-type tag: jnp promotion depends on the
# Python type, not the value, so one abstract eval per (op, signature, tag)
# is cached and reused for every scalar of that type.
_WEAK_REP = {"bool": True, "int": 2, "float": 1.5, "complex": 1.5j}


def _sig(frag):
    """Hashable promotion signature of one recorded input: a weak-type tag
    for Python scalars (value-independent promotion), (shape, dtype-name)
    otherwise.  NumPy scalars are strongly typed in jnp and take the
    (shape, dtype) form."""
    raw = frag[3]
    if isinstance(raw, np.number):
        return (frag[2], jnp.dtype(type(raw)).name)
    if isinstance(raw, bool):
        return "bool"
    if isinstance(raw, int):
        return "int"
    if isinstance(raw, float):
        return "float"
    if isinstance(raw, complex):
        return "complex"
    return (frag[2], jnp.dtype(raw).name)


@functools.lru_cache(maxsize=4096)
def _infer(name: str, *sigs):
    """Result aval of the eager jnp op for this signature — the lazy chain
    must report (and flush to) exactly the dtype the eager XLA path would
    produce, including int->float ops (divide, sqrt) and weak-scalar
    promotion."""
    from . import registry

    args = [
        _WEAK_REP[s] if isinstance(s, str)
        else jax.ShapeDtypeStruct(s[0], jnp.dtype(s[1]))
        for s in sigs
    ]
    return jax.eval_shape(registry.get_op(name).fn, *args)


def _deferrable(x) -> bool:
    """An input the queue can record: array-like with a static shape, a
    scalar, or another lazy array.  (FusedExpr is handled by callers.)"""
    if isinstance(x, LazyArray) or _scalarlike(x):
        return True
    if isinstance(x, Array):
        return True
    if isinstance(x, (np.ndarray, jax.Array)) or isinstance(x, jax.core.Tracer):
        return True
    return False


def defer_binary(name: str, a, b):
    """Record a registry binary op; returns a LazyArray or None (caller
    falls through to the eager path)."""
    if not (enabled() and _deferrable(a) and _deferrable(b)):
        return None
    fa = _as_operand(a)
    fb = _as_operand(b)
    # Shape errors keep the eager engine's NumPy-style message and raise at
    # the op call, not at flush.
    broadcast_shapes(fa[2], fb[2])
    aval = _infer(name, _sig(fa), _sig(fb))
    ops, ta, tb = _merge(fa, fb)
    return LazyArray(
        ("op2", name, ta, tb), ops, aval.shape, aval.dtype, fa[4] + fb[4] + 1
    )


def defer_ternary(name: str, a, b, c):
    """Record a registry ternary op (where/clip)."""
    if not (enabled() and _deferrable(a) and _deferrable(b) and _deferrable(c)):
        return None
    fa = _as_operand(a)
    fb = _as_operand(b)
    fc = _as_operand(c)
    broadcast_shapes(broadcast_shapes(fa[2], fb[2]).result_shape, fc[2])
    aval = _infer(name, _sig(fa), _sig(fb), _sig(fc))
    ops, ta, tb, tc = _merge(fa, fb, fc)
    return LazyArray(
        ("op3", name, ta, tb, tc), ops, aval.shape, aval.dtype,
        fa[4] + fb[4] + fc[4] + 1,
    )


def defer_unary(name: str, a):
    """Record a registry unary op."""
    if not (enabled() and _deferrable(a) and not _scalarlike(a)):
        return None
    fa = _as_operand(a)
    aval = _infer(name, _sig(fa))
    return LazyArray(("op1", name, fa[0]), fa[1], aval.shape, aval.dtype, fa[4] + 1)


def defer_trans(name: str, a):
    """Record a transcendental unary (exp/log/exp2/log2): float output,
    f32 for non-float inputs, f64 passthrough (the compose step falls to
    the jnp tile for f64, matching fusion.unary_node)."""
    if not (enabled() and _deferrable(a) and not _scalarlike(a)):
        return None
    fa = _as_operand(a)
    dt = jnp.result_type(fa[3])
    if not jnp.issubdtype(dt, jnp.floating):
        dt = jnp.dtype(jnp.float32)
    return LazyArray(("op1", name, fa[0]), fa[1], fa[2], dt, fa[4] + 1)


def defer_pow(a, b):
    """Record ``sm.pow`` with the eager engine's exact specialization
    ladder: int^int -> crafted square-and-multiply, float ** static small
    int -> repeated squaring, else the range-reduced float pow."""
    if not (enabled() and _deferrable(a) and _deferrable(b)):
        return None
    fa = _as_operand(a)
    a_dt = jnp.result_type(fa[3])
    if (
        isinstance(b, (int, float))
        and not isinstance(b, bool)
        and float(b) == int(b)
        and abs(int(b)) <= 64
        and jnp.issubdtype(a_dt, jnp.floating)
    ):
        return LazyArray(
            ("powi", int(b), fa[0]), fa[1], fa[2], a_dt, fa[4] + 1
        )
    fb = _as_operand(b)
    out_shape = broadcast_shapes(fa[2], fb[2]).result_shape
    b_dt = jnp.result_type(fb[3])
    if jnp.issubdtype(a_dt, jnp.integer) and jnp.issubdtype(b_dt, jnp.integer):
        out_dt = jnp.result_type(fa[3], fb[3])
    else:
        out_dt = jnp.result_type(fa[3], fb[3])
        if not jnp.issubdtype(out_dt, jnp.floating):
            out_dt = jnp.dtype(jnp.float32)
    ops, ta, tb = _merge(fa, fb)
    return LazyArray(("pow", ta, tb), ops, out_shape, out_dt, fa[4] + fb[4] + 1)


# ------------------------------------------------------------------ compose
@functools.lru_cache(maxsize=1024)
def _compose(tree, specs, impl):
    """Tree + operand signature -> FusedExpr (the same node constructors
    ``sm.fuse`` traces through, so tiles and impl selection are shared).

    Each spec carries the operand's weak_type flag: a Python-scalar
    snapshot is a WEAK 0-d array, and dropping that here would make the
    node dtype inference promote (e.g. f32 chain + weak-f64 scalar under
    x64 -> f64 nodes, which routes transcendentals to the f64/jnp branch
    and changes the chain's dtype)."""
    from . import fusion

    sds = tuple(
        jax.ShapeDtypeStruct(s, jnp.dtype(d), weak_type=w) for s, d, w in specs
    )
    leaves = [fusion.FusedExpr(fusion._leaf_fn(i), sds) for i in range(len(sds))]

    def build(t):
        tag = t[0]
        if tag == "leaf":
            return leaves[t[1]]
        if tag == "op2":
            return fusion.binary_node(t[1], build(t[2]), build(t[3]))
        if tag == "op3":
            return fusion.ternary_node(t[1], build(t[2]), build(t[3]), build(t[4]))
        if tag == "op1":
            return fusion.unary_node(t[1], build(t[2]))
        if tag == "powi":
            return fusion.pow_node(build(t[2]), t[1])
        if tag == "pow":
            return fusion.pow_node(build(t[1]), build(t[2]))
        raise AssertionError(f"unknown lazy tree node {tag!r}")

    return build(tree)


def _materialize(pending) -> Array:
    """One program for the recorded chain.  Single-op trees replay the
    ORIGINAL eager path (identical tile object and dispatch name); real
    chains compose into one jnp function."""
    tree, operands, shape, dtype, n_nodes = pending
    from . import dispatch, engine, transcendental

    tag = tree[0]
    single = all(t[0] == "leaf" for t in tree[1:] if isinstance(t, tuple))
    if single:
        # Scalar inputs were snapshotted as 0-d arrays, so the replay can
        # promote past the recorded weak-typed dtype — cast back.
        def _as_recorded(res: Array) -> Array:
            return res if jnp.dtype(res.dtype) == jnp.dtype(dtype) else res.astype(dtype)

        if tag == "op2":
            return _as_recorded(
                engine.binary_eager(
                    tree[1], operands[tree[2][1]], operands[tree[3][1]]
                )
            )
        if tag == "op3":
            return _as_recorded(
                engine.ternary_eager(
                    tree[1], operands[tree[2][1]], operands[tree[3][1]],
                    operands[tree[4][1]],
                )
            )
        if tag == "op1":
            name = tree[1]
            if name in ("exp", "log", "exp2", "log2", "sin", "cos", "tan", "tanh"):
                return Array(
                    getattr(transcendental, name)(operands[tree[2][1]]).astype(dtype)
                )
            return _as_recorded(engine.unary_eager(name, operands[tree[2][1]]))
        if tag == "powi":
            dispatch.record("elementwise", "powi")
            return Array(engine._static_int_pow(operands[tree[2][1]], tree[1]))
        if tag == "pow":
            return _as_recorded(
                engine.pow_eager(operands[tree[1][1]], operands[tree[2][1]])
            )

    specs = tuple(
        (tuple(o.shape), jnp.dtype(o.dtype).name, bool(getattr(o, "weak_type", False)))
        for o in operands
    )
    expr = _compose(tree, specs, config.transcendental_impl)
    dispatch.record("elementwise", "fused")
    return Array(jnp.broadcast_to(jnp.asarray(expr.fn(*operands)), shape).astype(dtype))
