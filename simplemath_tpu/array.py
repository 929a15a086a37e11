"""The ``Array`` container — re-creation of ``sm::SMArray<T>`` in JAX.

Reference: ``include/SMArray.h:30-438``.  The reference owns a raw ``T*`` plus
shape/strides/ndim/totalSize/isView and implements views by pointer
arithmetic.  Here the buffer is an immutable ``jax.Array`` held in a shared
``_Storage`` cell, and views are index expressions (``ViewSpec``) over that
cell, which preserves the observable aliasing semantics (writes through a
view are visible to the parent and all sibling views) while lowering every
access to XLA ``slice``/``transpose``/``scatter`` ops that fuse cleanly.

API parity map (reference -> here):

* nested initializer-list ctor (SMArray.h:36-68)  -> ``Array([[...]])``
* adopt-pointer ctor (SMArray.h:70-76)            -> ``Array(jax_or_numpy_array)``
* ``operator()`` value access (SMArray.h:99-119)  -> ``a(i, j)`` (scalar) /
  ``a(i, SLICE_ALL)`` (view); ``a[...]`` is the NumPy-style spelling
* ``accessByArray`` view slicing (SMArray.h:397-437) -> ``__getitem__``/``__call__``
* element assignment ``a(i,j) = v`` (C++ reference) -> ``a[i, j] = v`` / ``a.set(idx, v)``
* ``transpose`` (SMArray.h:121-136)               -> ``transpose()`` / ``.T``
* ``repeat`` flat + axis (SMArray.h:138-211)      -> ``repeat(n[, axis])`` with
  the *intended* semantics (the reference's flat repeat overwrites
  overlapping indices, SMArray.h:145-149; SURVEY §2.4-4 — fixed here)
* ``operator% `` dot product (SMArray.h:213-215)  -> ``a @ b`` / ``a.dot(b)``
  (``%`` itself is NumPy remainder here)
* ``operator+ - * /`` array & scalar (SMArray.h:217-305) -> python operators
* ``toString``/``operator<<`` (SMArray.h:306-332, UserFunctions.h:54-57)
  -> ``str(a)`` / ``repr(a)``

Scalar ops and reductions respect views/strides — fixing reference quirk
SURVEY §2.4-3 (include/math/calculate.h:137-169 iterates the flat buffer).
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from . import dtypes as _dtypes
from .slicing import Slice, process_index
from .viewspec import ViewSpec


class _Storage:
    """Shared mutable cell holding the base jax buffer (alias of ``T* data``)."""

    __slots__ = ("buf",)

    def __init__(self, buf):
        self.buf = buf


def _normalize_key(key, ndim: int) -> list:
    """Expand a user key (scalar / tuple with Ellipsis / Slice objects) into a
    list of int|slice over the array's dims.  ``None`` (newaxis) entries are
    handled by the caller (`_split_newaxes`) before reaching here."""
    if not isinstance(key, tuple):
        key = (key,)
    # Expand Ellipsis.  None consumes no input dim.
    n_explicit = sum(1 for k in key if k is not Ellipsis and k is not None)
    out = []
    seen_ellipsis = False
    for k in key:
        if k is Ellipsis:
            if seen_ellipsis:
                raise IndexError("an index can only have a single ellipsis")
            seen_ellipsis = True
            out.extend([slice(None)] * (ndim - n_explicit))
        else:
            out.append(process_index(k))
    return out


def _split_newaxes(key, ndim: int):
    """Split ``None`` (np.newaxis) entries out of a key.

    Returns ``(base_key, newaxis_positions)`` where ``base_key`` has the
    Nones removed and ``newaxis_positions`` are the output-dim indices at
    which size-1 axes must be inserted (computed after Ellipsis expansion,
    accounting for int keys collapsing dims)."""
    if not isinstance(key, tuple):
        key = (key,)
    if not any(k is None for k in key):
        return key, ()
    # Expand Ellipsis first so output positions are well defined.
    n_explicit = sum(1 for k in key if k is not Ellipsis and k is not None)
    expanded = []
    for k in key:
        if k is Ellipsis:
            expanded.extend([slice(None)] * (ndim - n_explicit))
        else:
            expanded.append(k)
    # Pad implicit trailing full slices so every base dim is represented.
    expanded += [slice(None)] * (ndim - sum(1 for k in expanded if k is not None))
    base_key, positions, out_dim = [], [], 0
    for k in expanded:
        if k is None:
            positions.append(out_dim)
            out_dim += 1
        else:
            base_key.append(k)
            is_int = not isinstance(k, (slice, Slice)) and (
                isinstance(k, int) or hasattr(k, "__index__")
            )
            if not is_int:
                out_dim += 1  # slices keep a dim; ints collapse one
    return tuple(base_key), tuple(positions)


def _is_advanced_key(key) -> bool:
    """Whether a key uses NumPy ADVANCED indexing (integer arrays /
    sequences or boolean masks) rather than basic ints/slices."""
    ks = key if isinstance(key, tuple) else (key,)
    for k in ks:
        if isinstance(k, (list, np.ndarray, jax.Array, Array)):
            return True
        if isinstance(k, (bool, np.bool_)):
            return True
    return False


def _advanced_key(key):
    """Convert Array entries of an advanced key to jax arrays and bare
    lists to numpy arrays (jax rejects non-tuple index sequences that
    numpy merely deprecated)."""
    ks = key if isinstance(key, tuple) else (key,)

    def conv(k):
        if isinstance(k, Array):
            return k.jax()
        if isinstance(k, list):
            return np.asarray(k)
        return k

    out = tuple(conv(k) for k in ks)
    return out if isinstance(key, tuple) else out[0]


class Array:
    """N-dimensional array with NumPy broadcasting and aliasing views."""

    __slots__ = ("_storage", "_spec")

    def __init__(self, data: Any = None, dtype=None, *, _storage=None, _spec=None):
        if _storage is not None:
            self._storage = _storage
            self._spec = _spec
            return
        if isinstance(data, Array):
            buf = data.jax()
            if dtype is not None:
                buf = buf.astype(_dtypes.canonicalize(dtype))
        elif isinstance(data, jax.Array) or isinstance(
            data, jax.core.Tracer
        ):
            buf = data if dtype is None else data.astype(_dtypes.canonicalize(dtype))
        else:
            dt = _dtypes.canonicalize(dtype) if dtype is not None else None
            explicit = isinstance(data, np.ndarray)
            if isinstance(data, (list, tuple)):
                # Native one-pass shape inference + flatten when the C
                # extension is built (reference nested-initializer ctor,
                # include/SMArray.h:36-68); numpy fallback otherwise.
                from . import native as _native

                _, arr = _native.parse_nested(data)
            else:
                arr = np.asarray(data)
            if dt is None and not explicit:
                # Python lists/scalars default to the 32-bit dtypes
                # regardless of jax_enable_x64; pass dtype= or a numpy
                # array for 64-bit.
                if arr.dtype == np.float64:
                    dt = jnp.dtype(jnp.float32)
                elif arr.dtype == np.int64:
                    dt = jnp.dtype(jnp.int32)
            if dt is None and explicit and not jax.config.x64_enabled:
                if arr.dtype == np.float64:
                    dt = jnp.dtype(jnp.float32)
                elif arr.dtype == np.int64:
                    dt = jnp.dtype(jnp.int32)
            buf = jnp.asarray(arr, dtype=dt)
        self._storage = _Storage(buf)
        self._spec = ViewSpec.identity(buf.shape)

    # ------------------------------------------------------------ metadata
    @property
    def shape(self) -> Tuple[int, ...]:
        return self._spec.shape

    @property
    def ndim(self) -> int:
        return self._spec.ndim

    @property
    def dtype(self):
        return self._storage.buf.dtype

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    # Reference spelling (SMArray.h ``totalSize`` member).
    @property
    def total_size(self) -> int:
        return self.size

    totalSize = total_size

    @property
    def strides(self) -> Tuple[int, ...]:
        """Element strides over the base buffer (reference ``_strides``,
        include/SMArray.h:357-364, views: :413-424)."""
        return self._spec.strides()

    @property
    def is_view(self) -> bool:
        return not self._spec.is_identity

    isView = is_view

    # --------------------------------------------------------- conversion
    def jax(self) -> jax.Array:
        """Materialize this view as a jax array."""
        return self._spec.read(self._storage.buf)

    def __jax_array__(self) -> jax.Array:
        return self.jax()

    def numpy(self) -> np.ndarray:
        return np.asarray(self.jax())

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def item(self):
        return self.jax().item()

    def tolist(self):
        return self.numpy().tolist()

    def astype(self, dtype) -> "Array":
        return Array(self.jax().astype(_dtypes.canonicalize(dtype)))

    def copy(self) -> "Array":
        return Array(self.jax())

    # ----------------------------------------------------------- indexing
    def __getitem__(self, key) -> "Array":
        if _is_advanced_key(key):
            # NumPy advanced indexing (integer arrays / boolean masks)
            # returns a COPY, never a view — same as NumPy.  Lowers to
            # XLA gather on the materialized view.  Boolean-mask reads
            # have data-dependent output shapes and therefore only work
            # eagerly (jit requires static shapes — use jnp.where-style
            # formulations inside jit).
            return Array(self.jax()[_advanced_key(key)])
        key, newaxes = _split_newaxes(key, self.ndim)
        spec = self._spec.compose(_normalize_key(key, self.ndim))
        if newaxes:
            # np.newaxis inserts dims the view machinery can't express; like
            # ``reshape``, the result is a regular array, not an alias.
            out = spec.read(self._storage.buf)
            for p in newaxes:
                out = jnp.expand_dims(out, p)
            return Array(out)
        return Array(_storage=self._storage, _spec=spec)

    def __setitem__(self, key, value) -> None:
        if _is_advanced_key(key):
            # Fancy writes lower to XLA scatter (boolean masks to select)
            # on the view's values, then write through the ViewSpec so
            # the update is visible to the parent and sibling views —
            # NumPy's in-place advanced-assignment semantics.
            if isinstance(value, Array):
                value = value.jax()
            cur = self._spec.read(self._storage.buf)
            new = cur.at[_advanced_key(key)].set(
                jnp.asarray(value, dtype=cur.dtype)
            )
            self._storage.buf = self._spec.write(self._storage.buf, new)
            return
        key, newaxes = _split_newaxes(key, self.ndim)
        spec = self._spec.compose(_normalize_key(key, self.ndim))
        if isinstance(value, Array):
            value = value.jax()
        if newaxes:
            value = jnp.asarray(value)
            # squeeze the inserted axes back out if the value carries them
            for p in reversed(newaxes):
                if value.ndim > len(spec.shape) and value.shape[p] == 1:
                    value = jnp.squeeze(value, p)
        self._storage.buf = spec.write(self._storage.buf, value)

    def __call__(self, *args) -> Union["Array", Any]:
        """Reference-style access (``operator()``, include/SMArray.h:99-119).

        All-int full index -> python scalar (``accessByValue``,
        SMArray.h:366-379); anything else -> aliasing view
        (``accessByArray``, SMArray.h:397-437).  Fewer args than ndim pads
        with SLICE_ALL.
        """
        if (
            len(args) == self.ndim
            and args
            and all(isinstance(a, int) and not isinstance(a, bool) for a in args)
        ):
            return self[args].item()
        return self[tuple(args)] if args else self[...]

    def set(self, index, value) -> None:
        """Reference-style element assignment ``a(i,j) = v``."""
        self[index if isinstance(index, tuple) else (index,)] = value

    def fill(self, value) -> None:
        self[...] = jnp.full(self.shape, value, dtype=self.dtype)

    # --------------------------------------------------------- reshaping
    def transpose(self, *axes) -> "Array":
        """View-producing transpose (reference include/SMArray.h:121-136
        reverses shape+strides; generalized to arbitrary axes here)."""
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        spec = self._spec.transpose(axes if axes else None)
        return Array(_storage=self._storage, _spec=spec)

    @property
    def T(self) -> "Array":
        return self.transpose()

    def reshape(self, *shape) -> "Array":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return Array(jnp.reshape(self.jax(), shape))

    def flatten(self) -> "Array":
        return Array(jnp.ravel(self.jax()))

    def repeat(self, n: int, axis: int = None) -> "Array":
        """NumPy-semantics repeat.

        The reference's flat ``repeat(n)`` intends each element repeated n
        times into a flat array but writes overlapping indices
        (include/SMArray.h:138-159, SURVEY §2.4-4); the axis version
        (SMArray.h:161-211) tiles along an axis.  Implemented here with the
        intended semantics via ``jnp.repeat``.
        """
        return Array(jnp.repeat(self.jax(), n, axis=axis))

    # --------------------------------------------------------- arithmetic
    def _binary(self, name: str, other, reverse: bool = False) -> "Array":
        from .ops import engine

        a, b = (other, self) if reverse else (self, other)
        return engine.binary(name, a, b)

    def __add__(self, o):
        return self._binary("add", o)

    def __radd__(self, o):
        return self._binary("add", o, True)

    def __sub__(self, o):
        return self._binary("subtract", o)

    def __rsub__(self, o):
        return self._binary("subtract", o, True)

    def __mul__(self, o):
        return self._binary("multiply", o)

    def __rmul__(self, o):
        return self._binary("multiply", o, True)

    def __truediv__(self, o):
        return self._binary("divide", o)

    def __rtruediv__(self, o):
        return self._binary("divide", o, True)

    def __floordiv__(self, o):
        return self._binary("floor_divide", o)

    def __rfloordiv__(self, o):
        return self._binary("floor_divide", o, True)

    def __mod__(self, o):
        return self._binary("remainder", o)

    def __rmod__(self, o):
        return self._binary("remainder", o, True)

    def __pow__(self, o):
        from .ops import engine

        return engine.pow(self, o)

    def __neg__(self):
        from .ops import engine

        return engine.unary("negative", self)

    def __abs__(self):
        from .ops import engine

        return engine.unary("abs", self)

    def __matmul__(self, o):
        return self.dot(o)

    def __rmatmul__(self, o):
        from .ops import engine

        return engine.dot(o, self)

    def dot(self, other) -> Union["Array", Any]:
        """Dot product — reference ``operator%`` (include/SMArray.h:213-215,
        include/math/product.h:8-224).  Unlike the reference (flat buffers,
        strides ignored; SURVEY §2.4-3), views are honored; lowers to
        ``lax.dot_general``."""
        from .ops import engine

        return engine.dot(self, other)

    # comparisons (NumPy semantics; not present in the reference but part of
    # any complete ndarray surface)
    def __eq__(self, o):
        return self._binary("equal", o)

    def __ne__(self, o):
        return self._binary("not_equal", o)

    def __lt__(self, o):
        return self._binary("less", o)

    def __le__(self, o):
        return self._binary("less_equal", o)

    def __gt__(self, o):
        return self._binary("greater", o)

    def __ge__(self, o):
        return self._binary("greater_equal", o)

    def __hash__(self):
        return id(self)

    # --------------------------------------------------------- reductions
    def _reduce(self, kind: str, axis, keepdims, jnp_fn) -> "Array":
        """Reductions lower to XLA's reduce, which on a GPU fuses any
        elementwise producer into the same pass."""
        from .ops import dispatch

        if axis is None:
            dispatch.record("reduce", kind)
        elif isinstance(axis, int) and self.ndim == 2:
            dispatch.record("reduce_axis", f"{kind}{axis % 2}")
        return Array(jnp_fn(self.jax(), axis=axis, keepdims=keepdims))

    def sum(self, axis=None, keepdims=False) -> Union["Array", Any]:
        return self._reduce("sum", axis, keepdims, jnp.sum)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis, keepdims, jnp.max)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis, keepdims, jnp.min)

    def mean(self, axis=None, keepdims=False):
        return self._reduce("mean", axis, keepdims, jnp.mean)

    # ------------------------------------------------------------ display
    def to_string(self) -> str:
        """Reference ``toString`` (include/SMArray.h:306-332)."""
        return np.array2string(self.numpy(), separator=", ")

    def __str__(self) -> str:
        return self.to_string()

    def __repr__(self) -> str:
        return f"Array({self.to_string()}, dtype={self.dtype})"

    def __len__(self) -> int:
        if self.ndim == 0:
            raise TypeError("len() of unsized Array")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        return bool(self.jax())

    def __float__(self):
        return float(self.jax())

    def __int__(self):
        return int(self.jax())


def _flatten_array(a: Array):
    # Pytree protocol: leaves = materialized buffer.  Unflattening builds a
    # fresh identity view, so transformed functions see value semantics.
    return (a.jax(),), None


def _unflatten_array(aux, children):
    return Array(children[0])


jax.tree_util.register_pytree_node(Array, _flatten_array, _unflatten_array)


def asarray(x, dtype=None) -> Array:
    return x if isinstance(x, Array) and dtype is None else Array(x, dtype=dtype)


def as_jax(x):
    """Coerce Array / jax / numpy / scalar to a jax-compatible value."""
    if isinstance(x, Array):
        return x.jax()
    return x
