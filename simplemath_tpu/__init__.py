"""simplemath_tpu — an accelerator array + batched trajectory-optimization
framework in JAX with the capability surface of alielmorsy/simpleMath.

The reference is a header-only C++20 SIMD ndarray library
(``sm::SMArray<T>``); this package re-creates that capability set on an
accelerator (an NVIDIA H100; every op also runs on the CPU):

* ``sm.Array`` — N-D arrays with NumPy broadcasting, aliasing views,
  slicing/transpose/repeat, operators (reference include/SMArray.h);
* ``sm.ops`` — op registry, deferred-eager fusion, correct-range-reduction
  exp/log/pow, and a Triton kernel for iterated fusion (reference
  include/math/);
* ``sm.parallel`` — mesh construction and shard_map collectives (the
  reference's intra-op OpenMP parallelism, scaled across devices);
* ``sm.models`` — batched iLQR/DDP and SQP-MPC solvers built on the array
  core (the BASELINE.json north star).

Typical use::

    import simplemath_tpu as sm
    a = sm.Array([[1., 2.], [3., 4.]])
    b = sm.ones(2, 2)
    c = a + b                 # broadcast + deferred elementwise op
    d = sm.pow(a, 3)          # correct float/integer pow
    v = a[0, :]               # aliasing view; v[0] = 9 writes through
"""

from .array import Array, asarray  # noqa: F401
from .slicing import SLICE, SLICE_ALL, SLICE_END, SLICE_START, Slice  # noqa: F401
from .broadcast import BroadcastResult, broadcast_shapes, total_size  # noqa: F401
from .config import Config, config, update as configure  # noqa: F401
from .api import (  # noqa: F401
    abs,
    add,
    allclose,
    arange,
    arccos,
    arcsin,
    arctan,
    arctan2,
    argmax,
    argmin,
    array,
    ceil,
    clip,
    concatenate,
    cos,
    cosh,
    cumsum,
    divide,
    dot,
    empty,
    exp,
    expm1,
    eye,
    expand_dims,
    exp2,
    floor,
    isfinite,
    isinf,
    isnan,
    dequantize,
    full,
    full_like,
    fuse,
    int8_matmul,
    linspace,
    log,
    log10,
    log1p,
    log2,
    matmul,
    max,
    maximum,
    mean,
    min,
    minimum,
    multiply,
    negative,
    ones,
    ones_like,
    pow,
    prod,
    quantize,
    repeat,
    reshape,
    round,
    sign,
    sin,
    sinh,
    sort,
    sqrt,
    square,
    squeeze,
    stack,
    std,
    subtract,
    sum,
    tan,
    tanh,
    transpose,
    var,
    where,
    zeros,
    zeros_like,
)
from .ops import apply_op, register_op, registered_ops  # noqa: F401

__version__ = "0.1.0"
