"""Transcendentals: exp / log / pow with correct range reduction.

The reference hand-crafted SIMD exp/log and documents that both are wrong —
"In both log and exp I have issues with range reduction … exp [wrong] below
1.1 … log [wrong] at 3.0" (reference README.md:8-10); float/double SIMD pow
is commented out pending SVML (include/math/pow.h:16-52), and only the
branch-free integer pow shipped (include/math/simd/crafted_pow.h).

This module is the replacement: correct Cody-Waite style range
reduction + minimax polynomials, written as pure jnp functions so the SAME
implementation runs under plain XLA on any backend and inside the iterated
fuse kernel (ops/fuse_loop.py), which Triton compiles.
Accuracy is validated against NumPy float64 across the full f32 domain in
tests/test_transcendental.py — including the reference's documented failure
points (exp below 1.1, log at 3.0).

Algorithms (standard fdlibm-style, implemented from the math):

* exp(x):  k = round(x/ln2); r = x - k*ln2 (two-term ln2 split keeps r
  exact); e^r by degree-6 Taylor/minimax on |r| <= ln2/2; scale by 2^k via
  exponent-field bitcast, split into two steps so results survive down to
  subnormals.
* log(x):  decompose x = 2^e * m with m in [sqrt(2)/2, sqrt(2)) via integer
  exponent extraction (subnormals pre-scaled by 2^25); log(m) via the
  s = f/(2+f) atanh series; recombine e*ln2 with a hi/lo split.
* pow(x,y) = 2^(y*log2(x)) with log2 carried as (integer, fraction) parts so
  the product y*log2(x) keeps f32 accuracy, plus IEEE edge handling
  (sign by parity for integer y, NaN for negative base with non-integer y,
  0/inf limits).
* integer pow: branch-free square-and-multiply over exponent bits — the
  working version of crafted_pow.h:4-52 — with the reference's negative-
  exponent semantics (0 except bases ±1; crafted_pow.h:35-51).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import config

_LN2_HI = np.float32(6.93145752e-01)  # ln2 split: hi has ~12 trailing zeros
_LN2_LO = np.float32(1.42860677e-06)
_LOG2E = np.float32(1.44269504088896341)
_LN2 = np.float32(0.6931471805599453)
_INV_LN2 = np.float32(1.4426950408889634)
_SQRT2 = np.float32(1.4142135623730951)

# e^r Taylor coefficients (1/n!) — degree 7 keeps f32 to ~1 ulp on |r|<=ln2/2.
_EXP_COEFFS = [
    np.float32(1.0 / 5040.0),
    np.float32(1.0 / 720.0),
    np.float32(1.0 / 120.0),
    np.float32(1.0 / 24.0),
    np.float32(1.0 / 6.0),
    np.float32(0.5),
    np.float32(1.0),
    np.float32(1.0),
]

# atanh-series coefficients for log ((fdlibm Lg1..Lg4 style minimax over
# z = s^2, s = f/(2+f)).
_LOG_COEFFS = [
    np.float32(0.14249323),
    np.float32(0.15406281),
    np.float32(0.18183572),
    np.float32(0.22222198),
    np.float32(0.28571429),
    np.float32(0.40000001),
    np.float32(0.66666667),
]


def _rint(x):
    """Round half to even, from ``floor`` (Triton has no round-to-integer
    rule): exact for every f32, identical to ``jnp.round``."""
    f = jnp.floor(x)
    d = x - f  # exact for |x| < 2^23
    half = f * np.float32(0.5)
    odd = (half - jnp.floor(half)) * np.float32(2.0)  # 1 where f is odd
    r = jnp.where(d > np.float32(0.5), f + np.float32(1.0),
                  jnp.where(d < np.float32(0.5), f, f + odd))
    r = jnp.where(r == np.float32(0.0), x * np.float32(0.0), r)  # sign of 0
    return jnp.where(jnp.abs(x) >= np.float32(2.0 ** 23), x, r)


def _poly(coeffs, x):
    acc = jnp.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        acc = acc * x + c
    return acc


def _ldexp_f32(x, k):
    """x * 2^k for int32 k in [-300, 300], via two-step exponent bitcast so
    subnormal results round correctly."""
    # Explicit int32 bounds/divisor: Python int literals become i64 scalars
    # under jax_enable_x64, and the int32 bit arithmetic must stay int32.
    k = jnp.clip(k, np.int32(-252), np.int32(252))
    k1 = k // np.int32(2)
    k2 = k - k1
    s1 = jax.lax.bitcast_convert_type(((k1 + 127) << 23).astype(jnp.int32), jnp.float32)
    s2 = jax.lax.bitcast_convert_type(((k2 + 127) << 23).astype(jnp.int32), jnp.float32)
    return (x * s1) * s2


def exp_f32(x):
    x = jnp.asarray(x, jnp.float32)
    kf = _rint(x * _LOG2E)
    k = kf.astype(jnp.int32)
    # Cody-Waite: r = x - k*ln2 computed in two exact-ish steps.
    r = (x - kf * _LN2_HI) - kf * _LN2_LO
    p = _poly(_EXP_COEFFS, r)
    out = _ldexp_f32(p, k)
    # Subnormal results: the float multiply path gets flushed to zero by the
    # platform (XLA runs FTZ), so construct the subnormal BITS
    # directly: value = round(p * 2^(k+149)) * 2^-149.
    k149 = jnp.clip(k + np.int32(149), np.int32(0), np.int32(254))
    scale_sub = jax.lax.bitcast_convert_type(
        ((k149 + 127) << 23).astype(jnp.int32), jnp.float32
    )
    sub_m = _rint(p * scale_sub).astype(jnp.int32)
    out_sub = jax.lax.bitcast_convert_type(sub_m, jnp.float32)
    out = jnp.where(k < -126, out_sub, out)
    # Saturation: beyond these, the result is not representable even as a
    # subnormal.
    out = jnp.where(x > np.float32(88.8), jnp.float32(np.inf), out)
    out = jnp.where(x < np.float32(-104.0), jnp.float32(0.0), out)
    return jnp.where(jnp.isnan(x), x, out)


def _decompose_f32(x):
    """x (finite, > 0) -> (e, m) with x = 2^e * m, m in [sqrt(2)/2, sqrt(2)).

    Subnormal inputs are handled in the integer domain (value =
    mantissa * 2^-149 with the mantissa floated exactly), immune to the
    platform's DAZ flushing."""
    bits0 = jax.lax.bitcast_convert_type(x, jnp.int32)
    exp_field = (bits0 >> 23) & 0xFF
    mant_field = bits0 & jnp.int32(0x007FFFFF)
    is_sub = (exp_field == 0) & (mant_field != 0)
    xs = jnp.where(is_sub, mant_field.astype(jnp.float32), x)
    # int32 literals: Python ints become i64 under x64.
    bias = jnp.where(is_sub, np.int32(149), np.int32(0))
    bits = jax.lax.bitcast_convert_type(xs, jnp.int32)
    e = ((bits >> 23) & 0xFF) - 127 - bias
    m = jax.lax.bitcast_convert_type(
        (bits & jnp.int32(0x007FFFFF)) | jnp.int32(0x3F800000), jnp.float32
    )
    hi = m >= _SQRT2
    m = jnp.where(hi, m * np.float32(0.5), m)
    e = e + hi.astype(jnp.int32)
    return e, m


def _log_mantissa(m):
    """log(m) for m in [sqrt(2)/2, sqrt(2)) via the atanh series."""
    f = m - np.float32(1.0)
    s = f / (np.float32(2.0) + f)
    z = s * s
    w = z * z
    # Split even/odd for a touch of ILP (mirrors fdlibm's t1/t2 grouping).
    t = z * _poly(_LOG_COEFFS, z)
    hfsq = np.float32(0.5) * f * f
    return f - (hfsq - s * (hfsq + t))


def log_f32(x):
    x = jnp.asarray(x, jnp.float32)
    # Zero/sign classification in the integer domain so subnormal inputs are
    # NOT treated as zero (the platform's DAZ would).
    bits = jax.lax.bitcast_convert_type(x, jnp.int32)
    is_zero = (bits & jnp.int32(0x7FFFFFFF)) == 0
    is_pos = (bits >= 0) & ~is_zero
    e, m = _decompose_f32(jnp.where(is_pos, x, np.float32(1.0)))
    ef = e.astype(jnp.float32)
    res = ef * _LN2_HI + (_log_mantissa(m) + ef * _LN2_LO)
    res = jnp.where(
        is_zero, jnp.float32(-np.inf), jnp.where(is_pos, res, jnp.float32(np.nan))
    )
    res = jnp.where(x == np.float32(np.inf), x, res)
    return jnp.where(jnp.isnan(x), x, res)


def _exp2_f32(t_int, t_frac):
    """2^(t_int + t_frac) with t_int integer-valued f32, |t_frac| <= ~0.5."""
    # Fold any integer part that leaked into t_frac.
    kf = _rint(t_frac)
    r = (t_frac - kf) * _LN2  # exact: |t_frac - kf| <= 0.5, ln2 mult is 1 rounding
    p = _poly(_EXP_COEFFS, r)
    k = (t_int + kf).astype(jnp.int32)
    t = t_int + t_frac
    out = _ldexp_f32(p, k)
    out = jnp.where(t > np.float32(128.5), jnp.float32(np.inf), out)
    out = jnp.where(t < np.float32(-150.5), jnp.float32(0.0), out)
    return out


def _log2_parts_f32(x):
    """log2(x) for x > 0 as (integer part e, fractional part in [-0.5, 0.5])."""
    e, m = _decompose_f32(x)
    frac = _log_mantissa(m) * _INV_LN2
    return e.astype(jnp.float32), frac


def exp2_f32(x):
    x = jnp.asarray(x, jnp.float32)
    kf = _rint(x)
    out = _exp2_f32(kf, x - kf)
    return jnp.where(jnp.isnan(x), x, out)


def log2_f32(x):
    x = jnp.asarray(x, jnp.float32)
    bits = jax.lax.bitcast_convert_type(x, jnp.int32)
    is_zero = (bits & jnp.int32(0x7FFFFFFF)) == 0
    is_pos = (bits >= 0) & ~is_zero
    e, frac = _log2_parts_f32(jnp.where(is_pos, x, np.float32(1.0)))
    res = e + frac
    res = jnp.where(
        is_zero, jnp.float32(-np.inf), jnp.where(is_pos, res, jnp.float32(np.nan))
    )
    res = jnp.where(x == np.float32(np.inf), x, res)
    return jnp.where(jnp.isnan(x), x, res)


def pow_f32(x, y):
    """IEEE-ish float pow in f32: 2^(y*log2|x|) with parity-based sign."""
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    x, y = jnp.broadcast_arrays(x, y)
    ax = jnp.abs(x)
    e, frac = _log2_parts_f32(jnp.where(ax > 0, ax, np.float32(1.0)))
    # y * (e + frac) keeping the integer/fraction split: t_int collects the
    # integer-valued product part exactly for integer y up to 2^23.
    t1 = y * e
    t2 = y * frac
    t1_int = _rint(t1)
    t2 = t2 + (t1 - t1_int)
    r = _exp2_f32(t1_int, t2)

    # y = ±inf: result depends on |x| vs 1 (avoid inf*0 NaNs in the log path).
    inf_y_res = jnp.where(
        ax == 1,
        np.float32(1.0),
        jnp.where(
            (ax > 1) == (y > 0), jnp.float32(np.inf), jnp.float32(0.0)
        ),
    )
    r = jnp.where(jnp.isinf(y), inf_y_res, r)

    y_int = _rint(y)
    y_is_int = y == y_int
    y_is_odd = y_is_int & (jnp.abs(jnp.mod(y_int, np.float32(2.0))) == np.float32(1.0))
    sign = jnp.where((x < 0) & y_is_odd, np.float32(-1.0), np.float32(1.0))
    out = sign * r
    # negative base, non-integer exponent -> nan
    out = jnp.where((x < 0) & ~y_is_int, jnp.float32(np.nan), out)
    # x == 0 cases
    zero_res = jnp.where(
        y > 0,
        jnp.where(y_is_odd, jnp.sign(x) * np.float32(0.0), np.float32(0.0)),
        jnp.where(y < 0, jnp.float32(np.inf), np.float32(1.0)),
    )
    out = jnp.where(x == 0, zero_res, out)
    # |x| == inf
    inf_res = jnp.where(
        y > 0,
        jnp.where((x < 0) & y_is_odd, jnp.float32(-np.inf), jnp.float32(np.inf)),
        jnp.where(y < 0, np.float32(0.0), np.float32(1.0)),
    )
    out = jnp.where(jnp.isinf(x), inf_res, out)
    out = jnp.where(y == 0, np.float32(1.0), out)
    out = jnp.where(x == np.float32(1.0), np.float32(1.0), out)
    out = jnp.where(jnp.isnan(x) & (y != 0), x, out)
    out = jnp.where(jnp.isnan(y) & (x != 1), y, out)
    return out


# tanh Taylor coefficients in z = x^2 (odd series through x^13): measured
# truncation at the 0.5 split point is ~1e-7 rel, ~1 ulp.
_TANH_COEFFS = [
    np.float32(21844.0 / 6081075.0),
    np.float32(-1382.0 / 155925.0),
    np.float32(62.0 / 2835.0),
    np.float32(-17.0 / 315.0),
    np.float32(2.0 / 15.0),
    np.float32(-1.0 / 3.0),
    np.float32(1.0),
]


def tanh_f32(x):
    """Crafted f32 tanh, for platforms whose native tanh misses the
    <=4-ulp contract.

    |x| <= 0.5: odd Taylor/minimax series (the 1 - 2/(e^2x+1) form cancels
    catastrophically near 0).  |x| > 0.5: 1 - 2/(e^{2|x|}+1) with the
    crafted exp (<=1 ulp), which saturates to exactly 1.0f where f32 tanh
    does (|x| >= ~9.011) with no special casing."""
    x = jnp.asarray(x, jnp.float32)
    ax = jnp.abs(x)
    z = x * x
    small = x * _poly(_TANH_COEFFS, z)
    big = np.float32(1.0) - np.float32(2.0) / (
        exp_f32(np.float32(2.0) * jnp.minimum(ax, np.float32(44.0)))
        + np.float32(1.0)
    )
    out = jnp.where(ax <= np.float32(0.5), small, jnp.sign(x) * big)
    return jnp.where(jnp.isnan(x), x, out)


def ipow_tile(base, exponent):
    """Branch-free square-and-multiply integer pow over exponent bits — the
    corrected version of __sm256_powi_ps (crafted_pow.h:54-103), with the
    reference's negative-exponent edge table (crafted_pow.h:35-51)."""
    base = jnp.asarray(base)
    exponent = jnp.asarray(exponent)
    base_b, e_b = jnp.broadcast_arrays(base, exponent)
    e = jnp.abs(e_b)
    result = jnp.ones_like(base_b)
    b = base_b
    for _ in range(31):
        one = jnp.asarray(1, e.dtype)
        result = jnp.where((e & one) == one, result * b, result)
        b = b * b
        e = e >> jnp.asarray(1, e.dtype)
    two = jnp.asarray(2, dtype=e_b.dtype)
    parity = jnp.where(
        jnp.abs(e_b) % two == jnp.asarray(0, e_b.dtype),
        jnp.asarray(1, base_b.dtype),
        jnp.asarray(-1, base_b.dtype),
    )
    neg = jnp.where(
        base_b == 1,
        jnp.ones_like(base_b),
        jnp.where(base_b == -1, parity, jnp.zeros_like(base_b)),
    )
    return jnp.where(e_b < 0, neg, result)


# ------------------------------------------------------------- dispatchers
# Crafted (fdlibm-style, from-the-math) f32 implementations, and the native
# jnp spelling of each.  config.transcendental_impl picks the tile.  "auto"
# takes the native op where its max ulp error on the H100, measured over
# the f32 sample domain of tests/test_transcendental.py by chip_smoke.py,
# meets the crafted <=4-ulp contract, and the crafted one otherwise.  On an
# H100 SXM (700 W limit) the native max errors were exp 1.76, log 0.77,
# log2 1.40, sin 1.41, cos 1.42 and pow 0.72 ulp; exp2 (66.95) and tanh
# (5.31) miss the contract, so they stay crafted (1.06 and 2.32 ulp).
# sin/cos/tan have no crafted variant; "crafted" mode falls back to native
# there.
_UNARY_IMPLS = {}  # name -> crafted f32 implementation (filled at bottom)
_NATIVE_UNARY = {
    "exp": jnp.exp,
    "log": jnp.log,
    "exp2": jnp.exp2,
    "log2": jnp.log2,
    "sin": jnp.sin,
    "cos": jnp.cos,
    "tan": jnp.tan,
    "tanh": jnp.tanh,
}
# "auto" = measured per-op defaults (see config.transcendental_impl).
_AUTO_NATIVE = frozenset({"exp", "log", "log2", "pow", "sin", "cos", "tan"})


def _resolve_impl(name: str, impl: str) -> str:
    if impl == "auto":
        return "native" if name in _AUTO_NATIVE else "crafted"
    if impl == "crafted" and name not in _UNARY_IMPLS and name != "pow":
        return "native"  # no crafted variant exists (accurate natively)
    return impl


@functools.lru_cache(maxsize=None)
def _unary_tile(name: str, out_dtype_str: str, impl: str = "auto"):
    """STABLE per-(op, out_dtype, impl) tile closure.  The fused-expression
    caches (ops/lazy.py, ops/fuse_loop.py) key on tile-function identity,
    so the closure must be one object across calls."""
    if _resolve_impl(name, impl) == "native" and name in _NATIVE_UNARY:
        fn = _NATIVE_UNARY[name]
    else:
        fn = _UNARY_IMPLS[name]
    out_dtype = jnp.dtype(out_dtype_str)

    def tile(v):
        return fn(v.astype(jnp.float32)).astype(out_dtype)

    return tile


def _dispatch_unary(name, impl_f32, jnp_fn, x):
    """Run the selected f32 implementation; f64 takes XLA's native op (the
    crafted polynomials are f32-grade)."""
    from . import dispatch

    x = jnp.asarray(x)
    if x.dtype in (jnp.dtype(jnp.float64),):
        return jnp_fn(x)
    _UNARY_IMPLS.setdefault(name, impl_f32)
    out_dtype = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.dtype(jnp.float32)
    dispatch.record("elementwise", name)
    return _unary_tile(name, jnp.dtype(out_dtype).name, config.transcendental_impl)(x)


def exp(x):
    return _dispatch_unary("exp", exp_f32, jnp.exp, x)


def log(x):
    return _dispatch_unary("log", log_f32, jnp.log, x)


def exp2(x):
    return _dispatch_unary("exp2", exp2_f32, jnp.exp2, x)


def log2(x):
    return _dispatch_unary("log2", log2_f32, jnp.log2, x)


def sin(x):
    return _dispatch_unary("sin", jnp.sin, jnp.sin, x)


def cos(x):
    return _dispatch_unary("cos", jnp.cos, jnp.cos, x)


def tan(x):
    return _dispatch_unary("tan", jnp.tan, jnp.tan, x)


def tanh(x):
    return _dispatch_unary("tanh", tanh_f32, jnp.tanh, x)


@functools.lru_cache(maxsize=None)
def _pow_tile(out_dtype_str: str, impl: str = "auto"):
    """Stable per-(out_dtype, impl) pow tile closure (see _unary_tile)."""
    out_dtype = jnp.dtype(out_dtype_str)
    fn = jnp.power if _resolve_impl("pow", impl) == "native" else pow_f32

    def tile(a, b):
        return fn(a.astype(jnp.float32), b.astype(jnp.float32)).astype(out_dtype)

    return tile


def pow(x, y):
    from . import dispatch
    from ..broadcast import broadcast_shapes

    x = jnp.asarray(x)
    y = jnp.asarray(y)
    if jnp.result_type(x, y) == jnp.dtype(jnp.float64):
        return jnp.power(x, y)
    out_dtype = jnp.result_type(x, y)
    if not jnp.issubdtype(out_dtype, jnp.floating):
        out_dtype = jnp.dtype(jnp.float32)
    broadcast_shapes(jnp.shape(x), jnp.shape(y))
    dispatch.record("elementwise", "pow")
    return _pow_tile(jnp.dtype(out_dtype).name, config.transcendental_impl)(x, y)


# Crafted implementations registered up front so tile factories work from
# any entry point (fusion composes tiles without going through the
# dispatchers above).
_UNARY_IMPLS.update(
    {
        "exp": exp_f32,
        "log": log_f32,
        "exp2": exp2_f32,
        "log2": log2_f32,
        "tanh": tanh_f32,
    }
)
