"""Dtype helpers — the reference's SimdTraits layer reduced to what JAX
needs: canonicalizing user dtype specs and NumPy-style promotion.

The reference defines a compile-time trait struct per dtype exposing SIMD
register width and load/store/splat intrinsics (include/math/helpers.h:
12-119).  XLA chooses vector widths itself, so no traits remain here.
int64 — a TODO stub in the reference (helpers.h:122-127) — is supported
via jax x64.
"""

from __future__ import annotations

import jax.numpy as jnp


def canonicalize(dtype):
    """Canonicalize a user dtype spec (python type / numpy dtype / string)."""
    if dtype in (float, "float"):
        return jnp.dtype(jnp.float32)
    if dtype in (int, "int"):
        return jnp.dtype(jnp.int32)
    if dtype in (complex, "complex"):
        return jnp.dtype(jnp.complex64)
    return jnp.dtype(dtype)


def result_dtype(*dtypes):
    """NumPy-style promotion over operand dtypes."""
    return jnp.result_type(*dtypes)
