"""Structure-of-arrays (batch-minor) small-matrix algebra.

The batched solvers carry thousands of tiny (nx<=16) matrices.  Under a
plain ``vmap`` the batch is a LEADING axis, so each small matrix is the
minor (contiguous) block of memory and every vector op works on a few
elements.  The reference hits the same wall from the other side: its
strided path drops to scalar code whenever the inner layout doesn't match
the SIMD width (include/math/calculate.h:33-46, SURVEY §2.4-1).

This module's layout: a batch of matrices is ONE array of shape
``(n, m, B)`` whose minor axis is the batch — every scalar entry
``A[i, j]`` is a contiguous ``(B,)`` vector, and the small-matrix algebra
unrolls into full-width elementwise ops over the batch (n, m are small
static ints, so the unrolled op count is tiny).  Whether it beats the
vmapped layout on the H100 is not measured yet.

Conversion helpers move the batch axis with a single transpose at the
boundary; everything between stays batch-minor.
"""

from __future__ import annotations

import jax.numpy as jnp


from ..utils.precision import f32_matmuls

def to_soa(x, n_minor: int):
    """Move a leading batch axis to the back: (B, d1..dk) -> (d1..dk, B).

    ``n_minor`` is the number of trailing non-batch dims the caller will
    treat as matrix/vector structure (kept for readability at call sites;
    the transpose itself is total)."""
    return jnp.moveaxis(x, 0, -1)


def from_soa(x):
    """Inverse of :func:`to_soa`: (d1..dk, B) -> (B, d1..dk)."""
    return jnp.moveaxis(x, -1, 0)


def transpose(A):
    """Matrix transpose of a (..., n, m, B) stack -> (..., m, n, B).

    All soa ops index the matrix axes from the RIGHT (batch last, matrix
    dims at -3/-2), so they are polymorphic over arbitrary LEADING axes —
    e.g. a time axis, which lets ``associative_scan`` map them over whole
    horizons without vmap."""
    return jnp.swapaxes(A, -3, -2)


@f32_matmuls
def matmul(A, C):
    """(..., n, k, B) @ (..., k, m, B) -> (..., n, m, B), unrolled over the
    static matrix dims."""
    n, k = A.shape[-3], A.shape[-2]
    m = C.shape[-2]
    rows = []
    for i in range(n):
        cols = []
        for j in range(m):
            acc = A[..., i, 0, :] * C[..., 0, j, :]
            for kk in range(1, k):
                acc = acc + A[..., i, kk, :] * C[..., kk, j, :]
            cols.append(acc)
        rows.append(jnp.stack(cols, axis=-2))
    return jnp.stack(rows, axis=-3)


@f32_matmuls
def matvec(A, v):
    """(..., n, k, B) @ (..., k, B) -> (..., n, B)."""
    n, k = A.shape[-3], A.shape[-2]
    out = []
    for i in range(n):
        acc = A[..., i, 0, :] * v[..., 0, :]
        for kk in range(1, k):
            acc = acc + A[..., i, kk, :] * v[..., kk, :]
        out.append(acc)
    return jnp.stack(out, axis=-2)


@f32_matmuls
def outer(u, v):
    """(..., n, B), (..., m, B) -> (..., n, m, B)."""
    return u[..., :, None, :] * v[..., None, :, :]


def eye_like(n: int, template):
    """(n, n, 1) identity broadcastable against a (..., n, n, B) stack."""
    return jnp.eye(n, dtype=template.dtype)[..., None]


@f32_matmuls
def inv(A):
    """Inverse of a (..., n, n, B) stack via unrolled Gauss-Jordan, no
    pivoting.

    Same contract as ops.linalg_small.inv_unrolled (diagonally-dominant /
    PD inputs; see that module's docstring for why pivoted LU is avoided),
    but in batch-minor layout.  n == 1 and n == 2
    specialize to closed forms."""
    from .linalg_small import _debug_check_finite

    n = A.shape[-3]
    if n == 1:
        out = 1.0 / A
        _debug_check_finite(out, "soa.inv")
        return out
    if n == 2:
        det = A[..., 0, 0, :] * A[..., 1, 1, :] - A[..., 0, 1, :] * A[..., 1, 0, :]
        inv_det = 1.0 / det
        row0 = jnp.stack(
            [A[..., 1, 1, :] * inv_det, -A[..., 0, 1, :] * inv_det], axis=-2
        )
        row1 = jnp.stack(
            [-A[..., 1, 0, :] * inv_det, A[..., 0, 0, :] * inv_det], axis=-2
        )
        out = jnp.stack([row0, row1], axis=-3)
        _debug_check_finite(out, "soa.inv")
        return out
    eye = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype)[..., None], A.shape)
    M = jnp.concatenate([A, eye], axis=-2)  # (..., n, 2n, B)
    for i in range(n):
        row = M[..., i, :, :] / M[..., i, i, :][..., None, :]  # (..., 2n, B)
        factor = M[..., :, i, :]  # (..., n, B)
        M = M - factor[..., :, None, :] * row[..., None, :, :]
        M = M.at[..., i, :, :].set(row)
    out = M[..., :, n:, :]
    _debug_check_finite(out, "soa.inv")
    return out


@f32_matmuls
def solve(A, b):
    """Solve A x = b for a (..., n, n, B) stack; b is (..., n, B) or
    (..., n, m, B)."""
    Ainv = inv(A)
    if b.ndim == A.ndim - 1:
        return matvec(Ainv, b)
    return matmul(Ainv, b)
