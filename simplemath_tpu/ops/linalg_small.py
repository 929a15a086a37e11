"""Small-matrix linear algebra, unrolled.

``jnp.linalg.solve``/``inv`` lower to pivoted LU implemented with
``while``-loops and per-column dynamic slices; nested under vmap +
associative_scan + an outer scan that is slow to compile and runs as many
small loops.  For the solver stack's matrices (nx <= ~16, well-conditioned
I + C·J forms with C, J PSD), a statically-unrolled Gauss-Jordan without
pivoting compiles to pure vector ops and is numerically fine.

Used by the associative-scan Riccati combines (models/ilqr.py,
models/rti.py).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import config


def _debug_check_finite(out, where: str):
    """Debug-mode guard (config.debug_checks): the no-pivot elimination
    turns a singular/indefinite input into inf/nan — surface that as a
    checkify error instead of silent NaN propagation.  The caller must be
    checkify-transformed (utils.debug.nan_guard does this)."""
    if config.debug_checks:
        from jax.experimental import checkify

        checkify.check(
            jnp.all(jnp.isfinite(out)),
            f"{where}: non-finite inverse — input violates the "
            "diagonally-dominant/PD contract (no pivoting is performed)",
        )


def inv_unrolled(A):
    """Inverse of (..., n, n) via unrolled Gauss-Jordan, no pivoting.

    Suitable for small n (static) and matrices with dominant diagonals
    (e.g. I + PSD·PSD products, whose spectrum is bounded away from 0).
    Violating inputs produce inf/nan, which the solvers' NaN-robust accept
    rejects (models/ilqr.py solve); set config.debug_checks for a checkify
    assertion at the source instead.
    """
    n = A.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype), A.shape)
    M = jnp.concatenate([A, eye], axis=-1)  # (..., n, 2n)
    for i in range(n):
        row = M[..., i, :] / M[..., i, i][..., None]  # (..., 2n)
        factor = M[..., :, i][..., None]  # (..., n, 1)
        M = M - factor * row[..., None, :]
        M = M.at[..., i, :].set(row)
    out = M[..., :, n:]
    _debug_check_finite(out, "inv_unrolled")
    return out


def solve_unrolled(A, B):
    """Solve A X = B for small static n via ``inv_unrolled``."""
    inv = inv_unrolled(A)
    if B.ndim == A.ndim - 1:
        return (inv @ B[..., None])[..., 0]
    return inv @ B
