"""Matmul-precision pinning for the solver layer.

A platform's DEFAULT f32 matmul precision may round the operands — on the
H100, XLA runs default-precision f32 products in TF32 on the tensor cores
(10 mantissa bits per operand).  For large dense products that is the
documented speed contract (ops/engine.py), but inside the solvers the
matrices are tiny (nx <= 12) and chained through hundreds of Riccati steps,
where operand rounding compounds into convergence failures and drift
between the SoA and vmapped backward passes.  Every solver entry point
therefore pins float32 precision for the ops built under it, which keeps
them off TF32; the cost is negligible at these shapes, and results match the
float64 reference within f32 tolerance — BASELINE.json's numerical-parity
contract (tests/test_numerical_parity.py, and on the card chip_smoke.py).
"""

from __future__ import annotations

import functools

import jax


def f32_matmuls(fn):
    """Decorator: trace ``fn``'s ops under float32 matmul precision."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)

    # Marker for the regression test that keeps every solver entry point
    # pinned (tests/test_numerical_parity.py).
    wrapped._pins_f32_matmuls = True
    return wrapped
