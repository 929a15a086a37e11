"""Op layer: op registry, dispatch engine, deferred-eager queue, fusion,
transcendentals, the iterated-fuse kernel — the stand-in for the
reference's include/math/ tree (op functors + dispatch engine).
"""

from . import (  # noqa: F401
    engine,
    fuse_loop,
    matmul,
    registry,
    transcendental,
)
from .registry import Op, get_op, register_op, registered_ops  # noqa: F401
from .engine import apply_op, binary, unary  # noqa: F401
