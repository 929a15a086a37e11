"""NumPy-style broadcasting shape machinery.

Parity layer for the reference's broadcasting engine (include/SMUtils.h:34-99):
right-align the two shapes, pad the shorter with 1s, require equal-or-1 per
dim (mismatch throws, SMUtils.h:76-78), and mark broadcast dims.  The
reference realizes broadcast dims as stride-0 (SMUtils.h:83-88); XLA's
fusions read broadcast operands the same way, without materializing them.

``calculateTotalSize`` (include/SMUtils.h:25-31) maps to ``total_size``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class BroadcastResult:
    """Analog of BroadCastResult (include/SMUtils.h:5-12)."""

    result_shape: Tuple[int, ...]
    total_size: int
    # Per input: right-aligned padded shape and which result dims are
    # broadcast (input extent 1, result extent > 1).
    padded_a: Tuple[int, ...]
    padded_b: Tuple[int, ...]
    bcast_dims_a: Tuple[int, ...]
    bcast_dims_b: Tuple[int, ...]


def total_size(shape: Sequence[int]) -> int:
    return int(math.prod(shape))


def broadcast_shapes(
    shape_a: Sequence[int], shape_b: Sequence[int]
) -> BroadcastResult:
    """Compute the NumPy broadcast of two shapes; raises ValueError on
    mismatch (reference throws std::runtime_error, SMUtils.h:76-78)."""
    a, b = tuple(shape_a), tuple(shape_b)
    nd = max(len(a), len(b))
    pa = (1,) * (nd - len(a)) + a
    pb = (1,) * (nd - len(b)) + b
    out = []
    ba, bb = [], []
    for d, (x, y) in enumerate(zip(pa, pb)):
        if x == y:
            out.append(x)
        elif x == 1:
            out.append(y)
            ba.append(d)
        elif y == 1:
            out.append(x)
            bb.append(d)
        else:
            raise ValueError(
                f"operands could not be broadcast together with shapes "
                f"{tuple(shape_a)} {tuple(shape_b)}"
            )
    rs = tuple(out)
    return BroadcastResult(
        result_shape=rs,
        total_size=total_size(rs),
        padded_a=pa,
        padded_b=pb,
        bcast_dims_a=tuple(ba),
        bcast_dims_b=tuple(bb),
    )
