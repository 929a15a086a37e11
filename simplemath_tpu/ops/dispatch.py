"""Dispatch observability: which path each library op took.

The reference's dispatch is compile-time (ISA ``#ifdef``s pick the SIMD
specialization, include/math/helpers.h:14-20) so "which kernel ran" is
visible in the binary.  Here it happens at trace time, so this module
counts, per path, the programs the library dispatches: ``engine:<op>``
for every public elementwise call, ``elementwise:<op>`` / ``elementwise:
fused`` for each program a lone op or a flushed chain becomes (launches
per chain), ``reduce*`` / ``matmul:*`` for reductions and contractions,
and ``fuse_loop:triton`` / ``fuse_loop:xla`` for the iterated fuse's
route.  Tests assert routing with it.

Counting happens at trace time: one increment per eager op call, one per
jit trace for ops inside a jitted function.
"""

from __future__ import annotations

import collections
from typing import Dict

_COUNTS: collections.Counter = collections.Counter()


def record(kind: str, name: str = "") -> None:
    """Record one dispatch, e.g. record("elementwise", "add")."""
    _COUNTS[f"{kind}:{name}" if name else kind] += 1


def counts() -> Dict[str, int]:
    """Snapshot of dispatch counts since the last reset."""
    return dict(_COUNTS)


def count(kind: str, name: str = "") -> int:
    return _COUNTS[f"{kind}:{name}" if name else kind]


def reset() -> None:
    _COUNTS.clear()
