"""Profiling / tracing utilities.

The reference has no tracing at all (SURVEY §5: only Google Benchmark
microbenches, benchmark/add.cpp:4-33).  Here: wall timers that end in
``block_until_ready``, ``jax.profiler`` trace capture (Perfetto-compatible),
and roofline math against the card's published peaks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional

import jax

# Published peaks per card, keyed by ``jax.devices()[0].device_kind``.
# Source: NVIDIA H100 data sheet, SXM part, dense rates without sparsity, at
# the 700 W power limit.  A card run below its limit cannot hold these rates
# under load, so every share against them is printed with the power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "f32_flops": 67e12,
        "int8_ops": 1979e12,
    },
}


def peaks(device_kind: Optional[str] = None) -> dict:
    """The peak table row of ``device_kind`` (default: device 0's).  A
    device that is not in the table is an error, not a default."""
    kind = device_kind or jax.devices()[0].device_kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; add its data-sheet "
            "row to utils.profiling.PEAKS"
        ) from None


def hbm_bandwidth_bytes_per_s(device_kind: Optional[str] = None) -> float:
    return peaks(device_kind)["hbm_bytes_per_s"]


@dataclasses.dataclass
class BenchResult:
    median_s: float
    best_s: float
    times_s: list
    bytes_moved: Optional[int] = None
    flops: Optional[int] = None

    @property
    def gbps(self) -> Optional[float]:
        if self.bytes_moved is None:
            return None
        return self.bytes_moved / self.median_s / 1e9

    @property
    def roofline_fraction(self) -> Optional[float]:
        """Fraction of the device-memory peak achieved (memory-bound ops)."""
        if self.bytes_moved is None:
            return None
        return (self.bytes_moved / self.median_s) / hbm_bandwidth_bytes_per_s()

    @property
    def tflops(self) -> Optional[float]:
        if self.flops is None:
            return None
        return self.flops / self.median_s / 1e12


def benchmark(
    fn: Callable,
    *args,
    warmup: int = 2,
    repeats: int = 5,
    bytes_moved: Optional[int] = None,
    flops: Optional[int] = None,
) -> BenchResult:
    """Time fn(*args) with device synchronization; median-of-repeats."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    st = sorted(times)
    return BenchResult(
        median_s=st[len(st) // 2],
        best_s=st[0],
        times_s=times,
        bytes_moved=bytes_moved,
        flops=flops,
    )


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace (view with Perfetto / TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named region that shows up in profiler traces."""
    with jax.profiler.TraceAnnotation(name):
        yield
