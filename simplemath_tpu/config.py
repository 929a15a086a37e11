"""Runtime configuration for simplemath_tpu.

The reference library's knobs are all compile-time (CMake option
``SM_ENABLE_NATIVE_OPTIMIZATION`` at CMakeLists.txt:3, ISA ``#ifdef``s at
include/math/helpers.h:14-20).  Here they are a runtime dataclass set from
environment variables.
"""

from __future__ import annotations

import dataclasses
import os


def _env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


@dataclasses.dataclass
class Config:
    # Transcendental implementation for exp/log/exp2/log2/tanh/pow:
    # "auto"    — per op, the native jnp op where it meets the crafted
    #             <=4-ulp contract on the H100, the crafted one otherwise
    #             (transcendental._AUTO_NATIVE, measured by chip_smoke.py);
    # "native"  — jnp ops everywhere (platform accuracy);
    # "crafted" — this framework's fdlibm-style range-reduction
    #             implementations everywhere (<=4 ulp across the f32
    #             domain — the from-the-math versions proving the
    #             reference's admitted exp/log bugs fixed).
    # Both impls are accuracy-tested against float64.
    transcendental_impl: str = dataclasses.field(
        default_factory=lambda: _env_str("SM_TRANSCENDENTAL", "auto")
    )

    # Deferred-eager elementwise queue (ops/lazy.py): eager op chains record
    # a lazy expression and flush as ONE fused program on materialization
    # instead of one dispatch per op.  Set SM_DEFERRED_EAGER=0 to compute
    # every op immediately.
    deferred_eager: bool = dataclasses.field(
        default_factory=lambda: _env_str("SM_DEFERRED_EAGER", "1") not in ("", "0")
    )

    # Debug-mode numerical guards (the sanitizer analog, SURVEY §5): when
    # True, the no-pivot small-matrix inverses emit checkify checks on the
    # finiteness of their results (they assume diagonally-dominant/PD
    # inputs — ops/linalg_small.py).  Run the caller under
    # jax.experimental.checkify.checkify (e.g. utils.debug.nan_guard) to
    # surface the errors; adds ~one reduction per inverse.
    debug_checks: bool = dataclasses.field(
        default_factory=lambda: _env_str("SM_DEBUG_CHECKS", "") not in ("", "0")
    )

    # Default mesh axis names for the distributed layer.
    data_axis: str = "scenario"
    model_axis: str = "model"


config = Config()


def update(**kwargs) -> Config:
    """Update global config fields; returns the config for chaining."""
    for k, v in kwargs.items():
        if not hasattr(config, k):
            raise AttributeError(f"unknown config field {k!r}")
        setattr(config, k, v)
    return config
