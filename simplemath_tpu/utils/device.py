"""What a measurement needs to know about the card it runs on.

``require_gpu`` stops a measurement that found no GPU instead of letting it
fall back to the CPU; ``card_info`` reads the card's name and power limit
from ``nvidia-smi`` in a child process that does not import JAX (one JAX
process per card); ``enable_compile_cache`` points JAX's persistent
compilation cache at one fixed directory.
"""

from __future__ import annotations

import os
import pathlib
import subprocess

import jax

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``.
    The path is part of the cache key, so it never moves."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        REPO_ROOT / ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Use ``compile_cache_dir()`` as JAX's persistent compilation cache;
    returns the directory."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> list:
    """The GPU devices, or ``SystemExit`` (non-zero) when JAX found none."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU found: JAX's devices are {devices[0].platform} "
            f"({len(devices)} x {devices[0].device_kind}); this measurement "
            "runs on a GPU only"
        )
    return devices


def card_info() -> str:
    """``name, power.limit`` of each card, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def describe() -> dict:
    """Device facts every result is printed with."""
    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
