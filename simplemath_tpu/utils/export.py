"""AOT export / serving: serialize compiled solver steps to StableHLO.

The reference is a header-only library — "deployment" means recompiling
the caller.  A production control stack wants the opposite: solve
steps compiled ONCE, serialized, and served by a process that contains no
tracing, no Python model code, and no compile-time jitter (the 1 kHz
replan budget has no room for a retrace).  This module wraps
``jax.export``:

* ``export_step(fn, *example_args)`` traces + lowers ``fn`` for the
  CURRENT backend and returns the serialized artifact (bytes);
* ``save_step(path, fn, *example_args)`` / ``load_step(path_or_bytes)``
  round-trip it through disk; the loaded callable runs the embedded
  StableHLO directly (one XLA compile on first call, no retracing);
* ``export_solver_step(system, config, batch, horizon)`` is the
  convenience wrapper for the flagship batched iLQR solve.

Artifacts embed platform-specific custom calls (the Triton kernel
serializes as a Triton payload), so an artifact exported on a GPU serves on
a GPU.
``jax.export``'s versioned serialization provides the compatibility
window; anything else raises at deserialization rather than miscomputing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import export as _jexport


def export_step(fn, *example_args, platforms=None):
    """Serialize ``jax.jit(fn)`` lowered for the current backend (or
    ``platforms``) at the example arguments' shapes/dtypes.  Returns
    bytes."""
    specs = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(jnp.shape(x), jnp.result_type(x)),
        tuple(example_args),
    )
    kwargs = {}
    if platforms is not None:
        kwargs["platforms"] = tuple(platforms)
    exported = _jexport.export(jax.jit(fn), **kwargs)(*specs)
    return exported.serialize()


def save_step(path, fn, *example_args, platforms=None) -> None:
    blob = export_step(fn, *example_args, platforms=platforms)
    with open(path, "wb") as f:
        f.write(blob)


def load_step(path_or_bytes):
    """Deserialize an exported step; returns a callable running the
    embedded StableHLO (compiled once by XLA on first call)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        blob = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            blob = f.read()
    exported = _jexport.deserialize(blob)

    def run(*args):
        return exported.call(*args)

    return run


def export_solver_step(system, ilqr_config, batch: int, horizon: int,
                       path=None, platforms=None):
    """Export the batched iLQR solve step (the flagship serving artifact):
    ``step(x0_batch, us_batch) -> (us, cost)``.  Returns bytes, or writes
    to ``path``."""
    from ..models.ilqr import solve_batched

    def step(x0s, us):
        result = solve_batched(system, x0s, us, ilqr_config)
        return result.us, result.cost

    x0s = jnp.zeros((batch, system.nx), jnp.float32)
    us = jnp.zeros((batch, horizon, system.nu), jnp.float32)
    if path is not None:
        save_step(path, step, x0s, us, platforms=platforms)
        return None
    return export_step(step, x0s, us, platforms=platforms)
