"""Debugging / numerical-safety helpers.

The reference has no sanitizers (SURVEY §5: no TSan/ASan; OpenMP regions
rely on disjoint writes by construction).  Under XLA the analogous hazards
are NaN/Inf propagation, silent dtype promotion, and buffer-donation
aliasing; these helpers surface them:

* ``nan_guard(fn)`` — wraps a function so every output leaf is checked for
  NaN/Inf at runtime (works under jit via ``jax.debug``-style checkify or
  eager asserts);
* ``assert_tree_finite`` / ``tree_norm`` — quick state inspection.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def assert_tree_finite(tree, name: str = "value") -> None:
    """Eager check that every leaf is finite; raises with the leaf path."""
    leaves_with_paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in leaves_with_paths:
        arr = jnp.asarray(leaf)
        if not bool(jnp.all(jnp.isfinite(arr))):
            raise FloatingPointError(
                f"non-finite values in {name}{jax.tree_util.keystr(path)}"
            )


def tree_norm(tree) -> float:
    """Global L2 norm over all leaves (host-side scalar)."""
    total = sum(
        jnp.sum(jnp.square(jnp.asarray(leaf).astype(jnp.float32)))
        for leaf in jax.tree_util.tree_leaves(tree)
    )
    return float(jnp.sqrt(total))


def nan_guard(fn):
    """Wrap ``fn`` with jittable NaN/Inf checking via checkify; the wrapped
    function raises on the host when a check trips."""
    from jax.experimental import checkify

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        def checked(*a, **k):
            out = fn(*a, **k)
            for leaf in jax.tree_util.tree_leaves(out):
                checkify.check(
                    jnp.all(jnp.isfinite(leaf)), "non-finite output detected"
                )
            return out

        err, out = checkify.checkify(checked)(*args, **kwargs)
        err.throw()
        return out

    return wrapped
