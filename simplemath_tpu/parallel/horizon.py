"""Horizon (sequence) parallelism: the Riccati suffix scan sharded over a
mesh axis.

SURVEY §5 maps the reference's absent long-context/sequence-parallel story
to the horizon axis of trajectory optimization.  ``backward_associative``
(models/ilqr.py) already gives O(log H) *depth* on one chip; this module
adds the cross-chip dimension: the time axis itself is sharded over a mesh
axis, and the associative scan becomes the classic blocked formulation —

1. each device suffix-scans its local block of value elements
   (O(H/D) work, O(log H/D) depth),
2. block totals are ``all_gather``-ed over the axis (one small collective:
   D elements of (nx² + nx)-sized tuples cross the interconnect),
3. every device composes the totals of all *later* blocks (exclusive
   suffix, O(log D) work, identical on all devices),
4. local results are corrected by one composition with that exclusive
   suffix.

The element algebra's two-sided identity (``riccati_identity``) pads H+1 to
a multiple of the axis size and serves as the "no later block" suffix, so
any horizon length works on any mesh.

This is how a horizon too long for one device's memory — or a replan
deadline tighter than one device's sequential latency — scales across
devices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..models import ilqr as _ilqr


from ..utils.precision import f32_matmuls

def _pad_to_multiple(tree, n_have: int, multiple: int, ident, axis: int = 0):
    """Pad each leaf's ``axis`` from n_have to the next multiple with
    broadcast copies of the identity element."""
    pad = (-n_have) % multiple
    if pad == 0:
        return tree, 0

    def _pad_leaf(x, i):
        lead = x.shape[:axis]
        block = jnp.broadcast_to(i, lead + (pad,) + i.shape)
        return jnp.concatenate([x, block], axis=axis)

    return jax.tree.map(_pad_leaf, tree, ident), pad


def _block_suffix(local, axis_name: str, ident, I_x):
    """Per-device body of the blocked suffix scan (time-leading leaves).
    Works unchanged under an outer vmap (batch dim): the collectives act on
    the mesh axis, which vmap does not touch."""
    # 1. local suffix scan
    local_suffix = _ilqr.riccati_suffix_scan(local, I_x)
    total = jax.tree.map(lambda x: x[0], local_suffix)
    # 2. gather block totals (the only communication)
    totals = jax.lax.all_gather(total, axis_name)  # leading (D, ...)
    # 3. exclusive suffix of LATER blocks; identity for the last block
    sfx = _ilqr.riccati_suffix_scan(totals, I_x)
    sfx = jax.tree.map(
        lambda s, i: jnp.concatenate([s, i[None]], axis=0), sfx, ident
    )
    d = jax.lax.axis_index(axis_name)
    S = jax.tree.map(
        lambda x: jax.lax.dynamic_index_in_dim(x, d + 1, 0, keepdims=False),
        sfx,
    )
    # 4. one correction composition per local element
    return jax.vmap(lambda e: _ilqr.riccati_combine(e, S, I_x))(local_suffix)


@f32_matmuls
def sharded_suffix_scan(mesh: Mesh, axis_name: str, full, nx: int, dtype):
    """Blocked associative suffix scan of a time-leading element pytree,
    sharded over ``axis_name``.  Returns the (unpadded) suffix pytree with
    the same global length as ``full``."""
    n = jax.tree.leaves(full)[0].shape[0]
    D = mesh.shape[axis_name]
    ident = _ilqr.riccati_identity(nx, dtype)
    padded, _ = _pad_to_multiple(full, n, D, ident)
    I_x = jnp.eye(nx, dtype=dtype)

    out = shard_map(
        lambda local: _block_suffix(local, axis_name, ident, I_x),
        mesh=mesh,
        in_specs=P(axis_name),
        out_specs=P(axis_name),
        check_vma=False,
    )(padded)
    return jax.tree.map(lambda x: x[:n], out)


@f32_matmuls
def sharded_suffix_scan_batched(
    mesh: Mesh,
    time_axis: str,
    full,
    nx: int,
    dtype,
    scenario_axis: str | None = None,
):
    """Batched blocked suffix scan: leaves are (Bb, n, ...) with time on
    axis 1, sharded over ``time_axis``; the scenario batch is optionally
    sharded over ``scenario_axis`` — the 2-D (scenario × horizon) mesh
    decomposition.  The per-device body is the unbatched block under vmap
    (mesh collectives are orthogonal to the vmapped batch dim)."""
    n = jax.tree.leaves(full)[0].shape[1]
    D = mesh.shape[time_axis]
    ident = _ilqr.riccati_identity(nx, dtype)
    padded, _ = _pad_to_multiple(full, n, D, ident, axis=1)
    I_x = jnp.eye(nx, dtype=dtype)

    out = shard_map(
        jax.vmap(lambda local: _block_suffix(local, time_axis, ident, I_x)),
        mesh=mesh,
        in_specs=P(scenario_axis, time_axis),
        out_specs=P(scenario_axis, time_axis),
        check_vma=False,
    )(padded)
    return jax.tree.map(lambda x: x[:, :n], out)


@f32_matmuls
def backward_associative_sharded_batched(
    mesh: Mesh,
    time_axis: str,
    A,
    B,
    lx,
    lu,
    lxx,
    luu,
    lux,
    Vx_T,
    Vxx_T,
    reg,
    scenario_axis: str | None = None,
    return_values: bool = False,
):
    """Batched Riccati backward with BOTH parallel dimensions sharded:
    scenario batch over ``scenario_axis`` (dp) and the horizon over
    ``time_axis`` (sequence parallelism) on a 2-D mesh.  Inputs are
    batch-leading ``(Bb, H, ...)``; ``reg`` is a scalar shared across the
    batch (per-scenario reg belongs to the on-chip SoA path,
    models/ilqr.backward_associative_soa)."""
    nu = B.shape[-1]
    nx = A.shape[-1]
    I_u = jnp.eye(nu, dtype=B.dtype)
    elems = jax.vmap(
        jax.vmap(lambda inp: _ilqr.riccati_make_elem(inp, reg, I_u))
    )((A, B, lx, lu, lxx, luu, lux))
    Bb = A.shape[0]
    term = (
        jnp.broadcast_to(jnp.zeros((nx, nx), A.dtype), (Bb, nx, nx)),
        jnp.broadcast_to(jnp.zeros((nx,), A.dtype), (Bb, nx)),
        jnp.broadcast_to(jnp.zeros((nx, nx), A.dtype), (Bb, nx, nx)),
        -Vx_T,
        Vxx_T,
    )
    full = jax.tree.map(
        lambda e, t: jnp.concatenate([e, t[:, None]], axis=1), elems, term
    )
    suffix = sharded_suffix_scan_batched(
        mesh, time_axis, full, nx, A.dtype, scenario_axis=scenario_axis
    )
    Vx_all = -suffix[3]
    Vxx_all = suffix[4]
    ks, Ks = jax.vmap(
        jax.vmap(
            lambda inp, Vx, Vxx: _ilqr.riccati_gains(inp, Vx, Vxx, reg, I_u)
        )
    )((A, B, lx, lu, lxx, luu, lux), Vx_all[:, 1:], Vxx_all[:, 1:])
    if return_values:
        return ks, Ks, Vx_all, Vxx_all
    return ks, Ks


@f32_matmuls
def backward_associative_sharded(
    mesh: Mesh,
    axis_name: str,
    A,
    B,
    lx,
    lu,
    lxx,
    luu,
    lux,
    Vx_T,
    Vxx_T,
    reg,
    return_values: bool = False,
):
    """Riccati backward pass with the HORIZON axis sharded over
    ``mesh[axis_name]`` — drop-in equivalent of
    :func:`models.ilqr.backward_associative` (same inputs, same outputs,
    same numerics up to f32 reassociation).

    Element construction and gain recovery are embarrassingly parallel over
    time (XLA shards them with the data); only the suffix scan needs the
    blocked algorithm above.
    """
    nu = B.shape[-1]
    nx = A.shape[-1]
    I_u = jnp.eye(nu, dtype=B.dtype)
    elems = jax.vmap(lambda inp: _ilqr.riccati_make_elem(inp, reg, I_u))(
        (A, B, lx, lu, lxx, luu, lux)
    )
    term = (
        jnp.zeros((nx, nx), A.dtype),
        jnp.zeros((nx,), A.dtype),
        jnp.zeros((nx, nx), A.dtype),
        -Vx_T,
        Vxx_T,
    )
    full = jax.tree.map(
        lambda e, t: jnp.concatenate([e, t[None]], axis=0), elems, term
    )
    suffix = sharded_suffix_scan(mesh, axis_name, full, nx, A.dtype)
    Vx_all = -suffix[3]
    Vxx_all = suffix[4]
    ks, Ks = jax.vmap(
        lambda inp, Vx, Vxx: _ilqr.riccati_gains(inp, Vx, Vxx, reg, I_u)
    )((A, B, lx, lu, lxx, luu, lux), Vx_all[1:], Vxx_all[1:])
    if return_values:
        return ks, Ks, Vx_all, Vxx_all
    return ks, Ks
