"""Distributed layer on the 8-virtual-device CPU mesh (SURVEY §4's fake
backend): mesh construction, collectives, and the sharded batched solver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import simplemath_tpu as sm
from simplemath_tpu import parallel
from simplemath_tpu.models import ILQRConfig, make_pendulum
from simplemath_tpu.models.ilqr import solve_batched


pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multiple (virtual) devices"
)


def test_device_info():
    info = parallel.device_info()
    assert info["n_devices"] >= 2


def test_make_mesh_default():
    mesh = parallel.make_mesh()
    assert mesh.devices.size == len(jax.devices())
    assert mesh.axis_names == ("scenario",)


def test_make_mesh_2d():
    n = len(jax.devices())
    mesh = parallel.make_mesh((2, n // 2), ("host", "scenario"))
    assert mesh.shape["host"] == 2
    assert mesh.shape["scenario"] == n // 2


def test_mesh_mismatch_raises():
    with pytest.raises(ValueError, match="device count"):
        parallel.make_mesh((3,), ("scenario",))


def test_collectives_in_shard_map():
    mesh = parallel.make_mesh()
    n = mesh.devices.size

    def fn(x):
        s = parallel.psum(jnp.sum(x), "scenario")
        m = parallel.pmax(jnp.max(x), "scenario")
        g = parallel.all_gather(x, "scenario")
        idx = parallel.axis_index("scenario").reshape(1)  # 1 elem per shard
        return s, m, g, idx

    x = jnp.arange(n * 4, dtype=jnp.float32).reshape(n, 4)
    s, m, g, idx = parallel.shard_map(
        fn,
        mesh=mesh,
        in_specs=P("scenario"),
        out_specs=(P(), P(), P("scenario"), P("scenario")),
    )(x)
    assert float(s) == float(jnp.sum(x))
    assert float(m) == float(jnp.max(x))
    assert g.shape == (n * n, 4)


def test_ring_permute():
    mesh = parallel.make_mesh()
    n = mesh.devices.size

    def fn(x):
        return parallel.ppermute_ring(x, "scenario", shift=1)

    x = jnp.arange(n, dtype=jnp.float32).reshape(n, 1)
    out = parallel.shard_map(
        fn, mesh=mesh, in_specs=P("scenario"), out_specs=P("scenario"),
    )(x)
    expected = np.roll(np.arange(n), 1).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(out).ravel(), expected)


def test_sharded_solve_matches_local():
    system = make_pendulum()
    mesh = parallel.make_mesh()
    n_dev = mesh.devices.size
    batch = n_dev * 2
    key = jax.random.PRNGKey(0)
    x0s = 0.3 * jax.random.normal(key, (batch, 2), dtype=jnp.float32)
    us = jnp.zeros((batch, 20, 1), jnp.float32)
    cfg = ILQRConfig(iterations=3)

    local = solve_batched(system, x0s, us, cfg)
    shard_res, stats = parallel.solve_batched_sharded(system, x0s, us, cfg, mesh)

    np.testing.assert_allclose(
        np.asarray(shard_res.cost), np.asarray(local.cost), rtol=1e-4
    )
    assert stats["total_cost"].shape == ()
    np.testing.assert_allclose(
        float(stats["total_cost"]), float(jnp.sum(local.cost)), rtol=1e-4
    )
    assert float(stats["max_grad_norm"]) >= 0


def test_sharded_solve_bad_batch_raises():
    system = make_pendulum()
    mesh = parallel.make_mesh()
    n_dev = mesh.devices.size
    if n_dev < 2:
        pytest.skip("needs >1 device")
    x0s = jnp.zeros((n_dev + 1, 2), jnp.float32)
    us = jnp.zeros((n_dev + 1, 20, 1), jnp.float32)
    with pytest.raises(ValueError, match="divisible"):
        parallel.solve_batched_sharded(system, x0s, us, ILQRConfig(1), mesh)
