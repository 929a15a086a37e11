"""Public sm ops + sm.fuse composed under shard_map over a device mesh.

The deployment shape for the distributed layer (SURVEY §2.3): per-device
compute inside shard_map shards runs the SAME public sm ops / fused chains
as single-device code — these tests pin that each path traces and executes
correctly inside shard_map-sharded programs with collectives mixed in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

import simplemath_tpu as sm
from simplemath_tpu import parallel
from simplemath_tpu.ops import dispatch

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multiple devices"
)


@pytest.fixture(autouse=True)
def reset_dispatch():
    dispatch.reset()
    yield


def test_elementwise_kernel_inside_shard_map(rng):
    mesh = parallel.make_mesh()
    n_dev = mesh.devices.size
    a = rng.standard_normal((n_dev * 4, 256)).astype(np.float32)
    b = rng.standard_normal((n_dev * 4, 256)).astype(np.float32)

    def shard_fn(a_s, b_s):
        c = sm.add(sm.Array(a_s), sm.Array(b_s)).jax()
        # mix a collective with the op's output
        total = jax.lax.psum(jnp.sum(c), "scenario")
        return c, total

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("scenario"), P("scenario")),
        out_specs=(P("scenario"), P()),
        check_vma=False,
    )
    c, total = jax.jit(fn)(a, b)
    np.testing.assert_allclose(np.asarray(c), a + b, rtol=1e-6)
    np.testing.assert_allclose(float(total), (a + b).sum(), rtol=1e-4)
    assert dispatch.count("elementwise", "add") >= 1


def test_fused_kernel_inside_shard_map(rng):
    mesh = parallel.make_mesh()
    n_dev = mesh.devices.size
    a = rng.uniform(0.5, 2.0, (n_dev * 2, 128)).astype(np.float32)
    e = rng.uniform(-1.0, 1.0, (n_dev * 2, 128)).astype(np.float32)
    fused = sm.fuse(lambda x, y: sm.exp(sm.pow(x, y)))

    def shard_fn(a_s, e_s):
        return fused(a_s, e_s).jax()

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("scenario"), P("scenario")),
        out_specs=P("scenario"),
        check_vma=False,
    )
    got = np.asarray(jax.jit(fn)(a, e))
    want = np.exp(np.power(a.astype(np.float64), e.astype(np.float64)))
    np.testing.assert_allclose(got, want, rtol=3e-5)
    assert dispatch.count("elementwise", "fused") >= 1


def test_reduction_kernel_inside_shard_map(rng):
    mesh = parallel.make_mesh()
    n_dev = mesh.devices.size
    x = rng.standard_normal((n_dev * 8, 100)).astype(np.float32)

    def shard_fn(x_s):
        local = sm.Array(x_s).sum().jax()
        return jax.lax.psum(local, "scenario")

    fn = shard_map(
        shard_fn, mesh=mesh, in_specs=(P("scenario"),), out_specs=P(),
        check_vma=False,
    )
    got = float(jax.jit(fn)(x))
    np.testing.assert_allclose(got, x.sum(), rtol=1e-4)
    assert dispatch.count("reduce", "sum") >= 1


def test_matmul_mxu_kernel_inside_shard_map(rng):
    # The matmul path the sharded solvers hit at scale, composing with
    # shard_map: row-sharded A, replicated B, per-shard matmul, psum'd
    # checksum.
    mesh = parallel.make_mesh()
    n_dev = mesh.devices.size
    a = (rng.standard_normal((n_dev * 256, 256)) / 16).astype(np.float32)
    b = (rng.standard_normal((256, 288)) / 16).astype(np.float32)

    def shard_fn(a_s, b_full):
        c = sm.matmul(sm.Array(a_s), sm.Array(b_full)).jax()
        return c, jax.lax.psum(jnp.sum(c), "scenario")

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("scenario"), P()),
        out_specs=(P("scenario"), P()),
        check_vma=False,
    )
    c, total = jax.jit(fn)(a, b)
    assert dispatch.count("matmul", "mm") >= 1
    np.testing.assert_allclose(np.asarray(c), a @ b, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(total), (a @ b).sum(), rtol=1e-3)


def test_bmm_mxu_kernel_inside_shard_map(rng):
    # Batched rank-3 contraction sharded over the batch axis — the exact
    # (B, n, m) @ (B, m, k) shape of the solver layer's KKT assembly.
    mesh = parallel.make_mesh()
    n_dev = mesh.devices.size
    a = (rng.standard_normal((n_dev, 256, 260)) / 16).astype(np.float32)
    b = (rng.standard_normal((n_dev, 260, 256)) / 16).astype(np.float32)

    def shard_fn(a_s, b_s):
        return sm.matmul(sm.Array(a_s), sm.Array(b_s)).jax()

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("scenario"), P("scenario")),
        out_specs=P("scenario"),
        check_vma=False,
    )
    got = np.asarray(jax.jit(fn)(a, b))
    assert dispatch.count("matmul", "bmm") >= 1
    np.testing.assert_allclose(got, a @ b, rtol=2e-4, atol=2e-4)


def test_dot1d_kernel_inside_shard_map(rng):
    # Sharded 1-D dot: per-shard multiply+reduce, psum across the mesh ==
    # the distributed form of product.h's dot loops.
    mesh = parallel.make_mesh()
    n_dev = mesh.devices.size
    a = rng.standard_normal((n_dev * 2048,)).astype(np.float32)
    b = rng.standard_normal((n_dev * 2048,)).astype(np.float32)

    def shard_fn(a_s, b_s):
        local = sm.dot(sm.Array(a_s), sm.Array(b_s)).jax()
        return jax.lax.psum(local, "scenario")

    fn = shard_map(
        shard_fn, mesh=mesh, in_specs=(P("scenario"), P("scenario")),
        out_specs=P(), check_vma=False,
    )
    got = float(jax.jit(fn)(a, b))
    assert dispatch.count("dot1d") >= 1
    np.testing.assert_allclose(
        got, np.dot(a.astype(np.float64), b.astype(np.float64)), rtol=1e-4
    )


def test_matmul_epilogue_inside_shard_map(rng):
    # The fused epilogue (relu(x @ W + b)) composes with SPMD: per-shard
    # activations against a replicated weight, a collective over the
    # outputs.
    mesh = parallel.make_mesh()
    n_dev = mesh.devices.size
    X = rng.standard_normal((n_dev * 256, 300)).astype(np.float32)
    W = rng.standard_normal((300, 320)).astype(np.float32)
    b = rng.standard_normal((1, 320)).astype(np.float32)
    layer = sm.fuse(lambda x, w, bias: sm.maximum(x @ w + bias, 0.0))

    def shard_fn(x_s, w_s, b_s):
        y = layer(x_s, w_s, b_s).jax()
        return y, jax.lax.psum(jnp.sum(y), "scenario")

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("scenario"), P(), P()),
        out_specs=(P("scenario"), P()),
        check_vma=False,
    )
    y, total = jax.jit(fn)(X, W, b)
    want = np.maximum(X @ W + b, 0.0)
    np.testing.assert_allclose(np.asarray(y), want, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(float(total), want.sum(), rtol=1e-4)


def test_axis_reduction_inside_shard_map(rng):
    # Per-shard row reductions + cross-shard psum.
    mesh = parallel.make_mesh()
    n_dev = mesh.devices.size
    A = rng.standard_normal((n_dev * 64, 256)).astype(np.float32)

    def shard_fn(a_s):
        rows = sm.array(a_s).sum(axis=1).jax()
        return rows, jax.lax.psum(jnp.sum(rows), "scenario")

    fn = shard_map(
        shard_fn, mesh=mesh, in_specs=(P("scenario"),),
        out_specs=(P("scenario"), P()), check_vma=False,
    )
    rows, total = jax.jit(fn)(A)
    np.testing.assert_allclose(np.asarray(rows), A.sum(axis=1), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(total), A.sum(), rtol=1e-4)


def test_view_kernel_inside_shard_map(rng):
    # A transposed view operand under shard_map.
    mesh = parallel.make_mesh()
    n_dev = mesh.devices.size
    A = rng.standard_normal((256, n_dev * 32)).astype(np.float32)
    B = rng.standard_normal((n_dev * 32, 256)).astype(np.float32)

    def shard_fn(a_s, b_s):
        # a_s arrives (256, 32) per shard; transpose-view + add
        return sm.add(sm.Array(a_s).T, sm.Array(b_s)).jax()

    fn = shard_map(
        shard_fn, mesh=mesh, in_specs=(P(None, "scenario"), P("scenario")),
        out_specs=P("scenario"), check_vma=False,
    )
    out = jax.jit(fn)(A, B)
    np.testing.assert_allclose(np.asarray(out), A.T + B, rtol=1e-5, atol=1e-5)
