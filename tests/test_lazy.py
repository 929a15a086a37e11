"""Deferred-eager queue (ops/lazy.py): eager op chains flush as ONE program.

The reference computes every op immediately (one OpenMP/SIMD pass each,
include/math/calculate.h); on an accelerator each eager op dispatched alone
is a launch and a pass over device memory.  These tests pin the queue's
contract: correctness vs the immediate path, one program per chain,
snapshot semantics under mutation, eager shape errors, dtype parity
(including weak scalars and int->float ops), and zero behavior change with
SM_DEFERRED_EAGER=0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import simplemath_tpu as sm
from simplemath_tpu.config import config
from simplemath_tpu.ops import dispatch, lazy


@pytest.fixture(autouse=True)
def _reset():
    dispatch.reset()
    yield
    dispatch.reset()


def test_chain_matches_immediate(rng):
    a = rng.uniform(0.5, 2.0, (16, 64)).astype(np.float32)
    b = rng.uniform(0.5, 2.0, (16, 64)).astype(np.float32)
    got = sm.sqrt(sm.add(sm.pow(sm.Array(a), 2), sm.multiply(sm.Array(b), 3.0)))
    assert isinstance(got, lazy.LazyArray)
    want = np.sqrt(a.astype(np.float64) ** 2 + b.astype(np.float64) * 3.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_chain_is_one_kernel_launch(rng):
    a = rng.uniform(0.5, 2.0, (16, 256)).astype(np.float32)
    b = rng.uniform(0.5, 2.0, (16, 256)).astype(np.float32)
    out = sm.sqrt(sm.add(sm.square(sm.Array(a)), sm.Array(b)))
    dispatch.reset()
    out.jax()
    ew = {k: v for k, v in dispatch.counts().items()
          if k.startswith("elementwise:")}
    assert ew == {"elementwise:fused": 1}, dispatch.counts()


def test_single_op_flushes_through_original_path(rng):
    # A one-op tree replays the eager engine: same dispatch name, same tile.
    a = rng.standard_normal((16, 256)).astype(np.float32)
    b = rng.standard_normal((16, 256)).astype(np.float32)
    out = sm.add(sm.Array(a), sm.Array(b))
    dispatch.reset()
    out.jax()
    assert dispatch.count("elementwise", "add") == 1
    assert dispatch.count("elementwise", "fused") == 0


def test_operand_snapshot_survives_mutation(rng):
    # The queue must snapshot VALUES: writing to an operand after the op is
    # recorded cannot change the result.
    a = sm.Array(np.ones((4, 4), np.float32))
    b = sm.Array(np.full((4, 4), 2.0, np.float32))
    c = sm.add(a, b)
    d = sm.multiply(c, 10.0)
    a[0, 0] = 100.0
    np.testing.assert_allclose(d.numpy(), np.full((4, 4), 30.0))
    # ... while the mutation itself is still visible on `a`.
    assert float(a[0, 0].jax()) == 100.0


def test_shape_errors_raise_at_the_op_call():
    a = sm.Array(np.ones((3, 4), np.float32))
    b = sm.Array(np.ones((5,), np.float32))
    with pytest.raises(ValueError):
        sm.add(a, b)


def test_dtype_parity_with_eager():
    a16 = sm.Array(np.ones((8, 8)), dtype=jnp.bfloat16)
    # Weak Python scalar must not promote bf16 to f32.
    assert sm.add(a16, 2.0).dtype == jnp.bfloat16
    assert sm.add(a16, 2.0).numpy().dtype == jnp.bfloat16
    # int/int true-divide and int sqrt promote to float like jnp.
    ai = sm.Array(np.arange(4, dtype=np.int32))
    assert sm.divide(ai, ai + 1).dtype == jnp.float32
    assert sm.sqrt(ai).dtype == jnp.float32
    np.testing.assert_allclose(
        sm.sqrt(ai).numpy(), np.sqrt(np.arange(4)), rtol=1e-6
    )
    # Comparisons stay bool through a chain.
    assert (sm.add(ai, 1) > 2).dtype == jnp.dtype(bool)


def test_lazy_metadata_without_flush(rng):
    a = sm.Array(rng.standard_normal((6, 7)).astype(np.float32))
    out = sm.add(sm.multiply(a, 2.0), 1.0)
    assert isinstance(out, lazy.LazyArray)
    assert out.shape == (6, 7)
    assert out.ndim == 2
    assert out.size == 42
    assert out._pending is not None  # metadata queries did not flush


def test_flush_triggers():
    a = sm.Array(np.ones((4, 4), np.float32))
    # indexing
    v = sm.add(a, 1.0)[0, 0]
    assert float(v.jax()) == 2.0
    # reduction
    s = sm.sum(sm.multiply(a, 2.0))
    np.testing.assert_allclose(float(s.jax()), 32.0)
    # float()/bool()
    assert float(sm.add(sm.Array(np.float32(1.0)), 1.0)) == 2.0
    # jit boundary (pytree flatten)
    out = jax.jit(lambda x: x + 1)(sm.add(a, 1.0))
    np.testing.assert_allclose(np.asarray(out), np.full((4, 4), 3.0))


def test_setitem_on_lazy_result():
    a = sm.Array(np.zeros((3, 3), np.float32))
    out = sm.add(a, 5.0)
    out[1, 1] = -1.0
    want = np.full((3, 3), 5.0, np.float32)
    want[1, 1] = -1.0
    np.testing.assert_allclose(out.numpy(), want)


def test_views_as_operands(rng):
    x = rng.standard_normal((6, 6)).astype(np.float32)
    a = sm.Array(x)
    row = a[2]  # aliasing view
    out = sm.multiply(sm.add(row, 1.0), 2.0)
    np.testing.assert_allclose(out.numpy(), (x[2] + 1.0) * 2.0, rtol=1e-6)


def test_ipow_chain_uses_crafted_kernel(rng):
    # int ** static int then + 1: the chain composes the integer pow.
    base = rng.integers(-4, 5, size=(8, 128)).astype(np.int32)
    out = sm.add(sm.pow(sm.Array(base), 3), 1)
    got = out.numpy()
    np.testing.assert_array_equal(
        got, (base.astype(np.int64) ** 3 + 1).astype(np.int32)
    )


def test_transcendental_chain(rng):
    a = rng.uniform(0.5, 2.0, (8, 128)).astype(np.float32)
    out = sm.log(sm.exp(sm.multiply(sm.Array(a), 0.5)))
    np.testing.assert_allclose(out.numpy(), a * 0.5, rtol=1e-5, atol=1e-6)


def test_chain_caps_force_partial_flush(rng):
    # Exceeding the operand/node caps flushes the prefix instead of growing
    # without bound; results stay correct.
    a = sm.Array(np.float32(1.0))
    acc = sm.Array(np.zeros((4,), np.float32))
    for i in range(40):
        acc = sm.add(acc, a)
    np.testing.assert_allclose(acc.numpy(), np.full((4,), 40.0))


def test_disable_flag_restores_immediate_eval(rng):
    old = config.deferred_eager
    config.deferred_eager = False
    try:
        a = sm.Array(np.ones((4, 4), np.float32))
        out = sm.add(a, 1.0)
        assert not isinstance(out, lazy.LazyArray)
        np.testing.assert_allclose(out.numpy(), 2.0 * np.ones((4, 4)))
    finally:
        config.deferred_eager = old


def test_compose_cache_stable(rng):
    # Re-running the same eager chain reuses the composed expression (no
    # per-call retrace of the tree).
    a = rng.standard_normal((8, 128)).astype(np.float32)
    b = rng.standard_normal((8, 128)).astype(np.float32)

    def chain():
        return sm.sqrt(sm.add(sm.square(sm.Array(a)), sm.square(sm.Array(b)))).jax()

    chain()
    info1 = lazy._compose.cache_info()
    chain()
    info2 = lazy._compose.cache_info()
    assert info2.hits > info1.hits
    assert info2.misses == info1.misses


def test_eager_chain_reduction_is_single_pass(rng):
    # sm.sum over a pending chain composes map+reduce into one program
    # instead of flushing the elementwise chain first.
    a = rng.standard_normal((64, 256)).astype(np.float32)
    b = rng.standard_normal((64, 256)).astype(np.float32)
    expr = sm.square(sm.subtract(sm.Array(a), sm.Array(b)))
    dispatch.reset()
    got = float(sm.sum(expr).jax())
    counts = dispatch.counts()
    assert counts.get("reduce_fused:sum") == 1, counts
    assert not any(k.startswith("elementwise:") for k in counts), counts
    want = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).sum()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_eager_chain_reductions_match_numpy(op, rng):
    a = rng.uniform(0.5, 2.0, (32, 128)).astype(np.float32)
    chain = sm.multiply(sm.add(sm.Array(a), 1.0), 2.0)
    got = float(getattr(sm, op)(chain).jax())
    d = (a.astype(np.float64) + 1.0) * 2.0
    want = {"sum": d.sum(), "mean": d.mean(), "max": d.max(), "min": d.min()}[op]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # method spelling too
    got_m = float(getattr(chain if hasattr(chain, op) else chain, op)().jax())
    np.testing.assert_allclose(got_m, want, rtol=1e-5)


def test_eager_chain_axis_reduction_flushes(rng):
    # axis reductions flush the chain and use the normal path.
    a = rng.standard_normal((8, 16)).astype(np.float32)
    chain = sm.add(sm.Array(a), 1.0)
    out = sm.sum(chain, axis=0)
    np.testing.assert_allclose(
        np.asarray(out.jax()), (a + 1.0).sum(axis=0), rtol=1e-5
    )


def test_where_clip_sign_defer_and_fuse(rng):
    a = rng.standard_normal((16, 256)).astype(np.float32)
    b = rng.standard_normal((16, 256)).astype(np.float32)
    # where over a lazy chain: one fused program at materialization.
    out = sm.where(sm.Array(a) > 0, sm.square(sm.Array(a)), sm.Array(b))
    assert isinstance(out, lazy.LazyArray)
    dispatch.reset()
    got = np.asarray(out.jax())
    ew = {k: v for k, v in dispatch.counts().items()
          if k.startswith("elementwise:")}
    assert ew == {"elementwise:fused": 1}, dispatch.counts()
    np.testing.assert_allclose(got, np.where(a > 0, a * a, b), rtol=1e-6)
    # clip with scalar bounds chains too.
    out2 = sm.clip(sm.multiply(sm.Array(a), 2.0), -1.0, 1.0)
    np.testing.assert_allclose(
        np.asarray(out2.jax()), np.clip(a * 2.0, -1.0, 1.0), rtol=1e-6
    )
    # sign rides the unary engine.
    out3 = sm.sign(sm.Array(a))
    np.testing.assert_array_equal(np.asarray(out3.jax()), np.sign(a))
    # one-sided clip falls back to jnp (no deferral) but still works.
    out4 = sm.clip(sm.Array(a), None, 0.5)
    np.testing.assert_allclose(np.asarray(out4.jax()), np.clip(a, None, 0.5))
