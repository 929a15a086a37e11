"""Tests for sm.fuse — fused elementwise chains as one program.

The reference has no fusion story at all (every op is its own OpenMP/SIMD
pass, include/math/calculate.h:5-99); sm.fuse is the answer to the
BASELINE configs[1] fused broadcast+pow+exp pipeline.  Correctness oracle:
the same chain as plain jnp ops in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import simplemath_tpu as sm
from simplemath_tpu.ops import dispatch


@pytest.fixture(autouse=True)
def _reset_dispatch():
    dispatch.reset()
    yield
    dispatch.reset()


def test_fused_exp_pow_matches_jnp(rng):
    a = rng.uniform(0.5, 2.0, (32, 64)).astype(np.float32)
    e = rng.uniform(-2.0, 2.0, (1, 64)).astype(np.float32)
    fused = sm.fuse(lambda x, y: sm.exp(sm.pow(x, y)))
    got = np.asarray(fused(sm.Array(a), sm.Array(e)).jax())
    want = np.exp(np.power(a.astype(np.float64), e.astype(np.float64)))
    np.testing.assert_allclose(got, want, rtol=3e-5)


def test_fused_single_kernel_launch(rng):
    a = rng.uniform(0.5, 2.0, (16, 256)).astype(np.float32)
    e = rng.uniform(-1.0, 1.0, (1, 256)).astype(np.float32)
    fused = sm.fuse(lambda x, y: sm.exp(sm.pow(x, y)))
    dispatch.reset()
    fused(a, e)
    counts = dispatch.counts()
    # Exactly ONE elementwise program, and it is the fused chain.
    ew = {k: v for k, v in counts.items() if k.startswith("elementwise:")}
    assert ew == {"elementwise:fused": 1}, counts


def test_fused_signature_cache_stable(rng):
    a = rng.standard_normal((8, 128)).astype(np.float32)
    b = rng.standard_normal((8, 128)).astype(np.float32)
    fused = sm.fuse(lambda x, y: sm.add(sm.multiply(x, y), 1.0))
    fused(a, b)
    expr = next(iter(fused._cache.values()))
    fused(a, b)
    fused(a, b)
    assert len(fused._cache) == 1
    assert next(iter(fused._cache.values())) is expr


def test_fused_operators_and_constants(rng):
    a = rng.standard_normal((4, 32)).astype(np.float32)
    b = rng.standard_normal((4, 32)).astype(np.float32)
    fused = sm.fuse(lambda x, y: (x * 2.0 + y) / (sm.sqrt(sm.square(x) + 1.0)))
    got = np.asarray(fused(a, b).jax())
    want = (a * 2.0 + b) / np.sqrt(a * a + 1.0)
    np.testing.assert_allclose(got, want, rtol=2e-6)


def test_fused_static_int_pow_exact():
    a = np.array([[1.5, -2.0, 3.0, 0.5]], dtype=np.float32)
    fused = sm.fuse(lambda x: sm.pow(x, 3))
    got = np.asarray(fused(a).jax())
    np.testing.assert_array_equal(got, a**3)


def test_fused_int_pow_edge_semantics():
    base = np.array([[0, 1, -1, 2, -3]], dtype=np.int32)
    expo = np.array([[5, -4, -3, 3, 2]], dtype=np.int32)
    fused = sm.fuse(lambda x, y: sm.pow(x, y))
    got = np.asarray(fused(base, expo).jax())
    # reference crafted_pow negative-exponent table: 0 except bases +-1
    np.testing.assert_array_equal(got, np.array([[0, 1, -1, 8, 9]]))


def test_fused_broadcast_not_materialized(rng):
    a = rng.standard_normal((64, 256)).astype(np.float32)
    row = rng.standard_normal((1, 256)).astype(np.float32)
    fused = sm.fuse(lambda x, r: x * r + r)
    got = np.asarray(fused(a, row).jax())
    np.testing.assert_allclose(got, a * row + row, rtol=1e-6, atol=1e-6)


def test_fused_rejects_array_constant(rng):
    a = rng.standard_normal((4, 4)).astype(np.float32)
    captured = np.ones((4, 4), np.float32)
    fused = sm.fuse(lambda x: sm.add(x, captured))
    with pytest.raises(TypeError, match="arguments to the fused"):
        fused(a)


def test_fused_rejects_non_expr_return():
    fused = sm.fuse(lambda x: 42)
    with pytest.raises(TypeError, match="must return a fused"):
        fused(np.ones((2, 2), np.float32))


def test_fused_unsupported_op_raises(rng):
    a = rng.standard_normal((4, 4)).astype(np.float32)
    fused = sm.fuse(lambda x: sm.sort(x))
    with pytest.raises(TypeError, match="not supported inside sm.fuse"):
        fused(a)


def test_fused_iterated_matches_python_loop(rng):
    # iterations=L == applying the chain L times; with a broadcast row
    # operand it stays on XLA's fori_loop on every platform.
    a = rng.uniform(0.5, 2.0, (16, 256)).astype(np.float32)
    e = rng.uniform(-1.0, 1.0, (1, 256)).astype(np.float32)
    acc0 = np.zeros_like(a)

    def chain(acc, x, y):
        return acc * np.float32(0.5) + sm.exp(sm.pow(x + acc * np.float32(1e-3), y))

    L = 5
    fused_iter = sm.fuse(chain, iterations=L)
    dispatch.reset()
    got = np.asarray(fused_iter(acc0, a, e).jax())
    assert dispatch.counts() == {"fuse_loop:xla": 1}, dispatch.counts()

    fused_once = sm.fuse(chain)
    want = acc0
    for _ in range(L):
        want = np.asarray(fused_once(want, a, e).jax())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_fused_iterated_1d_and_flattened_paths(rng):
    # 1-D operands.
    a = rng.standard_normal((4096,)).astype(np.float32)
    f = sm.fuse(lambda acc, x: acc * np.float32(0.9) + sm.square(x),
                iterations=3)
    got = np.asarray(f(np.zeros_like(a), a).jax())
    want = np.zeros_like(a)
    for _ in range(3):
        want = want * np.float32(0.9) + a * a
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # A (B, 3, 3) stack of small matrices.
    b = rng.standard_normal((64, 3, 3)).astype(np.float32)
    g = sm.fuse(lambda acc, x: acc + x * x, iterations=4)
    got2 = np.asarray(g(np.zeros_like(b), b).jax())
    np.testing.assert_allclose(got2, 4.0 * b * b, rtol=1e-6)


def test_fused_iterated_with_donated_carry(rng):
    # iterations + donate=carry (the shape of the fused_pipeline bench).
    a = rng.uniform(0.5, 2.0, (16, 256)).astype(np.float32)
    e = rng.uniform(-1.0, 1.0, (1, 256)).astype(np.float32)

    def chain(acc, x, y):
        return acc * np.float32(1e-3) + sm.exp(
            sm.pow(x + acc * np.float32(1e-6), y)
        )

    L = 4
    f_iter = sm.fuse(chain, donate=0, iterations=L)
    got = np.asarray(f_iter(np.zeros_like(a), a, e).jax())
    f_once = sm.fuse(chain)
    want = np.zeros_like(a)
    for _ in range(L):
        want = np.asarray(f_once(want, a, e).jax())
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


def test_fused_iterated_shape_mismatch_raises(rng):
    a = rng.standard_normal((8, 128)).astype(np.float32)
    e = rng.standard_normal((1, 128)).astype(np.float32)
    # Result broadcasts to (8, 128) but the carry is the (1, 128) row.
    f = sm.fuse(lambda row, x: x + row, iterations=2)
    with pytest.raises(ValueError, match="must match carry"):
        f(e, a)


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_fused_map_reduce_matches_numpy(op, rng):
    # Full reductions may ROOT a fused function: chain and reduction
    # compile together (FusedReduction).
    a = rng.standard_normal((64, 256)).astype(np.float32)
    b = rng.standard_normal((64, 256)).astype(np.float32)
    fused = sm.fuse(lambda x, y: getattr(sm, op)(sm.square(x - y)))
    dispatch.reset()
    got = float(fused(a, b).jax())
    assert dispatch.count("reduce_fused", "sum" if op == "mean" else op) == 1
    d = (a.astype(np.float64) - b.astype(np.float64)) ** 2
    want = getattr(np, op if op != "max" else "max")(d) if op != "mean" else d.mean()
    want = {"sum": d.sum(), "mean": d.mean(), "max": d.max(), "min": d.min()}[op]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_fused_map_reduce_broadcast_falls_back(rng):
    # Partially-broadcast operands under a reduction root.
    a = rng.standard_normal((32, 128)).astype(np.float32)
    row = rng.standard_normal((1, 128)).astype(np.float32)
    fused = sm.fuse(lambda x, r: sm.sum(x * r))
    got = float(fused(a, row).jax())
    np.testing.assert_allclose(
        got, (a.astype(np.float64) * row.astype(np.float64)).sum(),
        rtol=1e-4,
    )


def test_fused_reduction_must_be_root(rng):
    a = rng.standard_normal((8, 32)).astype(np.float32)
    fused = sm.fuse(lambda x: sm.sum(sm.square(x)) + 1.0)
    with pytest.raises(TypeError, match="cannot be composed further"):
        fused(a)
    # Axis reductions ARE supported as fuse roots since round 5
    # (tests/test_reduce_axis.py covers them); composing past one is not.
    fused_axis = sm.fuse(lambda x: sm.sum(sm.square(x), axis=0) + 1.0)
    with pytest.raises(TypeError, match="cannot be composed"):
        fused_axis(a)


def test_fused_map_reduce_ragged_and_1d(rng):
    # Odd flat size.
    a = rng.standard_normal((3333,)).astype(np.float32)
    fused = sm.fuse(lambda x: sm.sum(sm.abs(x)))
    got = float(fused(a).jax())
    np.testing.assert_allclose(got, np.abs(a.astype(np.float64)).sum(), rtol=1e-5)
    # max over negative values.
    fused_max = sm.fuse(lambda x: sm.max(x * 2.0))
    got2 = float(fused_max(a).jax())
    np.testing.assert_allclose(got2, (a * 2.0).max(), rtol=1e-6)


def test_fused_under_jit(rng):
    a = rng.uniform(0.5, 2.0, (16, 128)).astype(np.float32)
    e = rng.uniform(-1.0, 1.0, (1, 128)).astype(np.float32)
    fused = sm.fuse(lambda x, y: sm.exp(sm.pow(x, y)))

    @jax.jit
    def f(x, y):
        return fused(x, y).jax()

    got = np.asarray(f(a, e))
    want = np.exp(np.power(a.astype(np.float64), e.astype(np.float64)))
    np.testing.assert_allclose(got, want, rtol=3e-5)


def test_fused_transcendental_accuracy_at_reference_failure_points():
    # exp below 1.1 and log at 3.0 — the reference's documented bugs
    # (README.md:8-10) must hold inside fused chains too, at the default
    # ("auto") contract.
    x = np.array([[0.1, 0.5, 1.0, 1.09, 3.0]], dtype=np.float32)
    fused = sm.fuse(lambda v: sm.log(sm.exp(v)))
    got = np.asarray(fused(x).jax())
    np.testing.assert_allclose(got, x, rtol=2e-5, atol=1e-5)


def test_fused_donation_in_loop(rng):
    a = rng.uniform(0.5, 2.0, (16, 256)).astype(np.float32)
    e = rng.uniform(-1.0, 1.0, (1, 256)).astype(np.float32)
    fused = sm.fuse(
        lambda acc, x, ee: acc * np.float32(0.5) + sm.exp(sm.pow(x, ee)),
        donate=0,
    )

    @jax.jit
    def run(x, ee):
        def body(i, acc):
            return fused(acc, x, ee).jax()

        return jax.lax.fori_loop(0, 3, body, jnp.zeros_like(x))

    got = np.asarray(run(a, e))
    want = np.zeros_like(a)
    for _ in range(3):
        want = want * 0.5 + np.exp(
            np.power(a.astype(np.float64), e.astype(np.float64))
        )
    np.testing.assert_allclose(got, want.astype(np.float32), rtol=1e-4)


def test_fused_donation_shape_mismatch_raises(rng):
    a = rng.standard_normal((8, 128)).astype(np.float32)
    row = rng.standard_normal((1, 128)).astype(np.float32)
    fused = sm.fuse(lambda x, r: x + r, donate=1)  # r doesn't match out
    with pytest.raises(ValueError, match="donated operand"):
        fused(a, row)


def test_fused_trig(rng):
    a = rng.uniform(-1.0, 1.0, (8, 128)).astype(np.float32)
    b = rng.uniform(-1.0, 1.0, (8, 128)).astype(np.float32)
    fused = sm.fuse(lambda x, y: sm.tanh(sm.sin(x) * sm.cos(y)))
    got = np.asarray(fused(a, b).jax())
    want = np.tanh(np.sin(a.astype(np.float64)) * np.cos(b.astype(np.float64)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_fused_weak_scalar_argument_keeps_chain_dtype(rng):
    # A weak 0-d scalar ARGUMENT (jnp.asarray(0.5) under x64 is weak f64)
    # must not promote the chain: the expression stays f32 and log routes
    # per the f32 contract, not the f64/jnp branch.
    import jax.numpy as jnp

    a = rng.uniform(0.5, 2.0, (8, 128)).astype(np.float32)
    fused = sm.fuse(lambda s, x: sm.log(sm.exp(x * s)))
    out = fused(jnp.asarray(0.5), a)
    assert out.dtype == np.float32
    np.testing.assert_allclose(
        np.asarray(out.jax()), a * 0.5, rtol=1e-5, atol=1e-6
    )


def test_fused_where_clip(rng):
    a = rng.standard_normal((8, 256)).astype(np.float32)
    b = rng.standard_normal((8, 256)).astype(np.float32)
    fused = sm.fuse(
        lambda x, y: sm.clip(sm.where(x > y, x * 2.0, y - 1.0), -2.0, 2.0)
    )
    dispatch.reset()
    got = np.asarray(fused(a, b).jax())
    ew = {k: v for k, v in dispatch.counts().items()
          if k.startswith("elementwise:")}
    assert ew == {"elementwise:fused": 1}, dispatch.counts()
    want = np.clip(np.where(a > b, a * 2.0, b - 1.0), -2.0, 2.0)
    np.testing.assert_allclose(got, want, rtol=1e-6)
