"""The iterated-fuse Triton kernel (ops/fuse_loop.py) and its route.

On the CPU the kernel runs in the Pallas interpreter (``interpret=True``),
which checks its arithmetic, masking and operand handling against a plain
``lax.fori_loop`` of the same body.  Lowering it for CUDA (``jax.export``
with ``platforms=["cuda"]``) checks on the CPU that every tile the library
composes has a Triton lowering; the compile for the card itself happens on
the GPU (the ``gpu``-marked test here, and chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import simplemath_tpu as sm
from simplemath_tpu import platform
from simplemath_tpu.ops import dispatch, fuse_loop
from simplemath_tpu.ops import transcendental as tc


def _ema(acc, x, s):
    return acc * s + x * x


def _reference(tile, operands, iterations, carry, dtype):
    def body(_, c):
        args = list(operands)
        args[carry] = c
        return tile(*args).astype(dtype)

    return jax.lax.fori_loop(
        0, iterations, body, jnp.asarray(operands[carry]).astype(dtype)
    )


@pytest.mark.parametrize(
    "shape", [(1,), (127,), (1000,), (4096,), (37, 41), (3, 5, 7)]
)
@pytest.mark.parametrize("iterations", [1, 2, 7])
def test_kernel_matches_fori_loop(shape, iterations):
    # Tails (sizes that no block divides), ranks 1-3, a scalar operand.
    rng = np.random.default_rng(sum(shape) + iterations)
    acc = rng.uniform(-1, 1, shape).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    s = np.float32(0.75)
    ops = [acc, x, s]
    got = fuse_loop.iterate(
        _ema, shape, jnp.float32, ops, iterations=iterations, carry=0,
        interpret=True,
    )
    want = _reference(_ema, ops, iterations, 0, jnp.float32)
    assert got.shape == shape and got.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize(
    "dtype", [jnp.float32, jnp.bfloat16, jnp.float16, jnp.int32]
)
def test_kernel_dtypes(dtype):
    x = jnp.arange(300).astype(dtype)
    acc = jnp.ones((300,), dtype)

    def tile(a, b):
        return a + b

    got = fuse_loop.iterate(
        tile, (300,), dtype, [acc, x], iterations=5, carry=0, interpret=True
    )
    want = _reference(tile, [acc, x], 5, 0, dtype)
    assert got.dtype == jnp.dtype(dtype)
    np.testing.assert_array_equal(
        np.asarray(got, np.float64), np.asarray(want, np.float64)
    )


def test_kernel_carry_in_any_position():
    x = jnp.linspace(0.0, 1.0, 500, dtype=jnp.float32)
    acc = jnp.zeros((500,), jnp.float32)

    def tile(a, c):
        return c * 0.5 + a

    got = fuse_loop.iterate(
        tile, (500,), jnp.float32, [x, acc], iterations=6, carry=1,
        interpret=True,
    )
    want = _reference(tile, [x, acc], 6, 1, jnp.float32)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("impl", ["native", "crafted"])
@pytest.mark.parametrize("name", ["exp", "log", "exp2", "tanh", "pow"])
def test_kernel_transcendental_tiles(name, impl):
    rng = np.random.default_rng(3)
    x = rng.uniform(0.5, 2.0, (777,)).astype(np.float32)
    e = rng.uniform(-1.0, 1.0, (777,)).astype(np.float32)
    acc = np.zeros((777,), np.float32)
    if name == "pow":
        t = tc._pow_tile("float32", impl)

        def tile(c, a, b):
            return c * np.float32(1e-3) + t(a + c * np.float32(1e-6), b)
    else:
        t = tc._unary_tile(name, "float32", impl)

        def tile(c, a, b):
            return c * np.float32(0.5) + t(a * np.float32(0.5) + b * b)

    ops = [acc, x, e]
    got = fuse_loop.iterate(
        tile, (777,), jnp.float32, ops, iterations=4, carry=0, interpret=True
    )
    want = _reference(tile, ops, 4, 0, jnp.float32)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


def test_kernel_donated_carry():
    x = jnp.ones((1024,), jnp.float32)
    got = fuse_loop.iterate(
        lambda a, b: a + b, (1024,), jnp.float32, [jnp.zeros_like(x), x],
        iterations=3, carry=0, donate=0, interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(got), np.full(1024, 3.0))


def test_kernel_rejects_broadcast_operands():
    with pytest.raises(ValueError, match="full-shape"):
        fuse_loop.iterate(
            lambda a, b: a + b, (8, 4), jnp.float32,
            [jnp.zeros((8, 4)), jnp.ones((1, 4))], iterations=2, carry=0,
            interpret=True,
        )


@pytest.mark.parametrize("n", [1, 100, 4096, 132 * 4 * 256, 1 << 22])
def test_block_size(n):
    block = fuse_loop.block_size(n)
    assert block & (block - 1) == 0, "power of two"
    assert fuse_loop._MIN_BLOCK <= block <= fuse_loop._MAX_BLOCK
    programs = -(-n // block)
    # Enough programs for every SM, unless the array is too small to fill
    # them even at the smallest block.
    assert programs >= fuse_loop._MIN_PROGRAMS or block == fuse_loop._MIN_BLOCK


@pytest.mark.parametrize(
    "case, want",
    [
        (dict(shape=(64, 64), ops=[(64, 64), (64, 64)], dtype="float32"), "triton"),
        (dict(shape=(64, 64), ops=[(64, 64), ()], dtype="float32"), "triton"),
        (dict(shape=(64, 64), ops=[(64, 64), (1, 1)], dtype="bfloat16"), "triton"),
        (dict(shape=(64, 64), ops=[(64, 64), (1, 64)], dtype="float32"), "xla"),
        (dict(shape=(64, 64), ops=[(64, 64)], dtype="float64"), "xla"),
        (dict(shape=(64, 64), ops=[(64, 64)], dtype="bool"), "xla"),
        (dict(shape=(64, 64), ops=[(64, 64)], dtype="float32", L=1), "xla"),
        (dict(shape=(64, 64), ops=[(64, 64)], dtype="float32", platform="cpu"), "xla"),
        (dict(shape=(1000,), ops=[(1000,), (1000,)], dtype="int32"), "triton"),
        (dict(shape=(0, 64), ops=[(0, 64)], dtype="float32"), "xla"),
        (dict(shape=(64, 64), ops=[(64, 64)], dtype="complex64"), "xla"),
    ],
)
def test_route_choice(case, want):
    got = platform.fuse_loop_route(
        case["shape"], case["ops"], np.dtype(case["dtype"]), case.get("L", 8),
        platform=case.get("platform", "gpu"),
    )
    assert got == want


def test_route_defaults_to_this_platform():
    # The test run is on the CPU, so the default route is XLA.
    assert platform.fuse_loop_route((8,), [(8,)], np.float32, 4) == "xla"


@pytest.fixture
def as_on_gpu(monkeypatch):
    """sm.fuse routed as on a GPU, with the kernel interpreted."""
    monkeypatch.setattr(platform.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(
        fuse_loop, "iterate", functools.partial(fuse_loop.iterate, interpret=True)
    )
    dispatch.reset()


def test_sm_fuse_takes_the_kernel_route(as_on_gpu, rng):
    a = rng.standard_normal((33, 65)).astype(np.float32)
    acc = np.zeros_like(a)
    f = sm.fuse(lambda c, x: c * 0.9 + sm.square(x), iterations=12)
    got = np.asarray(f(acc, a).jax())
    assert dispatch.counts() == {"fuse_loop:triton": 1}, dispatch.counts()
    want = acc
    for _ in range(12):
        want = want * np.float32(0.9) + a * a
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_sm_fuse_broadcast_row_stays_on_xla(as_on_gpu, rng):
    a = rng.standard_normal((16, 32)).astype(np.float32)
    row = rng.standard_normal((1, 32)).astype(np.float32)
    f = sm.fuse(lambda c, x, r: c * 0.5 + x * r, iterations=3)
    got = np.asarray(f(np.zeros_like(a), a, row).jax())
    assert dispatch.counts() == {"fuse_loop:xla": 1}, dispatch.counts()
    want = np.zeros_like(a)
    for _ in range(3):
        want = want * np.float32(0.5) + a * row
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_sm_fuse_kernel_route_under_jit(as_on_gpu, rng):
    a = rng.uniform(0.5, 2.0, (40, 50)).astype(np.float32)
    e = rng.uniform(-1.0, 1.0, (40, 50)).astype(np.float32)

    def chain(c, x, y):
        return c * 1e-3 + sm.exp(sm.pow(x + c * 1e-6, y))

    f = sm.fuse(chain, iterations=5)
    got = np.asarray(jax.jit(lambda c, x, y: f(c, x, y).jax())(
        np.zeros_like(a), a, e))
    assert dispatch.count("fuse_loop", "triton") == 1
    want = np.zeros_like(a)
    once = sm.fuse(chain)
    for _ in range(5):
        want = np.asarray(once(want, a, e).jax())
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _lower_for_cuda(tile, n_ops, dtype=jnp.float32, n=4096):
    ops = [jax.ShapeDtypeStruct((n,), dtype)] * n_ops
    f = functools.partial(
        fuse_loop.iterate, tile, (n,), dtype, iterations=8, carry=0
    )
    exported = jax.export.export(
        jax.jit(lambda *o: f(list(o))),
        platforms=["cuda"],
        disabled_checks=[
            jax.export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(*ops)
    return exported.mlir_module()


@pytest.mark.parametrize("impl", ["native", "crafted"])
@pytest.mark.parametrize("name", ["exp", "log", "exp2", "log2", "tanh", "pow"])
def test_kernel_lowers_to_triton_for_cuda(name, impl):
    if name == "pow":
        t = tc._pow_tile("float32", impl)

        def tile(c, a, b):
            return c * np.float32(1e-3) + t(a + c * np.float32(1e-6), b)
        n_ops = 3
    else:
        t = tc._unary_tile(name, "float32", impl)

        def tile(c, a):
            return c * np.float32(0.5) + t(a)
        n_ops = 2
    assert "xla.gpu.triton" in _lower_for_cuda(tile, n_ops)


def test_int_pow_kernel_lowers_to_triton_for_cuda():
    def tile(c, a):
        return c + tc.ipow_tile(a, a)

    assert "xla.gpu.triton" in _lower_for_cuda(tile, 2, jnp.int32)


def _tanh_or_exp2_tile(name):
    t = tc._unary_tile(name, "float32", "crafted")

    def tile(c, a):
        return c * np.float32(0.5) + t(a + c * np.float32(0.1))

    return tile


@pytest.mark.gpu
@pytest.mark.parametrize("body", ["ema", "exp2", "tanh"])
def test_kernel_on_the_card_matches_fori_loop(gpu, body):
    # auto takes the crafted exp2 and tanh on the card, so an sm.fuse that
    # calls them compiles the crafted code through Triton.
    x = jax.random.normal(jax.random.PRNGKey(0), (1 << 20,), jnp.float32)
    acc = jnp.zeros_like(x)
    if body == "ema":
        tile, ops = _ema, [acc, x, np.float32(0.9)]
    else:
        tile, ops = _tanh_or_exp2_tile(body), [acc, x]
    got = fuse_loop.iterate(
        tile, x.shape, jnp.float32, ops, iterations=50, carry=0
    )
    want = _reference(tile, ops, 50, 0, jnp.float32)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5)
