"""Custom-op extension mechanism — reference README.md:86-133 MyOp example."""

import numpy as np
import pytest

import simplemath_tpu as sm


def test_register_and_apply_custom_op():
    # The reference's MyOp: (a + b) * 2 with an AVX2 specialization
    # (README.md:94-117).  Here one jnp lambda covers every dtype and the
    # fused tile path.
    if "my_op" not in sm.registered_ops():
        sm.register_op("my_op", lambda a, b: (a + b) * 2)
    a = sm.Array([1.0, 2.0, 3.0])
    b = sm.Array([4.0, 5.0, 6.0])
    out = sm.apply_op("my_op", a, b)
    np.testing.assert_allclose(out.numpy(), [10.0, 14.0, 18.0])


def test_custom_op_broadcasts():
    if "my_op2" not in sm.registered_ops():
        sm.register_op("my_op2", lambda a, b: a * 10 + b)
    a = sm.ones(2, 1)
    b = sm.Array([[1.0, 2.0, 3.0]])
    out = sm.apply_op("my_op2", a, b)
    assert out.shape == (2, 3)
    np.testing.assert_allclose(out.numpy()[0], [11.0, 12.0, 13.0])


def test_custom_unary_op():
    if "triple" not in sm.registered_ops():
        sm.register_op("triple", lambda a: a * 3, arity=1)
    out = sm.apply_op("triple", sm.Array([1.0, 2.0]))
    np.testing.assert_allclose(out.numpy(), [3.0, 6.0])


def test_duplicate_registration_raises():
    sm.register_op("dup_op_test", lambda a, b: a, overwrite=True)
    with pytest.raises(ValueError, match="already registered"):
        sm.register_op("dup_op_test", lambda a, b: a)


def test_operator_attachment():
    # Reference step 3 (README.md:119-133) wires the op into an operator on
    # SMArray; python allows the same via bound dunder.
    sm.register_op("xor_demo", lambda a, b: (a + b) * 2, overwrite=True)
    sm.Array.__xor__ = lambda self, other: sm.apply_op("xor_demo", self, other)
    try:
        out = sm.Array([1.0]) ^ sm.Array([2.0])
        np.testing.assert_allclose(out.numpy(), [6.0])
    finally:
        del sm.Array.__xor__


def test_custom_tile_fn_dispatched_to_pallas():
    # The reference's extension story is scalar apply + a SIMD specialization
    # (AddOp::apply_simd, README.md:94-117).  Here the specialization is the
    # tile_fn that fused chains compose; this asserts a chain traces it.
    traced = []

    def tile(a, b):
        traced.append(True)  # fires when the chain is composed
        return (a + b) * 2

    sm.register_op(
        "tiled_op", lambda a, b: (a + b) * 2, tile_fn=tile, overwrite=True
    )
    a = sm.ones(16, 256)
    b = sm.ones(16, 256)
    out = sm.apply_op("tiled_op", a, b) * 1.0  # a two-op chain
    out.jax()
    assert traced, "custom tile_fn was never traced by the fused chain"
    np.testing.assert_allclose(out.numpy(), np.full((16, 256), 4.0))
