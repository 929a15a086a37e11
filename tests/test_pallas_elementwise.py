"""Broadcast elementwise ops through the public API vs the NumPy oracle —
the engine tests the reference runs implicitly through its >100k-element
broadcast suites (SURVEY §4)."""

import numpy as np

import simplemath_tpu as sm
from simplemath_tpu import platform


def test_contiguous_add(rng):
    a = rng.normal(size=(64, 256)).astype(np.float32)
    b = rng.normal(size=(64, 256)).astype(np.float32)
    out = sm.Array(a) + sm.Array(b)
    np.testing.assert_allclose(out.numpy(), a + b, rtol=1e-6)


def test_1d_add(rng):
    a = rng.normal(size=(1000,)).astype(np.float32)
    b = rng.normal(size=(1000,)).astype(np.float32)
    out = sm.Array(a) + sm.Array(b)
    np.testing.assert_allclose(out.numpy(), a + b, rtol=1e-6)


def test_broadcast_no_materialize(rng):
    # Stride-0 analog: (B, N, C) * (1, 1, C), read with stride 0 by the
    # fusion.
    a = rng.normal(size=(4, 96, 130)).astype(np.float32)
    b = rng.normal(size=(1, 1, 130)).astype(np.float32)
    out = sm.Array(a) * sm.Array(b)
    np.testing.assert_allclose(out.numpy(), a * b, rtol=1e-6)


def test_image_broadcast_case(rng):
    # The reference's (32,224,224,3) ⊗ (1,224,1,3) suite shape, reduced
    # batch for CI speed.
    a = rng.normal(size=(2, 224, 224, 3)).astype(np.float32)
    b = rng.normal(size=(1, 224, 1, 3)).astype(np.float32)
    out = sm.Array(a) + sm.Array(b)
    np.testing.assert_allclose(out.numpy(), a + b, rtol=1e-6)


def test_unaligned_tail(rng):
    # Non-multiple-of-tile dims exercise boundary masking.
    a = rng.normal(size=(33, 257)).astype(np.float32)
    b = rng.normal(size=(33, 1)).astype(np.float32)
    out = sm.Array(a) - sm.Array(b)
    np.testing.assert_allclose(out.numpy(), a - b, rtol=1e-6)


def test_scalar_operand(rng):
    a = rng.normal(size=(40, 200)).astype(np.float32)
    out = sm.Array(a) * 2.5
    np.testing.assert_allclose(out.numpy(), a * 2.5, rtol=1e-6)


def test_int32(rng):
    a = rng.integers(-100, 100, size=(37, 129)).astype(np.int32)
    b = rng.integers(-100, 100, size=(37, 129)).astype(np.int32)
    out = sm.Array(a) * sm.Array(b)
    assert np.array_equal(out.numpy(), a * b)


def test_supported_gates():
    # Which iterated fuses the GPU kernel takes: dtypes, shapes, L > 1.
    gpu = dict(platform="gpu")
    assert platform.fuse_loop_route((4, 4), [(4, 4)], np.float32, 8, **gpu) == "triton"
    assert platform.fuse_loop_route((4,), [(4,)], np.float64, 8, **gpu) == "xla"
    assert platform.fuse_loop_route((4, 4), [(4, 4)], np.float32, 1, **gpu) == "xla"
    assert platform.fuse_loop_route((0, 4), [(0, 4)], np.float32, 8, **gpu) == "xla"
