"""Dot product — reference operator% / include/math/product.h:8-224.

The reference supports int32/float/double/complex<double> flat dot products;
here numpy.dot semantics over any rank, honoring views (fixing SURVEY
§2.4-3), lowered through dot_general."""

import numpy as np
import pytest

import simplemath_tpu as sm


@pytest.mark.parametrize(
    "dtype", [np.int32, np.float32, np.float64, np.complex128]
)
def test_dot_1d(dtype):
    # product.h per-dtype kernels: int32 (:26-69), float (:74-116), double
    # (:121-163), complex<double> (:168-224).
    a = np.arange(1, 9).astype(dtype)
    b = (np.arange(1, 9)[::-1]).astype(dtype)
    if dtype == np.complex128:
        a = a + 1j * np.arange(8)
        b = b - 1j * np.arange(8)
    out = sm.Array(a).dot(sm.Array(b))
    expected = np.dot(a, b)
    np.testing.assert_allclose(np.asarray(out.jax()), expected, rtol=1e-6)


def test_dot_operator_matmul():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.arange(12, dtype=np.float32).reshape(3, 4)
    out = sm.Array(a) @ sm.Array(b)
    np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-6)


def test_dot_respects_views():
    # The reference uses the rhs totalSize on flat buffers (SMArray.h:213-215)
    # so views give wrong results; fixed here.
    base = np.arange(16, dtype=np.float32).reshape(4, 4)
    a = sm.Array(base)
    v = a.T[1:3]
    w = a[:, 1:3]
    out = v @ w
    np.testing.assert_allclose(out.numpy(), base.T[1:3] @ base[:, 1:3], rtol=1e-6)


def test_dot_large_float(rng):
    a = rng.normal(size=(512,)).astype(np.float32)
    b = rng.normal(size=(512,)).astype(np.float32)
    out = sm.Array(a) @ sm.Array(b)
    np.testing.assert_allclose(float(out.jax()), np.dot(a, b), rtol=1e-4)
