"""Axis reductions through the Array methods and as sm.fuse /
deferred-eager roots.

The reference's reduction engine is its flagship op
(include/math/product.h:8-224, full-array only); NumPy semantics add the
axis argument.
"""

import zlib

import numpy as np
import pytest

import simplemath_tpu as sm
from simplemath_tpu.ops import dispatch


NP_FNS = {"sum": np.sum, "max": np.max, "min": np.min, "mean": np.mean}


class TestArrayAxisReduce:
    @pytest.mark.parametrize(
        "shape", [(300, 257), (8, 2048), (2048, 8), (513, 129), (7, 5), (1, 64)]
    )
    @pytest.mark.parametrize("axis", [0, 1, -1, -2])
    @pytest.mark.parametrize("kind", ["sum", "max", "min", "mean"])
    def test_oracle(self, shape, axis, kind):
        rng = np.random.default_rng(zlib.crc32(repr((shape, axis, kind)).encode()))
        A = rng.standard_normal(shape).astype(np.float32)
        got = np.asarray(getattr(sm.array(A), kind)(axis=axis))
        # float64 oracle: NumPy's own f32 strided axis sum is the less
        # accurate of the two.
        want = NP_FNS[kind](A.astype(np.float64), axis=axis)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    def test_kernel_dispatched(self):
        A = np.random.default_rng(0).standard_normal((256, 300)).astype(np.float32)
        dispatch.reset()
        sm.array(A).sum(axis=0)
        assert dispatch.count("reduce_axis", "sum0") == 1

    @pytest.mark.parametrize("axis", [0, 1])
    def test_keepdims(self, axis):
        A = np.random.default_rng(1).standard_normal((65, 33)).astype(np.float32)
        got = np.asarray(sm.array(A).sum(axis=axis, keepdims=True))
        want = A.sum(axis=axis, keepdims=True)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    def test_free_function_same_path(self):
        A = np.random.default_rng(2).standard_normal((64, 80)).astype(np.float32)
        got = np.asarray(sm.sum(sm.array(A), axis=1))
        np.testing.assert_allclose(got, A.sum(axis=1), rtol=2e-5, atol=2e-5)

    def test_bf16(self):
        A = np.random.default_rng(3).standard_normal((64, 256)).astype(np.float32)
        a = sm.array(A, dtype="bfloat16")
        got = np.asarray(a.sum(axis=0)).astype(np.float32)
        # bf16 inputs, result in bf16.
        want = np.asarray(
            A.astype(np.float32).sum(axis=0)
        )
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-1)

    def test_int_falls_back(self):
        A = np.arange(12, dtype=np.int32).reshape(3, 4)
        got = np.asarray(sm.array(A).sum(axis=0))
        np.testing.assert_array_equal(got, A.sum(axis=0))

    def test_rank3_falls_back(self):
        A = np.random.default_rng(4).standard_normal((4, 5, 6)).astype(np.float32)
        got = np.asarray(sm.array(A).sum(axis=1))
        np.testing.assert_allclose(got, A.sum(axis=1), rtol=2e-5, atol=2e-5)

    def test_axis_tuple_falls_back(self):
        A = np.random.default_rng(5).standard_normal((4, 5)).astype(np.float32)
        got = np.asarray(sm.array(A).sum(axis=(0, 1)))
        np.testing.assert_allclose(got, A.sum(), rtol=2e-5, atol=2e-5)


class TestFusedAxisReduce:
    def test_sum_axis1(self):
        rng = np.random.default_rng(0)
        A = rng.standard_normal((500, 300)).astype(np.float32)
        B = rng.standard_normal((500, 300)).astype(np.float32)
        f = sm.fuse(lambda x, y: sm.sum(sm.square(x - y), axis=1))
        dispatch.reset()
        got = np.asarray(f(A, B))
        np.testing.assert_allclose(
            got, ((A - B) ** 2).sum(axis=1), rtol=2e-5, atol=2e-4
        )
        assert dispatch.count("reduce_axis", "sum1") == 1

    def test_mean_axis0(self):
        rng = np.random.default_rng(1)
        A = rng.standard_normal((128, 96)).astype(np.float32)
        f = sm.fuse(lambda x: sm.mean(sm.abs(x), axis=0))
        got = np.asarray(f(A))
        np.testing.assert_allclose(got, np.abs(A).mean(axis=0), rtol=2e-5, atol=2e-5)

    def test_broadcast_row_operand(self):
        rng = np.random.default_rng(2)
        A = rng.standard_normal((200, 160)).astype(np.float32)
        r = rng.standard_normal((1, 160)).astype(np.float32)
        f = sm.fuse(lambda x, w: sm.max(x * w, axis=0))
        got = np.asarray(f(A, r))
        np.testing.assert_allclose(got, (A * r).max(axis=0), rtol=2e-5, atol=2e-5)

    def test_broadcast_col_operand(self):
        rng = np.random.default_rng(3)
        A = rng.standard_normal((200, 160)).astype(np.float32)
        c = rng.standard_normal((200, 1)).astype(np.float32)
        f = sm.fuse(lambda x, w: sm.sum(x * w, axis=1))
        got = np.asarray(f(A, c))
        np.testing.assert_allclose(got, (A * c).sum(axis=1), rtol=2e-5, atol=2e-4)

    def test_keepdims(self):
        A = np.random.default_rng(4).standard_normal((64, 48)).astype(np.float32)
        f = sm.fuse(lambda x: sm.sum(sm.square(x), axis=1, keepdims=True))
        got = np.asarray(f(A))
        want = (A ** 2).sum(axis=1, keepdims=True)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)

    def test_negative_axis(self):
        A = np.random.default_rng(5).standard_normal((64, 48)).astype(np.float32)
        f = sm.fuse(lambda x: sm.sum(x, axis=-1))
        got = np.asarray(f(A))
        np.testing.assert_allclose(got, A.sum(axis=-1), rtol=2e-5, atol=2e-4)

    def test_axis_tuple_rejected(self):
        f = sm.fuse(lambda x: sm.sum(x, axis=(0, 1)))
        with pytest.raises(TypeError, match="single int axis"):
            f(np.ones((4, 4), np.float32))

    def test_compose_after_reduction_rejected(self):
        f = sm.fuse(lambda x: sm.sum(x, axis=0) + 1.0)
        with pytest.raises(TypeError, match="cannot be composed"):
            f(np.ones((4, 4), np.float32))

    def test_rank1_axis0(self):
        A = np.random.default_rng(6).standard_normal(512).astype(np.float32)
        f = sm.fuse(lambda x: sm.sum(sm.square(x), axis=0))
        got = float(np.asarray(f(A)))
        np.testing.assert_allclose(got, (A ** 2).sum(), rtol=2e-5)


class TestLazyChainAxisReduce:
    def test_chain_then_axis_sum(self):
        rng = np.random.default_rng(0)
        A = rng.standard_normal((300, 200)).astype(np.float32)
        B = rng.standard_normal((300, 200)).astype(np.float32)
        x, y = sm.array(A), sm.array(B)
        got = np.asarray(((x - y) * 2.0).sum(axis=0))
        np.testing.assert_allclose(
            got, ((A - B) * 2.0).sum(axis=0), rtol=2e-5, atol=2e-4
        )

    def test_chain_then_axis_mean_keepdims(self):
        rng = np.random.default_rng(1)
        A = rng.standard_normal((128, 64)).astype(np.float32)
        x = sm.array(A)
        got = np.asarray((x * x).mean(axis=1, keepdims=True))
        np.testing.assert_allclose(
            got, (A * A).mean(axis=1, keepdims=True), rtol=2e-5, atol=2e-4
        )


class TestMapReduce2D:
    """Full reductions of 2-D chains, with full, row and scalar operands."""

    def test_2d_operands_full_reduce(self):
        rng = np.random.default_rng(0)
        A = rng.standard_normal((500, 300)).astype(np.float32)
        B = rng.standard_normal((500, 300)).astype(np.float32)
        f = sm.fuse(lambda x, y: sm.sum(sm.square(x - y)))
        got = float(np.asarray(f(A, B)))
        np.testing.assert_allclose(got, ((A - B) ** 2).sum(), rtol=1e-4)

    def test_2d_broadcast_row(self):
        rng = np.random.default_rng(1)
        A = rng.standard_normal((256, 128)).astype(np.float32)
        r = rng.standard_normal((1, 128)).astype(np.float32)
        f = sm.fuse(lambda x, w: sm.sum(x * w))
        got = float(np.asarray(f(A, r)))
        np.testing.assert_allclose(got, (A * r).sum(), rtol=1e-4)

    def test_2d_scalar_operand(self):
        A = np.random.default_rng(2).standard_normal((64, 96)).astype(np.float32)
        s = np.float32(1.5)
        f = sm.fuse(lambda x, w: sm.max(x * w))
        got = float(np.asarray(f(A, np.asarray(s).reshape(1, 1))))
        np.testing.assert_allclose(got, (A * s).max(), rtol=1e-5)
