"""Native integer compute paths:

* int32 1-D dot with i32 accumulation — exact, the analog of the
  reference's int32 SIMD dot (include/math/product.h:26-69);
* s8 x s8 -> s32 matmul (``sm.int8_matmul``, the int8 tensor cores on the
  H100) with symmetric quantize/dequantize helpers.
"""

import numpy as np
import pytest

import simplemath_tpu as sm
from simplemath_tpu.ops import dispatch


class TestInt32Dot:
    def test_exact_vs_numpy(self):
        rng = np.random.default_rng(0)
        a = rng.integers(-1000, 1000, 40_000).astype(np.int32)
        b = rng.integers(-1000, 1000, 40_000).astype(np.int32)
        dispatch.reset()
        got = int(sm.dot(sm.array(a), sm.array(b)))
        assert got == int((a.astype(np.int64) * b).sum())
        assert dispatch.count("dot1d") == 1

    def test_ragged(self):
        rng = np.random.default_rng(1)
        n = 4096 * 3 + 777
        a = rng.integers(-100, 100, n).astype(np.int32)
        b = rng.integers(-100, 100, n).astype(np.int32)
        got = int(sm.dot(sm.array(a), sm.array(b)))
        assert got == int((a.astype(np.int64) * b).sum())

    def test_wraparound_semantics(self):
        # i32 accumulation wraps mod 2^32 exactly like the reference's
        # int32 SIMD accumulator (product.h:26-69).
        a = np.full(70_000, 40_000, np.int32)
        b = np.full(70_000, 40_000, np.int32)
        got = int(sm.dot(sm.array(a), sm.array(b)))
        want = (np.int64(40_000) * 40_000 * 70_000) % (1 << 32)
        if want >= 1 << 31:
            want -= 1 << 32
        assert got == int(want)

    def test_operator_form(self):
        rng = np.random.default_rng(2)
        a = rng.integers(-50, 50, 8192).astype(np.int32)
        b = rng.integers(-50, 50, 8192).astype(np.int32)
        got = int(np.asarray((sm.array(a) @ sm.array(b)).jax()))
        assert got == int((a.astype(np.int64) * b).sum())

    def test_dtype_is_int32(self):
        a = np.arange(4096, dtype=np.int32)
        out = sm.dot(sm.array(a), sm.array(a))
        assert np.asarray(out.jax()).dtype == np.int32


class TestInt8Matmul:
    def test_exact_vs_numpy(self):
        rng = np.random.default_rng(0)
        A = rng.integers(-127, 128, (300, 384)).astype(np.int8)
        B = rng.integers(-127, 128, (384, 515)).astype(np.int8)
        dispatch.reset()
        got = np.asarray(sm.int8_matmul(A, B))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, A.astype(np.int32) @ B.astype(np.int32))
        assert dispatch.count("matmul", "int8") == 1

    def test_batched(self):
        rng = np.random.default_rng(1)
        A = rng.integers(-127, 128, (4, 256, 256)).astype(np.int8)
        B = rng.integers(-127, 128, (4, 256, 256)).astype(np.int8)
        got = np.asarray(sm.int8_matmul(A, B))
        np.testing.assert_array_equal(
            got, A.astype(np.int32) @ B.astype(np.int32)
        )

    def test_small_fallback_exact(self):
        rng = np.random.default_rng(2)
        A = rng.integers(-127, 128, (16, 24)).astype(np.int8)
        B = rng.integers(-127, 128, (24, 32)).astype(np.int8)
        got = np.asarray(sm.int8_matmul(A, B))
        np.testing.assert_array_equal(got, A.astype(np.int32) @ B.astype(np.int32))

    def test_uint8_exact_via_fallback(self):
        # uint8 operands are read unsigned: exact against int64 NumPy.
        rng = np.random.default_rng(4)
        A = rng.integers(0, 256, (300, 384)).astype(np.uint8)
        B = rng.integers(0, 256, (384, 300)).astype(np.uint8)
        got = np.asarray(sm.int8_matmul(A, B))
        want = (A.astype(np.int64) @ B.astype(np.int64)).astype(np.int32)
        np.testing.assert_array_equal(got, want)

    def test_rejects_non_int8(self):
        with pytest.raises(TypeError, match="int8"):
            sm.int8_matmul(
                np.ones((4, 4), np.float32), np.ones((4, 4), np.int8)
            )


class TestQuantize:
    def test_round_trip(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((64, 64)).astype(np.float32)
        q, s = sm.quantize(x)
        xq = np.asarray(sm.dequantize(q, s))
        # symmetric per-tensor int8: error bounded by scale/2 per element
        assert np.abs(xq - x).max() <= float(np.asarray(s)) * 0.5 + 1e-7

    def test_quantized_matmul_accuracy(self):
        rng = np.random.default_rng(1)
        X = rng.standard_normal((300, 384)).astype(np.float32)
        W = rng.standard_normal((384, 300)).astype(np.float32)
        qx, sx = sm.quantize(X)
        qw, sw = sm.quantize(W)
        prod = sm.int8_matmul(qx, qw)
        got = np.asarray(
            sm.dequantize(prod, np.float32(np.asarray(sx) * np.asarray(sw)))
        )
        want = X @ W
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < 0.02, rel

    def test_fused_dequant_epilogue(self):
        # scale= dequantizes the i32 product to f32 in the same program
        # (XLA fuses the scale into the GEMM's output under jit).
        rng = np.random.default_rng(2)
        X = rng.standard_normal((300, 384)).astype(np.float32)
        W = rng.standard_normal((384, 300)).astype(np.float32)
        qx, sx = sm.quantize(X)
        qw, sw = sm.quantize(W)
        s = np.float32(np.asarray(sx) * np.asarray(sw))
        dispatch.reset()
        got = np.asarray(sm.int8_matmul(qx, qw, scale=s))
        assert got.dtype == np.float32
        want = (
            np.asarray(qx).astype(np.int32) @ np.asarray(qw).astype(np.int32)
        ).astype(np.float32) * s
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert dispatch.count("matmul", "int8") == 1

    def test_fused_dequant_small_fallback(self):
        rng = np.random.default_rng(3)
        A = rng.integers(-127, 128, (16, 24)).astype(np.int8)
        B = rng.integers(-127, 128, (24, 32)).astype(np.int8)
        got = np.asarray(sm.int8_matmul(A, B, scale=0.25))
        want = (A.astype(np.int32) @ B.astype(np.int32)).astype(np.float32) * 0.25
        np.testing.assert_allclose(got, want, rtol=1e-6)

    def test_zero_input(self):
        q, s = sm.quantize(np.zeros((8, 8), np.float32))
        assert np.all(np.asarray(q) == 0)
        got = np.asarray(sm.dequantize(q, s))
        assert np.all(got == 0)

    def test_explicit_scale(self):
        x = np.array([[1.0, -2.0, 0.5]], np.float32)
        q, s = sm.quantize(x, scale=0.5)
        np.testing.assert_array_equal(np.asarray(q), [[2, -4, 1]])


class TestPerChannelQuantization:
    def test_per_channel_weight_scales(self):
        rng = np.random.default_rng(0)
        # weight columns with wildly different magnitudes: per-tensor
        # quantization destroys the small channels, per-channel keeps them
        W = rng.standard_normal((384, 300)).astype(np.float32)
        W[:, ::2] *= 50.0
        X = rng.standard_normal((300, 384)).astype(np.float32)
        qx, sx = sm.quantize(X)
        qw, sw = sm.quantize(W, axis=0)  # (1, 300) per-output-channel
        assert np.asarray(sw).shape == (1, 300)
        got = np.asarray(
            sm.int8_matmul(qx, qw, scale=np.asarray(sx) * np.asarray(sw))
        )
        want = X @ W
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < 0.02, rel
        # per-tensor on the same skewed weight is measurably worse on the
        # small channels
        qw_t, sw_t = sm.quantize(W)
        got_t = np.asarray(
            sm.int8_matmul(qx, qw_t, scale=float(np.asarray(sx) * np.asarray(sw_t)))
        )
        small = want[:, 1::2]
        err_pc = np.abs(got[:, 1::2] - small).max()
        err_pt = np.abs(got_t[:, 1::2] - small).max()
        assert err_pc < err_pt, (err_pc, err_pt)

    def test_vector_scale_shapes(self):
        rng = np.random.default_rng(1)
        A = rng.integers(-127, 128, (300, 384)).astype(np.int8)
        B = rng.integers(-127, 128, (384, 300)).astype(np.int8)
        s = np.linspace(0.5, 1.5, 300).astype(np.float32)  # (N,)
        got = np.asarray(sm.int8_matmul(A, B, scale=s))
        want = (
            A.astype(np.int32) @ B.astype(np.int32)
        ).astype(np.float32) * s[None, :]
        np.testing.assert_allclose(got, want, rtol=1e-6)
