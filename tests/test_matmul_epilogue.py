"""Fused matmul epilogues: ``sm.fuse(lambda x, W, b: relu(x @ W + b))``
runs the product and its elementwise tail as one program, which XLA fuses
into the GEMM's output (ops/fusion.py::matmul_node).  Reference analog: the
per-op extension story (README.md:86-133) composed with the reduction
engine (product.h:8-224).
"""

import numpy as np
import pytest

import simplemath_tpu as sm
from simplemath_tpu.ops import dispatch


def _mk(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _trunc_oracle_prod(X, W):
    """The f32 product these tests check on the CPU, where large f32
    contractions are exact (on the H100 they run in TF32; chip_smoke.py
    checks that contract)."""
    return X @ W


class TestEpilogueKernel:
    def test_relu_bias_single_launch(self):
        X, W, b = _mk((300, 270)), _mk((270, 515), 1), _mk((1, 515), 2)
        f = sm.fuse(lambda x, w, bias: sm.maximum(x @ w + bias, 0.0))
        dispatch.reset()
        got = np.asarray(f(X, W, b))
        want = np.maximum(_trunc_oracle_prod(X, W) + b, 0.0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        counts = dispatch.counts()
        assert counts.get("matmul:mm_epilogue") == 1
        # the epilogue never dispatched a separate elementwise program
        assert not any(k.startswith("elementwise") for k in counts)

    def test_column_and_scalar_extras(self):
        X, W, c = _mk((256, 384)), _mk((384, 512), 1), _mk((256, 1), 2)
        f = sm.fuse(lambda x, w, col: sm.tanh((x @ w) * col + 0.5))
        got = np.asarray(f(X, W, c))
        want = np.tanh(_trunc_oracle_prod(X, W) * c + 0.5)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)

    def test_full_mn_extra(self):
        X, W, Y = _mk((256, 256)), _mk((256, 384), 1), _mk((256, 384), 2)
        f = sm.fuse(lambda x, w, y: sm.square(x @ w - y))
        got = np.asarray(f(X, W, Y))
        want = (_trunc_oracle_prod(X, W) - Y) ** 2
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)

    def test_matmul_only_root(self):
        X, W = _mk((256, 300)), _mk((300, 256), 1)
        f = sm.fuse(lambda x, w: x @ w)
        got = np.asarray(f(X, W))
        np.testing.assert_allclose(
            got, _trunc_oracle_prod(X, W), rtol=1e-5, atol=1e-4
        )

    def test_bf16(self):
        import jax.numpy as jnp

        X, W = _mk((256, 256)), _mk((256, 256), 1)
        Xb, Wb = jnp.asarray(X).astype(jnp.bfloat16), jnp.asarray(W).astype(
            jnp.bfloat16
        )
        f = sm.fuse(lambda x, w: sm.abs(x @ w))
        got = np.asarray(f(Xb, Wb)).astype(np.float32)
        want = np.abs(
            np.asarray(Xb, dtype=np.float32) @ np.asarray(Wb, dtype=np.float32)
        )
        assert np.abs(got - want).max() / np.abs(want).max() < 2e-2

    def test_sm_matmul_free_function(self):
        X, W = _mk((256, 256)), _mk((256, 256), 1)
        f = sm.fuse(lambda x, w: sm.maximum(sm.matmul(x, w), 0.0))
        got = np.asarray(f(X, W))
        want = np.maximum(_trunc_oracle_prod(X, W), 0.0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


class TestEpilogueFallback:
    def test_small_shapes_fall_back(self):
        X, W = _mk((32, 16)), _mk((16, 48), 1)
        f = sm.fuse(lambda x, w: sm.square(x @ w))
        dispatch.reset()
        got = np.asarray(f(X, W))
        np.testing.assert_allclose(got, (X @ W) ** 2, rtol=1e-5, atol=1e-4)
        # Small shapes take the same one-program epilogue path.
        assert dispatch.counts().get("matmul:mm_epilogue") == 1

    def test_f64_falls_back(self):
        X = _mk((300, 300)).astype(np.float64)
        W = _mk((300, 300), 1).astype(np.float64)
        f = sm.fuse(lambda x, w: sm.abs(x @ w))
        dispatch.reset()
        got = np.asarray(f(X, W))
        # f64 stays f64 end to end.
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, np.abs(X @ W), rtol=1e-10, atol=1e-4)
        assert dispatch.counts().get("matmul:mm_epilogue") == 1

    def test_rank1_extra_broadcast(self):
        # A 1-D (N,) bias broadcasts over the rows.
        X, W, b = _mk((256, 256)), _mk((256, 384), 1), _mk((384,), 2)
        f = sm.fuse(lambda x, w, bias: x @ w + bias)
        got = np.asarray(f(X, W, b))
        want = _trunc_oracle_prod(X, W) + b
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


class TestEpilogueErrors:
    def test_composed_operand_rejected(self):
        f = sm.fuse(lambda x, w: (x + 1.0) @ w)
        with pytest.raises(TypeError, match="direct arguments"):
            f(_mk((256, 256)), _mk((256, 256), 1))

    def test_two_matmuls_rejected(self):
        f = sm.fuse(lambda x, w, v: (x @ w) + (x @ v))
        with pytest.raises(TypeError, match="at most one matmul"):
            f(_mk((256, 256)), _mk((256, 256), 1), _mk((256, 256), 2))

    def test_operand_reuse_rejected(self):
        f = sm.fuse(lambda x, w: (x @ w) + x)
        with pytest.raises(TypeError):
            f(_mk((256, 256)), _mk((256, 256), 1))

    def test_reduction_over_matmul_rejected(self):
        f = sm.fuse(lambda x, w: sm.sum(x @ w))
        with pytest.raises(TypeError, match="reduction over a fused matmul"):
            f(_mk((256, 256)), _mk((256, 256), 1))

    def test_rank4_rejected(self):
        f = sm.fuse(lambda x, w: x @ w)
        with pytest.raises(TypeError, match="2-D"):
            f(_mk((2, 2, 64, 64)), _mk((2, 2, 64, 64), 1))

    def test_shape_mismatch_rejected(self):
        f = sm.fuse(lambda x, w: x @ w)
        with pytest.raises(TypeError, match="2-D"):
            f(_mk((64, 32)), _mk((48, 64), 1))

    def test_batch_mismatch_rejected(self):
        f = sm.fuse(lambda x, w: x @ w)
        with pytest.raises(TypeError, match="batched"):
            f(_mk((2, 64, 64)), _mk((3, 64, 64), 1))


class TestBatchedEpilogue:
    """Rank-3 fused matmul epilogues — the solver layer's (B, n, m) shape."""

    def test_relu_bias_batched(self):
        X = _mk((3, 256, 300))
        W = _mk((3, 300, 260), 1)
        b = _mk((1, 1, 260), 2)
        f = sm.fuse(lambda x, w, bias: sm.maximum(x @ w + bias, 0.0))
        dispatch.reset()
        got = np.asarray(f(X, W, b))
        want = np.maximum(np.matmul(X, W) + b, 0.0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
        assert dispatch.counts().get("matmul:bmm_epilogue") == 1

    def test_per_batch_scale_extra(self):
        X = _mk((2, 256, 256))
        W = _mk((2, 256, 256), 1)
        s = _mk((2, 1, 1), 2)
        f = sm.fuse(lambda x, w, sc: (x @ w) * sc)
        got = np.asarray(f(X, W, s))
        want = np.matmul(X, W) * s
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)

    def test_batched_int8_fused_dequant(self):
        rng = np.random.default_rng(0)
        A = rng.integers(-127, 128, (2, 256, 256)).astype(np.int8)
        B = rng.integers(-127, 128, (2, 256, 256)).astype(np.int8)
        got = np.asarray(sm.int8_matmul(A, B, scale=0.5))
        want = (
            np.matmul(A.astype(np.int32), B.astype(np.int32))
        ).astype(np.float32) * 0.5
        np.testing.assert_allclose(got, want, rtol=1e-6)
