"""View operands (transposes, slices, collapses) through the public ops.

The reference's engine reads strided/transposed views directly in its hot
loop (include/math/calculate.h:16-99; transpose views SMArray.h:121-136).
Here a view operand joins the deferred-eager queue like any other operand
and XLA fuses its slice/transpose into the consumer; these tests pin that
each op still dispatches one program and agrees with the NumPy oracle.
"""

import numpy as np
import pytest

import simplemath_tpu as sm
from simplemath_tpu.ops import dispatch


def _mk(shape, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(np.dtype(dtype), np.integer):
        return rng.integers(-50, 50, size=shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


def _assert_view_kernel(fn, oracle, uses_plan=True):
    dispatch.reset()
    got = np.asarray(fn())
    np.testing.assert_allclose(got, oracle, rtol=1e-6, atol=1e-6)
    if uses_plan:
        programs = [k for k in dispatch.counts() if k.startswith("elementwise:")]
        assert len(programs) == 1, f"expected one program; got {dispatch.counts()}"


class TestViewKernelOracle:
    """Public-API view operands vs NumPy."""

    def test_transpose_add(self):
        A, B = _mk((300, 200)), _mk((200, 300), seed=1)
        _assert_view_kernel(
            lambda: sm.add(sm.array(A).T, sm.array(B)), A.T + B
        )

    def test_transpose_both_operands(self):
        A, B = _mk((300, 200)), _mk((300, 200), seed=1)
        _assert_view_kernel(
            lambda: sm.add(sm.array(A).T, sm.array(B).T), A.T + B.T
        )

    def test_truncating_slab(self):
        A = _mk((300, 256))
        B = _mk((200, 128), seed=1)
        _assert_view_kernel(
            lambda: sm.add(sm.array(A)[:200, :128], sm.array(B)),
            A[:200, :128] + B,
        )

    def test_stepped_leading_3d(self):
        D = _mk((16, 64, 128))
        Z = np.zeros((4, 64, 128), np.float32)
        _assert_view_kernel(
            lambda: sm.add(sm.array(D)[1:9:2], sm.array(Z)), D[1:9:2]
        )

    def test_negative_step_leading(self):
        D = _mk((16, 64, 128))
        Z = np.zeros_like(D)
        _assert_view_kernel(
            lambda: sm.add(sm.array(D)[::-1], sm.array(Z)), D[::-1]
        )

    def test_collapsed_leading(self):
        D = _mk((16, 64, 128))
        Z = np.zeros((64, 128), np.float32)
        _assert_view_kernel(
            lambda: sm.add(sm.array(D)[5], sm.array(Z)), D[5]
        )

    def test_view_with_broadcast_row(self):
        A = _mk((300, 200))
        r = np.arange(300, dtype=np.float32).reshape(1, 300)
        _assert_view_kernel(
            lambda: sm.add(sm.array(A).T, sm.array(r)), A.T + r
        )

    def test_unary_on_view(self):
        A = _mk((300, 200))
        dispatch.reset()
        got = np.asarray(sm.square(sm.array(A).T))
        np.testing.assert_allclose(got, A.T ** 2, rtol=1e-6)
        assert any(k.startswith("elementwise:") for k in dispatch.counts())

    def test_pow_on_view(self):
        A = _mk((200, 300))
        dispatch.reset()
        got = np.asarray(sm.pow(sm.array(A).T, 3))
        np.testing.assert_allclose(got, A.T ** 3, rtol=1e-5, atol=1e-5)
        assert any(k.startswith("elementwise:") for k in dispatch.counts())

    def test_int_pow_on_view(self):
        rng = np.random.default_rng(7)
        Ai = rng.integers(-5, 6, (200, 300)).astype(np.int32)
        e = np.full((300, 200), 2, np.int32)
        dispatch.reset()
        got = np.asarray(sm.pow(sm.array(Ai).T, sm.array(e)))
        np.testing.assert_array_equal(
            got, (Ai.T.astype(np.int64) ** 2).astype(np.int32)
        )
        assert dispatch.count("elementwise", "ipow") == 1

    def test_transcendental_on_view(self):
        A = np.abs(_mk((300, 200))) + 0.5
        dispatch.reset()
        got = np.asarray(sm.log(sm.array(A).T))
        np.testing.assert_allclose(got, np.log(A.T), rtol=1e-5, atol=1e-6)
        assert any(k.startswith("elementwise:") for k in dispatch.counts())
        got = np.asarray(sm.tanh(sm.array(A)[:200, :128]))
        np.testing.assert_allclose(got, np.tanh(A[:200, :128]), rtol=1e-5,
                                   atol=1e-6)

    def test_ternary_on_view(self):
        A = _mk((300, 200))
        a = sm.array(A)
        got = np.asarray(sm.where(a.T > 0, a.T, -a.T))
        np.testing.assert_allclose(got, np.abs(A.T), rtol=1e-6)

    def test_int32_view(self):
        A = _mk((300, 200), np.int32)
        got = np.asarray(sm.add(sm.array(A).T, sm.array(A).T))
        np.testing.assert_array_equal(got, A.T * 2)

    def test_aliasing_semantics_preserved(self):
        # Writes through the parent remain visible to the in-kernel view.
        P = np.zeros((8, 256), np.float32)
        p = sm.array(P)
        v = p.T
        p[0, 5] = 7.0
        got = np.asarray(sm.add(v, sm.array(np.zeros((256, 8), np.float32))))
        want = np.asarray(p).T
        np.testing.assert_array_equal(got, want)

    def test_rank_promoting_view_broadcast(self):
        # A 2-D transpose view broadcasting into a 3-D output.
        A = _mk((40, 30))
        B = _mk((5, 30, 40), seed=1)
        _assert_view_kernel(
            lambda: sm.add(sm.array(A).T, sm.array(B)), A.T + B
        )

    def test_view_with_lower_rank_dense(self):
        C = _mk((8, 16, 24))
        r = _mk((16, 24), seed=1)
        got = np.asarray(sm.multiply(sm.array(C)[::2], sm.array(r)))
        np.testing.assert_allclose(got, C[::2] * r, rtol=1e-6)

    def test_ragged_transpose(self):
        A, B = _mk((2000, 1100)), _mk((1100, 2000), seed=1)
        _assert_view_kernel(
            lambda: sm.add(sm.array(A).T, sm.array(B)), A.T + B
        )


class TestFallbacks:
    """Views of every layout stay correct (trailing steps and offsets,
    rank-changing rows, general permutations)."""

    def test_stepped_trailing(self):
        A = _mk((64, 128))
        got = np.asarray(
            sm.add(sm.array(A)[:, ::2], sm.array(np.zeros((64, 64), np.float32)))
        )
        np.testing.assert_allclose(got, A[:, ::2])

    def test_offset_trailing(self):
        A = _mk((64, 256))
        got = np.asarray(
            sm.add(
                sm.array(A)[:, 7:135],
                sm.array(np.zeros((64, 128), np.float32)),
            )
        )
        np.testing.assert_allclose(got, A[:, 7:135])

    def test_row_view_1d(self):
        A = _mk((64, 128))
        got = np.asarray(
            sm.add(sm.array(A)[5], sm.array(np.zeros(128, np.float32)))
        )
        np.testing.assert_allclose(got, A[5])

    def test_general_perm_3d(self):
        D = _mk((8, 64, 128))
        got = np.asarray(
            sm.add(
                sm.array(D).transpose(2, 0, 1),
                sm.array(np.zeros((128, 8, 64), np.float32)),
            )
        )
        np.testing.assert_allclose(got, D.transpose(2, 0, 1))


class TestFusedViewOperands:
    """sm.fuse arguments that are views."""

    def test_fused_chain_on_transpose(self):
        A = _mk((200, 300))
        B = _mk((300, 200), seed=1)
        f = sm.fuse(lambda x, y: sm.exp(-sm.square(x - y)) * 0.5)
        dispatch.reset()
        got = np.asarray(f(sm.array(A).T, sm.array(B)))
        want = np.exp(-((A.T - B) ** 2)) * 0.5
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert dispatch.count("elementwise", "fused") == 1

    def test_fused_stepped_leading_view(self):
        D = _mk((16, 64, 128))
        Z = np.zeros((8, 64, 128), np.float32)
        f = sm.fuse(lambda x, y: sm.square(x + y))
        got = np.asarray(f(sm.array(D)[::2], Z))
        np.testing.assert_allclose(got, D[::2] ** 2, rtol=1e-6)

    def test_fused_reduction_with_view_falls_back(self):
        A = _mk((200, 300))
        B = _mk((300, 200), seed=1)
        g = sm.fuse(lambda x, y: sm.sum(sm.square(x - y)))
        got = float(np.asarray(g(sm.array(A).T, sm.array(B))))
        np.testing.assert_allclose(got, ((A.T - B) ** 2).sum(), rtol=1e-4)

    def test_fused_inexpressible_view_reads(self):
        A = _mk((64, 128))
        f = sm.fuse(lambda x, y: x * y)
        got = np.asarray(
            f(sm.array(A)[:, ::2], np.full((64, 64), 2.0, np.float32))
        )
        np.testing.assert_allclose(got, A[:, ::2] * 2.0, rtol=1e-6)

    def test_fused_view_cache_distinguishes_specs(self):
        # Same shapes/dtypes, different view specs -> same values.
        A = _mk((64, 64))
        f = sm.fuse(lambda x: sm.square(x))
        got_t = np.asarray(f(sm.array(A).T))
        got_d = np.asarray(f(sm.array(A.T)))
        np.testing.assert_allclose(got_t, got_d, rtol=1e-6)
        np.testing.assert_allclose(got_t, A.T ** 2, rtol=1e-6)


class TestTransposedViewDot:
    """2-D transpose views fold into dot_general dimension numbers, so
    a.T @ b costs no relayout copy (engine._dot_transposed_views)."""

    def test_lhs_transposed(self):
        A, B = _mk((300, 200)), _mk((300, 256), seed=1)
        got = np.asarray(sm.array(A).T @ sm.array(B))
        np.testing.assert_allclose(got, A.T @ B, rtol=1e-4, atol=1e-3)

    def test_rhs_transposed(self):
        A, B = _mk((200, 300)), _mk((256, 300), seed=1)
        got = np.asarray(sm.matmul(sm.array(A), sm.array(B).T))
        np.testing.assert_allclose(got, A @ B.T, rtol=1e-4, atol=1e-3)

    def test_both_transposed(self):
        A, B = _mk((300, 200)), _mk((256, 300), seed=1)
        got = np.asarray(sm.dot(sm.array(A).T, sm.array(B).T))
        np.testing.assert_allclose(got, A.T @ B.T, rtol=1e-4, atol=1e-3)

    def test_sliced_view_still_correct(self):
        A, B = _mk((300, 200)), _mk((100, 50), seed=1)
        got = np.asarray(sm.dot(sm.array(A)[:200, :100], sm.array(B)))
        np.testing.assert_allclose(
            got, A[:200, :100] @ B, rtol=1e-4, atol=1e-3
        )


class TestViewFuzzOracle:
    """Randomized view chains through binary ops vs NumPy."""

    @pytest.mark.parametrize("seed", range(20))
    def test_fuzz(self, seed):
        rng = np.random.default_rng(seed)
        nd = rng.integers(2, 4)
        shape = tuple(int(rng.integers(3, 40)) for _ in range(nd))
        A = rng.standard_normal(shape).astype(np.float32)
        a = sm.array(A)
        ref = A
        # random view chain: slices, transposes, collapses
        for _ in range(int(rng.integers(1, 3))):
            if a.ndim < 2:
                break
            choice = rng.integers(0, 3)
            if choice == 0:
                a, ref = a.T, ref.T
            elif choice == 1 and a.shape[0] > 2:
                s = slice(1, int(a.shape[0]) - 1)
                a, ref = a[s], ref[s]
            elif choice == 2 and a.ndim >= 3:
                i = int(rng.integers(0, a.shape[0]))
                a, ref = a[i], ref[i]
        B = rng.standard_normal(ref.shape).astype(np.float32)
        got = np.asarray(sm.multiply(a, sm.array(B)))
        np.testing.assert_allclose(got, ref * B, rtol=1e-6, atol=1e-6)
