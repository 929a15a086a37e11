"""Complex dtype support (reference product.h:168-224 supports
complex<double> dot) and debug utilities."""

import jax.numpy as jnp
import numpy as np
import pytest

import simplemath_tpu as sm
from simplemath_tpu.utils import debug


def test_complex_array_ops():
    a = np.array([1 + 2j, 3 - 1j], dtype=np.complex128)
    b = np.array([2 - 1j, 1 + 1j], dtype=np.complex128)
    out = sm.Array(a) * sm.Array(b)
    np.testing.assert_allclose(np.asarray(out.jax()), a * b)
    out2 = sm.Array(a) + sm.Array(b)
    np.testing.assert_allclose(np.asarray(out2.jax()), a + b)


def test_complex_dot():
    # product.h:168-224: complex<double> dot with real/imag lane splitting;
    # here one dot_general call.
    a = np.array([1 + 2j, 3 - 1j, 0.5j], dtype=np.complex128)
    b = np.array([2 - 1j, 1 + 1j, -1.0], dtype=np.complex128)
    out = sm.Array(a) @ sm.Array(b)
    np.testing.assert_allclose(np.asarray(out.jax()), np.dot(a, b))


def test_complex64_elementwise_any_backend(rng):
    a = (rng.normal(size=(8, 16)) + 1j * rng.normal(size=(8, 16))).astype(
        np.complex64
    )
    b = (rng.normal(size=(8, 16)) + 1j * rng.normal(size=(8, 16))).astype(
        np.complex64
    )
    np.testing.assert_allclose(
        np.asarray((sm.Array(a) * sm.Array(b)).jax()), a * b, rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray((sm.Array(a) + sm.Array(b)).jax()), a + b, rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray((sm.Array(a) - sm.Array(b)).jax()), a - b, rtol=1e-5
    )


def test_complex64_dot_any_backend(rng):
    a = (rng.normal(size=(33,)) + 1j * rng.normal(size=(33,))).astype(np.complex64)
    b = (rng.normal(size=(33,)) + 1j * rng.normal(size=(33,))).astype(np.complex64)
    out = sm.Array(a) @ sm.Array(b)
    np.testing.assert_allclose(
        np.asarray(out.jax()), np.dot(a, b), rtol=1e-5, atol=1e-5
    )


def test_complex64_matmul_public_path(rng):
    # c64 contractions through the public API at every rank: 2-D matmul,
    # 1-D dot, batched rank-3 matmul (numpy.matmul semantics).
    def c64(*shape):
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
            np.complex64
        )

    a, b = c64(24, 48), c64(48, 16)
    np.testing.assert_allclose(
        np.asarray(sm.matmul(sm.Array(a), sm.Array(b)).jax()), a @ b,
        rtol=2e-4, atol=2e-4,
    )
    v, w = c64(129), c64(129)
    np.testing.assert_allclose(
        np.asarray(sm.dot(sm.Array(v), sm.Array(w)).jax()), np.dot(v, w),
        rtol=1e-4, atol=1e-4,
    )
    ab, bb = c64(4, 8, 8), c64(4, 8, 8)
    out = sm.matmul(sm.Array(ab), sm.Array(bb))
    assert out.dtype == np.complex64
    np.testing.assert_allclose(np.asarray(out.jax()), ab @ bb, rtol=2e-4, atol=2e-4)


def test_complex64_dominated_component_accuracy(rng):
    # A dominated imaginary part (|bi| << |br|) keeps its RELATIVE
    # accuracy through the public c64 matmul, as the reference's
    # four-product form (product.h:168-224) does — no Gauss-style
    # cancellation of two large terms.
    ar = rng.normal(size=(32, 64)).astype(np.float32)
    br = rng.normal(size=(64, 32)).astype(np.float32)
    bi = (1e-6 * rng.normal(size=(64, 32))).astype(np.float32)
    a = ar.astype(np.complex64)
    b = (br + 1j * bi).astype(np.complex64)

    want = a.astype(np.complex128) @ b.astype(np.complex128)
    out = np.asarray(sm.matmul(sm.Array(a), sm.Array(b)).jax())
    im_rel = np.abs(out.imag - want.imag).max() / np.abs(want.imag).max()
    assert im_rel < 1e-3, im_rel


def test_assert_tree_finite():
    debug.assert_tree_finite({"x": jnp.ones(3)})
    with pytest.raises(FloatingPointError, match="non-finite"):
        debug.assert_tree_finite({"x": jnp.asarray([1.0, np.nan])})


def test_tree_norm():
    n = debug.tree_norm({"a": jnp.ones(4), "b": jnp.ones(4) * 2})
    np.testing.assert_allclose(n, np.sqrt(4 + 16), rtol=1e-6)


def test_nan_guard():
    safe = debug.nan_guard(lambda x: x * 2)
    np.testing.assert_allclose(np.asarray(safe(jnp.ones(3))), 2 * np.ones(3))
    bad = debug.nan_guard(lambda x: x / 0.0)
    with pytest.raises(Exception):
        bad(jnp.ones(3))


def test_debug_checks_guard_no_pivot_inverse():
    """config.debug_checks surfaces singular/indefinite inputs to the
    no-pivot inverses as checkify errors (round-1 VERDICT item 10)."""
    from jax.experimental import checkify

    from simplemath_tpu.config import config
    from simplemath_tpu.ops import soa
    from simplemath_tpu.ops.linalg_small import inv_unrolled

    singular = jnp.asarray(
        [[1.0, 2.0, 3.0], [2.0, 4.0, 6.0], [0.0, 0.0, 1.0]], jnp.float32
    )
    old = config.debug_checks
    config.debug_checks = True
    try:
        err, _ = checkify.checkify(inv_unrolled)(singular)
        with pytest.raises(Exception, match="diagonally-dominant"):
            err.throw()
        err2, _ = checkify.checkify(soa.inv)(singular[..., None])
        with pytest.raises(Exception, match="diagonally-dominant"):
            err2.throw()
        # Well-conditioned inputs pass clean.
        ok = jnp.eye(3, dtype=jnp.float32) * 2.0
        err3, out = checkify.checkify(inv_unrolled)(ok)
        err3.throw()
        np.testing.assert_allclose(np.asarray(out), np.eye(3) / 2.0, rtol=1e-6)
    finally:
        config.debug_checks = old


def test_ilqr_psd_none_indefinite_quu_recovers():
    """psd="none" with a nonconvex (indefinite-luu) cost: the no-pivot
    Riccati solves go non-finite, the NaN-robust accept rejects every such
    candidate, and the solve still returns a finite result (the documented
    recovery path for the no-pivot contract)."""
    import dataclasses as _dc

    from simplemath_tpu.models import make_pendulum
    from simplemath_tpu.models.ilqr import ILQRConfig, solve

    base = make_pendulum()
    # Concave-in-u stage cost => luu = -1 (indefinite) at every step.
    system = _dc.replace(
        base,
        stage_cost=lambda x, u: 0.5 * ((x[0] - np.pi) ** 2 - u[0] ** 2),
        separable_cost=False,
    )
    x0 = jnp.asarray([0.3, 0.0], jnp.float32)
    us = jnp.zeros((20, 1), jnp.float32)
    res = solve(system, x0, us, ILQRConfig(iterations=4, psd="none"))
    assert np.isfinite(float(res.cost))
    assert np.all(np.isfinite(np.asarray(res.us)))
