"""NumPy-style free-function surface vs the NumPy oracle."""

import numpy as np

import simplemath_tpu as sm


def test_unary_functions(rng):
    x = rng.normal(size=(4, 5)).astype(np.float32)
    a = sm.Array(x)
    # These assert API surface (the accuracy contracts of the
    # transcendentals are pinned down in test_transcendental.py).
    np.testing.assert_allclose(sm.sin(a).numpy(), np.sin(x), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sm.cos(a).numpy(), np.cos(x), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sm.tanh(a).numpy(), np.tanh(x), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sm.abs(a).numpy(), np.abs(x), rtol=1e-6)
    np.testing.assert_allclose(sm.square(a).numpy(), x * x, rtol=1e-6)
    np.testing.assert_allclose(
        sm.sqrt(sm.abs(a)).numpy(), np.sqrt(np.abs(x)), rtol=1e-6
    )


def test_reductions(rng):
    x = rng.normal(size=(3, 7)).astype(np.float32)
    a = sm.Array(x)
    np.testing.assert_allclose(float(sm.sum(a).jax()), x.sum(), rtol=1e-5)
    np.testing.assert_allclose(
        sm.sum(a, axis=0).numpy(), x.sum(axis=0), rtol=1e-5
    )
    np.testing.assert_allclose(float(sm.mean(a).jax()), x.mean(), rtol=1e-5)
    assert float(sm.max(a).jax()) == x.max()
    assert float(sm.min(a).jax()) == x.min()
    assert int(sm.argmax(a).jax()) == x.argmax()


def test_shape_functions(rng):
    x = rng.normal(size=(2, 6)).astype(np.float32)
    a = sm.Array(x)
    assert sm.transpose(a).shape == (6, 2)
    assert sm.reshape(a, (3, 4)).shape == (3, 4)
    np.testing.assert_array_equal(
        sm.repeat(sm.Array([1, 2]), 2).numpy(), np.array([1, 1, 2, 2])
    )
    c = sm.concatenate([a, a], axis=0)
    assert c.shape == (4, 6)
    s = sm.stack([a, a])
    assert s.shape == (2, 2, 6)


def test_binary_functions(rng):
    x = rng.normal(size=(5,)).astype(np.float32)
    y = rng.normal(size=(5,)).astype(np.float32)
    a, b = sm.Array(x), sm.Array(y)
    np.testing.assert_allclose(sm.maximum(a, b).numpy(), np.maximum(x, y))
    np.testing.assert_allclose(sm.minimum(a, b).numpy(), np.minimum(x, y))
    np.testing.assert_allclose(
        sm.where(a > b, a, b).numpy(), np.where(x > y, x, y)
    )


def test_matmul_function(rng):
    x = rng.normal(size=(3, 4)).astype(np.float32)
    y = rng.normal(size=(4, 2)).astype(np.float32)
    np.testing.assert_allclose(
        sm.matmul(sm.Array(x), sm.Array(y)).numpy(), x @ y, rtol=1e-5
    )


def test_allclose_helper():
    assert sm.allclose(sm.Array([1.0, 2.0]), sm.Array([1.0, 2.0]))
    assert not sm.allclose(sm.Array([1.0]), sm.Array([2.0]))


def test_views_through_free_functions(rng):
    x = rng.normal(size=(4, 4)).astype(np.float32)
    a = sm.Array(x)
    v = a.T[1:3]
    np.testing.assert_allclose(sm.sum(v, axis=1).numpy(), x.T[1:3].sum(axis=1), rtol=1e-5)


def test_factory_extensions():
    """eye/linspace/*_like — NumPy-surface completeness beyond the
    reference's empty/ones/zeros (UserFunctions.h:8-40)."""
    A = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_allclose(np.asarray(sm.eye(3)), np.eye(3))
    np.testing.assert_allclose(np.asarray(sm.eye(2, 5)), np.eye(2, 5))
    np.testing.assert_allclose(
        np.asarray(sm.linspace(0.0, 1.0, 5)), np.linspace(0, 1, 5)
    )
    np.testing.assert_allclose(
        np.asarray(sm.zeros_like(sm.array(A))), np.zeros_like(A)
    )
    np.testing.assert_allclose(
        np.asarray(sm.ones_like(sm.array(A))), np.ones_like(A)
    )
    np.testing.assert_allclose(
        np.asarray(sm.full_like(sm.array(A), 7)), np.full_like(A, 7)
    )


def test_statistical_reductions():
    A = np.arange(12, dtype=np.float32).reshape(3, 4) + 1
    np.testing.assert_allclose(
        float(np.asarray(sm.prod(sm.array(A[:2, :2])))), np.prod(A[:2, :2])
    )
    np.testing.assert_allclose(
        np.asarray(sm.var(sm.array(A), axis=0)), A.var(axis=0), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(sm.std(sm.array(A), axis=1)), A.std(axis=1), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(sm.var(sm.array(A), ddof=1)), A.var(ddof=1), rtol=1e-5
    )


def test_unary_surface_extensions():
    A = np.asarray([[0.3, -1.7], [2.5, -0.5]], np.float32)
    a = sm.array(A)
    # These surface fns are plain XLA lowerings (unlike the contracted
    # transcendentals), held to the CPU's accuracy here.
    rtol = 1e-5
    for name in ("floor", "ceil", "round", "log1p", "expm1", "sinh", "cosh",
                 "arctan", "isnan", "isinf", "isfinite"):
        got = np.asarray(getattr(sm, name)(sm.abs(a) if name.startswith("log") else a))
        want = getattr(np, name)(np.abs(A) if name.startswith("log") else A)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(sm.log10(sm.abs(a))), np.log10(np.abs(A)), rtol=rtol
    )
    np.testing.assert_allclose(
        np.asarray(sm.arcsin(sm.clip(a, -1.0, 1.0))),
        np.arcsin(np.clip(A, -1, 1)), rtol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(sm.arctan2(a, sm.ones_like(a))), np.arctan2(A, 1.0),
        rtol=1e-5,
    )
