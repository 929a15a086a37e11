"""Batch-minor (SoA) small-matrix algebra and the SoA iLQR stages.

The SoA layout (ops/soa.py) is the answer to the reference's
layout-sensitive SIMD dispatch (include/math/calculate.h:33-46): instead of
dropping to scalar code when the inner layout doesn't match the vector
width, the batched solvers transpose ONCE so the scenario batch is the
minor (contiguous) axis.  These tests pin exact parity between the SoA paths and the
straightforward vmapped implementations they replace.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from simplemath_tpu.models import make_cartpole, make_pendulum, make_quadrotor
from simplemath_tpu.models import ilqr as I
from simplemath_tpu.models.ilqr import ILQRConfig, solve, solve_batched
from simplemath_tpu.ops import soa

SYSTEMS = [make_pendulum, make_cartpole, make_quadrotor]


def _rand(key, shape):
    return jax.random.normal(key, shape, jnp.float32)


# ------------------------------------------------------------- primitives
def test_soa_matmul_matvec_inv(rng):
    B = 37
    for n, m, k in [(1, 1, 1), (2, 3, 4), (4, 4, 4), (5, 2, 3)]:
        A = rng.standard_normal((n, k, B)).astype(np.float32)
        C = rng.standard_normal((k, m, B)).astype(np.float32)
        v = rng.standard_normal((k, B)).astype(np.float32)
        got = np.asarray(soa.matmul(jnp.asarray(A), jnp.asarray(C)))
        want = np.einsum("ikb,kjb->ijb", A, C)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        gotv = np.asarray(soa.matvec(jnp.asarray(A), jnp.asarray(v)))
        np.testing.assert_allclose(
            gotv, np.einsum("ikb,kb->ib", A, v), rtol=1e-5, atol=1e-5
        )


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_soa_inv_matches_numpy(rng, n):
    B = 17
    # Well-conditioned PD stacks: A = M M^T + n*I.
    M = rng.standard_normal((B, n, n)).astype(np.float64)
    A = M @ np.swapaxes(M, -1, -2) + n * np.eye(n)
    A_soa = jnp.asarray(np.moveaxis(A, 0, -1))
    got = np.moveaxis(np.asarray(soa.inv(A_soa)), -1, 0)
    want = np.linalg.inv(A)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_soa_roundtrip_transpose(rng):
    x = jnp.asarray(rng.standard_normal((6, 4, 5)).astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(soa.from_soa(soa.to_soa(x, 2))), np.asarray(x)
    )
    np.testing.assert_array_equal(
        np.asarray(soa.transpose(x)), np.swapaxes(np.asarray(x), 0, 1)
    )


# ----------------------------------------------------------- solver stages
@pytest.mark.parametrize("mk", SYSTEMS)
def test_backward_soa_matches_vmapped(mk):
    system = mk()
    Bb, H, nx, nu = 6, 9, system.nx, system.nu
    k = jax.random.split(jax.random.PRNGKey(0), 6)
    A = 0.05 * _rand(k[0], (Bb, H, nx, nx)) + jnp.eye(nx, dtype=jnp.float32)
    Bm = 0.1 * _rand(k[1], (Bb, H, nx, nu))
    lx = _rand(k[2], (Bb, H, nx))
    lu = _rand(k[3], (Bb, H, nu))
    lxx = jnp.broadcast_to(jnp.eye(nx), (Bb, H, nx, nx)).astype(jnp.float32)
    luu = jnp.broadcast_to(jnp.eye(nu), (Bb, H, nu, nu)).astype(jnp.float32)
    lux = jnp.zeros((Bb, H, nu, nx), jnp.float32)
    VxT = _rand(k[4], (Bb, nx))
    VxxT = jnp.broadcast_to(jnp.eye(nx), (Bb, nx, nx)).astype(jnp.float32)
    reg = jnp.float32(1e-6)
    ks0, Ks0 = jax.jit(
        jax.vmap(lambda *a: I.backward_sequential(*a, reg))
    )(A, Bm, lx, lu, lxx, luu, lux, VxT, VxxT)
    ks1, Ks1 = jax.jit(
        lambda *a: I.backward_sequential_soa(*a, jnp.full((Bb,), 1e-6, jnp.float32))
    )(A, Bm, lx, lu, lxx, luu, lux, VxT, VxxT)
    np.testing.assert_allclose(np.asarray(ks0), np.asarray(ks1), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(Ks0), np.asarray(Ks1), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("mk", SYSTEMS)
def test_linearize_soa_matches_vmapped(mk):
    system = mk()
    Bb, H = 5, 7
    key = jax.random.PRNGKey(1)
    xs = 0.3 * _rand(key, (Bb, H + 1, system.nx))
    us = 0.3 * _rand(key, (Bb, H, system.nu))
    ref = jax.jit(jax.vmap(lambda xs, us: I.linearize(system, xs, us)))(xs, us)
    got = jax.jit(lambda xs, us: I.linearize_soa(system, xs, us))(xs, us)
    for name, (r, g) in zip(
        ("A", "B", "lx", "lu", "lxx", "luu", "lux", "VxT", "VxxT"), zip(ref, got)
    ):
        assert r.shape == g.shape, name
        np.testing.assert_allclose(
            np.asarray(r), np.asarray(g), rtol=1e-4, atol=2e-5, err_msg=name
        )


@pytest.mark.parametrize("mk", SYSTEMS)
def test_linesearch_soa_matches_vmapped(mk):
    system = mk()
    Bb, H = 4, 8
    key = jax.random.PRNGKey(2)
    alphas = (1.0, 0.5, 0.1)
    xs = 0.1 * _rand(key, (Bb, H + 1, system.nx))
    us = 0.1 * _rand(key, (Bb, H, system.nu))
    ks = 0.1 * _rand(key, (Bb, H, system.nu))
    Ks = 0.1 * _rand(key, (Bb, H, system.nu, system.nx))
    ref = jax.jit(
        jax.vmap(lambda *a: I.forward_linesearch(system, *a, alphas))
    )(xs, us, ks, Ks)
    got = jax.jit(lambda *a: I.forward_linesearch_soa(system, *a, alphas))(
        xs, us, ks, Ks
    )
    for name, (r, g) in zip(("xs", "us", "cost"), zip(ref, got)):
        np.testing.assert_allclose(
            np.asarray(r), np.asarray(g), rtol=1e-4, atol=1e-5, err_msg=name
        )


def test_solve_batched_converges_like_vmapped_solve():
    """End-to-end: the SoA-batched solver reaches the same solution quality
    as per-scenario vmap(solve) (identical up to f32 summation order, which
    can flip line-search accepts between equal-quality local optima)."""
    system = make_pendulum()
    cfg = ILQRConfig(iterations=15)
    Bb, H = 16, 30
    x0 = 0.2 * _rand(jax.random.PRNGKey(3), (Bb, system.nx))
    us = jnp.zeros((Bb, H, system.nu), jnp.float32)
    c_soa = np.asarray(
        jax.jit(lambda x, u: solve_batched(system, x, u, cfg).cost)(x0, us)
    )
    c_vm = np.asarray(
        jax.jit(jax.vmap(lambda x, u: solve(system, x, u, cfg).cost))(x0, us)
    )
    # Mean solution quality matches tightly; each scenario is no worse than
    # a small multiple of its vmapped counterpart.
    assert abs(c_soa.mean() - c_vm.mean()) / abs(c_vm.mean()) < 1e-2
    assert np.all(c_soa < c_vm * 1.05 + 1e-3)


def test_solve_batched_result_shapes():
    system = make_cartpole()
    cfg = ILQRConfig(iterations=3)
    Bb, H = 3, 5
    x0 = 0.1 * _rand(jax.random.PRNGKey(4), (Bb, system.nx))
    us = jnp.zeros((Bb, H, system.nu), jnp.float32)
    r = jax.jit(lambda x, u: solve_batched(system, x, u, cfg))(x0, us)
    assert r.xs.shape == (Bb, H + 1, system.nx)
    assert r.us.shape == (Bb, H, system.nu)
    assert r.cost.shape == (Bb,)
    assert r.cost_trace.shape == (Bb, cfg.iterations)
    assert r.grad_norm.shape == (Bb,)
    assert np.all(np.isfinite(np.asarray(r.cost)))


def test_batch_polymorphic_dynamics_trailing_axes():
    """step/stage_cost/final_cost accept (n, *batch) stacks and match the
    per-point results elementwise."""
    for mk in SYSTEMS:
        system = mk()
        key = jax.random.PRNGKey(5)
        A, B = 3, 11
        x = 0.3 * _rand(key, (system.nx, A, B))
        u = 0.3 * _rand(key, (system.nu, A, B))
        xn = system.step(x, u)
        c = system.stage_cost(x, u)
        cf = system.final_cost(x)
        assert xn.shape == x.shape
        assert c.shape == (A, B)
        assert cf.shape == (A, B)
        # Spot-check one point against the unstacked call.
        x1, u1 = x[:, 1, 4], u[:, 1, 4]
        np.testing.assert_allclose(
            np.asarray(system.step(x1, u1)), np.asarray(xn[:, 1, 4]),
            rtol=1e-5, atol=1e-6,
        )
        np.testing.assert_allclose(
            float(system.stage_cost(x1, u1)), float(c[1, 4]), rtol=1e-5
        )
