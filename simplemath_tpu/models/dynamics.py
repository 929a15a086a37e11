"""Benchmark dynamical systems for the trajectory-optimization layer.

The reference has no model layer; these systems realize the BASELINE.json
workloads (configs 3-5): pendulum swing-up (H=50, 4096 rollouts), cartpole
iLQR/DDP (H=100, 8192 scenarios), and a 12-state quadrotor for SQP-MPC at a
1 kHz replan budget.

Each system is a pure-function triple (dynamics, stage cost, final cost)
over jnp-compatible operands — they trace identically whether called with
``jax.Array`` or ``simplemath_tpu.Array`` (the SMArray-API expressibility the
north star asks for; see tests/test_models.py::test_dynamics_via_sm_api).
Dynamics are continuous-time ``xdot = f(x, u)`` discretized with RK4, static
shapes throughout so everything vmaps and compiles to batched vector ops.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax.numpy as jnp


def rk4(f: Callable, x, u, dt: float):
    """Classic RK4 step, fully unrolled (static) for XLA fusion."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


@dataclasses.dataclass(frozen=True)
class System:
    """A control system: discrete dynamics + quadratic-ish costs."""

    name: str
    nx: int
    nu: int
    dt: float
    step: Callable  # (x, u) -> x_next
    stage_cost: Callable  # (x, u) -> scalar
    final_cost: Callable  # (x) -> scalar
    # True when the costs are coordinate-separable (diagonal Hessians, no
    # x-u cross terms): iLQR's PSD projection then reduces to exact diagonal
    # clamping instead of a batched eigh (ILQRConfig.psd="auto").
    separable_cost: bool = False
    # True when step/stage_cost/final_cost accept states with arbitrary
    # TRAILING batch axes — x of shape (nx, *batch), u of (nu, *batch),
    # costs returning (*batch).  Lets the batched solvers run rollouts and
    # line searches in batch-minor SoA layout (ops/soa.py) where the
    # scenario batch is the minor (contiguous) axis, instead of vmapping
    # with the tiny state dim minor.  Leading-axis indexing (``x[0]``) plus
    # ``jnp.stack`` along axis 0 gives this for free; constants must
    # broadcast from the left (see _left_bcast).
    batch_polymorphic: bool = False


def _left_bcast(c, x):
    """Reshape a (k,) constant vector so it broadcasts against a stacked
    (k, *batch) state: (k,) -> (k, 1, ..., 1)."""
    c = jnp.asarray(c, x.dtype)
    return c.reshape(c.shape + (1,) * (x.ndim - 1))


# ---------------------------------------------------------------- pendulum
def make_pendulum(dt: float = 0.05) -> System:
    """Torque-limited pendulum swing-up: x = [theta, thetadot], target
    upright (theta = pi)."""
    g, m, l, b = 9.81, 1.0, 1.0, 0.1

    def f(x, u):
        th, thd = x[0], x[1]
        thdd = (u[0] - b * thd - m * g * l * jnp.sin(th)) / (m * l * l)
        return jnp.stack([thd, thdd])

    def step(x, u):
        return rk4(f, x, u, dt)

    def stage_cost(x, u):
        th_err = x[0] - jnp.pi
        return 0.5 * (th_err**2 + 0.1 * x[1] ** 2 + 0.01 * u[0] ** 2)

    def final_cost(x):
        th_err = x[0] - jnp.pi
        return 0.5 * (100.0 * th_err**2 + 10.0 * x[1] ** 2)

    return System("pendulum", 2, 1, dt, step, stage_cost, final_cost,
                  separable_cost=True, batch_polymorphic=True)


# ---------------------------------------------------------------- cartpole
def make_cartpole(dt: float = 0.02) -> System:
    """Cartpole swing-up: x = [p, pdot, theta, thetadot], theta = 0 is
    hanging, target theta = pi (up)."""
    mc, mp, l, g = 1.0, 0.3, 0.5, 9.81

    def f(x, u):
        _, pd, th, thd = x[0], x[1], x[2], x[3]
        s, c = jnp.sin(th), jnp.cos(th)
        force = u[0]
        denom = mc + mp * s * s
        pdd = (force + mp * s * (l * thd * thd + g * c)) / denom
        thdd = (-force * c - mp * l * thd * thd * c * s - (mc + mp) * g * s) / (
            l * denom
        )
        return jnp.stack([pd, pdd, thd, thdd])

    def step(x, u):
        return rk4(f, x, u, dt)

    def stage_cost(x, u):
        # Upright target via cos(theta) = -1 (smooth, no angle wrapping).
        up_err = 1.0 + jnp.cos(x[2])
        return 0.5 * (
            0.1 * x[0] ** 2 + 10.0 * up_err**2 + 0.1 * x[3] ** 2 + 0.01 * u[0] ** 2
        )

    def final_cost(x):
        up_err = 1.0 + jnp.cos(x[2])
        return 0.5 * (
            10.0 * x[0] ** 2
            + 500.0 * up_err**2
            + 10.0 * x[1] ** 2
            + 50.0 * x[3] ** 2
        )

    return System("cartpole", 4, 1, dt, step, stage_cost, final_cost,
                  separable_cost=True, batch_polymorphic=True)


# --------------------------------------------------------------- quadrotor
def make_quadrotor(dt: float = 0.02) -> System:
    """12-state quadrotor (BASELINE.json config 5): position (3), velocity
    (3), Euler attitude (3), body rates (3); controls = total thrust +
    body-rate torques (4).  Euler-angle model with small-angle-safe
    trigonometry; costs regulate to hover at the origin."""
    import numpy as np

    mass, g = 1.0, 9.81
    J_np = np.array([0.01, 0.01, 0.02])  # diagonal inertia

    def f(x, u):
        # Constants follow the state dtype so f32 pipelines stay f32 even
        # under jax_enable_x64, and broadcast from the LEFT so stacked
        # (nx, *batch) states work (batch_polymorphic).
        J = _left_bcast(J_np, x)
        vel = x[3:6]
        phi, theta, psi = x[6], x[7], x[8]
        omega = x[9:12]
        thrust = u[0] + mass * g  # u[0] is delta-thrust around hover
        torque = u[1:4]

        cph, sph = jnp.cos(phi), jnp.sin(phi)
        cth, sth = jnp.cos(theta), jnp.sin(theta)
        cps, sps = jnp.cos(psi), jnp.sin(psi)
        # Body-z axis in world frame (ZYX Euler).
        zb = jnp.stack(
            [cph * sth * cps + sph * sps, cph * sth * sps - sph * cps, cph * cth]
        )
        gvec = _left_bcast([0.0, 0.0, g], x)
        acc = (thrust / mass) * zb - gvec

        # Euler kinematics (ZYX): eulerdot = E(phi, theta) @ omega.
        tth = sth / cth
        eulerdot = jnp.stack(
            [
                omega[0] + tth * (sph * omega[1] + cph * omega[2]),
                cph * omega[1] - sph * omega[2],
                (sph * omega[1] + cph * omega[2]) / cth,
            ]
        )
        omegadot = (torque - jnp.cross(omega, J * omega, axis=0)) / J
        return jnp.concatenate([vel, acc, eulerdot, omegadot])

    def step(x, u):
        return rk4(f, x, u, dt)

    Qdiag_np = np.array(
        [10.0, 10.0, 10.0, 1.0, 1.0, 1.0, 5.0, 5.0, 5.0, 0.1, 0.1, 0.1]
    )
    Rdiag_np = np.array([0.1, 0.5, 0.5, 0.5])

    def stage_cost(x, u):
        Qd = _left_bcast(Qdiag_np, x)
        Rd = _left_bcast(Rdiag_np, u)
        return 0.5 * (jnp.sum(Qd * x * x, axis=0) + jnp.sum(Rd * u * u, axis=0))

    def final_cost(x):
        Qd = _left_bcast(Qdiag_np, x)
        return 0.5 * 10.0 * jnp.sum(Qd * x * x, axis=0)

    return System("quadrotor", 12, 4, dt, step, stage_cost, final_cost,
                  separable_cost=True, batch_polymorphic=True)


# ----------------------------------------------------------------- bicycle
def make_bicycle(dt: float = 0.05, wheelbase: float = 2.7,
                 target=(20.0, 3.0)) -> System:
    """Kinematic bicycle (car) lane-change / waypoint tracking: the
    autonomous-driving MPC workhorse.  x = [px, py, yaw, v],
    u = [accel, steer] — the framework's two-input model family (pendulum
    and cartpole are single-input, the quadrotor four).  Costs drive to
    ``target`` at cruise speed with straight heading; steering enters the
    dynamics through tan(delta)/L, so the problem is genuinely nonlinear
    in the controls."""
    import numpy as np

    v_ref = 5.0
    tgt_np = np.array([target[0], target[1]])

    def f(x, u):
        yaw, v = x[2], x[3]
        a, delta = u[0], u[1]
        return jnp.stack(
            [
                v * jnp.cos(yaw),
                v * jnp.sin(yaw),
                v * jnp.tan(delta) / wheelbase,
                a,
            ]
        )

    def step(x, u):
        return rk4(f, x, u, dt)

    def stage_cost(x, u):
        tgt = _left_bcast(tgt_np, x)
        ex = x[0] - tgt[0]
        ey = x[1] - tgt[1]
        return 0.5 * (
            0.02 * ex**2
            + 0.1 * ey**2
            + 0.5 * x[2] ** 2
            + 0.05 * (x[3] - v_ref) ** 2
            + 0.1 * u[0] ** 2
            + 1.0 * u[1] ** 2
        )

    def final_cost(x):
        tgt = _left_bcast(tgt_np, x)
        ex = x[0] - tgt[0]
        ey = x[1] - tgt[1]
        return 0.5 * (
            10.0 * ex**2 + 50.0 * ey**2 + 20.0 * x[2] ** 2
            + 5.0 * (x[3] - v_ref) ** 2
        )

    return System("bicycle", 4, 2, dt, step, stage_cost, final_cost,
                  separable_cost=True, batch_polymorphic=True)


SYSTEMS = {
    "pendulum": make_pendulum,
    "cartpole": make_cartpole,
    "quadrotor": make_quadrotor,
    "bicycle": make_bicycle,
}
