"""Parallel-in-time real-time-iteration (RTI) SQP-MPC.

The 1 kHz replan budget (BASELINE.json config 5) is hard to meet with O(H)
sequential structure: every sequential scan step costs a device-side loop
iteration, and rollout(H) + backward(H) + forward(H) is 3H of them.  This
module is the O(log H)-depth replan:

* **linearize** around the shifted previous nominal — vmapped over the
  horizon, depth O(1);
* **defects** d_k = f(x_k, u_k) - x_{k+1} evaluated in parallel
  (multiple-shooting Gauss-Newton: the nominal need not be dynamically
  feasible; defects shrink across ticks);
* **backward pass** — associative scan over affine-quadratic value
  elements with defect offsets, depth O(log H);
* **forward pass** — the closed-loop update is an AFFINE recursion
  dx_{k+1} = (A_k + B_k K_k) dx_k + B_k k_k + d_k, i.e. another
  associative scan, depth O(log H).

No sequential nonlinear rollout anywhere in the tick.  This is the
standard real-time iteration scheme (one SQP iteration per tick, warm
started), laid out parallel-in-time.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .dynamics import System
from . import ilqr as _ilqr


from ..utils.precision import f32_matmuls

@dataclasses.dataclass(frozen=True)
class RTIConfig:
    reg: float = 1e-6
    step_alpha: float = 1.0  # RTI applies full steps; lower to damp
    psd: str = "auto"
    psd_eps: float = 1e-6


class RTIState(NamedTuple):
    xs: jax.Array  # (H+1, nx) nominal states
    us: jax.Array  # (H, nu) nominal controls


class RTIOutput(NamedTuple):
    u0: jax.Array
    state: RTIState
    defect_norm: jax.Array
    cost: jax.Array


@f32_matmuls
def affine_scan(A, b, x0):
    """All states of x_{k+1} = A_k x_k + b_k via associative scan.

    Returns xs with shape (H+1, nx); depth O(log H)."""

    def combine(e1, e2):
        # e1 earlier in time; composition is (A2 A1, A2 b1 + b2), batched.
        A1, b1 = e1
        A2, b2 = e2
        return A2 @ A1, (A2 @ b1[..., None])[..., 0] + b2

    Ps, qs = jax.lax.associative_scan(combine, (A, b), axis=0)
    xs_tail = (Ps @ x0[None, :, None])[..., 0] + qs
    return jnp.concatenate([x0[None], xs_tail], axis=0)


def linearize_with_defects(system: System, xs, us):
    """Jacobians, cost derivatives, and shooting defects — all parallel
    over the horizon."""
    A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T = _ilqr.linearize(system, xs, us)
    f_next = jax.vmap(system.step)(xs[:-1], us)
    d = f_next - xs[1:]
    return A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, d


@f32_matmuls
def backward_associative_defect(
    A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, d, reg
):
    """Associative-scan Riccati with defect (multiple-shooting) offsets.

    Identical to ilqr.backward_associative but the per-step element carries
    the affine dynamics offset c = d - B luu^{-1} lu, and gain recovery
    uses Vx_{k+1} + Vxx_{k+1} d_k."""
    nu = B.shape[-1]
    nx = A.shape[-1]
    I_u = jnp.eye(nu, dtype=B.dtype)
    I_x = jnp.eye(nx, dtype=A.dtype)

    from ..ops.linalg_small import solve_unrolled

    def make_elem(inp):
        A_t, B_t, lx_t, lu_t, lxx_t, luu_t, lux_t, d_t = inp
        Ru = luu_t + reg * I_u
        Ru_inv_lux = solve_unrolled(Ru, lux_t)
        Ru_inv_lu = solve_unrolled(Ru, lu_t)
        Ru_inv_Bt = solve_unrolled(Ru, B_t.T)
        F = A_t - B_t @ Ru_inv_lux
        c = d_t - B_t @ Ru_inv_lu
        C = B_t @ Ru_inv_Bt
        J = lxx_t - lux_t.T @ Ru_inv_lux
        eta = -(lx_t - lux_t.T @ Ru_inv_lu)
        return F, c, C, eta, J

    elems = jax.vmap(make_elem)((A, B, lx, lu, lxx, luu, lux, d))
    term = (
        jnp.zeros((nx, nx), A.dtype),
        jnp.zeros((nx,), A.dtype),
        jnp.zeros((nx, nx), A.dtype),
        -Vx_T,
        Vxx_T,
    )
    full = jax.tree.map(
        lambda e, t: jnp.concatenate([e, t[None]], axis=0), elems, term
    )

    def combine(elem_i, elem_j):
        Fi, ci, Ci, etai, Ji = elem_i
        Fj, cj, Cj, etaj, Jj = elem_j

        def mv(M, v):
            return (M @ v[..., None])[..., 0]

        def tr(M):
            return jnp.swapaxes(M, -1, -2)

        # Unrolled inverses instead of jnp.linalg.solve's pivoted-LU loops
        # inside this nested program (ops/linalg_small.py).
        from ..ops.linalg_small import inv_unrolled

        M = inv_unrolled(I_x + Ci @ Jj)
        N = inv_unrolled(I_x + Jj @ Ci)
        F = Fj @ M @ Fi
        c = mv(Fj @ M, ci + mv(Ci, etaj)) + cj
        C = Fj @ M @ Ci @ tr(Fj) + Cj
        eta = mv(tr(Fi) @ N, etaj - mv(Jj, ci)) + etai
        J = tr(Fi) @ N @ Jj @ Fi + Ji
        return F, c, C, eta, J

    rev = jax.tree.map(lambda x: jnp.flip(x, axis=0), full)
    scanned = jax.lax.associative_scan(lambda a, b: combine(b, a), rev, axis=0)
    suffix = jax.tree.map(lambda x: jnp.flip(x, axis=0), scanned)

    Vx_all = -suffix[3]
    Vxx_all = suffix[4]

    def gains(inp, Vx, Vxx):
        A_t, B_t, lu_t, luu_t, lux_t, d_t = inp
        Vx_eff = Vx + (Vxx @ d_t[..., None])[..., 0]
        Qu = lu_t + B_t.T @ Vx_eff
        Quu = luu_t + B_t.T @ Vxx @ B_t + reg * I_u
        Qux = lux_t + B_t.T @ Vxx @ A_t
        k_t = -solve_unrolled(Quu, Qu)
        K_t = -solve_unrolled(Quu, Qux)
        return k_t, K_t

    ks, Ks = jax.vmap(gains)((A, B, lu, luu, lux, d), Vx_all[1:], Vxx_all[1:])
    return ks, Ks


@f32_matmuls
def rti_tick(
    system: System,
    state: RTIState,
    x_measured,
    config: RTIConfig = RTIConfig(),
) -> RTIOutput:
    """One real-time iteration: shift, linearize, backward, affine forward.

    Every stage is O(1) or O(log H) in sequential depth."""
    xs, us = state.xs, state.us
    # Shift the nominal one step (receding horizon warm start).
    xs = jnp.concatenate([xs[1:], xs[-1:]], axis=0)
    us = jnp.concatenate([us[1:], us[-1:]], axis=0)

    A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, d = linearize_with_defects(
        system, xs, us
    )
    psd_mode = config.psd
    if psd_mode == "auto":
        psd_mode = "clamp_diag" if system.separable_cost else "eigh"
    lxx, luu, lux, Vxx_T = _ilqr.psd_cost_hessians(
        lxx, luu, lux, Vxx_T, psd_mode, config.psd_eps
    )
    reg = jnp.asarray(config.reg, xs.dtype)
    ks, Ks = backward_associative_defect(
        A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, d, reg
    )

    # Closed-loop affine forward pass (associative):
    #   dx_{k+1} = (A_k + B_k K_k) dx_k + alpha*B_k k_k + d_k
    alpha = jnp.asarray(config.step_alpha, xs.dtype)
    Acl = A + B @ Ks
    bcl = alpha * (B @ ks[..., None])[..., 0] + d
    dx0 = jnp.asarray(x_measured, xs.dtype) - xs[0]
    dxs = affine_scan(Acl, bcl, dx0)
    dus = alpha * ks + (Ks @ dxs[:-1, :, None])[..., 0]

    xs_new = xs + dxs
    us_new = us + dus
    cost = _ilqr.trajectory_cost(system, xs_new, us_new)
    return RTIOutput(
        u0=us_new[0],
        state=RTIState(xs=xs_new, us=us_new),
        defect_norm=jnp.max(jnp.abs(d)),
        cost=cost,
    )


def rti_init(system: System, x0, horizon: int) -> RTIState:
    """Initial nominal: zero controls, sequential rollout ONCE at startup
    (startup is not latency-critical)."""
    us = jnp.zeros((horizon, system.nu), jnp.float32)
    xs = _ilqr.rollout(system.step, jnp.asarray(x0, jnp.float32), us)
    return RTIState(xs=xs, us=us)


@f32_matmuls
def rti_closed_loop(
    system: System,
    x0,
    horizon: int,
    ticks: int,
    config: RTIConfig = RTIConfig(),
):
    """Closed-loop RTI MPC, fully on device: one lax.scan over ticks."""
    state0 = rti_init(system, x0, horizon)
    x0 = jnp.asarray(x0, jnp.float32)

    def tick(carry, _):
        x, state = carry
        out = rti_tick(system, state, x, config)
        x_next = system.step(x, out.u0)
        return (x_next, out.state), (x_next, out.u0, out.cost, out.defect_norm)

    (xf, _), (xs, us, costs, defects) = jax.lax.scan(
        tick, (x0, state0), None, length=ticks
    )
    return xs, us, costs, defects
