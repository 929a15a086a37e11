"""Batched iLQR/DDP trajectory optimizer — the BASELINE.json north star.

Built on the array core:

* rollouts and linearization are ``lax.scan``/``vmap`` over static shapes;
* the Riccati backward pass comes in two interchangeable forms:
  - ``backward="sequential"``: classic reverse ``lax.scan`` (O(H) depth);
  - ``backward="associative"``: ``jax.lax.associative_scan`` over
    affine-quadratic value-function elements (O(log H) depth) — the
    "long-axis" parallelization SURVEY §5 maps the reference's missing
    sequence parallelism onto (parallel LQT composition, cf. Särkkä &
    García-Fernández temporal parallelization);
* the forward line search evaluates ALL step sizes in parallel with ``vmap``
  and picks the best improvement — batched work instead of host control
  flow;
* thousands of scenarios run per device via an outer ``vmap``; the scenario
  axis shards over the device mesh in simplemath_tpu.parallel.

Everything is jittable with zero data-dependent python control flow; the
iteration count is static so a solve compiles to one XLA program.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .dynamics import System


from ..utils.precision import f32_matmuls

@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    iterations: int = 10
    # Parallel line search step sizes (all evaluated at once, vmapped).
    alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)
    reg_init: float = 1e-6
    reg_scale_up: float = 10.0
    reg_scale_down: float = 0.5
    reg_max: float = 1e8
    backward: str = "sequential"  # or "associative"
    # PSD-ization of per-step cost Hessians (nonconvex costs make lxx
    # indefinite, which NaNs the Riccati Cholesky):
    #   "auto"       — "clamp_diag" for separable-cost systems, else "eigh";
    #   "clamp_diag" — clamp diagonal entries at eps (EXACT projection when
    #                  Hessians are diagonal, i.e. separable costs; no
    #                  eigendecomposition);
    #   "eigh"       — exact projection onto the PSD cone (batched eigh);
    #   "gershgorin" — Gershgorin lower-bound shift (cheap, conservative —
    #                  can over-damp);
    #   "none"       — disabled (convex costs only).
    psd: str = "auto"
    psd_eps: float = 1e-6


class ILQRResult(NamedTuple):
    xs: jax.Array  # (H+1, nx)
    us: jax.Array  # (H, nu)
    cost: jax.Array  # scalar final cost
    cost_trace: jax.Array  # (iterations,)
    grad_norm: jax.Array  # scalar, |k| of last backward pass


def rollout(step: Callable, x0, us):
    """Open-loop rollout: xs[0]=x0, xs[t+1]=step(xs[t], us[t])."""

    def body(x, u):
        xn = step(x, u)
        return xn, xn

    _, xs_tail = jax.lax.scan(body, x0, us)
    return jnp.concatenate([x0[None], xs_tail], axis=0)


def trajectory_cost(system: System, xs, us):
    stage = jax.vmap(system.stage_cost)(xs[:-1], us)
    return jnp.sum(stage) + system.final_cost(xs[-1])


@f32_matmuls
def linearize(system: System, xs, us):
    """Per-step Jacobians of dynamics and gradients/Hessians of cost,
    vmapped over the horizon (all small dense matrices, batched)."""
    A = jax.vmap(jax.jacfwd(system.step, argnums=0))(xs[:-1], us)
    B = jax.vmap(jax.jacfwd(system.step, argnums=1))(xs[:-1], us)
    lx = jax.vmap(jax.grad(system.stage_cost, argnums=0))(xs[:-1], us)
    lu = jax.vmap(jax.grad(system.stage_cost, argnums=1))(xs[:-1], us)
    lxx = jax.vmap(jax.hessian(system.stage_cost, argnums=0))(xs[:-1], us)
    luu = jax.vmap(jax.hessian(system.stage_cost, argnums=1))(xs[:-1], us)
    lux = jax.vmap(
        jax.jacfwd(jax.grad(system.stage_cost, argnums=1), argnums=0)
    )(xs[:-1], us)
    Vx_T = jax.grad(system.final_cost)(xs[-1])
    Vxx_T = jax.hessian(system.final_cost)(xs[-1])
    return A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T


@f32_matmuls
def linearize_soa(system: System, xs, us):
    """Batched linearization in batch-minor SoA layout.

    Same outputs as ``vmap(linearize)`` — batch-leading (Bb, H, ...) arrays
    — but computed with the (time x scenario) product as the minor axes:
    every point is independent, so Jacobian/Hessian columns come from nx+nu
    ``jvp`` seed directions evaluated over ALL (H, Bb) points at once
    (forward-over-reverse for the Hessians), instead of per-scenario
    ``jacfwd``/``hessian`` structures with the tiny state dim minor.
    Requires ``system.batch_polymorphic``.
    """
    nx, nu = system.nx, system.nu
    dtype = xs.dtype
    # (Bb, H, n) -> (n, H, Bb)
    x_st = jnp.transpose(xs[:, :-1, :], (2, 1, 0))
    u_st = jnp.transpose(us, (2, 1, 0))
    xT = jnp.transpose(xs[:, -1, :], (1, 0))  # (nx, Bb)

    def seed(n, i, template):
        e = jnp.zeros((n,) + (1,) * (template.ndim - 1), dtype)
        return jnp.broadcast_to(e.at[i].set(1.0), template.shape)

    # Dynamics Jacobians: column i of A is d step / d x_i at every point.
    A_cols = [
        jax.jvp(lambda x: system.step(x, u_st), (x_st,), (seed(nx, i, x_st),))[1]
        for i in range(nx)
    ]
    B_cols = [
        jax.jvp(lambda u: system.step(x_st, u), (u_st,), (seed(nu, j, u_st),))[1]
        for j in range(nu)
    ]
    A = jnp.stack(A_cols, axis=1)  # (nx, nx, H, Bb)
    B = jnp.stack(B_cols, axis=1)  # (nx, nu, H, Bb)

    # Cost gradients: stage cost is separable across points, so the grad of
    # the summed cost IS the per-point gradient stack.
    def csum(x, u):
        return jnp.sum(system.stage_cost(x, u))

    grad_c = jax.grad(csum, argnums=(0, 1))
    lx, lu = grad_c(x_st, u_st)  # (nx, H, Bb), (nu, H, Bb)

    # Hessian columns: forward-over-reverse jvp of the gradient.
    lxx_cols, lux_cols = [], []
    for i in range(nx):
        (_, _), (dgx, dgu) = jax.jvp(
            lambda x: grad_c(x, u_st), (x_st,), (seed(nx, i, x_st),)
        )
        lxx_cols.append(dgx)  # (nx, H, Bb) = lxx[:, i]
        lux_cols.append(dgu)  # (nu, H, Bb) = lux[:, i]
    luu_cols = [
        jax.jvp(lambda u: grad_c(x_st, u), (u_st,), (seed(nu, j, u_st),))[1][1]
        for j in range(nu)
    ]
    lxx = jnp.stack(lxx_cols, axis=1)  # (nx, nx, H, Bb)
    lux = jnp.stack(lux_cols, axis=1)  # (nu, nx, H, Bb)
    luu = jnp.stack(luu_cols, axis=1)  # (nu, nu, H, Bb)

    # Terminal value expansion at xs[:, -1].
    def fsum(x):
        return jnp.sum(system.final_cost(x))

    Vx_T = jax.grad(fsum)(xT)  # (nx, Bb)
    VxxT_cols = [
        jax.jvp(jax.grad(fsum), (xT,), (seed(nx, i, xT),))[1] for i in range(nx)
    ]
    Vxx_T = jnp.stack(VxxT_cols, axis=1)  # (nx, nx, Bb)

    # Back to the batch-leading interface shared with vmap(linearize).
    m4 = lambda a: jnp.transpose(a, (3, 2, 0, 1))  # (n,m,H,Bb)->(Bb,H,n,m)
    m3 = lambda a: jnp.transpose(a, (2, 1, 0))  # (n,H,Bb)->(Bb,H,n)
    return (
        m4(A),
        m4(B),
        m3(lx),
        m3(lu),
        m4(lxx),
        m4(luu),
        m4(lux),
        jnp.transpose(Vx_T, (1, 0)),
        jnp.transpose(Vxx_T, (2, 0, 1)),
    )


def _gershgorin_shift(H, eps):
    """Shift H by max(0, -Gershgorin lower bound) + eps so it is PD.

    lambda_min >= min_i (H_ii - sum_{j!=i} |H_ij|); one reduction per
    matrix, no factorization — vectorizes over (batch, H)."""
    diag = jnp.diagonal(H, axis1=-2, axis2=-1)
    offsum = jnp.sum(jnp.abs(H), axis=-1) - jnp.abs(diag)
    lb = jnp.min(diag - offsum, axis=-1)
    shift = jnp.maximum(0.0, -lb) + eps
    eye = jnp.eye(H.shape[-1], dtype=H.dtype)
    return H + shift[..., None, None] * eye


def _eigh_project(H, eps):
    """Exact projection onto the PSD cone (eigenvalue clamping)."""
    w, V = jnp.linalg.eigh(H)
    w = jnp.maximum(w, eps)
    return (V * w[..., None, :]) @ jnp.swapaxes(V, -1, -2)


def _clamp_diag(H, eps):
    """Clamp diagonal entries at eps — exact PSD projection for diagonal
    Hessians (separable costs), an approximation otherwise."""
    diag = jnp.diagonal(H, axis1=-2, axis2=-1)
    bump = jnp.maximum(eps - diag, 0.0)
    eye = jnp.eye(H.shape[-1], dtype=H.dtype)
    return H + bump[..., None] * eye


def psd_cost_hessians(lxx, luu, lux, Vxx_T, mode: str, eps: float):
    """PSD-ize the per-step joint cost Hessian [[lxx, lux^T], [lux, luu]]
    and the terminal Hessian, preserving gradients (only curvature moves)."""
    if mode == "none":
        return lxx, luu, lux, Vxx_T
    if mode == "clamp_diag":
        return (
            _clamp_diag(lxx, eps),
            _clamp_diag(luu, eps),
            lux,
            _clamp_diag(Vxx_T, eps),
        )
    nx = lxx.shape[-1]
    top = jnp.concatenate([lxx, jnp.swapaxes(lux, -1, -2)], axis=-1)
    bot = jnp.concatenate([lux, luu], axis=-1)
    blk = jnp.concatenate([top, bot], axis=-2)
    if mode == "eigh":
        blk = _eigh_project(blk, eps)
        Vxx_T = _eigh_project(Vxx_T, eps)
    else:
        blk = _gershgorin_shift(blk, eps)
        Vxx_T = _gershgorin_shift(Vxx_T, eps)
    lxx = blk[..., :nx, :nx]
    lux = blk[..., nx:, :nx]
    luu = blk[..., nx:, nx:]
    return lxx, luu, lux, Vxx_T


def _solve_psd(M, rhs):
    """Solve M X = rhs for symmetric positive-definite M via Cholesky."""
    L = jnp.linalg.cholesky(M)
    y = jax.scipy.linalg.solve_triangular(L, rhs, lower=True)
    return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)


@f32_matmuls
def backward_sequential(A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, reg):
    """Classic Riccati/DDP backward pass as a reverse lax.scan."""
    nu = B.shape[-1]
    I_u = jnp.eye(nu, dtype=B.dtype)

    def body(carry, inp):
        Vx, Vxx = carry
        A_t, B_t, lx_t, lu_t, lxx_t, luu_t, lux_t = inp
        Qx = lx_t + A_t.T @ Vx
        Qu = lu_t + B_t.T @ Vx
        Qxx = lxx_t + A_t.T @ Vxx @ A_t
        Quu = luu_t + B_t.T @ Vxx @ B_t + reg * I_u
        Qux = lux_t + B_t.T @ Vxx @ A_t
        k_t = -_solve_psd(Quu, Qu)
        K_t = -_solve_psd(Quu, Qux)
        Vx_new = Qx + K_t.T @ Quu @ k_t + K_t.T @ Qu + Qux.T @ k_t
        Vxx_new = Qxx + K_t.T @ Quu @ K_t + K_t.T @ Qux + Qux.T @ K_t
        Vxx_new = 0.5 * (Vxx_new + Vxx_new.T)
        return (Vx_new, Vxx_new), (k_t, K_t)

    (_, _), (ks, Ks) = jax.lax.scan(
        body, (Vx_T, Vxx_T), (A, B, lx, lu, lxx, luu, lux), reverse=True
    )
    return ks, Ks


@f32_matmuls
def backward_sequential_soa(A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, reg):
    """Batched Riccati backward pass in batch-minor (SoA) layout.

    Same recursion as :func:`backward_sequential`, but over a whole scenario
    batch at once: inputs are batch-LEADING ``(Bb, H, ...)`` arrays (as
    produced by a vmapped linearize) and ``reg`` is per-scenario ``(Bb,)``.
    Internally every small matrix becomes an ``(n, m, Bb)`` stack so the
    scenario batch is the minor (contiguous) axis of each vector op instead
    of the 4x4 matrix being so — see ops/soa.py for the layout argument.

    The Cholesky solve of the vmapped path becomes an unrolled Gauss-Jordan
    inverse (closed-form for nu <= 2); Quu is PD by construction here
    (psd_cost_hessians + reg), where pivoting would matter it returns
    inf/nan and the NaN-robust accept in :func:`solve` rejects the step.
    """
    from ..ops import soa

    nu = B.shape[-1]
    # (Bb, H, n, m) -> (H, n, m, Bb): one transpose at the boundary.
    tr = lambda x: jnp.moveaxis(x, 0, -1)
    A_, B_, lxx_, luu_, lux_, lx_, lu_ = map(tr, (A, B, lxx, luu, lux, lx, lu))
    Vx0 = tr(Vx_T)
    Vxx0 = tr(Vxx_T)
    eye_u = soa.eye_like(nu, B_)
    reg = jnp.asarray(reg, A.dtype)

    def body(carry, inp):
        Vx, Vxx = carry
        A_t, B_t, lx_t, lu_t, lxx_t, luu_t, lux_t = inp
        At, Bt = soa.transpose(A_t), soa.transpose(B_t)
        VxxA = soa.matmul(Vxx, A_t)
        VxxB = soa.matmul(Vxx, B_t)
        Qx = lx_t + soa.matvec(At, Vx)
        Qu = lu_t + soa.matvec(Bt, Vx)
        Qxx = lxx_t + soa.matmul(At, VxxA)
        Quu = luu_t + soa.matmul(Bt, VxxB) + reg * eye_u
        Qux = lux_t + soa.matmul(Bt, VxxA)
        Quu_inv = soa.inv(Quu)
        k_t = -soa.matvec(Quu_inv, Qu)
        K_t = -soa.matmul(Quu_inv, Qux)
        Kt = soa.transpose(K_t)
        Quxt = soa.transpose(Qux)
        Vx_new = (
            Qx
            + soa.matvec(Kt, soa.matvec(Quu, k_t))
            + soa.matvec(Kt, Qu)
            + soa.matvec(Quxt, k_t)
        )
        Vxx_new = (
            Qxx
            + soa.matmul(Kt, soa.matmul(Quu, K_t))
            + soa.matmul(Kt, Qux)
            + soa.matmul(Quxt, K_t)
        )
        Vxx_new = 0.5 * (Vxx_new + soa.transpose(Vxx_new))
        return (Vx_new, Vxx_new), (k_t, K_t)

    (_, _), (ks, Ks) = jax.lax.scan(
        body, (Vx0, Vxx0), (A_, B_, lx_, lu_, lxx_, luu_, lux_), reverse=True
    )
    # (H, n[, m], Bb) -> (Bb, H, n[, m])
    back = lambda x: jnp.moveaxis(x, -1, 0)
    return back(ks), back(Ks)


def riccati_make_elem(inp, reg, I_u):
    """Per-step conditional-value element (F, c, C, eta, J): step k's
    quadratic with u eliminated against its own stage quadratic
    (temporal-parallelization-of-LQT formulation)."""
    A_t, B_t, lx_t, lu_t, lxx_t, luu_t, lux_t = inp
    Ru = luu_t + reg * I_u
    Ru_inv_lux = _solve_psd(Ru, lux_t)
    Ru_inv_lu = _solve_psd(Ru, lu_t)
    Ru_inv_Bt = _solve_psd(Ru, B_t.T)
    F = A_t - B_t @ Ru_inv_lux
    c = -B_t @ Ru_inv_lu
    C = B_t @ Ru_inv_Bt
    J = lxx_t - lux_t.T @ Ru_inv_lux
    eta = -(lx_t - lux_t.T @ Ru_inv_lu)
    return F, c, C, eta, J


def riccati_combine(elem_i, elem_j, I_x):
    """Associative composition: ``elem_i`` is earlier in time; ``elem_j``
    aggregates the later suffix.  Applied with a leading batch axis, so all
    products are batched matmuls and vectors use explicit [..., None].

    The identity element (F=I, c=0, C=0, eta=0, J=0) is a two-sided unit —
    :func:`riccati_identity` — which the horizon-sharded scan
    (parallel/horizon.py) uses for padding and the exclusive prefix."""
    Fi, ci, Ci, etai, Ji = elem_i
    Fj, cj, Cj, etaj, Jj = elem_j

    def mv(M, v):
        return (M @ v[..., None])[..., 0]

    def tr(M):
        return jnp.swapaxes(M, -1, -2)

    # M = (I + Ci Jj)^{-1}; N = (I + Jj Ci)^{-1} — unrolled inverses
    # instead of jnp.linalg.solve's LU loops (ops/linalg_small.py).
    from ..ops.linalg_small import inv_unrolled

    M = inv_unrolled(I_x + Ci @ Jj)
    N = inv_unrolled(I_x + Jj @ Ci)
    F = Fj @ M @ Fi
    c = mv(Fj @ M, ci + mv(Ci, etaj)) + cj
    C = Fj @ M @ Ci @ tr(Fj) + Cj
    eta = mv(tr(Fi) @ N, etaj - mv(Jj, ci)) + etai
    J = tr(Fi) @ N @ Jj @ Fi + Ji
    return F, c, C, eta, J


def riccati_identity(nx, dtype):
    """Two-sided unit of :func:`riccati_combine`."""
    return (
        jnp.eye(nx, dtype=dtype),
        jnp.zeros((nx,), dtype),
        jnp.zeros((nx, nx), dtype),
        jnp.zeros((nx,), dtype),
        jnp.zeros((nx, nx), dtype),
    )


def riccati_gains(inp, Vx, Vxx, reg, I_u):
    """Per-step feedback gains from the step-(k+1) value function —
    identical to the sequential pass's stage equations."""
    A_t, B_t, lx_t, lu_t, lxx_t, luu_t, lux_t = inp
    Qu = lu_t + B_t.T @ Vx
    Quu = luu_t + B_t.T @ Vxx @ B_t + reg * I_u
    Qux = lux_t + B_t.T @ Vxx @ A_t
    k_t = -_solve_psd(Quu, Qu)
    K_t = -_solve_psd(Quu, Qux)
    return k_t, K_t


def riccati_suffix_scan(full, I_x):
    """Suffix-composition scan over a time-leading element pytree:
    ``out[k] = elem_k ⊕ elem_{k+1} ⊕ … ⊕ elem_last``."""
    # Reverse the time axis so the scan accumulates suffixes k..T.  In the
    # reversed order, scan-"left" operands are LATER in time, so flip the
    # operator's arguments: prefix_rev[j] = elem_{T-j} ⊕ (later suffix).
    rev = jax.tree.map(lambda x: jnp.flip(x, axis=0), full)
    scanned = jax.lax.associative_scan(
        lambda a, b: riccati_combine(b, a, I_x), rev, axis=0
    )
    return jax.tree.map(lambda x: jnp.flip(x, axis=0), scanned)


@f32_matmuls
def backward_associative(
    A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, reg, return_values=False
):
    """Riccati backward pass as an associative scan over value elements.

    Each step k contributes a conditional-value element
    ``(F, b, C, eta, J)`` encoding
    ``V_k(x) = min_u [cost + V_{k+1}(f(x,u))]`` after eliminating ``u``
    against its own stage quadratic; elements compose associatively
    (temporal-parallelization-of-LQT formulation), so the whole horizon
    reduces in O(log H) depth instead of O(H).

    Element semantics (suffix form): composing elements k..T yields
    ``J_k = Vxx_k`` and ``eta_k = -Vx_k`` contributions such that the
    feedback gains recovered per-step match the sequential pass.
    """
    nu = B.shape[-1]
    nx = A.shape[-1]
    I_u = jnp.eye(nu, dtype=B.dtype)
    I_x = jnp.eye(nx, dtype=A.dtype)

    # Per-step elimination of u against the stage quadratic (luu + reg):
    #   u* = -luu^{-1}(lu + lux x + B^T lambda) style; in element form:
    #   F = A - B luu^{-1} lux,  c = -B luu^{-1} lu,
    #   C = B luu^{-1} B^T,
    #   J = lxx - lux^T luu^{-1} lux,  eta = -(lx - lux^T luu^{-1} lu)
    elems = jax.vmap(lambda inp: riccati_make_elem(inp, reg, I_u))(
        (A, B, lx, lu, lxx, luu, lux)
    )

    # Terminal element: pure quadratic terminal cost.
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

    suffix = riccati_suffix_scan(full, I_x)

    # suffix[k+1] carries (eta, J) of the value function at step k+1; recover
    # per-step gains exactly like the sequential pass.
    Vx_all = -suffix[3]  # (H+1, nx)
    Vxx_all = suffix[4]  # (H+1, nx, nx)

    ks, Ks = jax.vmap(lambda inp, Vx, Vxx: riccati_gains(inp, Vx, Vxx, reg, I_u))(
        (A, B, lx, lu, lxx, luu, lux), Vx_all[1:], Vxx_all[1:]
    )
    if return_values:
        return ks, Ks, Vx_all, Vxx_all
    return ks, Ks


@f32_matmuls
def backward_associative_soa(
    A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, reg, return_values=False
):
    """Batched O(log H) Riccati backward pass in batch-minor (SoA) layout.

    Same value-element formulation as :func:`backward_associative`, but over
    a whole scenario batch at once: inputs are batch-leading ``(Bb, H, ...)``
    arrays and ``reg`` is per-scenario ``(Bb,)``.  Elements are built as
    ``(H+1, n, m, Bb)`` stacks — the soa ops index matrix dims from the
    right, so the element construction needs no vmap and the
    ``associative_scan`` combine maps over the time axis for free.  This
    composes the batch-minor layout with the O(log H) horizon
    parallelism.
    """
    from ..ops import soa

    nu = B.shape[-1]
    nx = A.shape[-1]
    tr0 = lambda x: jnp.moveaxis(x, 0, -1)  # batch-leading -> batch-minor
    A_, B_, lxx_, luu_, lux_, lx_, lu_ = map(tr0, (A, B, lxx, luu, lux, lx, lu))
    VxT_ = tr0(Vx_T)  # (nx, Bb)
    VxxT_ = tr0(Vxx_T)  # (nx, nx, Bb)
    reg = jnp.asarray(reg, A.dtype)  # (Bb,) or scalar
    eye_u = soa.eye_like(nu, B_)
    eye_x = soa.eye_like(nx, A_)
    Bb = A_.shape[-1]

    # Per-step elements over the whole horizon at once (leading H axis).
    Ru = luu_ + reg * eye_u
    Ru_inv = soa.inv(Ru)
    Ru_inv_lux = soa.matmul(Ru_inv, lux_)
    Ru_inv_lu = soa.matvec(Ru_inv, lu_)
    Ru_inv_Bt = soa.matmul(Ru_inv, soa.transpose(B_))
    luxT = soa.transpose(lux_)
    F = A_ - soa.matmul(B_, Ru_inv_lux)  # (H, nx, nx, Bb)
    c = -soa.matvec(B_, Ru_inv_lu)  # (H, nx, Bb)
    C = soa.matmul(B_, Ru_inv_Bt)  # (H, nx, nx, Bb)
    J = lxx_ - soa.matmul(luxT, Ru_inv_lux)
    eta = -(lx_ - soa.matvec(luxT, Ru_inv_lu))

    zmat = jnp.zeros((1, nx, nx, Bb), A.dtype)
    zvec = jnp.zeros((1, nx, Bb), A.dtype)
    full = (
        jnp.concatenate([F, zmat], axis=0),
        jnp.concatenate([c, zvec], axis=0),
        jnp.concatenate([C, zmat], axis=0),
        jnp.concatenate([eta, -VxT_[None]], axis=0),
        jnp.concatenate([J, VxxT_[None]], axis=0),
    )

    def combine(elem_i, elem_j):
        # elem_i earlier in time, elem_j the later suffix; arrays carry a
        # leading scan axis which the right-indexed soa ops pass through.
        Fi, ci, Ci, etai, Ji = elem_i
        Fj, cj, Cj, etaj, Jj = elem_j
        M = soa.inv(eye_x + soa.matmul(Ci, Jj))
        N = soa.inv(eye_x + soa.matmul(Jj, Ci))
        FjM = soa.matmul(Fj, M)
        FiTN = soa.matmul(soa.transpose(Fi), N)
        F = soa.matmul(FjM, Fi)
        c = soa.matvec(FjM, ci + soa.matvec(Ci, etaj)) + cj
        C = soa.matmul(FjM, soa.matmul(Ci, soa.transpose(Fj))) + Cj
        eta = soa.matvec(FiTN, etaj - soa.matvec(Jj, ci)) + etai
        J = soa.matmul(FiTN, soa.matmul(Jj, Fi)) + Ji
        return F, c, C, eta, J

    rev = jax.tree.map(lambda x: jnp.flip(x, axis=0), full)
    scanned = jax.lax.associative_scan(lambda a, b: combine(b, a), rev, axis=0)
    suffix = jax.tree.map(lambda x: jnp.flip(x, axis=0), scanned)

    Vx_all = -suffix[3]  # (H+1, nx, Bb)
    Vxx_all = suffix[4]  # (H+1, nx, nx, Bb)

    # Per-step gains from the step-(k+1) value, vectorized over H.
    Vx1, Vxx1 = Vx_all[1:], Vxx_all[1:]
    Bt = soa.transpose(B_)
    Qu = lu_ + soa.matvec(Bt, Vx1)
    Quu = luu_ + soa.matmul(Bt, soa.matmul(Vxx1, B_)) + reg * eye_u
    Qux = lux_ + soa.matmul(Bt, soa.matmul(Vxx1, A_))
    Quu_inv = soa.inv(Quu)
    ks = -soa.matvec(Quu_inv, Qu)
    Ks = -soa.matmul(Quu_inv, Qux)

    back = lambda x: jnp.moveaxis(x, -1, 0)  # batch-minor -> batch-leading
    if return_values:
        return back(ks), back(Ks), back(Vx_all), back(Vxx_all)
    return back(ks), back(Ks)


@f32_matmuls
def forward_linesearch(system: System, xs, us, ks, Ks, alphas):
    """Closed-loop rollouts at every alpha in parallel; returns best."""
    alphas = jnp.asarray(alphas, dtype=us.dtype)

    def rollout_alpha(alpha):
        def body(x, inp):
            x_ref, u_ref, k_t, K_t = inp
            u = u_ref + alpha * k_t + K_t @ (x - x_ref)
            xn = system.step(x, u)
            return xn, (xn, u)

        _, (xs_tail, us_new) = jax.lax.scan(body, xs[0], (xs[:-1], us, ks, Ks))
        xs_new = jnp.concatenate([xs[0][None], xs_tail], axis=0)
        return xs_new, us_new, trajectory_cost(system, xs_new, us_new)

    xs_c, us_c, costs = jax.vmap(rollout_alpha)(alphas)
    best = jnp.argmin(costs)
    return (
        jnp.take(xs_c, best, axis=0),
        jnp.take(us_c, best, axis=0),
        jnp.take(costs, best, axis=0),
    )


@f32_matmuls
def forward_linesearch_soa(system: System, xs, us, ks, Ks, alphas):
    """Batched closed-loop line search in batch-minor SoA layout.

    Same semantics as ``vmap(forward_linesearch)`` over a scenario batch,
    but states are carried as ``(nx, n_alpha, Bb)`` stacks so every vector
    op runs over scenarios in the minor axis (requires
    ``system.batch_polymorphic``; see ops/soa.py for the layout argument).
    Inputs/outputs are batch-leading: xs (Bb, H+1, nx), us (Bb, H, nu),
    ks (Bb, H, nu), Ks (Bb, H, nu, nx).
    """
    nA = len(alphas)
    alphas = jnp.asarray(alphas, dtype=us.dtype)  # (nA,)
    # (Bb, H, ...) -> (H, ..., Bb): one boundary transpose each.
    xs_, us_, ks_, Ks_ = (jnp.moveaxis(a, 0, -1) for a in (xs, us, ks, Ks))
    al = alphas[:, None]  # (nA, 1) broadcasts against (nA, Bb)

    x0 = jnp.broadcast_to(
        xs_[0][:, None, :], (xs_.shape[1], nA, xs_.shape[2])
    )  # (nx, nA, Bb)

    def body(carry, inp):
        x, cost = carry
        x_ref, u_ref, k_t, K_t = inp  # (nx,Bb), (nu,Bb), (nu,Bb), (nu,nx,Bb)
        dx = x - x_ref[:, None, :]  # (nx, nA, Bb)
        # u = u_ref + alpha*k + K @ dx, all (nu, nA, Bb)
        u = jnp.stack(
            [
                u_ref[i][None, :]
                + al * k_t[i][None, :]
                + sum(K_t[i, j][None, :] * dx[j] for j in range(dx.shape[0]))
                for i in range(u_ref.shape[0])
            ]
        )
        cost = cost + system.stage_cost(x, u)  # (nA, Bb)
        xn = system.step(x, u)
        return (xn, cost), (xn, u)

    (x_fin, run_cost), (xs_tail, us_new) = jax.lax.scan(
        body, (x0, jnp.zeros((nA, xs.shape[0]), xs.dtype)),
        (xs_[:-1], us_, ks_, Ks_),
    )
    costs = run_cost + system.final_cost(x_fin)  # (nA, Bb)
    best = jnp.argmin(costs, axis=0)  # (Bb,)

    def pick(stacked):  # (H, d, nA, Bb) -> (Bb, H, d)
        g = jnp.take_along_axis(stacked, best[None, None, None, :], axis=2)
        return jnp.moveaxis(g[:, :, 0, :], -1, 0)

    xs_best = pick(xs_tail)
    us_best = pick(us_new)
    xs_new = jnp.concatenate([xs[:, :1], xs_best], axis=1)
    cost_best = jnp.take_along_axis(costs, best[None, :], axis=0)[0]
    return xs_new, us_best, cost_best


@f32_matmuls
def solve(
    system: System,
    x0,
    us_init,
    config: ILQRConfig = ILQRConfig(),
) -> ILQRResult:
    """Single-scenario iLQR solve (jit/vmap-friendly; static iteration
    count)."""
    backward = (
        backward_associative
        if config.backward == "associative"
        else backward_sequential
    )

    xs0 = rollout(system.step, x0, us_init)
    cost0 = trajectory_cost(system, xs0, us_init)

    def iteration(carry, _):
        xs, us, cost, reg = carry
        A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T = linearize(system, xs, us)
        psd_mode = config.psd
        if psd_mode == "auto":
            psd_mode = "clamp_diag" if system.separable_cost else "eigh"
        lxx, luu, lux, Vxx_T = psd_cost_hessians(
            lxx, luu, lux, Vxx_T, psd_mode, config.psd_eps
        )
        ks, Ks = backward(A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, reg)
        xs_new, us_new, cost_new = forward_linesearch(
            system, xs, us, ks, Ks, config.alphas
        )
        # NaN-robust accept: an indefinite Quu makes the Cholesky emit NaNs
        # and the candidate rollout non-finite; reject it and retry with a
        # larger regularizer next iteration (standard iLQR reg escalation).
        improved = jnp.isfinite(cost_new) & (cost_new < cost)
        xs = jnp.where(improved, xs_new, xs)
        us = jnp.where(improved, us_new, us)
        reg = jnp.where(
            improved,
            jnp.maximum(reg * config.reg_scale_down, config.reg_init),
            jnp.minimum(reg * config.reg_scale_up, config.reg_max),
        )
        cost = jnp.where(improved, cost_new, cost)
        grad_norm = jnp.nan_to_num(jnp.max(jnp.abs(ks)), nan=jnp.inf)
        return (xs, us, cost, reg), (cost, grad_norm)

    init = (xs0, us_init, cost0, jnp.asarray(config.reg_init, xs0.dtype))
    (xs, us, cost, _), (cost_trace, grad_norms) = jax.lax.scan(
        iteration, init, None, length=config.iterations
    )
    return ILQRResult(
        xs=xs, us=us, cost=cost, cost_trace=cost_trace, grad_norm=grad_norms[-1]
    )


@f32_matmuls
def solve_batched(
    system: System, x0_batch, us_init_batch, config: ILQRConfig = ILQRConfig()
) -> ILQRResult:
    """Batched solve over the scenario axis — thousands of solves per chip
    (BASELINE.json configs 3-4).

    Rollout/linearize/line-search stages vmap over scenarios (their hot
    loops are already wide).  The Riccati backward pass — the dominant cost
    at scale — runs in batch-minor SoA layout
    (:func:`backward_sequential_soa`, or :func:`backward_associative_soa`
    for ``backward="associative"``, which adds O(log H) horizon parallelism
    on top of the batch-minor layout).  Semantics match ``vmap(solve)``
    exactly up to f32 summation order.
    """
    backward_b = (
        backward_associative_soa
        if config.backward == "associative"
        else backward_sequential_soa
    )

    rollout_b = jax.vmap(lambda x0, us: rollout(system.step, x0, us))
    cost_b = jax.vmap(lambda xs, us: trajectory_cost(system, xs, us))
    if system.batch_polymorphic:
        lin_b = lambda xs, us: linearize_soa(system, xs, us)
    else:
        lin_b = jax.vmap(lambda xs, us: linearize(system, xs, us))
    if system.batch_polymorphic:
        fwd_b = lambda xs, us, ks, Ks: forward_linesearch_soa(
            system, xs, us, ks, Ks, config.alphas
        )
    else:
        fwd_b = jax.vmap(
            lambda xs, us, ks, Ks: forward_linesearch(
                system, xs, us, ks, Ks, config.alphas
            )
        )

    xs0 = rollout_b(x0_batch, us_init_batch)
    cost0 = cost_b(xs0, us_init_batch)
    psd_mode = config.psd
    if psd_mode == "auto":
        psd_mode = "clamp_diag" if system.separable_cost else "eigh"

    def iteration(carry, _):
        xs, us, cost, reg = carry  # cost, reg: (Bb,)
        A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T = lin_b(xs, us)
        lxx, luu, lux, Vxx_T = psd_cost_hessians(
            lxx, luu, lux, Vxx_T, psd_mode, config.psd_eps
        )
        ks, Ks = backward_b(A, B, lx, lu, lxx, luu, lux, Vx_T, Vxx_T, reg)
        xs_new, us_new, cost_new = fwd_b(xs, us, ks, Ks)
        improved = jnp.isfinite(cost_new) & (cost_new < cost)
        xs = jnp.where(improved[:, None, None], xs_new, xs)
        us = jnp.where(improved[:, None, None], us_new, us)
        reg = jnp.where(
            improved,
            jnp.maximum(reg * config.reg_scale_down, config.reg_init),
            jnp.minimum(reg * config.reg_scale_up, config.reg_max),
        )
        cost = jnp.where(improved, cost_new, cost)
        grad_norm = jnp.nan_to_num(
            jnp.max(jnp.abs(ks), axis=(1, 2)), nan=jnp.inf
        )
        return (xs, us, cost, reg), (cost, grad_norm)

    init = (
        xs0,
        us_init_batch,
        cost0,
        jnp.full(cost0.shape, config.reg_init, xs0.dtype),
    )
    (xs, us, cost, _), (cost_trace, grad_norms) = jax.lax.scan(
        iteration, init, None, length=config.iterations
    )
    # Batch-leading result fields; cost_trace comes out (iters, Bb).
    return ILQRResult(
        xs=xs,
        us=us,
        cost=cost,
        cost_trace=jnp.moveaxis(cost_trace, 0, 1),
        grad_norm=grad_norms[-1],
    )


@functools.partial(jax.jit, static_argnums=(0, 3))
def solve_batched_jit(system, x0_batch, us_init_batch, config=ILQRConfig()):
    return solve_batched(system, x0_batch, us_init_batch, config)
