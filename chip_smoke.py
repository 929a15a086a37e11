"""Drive the main path once on one GPU and check what comes out.

Run from the repository root, on a machine with an NVIDIA GPU:

    python chip_smoke.py          # one card, every phase
    python chip_smoke.py --four   # the four-card path only (four cards)

Phases: the device; the array front end at real widths against NumPy; the
iterated ``sm.fuse`` against a plain ``lax.fori_loop``; the flagship batched
cartpole solve, re-solved in float64 on the card; closed-loop quadrotor
replanning; the max ulp error of the native and crafted transcendentals.
Each phase prints one line per check: what it compared, the tolerance, the
precision, and a time where one helps.  A failed check fails its phase, and
a failed phase makes the script exit non-zero without the result line.

The last line of standard output is the device as JAX reports it:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

from __future__ import annotations

import argparse
import json
import operator
import sys
import time
import traceback

import numpy as np


class CheckFailed(AssertionError):
    pass


def check(ok: bool, line: str) -> None:
    print(("  ok   " if ok else "  FAIL ") + line, flush=True)
    if not ok:
        raise CheckFailed(line)


def max_rel(got, want, floor=1e-30) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), floor)))


def allclose(got, want, rtol, atol) -> tuple[bool, str]:
    """``np.allclose`` and the measured gap, as text for the check line."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ok = bool(np.allclose(got, want, rtol=rtol, atol=atol))
    gap = np.abs(got - want)
    return ok, (f"max abs {gap.max():.2e}, max rel {max_rel(got, want):.2e} "
                f"(rtol {rtol:g} atol {atol:g})")


def rel_fro(got, want) -> float:
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def timed(fn, *args, repeats: int = 5):
    """(first call incl. compile, median steady call) in seconds, each
    ending in block_until_ready."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, sorted(ts)[len(ts) // 2]


def ulp_err(got, want, mask) -> float:
    want32 = np.where(mask, want, 1.0).astype(np.float32)
    ulp = np.spacing(np.abs(want32)).astype(np.float64)
    err = np.abs(np.asarray(got, np.float64) - want) / ulp
    return float(np.max(err[mask]))


# --------------------------------------------------------------- phases
def phase_device(ctx):
    import jax

    from simplemath_tpu.utils import device

    devs = jax.devices()
    print(f"  device_kind={devs[0].device_kind} count={len(devs)}")
    print(f"  compile cache: {ctx['cache']}")
    check(devs[0].platform == "gpu", f"platform={devs[0].platform}")
    ctx["card"] = device.card_info()


def phase_array(ctx):
    import jax
    import jax.numpy as jnp

    import simplemath_tpu as sm
    from simplemath_tpu.ops import dispatch
    from simplemath_tpu.ops.lazy import LazyArray

    rng = np.random.default_rng(ctx["seed"])
    n = 1_000_000
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.uniform(0.5, 2.0, n).astype(np.float32)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    for sym, op in (("+", operator.add), ("-", operator.sub),
                    ("*", operator.mul), ("/", operator.truediv)):
        got = op(sm.Array(a), sm.Array(b)).numpy()
        err = max_rel(got, op(a64, b64))
        check(err <= 1e-6, f"({n},) {sym} ({n},) f32 vs NumPy f64: "
              f"max rel {err:.2e} <= 1e-6")

    r, c = 8192, 8192
    X = rng.standard_normal((r, c), dtype=np.float32)
    col = rng.standard_normal((r, 1), dtype=np.float32)
    got = (sm.Array(X) + sm.Array(col)).numpy()
    err = max_rel(got, X.astype(np.float64) + col)
    check(err <= 1e-6, f"({r},{c}) + ({r},1) broadcast f32: max rel "
          f"{err:.2e} <= 1e-6")

    dispatch.reset()
    x, y = sm.Array(a), sm.Array(b)
    chain = sm.sqrt(sm.abs(sm.pow(x, 2) + 3.0) * y) - 1.5
    pending = isinstance(chain, LazyArray) and chain._pending is not None
    got = chain.numpy()
    programs = {k: v for k, v in dispatch.counts().items()
                if k.startswith("elementwise:")}
    want = np.sqrt(np.abs(a64 ** 2 + 3.0) * b64) - 1.5
    err = max_rel(got, want, floor=1.0)
    check(pending and programs == {"elementwise:fused": 1} and err <= 2e-6,
          f"deferred 6-op chain: one program {programs}, max "
          f"|err|/max(|x|,1) {err:.2e} <= 2e-6")

    m = 2048
    M = rng.standard_normal((m, m), dtype=np.float32)
    A = sm.Array(M.copy())
    mirror = M.copy()
    t = A.T
    v = A[m // 20: m // 2: 2, 7: m // 2 + 7]
    ok = np.array_equal((t + 1.0).numpy(), mirror.T + np.float32(1.0))
    ok &= np.array_equal((v * 2.0).numpy(), mirror[m // 20: m // 2: 2, 7: m // 2 + 7] * 2)
    v[0, 0] = 5.0
    mirror[m // 20, 7] = 5.0
    v[1:3, :] = np.zeros((2, v.shape[1]), np.float32)
    mirror[m // 20 + 2: m // 20 + 6: 2, 7: m // 2 + 7] = 0.0
    t[3, :] = np.arange(m, dtype=np.float32)
    mirror[:, 3] = np.arange(m, dtype=np.float32)
    ok &= np.array_equal(A.numpy(), mirror) and np.array_equal(t.numpy(), mirror.T)
    check(bool(ok), f"({m},{m}) transpose and stepped-slice views: read "
          "and written through, exact")

    X64 = X.astype(np.float64)
    absx = np.abs(X64)
    for axis in (None, 0, 1):
        got = np.asarray(sm.Array(X).sum(axis=axis).jax(), np.float64)
        err = float(np.max(np.abs(got - X64.sum(axis=axis))
                           / absx.sum(axis=axis)))
        check(err <= 1e-5, f"sum(axis={axis}) f32 of ({r},{c}): |err|/sum|x| "
              f"{err:.2e} <= 1e-5")
        got = np.asarray(sm.max(sm.Array(X), axis=axis).jax())
        check(np.array_equal(got, X.max(axis=axis)),
              f"max(axis={axis}) of ({r},{c}): exact")

    P = rng.uniform(0.5, 2.0, (m, m)).astype(np.float32)
    E = rng.uniform(-2.0, 2.0, (1, m)).astype(np.float32)
    pipeline = sm.fuse(lambda x, e: sm.exp(sm.pow(x, e)))
    got = pipeline(P, E).numpy()
    err = max_rel(got, np.exp(np.power(P.astype(np.float64), E)))
    f = jax.jit(lambda x, e: pipeline(x, e).jax())
    _, t_pipe = timed(f, jnp.asarray(P), jnp.asarray(E))
    check(err <= 2e-5, f"fuse exp(pow(x, e_row)) ({m},{m}) f32: max rel "
          f"{err:.2e} <= 2e-5, {t_pipe * 1e6:.1f} us")

    k = 2048
    Af = rng.standard_normal((k, k), dtype=np.float32)
    Bf = rng.standard_normal((k, k), dtype=np.float32)
    want = Af.astype(np.float64) @ Bf.astype(np.float64)
    for name, fn in (("dot", sm.dot), ("matmul", sm.matmul)):
        err = rel_fro(fn(sm.Array(Af), sm.Array(Bf)).numpy(), want)
        check(err <= 5e-3, f"sm.{name} f32 ({k},{k})@({k},{k}) at platform "
              f"default precision (TF32 on the H100): rel fro {err:.2e} <= 5e-3")
    As, Bs = Af[:200, :300], Bf[:300, :180]
    err = rel_fro(sm.matmul(sm.Array(As), sm.Array(Bs)).numpy(),
                  As.astype(np.float64) @ Bs)
    check(err <= 1e-5, f"sm.matmul f32 (200,300)@(300,180) at HIGHEST: rel "
          f"fro {err:.2e} <= 1e-5")

    Ab = jnp.asarray(Af, jnp.bfloat16)
    Bb = jnp.asarray(Bf, jnp.bfloat16)
    got = sm.matmul(sm.Array(Ab), sm.Array(Bb)).numpy().astype(np.float64)
    err = rel_fro(got, np.asarray(Ab, np.float64) @ np.asarray(Bb, np.float64))
    check(err <= 1e-4, f"sm.matmul bf16 ({k},{k})@({k},{k}), f32 accumulate and out: "
          f"rel fro {err:.2e} <= 1e-4")

    Aq = rng.integers(-127, 128, (k, k), dtype=np.int8)
    Bq = rng.integers(-127, 128, (k, k), dtype=np.int8)
    want = Aq.astype(np.int64) @ Bq.astype(np.int64)
    got = sm.int8_matmul(Aq, Bq).numpy()
    check(got.dtype == np.int32 and np.array_equal(got, want),
          f"sm.int8_matmul ({k},{k}) s8xs8->s32: exact")
    scale = rng.uniform(1e-4, 1e-2, (1, k)).astype(np.float32)
    got = sm.int8_matmul(Aq, Bq, scale=scale).numpy()
    err = max_rel(got, want * scale.astype(np.float64))
    check(err <= 1e-6, f"sm.int8_matmul with per-channel dequant scale: max "
          f"rel {err:.2e} <= 1e-6")

    Ac = (Af + 1j * Bf).astype(np.complex64)
    Bc = (Bf - 1j * Af).astype(np.complex64)
    err = rel_fro(sm.dot(sm.Array(Ac), sm.Array(Bc)).numpy(),
                  Ac.astype(np.complex128) @ Bc.astype(np.complex128))
    check(err <= 5e-3, f"sm.dot complex64 ({k},{k}) at platform default "
          f"precision: rel fro {err:.2e} <= 5e-3")


def _recurrences():
    import jax.numpy as jnp

    import simplemath_tpu as sm
    from simplemath_tpu.ops import transcendental as tc

    def ema_sm(acc, x):
        return acc * 0.9 + sm.square(x)

    def ema_jnp(acc, x):
        return acc * np.float32(0.9) + jnp.square(x)

    def powexp_sm(acc, a, e):
        return acc * 1e-3 + sm.exp(sm.pow(a + acc * 1e-6, e))

    def powexp_jnp(acc, a, e):
        return acc * np.float32(1e-3) + jnp.exp(
            jnp.power(a + acc * np.float32(1e-6), e)
        )

    # auto takes the crafted tanh and exp2 on the card (phase 6), so this
    # runs the crafted code inside the kernel; the reference loop calls the
    # same crafted functions, compiled by XLA.
    def crafted_sm(acc, x):
        return acc * 0.5 + sm.exp2(sm.tanh(x + acc * 0.1))

    def crafted_jnp(acc, x):
        return acc * np.float32(0.5) + tc.exp2_f32(
            tc.tanh_f32(x + acc * np.float32(0.1))
        )

    return {"ema": (ema_sm, ema_jnp), "powexp": (powexp_sm, powexp_jnp),
            "crafted": (crafted_sm, crafted_jnp)}


def phase_fuse_loop(ctx):
    import jax
    import jax.numpy as jnp

    import simplemath_tpu as sm
    from simplemath_tpu.ops import dispatch

    rng = np.random.default_rng(ctx["seed"] + 1)
    for side in (2048, 8192):
        shape = (side, side)
        acc0 = jnp.asarray(rng.uniform(0.0, 1.0, shape).astype(np.float32))
        xs = {
            "ema": [jnp.asarray(rng.standard_normal(shape, dtype=np.float32))],
            "powexp": [
                jnp.asarray(rng.uniform(0.5, 2.0, shape).astype(np.float32)),
                jnp.asarray(rng.uniform(-2.0, 2.0, shape).astype(np.float32)),
            ],
        }
        xs["crafted"] = xs["ema"]
        for L in (16, 400):
            for name, (f_sm, f_jnp) in _recurrences().items():
                fused = sm.fuse(f_sm, iterations=L)
                lib = jax.jit(lambda acc, *x, fused=fused: fused(acc, *x).jax())

                def ref_fn(acc, *x, f_jnp=f_jnp, L=L):
                    return jax.lax.fori_loop(
                        0, L, lambda i, c: f_jnp(c, *x), acc
                    )

                ref = jax.jit(ref_fn)
                dispatch.reset()
                got = np.asarray(lib(acc0, *xs[name]))
                routed = dispatch.count("fuse_loop", "triton")
                want = np.asarray(ref(acc0, *xs[name]))
                err = max_rel(got, want, floor=1e-6)
                _, t_lib = timed(lib, acc0, *xs[name])
                _, t_ref = timed(ref, acc0, *xs[name])
                check(
                    err <= 1e-5 and routed == 1,
                    f"fuse {name} L={L} ({side},{side}) f32 vs lax.fori_loop: "
                    f"max rel {err:.2e} <= 1e-5; triton kernel "
                    f"{t_lib * 1e3:.3f} ms, XLA fori_loop {t_ref * 1e3:.3f} ms "
                    f"({t_ref / t_lib:.2f}x)",
                )


def phase_solve(ctx):
    import jax
    import jax.numpy as jnp

    from simplemath_tpu.models import ILQRConfig, make_cartpole
    from simplemath_tpu.models.ilqr import rollout, solve_batched, trajectory_cost

    batch, horizon, iters = 8192, 100, 10
    system = make_cartpole()
    cfg = ILQRConfig(iterations=iters)
    key = jax.random.PRNGKey(ctx["seed"])
    x0s = 0.2 * jax.random.normal(key, (batch, system.nx), dtype=jnp.float32)
    us = jnp.zeros((batch, horizon, system.nu), jnp.float32)
    solve = jax.jit(lambda x, u: solve_batched(system, x, u, cfg))
    t0 = time.perf_counter()
    compiled = solve.lower(x0s, us).compile()
    first = time.perf_counter() - t0
    print(f"  memory_analysis: {compiled.memory_analysis()}")
    _, t = timed(compiled, x0s, us, repeats=3)
    res = compiled(x0s, us)
    cost0 = jax.vmap(
        lambda x0, u: trajectory_cost(system, rollout(system.step, x0, u), u)
    )(x0s, us)
    trace = np.asarray(res.cost_trace)
    cost = np.asarray(res.cost)
    monotone = bool(np.all(np.diff(trace, axis=1) <= 0)
                    and np.all(trace[:, 0] <= np.asarray(cost0)))
    check(bool(np.isfinite(cost).all()) and monotone,
          f"cartpole {batch}x{horizon}x{iters} iLQR: every cost finite and "
          f"non-increasing; {batch / t:.0f} solves/s ({t * 1e3:.1f} ms per "
          f"solve batch; compile {first:.1f} s)")

    k = 16
    x64 = jnp.asarray(np.asarray(x0s[:k]), jnp.float64)
    u64 = jnp.zeros((k, horizon, system.nu), jnp.float64)
    res64 = jax.jit(lambda x, u: solve_batched(system, x, u, cfg))(x64, u64)
    check(res64.cost.dtype == jnp.float64, "float64 re-solve runs in float64")
    err = max_rel(cost[:k], np.asarray(res64.cost))
    check(err <= 5e-3, f"{k} scenarios f32 vs float64 re-solve on the card: "
          f"max rel cost {err:.2e} <= 5e-3")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak_bytes_in_use={stats.get('peak_bytes_in_use')} "
          f"card={ctx.get('card', 'n/a')}")


def phase_replan(ctx):
    import jax
    import jax.numpy as jnp

    from simplemath_tpu.models import make_quadrotor
    from simplemath_tpu.models.rti import rti_closed_loop

    system = make_quadrotor()
    horizon, ticks = 50, 200
    x0 = 0.1 * jax.random.normal(
        jax.random.PRNGKey(ctx["seed"]), (system.nx,), dtype=jnp.float32
    )
    loop = jax.jit(lambda x: rti_closed_loop(system, x, horizon, ticks))
    _, t = timed(loop, x0, repeats=3)
    xs, us, costs, defects = (np.asarray(v) for v in loop(x0))
    finite = all(np.isfinite(v).all() for v in (xs, us, costs, defects))
    bounded = float(defects.max()) < 10.0 and defects[-1] <= defects[0] + 1e-3
    check(finite and bounded,
          f"quadrotor RTI H={horizon}, {ticks} ticks: states finite, defects "
          f"{defects[0]:.2e} -> {defects[-1]:.2e} (max {defects.max():.2e} < "
          f"10); {t / ticks * 1e6:.1f} us per tick")


def _transcendental_domains():
    rng = np.random.default_rng(0)
    trig = np.concatenate([
        np.linspace(-2 * np.pi, 2 * np.pi, 50_001),
        np.linspace(-1e3, 1e3, 20_001),
        rng.uniform(1e4, 3e7, 10_000) * rng.choice([-1.0, 1.0], 10_000),
    ]).astype(np.float32)
    tanh = np.concatenate([
        np.linspace(-30, 30, 50_001), np.linspace(-0.6, 0.6, 50_001),
        [0.0, 1e-8, 0.5, 9.2, 100.0],
    ]).astype(np.float32)
    return {
        "exp": np.linspace(-87.0, 88.0, 200_001).astype(np.float32),
        "log": np.logspace(-37, 38, 200_001).astype(np.float32),
        "exp2": np.linspace(-120.0, 120.0, 50_001).astype(np.float32),
        "log2": np.logspace(-30, 30, 50_001).astype(np.float32),
        "tanh": tanh,
        "sin": trig,
        "cos": trig,
        "tan": trig,
    }


def phase_transcendental(ctx):
    import jax
    import jax.numpy as jnp

    from simplemath_tpu.ops import transcendental as tc

    contract = 4.0
    crafted = {"exp": tc.exp_f32, "log": tc.log_f32, "exp2": tc.exp2_f32,
               "log2": tc.log2_f32, "tanh": tc.tanh_f32}
    for name, x in _transcendental_domains().items():
        want = getattr(np, name)(x.astype(np.float64))
        mask = np.isfinite(want) & (np.abs(want) > 1.2e-38) & (np.abs(want) < 3.4e38)
        if name in ("sin", "cos", "tan", "tanh"):
            # As the tests: relative bounds away from zeros and tan's poles.
            mask &= (np.abs(want) > 1e-3) & (np.abs(want) < 1e6)
        native = ulp_err(jax.jit(getattr(jnp, name))(x), want, mask)
        line = f"{name}: native {native:.2f} ulp"
        auto = native
        if name in crafted:
            mine = ulp_err(jax.jit(crafted[name])(x), want, mask)
            line += f", crafted {mine:.2f} ulp"
            auto = native if tc._resolve_impl(name, "auto") == "native" else mine
        check(auto <= contract,
              f"{line}; auto takes {tc._resolve_impl(name, 'auto')} "
              f"({auto:.2f} <= {contract} ulp)")
    bases = np.logspace(-10, 10, 201).astype(np.float32)
    exps = np.array([-3.0, -1.5, -1.0, -0.5, 0.5, 1.0, 2.0, 3.0, 7.5], np.float32)
    b, e = np.meshgrid(bases, exps)
    want = np.power(b.astype(np.float64), e.astype(np.float64))
    mask = (want < 3.4e38) & (want > 1.2e-38)
    native = ulp_err(jax.jit(jnp.power)(b, e), want, mask)
    mine = ulp_err(jax.jit(tc.pow_f32)(b, e), want, mask)
    auto = native if tc._resolve_impl("pow", "auto") == "native" else mine
    check(auto <= contract, f"pow: native {native:.2f} ulp, crafted "
          f"{mine:.2f} ulp; auto takes {tc._resolve_impl('pow', 'auto')}")


def phase_four(ctx):
    import functools

    import jax
    import jax.numpy as jnp

    from simplemath_tpu import parallel
    from simplemath_tpu.models import ILQRConfig, ilqr, make_cartpole, make_quadrotor
    from simplemath_tpu.models.sqp_mpc import make_scenario_mpc_step
    from simplemath_tpu.parallel import horizon

    devs = jax.devices()
    check(len(devs) == 4, f"four devices: {len(devs)} x {devs[0].device_kind}")
    mesh = parallel.make_mesh((4,), ("scenario",), devices=devs)
    tol = dict(rtol=1e-5, atol=1e-6)

    batch, H = 8192, 100
    system = make_cartpole()
    cfg = ILQRConfig(iterations=10)
    x0s = 0.2 * jax.random.normal(
        jax.random.PRNGKey(ctx["seed"]), (batch, system.nx), dtype=jnp.float32
    )
    us = jnp.zeros((batch, H, system.nu), jnp.float32)
    step = parallel.make_sharded_train_step(system, mesh, cfg, "scenario")
    one = jax.jit(lambda x, u: ilqr.solve_batched(system, x, u, cfg))
    # Equality in float64: in float32 the line search of a few scenarios
    # flips on last-bit differences between the two compiled programs,
    # which says nothing about the sharding.
    x64, u64 = x0s.astype(jnp.float64), us.astype(jnp.float64)
    res4, stats = step(x64, u64)
    ref = one(x64, u64)
    for name, got, want in (("cost", res4.cost, ref.cost), ("us", res4.us, ref.us)):
        ok, gap = allclose(got, want, **tol)
        check(ok, f"solve_batched_sharded {batch}x{H} float64 on a 1-D 4-card "
              f"mesh vs one card: {name} {gap}")
    total = float(stats["total_cost"])
    err = abs(total - float(np.asarray(ref.cost).sum())) / abs(total)
    check(err <= 1e-5, f"psum total cost vs one-card sum: rel {err:.2e} <= 1e-5")
    _, t4 = timed(step, x0s, us, repeats=3)
    _, t1 = timed(one, x0s, us, repeats=3)
    err = max_rel(step(x0s, us)[0].cost, one(x0s, us).cost)
    check(err <= 5e-3, f"float32 4-card vs one-card costs: max rel {err:.2e} "
          "<= 5e-3 (the f32 parity bound); 4 cards "
          f"{t4 * 1e3:.1f} ms ({batch / t4:.0f} solves/s), one card "
          f"{t1 * 1e3:.1f} ms ({batch / t1:.0f} solves/s)")

    hmesh = parallel.make_mesh((4,), ("h",), devices=devs)
    Hh = 1001
    x0 = jnp.zeros((system.nx,), jnp.float32).at[1].set(0.3)
    u1 = 0.01 * jnp.ones((Hh, system.nu), jnp.float32)
    xs1 = ilqr.rollout(system.step, x0, u1)
    A, Bm, lx, lu, lxx, luu, lux, VxT, VxxT = ilqr.linearize(system, xs1, u1)
    lxx, luu, lux, VxxT = ilqr.psd_cost_hessians(
        lxx, luu, lux, VxxT, "clamp_diag", 1e-6
    )
    lin = (A, Bm, lx, lu, lxx, luu, lux, VxT, VxxT)
    reg = jnp.float32(1e-6)
    ks, Ks = jax.jit(functools.partial(
        horizon.backward_associative_sharded, hmesh, "h"))(*lin, reg)
    ks_r, Ks_r = jax.jit(ilqr.backward_associative)(*lin, reg)
    for name, got, want in (("ks", ks, ks_r), ("Ks", Ks, Ks_r)):
        ok, gap = allclose(got, want, **tol)
        check(ok, f"backward_associative_sharded H={Hh} over 4 cards vs "
              f"ilqr.backward_associative: {name} {gap}")

    # The consensus step: a psum of first-step KKT blocks and a line search
    # over the mesh-wide cost, on the quadrotor.  Equal in float64.  In
    # float32 the psum adds the 64 blocks in another order than one device
    # does: du0 moves by a few ulps and the closed-loop rollouts carry that
    # into every control, so controls near zero miss atol 1e-6.  (Summing
    # the blocks in float64 makes the float32 results bit-equal.)  float32
    # is held to the f32 parity bound, relative to the largest value.
    quad = make_quadrotor()
    nb, Hq = 64, 50
    step4 = jax.jit(make_scenario_mpc_step(quad, mesh))
    mesh1 = parallel.make_mesh((1,), ("scenario",), devices=devs[:1])
    step1 = jax.jit(make_scenario_mpc_step(quad, mesh1))
    xq = 0.3 * jax.random.normal(
        jax.random.PRNGKey(ctx["seed"] + 1), (nb, quad.nx), dtype=jnp.float64
    )
    uq = jnp.zeros((nb, Hq, quad.nu), jnp.float64)
    for dtype in (jnp.float64, jnp.float32):
        x, u = xq.astype(dtype), uq.astype(dtype)
        us4, du4, st4 = step4(x, u)
        us1, du1, st1 = step1(x, u)
        for name, got, want in (("us", us4, us1), ("du0", du4, du1),
                                ("total_cost", st4["total_cost"],
                                 st1["total_cost"])):
            label = (f"scenario MPC step (quadrotor {nb}x{Hq}, "
                     f"{jnp.dtype(dtype).name}) over 4 cards vs a 1-device "
                     f"mesh: {name}")
            if dtype == jnp.float64:
                ok, gap = allclose(got, want, **tol)
                check(ok, f"{label} {gap}")
            else:
                got = np.asarray(got, np.float64)
                want = np.asarray(want, np.float64)
                err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
                check(err <= 5e-3, f"{label} max |err|/max|x| {err:.2e} <= "
                      f"5e-3 (max rel {max_rel(got, want):.2e})")


PHASES = [
    ("device", phase_device),
    ("array front end", phase_array),
    ("iterated fuse", phase_fuse_loop),
    ("flagship solve", phase_solve),
    ("replan", phase_replan),
    ("transcendental accuracy", phase_transcendental),
]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--four", action="store_true",
                        help="run only the four-card path and its reference")
    args = parser.parse_args()

    import jax

    jax.config.update("jax_enable_x64", True)
    from simplemath_tpu.utils import device

    device.require_gpu()
    ctx = {"seed": args.seed, "cache": device.enable_compile_cache()}
    phases = [PHASES[0], ("four cards", phase_four)] if args.four else PHASES
    failed = []
    for name, fn in phases:
        print(f"[{name}]", flush=True)
        t0 = time.perf_counter()
        try:
            fn(ctx)
        except Exception:
            traceback.print_exc()
            failed.append(name)
        print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    if failed:
        print(f"FAILED phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(ctx["card"])
    print(json.dumps({"ok": True, "device": device.describe()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
