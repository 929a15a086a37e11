"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline: cartpole iLQR solves/s on one card at H=100, 8192 scenarios, 10
iLQR iterations per solve.  The other rows (array ops, matmuls, the
iterated fuse, solver and replan variants) go to stderr and to
``bench_details.json``.

Timing: every row is jitted, run once to compile, then timed as the median
of several calls that each end in ``block_until_ready``.  Rows that loop an
op L times on the device report the per-iteration time (the loop's time
over L).  Every result names the device (``device_kind``, count, the card's
name and power limit); the script exits when JAX finds no GPU.

Run: ``python bench.py`` (full sizes) / ``python bench.py --quick`` (small
shapes).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def _timeit(fn, make_args, warmup: int = 1, repeats: int = 5):
    """Median seconds of ``jit(fn)(*make_args(0))`` after ``warmup``
    calls, each call ending in block_until_ready."""
    fn = jax.jit(fn)
    args = make_args(0)
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _per_iter_time(build_run, make_args, iterations, repeats=5):
    """Seconds per iteration of ``build_run(iterations)``, whose body loops
    on the device with a loop-carried dependency."""
    return _timeit(build_run(iterations), make_args, repeats=repeats) / iterations


def _peak(name):
    from simplemath_tpu.utils.profiling import peaks

    return peaks()[name]


def bench_million_add(n=1_000_000):
    """Reference million_check (benchmark/add.cpp:21-29): 1M-float add
    through the PUBLIC ``sm.add`` path, looped on the device.  The
    reference's number to beat is 666,833 ns wall (README.md:141-145)."""
    import simplemath_tpu as sm

    def build_run(L):
        def run(a, b):
            def body(i, acc):
                return sm.add(sm.Array(acc), sm.Array(b)).jax()

            return jax.lax.fori_loop(0, L, body, a)

        return run

    def make_args(i):
        ka, kb = jax.random.split(jax.random.PRNGKey(i))
        return (
            jax.random.normal(ka, (n,), jnp.float32),
            jax.random.normal(kb, (n,), jnp.float32),
        )

    t = _per_iter_time(build_run, make_args, 2000)
    gbps = 3 * n * 4 / t / 1e9
    return {
        "time_s": t,
        "effective_GBps": gbps,
        "vs_ref_666833ns": 666833e-9 / t if n == 1_000_000 else None,
    }


def bench_simple_check():
    """Reference simple_check (benchmark/add.cpp:4-19): construct a 5x5
    float array + add per iteration, through the public API.  Reference:
    2,637 ns wall / 837 ns CPU per iteration (README.md:143).  Measured as
    the per-iteration time of the traced construct+add inside one
    program."""
    import simplemath_tpu as sm

    vals = jnp.arange(25, dtype=jnp.float32).reshape(5, 5)

    def build_run(L):
        def run(seed):
            def body(i, acc):
                a = sm.Array(vals + acc)  # construct from fresh values
                b = sm.Array(vals * jnp.float32(0.5))
                c = sm.add(a, b)  # public add
                return acc + jnp.sum(c.jax()) * jnp.float32(1e-7)

            return jax.lax.fori_loop(0, L, body, seed)

        return run

    def make_args(i):
        return (jnp.float32(i) * jnp.float32(1e-3),)

    t = _per_iter_time(build_run, make_args, 20000)
    return {"time_s": t, "vs_ref_2637ns": 2637e-9 / t}


def bench_pow_small(shape, exponent, ref_ns, label):
    """Reference BM_SMArrayPow_1D / _2D (benchmark/pow.cpp:5-28): tiny int
    pow through public ``sm.pow`` (static int exponent), steady-state
    per-iteration."""
    import simplemath_tpu as sm

    base = (jnp.arange(np.prod(shape), dtype=jnp.int32) % 5).reshape(shape)

    def build_run(L):
        def run(seed):
            def body(i, acc):
                out = sm.pow(sm.Array(base + (acc & 1)), exponent).jax()
                return acc + jnp.sum(out) % 97

            return jax.lax.fori_loop(0, L, body, seed)

        return run

    def make_args(i):
        return (jnp.zeros(shape, jnp.int32) + jnp.int32(i % 3),)

    t = _per_iter_time(build_run, make_args, 20000)
    return {"time_s": t, f"vs_ref_{ref_ns}ns": ref_ns * 1e-9 / t}


def bench_tiny_chain(shape=(5, 5), n_ops=5):
    """Deferred-eager queue payoff: a chain of ``n_ops`` tiny elementwise
    ops through the EAGER public API — no sm.fuse — must cost about one
    program, not ``n_ops`` (ops/lazy.py records the chain and flushes it as
    one program at materialization).  Reports per-chain time vs the
    single-op time; the reference's tiny-op rows are benchmark/pow.cpp:5-28
    (~300 ns each on the Ryzen)."""
    import simplemath_tpu as sm

    vals = (jnp.arange(np.prod(shape), dtype=jnp.int32) % 5).reshape(shape)
    fvals = vals.astype(jnp.float32)

    def build_chain(L):
        def run(seed):
            def body(i, acc):
                a = sm.Array(fvals + acc)
                # 5 eager public ops: pow, add, multiply, subtract, sqrt.
                r = sm.pow(a, 2)
                r = sm.add(r, 3.0)
                r = sm.multiply(r, a)
                r = sm.subtract(r, 1.5)
                r = sm.sqrt(sm.abs(r))
                return acc + jnp.sum(r.jax()) * jnp.float32(1e-7)

            return jax.lax.fori_loop(0, L, body, seed)

        return run

    def build_single(L):
        def run(seed):
            def body(i, acc):
                out = sm.add(sm.Array(fvals + acc), 3.0).jax()
                return acc + jnp.sum(out) * jnp.float32(1e-7)

            return jax.lax.fori_loop(0, L, body, seed)

        return run

    def make_args(i):
        return (jnp.float32(i % 3),)

    # Programs per chain, counted at trace time: the queue turns the
    # op-per-program chain into ONE fused program.
    from simplemath_tpu.config import config as smconfig
    from simplemath_tpu.ops import dispatch

    def _count_programs():
        dispatch.reset()
        jax.make_jaxpr(build_chain(1))(jnp.float32(0.0))
        return sum(
            v for k, v in dispatch.counts().items()
            if k.startswith("elementwise:")
        )

    old_flag = smconfig.deferred_eager
    try:
        launches_deferred = _count_programs()
        smconfig.deferred_eager = False
        launches_immediate = _count_programs()
    finally:
        smconfig.deferred_eager = old_flag

    t_chain = _per_iter_time(build_chain, make_args, 20000)
    t_single = _per_iter_time(build_single, make_args, 20000)
    return {
        "shape": list(shape),
        "n_ops": n_ops,
        "chain_time_s": t_chain,
        "single_op_time_s": t_single,
        "chain_over_single": t_chain / t_single,
        "meets_2x_floor": t_chain <= 2.0 * t_single,
        "programs_per_chain_deferred": launches_deferred,
        "programs_per_chain_immediate": launches_immediate,
    }


def bench_dot1d(n=32 * 1024 * 1024):
    """1-D dot through public ``sm.dot`` (the reference's ``operator%`` /
    product.h path): device-memory GB/s on 128 MB operands."""
    import simplemath_tpu as sm

    def build_run(L):
        def run(a, b):
            def body(i, acc):
                s = sm.dot(sm.Array(a + acc * jnp.float32(1e-9)), sm.Array(b))
                return acc + s.jax() * jnp.float32(1e-9)

            return jax.lax.fori_loop(0, L, body, jnp.float32(0.0))

        return run

    def make_args(i):
        ka, kb = jax.random.split(jax.random.PRNGKey(i))
        return (
            jax.random.normal(ka, (n,), jnp.float32),
            jax.random.normal(kb, (n,), jnp.float32),
        )

    t = _per_iter_time(build_run, make_args, 64)
    # The loop-dependency perturbation fuses into the dot's read of a, so
    # one pass reads both operands (2n floats) — if XLA fuses it.
    gbps = 2 * n * 4 / t / 1e9
    return {
        "time_s": t,
        "GBps": gbps,
        "roofline_fraction": gbps * 1e9 / _peak("hbm_bytes_per_s"),
    }


def bench_fused_map_reduce(n=32 * 1024 * 1024):
    """Fused map+reduce through the public API: ``sm.fuse(lambda a, b:
    sm.sum(sm.square(a - b)))`` — squared L2 distance of two 128 MB
    operands; XLA fuses map and reduce into one pass."""
    import simplemath_tpu as sm

    fused = sm.fuse(lambda a, b, eps: sm.sum(sm.square(a + eps - b)))

    def build_run(L):
        def run(a, b):
            def body(i, acc):
                s = fused(a, b, acc * jnp.float32(1e-9)).jax()
                return acc + s * jnp.float32(1e-9)

            return jax.lax.fori_loop(0, L, body, jnp.float32(0.0))

        return run

    def make_args(i):
        ka, kb = jax.random.split(jax.random.PRNGKey(i))
        return (
            jax.random.normal(ka, (n,), jnp.float32),
            jax.random.normal(kb, (n,), jnp.float32),
        )

    t = _per_iter_time(build_run, make_args, 64)
    gbps = 2 * n * 4 / t / 1e9  # one pass: both operands read once
    return {
        "time_s": t,
        "GBps": gbps,
        "roofline_fraction": gbps * 1e9 / _peak("hbm_bytes_per_s"),
    }


def bench_reduce_sum(n=64 * 1024 * 1024):
    """Public ``Array.sum()``: device-memory GB/s on a 256 MB operand."""
    import simplemath_tpu as sm

    def build_run(L):
        def run(a):
            def body(i, acc):
                s = sm.Array(a + acc * jnp.float32(1e-9)).sum()
                return acc + s.jax() * jnp.float32(1e-9)

            return jax.lax.fori_loop(0, L, body, jnp.float32(0.0))

        return run

    def make_args(i):
        return (jax.random.normal(jax.random.PRNGKey(i), (n,), jnp.float32),)

    t = _per_iter_time(build_run, make_args, 64)
    gbps = n * 4 / t / 1e9  # the perturbation fuses into the reduction's read
    return {
        "time_s": t,
        "GBps": gbps,
        "roofline_fraction": gbps * 1e9 / _peak("hbm_bytes_per_s"),
    }


def bench_reduce_axis(n=8192):
    """Single-pass axis map+reduce, ``sum(where(a > s, a, 0), axis)`` at
    (n, n) f32 -> (n,), as XLA compiles it, against one plain read of the
    operand (``sum(a)``).  The loop threads a scalar carry into the mapped
    expression through a non-factorable select, so XLA can neither hoist
    nor factor the reduction out of the loop."""
    shape = (n, n)

    def mk_build(fn):
        def build_run(L):
            def run(a):
                def body(i, s):
                    out = fn(a, s)
                    return jnp.float32(1.0) + jnp.float32(1e-30) * jnp.sum(out)

                return jax.lax.fori_loop(0, L, body, jnp.float32(1.0))

            return run

        return build_run

    def make_args(i):
        return (jax.random.normal(jax.random.PRNGKey(i), shape, jnp.float32),)

    roof = _peak("hbm_bytes_per_s")
    out = {}
    for axis in (0, 1):
        t = _per_iter_time(
            mk_build(lambda a, s, ax=axis: jnp.sum(jnp.where(a > s, a, 0.0), axis=ax)),
            make_args, 32,
        )
        gbps = n * n * 4 / t / 1e9
        out[f"axis{axis}"] = {
            "time_s": t, "GBps": gbps, "roofline_fraction": gbps * 1e9 / roof,
        }
    t_read = _per_iter_time(
        mk_build(lambda a, s: jnp.sum(jnp.where(a > s, a, 0.0))), make_args, 32
    )
    out["full_read_time_s"] = t_read
    return out


def bench_view_add(n=8192):
    """A transpose-view operand through the public API: ``sm.add(a.T, b)``
    at (n, n) f32, against the same add on dense operands.  XLA fuses the
    transpose into the add's read, so ``view_marginal_cost`` is what the
    strided read costs."""
    import simplemath_tpu as sm

    decay = np.float32(0.999)

    def build_run(L):
        def run(a, b):
            def body(i, acc):
                return sm.add(sm.Array(acc).T, sm.Array(a) * decay).jax()

            return jax.lax.fori_loop(0, L, body, b)

        return run

    def build_run_dense(L):
        def run(a, b):
            def body(i, acc):
                return sm.add(sm.Array(acc), sm.Array(a) * decay).jax()

            return jax.lax.fori_loop(0, L, body, b)

        return run

    def make_args(i):
        ka, kb = jax.random.split(jax.random.PRNGKey(i))
        return (
            jax.random.normal(ka, (n, n), jnp.float32),
            jax.random.normal(kb, (n, n), jnp.float32),
        )

    t = _per_iter_time(build_run, make_args, 32)
    t_dense = _per_iter_time(build_run_dense, make_args, 32)
    gbps = 3 * n * n * 4 / t / 1e9
    return {
        "time_s": t,
        "GBps": gbps,
        "roofline_fraction": gbps * 1e9 / _peak("hbm_bytes_per_s"),
        "dense_time_s": t_dense,
        "view_marginal_cost": t / t_dense - 1.0,
    }


def bench_pow(n=1000):
    """Reference BM_SMArrayPow_Large (benchmark/pow.cpp:33-49): NxN float
    pow^2 through the public ``sm.pow`` — which, like the reference's call
    site, sees a static exponent and specializes to repeated squaring.
    Looped on the device with an acc-coupled base (includes one accumulate
    multiply-add per iteration)."""
    import simplemath_tpu as sm

    def build_run(L):
        def run(a):
            def body(i, acc):
                return (
                    acc * np.float32(1e-3)
                    + sm.pow(sm.Array(a + acc * np.float32(1e-6)), 2).jax()
                )

            return jax.lax.fori_loop(0, L, body, jnp.zeros_like(a))

        return run

    def make_args(i):
        return (
            jax.random.uniform(
                jax.random.PRNGKey(i), (n, n), jnp.float32, 0.5, 100.0
            ),
        )

    t = _per_iter_time(build_run, make_args, 2000)
    # Reference: 1000x1000 in 934,838 ns wall (README.md:154).
    return {"time_s": t, "vs_ref_1000": (934838e-9 / t) if n == 1000 else None}


def bench_small_pow_batched(batch=200_000):
    """The batched answer to the reference's 300 ns tiny-pow rows
    (benchmark/pow.cpp:5-28): ``sm.pow`` on a (B, 3, 3) int32 stack, as
    equivalent tiny-pows/s vs the reference's 1/297ns."""
    import simplemath_tpu as sm

    base = (jnp.arange(batch * 9, dtype=jnp.int32) % 5).reshape(batch, 3, 3)

    def build_run(L):
        def run(seed):
            def body(i, acc):
                out = sm.pow(sm.Array(base + (acc & 1)), 2).jax()
                return acc + jnp.sum(out) % 97

            return jax.lax.fori_loop(0, L, body, seed)

        return run

    def make_args(i):
        return (jnp.int32(i % 3),)

    t = _per_iter_time(build_run, make_args, 2000)
    pows_per_s = batch / t
    return {
        "batch": batch,
        "time_s": t,
        "tiny_pows_per_s": pows_per_s,
        "vs_ref_throughput": pows_per_s * 297e-9,
    }


def bench_fused_pipeline(n=2048, iterations=400):
    """BASELINE.json configs[1]: fused broadcast+pow+exp elementwise
    pipeline on 2-D float arrays (benchmark_pow parity workload, extended
    with the exp stage the reference never shipped working).

    ``acc = acc*d + exp(pow(a + acc*eps, e))`` iterated L times through the
    public ``sm.fuse(..., iterations=L)``, against the same recurrence as
    raw jnp ops in a ``fori_loop`` (``vs_xla``).  With the exponent a (1, n)
    row (the configuration's broadcast) the fuse runs as XLA's fori_loop;
    with a full-shape exponent it runs as the Triton kernel on a GPU
    (``full_exponent``)."""
    import simplemath_tpu as sm

    def chain(acc, a, e):
        return acc * np.float32(1e-3) + sm.exp(
            sm.pow(a + acc * np.float32(1e-6), e)
        )

    fused_L = sm.fuse(chain, iterations=iterations)

    def run_sm(a, e):
        return fused_L(jnp.zeros_like(a), a, e).jax()

    def run_xla(a, e):
        def body(i, acc):
            y = jnp.exp(jnp.power(a + acc * np.float32(1e-6), e))
            return acc * np.float32(1e-3) + y

        return jax.lax.fori_loop(0, iterations, body, jnp.zeros_like(a))

    out = {"shape": [n, n], "iterations": iterations}
    for label, e_shape in (("row_exponent", (1, n)), ("full_exponent", (n, n))):
        def make_args(i, e_shape=e_shape):
            k1, k2 = jax.random.split(jax.random.PRNGKey(i))
            return (
                jax.random.uniform(k1, (n, n), jnp.float32, 0.5, 2.0),
                jax.random.uniform(k2, e_shape, jnp.float32, -2.0, 2.0),
            )

        t_sm = _timeit(run_sm, make_args) / iterations
        t_xla = _timeit(run_xla, make_args) / iterations
        out[label] = {
            "time_s": t_sm,
            "gelements_per_s": n * n / t_sm / 1e9,
            "xla_time_s": t_xla,
            "vs_xla": t_xla / t_sm,
        }
    return out


def bench_matmul(n=2048, dtype="bfloat16"):
    """Matmul TF/s through the public ``sm.dot`` path (XLA: cuBLAS or its
    own GEMM), as a share of the card's published peak for the dtype (f32
    at the platform's default precision runs in TF32 on the H100)."""
    import simplemath_tpu as sm

    dt = jnp.dtype(dtype)
    scale = np.float32(1.0 / n)

    def build_run(L):
        def run(a, b):
            def body(i, acc):
                return (sm.dot(sm.Array(acc), sm.Array(b)).jax() * scale).astype(dt)

            return jax.lax.fori_loop(0, L, body, a)

        return run

    def make_args(i):
        ka, kb = jax.random.split(jax.random.PRNGKey(i))
        return (
            jax.random.normal(ka, (n, n), dt),
            jax.random.normal(kb, (n, n), dt),
        )

    t = _per_iter_time(build_run, make_args, 200)
    tflops = 2 * n**3 / t / 1e12
    peak = _peak("bf16_flops" if dt == jnp.bfloat16 else "tf32_flops")
    return {"time_s": t, "TFLOPs": tflops, "peak_fraction": tflops * 1e12 / peak}


def bench_matmul_epilogue(n=2048, dtype="bfloat16"):
    """Matmul epilogue: ``relu(x @ W + b) * s - c`` through ``sm.fuse``
    (XLA fuses the tail into the GEMM's output) against the bare matmul:
    ``epilogue_marginal_cost`` is the extra time the tail costs."""
    import simplemath_tpu as sm

    dt = jnp.dtype(dtype)
    scale = np.float32(1.0 / n)
    half = np.float32(0.5)

    fused = sm.fuse(
        lambda x, w, bias: sm.maximum(x @ w + bias, 0.0) * scale - half
    )

    def build_run(L):
        def run(a, b, bias):
            def body(i, acc):
                return fused(sm.Array(acc), sm.Array(b), sm.Array(bias)).jax().astype(dt)

            return jax.lax.fori_loop(0, L, body, a)

        return run

    def build_run_bare(L):
        def run(a, b, bias):
            def body(i, acc):
                return (jnp.dot(acc, b) * scale).astype(dt)

            return jax.lax.fori_loop(0, L, body, a)

        return run

    def make_args(i):
        ka, kb, kc = jax.random.split(jax.random.PRNGKey(i), 3)
        return (
            jax.random.normal(ka, (n, n), dt),
            jax.random.normal(kb, (n, n), dt),
            jax.random.normal(kc, (1, n), dt),
        )

    t = _per_iter_time(build_run, make_args, 200)
    t_bare = _per_iter_time(build_run_bare, make_args, 200)
    return {
        "time_s": t,
        "TFLOPs": 2 * n**3 / t / 1e12,
        "bare_matmul_time_s": t_bare,
        "epilogue_marginal_cost": t / t_bare - 1.0,
    }


def bench_int8_matmul(n=2048):
    """s8 x s8 -> s32 through ``sm.int8_matmul`` (the int8 tensor cores):
    TOPS as a share of the published peak, and the per-channel dequant
    (``scale=``) against the bare integer product.  The carry re-quantizes
    the output back to int8 each iteration (the quantized-inference
    dataflow)."""
    import simplemath_tpu as sm

    def build_run(L):
        def run(a, b, s):
            def body(i, acc):
                out = sm.int8_matmul(sm.Array(acc), sm.Array(b)).jax()
                return (out >> 12).astype(jnp.int8)

            return jax.lax.fori_loop(0, L, body, a)

        return run

    def build_run_dequant(L):
        def run(a, b, s):
            def body(i, acc):
                out = sm.int8_matmul(sm.Array(acc), sm.Array(b), scale=s).jax()
                return jnp.clip(jnp.round(out), -127, 127).astype(jnp.int8)

            return jax.lax.fori_loop(0, L, body, a)

        return run

    def make_args(i):
        ka, kb, kc = jax.random.split(jax.random.PRNGKey(i), 3)
        return (
            jax.random.randint(ka, (n, n), -127, 128, jnp.int8),
            jax.random.randint(kb, (n, n), -127, 128, jnp.int8),
            jax.random.uniform(kc, (1, n), jnp.float32, 1e-5, 1e-4),
        )

    t = _per_iter_time(build_run, make_args, 200)
    t_dq = _per_iter_time(build_run_dequant, make_args, 200)
    tops = 2 * n**3 / t / 1e12
    return {
        "time_s": t,
        "TOPS": tops,
        "peak_fraction": tops * 1e12 / _peak("int8_ops"),
        "dequant_time_s": t_dq,
        "dequant_marginal_cost": t_dq / t - 1.0,
    }


def bench_bmm(B=8, n=1024, dtype="bfloat16"):
    """Batched rank-3 matmul TF/s through public ``sm.matmul``."""
    import simplemath_tpu as sm

    dt = jnp.dtype(dtype)
    scale = np.float32(1.0 / n)

    def build_run(L):
        def run(a, b):
            def body(i, acc):
                return (sm.matmul(sm.Array(acc), sm.Array(b)).jax() * scale).astype(dt)

            return jax.lax.fori_loop(0, L, body, a)

        return run

    def make_args(i):
        ka, kb = jax.random.split(jax.random.PRNGKey(i))
        return (
            jax.random.normal(ka, (B, n, n), dt),
            jax.random.normal(kb, (B, n, n), dt),
        )

    t = _per_iter_time(build_run, make_args, 200)
    tflops = 2 * B * n**3 / t / 1e12
    return {"time_s": t, "TFLOPs": tflops,
            "peak_fraction": tflops * 1e12 / _peak("bf16_flops")}


def bench_c64_matmul(n=2048):
    """complex64 matmul through public ``sm.dot`` (XLA's native c64 GEMM):
    TF/s counted as the standard 8*n^3 real operations."""
    import simplemath_tpu as sm

    scale = np.float32(1.0 / n)

    def build_run(L):
        def run(a, b):
            def body(i, acc):
                return (sm.dot(sm.Array(acc), sm.Array(b)).jax() * scale).astype(
                    jnp.complex64
                )

            return jax.lax.fori_loop(0, L, body, a)

        return run

    def make_args(i):
        ka, kb, kc, kd = jax.random.split(jax.random.PRNGKey(i), 4)

        def mk(kr, ki):
            return (
                jax.random.normal(kr, (n, n), jnp.float32)
                + 1j * jax.random.normal(ki, (n, n), jnp.float32)
            ).astype(jnp.complex64)

        return (mk(ka, kb), mk(kc, kd))

    t = _per_iter_time(build_run, make_args, 64)
    return {"time_s": t, "TFLOPs": 8 * n**3 / t / 1e12}


def bench_long_horizon(batch=512, horizon=1000, iters=2):
    """O(log H) payoff at scale: batched cartpole solves at H=1000 with the
    SoA associative backward vs the SoA sequential backward (round-1
    VERDICT item 7 'done' criterion)."""
    from simplemath_tpu.models import ILQRConfig, make_cartpole

    system = make_cartpole()
    out = {}
    for mode in ("sequential", "associative"):
        t = _ilqr_bench(
            system, batch, horizon, iters, backward=mode
        )
        out[mode] = {"time_s": t, "solves_per_s": batch / t}
    out["associative_speedup"] = (
        out["sequential"]["time_s"] / out["associative"]["time_s"]
    )
    return out


def bench_horizon_crossover(batch=8, horizons=(1024, 4096, 16384), iters=1):
    """O(log H) payoff in the LATENCY-BOUND regime: small batch, very long
    horizons, sequential vs associative-scan Riccati backward; per-solve
    time at each H so the crossover is on record."""
    from simplemath_tpu.models import ILQRConfig, make_cartpole
    from simplemath_tpu.models.ilqr import solve_batched

    system = make_cartpole()
    out = {"batch": batch, "iterations": iters, "rows": []}

    def make_args(i):
        return (
            0.2 * jax.random.normal(
                jax.random.PRNGKey(i), (batch, system.nx), jnp.float32
            ),
        )

    for H in horizons:
        row = {"horizon": H}
        us = jnp.zeros((batch, H, system.nu), jnp.float32)
        for mode in ("sequential", "associative"):
            cfg = ILQRConfig(iterations=iters, backward=mode)
            row[mode] = _timeit(
                lambda x0s, cfg=cfg, us=us: solve_batched(system, x0s, us, cfg).cost,
                make_args, repeats=3,
            )
        row["associative_speedup"] = row["sequential"] / row["associative"]
        out["rows"].append(row)
    out["max_speedup"] = max(r["associative_speedup"] for r in out["rows"])
    return out


def bench_sharded_overhead(batch=1024, horizon=50, iters=3):
    """Single-chip vs sharded(1)-on-a-one-device-mesh solve: the shard_map
    wrapping overhead that multi-chip runs pay per chip."""
    from simplemath_tpu.models import ILQRConfig, make_cartpole
    from simplemath_tpu.models.ilqr import solve_batched
    from simplemath_tpu.parallel import make_mesh, sharded

    system = make_cartpole()
    cfg = ILQRConfig(iterations=iters)
    us = jnp.zeros((batch, horizon, system.nu), jnp.float32)

    def make_args(i):
        x0s = 0.2 * jax.random.normal(
            jax.random.PRNGKey(i), (batch, system.nx), dtype=jnp.float32
        )
        return (x0s, us)

    t_plain = _timeit(
        lambda x, u: solve_batched(system, x, u, cfg).cost, make_args, repeats=3
    )
    mesh = make_mesh((1,), ("scenario",), devices=jax.devices()[:1])
    step = sharded.make_sharded_train_step(system, mesh, cfg, "scenario")
    t_shard = _timeit(
        lambda x, u: step(x, u)[1]["total_cost"], make_args, repeats=3
    )
    return {
        "plain_s": t_plain,
        "sharded1_s": t_shard,
        "overhead_fraction": (t_shard - t_plain) / t_plain,
    }


def _ilqr_bench(system, batch, horizon, iters, backward="sequential"):
    from simplemath_tpu.models import ILQRConfig
    from simplemath_tpu.models.ilqr import solve_batched

    cfg = ILQRConfig(iterations=iters, backward=backward)
    us = jnp.zeros((batch, horizon, system.nu), jnp.float32)
    def make_args(i):
        x0s = 0.2 * jax.random.normal(
            jax.random.PRNGKey(i), (batch, system.nx), dtype=jnp.float32
        )
        return (x0s, us)

    return _timeit(
        lambda x, u: solve_batched(system, x, u, cfg).cost, make_args, repeats=3
    )


def bench_cartpole(batch=8192, horizon=100, iters=10, quick=False):
    from simplemath_tpu.models import make_cartpole

    if quick:
        batch, horizon, iters = 256, 50, 5
    t = _ilqr_bench(make_cartpole(), batch, horizon, iters)
    solves_per_s = batch / t
    return {
        "time_s": t,
        "batch": batch,
        "horizon": horizon,
        "iterations": iters,
        "solves_per_s": solves_per_s,
    }


def bench_pendulum(batch=4096, horizon=50, iters=10, quick=False):
    from simplemath_tpu.models import make_pendulum

    if quick:
        batch, horizon, iters = 128, 25, 3
    t = _ilqr_bench(make_pendulum(), batch, horizon, iters)
    return {"time_s": t, "batch": batch, "solves_per_s": batch / t}


def bench_quadrotor_replan(horizon=50, loop_steps=200):
    """MPC replan latency (1 kHz budget = 1 ms per replan).

    Uses the parallel-in-time RTI solver (models/rti.py): linearize
    (parallel) + associative-scan backward + associative-scan affine
    forward, O(log H) sequential depth.  Runs a closed control loop ON
    DEVICE (`loop_steps` ticks inside one jitted lax.scan), so per-replan
    time excludes host dispatch."""
    from simplemath_tpu.models import make_quadrotor
    from simplemath_tpu.models import rti as _rti

    system = make_quadrotor()

    def build_run(ticks):
        def run(x0):
            xs, us, costs, defects = _rti.rti_closed_loop(
                system, x0, horizon=horizon, ticks=ticks
            )
            return costs

        return run

    def make_args(i):
        return (
            0.1
            * jax.random.normal(
                jax.random.PRNGKey(i), (system.nx,), dtype=jnp.float32
            ),
        )

    t = _per_iter_time(build_run, make_args, loop_steps, repeats=3)
    return {"replan_s": t, "replan_hz": 1.0 / t, "meets_1khz": t < 1e-3}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--skip-elementwise", action="store_true")
    args = parser.parse_args()

    from simplemath_tpu.utils import device

    device.require_gpu()
    cache = device.enable_compile_cache()
    details = {
        "device": device.describe(),
        "card": device.card_info(),
        "compile_cache": cache,
    }
    err = sys.stderr
    print(f"device: {details['device']}  card: {details['card']}", file=err)

    q = args.quick
    rows = [
        ("million_add", lambda: bench_million_add(100_000 if q else 1_000_000)),
        ("simple_check", bench_simple_check),
        ("pow_1d_int", lambda: bench_pow_small((10,), 3, 297, "1d")),
        ("pow_2d_int", lambda: bench_pow_small((3, 3), 2, 302, "2d")),
        ("tiny_chain_5op", lambda: bench_tiny_chain()),
        ("view_add", lambda: bench_view_add(1024 if q else 8192)),
        ("pow_1000", lambda: bench_pow(100 if q else 1000)),
        ("fused_pipeline", lambda: bench_fused_pipeline(512 if q else 2048, 16 if q else 400)),
        ("fused_pipeline_8k", lambda: bench_fused_pipeline(1024 if q else 8192, 16 if q else 72)),
        ("dot1d", lambda: bench_dot1d(1 << 20 if q else 32 * 1024 * 1024)),
        ("reduce_sum", lambda: bench_reduce_sum(1 << 20 if q else 64 * 1024 * 1024)),
        ("reduce_axis", lambda: bench_reduce_axis(1024 if q else 8192)),
        ("fused_map_reduce", lambda: bench_fused_map_reduce(1 << 20 if q else 32 * 1024 * 1024)),
        ("small_pow_batched", lambda: bench_small_pow_batched(10_000 if q else 200_000)),
        ("matmul_bf16", lambda: bench_matmul(512 if q else 2048, "bfloat16")),
        ("matmul_f32", lambda: bench_matmul(512 if q else 2048, "float32")),
        ("matmul_epilogue", lambda: bench_matmul_epilogue(512 if q else 2048)),
        ("int8_matmul", lambda: bench_int8_matmul(512 if q else 2048)),
        ("bmm_bf16", lambda: bench_bmm(4 if q else 8, 512 if q else 1024)),
        ("c64_matmul", lambda: bench_c64_matmul(512 if q else 2048)),
        ("pendulum", lambda: bench_pendulum(quick=q)),
        ("quadrotor_replan", lambda: bench_quadrotor_replan()),
        ("long_horizon", lambda: bench_long_horizon(
            batch=64 if q else 512, horizon=200 if q else 1000)),
        ("horizon_crossover", lambda: bench_horizon_crossover(
            horizons=(256, 1024) if q else (1024, 4096, 16384))),
        ("sharded_overhead", lambda: bench_sharded_overhead()),
    ]
    if not args.skip_elementwise:
        for name, fn in rows:
            details[name] = fn()
            print(f"{name}: {details[name]}", file=err)

    cart = bench_cartpole(quick=q)
    details["cartpole"] = cart
    print(f"cartpole: {cart}", file=err)

    out_name = "bench_details_quick.json" if q else "bench_details.json"
    with open(out_name, "w") as f:
        json.dump(details, f, indent=2)

    print(details["card"])
    print(
        json.dumps(
            {
                "metric": "cartpole_ilqr_solves_per_s",
                "value": cart["solves_per_s"],
                "unit": "solves/s",
                "device": details["device"],
            }
        )
    )


if __name__ == "__main__":
    main()
