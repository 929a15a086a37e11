"""Transcendental accuracy sweeps vs NumPy float64 — covering the reference's
documented failures: exp wrong below 1.1, log wrong at 3.0 (reference
README.md:8-10), and float pow absent (include/math/pow.h:16-52)."""

import numpy as np
import pytest

from simplemath_tpu.ops import transcendental as tc


def _ulp_err(got_f32, want_f64):
    want_f32 = want_f64.astype(np.float32)
    ulp = np.spacing(np.abs(want_f32)).astype(np.float64)
    return np.abs(got_f32.astype(np.float64) - want_f64) / ulp


def test_exp_full_domain():
    x = np.linspace(-87.0, 88.0, 200_001).astype(np.float32)
    got = np.asarray(tc.exp_f32(x))
    want = np.exp(x.astype(np.float64))
    assert np.max(_ulp_err(got, want)) < 4.0


def test_exp_below_1_1():
    # The reference's exp is wrong below 1.1 (README.md:10).
    x = np.linspace(-1.5, 1.1, 100_001).astype(np.float32)
    got = np.asarray(tc.exp_f32(x))
    want = np.exp(x.astype(np.float64))
    assert np.max(_ulp_err(got, want)) < 2.0


def test_exp_edges():
    x = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 100.0, -200.0], np.float32)
    got = np.asarray(tc.exp_f32(x))
    assert got[0] == 1.0 and got[1] == 1.0
    assert got[2] == np.inf and got[3] == 0.0
    assert np.isnan(got[4])
    assert got[5] == np.inf and got[6] == 0.0


def test_exp_subnormal_results():
    # Down in the f32 subnormal range the quantization step (1.4e-45)
    # dominates relative error; require agreement within one subnormal ulp.
    x = np.array([-95.0, -100.0, -103.0], np.float32)
    got = np.asarray(tc.exp_f32(x))
    want = np.exp(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1.5e-45)


def test_log_full_domain():
    x = np.logspace(-37, 38, 200_001).astype(np.float32)
    got = np.asarray(tc.log_f32(x))
    want = np.log(x.astype(np.float64))
    assert np.max(_ulp_err(got, want)) < 4.0


def test_log_at_3():
    # The reference's log is wrong at 3.0 (README.md:10).
    x = np.array([3.0], np.float32)
    got = float(np.asarray(tc.log_f32(x))[0])
    assert got == pytest.approx(np.log(3.0), rel=1e-7)


def test_log_near_1():
    # Cancellation region — hardest part of the range reduction.
    x = np.linspace(0.9, 1.1, 100_001).astype(np.float32)
    got = np.asarray(tc.log_f32(x))
    want = np.log(x.astype(np.float64))
    err = np.abs(got.astype(np.float64) - want)
    assert np.max(err) < 1e-7


def test_log_subnormal_inputs():
    x = np.array([1e-40, 1e-44], np.float32)  # subnormal f32
    got = np.asarray(tc.log_f32(x))
    want = np.log(x.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_log_edges():
    x = np.array([0.0, -1.0, np.inf, np.nan], np.float32)
    got = np.asarray(tc.log_f32(x))
    assert got[0] == -np.inf
    assert np.isnan(got[1])
    assert got[2] == np.inf
    assert np.isnan(got[3])


def test_exp2_log2_roundtrip():
    x = np.linspace(-120.0, 120.0, 50_001).astype(np.float32)
    got = np.asarray(tc.exp2_f32(x))
    want = np.exp2(x.astype(np.float64))
    assert np.max(_ulp_err(got, want)) < 4.0
    y = np.logspace(-30, 30, 50_001).astype(np.float32)
    got2 = np.asarray(tc.log2_f32(y))
    want2 = np.log2(y.astype(np.float64))
    assert np.max(_ulp_err(got2, want2)) < 4.0


def test_pow_grid():
    bases = np.logspace(-10, 10, 201).astype(np.float32)
    exps = np.array([-3.0, -1.5, -1.0, -0.5, 0.5, 1.0, 2.0, 3.0, 7.5], np.float32)
    b, e = np.meshgrid(bases, exps)
    got = np.asarray(tc.pow_f32(b, e))
    want = np.power(b.astype(np.float64), e.astype(np.float64))
    # Compare only where the true result is representable in f32 (outside,
    # the correct f32 answer is inf/0 — checked in the edge tests).
    f32max = np.float64(np.finfo(np.float32).max)
    f32tiny = np.float64(np.finfo(np.float32).tiny)
    finite = (want < f32max) & (want > f32tiny)
    rel = np.abs(got.astype(np.float64)[finite] - want[finite]) / np.abs(want[finite])
    assert np.max(rel) < 1e-5


def test_pow_negative_base_integer_exponent():
    b = np.array([-2.0, -2.0, -3.0], np.float32)
    e = np.array([2.0, 3.0, 4.0], np.float32)
    got = np.asarray(tc.pow_f32(b, e))
    np.testing.assert_allclose(got, [4.0, -8.0, 81.0], rtol=1e-6)


def test_pow_edge_cases():
    cases = [
        (0.0, 0.0, 1.0),
        (0.0, 2.0, 0.0),
        (0.0, -1.0, np.inf),
        (1.0, np.nan, 1.0),
        (np.nan, 0.0, 1.0),
        (-2.0, 0.5, np.nan),
        (np.inf, 2.0, np.inf),
        (np.inf, -2.0, 0.0),
        (-np.inf, 3.0, -np.inf),
        (2.0, np.inf, np.inf),
    ]
    b = np.array([c[0] for c in cases], np.float32)
    e = np.array([c[1] for c in cases], np.float32)
    want = np.array([c[2] for c in cases], np.float32)
    got = np.asarray(tc.pow_f32(b, e))
    for i, (bb, ee, ww) in enumerate(cases):
        if np.isnan(ww):
            assert np.isnan(got[i]), (bb, ee, got[i])
        else:
            assert got[i] == ww, (bb, ee, got[i], ww)


def test_pow_matches_numpy_float_semantics(rng):
    b = rng.uniform(0.01, 100.0, size=10_000).astype(np.float32)
    e = rng.uniform(-5.0, 5.0, size=10_000).astype(np.float32)
    got = np.asarray(tc.pow_f32(b, e))
    want = np.power(b.astype(np.float64), e.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=3e-6)


def test_ipow_tile_matches_int_semantics():
    base = np.array([0, 0, 1, -1, -1, 2, -3, 5, -5], np.int32)
    exp = np.array([3, 0, -5, -2, -3, -1, -2, 3, 4], np.int32)
    got = np.asarray(tc.ipow_tile(base, exp))
    want = np.array([0, 1, 1, 1, -1, 0, 0, 125, 625], np.int32)
    assert np.array_equal(got, want)


def test_pow_infinity_special():
    # 2^inf handled by saturation path.
    got = np.asarray(tc.pow_f32(np.float32(2.0), np.float32(np.inf)))
    assert got == np.inf


# ---------------------------------------------------------------- impl modes
# Accuracy contract per impl mode:
#  - "crafted": <=4 ulp everywhere (the fdlibm-style implementations);
#  - "auto" (DEFAULT): per op, the native op where it meets the <=4-ulp
#    contract on the H100 (ops/transcendental.py), crafted otherwise;
#  - "native": platform accuracy everywhere — the opt-in mode keeps the
#    looser bounds that cover platforms with a sloppy native log.
_IMPL_TOLS = {
    "crafted": dict(exp=1e-6, log=1e-6, log_atol=1e-6, pow=4e-6),
    "auto": dict(exp=1e-5, log=1e-6, log_atol=1e-6, pow=1e-5),
    "native": dict(exp=1e-5, log=2e-4, log_atol=1e-4, pow=1e-5),
}


@pytest.mark.parametrize("impl", ["crafted", "auto", "native"])
def test_public_path_accuracy_all_impls(impl):
    import simplemath_tpu as sm
    from simplemath_tpu.config import config

    tol = _IMPL_TOLS[impl]
    x = np.linspace(0.01, 20.0, 50_001).astype(np.float32)
    b = np.linspace(0.5, 4.0, 50_001).astype(np.float32)
    e = np.linspace(-3.0, 3.0, 50_001).astype(np.float32)
    old = config.transcendental_impl
    try:
        config.transcendental_impl = impl
        got_exp = np.asarray(sm.exp(sm.Array(-x / 4)).jax())
        np.testing.assert_allclose(
            got_exp, np.exp(-x.astype(np.float64) / 4), rtol=tol["exp"],
            err_msg=f"exp impl={impl}",
        )
        got_log = np.asarray(sm.log(sm.Array(x)).jax())
        np.testing.assert_allclose(
            got_log, np.log(x.astype(np.float64)), rtol=tol["log"],
            atol=tol["log_atol"], err_msg=f"log impl={impl}",
        )
        got_pow = np.asarray(sm.pow(sm.Array(b), sm.Array(e)).jax())
        np.testing.assert_allclose(
            got_pow,
            np.power(b.astype(np.float64), e.astype(np.float64)),
            rtol=tol["pow"],
            err_msg=f"pow impl={impl}",
        )
    finally:
        config.transcendental_impl = old


def test_log_at_3_default_and_crafted():
    """The reference's log is wrong at exactly 3.0 (README.md:10).  The
    DEFAULT ("auto") path and the crafted one must get it right."""
    import simplemath_tpu as sm
    from simplemath_tpu.config import config

    old = config.transcendental_impl
    try:
        for impl in ("auto", "crafted"):
            config.transcendental_impl = impl
            got = float(sm.log(sm.Array(np.float32(3.0))).jax())
            assert abs(got - np.log(3.0)) < 1e-7, impl
    finally:
        config.transcendental_impl = old


# ------------------------------------------------------------ trig contract
# sin/cos/tan run natively under "auto"; tanh runs crafted (its native
# lowering misses the 4-ulp contract on the H100 and on the CPU).  These
# bounds are asserted through the PUBLIC sm.* path on the CPU;
# chip_smoke.py measures the same domains on the card.
_TRIG_TOLS = {"sin": 5e-7, "cos": 5e-7, "tan": 1e-6, "tanh": 5e-7}


def _trig_domain(op):
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.linspace(-2 * np.pi, 2 * np.pi, 50_001),
        np.linspace(-1e3, 1e3, 20_001),
        rng.uniform(1e4, 3e7, 10_000) * rng.choice([-1.0, 1.0], 10_000),
    ])
    if op == "tanh":
        x = np.concatenate([
            np.linspace(-30, 30, 50_001),
            np.linspace(-0.6, 0.6, 50_001),
            [0.0, 1e-8, 0.5, 9.2, 100.0],
        ])
    return x.astype(np.float32)


@pytest.mark.parametrize("op", ["sin", "cos", "tan", "tanh"])
def test_trig_accuracy_contract(op):
    import simplemath_tpu as sm

    x = _trig_domain(op)
    got = np.asarray(getattr(sm, op)(sm.Array(x)).jax(), dtype=np.float64)
    want = getattr(np, op)(x.astype(np.float64))
    # tan poles: where the f64 oracle exceeds 1e6, the f32 INPUT rounding
    # alone moves the true value by more than any implementation could fix.
    ok = np.isfinite(want) & (np.abs(want) < 1e6)
    abs_err = np.abs(got[ok] - want[ok])
    denom = np.abs(want[ok])
    rel = denom > 1e-3
    tol = _TRIG_TOLS[op]
    assert abs_err[~rel].max(initial=0.0) < 1e-6, op
    assert (abs_err[rel] / denom[rel]).max() < tol, (
        op, float((abs_err[rel] / denom[rel]).max()))


def test_tanh_crafted_edges():
    # Saturation to exactly +-1.0f where f32 tanh saturates; sign/NaN edges.
    got = np.asarray(tc.tanh_f32(np.array(
        [np.inf, -np.inf, 10.0, -10.0, 0.0, -0.0, 1e-30], np.float32)))
    np.testing.assert_array_equal(got[:4], [1.0, -1.0, 1.0, -1.0])
    assert got[4] == 0.0 and got[5] == 0.0
    np.testing.assert_allclose(got[6], 1e-30, rtol=1e-6)
    assert np.isnan(np.asarray(tc.tanh_f32(np.float32(np.nan))))


def test_trig_fused_uses_contract_impl(rng):
    # sm.fuse chains route trig through the same transcendental tiles (the
    # crafted tanh, not the native lowering).
    import simplemath_tpu as sm

    x = rng.uniform(-3.0, 3.0, (8, 128)).astype(np.float32)
    fused = sm.fuse(lambda v: sm.tanh(sm.sin(v)))
    got = np.asarray(fused(x).jax(), dtype=np.float64)
    want = np.tanh(np.sin(x.astype(np.float64)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
