"""Numerical parity: the f32 solver must match a float64 CPU reference
control sequence within tolerance at the same horizon (BASELINE.json
north_star)."""

import jax
import jax.numpy as jnp
import numpy as np

from simplemath_tpu.models import ILQRConfig, make_cartpole, make_pendulum
from simplemath_tpu.models.ilqr import solve


def _solve_in_dtype(system, x0, horizon, dtype, iters=20):
    x0 = jnp.asarray(x0, dtype)
    us = jnp.zeros((horizon, system.nu), dtype)
    return solve(system, x0, us, ILQRConfig(iterations=iters))


def test_pendulum_f32_matches_f64_controls():
    system = make_pendulum()
    x0 = [0.4, 0.0]
    r32 = _solve_in_dtype(system, x0, 40, jnp.float32)
    r64 = _solve_in_dtype(system, x0, 40, jnp.float64)
    # Cost parity is the robust criterion (controls can differ along flat
    # valleys); require matching trajectory cost within 0.1%.
    assert abs(float(r32.cost) - float(r64.cost)) / float(r64.cost) < 1e-3
    # Control sequences agree to f32-appropriate tolerance.
    np.testing.assert_allclose(
        np.asarray(r32.us), np.asarray(r64.us), rtol=0.05, atol=0.05
    )


def test_cartpole_f32_matches_f64_cost():
    system = make_cartpole()
    x0 = [0.0, 0.0, 0.3, 0.0]
    r32 = _solve_in_dtype(system, x0, 60, jnp.float32, iters=15)
    r64 = _solve_in_dtype(system, x0, 60, jnp.float64, iters=15)
    assert abs(float(r32.cost) - float(r64.cost)) / float(r64.cost) < 5e-3


def test_solver_entry_points_pin_f32_matmul_precision():
    """Every solver entry point must trace its ops under float32 matmul
    precision (utils/precision.py): a platform default that rounds f32
    matmul operands (TF32 on the H100) compounds through hundreds of
    Riccati steps.  This test fails if a refactor drops the pin from any
    of them."""
    from simplemath_tpu.models import ilqr, rti, sqp_mpc
    from simplemath_tpu.ops import soa
    from simplemath_tpu.parallel import horizon

    entry_points = [
        ilqr.linearize, ilqr.linearize_soa,
        ilqr.backward_sequential, ilqr.backward_sequential_soa,
        ilqr.backward_associative, ilqr.backward_associative_soa,
        ilqr.forward_linesearch, ilqr.forward_linesearch_soa,
        ilqr.solve, ilqr.solve_batched,
        soa.matmul, soa.matvec, soa.outer, soa.inv, soa.solve,
        rti.affine_scan, rti.backward_associative_defect,
        rti.rti_tick, rti.rti_closed_loop,
        horizon.sharded_suffix_scan, horizon.sharded_suffix_scan_batched,
        horizon.backward_associative_sharded,
        horizon.backward_associative_sharded_batched,
        sqp_mpc.solve_constrained, sqp_mpc.make_scenario_mpc_step,
    ]
    unpinned = [
        fn.__name__
        for fn in entry_points
        if not getattr(fn, "_pins_f32_matmuls", False)
    ]
    assert not unpinned, f"solver entry points missing @f32_matmuls: {unpinned}"


def _dot_precisions(jaxpr):
    """Recursively collect the `precision` param of every dot_general in a
    (closed) jaxpr, descending into scan/cond/shard_map/pjit sub-jaxprs."""
    out = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params.get("precision"))
            for v in eqn.params.values():
                if hasattr(v, "jaxpr"):  # ClosedJaxpr
                    walk(v.jaxpr)
                elif hasattr(v, "eqns"):  # raw Jaxpr
                    walk(v)

    walk(jaxpr.jaxpr if hasattr(jaxpr, "jaxpr") else jaxpr)
    return out


def test_scenario_step_traces_with_f32_precision():
    """Round-3 advisor (high): the marker-attribute check above passed even
    though the pin did NOT apply — @f32_matmuls on the BUILDER exits before
    the returned shard_map'd step traces.  This test inspects the actual
    traced jaxpr: every dot_general in the step (KKT assembly, solve,
    line-search feedback matvecs, all nested inside shard_map/vmap/scan)
    must carry precision=HIGHEST."""
    from jax.lax import Precision
    from jax.sharding import Mesh
    from simplemath_tpu.models import make_pendulum, sqp_mpc

    devs = jax.devices()[:2]
    mesh = Mesh(np.array(devs), ("scenario",))
    system = make_pendulum()
    step = sqp_mpc.make_scenario_mpc_step(system, mesh)
    x0s = jnp.zeros((2, system.nx), jnp.float32)
    uss = jnp.zeros((2, 6, system.nu), jnp.float32)
    jx = jax.make_jaxpr(step)(x0s, uss)
    precisions = _dot_precisions(jx)
    assert precisions, "no dot_general found in the traced scenario step"
    bad = [p for p in precisions if p != (Precision.HIGHEST, Precision.HIGHEST)]
    assert not bad, (
        f"{len(bad)}/{len(precisions)} dot_generals traced without "
        f"f32 (HIGHEST) precision: {set(map(str, bad))}"
    )
