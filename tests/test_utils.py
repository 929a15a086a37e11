"""Aux subsystems: profiling/benchmark harness, metrics logger, checkpoint
round-trip (SURVEY §5)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from simplemath_tpu.utils import MetricsLogger, benchmark, checkpoint


def test_benchmark_result():
    x = jnp.ones((256, 256), jnp.float32)
    res = benchmark(lambda a: a + 1.0, x, warmup=1, repeats=3,
                    bytes_moved=2 * x.size * 4)
    assert res.median_s > 0
    assert res.gbps is not None and res.gbps > 0
    # The CPU has no published peak: a roofline share is an error here,
    # never a share of a default bandwidth.
    with pytest.raises(KeyError, match="no published peaks"):
        res.roofline_fraction


def test_metrics_logger(tmp_path):
    log = MetricsLogger("test")
    log.log(0, cost=1.5, residual=jnp.asarray(0.25))
    log.log(1, cost=1.0, residual=jnp.asarray(0.125))
    assert len(log) == 2
    assert log.summary()["cost"] == 1.0
    path = os.path.join(tmp_path, "metrics.jsonl")
    log.dump_jsonl(path)
    with open(path) as f:
        lines = f.readlines()
    assert len(lines) == 2


def test_checkpoint_roundtrip(tmp_path):
    state = {
        "us": jnp.ones((10, 2), jnp.float32),
        "step": jnp.asarray(7),
        "nested": {"x": jnp.arange(5)},
    }
    path = os.path.join(tmp_path, "ckpt")
    checkpoint.save(path, state, metadata={"note": "test"})
    restored = checkpoint.restore(path, like=state)
    np.testing.assert_array_equal(np.asarray(restored["us"]), np.ones((10, 2)))
    assert int(np.asarray(restored["step"])) == 7
    np.testing.assert_array_equal(np.asarray(restored["nested"]["x"]), np.arange(5))


def test_checkpoint_structure_mismatch_raises(tmp_path):
    """Restoring with a different pytree structure must fail loudly at the
    checkpoint boundary (round-1 VERDICT weak #8), not as a downstream
    shape error or silent misbinding."""
    import pytest

    state = {"us": jnp.ones((4,), jnp.float32), "step": jnp.asarray(1)}
    path = os.path.join(tmp_path, "ckpt")
    checkpoint.save(path, state)
    wrong = {"us": jnp.ones((4,), jnp.float32), "extra": jnp.asarray(0)}
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(path, like=wrong)
    # matching structure still restores
    ok = checkpoint.restore(path, like=state)
    assert int(np.asarray(ok["step"])) == 1


class TestAOTExport:
    """AOT export / serving (utils/export.py): solve steps serialize to
    StableHLO and run back without tracing or Python model code —
    production serving for the 1 kHz replan budget."""

    def test_plain_roundtrip(self, tmp_path):
        import jax.numpy as jnp

        from simplemath_tpu.utils import export as smx

        p = tmp_path / "step.bin"
        smx.save_step(p, lambda x: jnp.tanh(x) * 2, jnp.ones((8,)))
        run = smx.load_step(str(p))
        out = np.asarray(run(jnp.full((8,), 0.5)))
        np.testing.assert_allclose(out, np.tanh(0.5) * 2, rtol=1e-6)

    def test_solver_step_roundtrip(self):
        import jax.numpy as jnp

        from simplemath_tpu.models import ILQRConfig, make_cartpole
        from simplemath_tpu.utils import export as smx

        system = make_cartpole()
        cfg = ILQRConfig(iterations=2)
        blob = smx.export_solver_step(system, cfg, batch=4, horizon=10)
        run = smx.load_step(blob)
        x0s = 0.1 * jnp.ones((4, system.nx), jnp.float32)
        us0 = jnp.zeros((4, 10, system.nu), jnp.float32)
        us, cost = run(x0s, us0)
        # must equal the live (traced) solve exactly
        from simplemath_tpu.models.ilqr import solve_batched

        ref = solve_batched(system, x0s, us0, cfg)
        np.testing.assert_allclose(np.asarray(cost), np.asarray(ref.cost),
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(us), np.asarray(ref.us),
                                   rtol=1e-6, atol=1e-7)

    def test_pallas_kernel_roundtrip(self):
        import jax.numpy as jnp

        from simplemath_tpu.ops import fuse_loop
        from simplemath_tpu.utils import export as smx

        one = np.float32(1.0)

        def tile(a, b):
            return a * b + one

        def k(x, y):
            # The iterated-fuse Pallas kernel (interpret mode on the CPU);
            # one iteration, carry x.
            return fuse_loop.iterate(
                tile, x.shape, jnp.float32, [x, y], iterations=1, carry=0,
                interpret=True,
            )

        blob = smx.export_step(
            k,
            jnp.ones((256, 256), jnp.float32),
            jnp.ones((256, 256), jnp.float32),
        )
        run = smx.load_step(blob)
        out = np.asarray(
            run(
                jnp.full((256, 256), 2.0, jnp.float32),
                jnp.full((256, 256), 3.0, jnp.float32),
            )
        )
        np.testing.assert_allclose(out, 7.0)

    def test_shape_mismatch_raises(self):
        import jax.numpy as jnp

        from simplemath_tpu.utils import export as smx

        import pytest

        blob = smx.export_step(lambda x: x + 1, jnp.ones((8,)))
        run = smx.load_step(blob)
        with pytest.raises(Exception):
            run(jnp.ones((9,)))
