"""Measurement plumbing: the compile-cache rule, the GPU requirement, the
peak table, and the card query (utils/device.py, utils/profiling.py)."""

import jax
import pytest

from simplemath_tpu.utils import device, profiling


def test_cache_dir_from_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.compile_cache_dir() == str(tmp_path)


def test_cache_dir_default_is_repo_local(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert device.compile_cache_dir() == str(device.REPO_ROOT / ".jax_cache")
    assert (device.REPO_ROOT / "simplemath_tpu").is_dir()


def test_enable_compile_cache_sets_only_that_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    try:
        assert device.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="no GPU found"):
        device.require_gpu()


def test_describe_names_the_device():
    d = device.describe()
    assert d == {
        "platform": "cpu",
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }


def test_peaks_of_the_h100():
    p = profiling.peaks("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert p["bf16_flops"] == 989e12 and p["int8_ops"] == 1979e12
    assert p["tf32_flops"] == 495e12 and p["f32_flops"] == 67e12


def test_unknown_device_has_no_peaks():
    with pytest.raises(KeyError, match="no published peaks"):
        profiling.peaks("some other card")
    with pytest.raises(KeyError):
        profiling.hbm_bandwidth_bytes_per_s()  # this CPU


@pytest.mark.gpu
def test_card_info_names_the_card(gpu):
    line = device.card_info().splitlines()[0]
    name, limit = (s.strip() for s in line.split(","))
    assert name and limit.endswith("W")
