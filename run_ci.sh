#!/bin/bash
# Single-command build-and-test flow, mirroring the reference CI
# (.github/workflows/cmake-single-platform.yml: configure -> build -> ctest).
# The tests run on the CPU; on a machine with an NVIDIA GPU, also run
# `python chip_smoke.py` (README.md, "Tests and benchmarks").
set -euo pipefail
cd "$(dirname "$0")"

echo "== build native extension =="
python -m simplemath_tpu.native.build || echo "native build skipped (toolchain unavailable)"

echo "== unit + distributed tests (CPU backend, 8 virtual devices) =="
JAX_PLATFORMS=cpu python -m pytest tests/ -q -n auto
