"""Test configuration.

- Force the CPU backend with 8 virtual devices so sharding/collective tests
  run anywhere (the multi-chip story is validated on a fake mesh, per
  SURVEY.md §4's test plan).
- Enable float64: the reference goldens are specified to 1e-6
  (gp/gp_test.go), which float32 cannot hold through a Cholesky.
"""

import os

# The tests run on the CPU whatever accelerator the machine has: both the
# env var and jax.config are pinned, so a process that already imported jax
# stays on the CPU too.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


# ---------------------------------------------------------------------------
# Test tiers: the sampler-moment long tail is marked ``slow`` from a measured
# duration manifest (tests/slow_tests.txt, regenerated from
# ``pytest --durations=0`` by tests/make_slow_manifest.py).  ``make test``
# runs the quick tier (~8 min, every module still covered by its fast
# tests); ``make test-all`` runs everything (~37 min).
# ---------------------------------------------------------------------------

import pathlib

import pytest

_SLOW_MANIFEST = pathlib.Path(__file__).with_name("slow_tests.txt")


def pytest_collection_modifyitems(config, items):
    if not _SLOW_MANIFEST.exists():
        return
    slow_ids = set(_SLOW_MANIFEST.read_text().split())
    for item in items:
        # item.nodeid is rootdir-relative ("tests/test_x.py::TestC::test_y")
        if item.nodeid in slow_ids:
            item.add_marker(pytest.mark.slow)
