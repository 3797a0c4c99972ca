"""Test configuration: run on a virtual 8-device CPU mesh with x64 enabled.

Unit tests validate numerics in float64 on CPU and sharding on a forced
8-device host platform (SURVEY.md §4: CPU-backend multi-device
simulation); JAX_PLATFORMS=cpu makes the CPU the default backend.  Tests
that need the GPU carry the ``gpu`` marker and skip without one; the
chip-level checks live in chip_smoke.py.
"""

import os

# Must be set before jax is imported anywhere.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: compiles dominate test wall time here.
from plslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)

# ---------------------------------------------------------------------------
# Tests exercise the math core through many small calls; eager dispatch
# pays per op, so wrap its pure entry points in jax.jit once here.
# ---------------------------------------------------------------------------
import inspect

import pytest

# ---------------------------------------------------------------------------
# Tier split (fast core vs slow e2e): `pytest -m "not slow"` is the
# per-commit loop; the full pyramid runs the slow tier too.  Slow modules
# are the e2e / distribution / threaded-pipeline suites whose compile +
# multi-frame walls dominate total suite time.
# ---------------------------------------------------------------------------
_SLOW_MODULES = {
    "test_scale_e2e", "test_slam_e2e", "test_vo_e2e", "test_batch_vo",
    "test_pipeline_threads", "test_slam_endpoint_mode", "test_rgbd",
    "test_dist_gba", "test_dist_ba", "test_dist_match_pgo", "test_loop",
    "test_cli", "test_ba_endpoint", "test_loop_stress",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.module.__name__ in _SLOW_MODULES:
            item.add_marker(pytest.mark.slow)


from plslam_tpu.core import lie as _lie
from plslam_tpu.core import plucker as _plucker
from plslam_tpu.core import robust as _robust

for _mod in (_lie, _plucker, _robust):
    for _name, _fn in list(vars(_mod).items()):
        if (
            inspect.isfunction(_fn)
            and not _name.startswith("_")
            and _fn.__module__ == _mod.__name__
        ):
            setattr(_mod, _name, jax.jit(_fn))


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip.  Decided here, never at import, so every
    test worker collects the same tests.  On the card:
    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/"""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu -m gpu)")
