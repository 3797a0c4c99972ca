"""Device choice, compile cache and entry-point guards: nothing silently
falls back to another backend or to a temporary cache directory."""

import os
import subprocess
import sys

import jax
import pytest

from plslam_tpu.parallel.mesh import make_mesh
from plslam_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_make_mesh_raises_instead_of_falling_back():
    n = len(jax.devices())
    assert make_mesh(n).devices.size == n
    with pytest.raises(ValueError, match="need"):
        make_mesh(n + 1)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(env_set, monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            jax.config.update("jax_compilation_cache_dir", "sentinel")
            assert compile_cache.enable_compile_cache() == str(tmp_path)
            # JAX reads the variable itself; the helper sets nothing
            assert jax.config.jax_compilation_cache_dir == "sentinel"
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = compile_cache.enable_compile_cache()
            assert path == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _run(args, **env):
    return subprocess.run([sys.executable] + args, cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, **env))


def test_chip_smoke_refuses_cpu():
    r = _run(["chip_smoke.py"], JAX_PLATFORMS="cpu")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not a GPU" in r.stderr


_BLOCKED = ("yaml", "cv2", "matplotlib")


def test_main_path_imports_without_optional_packages():
    """pipeline, vo, batch_vo, the back end and the synthetic data layer
    need only JAX and numpy: importing them with yaml, cv2 and matplotlib
    made unimportable must work, and must not load them."""
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {_BLOCKED!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import plslam_tpu.pipeline, plslam_tpu.vo, plslam_tpu.batch_vo
import plslam_tpu.backend.ba, plslam_tpu.backend.mapping
import plslam_tpu.backend.loop, plslam_tpu.backend.pgo
import plslam_tpu.backend.vocab, plslam_tpu.io.synthetic
import plslam_tpu.parallel.dist_ba, plslam_tpu.parallel.dist_gba
loaded = [m for m in {_BLOCKED!r} if m in sys.modules]
assert not loaded, loaded
print("imports ok")
"""
    r = _run(["-c", code], JAX_PLATFORMS="cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "imports ok" in r.stdout
