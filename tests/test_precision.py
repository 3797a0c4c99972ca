"""Every f32 matmul on the per-frame path states full precision.

On the GPU an f32 dot with default precision may run in TF32 (about three
decimal digits), which flips descriptor bits and degrades the pose solve.
The lowered StableHLO of the detection program, of the fused frame step
and of the edge-sharded pose-graph solve must carry HIGHEST on every
dot_general, except the +/-1 Hamming matmul, which is exact at any
precision and states DEFAULT itself.
"""

import re

import jax
import jax.numpy as jnp
import pytest

from plslam_tpu.backend.pgo import PoseGraph
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.frontend.frame import FrontendConfig
from plslam_tpu.frontend.tracker import TrackerConfig
from plslam_tpu.parallel.dist_match import AXIS, make_dist_pgo
from plslam_tpu.parallel.mesh import make_mesh
from plslam_tpu.vo import VisualOdometry, _fresh_state

H, W = 120, 160
_DOT = re.compile(r"stablehlo\.dot_general .*precision = \[(\w+), (\w+)\]"
                  r".*: \((tensor<[^>]*>), (tensor<[^>]*>)\)")
_HAMMING = re.compile(r"tensor<\d+x256xf32>")


def _lowered(program: str) -> str:
    if program == "dist_pgo":
        g = PoseGraph(*(jax.ShapeDtypeStruct(s, d) for s, d in (
            ((8, 4, 4), jnp.float32), ((8,), bool), ((8,), bool),
            ((8,), jnp.int32), ((8,), jnp.int32), ((8, 4, 4), jnp.float32),
            ((8,), jnp.float32), ((8,), bool))))
        return make_dist_pgo(make_mesh(2, AXIS), iters=2).lower(g).as_text()
    cam = StereoCamera.create(100.0, 100.0, 80.0, 60.0, 0.11, width=W,
                              height=H, dtype=jnp.float32)
    vo = VisualOdometry(cam, FrontendConfig(n_points=64, n_lines=64),
                        TrackerConfig())
    imgs = jax.ShapeDtypeStruct((2, H, W), jnp.float32)
    th = jax.ShapeDtypeStruct((), jnp.float32)
    if program == "detect":
        return vo._det_both.lower(imgs, th).as_text()
    kp, seg = jax.eval_shape(vo._det_both, imgs, th)
    feats = jax.eval_shape(vo._match_pair, kp, seg)
    state = jax.eval_shape(
        lambda f: _fresh_state(f, 20.0, jnp.float32), feats)
    img = jax.ShapeDtypeStruct((H, W), jnp.float32)
    return vo._step.lower(img, img, state).as_text()


@pytest.mark.parametrize("program", ["detect", "step", "dist_pgo"])
def test_every_f32_dot_is_highest(program):
    txt = _lowered(program)
    dots = [ln for ln in txt.splitlines() if "stablehlo.dot_general" in ln]
    assert dots, "no matmuls found: the probe no longer sees the program"
    parsed = [_DOT.search(ln) for ln in dots]
    assert all(parsed), [ln for ln, m in zip(dots, parsed) if not m][:3]
    loose = [m for m in parsed
             if m.group(1) != "HIGHEST" or m.group(2) != "HIGHEST"]
    for m in loose:
        # the only allowed exception: the (N, 256) x (M, 256) +/-1 matmul
        assert (m.group(1), m.group(2)) == ("DEFAULT", "DEFAULT")
        assert _HAMMING.fullmatch(m.group(3)), m.group(0)
        assert _HAMMING.fullmatch(m.group(4)), m.group(0)
    if program == "step":
        # stereo point + line matching and f2f point + line matching
        assert len(loose) == 4, len(loose)
    else:
        assert not loose
