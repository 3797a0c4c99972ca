"""Interleaved A/B harness on the real chip: two VisualOdometry variants
alternate timing windows in ONE process, so shared-chip drift hits both
equally.  Currently wired to compare TrackerConfig.early_exit (GN as a
lax.while_loop ending on the reference's stopping rules) against the
fixed-length masked-scan form (identical numerics, full 5+10 budget).

Usage: python scripts/ab_fused_step.py [n_rounds]
"""

import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "")
sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax

from plslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.frontend.frame import FrontendConfig
from plslam_tpu.frontend.tracker import TrackerConfig
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu.vo import VisualOdometry

N_FRAMES = 20


def main():
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    scene = SyntheticScene(n_points=600, n_lines=60, seed=0,
                           width=752, height=480,
                           fx=435.2, fy=435.2, cx=367.4, cy=252.2)
    cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy, scene.b,
                              width=scene.width, height=scene.height)
    fcfg = FrontendConfig(n_points=1200, n_lines=256)
    vo_a = VisualOdometry(cam, fcfg, TrackerConfig(early_exit=True))
    vo_b = VisualOdometry(cam, fcfg, TrackerConfig(early_exit=False))
    poses = circular_trajectory(N_FRAMES + 4, step_t=0.05)
    frames = [tuple(map(jnp.asarray, scene.render_stereo(T, noise=1.0)))
              for T in poses]
    for vo in (vo_a, vo_b):
        vo.prewarm(frames[0][0].shape, frames[0][0].dtype)

    def run(vo):
        vo.initialize(*frames[0])
        for i in range(1, 4):
            res = vo.process(*frames[i])
        _ = float(res.err)
        t0 = time.time()
        for i in range(3, 3 + N_FRAMES):
            res = vo.process(*frames[i])
        _ = float(res.err)
        return N_FRAMES / (time.time() - t0), res

    a, b = [], []
    for r in range(rounds):
        fa, ra = run(vo_a)
        fb, rb = run(vo_b)
        a.append(fa)
        b.append(fb)
        print(f"round {r}: A(early) {fa:7.1f}  B(scan) {fb:7.1f}"
              f"   errA={float(ra.err):.5f} errB={float(rb.err):.5f}",
              flush=True)
    print(f"median A {np.median(a):.1f}  B {np.median(b):.1f}"
          f"  best A {max(a):.1f}  B {max(b):.1f}")


if __name__ == "__main__":
    main()
