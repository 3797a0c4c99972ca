"""Batched-VO B-sweep: per-stream and aggregate frames/s at B in
{1, 2, 4, 8, 16} on the available accelerator.

The data-parallel scaling axis of SURVEY.md §2.4 ("DP = per-frame
batching"): B independent stereo streams tracked in lockstep, detection
as ONE flat (2B, H, W) program.  Prints one JSON line per B for the
BASELINE.md table.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

from plslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from plslam_tpu.batch_vo import BatchedVisualOdometry
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.frontend.frame import FrontendConfig
from plslam_tpu.frontend.tracker import TrackerConfig
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory

N_WARMUP = 3
N_FRAMES = 12


def bench_one(B: int, frames_by_stream):
    cam = StereoCamera.create(435.2, 435.2, 367.4, 252.2, 0.110074,
                              width=752, height=480)
    bvo = BatchedVisualOdometry(B, cam,
                                FrontendConfig(n_points=1200, n_lines=256),
                                TrackerConfig())
    il0 = jnp.stack([frames_by_stream[b][0][0] for b in range(B)])
    ir0 = jnp.stack([frames_by_stream[b][0][1] for b in range(B)])
    bvo.initialize(il0, ir0)
    for i in range(1, N_WARMUP + 1):
        res = bvo.process(
            jnp.stack([frames_by_stream[b][i][0] for b in range(B)]),
            jnp.stack([frames_by_stream[b][i][1] for b in range(B)]))
    _ = np.asarray(res.err)
    t0 = time.time()
    for i in range(N_WARMUP + 1, N_WARMUP + 1 + N_FRAMES):
        res = bvo.process(
            jnp.stack([frames_by_stream[b][i][0] for b in range(B)]),
            jnp.stack([frames_by_stream[b][i][1] for b in range(B)]))
    err = np.asarray(res.err)  # sync the sequential chain
    dt = time.time() - t0
    assert np.isfinite(err).all()
    agg = B * N_FRAMES / dt
    return agg, agg / B


def main():
    max_b = 16
    scenes = [SyntheticScene(n_points=600, n_lines=60, seed=s,
                             width=752, height=480,
                             fx=435.2, fy=435.2, cx=367.4, cy=252.2)
              for s in range(max_b)]
    poses = circular_trajectory(N_WARMUP + N_FRAMES + 1, step_t=0.05)
    frames_by_stream = []
    for s in scenes:
        frames_by_stream.append([
            tuple(jnp.asarray(x) for x in s.render_stereo(T, noise=1.0))
            for T in poses])

    single = None
    for B in (1, 2, 4, 8, 16):
        agg, per = bench_one(B, frames_by_stream)
        if B == 1:
            single = per
        print(json.dumps({
            "metric": f"batch_vo_frames_per_s_B{B}",
            "value": round(agg, 2), "unit": "frames/s (aggregate)",
            "per_stream": round(per, 2),
            "per_stream_vs_single": round(per / single, 3),
        }))


if __name__ == "__main__":
    main()
