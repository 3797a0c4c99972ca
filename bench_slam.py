"""Secondary benchmark: full SLAM pipeline (tracking + threaded mapping +
local BA) frames/s, and local-BA solver iterations/s, on one NVIDIA GPU.
bench.py remains the headline single metric; this script prints one JSON
line per metric, each naming its device.  Without a GPU it exits
non-zero and prints no result.
"""

import json
import time

import jax

from plslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from plslam_tpu.backend import ba as ba_mod
from plslam_tpu.backend.mapping import MapConfig
from plslam_tpu.config import PLSLAMConfig
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.io.synthetic import (SyntheticScene, ba_problem,
                                    circular_trajectory)
from plslam_tpu.pipeline import PLSLAM

N_FRAMES = 16


def bench_slam():
    scene = SyntheticScene(n_points=600, n_lines=60, seed=0,
                           width=752, height=480,
                           fx=435.2, fy=435.2, cx=367.4, cy=252.2)
    cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy,
                              scene.b, width=scene.width, height=scene.height)
    cfg = PLSLAMConfig(orb_nfeatures=1200, lsd_nfeatures=256,
                       min_entropy_ratio=0.99)   # KF-heavy: stress mapping
    slam = PLSLAM(cam, cfg, MapConfig(local_ba_kf=8, ba_points=2048,
                                      ba_lines=256, ba_pobs=8192,
                                      ba_lobs=2048))
    poses = circular_trajectory(N_FRAMES + 4, step_t=0.05)
    frames = [scene.render_stereo(T, noise=1.0) for T in poses]
    dev = [(jnp.asarray(il), jnp.asarray(ir)) for il, ir in frames]
    # warmup (compiles)
    for i in range(4):
        slam.process(*dev[i], timestamp=0.05 * i)
    slam.wait_until_idle()
    t0 = time.time()
    for i in range(4, 4 + N_FRAMES):
        slam.process(*dev[i], timestamp=0.05 * i)
    slam.wait_until_idle()
    dt = time.time() - t0
    n_kf = len(slam.mapper.map.keyframes)
    slam.finish(run_gba=False)
    return N_FRAMES / dt, n_kf


def bench_ba_iters():
    """LM iterations/s of the Schur-complement local BA at the default
    local-map problem size."""
    prob, _, _, _ = ba_problem(_CAM32, K=8, P=512, L=64)
    cfg = ba_mod.BAConfig()
    run = jax.jit(lambda p: ba_mod.lm_rounds(p, _CAM32, cfg, p.p_valid,
                                             p.l_valid, 10))
    jax.block_until_ready(run(prob))
    n_rep = 5
    t0 = time.time()
    for _ in range(n_rep):
        r = run(prob)
    jax.block_until_ready(r)
    return 10 * n_rep / (time.time() - t0)


_CAM32 = StereoCamera.create(435.2, 435.2, 367.4, 252.2, 0.110074,
                             dtype=jnp.float32)


def main():
    import sys

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench_slam: the default JAX device is {dev.platform!r}, "
              f"not a GPU; no result", file=sys.stderr)
        sys.exit(2)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    fps, n_kf = bench_slam()
    print(json.dumps({"metric": "full_slam_frames_per_s",
                      "value": round(fps, 3), "unit": "frames/s",
                      "vs_baseline": round(fps / 20.0, 3),
                      "device": device}))
    iters = bench_ba_iters()
    print(json.dumps({"metric": "local_ba_lm_iterations_per_s",
                      "value": round(iters, 2), "unit": "iters/s",
                      "vs_baseline": None, "device": device}))
    print(f"# keyframes mapped during bench: {n_kf}")


if __name__ == "__main__":
    main()
