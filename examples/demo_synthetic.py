#!/usr/bin/env python
"""End-to-end demo on a rendered synthetic stereo sequence: runs the full
SLAM pipeline (tracking, threaded mapping, local BA, final global BA),
prints per-frame tracking stats, and writes the trajectory + visualization
artifacts into ./demo_out.

Usage:  python examples/demo_synthetic.py [n_frames]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

from plslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from plslam_tpu import viz
from plslam_tpu.backend.mapping import MapConfig
from plslam_tpu.config import PLSLAMConfig
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu.io.trajectory import ate_rmse
from plslam_tpu.pipeline import PLSLAM


def main():
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    out = os.path.join(os.getcwd(), "demo_out")
    os.makedirs(out, exist_ok=True)

    scene = SyntheticScene(seed=5)
    cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy,
                              scene.b, width=scene.width,
                              height=scene.height, dtype=jnp.float32)
    cfg = PLSLAMConfig(orb_nfeatures=512, lsd_nfeatures=128, orb_fast_th=15,
                       min_entropy_ratio=0.99)
    slam = PLSLAM(cam, cfg, MapConfig(local_ba_kf=8, ba_points=2048,
                                      ba_lines=256, ba_pobs=8192,
                                      ba_lobs=2048))
    DT = 0.05  # frame period used for both timestamps and gt lookup
    poses_gt = circular_trajectory(n_frames, step_t=0.12, step_r=0.015)
    t0 = time.time()
    for i, T in enumerate(poses_gt):
        il, ir = scene.render_stereo(T)
        res = slam.process(jnp.asarray(il), jnp.asarray(ir),
                           timestamp=DT * i)
        if res is not None:
            print(f"frame {i:3d}: inliers={int(res.n_inliers):3d} "
                  f"err={float(res.err):.3f} kf={bool(res.is_kf)}")
    traj = slam.finish(run_gba=True)
    dt = time.time() - t0

    kf_pos = np.stack([T[:3, 3] for T in traj])
    gt_pos = np.stack(
        [poses_gt[int(round(t / DT))][:3, 3] for t in slam.kf_timestamps])
    print(f"\n{len(traj)} keyframes in {dt:.1f}s; "
          f"ATE RMSE (aligned) = {ate_rmse(kf_pos, gt_pos, align=True):.4f} m")

    slam.save_trajectory_tum(os.path.join(out, "trajectory.txt"))
    slam.save_logs_jsonl(os.path.join(out, "frames.jsonl"))
    files = viz.render_run(slam, out, gt=np.stack(poses_gt))
    print("artifacts:", [os.path.basename(f) for f in
                         files + [os.path.join(out, "trajectory.txt")]])


if __name__ == "__main__":
    main()
