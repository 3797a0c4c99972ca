"""Hardened end-to-end evaluation: 500+ frames of the FULL pipeline
(image extraction -> VO -> threaded mapping/LBA -> final chunked GBA)
under photometric nuisances — rolling illumination (exposure gain +
black-level bias), sensor noise, and stereo-consistent textureless
occluders — in BOTH line parameterizations, at the natural keyframe rate.
Reports per-mode tracked frames, KF count, and Umeyama-aligned ATE RMSE,
and dumps TUM trajectories (the EuRoC-protocol stand-in while no real
image data exists in this environment; VERDICT r3 next-round #6).

Run: python scripts/e2e_robust.py [N_FRAMES]   (GPU or CPU)
"""

import json
import os
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax

from plslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

from plslam_tpu.config import PLSLAMConfig
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu.io.trajectory import ate_rmse, save_tum
from plslam_tpu.pipeline import PLSLAM

N_FRAMES = int(sys.argv[1]) if len(sys.argv) > 1 else 500


def run_mode(plucker: bool, frames, poses, cam):
    from plslam_tpu.backend.mapping import MapConfig

    cfg = PLSLAMConfig(use_line_plucker=plucker, use_loop_closure=False,
                       multithread_slam=True)
    # 200+ keyframes at the natural KF rate: size the BA capacities so
    # nothing overflows (the capacity warnings are loud, not silent —
    # give the long run the budget it needs)
    mcfg = MapConfig(use_lines=True, plucker_lines=plucker,
                     local_ba_kf=16, ba_points=2048, ba_lines=256,
                     ba_pobs=16384, ba_lobs=2048)
    if os.environ.get("E2E_DEFAULT_CAPS"):
        mcfg = None
    slam = PLSLAM(cam, cfg, mcfg)
    t0 = time.time()
    for i, (il, ir) in enumerate(frames):
        slam.process(il, ir, timestamp=0.05 * i)
    slam.wait_until_idle()
    track_wall = time.time() - t0
    slam.finish(run_gba=True)
    kfs = slam.mapper.map.keyframes
    ts = np.asarray(slam.kf_timestamps)
    idx = np.clip((ts / 0.05).round().astype(int), 0, len(poses) - 1)
    est = np.stack([k.T_w_k[:3, 3] for k in kfs])
    gt = np.stack([poses[i][:3, 3] for i in idx])
    ate = ate_rmse(est, gt)
    mode = "plucker" if plucker else "endpoint"
    os.makedirs("e2e_robust_out", exist_ok=True)
    save_tum(os.path.join("e2e_robust_out", f"{mode}.tum"), ts,
             [k.T_w_k for k in kfs])
    good = sum(1 for lg in slam.logs if lg.good)
    out = {
        "mode": mode, "frames": len(frames), "good_frames": good,
        "keyframes": len(kfs), "ate_rmse_m": round(float(ate), 4),
        "path_len_m": round(float(np.linalg.norm(
            np.diff(gt, axis=0), axis=1).sum()), 2),
        "track_fps": round(len(frames) / track_wall, 1),
    }
    print(json.dumps(out), flush=True)
    return out


def main():
    scene = SyntheticScene(n_points=1600, n_lines=160, seed=3,
                           width=752, height=480,
                           fx=435.2, fy=435.2, cx=367.4, cy=252.2)
    # deep world so a long run keeps features in view
    rng = np.random.default_rng(9)
    scene.P[:, 2] = rng.uniform(2.0, 30.0, len(scene.P))
    scene.LA[:, 2] = rng.uniform(2.0, 28.0, len(scene.LA))
    scene.LB[:, 2] = scene.LA[:, 2] + rng.uniform(-1.0, 1.0, len(scene.LB))
    cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy,
                              scene.b, width=scene.width,
                              height=scene.height)
    poses = circular_trajectory(N_FRAMES, step_t=0.02, step_r=0.002)
    print(f"# rendering {N_FRAMES} frames with rolling illumination, "
          "noise=2.0, occluders...", file=sys.stderr, flush=True)
    t0 = time.time()
    frames = []
    for i, T in enumerate(poses):
        gain = 1.0 + 0.25 * np.sin(2 * np.pi * i / 150.0)
        bias = 8.0 * np.sin(2 * np.pi * i / 220.0)
        nocc = 2 if i % 3 == 0 else 0
        frames.append(scene.render_stereo(T, noise=2.0, gain=gain,
                                          bias=bias, n_occluders=nocc))
        if i % 100 == 99:
            print(f"#   rendered {i + 1}/{N_FRAMES} "
                  f"({time.time() - t0:.0f}s)", file=sys.stderr, flush=True)
    for plucker in (True, False):
        run_mode(plucker, frames, poses, cam)


if __name__ == "__main__":
    main()
