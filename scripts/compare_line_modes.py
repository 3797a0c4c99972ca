"""The reference's headline evaluation, reproduced: endpoint-parameterized
lines vs Pluecker/orthonormal lines on the same sequence.

The reference's only published result is a qualitative pair of trajectory
plots with the claim "only a small difference between them"
(/root/reference/README.md:14-21, result/xyz.png vs result/plucker.png).
This script runs BOTH line modes of the rebuilt engine over one rendered
synthetic sequence and prints the aligned ATE RMSE of each — the
quantitative version of that comparison (no EuRoC imagery exists in this
environment; BASELINE.md records the numbers).

Run: JAX_PLATFORMS=cpu python scripts/compare_line_modes.py  (or on the GPU)
"""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax

from plslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from plslam_tpu.backend.mapping import MapConfig
from plslam_tpu.config import PLSLAMConfig
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu.io.trajectory import ate_rmse
from plslam_tpu.pipeline import PLSLAM

N_FRAMES = 30
DT = 0.05


def run_mode(plucker: bool, scene, cam, poses):
    cfg = PLSLAMConfig(orb_nfeatures=512, lsd_nfeatures=128, orb_fast_th=15,
                       min_entropy_ratio=0.97,
                       use_line_plucker=plucker)
    slam = PLSLAM(cam, cfg, MapConfig(local_ba_kf=8, ba_points=4096,
                                      ba_lines=256, ba_pobs=16384,
                                      ba_lobs=2048,
                                      plucker_lines=plucker))
    frames = [scene.render_stereo(T) for T in poses]
    for i, (il, ir) in enumerate(frames):
        slam.process(jnp.asarray(il), jnp.asarray(ir), timestamp=DT * i)
    traj = slam.finish(run_gba=True)
    kf_times = slam.kf_timestamps
    gt = np.stack([poses[int(round(t / DT))][:3, 3] for t in kf_times])
    est = np.stack([np.asarray(T)[:3, 3] for T in traj])
    return ate_rmse(est, gt, align=True), len(traj)


def main():
    scene = SyntheticScene(seed=5)
    cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy,
                              scene.b, width=scene.width,
                              height=scene.height, dtype=jnp.float32)
    poses = circular_trajectory(N_FRAMES, step_t=0.10, step_r=0.012)
    travel = sum(np.linalg.norm(poses[i + 1][:3, 3] - poses[i][:3, 3])
                 for i in range(len(poses) - 1))
    out = {}
    for plucker in (False, True):
        name = "plucker" if plucker else "endpoint"
        ate, nkf = run_mode(plucker, scene, cam, poses)
        out[name] = ate
        print(f"{name:9s}: ATE RMSE {ate:.5f} m over {travel:.2f} m travel "
              f"({nkf} KFs)")
    diff = abs(out["plucker"] - out["endpoint"])
    print(f"|difference| = {diff:.5f} m "
          f"({100 * diff / max(travel, 1e-9):.2f}% of travel) — the "
          f"reference claims 'only a small difference between them'")


if __name__ == "__main__":
    main()
