"""Per-stage wall profile of the mapping back-end on the real device.

Times each host-orchestrated stage of MapHandler.add_keyframe per KF to
show where the per-KF budget goes (dispatch/transfer vs compute) — the
measurement tool behind BASELINE.md's mapping-throughput table.
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

from plslam_tpu.backend.mapping import KeyframeRecord, MapConfig, MapHandler
from plslam_tpu.config import PLSLAMConfig
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu.vo import VisualOdometry

N_KF = 14
WARM = 4


def main():
    scene = SyntheticScene(n_points=600, n_lines=60, seed=0,
                           width=752, height=480,
                           fx=435.2, fy=435.2, cx=367.4, cy=252.2)
    cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy,
                              scene.b, width=scene.width,
                              height=scene.height)
    cfg = PLSLAMConfig(orb_nfeatures=1200, lsd_nfeatures=256)
    vo = VisualOdometry(cam, cfg.frontend(752), cfg.tracker())
    mapper = MapHandler(cam, MapConfig(local_ba_kf=8, ba_points=2048,
                                       ba_lines=256, ba_pobs=8192,
                                       ba_lobs=2048), cfg.ba(),
                        tracker_cfg=cfg.tracker())

    poses = circular_trajectory(N_KF + 1, step_t=0.05)
    frames = [scene.render_stereo(T, noise=1.0) for T in poses]
    feats0 = vo.initialize(jnp.asarray(frames[0][0]),
                           jnp.asarray(frames[0][1]))
    mapper.initialize(np.eye(4), feats0)

    stages = {}

    def mark(name, t0):
        t1 = time.time()
        stages.setdefault(name, []).append(t1 - t0)
        return t1

    # split the combined-fetch wall time out of the association stage so
    # the table separates host prep + dispatch from the device round trip
    origf = MapHandler._fetch_with_pending

    def timedf(self, out):
        t0 = time.time()
        r = origf(self, out)
        stages.setdefault("  of which: combined fetch", []).append(
            time.time() - t0)
        return r

    MapHandler._fetch_with_pending = timedf

    for i in range(1, N_KF + 1):
        vo.process(jnp.asarray(frames[i][0]), jnp.asarray(frames[i][1]))
        feats = vo.current_features
        vo.mark_keyframe()
        pose = poses[i]

        # the production (fused + deferred) flow: one combined fetch for
        # {pending BA of the previous KF + the whole association + the
        # packed KF features}, then one deferred BA dispatch
        t = time.time()
        kf = mapper._associate_and_insert(pose, feats)
        t = mark("assoc+flushBA (1 fetch)", t)
        mapper._spawn_landmarks(kf)
        t = mark("spawn_landmarks(host)", t)
        mapper.local_bundle_adjustment(defer=True)
        t = mark("ba_assemble+dispatch", t)
        mapper.cull_landmarks()
        t = mark("cull(host)", t)
    t = time.time()
    mapper.flush_ba()
    mark("final ba flush", t)

    print(f"{'stage':28s} {'mean ms':>9s} {'p50 ms':>9s} {'max ms':>9s}")
    tot = 0.0
    for name, ts in stages.items():
        ts = np.asarray(ts[WARM:] if len(ts) > WARM else ts) * 1e3
        if not name.startswith("  "):
            tot += ts.mean()
        print(f"{name:28s} {ts.mean():9.1f} {np.median(ts):9.1f} "
              f"{ts.max():9.1f}")
    print(f"{'TOTAL per KF':28s} {tot:9.1f}  ->  {1e3 / tot:.1f} KF/s")
    print(f"map: {mapper.map.n_pt} pts, {mapper.map.n_ls} lines, "
          f"{len(mapper.map.keyframes)} KFs")


if __name__ == "__main__":
    main()
