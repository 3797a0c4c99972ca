#!/usr/bin/env python
"""CLI driver — the app/plslam_dataset.cpp equivalent.

Usage:
    python scripts/run_euroc.py DATASET_DIR \
        [--params euroc_params.yaml] [--config config_euroc.yaml] \
        [-o OFFSET] [-n NMAX] [-s STEP] [--gt groundtruth.txt] \
        [--out trajectory.txt] [--no-gba] [--native-loader]

Flags mirror the reference's -o/-n/-s/-c (app/plslam_dataset.cpp:195-218).
Prints per-frame tracking stats and, with --gt, the final ATE RMSE.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset_dir")
    ap.add_argument("--params", default=None,
                    help="camera yaml (reference euroc_params.yaml format)")
    ap.add_argument("--config", default=None, help="run config yaml")
    ap.add_argument("-o", "--offset", type=int, default=0)
    ap.add_argument("-n", "--nmax", type=int, default=0)
    ap.add_argument("-s", "--step", type=int, default=1)
    ap.add_argument("--gt", default=None, help="ground truth for ATE")
    ap.add_argument("--out", default="trajectory.txt")
    ap.add_argument("--no-gba", action="store_true")
    ap.add_argument("--native-loader", action="store_true")
    ap.add_argument("--overlay-every", type=int, default=0, metavar="N",
                    help="render a per-frame diagnosis overlay (tracked "
                         "features, f2f match segments, residual ramp) + "
                         "residual JSONL every N frames (plotStereoFrame "
                         "analog); 0 = off")
    ap.add_argument("--overlay-dir", default="overlays")
    args = ap.parse_args()

    import jax.numpy as jnp

    from plslam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from plslam_tpu.config import PLSLAMConfig
    from plslam_tpu.core.camera import StereoCamera
    from plslam_tpu.io.euroc import EurocDataset, load_euroc_calib, load_groundtruth
    from plslam_tpu.io.trajectory import ate_rmse, associate_timestamps
    from plslam_tpu.pipeline import PLSLAM

    params = args.params or os.path.join(
        os.path.dirname(__file__), "..", "configs", "euroc_params.yaml")
    calib = load_euroc_calib(params)
    cam = StereoCamera.create(calib.fx, calib.fy, calib.cx, calib.cy,
                              calib.baseline, width=calib.width,
                              height=calib.height)
    cfg = (PLSLAMConfig.from_yaml(args.config) if args.config
           else PLSLAMConfig())
    if args.overlay_every:
        import dataclasses
        cfg = dataclasses.replace(cfg, overlay_every=args.overlay_every,
                                  overlay_dir=args.overlay_dir)
    slam = PLSLAM(cam, cfg)

    # honor the params file's images_subfolder_l/r keys (KITTI etc.); fall
    # back to the EuRoC mav0/cam*/data layout
    import yaml as _yaml
    with open(params) as f:
        _p = _yaml.safe_load(f)
    if "images_subfolder_l" in _p:
        from plslam_tpu.io.euroc import StereoDirDataset
        ds = StereoDirDataset(
            args.dataset_dir, calib,
            subfolder_l=_p["images_subfolder_l"],
            subfolder_r=_p["images_subfolder_r"],
            offset=args.offset, nmax=args.nmax, step=args.step,
            rectify_on_host=not args.native_loader)
    else:
        ds = EurocDataset(args.dataset_dir, calib, offset=args.offset,
                          nmax=args.nmax, step=args.step,
                          rectify_on_host=not args.native_loader)
    if args.native_loader:
        from plslam_tpu.native.loader import NativeStereoLoader
        nl = NativeStereoLoader(ds.files_l, ds.files_r, calib.width,
                                calib.height, maps=(calib.map_l, calib.map_r))

        def _native_frames():
            # ONE get() per index: the prefetch loader CONSUMES the frame
            # (done_.erase in Loader::get) — a second get(i) would wait
            # forever.  (Caught by tests/test_disk_e2e.py, which drives
            # this exact path.)
            for i in range(len(ds)):
                il, ir = nl.get(i)
                yield il, ir, ds.timestamps[i]

        frames = _native_frames()
    else:
        frames = (ds[i] for i in range(len(ds)))

    t_start = time.time()
    for i, (il, ir, t) in enumerate(frames):
        res = slam.process(il, ir, t)
        if res is not None and i % 10 == 0:
            print(f"frame {i}: inliers={int(res.n_inliers)} "
                  f"err={float(res.err):.4f} kf={bool(res.is_kf)} "
                  f"({(time.time()-t_start)/max(i,1):.3f}s/frame)")
    slam.finish(run_gba=not args.no_gba)
    slam.save_trajectory_tum(args.out)
    print(f"saved {len(slam.mapper.map.keyframes)} keyframes to {args.out}")

    if args.gt:
        t_gt, pos_gt = load_groundtruth(args.gt)
        est = np.stack([T[:3, 3] for T in slam.keyframe_trajectory()])
        if t_gt is not None:
            ie, ig = associate_timestamps(slam.kf_timestamps, t_gt)
            est, pos_gt = est[ie], pos_gt[ig]
        else:
            n = min(len(est), len(pos_gt))
            est, pos_gt = est[:n], pos_gt[:n]
        err = ate_rmse(est, pos_gt, align=True)
        print(json.dumps({"ate_rmse_m": round(err, 4),
                          "n_keyframes": len(est)}))


if __name__ == "__main__":
    main()
