#!/usr/bin/env python3
"""Smoke test: the full stereo point+line SLAM path on one NVIDIA GPU.

Drives the system through the entry points a user calls, at EuRoC width
(752x480 stereo, 1200 ORB slots, 256 line slots: the bench.py
configuration), and checks every result against a plain reference:

  0. preflight: the GPU's name and power limit, JAX version and devices;
     no GPU -> exit 2 before any phase (there is no CPU fallback);
  1. stages against references at real widths: patch gathers vs the
     one-hot reference on the CPU backend, the +/-1 Hamming matmul vs
     popcount, blur/Sobel/pyramid vs float64 numpy, one frame's
     detect+describe on the GPU vs the same program on the CPU backend,
     and the LM bundle adjustment vs a CPU float64 run;
  2. full SLAM in Pluecker mode (threaded mapping + local BA, then the
     final global BA) over 120 frames, with ATE against the truth;
  3. endpoint mode with loop closure on a route that revisits its start;
  4. batched VO (B=4 streams) against single-stream VO.

Every check prints its bound and the precision it runs at.  A failed
check or phase makes the run exit 1; the last line of a passing run is
one JSON object naming the device.  The times it prints are smoke
numbers, not benchmark numbers.

    python chip_smoke.py             # one GPU: phases 0-4
    python chip_smoke.py --four      # four GPUs: the sharded paths only
    python chip_smoke.py --rehearse  # CPU, 376x240: control-flow rehearsal,
                                     # prints no result line
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))

# the bench.py / bench_slam.py scene: EuRoC geometry and feature budget
EUROC = dict(width=752, height=480, fx=435.2, fy=435.2, cx=367.4, cy=252.2)
HALF = dict(width=376, height=240, fx=217.6, fy=217.6, cx=183.7, cy=126.1)

_failed: list[str] = []

# frames per lap of the loop-closure route (phase 3)
LOOP_LAP = 140

# seconds spent in XLA compilation, summed per phase (set-up, reported
# apart from the steady-state numbers)
_compile_s: list[float] = [0.0]


def _on_event_duration(event: str, duration: float, **_) -> None:
    if event == "/jax/core/compile/backend_compile_duration":
        _compile_s[0] += duration


class CallTimer:
    """Wall time of every call to one bound method of ``obj`` (for the
    per-stage lines of phases 2-3; the workers call it on their threads)."""

    def __init__(self, obj, name: str):
        self.total, self.count = 0.0, 0
        fn = getattr(obj, name)

        def timed(*a, **k):
            t0 = time.time()
            try:
                return fn(*a, **k)
            finally:
                self.total += time.time() - t0
                self.count += 1

        setattr(obj, name, timed)

    def __str__(self) -> str:
        return (f"{self.count} calls, {self.total:.2f} s "
                f"({1e3 * self.total / max(self.count, 1):.1f} ms each)")


def check(name: str, ok: bool, detail: str) -> None:
    print(f"  [{'PASS' if ok else 'FAIL'}] {name}: {detail}", flush=True)
    if not ok:
        _failed.append(name)


def phase(title: str, fn, *args) -> None:
    """Run one phase; an exception fails it (and the run) but lets the
    later phases report."""
    print(f"\n== {title}", flush=True)
    t0 = time.time()
    _compile_s[0] = 0.0
    try:
        fn(*args)
    except Exception:
        traceback.print_exc()
        _failed.append(title)
        print(f"  [FAIL] {title}: raised", flush=True)
    print(f"  ({time.time() - t0:.1f} s wall, of which {_compile_s[0]:.1f} s "
          f"XLA compilation)", flush=True)


# ---------------------------------------------------------------------------
# 0. preflight
# ---------------------------------------------------------------------------


def gpu_name_and_power() -> str | None:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip() if r.returncode == 0 else None


def preflight(rehearse: bool, n_devices: int):
    """Fail fast, printing no result, unless the program and the GPU are
    both here."""
    try:
        import plslam_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the plslam_tpu package is not importable from "
              f"{REPO} ({e}); run from a checkout of the repository",
              file=sys.stderr)
        sys.exit(2)
    smi = gpu_name_and_power()
    print(smi if smi else "nvidia-smi: no GPU found", flush=True)

    import jax

    from plslam_tpu.utils.compile_cache import enable_compile_cache

    print(f"jax {jax.__version__}; devices: {jax.devices()}; compile "
          f"cache: {enable_compile_cache()}", flush=True)
    jax.monitoring.register_event_duration_secs_listener(_on_event_duration)
    dev = jax.devices()[0]
    if not rehearse and dev.platform != "gpu":
        print(f"chip_smoke: the default JAX device is {dev.platform!r}, "
              f"not a GPU; nothing was run", file=sys.stderr)
        sys.exit(2)
    if len(jax.devices()) < n_devices:
        print(f"chip_smoke: needs {n_devices} devices, found "
              f"{len(jax.devices())}", file=sys.stderr)
        sys.exit(2)
    return dev


# ---------------------------------------------------------------------------
# shared set-up
# ---------------------------------------------------------------------------


class Setup:
    def __init__(self, rehearse: bool):
        import jax.numpy as jnp

        from plslam_tpu.core.camera import StereoCamera
        from plslam_tpu.frontend.frame import FrontendConfig

        self.rehearse = rehearse
        self.geom = HALF if rehearse else EUROC
        self.n_points, self.n_lines = (512, 128) if rehearse else (1200, 256)
        self.fcfg = FrontendConfig(n_points=self.n_points,
                                   n_lines=self.n_lines)
        g = self.geom
        self.cam = StereoCamera.create(g["fx"], g["fy"], g["cx"], g["cy"],
                                       0.110074, width=g["width"],
                                       height=g["height"], dtype=jnp.float32)

    def scene(self, seed=0, n_points=600, n_lines=60):
        from plslam_tpu.io.synthetic import SyntheticScene

        return SyntheticScene(n_points=n_points, n_lines=n_lines, seed=seed,
                              **self.geom)

    def deep_scene(self, seed):
        """The scripts/e2e_robust.py world: deep enough that a long run
        keeps features in view."""
        import numpy as np

        scene = self.scene(seed=seed, n_points=1600, n_lines=160)
        rng = np.random.default_rng(9)
        scene.P[:, 2] = rng.uniform(2.0, 30.0, len(scene.P))
        scene.LA[:, 2] = rng.uniform(2.0, 28.0, len(scene.LA))
        scene.LB[:, 2] = scene.LA[:, 2] + rng.uniform(-1.0, 1.0,
                                                      len(scene.LB))
        return scene


def _popcount_rows(a, b):
    import numpy as np

    x = np.bitwise_xor(a, b).view(np.uint8)
    return np.unpackbits(x, axis=-1).sum(-1)


# ---------------------------------------------------------------------------
# 1. stages against references
# ---------------------------------------------------------------------------


def phase_stages(S: Setup, dev):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from plslam_tpu.frontend.frame import make_batched_detectors
    from plslam_tpu.ops import image, lbd, orb
    from plslam_tpu.ops.descriptors import (hamming_distance_matrix,
                                            hamming_distance_matrix_popcount)
    from plslam_tpu.ops.patches import extract_patches, extract_patches_onehot

    cpu = jax.devices("cpu")[0]
    H, W = S.geom["height"], S.geom["width"]
    il, ir = S.scene(seed=0).render_stereo(np.eye(4), noise=1.0)
    imgs = np.stack([il, ir])
    imgs_dev = jax.device_put(imgs, dev)
    imgs_cpu = jax.device_put(imgs, cpu)
    det_pts, det_ls = make_batched_detectors(S.fcfg)
    kp_d, pdesc_d = det_pts(imgs_dev, 20.0)
    seg_d, ldesc_d = det_ls(imgs_dev)
    kp_c, pdesc_c = det_pts(imgs_cpu, 20.0)
    seg_c, ldesc_c = det_ls(imgs_cpu)

    # -- patch gathers vs the one-hot reference (CPU backend, HIGHEST) ----
    print("  patches: gather on the device vs one-hot matmuls at HIGHEST "
          "on the CPU backend; bound: bit-identical")
    edge = np.asarray([[0.0, 0.0], [W - 1, H - 1], [2.5, H / 2],
                       [W - 3.5, 5.0], [-40.0, 30.0], [W + 60.0, H + 9.0]],
                      np.float32)
    xy = np.concatenate([np.asarray(kp_d.xy),
                         np.broadcast_to(edge, (2,) + edge.shape)], axis=1)
    smoothed = jax.jit(jax.vmap(lambda im: image.blur(im, 2.0)))(imgs_cpu)
    gx, gy = jax.jit(jax.vmap(lambda im: image.sobel(image.blur(im, 1.4))))(
        imgs_cpu)
    c2 = np.asarray(jax.vmap(lbd._patch_centers)(seg_d.sp, seg_d.ep)
                    ).reshape(2, -1, 2)
    cases = [("ORB", smoothed, xy, orb.PATCH, orb.CENTER),
             ("LBD gx", gx, c2, lbd.PATCH, lbd.CENTER),
             ("LBD gy", gy, c2, lbd.PATCH, lbd.CENTER)]
    for name, field, pts, P, c in cases:
        gather = jax.jit(jax.vmap(lambda f, p: extract_patches(f, p, P, c)))
        onehot = jax.jit(jax.vmap(
            lambda f, p: extract_patches_onehot(f, p, P, c)))
        got = np.asarray(gather(jax.device_put(field, dev),
                                jax.device_put(pts, dev)))
        want = np.asarray(onehot(field, jax.device_put(pts, cpu)))
        n_bad = int((got != want).sum())
        check(f"{name} patches {got.shape}", n_bad == 0,
              f"{n_bad} differing values")

    # -- Hamming: +/-1 matmul (DEFAULT precision) vs popcount -------------
    print("  hamming: +/-1 matmul at DEFAULT precision (TF32 on the GPU) "
          "vs XOR+popcount; bound: exact")
    rng = np.random.default_rng(1)
    d1 = jnp.asarray(rng.integers(0, 2**32, (S.n_points, 8), dtype=np.uint64)
                     .astype(np.uint32), device=dev)
    d2 = jnp.asarray(rng.integers(0, 2**32, (S.n_points, 8), dtype=np.uint64)
                     .astype(np.uint32), device=dev)
    hm = np.asarray(jax.jit(hamming_distance_matrix)(d1, d2))
    hp = np.asarray(jax.jit(hamming_distance_matrix_popcount)(d1, d2))
    check(f"hamming {hm.shape}", np.array_equal(hm, hp),
          f"{int((hm != hp).sum())} differing distances")

    # -- image ops vs float64 numpy ----------------------------------------
    print("  image ops: banded matmuls at HIGHEST vs float64 numpy; "
          "bound: max abs error 1e-3 on the 0..255 image")
    img64 = np.asarray(il, np.float64)
    img_d = jax.device_put(il, dev)

    def np_corr(x, taps, axis):
        taps = np.asarray(taps, np.float64)
        r = (len(taps) - 1) // 2
        pad = [(0, 0), (0, 0)]
        pad[axis] = (r, r)
        xp = np.pad(x, pad, mode="edge")
        n = x.shape[axis]
        return sum(t * np.take(xp, np.arange(j, j + n), axis=axis)
                   for j, t in enumerate(taps))

    def np_sep(x, row_taps, col_taps):
        return np_corr(np_corr(x, row_taps, 0), col_taps, 1)

    def np_resize(x, h, w):
        def mat(n_out, n_in):
            s = n_out / n_in
            x_in = (np.arange(n_out) + 0.5) / s - 0.5
            t = (np.arange(n_in)[None, :] - x_in[:, None]) * min(s, 1.0)
            m = np.maximum(0.0, 1.0 - np.abs(t))
            return m / m.sum(1, keepdims=True)
        return mat(h, x.shape[0]) @ x @ mat(w, x.shape[1]).T

    errs = {}
    for sigma in (2.0, 1.4):
        taps = image._gaussian_taps(sigma)
        got = np.asarray(jax.jit(lambda x: image.blur(x, sigma))(img_d))
        errs[f"blur s={sigma}"] = np.abs(got - np_sep(img64, taps, taps)).max()
    gx_d, gy_d = jax.jit(image.sobel)(img_d)
    sm, df = (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0)
    errs["sobel gx"] = np.abs(np.asarray(gx_d) - np_sep(img64, sm, df)).max()
    errs["sobel gy"] = np.abs(np.asarray(gy_d) - np_sep(img64, df, sm)).max()
    levels = jax.jit(lambda x: tuple(image.build_pyramid(
        x, S.fcfg.n_levels, S.fcfg.scale_factor)))(img_d)
    for i, lv in enumerate(levels[1:], 1):
        h, w = lv.shape
        errs[f"pyramid level {i} {h}x{w}"] = np.abs(
            np.asarray(lv) - np_resize(img64, h, w)).max()
    for name, e in errs.items():
        check(name, e <= 1e-3, f"max abs error {e:.2e}")

    # -- one frame's detect+describe: device vs CPU backend ---------------
    print("  detect+describe: the same jitted programs (full-f32 matmul "
          "scope) on the device vs the CPU backend; bounds: keypoint "
          "count within 2% and >=97% of keypoints within 0.01 px; segment "
          "count within 5% and >=85% of segments with both endpoints "
          "within 0.05 px (line support regions are binned by gradient "
          "angle, and a last-bit difference in atan2 between the backends "
          "moves a pixel across a bin edge); descriptor bits differing on "
          "matched features <=1%")
    for b in range(2):
        vd = np.asarray(kp_d.valid[b])
        vc = np.asarray(kp_c.valid[b])
        xd = np.asarray(kp_d.xy[b])[vd]
        xc = np.asarray(kp_c.xy[b])[vc]
        nd, nc = len(xd), len(xc)
        check(f"image {b} keypoint count", abs(nd - nc) <= 0.02 * max(nc, 1),
              f"device {nd} vs cpu {nc}")
        dist = np.linalg.norm(xd[:, None] - xc[None], axis=-1)
        j = dist.argmin(1)
        hit = dist[np.arange(nd), j] <= 0.01
        check(f"image {b} keypoint positions", hit.mean() >= 0.97,
              f"{hit.mean():.4f} of device keypoints match a cpu one")
        da = np.asarray(pdesc_d[b])[vd][hit]
        dc = np.asarray(pdesc_c[b])[vc][j[hit]]
        rate = _popcount_rows(da, dc).sum() / max(256 * len(da), 1)
        check(f"image {b} ORB descriptor bits", rate <= 0.01,
              f"mismatch rate {rate:.5f} over {len(da)} matched keypoints")

        vd = np.asarray(seg_d.valid[b])
        vc = np.asarray(seg_c.valid[b])
        sd = np.concatenate([np.asarray(seg_d.sp[b]),
                             np.asarray(seg_d.ep[b])], -1)[vd]
        sc = np.concatenate([np.asarray(seg_c.sp[b]),
                             np.asarray(seg_c.ep[b])], -1)[vc]
        check(f"image {b} segment count",
              abs(len(sd) - len(sc)) <= 0.05 * max(len(sc), 1),
              f"device {len(sd)} vs cpu {len(sc)}")
        sc_flip = np.concatenate([sc[:, 2:], sc[:, :2]], -1)
        dd = np.minimum(np.abs(sd[:, None] - sc[None]).max(-1),
                        np.abs(sd[:, None] - sc_flip[None]).max(-1))
        j = dd.argmin(1)
        hit = dd[np.arange(len(sd)), j] <= 0.05
        check(f"image {b} segment endpoints", hit.mean() >= 0.85,
              f"{hit.mean():.4f} of device segments match a cpu one")
        la = np.asarray(ldesc_d[b])[vd][hit]
        lc = np.asarray(ldesc_c[b])[vc][j[hit]]
        rate = _popcount_rows(la, lc).sum() / max(256 * len(la), 1)
        check(f"image {b} LBD descriptor bits", rate <= 0.01,
              f"mismatch rate {rate:.5f} over {len(la)} matched segments")

    # -- LM bundle adjustment: f32 on the device vs f64 on the CPU --------
    print("  bundle adjustment: ba.lm_rounds, 10 iterations, K=8 P=512 L=64 "
          "with 1 px noise; f32 (full-f32 matmuls) on the device vs f64 "
          "on the CPU backend; bound: final cost relative error 1e-3")
    from plslam_tpu.backend import ba
    from plslam_tpu.core.camera import StereoCamera
    from plslam_tpu.io.synthetic import ba_problem

    with jax.enable_x64(True), jax.default_device(cpu):
        cam64 = StereoCamera.create(435.2, 435.2, 367.4, 252.2, 0.110074,
                                    dtype=jnp.float64)
        prob64, _, _, _ = ba_problem(cam64, K=8, P=512, L=64, noise=1.0)
        run64 = jax.jit(lambda p: ba.lm_rounds(p, cam64, ba.BAConfig(),
                                               p.p_valid, p.l_valid, 10))
        _, cost64 = run64(prob64)
        cost64 = float(cost64)
        prob32 = jax.tree.map(lambda x: np.asarray(
            x, np.float32 if x.dtype == np.float64 else x.dtype), prob64)
    cam32 = StereoCamera.create(435.2, 435.2, 367.4, 252.2, 0.110074,
                                dtype=jnp.float32)
    run32 = jax.jit(lambda p: ba.lm_rounds(p, cam32, ba.BAConfig(),
                                           p.p_valid, p.l_valid, 10))
    _, cost32 = run32(jax.device_put(prob32, dev))
    rel = abs(float(cost32) - cost64) / abs(cost64)
    check("LM BA final cost", rel <= 1e-3,
          f"device f32 {float(cost32):.6f} vs cpu f64 {cost64:.6f} "
          f"(rel {rel:.2e})")


# ---------------------------------------------------------------------------
# 2. full SLAM, Pluecker mode
# ---------------------------------------------------------------------------


def _ate(slam, poses, dt=0.05):
    import numpy as np

    from plslam_tpu.io.trajectory import ate_rmse

    traj = slam.keyframe_trajectory()
    idx = [int(round(t / dt)) for t in slam.kf_timestamps]
    est = np.stack([np.asarray(T)[:3, 3] for T in traj])
    gt = np.stack([poses[i][:3, 3] for i in idx])
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    return float(ate_rmse(est, gt, align=True)), path


def phase_slam(S: Setup, dev):
    import jax
    import numpy as np

    from plslam_tpu.backend.mapping import MapConfig
    from plslam_tpu.config import PLSLAMConfig
    from plslam_tpu.io.synthetic import circular_trajectory
    from plslam_tpu.pipeline import PLSLAM

    n_frames, n_warm = (40, 6) if S.rehearse else (120, 10)
    t0 = time.time()
    scene = S.deep_scene(seed=3)
    poses = circular_trajectory(n_frames, step_t=0.02, step_r=0.002)
    frames = [scene.render_stereo(T, noise=1.0) for T in poses]
    print(f"  rendered {n_frames} stereo pairs in {time.time() - t0:.1f} s")

    cfg = PLSLAMConfig(orb_nfeatures=S.n_points, lsd_nfeatures=S.n_lines,
                       multithread_slam=True)
    mcfg = MapConfig(use_lines=True, plucker_lines=True, local_ba_kf=16,
                     ba_points=2048, ba_lines=256, ba_pobs=16384,
                     ba_lobs=2048)
    slam = PLSLAM(S.cam, cfg, mcfg)
    t0 = time.time()
    slam.vo.prewarm(frames[0][0].shape)
    for i in range(n_warm):
        slam.process(*frames[i], timestamp=0.05 * i)
    slam.wait_until_idle()
    jax.block_until_ready(slam.vo.state)
    setup_s, setup_compile_s = time.time() - t0, _compile_s[0]
    t_frame = CallTimer(slam, "process")
    t_kf = CallTimer(slam, "_insert_keyframe")
    t0 = time.time()
    for i in range(n_warm, n_frames):
        slam.process(*frames[i], timestamp=0.05 * i)
    slam.wait_until_idle()
    jax.block_until_ready(slam.vo.state)
    steady_fps = (n_frames - n_warm) / (time.time() - t0)
    steady_compile_s = _compile_s[0] - setup_compile_s
    t0 = time.time()
    slam.finish(run_gba=True)
    gba_s = time.time() - t0

    # detect-stage time alone (one fused point+line detection program)
    imgs = jax.device_put(np.stack(frames[0]), dev)
    th = np.float32(20.0)
    jax.block_until_ready(slam.vo._det_both(imgs, th))
    t0 = time.time()
    for _ in range(20):
        out = slam.vo._det_both(imgs, th)
    jax.block_until_ready(out)
    det_ms = (time.time() - t0) / 20 * 1e3

    stats = dev.memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    n_kf = len(slam.mapper.map.keyframes)
    good = sum(lg.good for lg in slam.logs)
    print(f"  smoke numbers, not benchmark numbers: frames {n_frames}, "
          f"good {good}, keyframes {n_kf}, local BAs "
          f"{slam.mapper.n_local_ba}, set-up (compile + {n_warm} frames) "
          f"{setup_s:.1f} s of which {setup_compile_s:.1f} s XLA "
          f"compilation, steady {steady_fps:.2f} frames/s (tracking + "
          f"threaded mapping, host clock, ends in block_until_ready; "
          f"{steady_compile_s:.1f} s of it compiling), final GBA "
          f"{gba_s:.2f} s, detect stage {det_ms:.3f} ms per stereo pair, "
          f"peak_bytes_in_use {peak}")
    print(f"  steady stages (host wall): process() {t_frame}; keyframe "
          f"insertion on the mapping worker {t_kf}")
    ate, path = _ate(slam, poses)
    check("Pluecker SLAM keyframes and local BA",
          n_kf >= 3 and slam.mapper.n_local_ba >= 1,
          f"{n_kf} keyframes, {slam.mapper.n_local_ba} local BAs")
    check("Pluecker SLAM ATE", ate < 0.05,
          f"{ate:.4f} m over {path:.2f} m (bound 0.05 m, the floor of "
          f"tests/test_slam_e2e.py)")


# ---------------------------------------------------------------------------
# 3. endpoint mode with loop closure
# ---------------------------------------------------------------------------


def phase_loop(S: Setup, dev):
    import numpy as np

    from plslam_tpu.backend.mapping import MapConfig
    from plslam_tpu.config import PLSLAMConfig
    from plslam_tpu.io.synthetic import loop_trajectory
    from plslam_tpu.pipeline import PLSLAM

    n_lap, laps = LOOP_LAP, 1.15
    n_frames = int(n_lap * laps)
    t0 = time.time()
    scene = S.deep_scene(seed=5)
    poses = loop_trajectory(n_lap, laps=1.0) + loop_trajectory(
        n_lap, laps=1.0)[:n_frames - n_lap]
    frames = [scene.render_stereo(T, noise=1.0) for T in poses]
    print(f"  rendered {n_frames} stereo pairs ({laps} laps of a 1.2 m x "
          f"3 m loop) in {time.time() - t0:.1f} s")
    cfg = PLSLAMConfig(orb_nfeatures=S.n_points, lsd_nfeatures=S.n_lines,
                       use_line_plucker=False, use_loop_closure=True,
                       multithread_slam=True, lc_kf_dist=20)
    mcfg = MapConfig(use_lines=True, plucker_lines=False, local_ba_kf=8,
                     ba_points=2048, ba_lines=256, ba_pobs=16384,
                     ba_lobs=2048)
    slam = PLSLAM(S.cam, cfg, mcfg)
    t_frame = CallTimer(slam, "process")
    t_kf = CallTimer(slam, "_insert_keyframe")
    t_lc = CallTimer(slam.loop_closer, "on_new_keyframe")
    t0 = time.time()
    for i, (il, ir) in enumerate(frames):
        slam.process(il, ir, timestamp=0.05 * i)
    slam.wait_until_idle()
    run_s = time.time() - t0
    t0 = time.time()
    slam.finish(run_gba=True)
    n_kf = len(slam.mapper.map.keyframes)
    print(f"  smoke numbers, not benchmark numbers: {n_frames} frames, "
          f"{n_kf} keyframes, {slam.mapper.n_local_ba} local BAs, "
          f"{run_s:.1f} s for the frames (compile included), final GBA "
          f"{time.time() - t0:.2f} s; loop reports {slam.loop_reports}")
    print(f"  stages (host wall): process() {t_frame}; keyframe insertion "
          f"on the mapping worker {t_kf}; loop closure on its worker {t_lc}")
    # a genuine closure joins two keyframes half a lap or more apart in
    # time whose true positions are within 0.5 m of each other
    frame_of = [int(round(t / 0.05)) for t in slam.kf_timestamps]
    genuine = [r for r in slam.loop_reports
               if frame_of[r["kf"]] - frame_of[r["candidate"]] >= n_lap // 2
               and np.linalg.norm(poses[frame_of[r["kf"]]][:3, 3]
                                  - poses[frame_of[r["candidate"]]][:3, 3])
               < 0.5]
    check("loop detected and closed (retrieval, verification, PGO)",
          len(genuine) >= 1 and len(genuine) == len(slam.loop_reports),
          f"{len(slam.loop_reports)} closures, {len(genuine)} genuine "
          f"revisits")
    ate, path = _ate(slam, poses)
    check("endpoint SLAM ATE", ate < 0.25,
          f"{ate:.4f} m over {path:.2f} m (bound 0.25 m, the floor of "
          f"tests/test_slam_endpoint_mode.py)")


# ---------------------------------------------------------------------------
# 4. batched VO
# ---------------------------------------------------------------------------


def _stream_frames(S: Setup, seeds, n):
    from plslam_tpu.io.synthetic import circular_trajectory

    poses = circular_trajectory(n)
    return [[S.scene(seed=s).render_stereo(T) for T in poses] for s in seeds]


def phase_batch(S: Setup, dev):
    import numpy as np

    from plslam_tpu.batch_vo import BatchedVisualOdometry
    from plslam_tpu.frontend.tracker import TrackerConfig
    from plslam_tpu.vo import VisualOdometry

    B, n = 4, 5
    streams = _stream_frames(S, (3, 8, 11, 17), n)
    single = []
    for fr in streams:
        vo = VisualOdometry(S.cam, S.fcfg, TrackerConfig())
        vo.initialize(*fr[0])
        single.append([vo.process(*f) for f in fr[1:]])
    bvo = BatchedVisualOdometry(B, S.cam, S.fcfg, TrackerConfig())
    stack = lambda t, k: np.stack([fr[t][k] for fr in streams])
    bvo.initialize(stack(0, 0), stack(0, 1))
    worst, good_same, inl = 0.0, True, 0
    for t in range(1, n):
        res = bvo.process(stack(t, 0), stack(t, 1))
        for b in range(B):
            r = single[b][t - 1]
            worst = max(worst, float(np.abs(np.asarray(res.T_f_w[b])
                                            - np.asarray(r.T_f_w)).max()))
            good_same &= bool(res.good[b]) == bool(r.good)
            inl = max(inl, abs(int(res.n_inliers[b]) - int(r.n_inliers)))
    print("  batched VO, B=4 EuRoC-shape streams x 4 tracked frames, vs "
          "single-stream VisualOdometry on the same frames; bound: pose "
          "entries within 2e-2 (the tolerance of tests/test_batch_vo.py)")
    check("batched VO poses", worst <= 2e-2 and good_same,
          f"max |dT| {worst:.2e}, good flags equal: {good_same}, "
          f"max inlier-count difference {inl}")


# ---------------------------------------------------------------------------
# four devices: the sharded paths
# ---------------------------------------------------------------------------


def phase_four_dryrun(S: Setup, dev):
    sys.path.insert(0, REPO)
    import __graft_entry__ as G

    print("  landmark-sharded BA, sharded matcher, edge-sharded PGO and "
          "kf-block GBA on a 4-device mesh, each against its one-device "
          "oracle at full f32 (bounds in __graft_entry__.dryrun_multichip)")
    G.dryrun_multichip(4)
    check("dryrun_multichip(4)", True, "all agreement asserts held")


def phase_four_batch(S: Setup, dev):
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec

    from plslam_tpu.batch_vo import BatchedVisualOdometry
    from plslam_tpu.frontend.tracker import TrackerConfig
    from plslam_tpu.parallel.mesh import make_mesh

    B, n = 4, 3
    streams = _stream_frames(S, (3, 8, 11, 17), n)
    stack = lambda t, k: np.stack([fr[t][k] for fr in streams])
    sharding = NamedSharding(make_mesh(4, "seq"), PartitionSpec("seq"))
    res = {}
    for name, sh in (("unsharded", None), ("sharded", sharding)):
        bvo = BatchedVisualOdometry(B, S.cam, S.fcfg, TrackerConfig(),
                                    sharding=sh)
        bvo.initialize(stack(0, 0), stack(0, 1))
        for t in range(1, n):
            r = bvo.process(stack(t, 0), stack(t, 1))
        res[name] = jax.device_get(r)
    dT = float(np.abs(res["sharded"].T_f_w - res["unsharded"].T_f_w).max())
    same = np.array_equal(res["sharded"].good, res["unsharded"].good)
    print("  batched VO, B=4 sharded one stream per device vs the unsharded "
          "batch on one device; bound: pose entries within 5e-3 (the "
          "tolerance of tests/test_batch_vo.py)")
    check("sharded batched VO", dT <= 5e-3 and same,
          f"max |dT| {dT:.2e}, good flags equal: {same}")


# ---------------------------------------------------------------------------


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-device sharded paths")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU control-flow rehearsal at 376x240; prints no "
                         "result line")
    args = ap.parse_args()
    n_dev = 4 if args.four else 1
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4").strip()

    dev = preflight(args.rehearse, n_dev)
    S = Setup(args.rehearse)
    t0 = time.time()
    if args.four:
        phase("four devices: dryrun_multichip(4)", phase_four_dryrun, S, dev)
        phase("four devices: sharded batched VO", phase_four_batch, S, dev)
    else:
        phase("1. stages against references", phase_stages, S, dev)
        phase("2. full SLAM, Pluecker mode", phase_slam, S, dev)
        phase("3. endpoint mode with loop closure", phase_loop, S, dev)
        phase("4. batched VO", phase_batch, S, dev)
    print(f"\ntotal {time.time() - t0:.1f} s; failed: {_failed or 'none'}",
          flush=True)
    if _failed:
        sys.exit(1)
    if args.rehearse:
        print("rehearsal passed (CPU; no result line)")
        return
    import jax

    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
