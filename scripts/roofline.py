"""Speed-of-light analysis of the per-frame hot programs on the GPU.

For each of the three per-frame VO programs (point detect+describe, line
detect+LBD, fused match+track) and the local-BA solver, reports:

  - wall time per call: N back-to-back calls on distinct inputs, ended by
    ``jax.block_until_ready``, divided by N;
  - XLA's static cost model (compiled.cost_analysis): FLOPs + bytes;
  - achieved GFLOP/s and GB/s, and their share of the card's peaks (the
    matmuls run at HIGHEST precision, i.e. on the FP32 units, so the FLOP
    share is against the FP32 peak).

The peaks are NVIDIA's published figures, keyed by ``device_kind``; a
device missing from the table is an error, not a default.  The card's
power limit is printed beside them: a card set below its maximum cannot
hold its top clock under load.

Run: python scripts/roofline.py
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax

from plslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from plslam_tpu.backend import ba as ba_mod
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.frontend.frame import FrontendConfig
from plslam_tpu.frontend.tracker import TrackerConfig
from plslam_tpu.io.synthetic import (SyntheticScene, ba_problem,
                                    circular_trajectory)
from plslam_tpu.vo import VisualOdometry, _match_and_track

# Published peaks (NVIDIA H100 data sheet, SXM5 part, dense rates without
# sparsity, at the full 700 W power limit).  Keyed by jax device_kind.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops_bf16": 989e12, "flops_tf32": 495e12,
                              "flops_f32": 67e12, "hbm": 3.35e12},
}
N = 24


def peaks_for(dev) -> dict:
    if dev.device_kind not in PEAKS:
        raise SystemExit(f"roofline: no published peaks for device_kind "
                         f"{dev.device_kind!r}; add them to PEAKS with "
                         f"their source")
    return PEAKS[dev.device_kind]


def timed(fn, inputs, n=N):
    """Seconds per call: n back-to-back calls ended by block_until_ready
    (after one warm-up pass over the same inputs)."""
    jax.block_until_ready([fn(x) for x in inputs])
    t0 = time.perf_counter()
    jax.block_until_ready([fn(x) for x in inputs])
    return (time.perf_counter() - t0) / n


def cost_of(lowered):
    ca = lowered.compile().cost_analysis()
    return float(ca.get("flops", 0.0)), float(ca.get("bytes accessed", 0.0))


def main():
    import subprocess

    dev = jax.devices()[0]
    peaks = peaks_for(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    scene = SyntheticScene(n_points=600, n_lines=60, seed=0,
                           width=752, height=480,
                           fx=435.2, fy=435.2, cx=367.4, cy=252.2)
    cam = StereoCamera.create(scene.fx, scene.fy, scene.cx, scene.cy,
                              scene.b, width=scene.width,
                              height=scene.height)
    fcfg = FrontendConfig(n_points=1200, n_lines=256)
    tcfg = TrackerConfig()
    vo = VisualOdometry(cam, fcfg, tcfg)
    poses = circular_trajectory(3, step_t=0.05)
    il, ir = scene.render_stereo(poses[0], noise=1.0)
    vo.initialize(jnp.asarray(il), jnp.asarray(ir))
    il, ir = scene.render_stereo(poses[1], noise=1.0)
    base = jnp.stack([jnp.asarray(il), jnp.asarray(ir)])
    stacks = [base + 0.01 * i for i in range(N)]
    th = vo.state.fast_th

    rows = []

    # -- stage 1: point detect + describe (batched L/R stack) --
    t = timed(lambda im: vo._det_pts(im, th), stacks)
    fl, by = cost_of(vo._det_pts.lower(base, th))
    rows.append(("point detect+describe", t, fl, by))

    # -- stage 2: line detect + LBD --
    t = timed(lambda im: vo._det_ls(im), stacks)
    fl, by = cost_of(vo._det_ls.lower(base))
    rows.append(("line detect+LBD", t, fl, by))

    # -- stage 3: fused stereo match + f2f + GN track --
    kp_pair = vo._det_pts(base, th)
    seg_pair = vo._det_ls(base)
    st = vo.state
    fn = lambda kp: _match_and_track(kp, seg_pair, st, cam, fcfg, tcfg,
                                     vo.params)
    kps = [vo._det_pts(s, th) for s in stacks]
    t = timed(fn, kps)
    fl, by = cost_of(_match_and_track.lower(kp_pair, seg_pair, st, cam,
                                            fcfg, tcfg, vo.params))
    rows.append(("match+f2f+GN track", t, fl, by))

    # -- local BA solver (default local problem size) --
    cam32 = StereoCamera.create(435.2, 435.2, 367.4, 252.2, 0.110074,
                                dtype=jnp.float32)
    prob, _, _, _ = ba_problem(cam32, K=8, P=512, L=64)
    bacfg = ba_mod.BAConfig()
    run = jax.jit(lambda p: ba_mod.lm_rounds(p, cam32, bacfg, p.p_valid,
                                             p.l_valid, 10))
    probs = [jax.tree.map(lambda x: x, prob) for _ in range(N)]
    t = timed(run, probs)
    fl, by = cost_of(run.lower(prob))
    rows.append(("local BA (10 LM iters, 8KF/512pt/64ls)", t, fl, by))

    print(f"# device: {dev.device_kind} ({smi})  published peaks: "
          f"{peaks['flops_f32']/1e12:.0f} TFLOP/s f32, "
          f"{peaks['hbm']/1e9:.0f} GB/s")
    hdr = (f"{'stage':40s} {'ms':>7s} {'GFLOP':>8s} {'MB':>8s} "
           f"{'GFLOP/s':>9s} {'GB/s':>7s} {'%FLOP':>6s} {'%BW':>5s}")
    print(hdr)
    for name, t, fl, by in rows:
        fr = fl / t
        br = by / t
        print(f"{name:40s} {t*1e3:7.2f} {fl/1e9:8.2f} {by/1e6:8.1f} "
              f"{fr/1e9:9.1f} {br/1e9:7.1f} "
              f"{100*fr/peaks['flops_f32']:6.1f} {100*br/peaks['hbm']:5.1f}")
    tot = sum(r[1] for r in rows[:3])
    print(f"# per-frame total (3 stages): {tot*1e3:.2f} ms "
          f"-> {1.0/tot:.1f} frames/s ceiling")


if __name__ == "__main__":
    main()
