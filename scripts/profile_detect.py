"""Sub-stage wall breakdown of the fused detection program.

Times each stage as N back-to-back calls ended by block_until_ready,
divided by N.  Sub-stage programs trace under the same full-f32 matmul
scope as the fused detector.

Usage: python scripts/profile_detect.py [N]
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax

from plslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from plslam_tpu.core.numerics import full_f32_matmuls
from plslam_tpu.frontend.frame import FrontendConfig, make_batched_detectors
from plslam_tpu.io.synthetic import SyntheticScene, circular_trajectory
from plslam_tpu.ops import fast, lbd, lines, orb
from plslam_tpu.ops.image import build_pyramid

N = int(sys.argv[1]) if len(sys.argv) > 1 else 24


def timeit(name, fn, inputs, reducer=None):
    jax.block_until_ready([fn(x) for x in inputs])     # warm (compile)
    t0 = time.time()
    jax.block_until_ready([fn(x) for x in inputs])
    dt = (time.time() - t0) / len(inputs)
    print(f"{name:<42s} {dt * 1e3:7.3f} ms")
    return dt


def main():
    cfg = FrontendConfig(n_points=1200, n_lines=256)
    scene = SyntheticScene(n_points=600, n_lines=60, seed=0,
                           width=752, height=480,
                           fx=435.2, fy=435.2, cx=367.4, cy=252.2)
    poses = circular_trajectory(4, step_t=0.05)
    frames = []
    for T in poses:
        il, ir = scene.render_stereo(T, noise=1.0)
        frames.append(jnp.stack([jnp.asarray(il), jnp.asarray(ir)]))
    imgs_list = [frames[i % len(frames)] for i in range(N)]
    th = jnp.asarray(cfg.fast_th, jnp.float32)

    print(f"device={jax.devices()[0].device_kind} N={N}")

    # --- dispatch floor: a trivial program through the same timing path.
    # If this is ~1 ms, sub-stage numbers below carry that constant each
    # and the per-frame budget is dispatch-bound, not compute-bound.
    tiny = jax.jit(lambda im: im[0, 0, 0] + 1.0)
    timeit("dispatch floor (trivial program)", tiny, imgs_list,
           lambda o: o)
    # chained trivial programs: does enqueueing 2 programs per "frame"
    # pipeline their dispatch overheads or serialize them?
    def tiny2(im):
        a = tiny(im)
        return jax.jit(lambda x: x * 2.0)(a)
    timeit("dispatch floor x2 (two chained)", tiny2, imgs_list,
           lambda o: o)

    # --- full fused program (the actual per-frame dispatch)
    det_pts, det_ls = make_batched_detectors(cfg)
    det_both = jax.jit(lambda imgs: (det_pts(imgs, th), det_ls(imgs)))
    timeit("FUSED point+line detection", det_both, imgs_list,
           lambda o: o[0][0].score[0, 0])
    timeit("point detect+describe (alone)", lambda im: det_pts(im, th),
           imgs_list, lambda o: o[0].score[0, 0])
    timeit("line detect+LBD (alone)", det_ls, imgs_list,
           lambda o: o[0].score[0, 0])

    # --- point sub-stages
    pyr = jax.jit(lambda im: tuple(
        jax.vmap(lambda x: tuple(build_pyramid(x, cfg.n_levels,
                                               cfg.scale_factor)))(im)))
    timeit("  pyramid build", pyr, imgs_list, lambda o: o[0][0, 0, 0])

    levels0 = pyr(imgs_list[0])
    lv_list = [pyr(im) for im in imgs_list]

    score_all = jax.jit(lambda lv: tuple(
        jax.vmap(fast.nms3x3)(jax.vmap(lambda x: fast.fast_score_map(x, 20.0))(l))
        for l in lv))
    timeit("  FAST score+NMS (all levels, XLA)", score_all, lv_list,
           lambda o: o[0][0, 5, 5])

    def sel_all(lv):
        outs = []
        per = cfg.n_points // cfg.n_levels + 1
        for l in lv:
            raw = jax.vmap(lambda x: fast.fast_score_map(x, 20.0))(l)
            s = jax.vmap(fast.nms3x3)(raw)
            outs.append(jax.vmap(
                lambda r, ss: fast.select_corners(r, ss, per, cfg.edge_th))(raw, s))
        return outs
    sel_all_j = jax.jit(sel_all)
    timeit("  score+NMS+select (all levels)", sel_all_j, lv_list,
           lambda o: o[0].score[0, 0])

    det_pyr = jax.jit(jax.vmap(lambda *lv: fast.detect_pyramid(
        list(lv), 20.0, cfg.n_points, cfg.edge_th, cfg.scale_factor)))
    timeit("  detect_pyramid (score..topk)", lambda lv: det_pyr(*lv),
           lv_list, lambda o: o.score[0, 0])

    kp = det_pyr(*levels0)
    desc_fn = jax.jit(full_f32_matmuls(
        lambda im: jax.vmap(orb.describe)(im, kp.xy, kp.valid)))
    timeit("  ORB describe (1200 kp x 2)", desc_fn, imgs_list,
           lambda o: o[0][0, 0, 0])

    # --- line sub-stages
    det_cfg = lines.LineDetectorConfig(max_out=cfg.n_lines,
                                       n_orient=cfg.line_orient_bins)
    seg_fn = jax.jit(jax.vmap(lambda im: lines.detect_segments(im, det_cfg)))
    timeit("  line detect_segments", seg_fn, imgs_list,
           lambda o: o.score[0, 0])
    seg = seg_fn(imgs_list[0])
    lbd_fn = jax.jit(full_f32_matmuls(lambda im: jax.vmap(lbd.describe)(
        im, seg.sp, seg.ep, seg.valid)))
    timeit("  LBD describe", lbd_fn, imgs_list, lambda o: o[0, 0, 0])

    # line stage internals: gradient front
    def grad_front(im):
        g = jax.vmap(lambda x: lines.blur(x, 1.0))(im)
        gx, gy = jax.vmap(lines.sobel)(g)
        mag = jnp.sqrt(gx * gx + gy * gy)
        edge = jax.vmap(lines._edge_nms)(mag, gx, gy) & (mag > det_cfg.mag_th)
        return edge, mag
    gf = jax.jit(grad_front)
    timeit("  line gradient front (blur+sobel+nms)", gf, imgs_list,
           lambda o: o[1][0, 5, 5])


if __name__ == "__main__":
    main()
