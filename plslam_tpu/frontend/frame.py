"""Per-frame stereo feature extraction — the array-ized StereoFrame.

Behavioral spec: reference ``src2/stereoFrame.cpp`` —
detectStereoPoints/matchStereoPoints (:80-171), detectStereoLineSegments/
matchStereoLines (:183-500), filterLineSegmentDisparity (:505),
lineSegmentOverlapStereo (:510), Pluecker construction (:870-883).

Where the reference runs left/right and points/lines on four async CPU
threads, here the four detections are one jit program — XLA schedules the
independent subgraphs on the device, in place of the std::async pairs
(stereoFrame.cpp:63-93).

Every program built here traces its matmuls at full f32 precision
(``numerics.full_f32_matmuls``): descriptor bits compare blurred
intensities and orientation moments, and a reduced-precision matmul pass
(TF32 on the GPU) would flip them.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.camera import StereoCamera
from ..core.numerics import full_f32_matmuls
from ..core.plucker import plane_from_points, plucker_from_planes
from ..ops import fast, lbd, lines, orb
from ..ops import matching as M
from .features import LineSet, PointSet, StereoFeatures


class FrontendConfig(NamedTuple):
    """Feature-extraction tunables (defaults = reference config.cpp:36-113)."""

    n_points: int = 1200          # orb_nfeatures
    n_lines: int = 256            # lsd_nfeatures (300) rounded to 64
    n_levels: int = 4             # orb_nlevels
    scale_factor: float = 1.2     # orb_scale_factor
    fast_th: float = 20.0         # orb_fast_th
    edge_th: int = 19             # orb_edge_th
    max_dist_epip: float = 1.0    # max_dist_epip
    min_disp: float = 1.0         # min_disp
    nnr: float = 0.9              # min_ratio_12_p / _l
    stereo_window: float = 120.0  # matching_s_ws = 10 grid cells of ~12 px
    stereo_row_tol: float = 10.0  # one grid cell (48 rows over 480 px)
    line_sim_th: float = 0.75     # line_sim_th
    line_horiz_th: float = 0.1    # line_horiz_th
    ls_min_disp_ratio: float = 0.7
    stereo_overlap_th: float = 0.75
    min_line_length_frac: float = 0.025  # min_line_length * image size
    line_window: float = 120.0
    # orientation bins of the tile-parallel line detector; 360/lsd_ang_th
    # (reference lsd_ang_th=22.5 deg <-> 16 bins with the double-bin
    # assignment of ops/lines.py)
    line_orient_bins: int = 16


def _sigma2(level: jax.Array, scale_factor: float) -> jax.Array:
    """Inverse-variance pyramid weight (stereoFeatures.cpp:41-56)."""
    s = scale_factor ** level.astype(jnp.float32)
    return 1.0 / (s * s)


def extract_stereo_features(
    img_l: jax.Array,
    img_r: jax.Array,
    cam: StereoCamera,
    cfg: FrontendConfig = FrontendConfig(),
) -> StereoFeatures:
    """Full stereo extraction for one frame pair -> padded feature sets."""
    points = _stereo_points(img_l, img_r, cam, cfg)
    line_set = _stereo_lines(img_l, img_r, cam, cfg)
    return StereoFeatures(points=points, lines=line_set)


def make_batched_detectors(cfg: FrontendConfig):
    """Two jit programs that detect+describe on a stacked (B, H, W) image
    batch (a stereo pair is B=2): det_pts(imgs, th) -> (Keypoints, desc)
    with th a scalar or (B,) FAST threshold, det_ls(imgs) -> (Segments,
    desc).  Batching left and right halves the per-frame dispatch count."""
    det_pts = jax.jit(full_f32_matmuls(
        lambda imgs, th: _detect_describe_points_batch(imgs, cfg, th)))
    det_ls = jax.jit(full_f32_matmuls(
        lambda imgs: _detect_describe_lines_batch(imgs, cfg)))
    return det_pts, det_ls


def make_sharded_detectors(cfg: FrontendConfig, sharding):
    """Batched detectors over (B, 2, H, W) stereo stacks, shard_mapped over
    the sequence axis of a mesh: each device runs the batch detection
    program on its local (B_local, 2, H, W) sub-batch.  ``sharding`` is a
    NamedSharding whose spec partitions the leading (sequence-batch)
    axis."""
    from jax.sharding import PartitionSpec

    mesh = sharding.mesh
    pspec = PartitionSpec(sharding.spec[0])

    def pts_local(imgs, th):
        return _pairs(_detect_describe_points_batch,
                      imgs, cfg, jnp.repeat(th, 2))

    def ls_local(imgs):
        return _pairs(_detect_describe_lines_batch, imgs, cfg)

    det_pts = jax.jit(jax.shard_map(
        full_f32_matmuls(pts_local), mesh=mesh, in_specs=(pspec, pspec),
        out_specs=pspec))
    det_ls = jax.jit(jax.shard_map(
        full_f32_matmuls(ls_local), mesh=mesh, in_specs=(pspec,),
        out_specs=pspec))
    return det_pts, det_ls


def _pairs(detect, imgs, *args):
    """Run a flat (B*2, H, W) detector on a (B, 2, H, W) stack and fold
    its outputs back to leading (B, 2)."""
    B = imgs.shape[0]
    out = detect(imgs.reshape((B * 2,) + imgs.shape[2:]), *args)
    return jax.tree.map(lambda x: x.reshape((B, 2) + x.shape[1:]), out)


def make_extractor(cam: StereoCamera, cfg: FrontendConfig):
    """Staged extractor: per-image detection and stereo matching compile as
    separate programs (each reused for left/right), which compiles several
    times faster than one monolithic program.  Returns
    extract(img_l, img_r) -> StereoFeatures."""
    det_pts = jax.jit(full_f32_matmuls(
        lambda im, th: _detect_describe_points(im, cfg, th)))
    det_ls = jax.jit(full_f32_matmuls(
        lambda im: _detect_describe_lines(im, cfg)))
    match_pts = jax.jit(full_f32_matmuls(
        lambda kl, dl, kr, dr: _match_stereo_points(kl, dl, kr, dr, cam, cfg)))
    match_ls = jax.jit(full_f32_matmuls(
        lambda sl, dl, sr, dr: _match_stereo_lines(sl, dl, sr, dr, cam, cfg)))

    def extract(img_l, img_r, fast_th=None) -> StereoFeatures:
        th = jnp.asarray(cfg.fast_th if fast_th is None else fast_th,
                         jnp.float32)
        kp_l, pdesc_l = det_pts(img_l, th)
        kp_r, pdesc_r = det_pts(img_r, th)
        seg_l, ldesc_l = det_ls(img_l)
        seg_r, ldesc_r = det_ls(img_r)
        points = match_pts(kp_l, pdesc_l, kp_r, pdesc_r)
        line_set = match_ls(seg_l, ldesc_l, seg_r, ldesc_r)
        return StereoFeatures(points=points, lines=line_set)

    return extract


# ---------------------------------------------------------------------------
# Points
# ---------------------------------------------------------------------------


def _detect_describe_points(img, cfg: FrontendConfig, fast_th=None):
    from ..ops.image import build_pyramid

    th = cfg.fast_th if fast_th is None else fast_th
    levels = build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    kp = fast.detect_pyramid(levels, th, cfg.n_points, cfg.edge_th,
                             cfg.scale_factor)
    desc, _ = orb.describe(img, kp.xy, kp.valid)
    return kp, desc


def _detect_describe_points_batch(imgs, cfg: FrontendConfig, fast_th):
    """(B, H, W) stack -> Keypoints + descriptors with leading (B,); the
    FAST threshold is a scalar or one per image."""
    th = jnp.broadcast_to(jnp.asarray(fast_th, jnp.float32), imgs.shape[:1])
    return jax.vmap(lambda im, t: _detect_describe_points(im, cfg, t))(
        imgs, th)


def _stereo_points(img_l, img_r, cam: StereoCamera, cfg: FrontendConfig) -> PointSet:
    kp_l, desc_l = _detect_describe_points(img_l, cfg)
    kp_r, desc_r = _detect_describe_points(img_r, cfg)
    return _match_stereo_points(kp_l, desc_l, kp_r, desc_r, cam, cfg)


def _match_stereo_points(kp_l, desc_l, kp_r, desc_r,
                         cam: StereoCamera, cfg: FrontendConfig) -> PointSet:
    pair_mask = M.stereo_point_pair_mask(
        kp_l.xy, kp_r.xy, kp_l.valid, kp_r.valid,
        max_disp=cfg.stereo_window, row_tol=cfg.stereo_row_tol)
    match = M.match_descriptors(desc_l, desc_r, pair_mask, cfg.nnr)

    idx_r = jnp.clip(match.idx, 0, cfg.n_points - 1)
    xy_r = kp_r.xy[idx_r]
    matched = match.idx >= 0
    # epipolar + disparity gates (stereoFrame.cpp:158-161)
    dy = jnp.abs(kp_l.xy[:, 1] - xy_r[:, 1])
    disp = kp_l.xy[:, 0] - xy_r[:, 0]
    ok = matched & (dy <= cfg.max_dist_epip) & (disp >= cfg.min_disp)

    disp_safe = jnp.where(ok, disp, 1.0)
    P = cam.back_project(kp_l.xy, disp_safe)
    return PointSet(
        uv=kp_l.xy,
        disp=disp_safe,
        P=P,
        desc=desc_l,
        sigma2=_sigma2(kp_l.level, cfg.scale_factor),
        valid=ok,
    )


# ---------------------------------------------------------------------------
# Lines
# ---------------------------------------------------------------------------


def _detect_describe_lines(img, cfg: FrontendConfig):
    min_len = cfg.min_line_length_frac * max(img.shape)
    det_cfg = lines.LineDetectorConfig(max_out=cfg.n_lines,
                                       n_orient=cfg.line_orient_bins)
    seg = lines.detect_segments(img, det_cfg)
    seg = seg._replace(valid=seg.valid & (seg.length >= min_len))
    desc = lbd.describe(img, seg.sp, seg.ep, seg.valid)
    return seg, desc


def _detect_describe_lines_batch(imgs, cfg: FrontendConfig):
    """(B, H, W) stack -> Segments + LBD descriptors with leading (B,)."""
    return jax.vmap(lambda im: _detect_describe_lines(im, cfg))(imgs)


def _stereo_lines(img_l, img_r, cam: StereoCamera, cfg: FrontendConfig) -> LineSet:
    seg_l, desc_l = _detect_describe_lines(img_l, cfg)
    seg_r, desc_r = _detect_describe_lines(img_r, cfg)
    return _match_stereo_lines(seg_l, desc_l, seg_r, desc_r, cam, cfg)


def _match_stereo_lines(seg_l, desc_l, seg_r, desc_r,
                        cam: StereoCamera, cfg: FrontendConfig) -> LineSet:
    n = cfg.n_lines

    pair_mask = M.line_pair_mask(
        seg_l.sp, seg_l.ep, seg_r.sp, seg_r.ep, seg_l.valid, seg_r.valid,
        radius=cfg.line_window, min_dir_cos=cfg.line_sim_th)
    match = M.match_descriptors(desc_l, desc_r, pair_mask, cfg.nnr)

    j = jnp.clip(match.idx, 0, n - 1)
    matched = match.idx >= 0
    sp_l, ep_l = seg_l.sp, seg_l.ep
    sp_r, ep_r = seg_r.sp[j], seg_r.ep[j]

    # intersect the right segment's supporting line with the left endpoints'
    # image rows to get per-endpoint disparities (stereoFrame.cpp:370-373)
    def x_at_y(sp, ep, y):
        dy = ep[:, 1] - sp[:, 1]
        t = (y - sp[:, 1]) / jnp.where(jnp.abs(dy) > 1e-6, dy, 1e-6)
        return sp[:, 0] + t * (ep[:, 0] - sp[:, 0])

    xr_s = x_at_y(sp_r, ep_r, sp_l[:, 1])
    xr_e = x_at_y(sp_r, ep_r, ep_l[:, 1])
    disp_s = sp_l[:, 0] - xr_s
    disp_e = ep_l[:, 0] - xr_e
    # disparity-ratio filter (filterLineSegmentDisparity :505)
    ratio = jnp.minimum(disp_s, disp_e) / jnp.maximum(
        jnp.maximum(disp_s, disp_e), 1e-9)
    ratio_ok = ratio >= cfg.ls_min_disp_ratio

    # vertical-extent overlap (lineSegmentOverlapStereo :510)
    sln = jnp.minimum(sp_l[:, 1], ep_l[:, 1])
    eln = jnp.maximum(sp_l[:, 1], ep_l[:, 1])
    spn = jnp.minimum(sp_r[:, 1], ep_r[:, 1])
    epn = jnp.maximum(sp_r[:, 1], ep_r[:, 1])
    inter = jnp.minimum(eln, epn) - jnp.maximum(sln, spn)
    overlap = jnp.clip(inter / jnp.maximum(eln - spn, 1e-2), 0.0, 1.0)

    ok = (matched & ratio_ok
          & (disp_s >= cfg.min_disp) & (disp_e >= cfg.min_disp)
          & (jnp.abs(sp_l[:, 1] - ep_l[:, 1]) > cfg.line_horiz_th)
          & (jnp.abs(sp_r[:, 1] - ep_r[:, 1]) > cfg.line_horiz_th)
          & (overlap > cfg.stereo_overlap_th))

    disp_s = jnp.where(ok, disp_s, 1.0)
    disp_e = jnp.where(ok, disp_e, 1.0)
    sP = cam.back_project(sp_l, disp_s)
    eP = cam.back_project(ep_l, disp_e)

    # image line equation, normalized over (a, b) (stereoFrame.cpp:356)
    sph = jnp.concatenate([sp_l, jnp.ones((n, 1), sp_l.dtype)], axis=-1)
    eph = jnp.concatenate([ep_l, jnp.ones((n, 1), ep_l.dtype)], axis=-1)
    le = jnp.cross(sph, eph)
    le = le / jnp.maximum(jnp.linalg.norm(le[:, :2], axis=-1, keepdims=True), 1e-9)

    # Pluecker from the two back-projected planes (stereoFrame.cpp:377-398)
    o1 = jnp.zeros(3, sp_l.dtype)
    o2 = jnp.asarray([1.0, 0.0, 0.0], sp_l.dtype) * cam.b
    r1s = cam.back_project_unit(sp_l)
    r1e = cam.back_project_unit(ep_l)
    r2s = cam.back_project_unit(jnp.stack([xr_s, sp_l[:, 1]], -1)) + o2
    r2e = cam.back_project_unit(jnp.stack([xr_e, ep_l[:, 1]], -1)) + o2
    pi1 = plane_from_points(r1s, r1e, o1)
    pi2 = plane_from_points(r2s, r2e, o2)
    NDc = plucker_from_planes(pi1, pi2)

    return LineSet(
        sp=sp_l, ep=ep_l, sdisp=disp_s, edisp=disp_e, sP=sP, eP=eP,
        le=le, angle=seg_l.angle, NDc=NDc, desc=desc_l,
        sigma2=jnp.ones(n, sp_l.dtype), valid=ok,
    )
