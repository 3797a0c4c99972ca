"""FAST-9/16 corner detection as a dense, fixed-shape program.

Replaces OpenCV's ORB detector stage (stereoFrame.cpp:105-119).  The
classic implementation walks pixels and early-exits; here the whole
image is evaluated at once:

- the 16-pixel Bresenham ring is materialized as 16 rolled copies of the
  image (pure data movement, fused by XLA);
- a segment of >= 9 contiguous brighter/darker ring pixels is found with
  windowed boolean products on the wrapped ring axis;
- the corner score is the exact FAST margin: max over arcs of the min
  ring-center contrast inside the arc;
- 3x3 non-max suppression via reduce_window, then a single top_k.

Supports the adaptative threshold protocol of the reference
(Config::adaptativeFAST, stereoFrameHandler.cpp usage): the caller passes
the threshold; retry logic lives in the frontend.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Bresenham circle radius 3 (dx, dy), clockwise
RING = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
ARC = 9


class Keypoints(NamedTuple):
    xy: jax.Array      # (K, 2) float pixel coords (x, y) at full resolution
    score: jax.Array   # (K,)
    level: jax.Array   # (K,) int32 pyramid level
    valid: jax.Array   # (K,) bool


def fast_score_map(img: jax.Array, threshold: float) -> jax.Array:
    """Dense FAST-9 score map; 0 where not a corner.

    The bright margin is max over the 16 arc starts of the window-9 min
    of (ring - I); the dark margin is the same on (I - ring), i.e.
    -min_k max_window9(ring - I).  Both come from ONE doubling chain of
    windowed mins/maxes over the wrapped ring (width 2 -> 4 -> 8 -> 9),
    ~92 elementwise ops per pixel per extremum instead of the 143 of the
    naive 9-slice stack.  Results are bit-identical (min/max are
    exact)."""
    diff = [jnp.roll(img, (-dy, -dx), axis=(0, 1)) - img for (dx, dy) in RING]
    d2 = diff + diff[:ARC - 1]                # wrapped ring, 24 entries

    def win9(vals, op):
        w2 = [op(vals[k], vals[k + 1]) for k in range(16 + 7)]
        w4 = [op(w2[k], w2[k + 2]) for k in range(16 + 5)]
        w8 = [op(w4[k], w4[k + 4]) for k in range(16 + 1)]
        return [op(w8[k], vals[k + 8]) for k in range(16)]

    mins = win9(d2, jnp.minimum)              # window-9 min per arc start
    maxs = win9(d2, jnp.maximum)              # window-9 max per arc start
    bright = mins[0]
    darkneg = maxs[0]
    for k in range(1, 16):
        bright = jnp.maximum(bright, mins[k])
        darkneg = jnp.minimum(darkneg, maxs[k])
    margin = jnp.maximum(bright, -darkneg)
    return jnp.where(margin > threshold, margin, 0.0)


def nms3x3(score: jax.Array) -> jax.Array:
    mx = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME")
    return jnp.where((score >= mx) & (score > 0), score, 0.0)


def detect_level(img: jax.Array, threshold: float, max_kp: int,
                 border: int) -> Keypoints:
    """Top-K FAST corners on one image with border exclusion
    (Config::orbEdgeTh=19) and parabolic sub-pixel refinement — integer
    corner coordinates would quantize stereo disparity by a full pixel,
    which at EuRoC depths is tens of centimeters of depth error."""
    raw = fast_score_map(img, threshold)
    return select_corners(raw, nms3x3(raw), max_kp, border)


CELL = 12  # spatial-bucket side (px) for per-cell corner selection


def select_corners(raw: jax.Array, s: jax.Array, max_kp: int,
                   border: int, cell: int | None = CELL) -> Keypoints:
    """Top-K + sub-pixel refinement on precomputed (raw, nms) score maps.

    ``cell`` selects the per-cell-argmax strategy: the NMS map is bucketed
    into cell x cell tiles, each tile contributes its best corner, and the
    top-K runs over the ~2.5k tile maxima instead of sorting all H*W
    scores.  One corner per 12x12 px also enforces the spatial uniformity
    the reference gets from its 48x64 bucket grids (stereoFrame.h:51-52).
    ``cell=None`` restores the exact global top-K."""
    H, W = raw.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    inside = ((xx >= border) & (xx < W - border)
              & (yy >= border) & (yy < H - border))
    s = jnp.where(inside, s, 0.0)
    if cell:
        Hc, Wc = -(-H // cell), -(-W // cell)
        sp = jnp.zeros((Hc * cell, Wc * cell), s.dtype).at[:H, :W].set(s)
        flat_ix = jax.lax.broadcasted_iota(
            jnp.int32, (Hc * cell, Wc * cell), 0) * W + \
            jax.lax.broadcasted_iota(jnp.int32, (Hc * cell, Wc * cell), 1)
        sc = sp.reshape(Hc, cell, Wc, cell)
        fc = flat_ix.reshape(Hc, cell, Wc, cell)
        cmax = sc.max(axis=(1, 3))                       # (Hc, Wc)
        hit = (sc == cmax[:, None, :, None]) & (sc > 0)
        cidx = jnp.where(hit, fc, -1).max(axis=(1, 3))   # (Hc, Wc)
        n_cells = Hc * Wc
        k = min(max_kp, n_cells)
        vals, ci = jax.lax.top_k(cmax.reshape(-1), k)
        idx = cidx.reshape(-1)[ci]
        if k < max_kp:  # pad back up to the static capacity
            vals = jnp.concatenate([vals, jnp.zeros(max_kp - k, vals.dtype)])
            idx = jnp.concatenate([idx, jnp.full(max_kp - k, -1, idx.dtype)])
        idx = jnp.maximum(idx, 0)
    else:
        flat = s.reshape(-1)
        vals, idx = jax.lax.top_k(flat, max_kp)
    x = (idx % W).astype(jnp.int32)
    y = (idx // W).astype(jnp.int32)

    # sub-pixel: 1D parabola fits on the raw score in x and y
    def subpix(c0, cm, cp):
        denom = cm - 2.0 * c0 + cp
        off = 0.5 * (cm - cp) / jnp.where(jnp.abs(denom) > 1e-9, denom, 1e-9)
        return jnp.clip(off, -0.5, 0.5)

    s_c = raw[y, x]
    off_x = subpix(s_c, raw[y, jnp.maximum(x - 1, 0)],
                   raw[y, jnp.minimum(x + 1, W - 1)])
    off_y = subpix(s_c, raw[jnp.maximum(y - 1, 0), x],
                   raw[jnp.minimum(y + 1, H - 1), x])
    xf = x.astype(raw.dtype) + off_x
    yf = y.astype(raw.dtype) + off_y
    return Keypoints(
        xy=jnp.stack([xf, yf], axis=-1),
        score=vals,
        level=jnp.zeros(max_kp, jnp.int32),
        valid=vals > 0,
    )


def detect_pyramid(levels, threshold: float, max_total: int, border: int,
                   scale_factor: float,
                   per_level: int | None = None) -> Keypoints:
    """Detect on every pyramid level, scale coords to level 0, keep global
    top max_total by score (ORB multi-scale semantics)."""
    n = len(levels)
    per = per_level or max_total // n + 1
    all_xy, all_s, all_l, all_v = [], [], [], []
    for i, img in enumerate(levels):
        kp = detect_level(img, threshold, per, border)
        scale = scale_factor ** i
        all_xy.append(kp.xy * scale)
        all_s.append(kp.score)
        all_l.append(jnp.full(per, i, jnp.int32))
        all_v.append(kp.valid)
    xy = jnp.concatenate(all_xy)
    sc = jnp.concatenate(all_s)
    lv = jnp.concatenate(all_l)
    va = jnp.concatenate(all_v)
    vals, idx = jax.lax.top_k(jnp.where(va, sc, -1.0), max_total)
    return Keypoints(xy=xy[idx], score=vals, level=lv[idx], valid=vals > 0)
