"""Patch extraction and in-patch sampling for the describe stages.

The ORB and LBD descriptors read square patches around image locations
(stereoFrame.cpp:113-116, binary_descriptor_custom.cpp:836-848) and then
sample points inside each patch.  Both reads are plain gathers:

- **patch extraction**: each (P, P) patch is one dynamic slice of the
  zero-padded image, batched over keypoints (contiguous rows, which the
  GPU serves as ordinary loads);
- **in-patch sampling**: one gather per sample from the flattened patch.

Out-of-image coordinates read zero.

The ``*_onehot`` functions are the reference formulation of the same
reads: one-hot selection matrices built with iota compares and applied as
matmuls at HIGHEST precision, so every product is an exact copy.  They are
kept to check the gathers against (tests, chip_smoke.py) and to time the
two forms (scripts/ab_patch_forms.py); the descriptors do not use them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def _round_half_up(x: jax.Array) -> jax.Array:
    """floor(x + 0.5): unlike jnp.round's round-half-to-even, the anchor of
    a half-pixel coordinate does not depend on integer parity — critical
    because corner detectors land exactly on .5 and banker's rounding
    would put the patch center on opposite sides of the same corner in two
    images (flipping the orientation estimate of symmetric corners)."""
    return jnp.floor(x + 0.5)


def patch_corners(xy: jax.Array, patch: int,
                  center_offset: float | None = None):
    """(y0, x0) int32 top-left corners: patch[k, r, c] reads
    img[y0_k + r, x0_k + c], with (x0, y0) = round(xy) - off and
    off = center_offset (default (P-1)/2)."""
    off = (patch - 1) / 2.0 if center_offset is None else center_offset
    o = int(round(off))
    y0 = _round_half_up(xy[..., 1]).astype(jnp.int32) - o
    x0 = _round_half_up(xy[..., 0]).astype(jnp.int32) - o
    return y0, x0


def extract_patches(img: jax.Array, xy: jax.Array, patch: int,
                    center_offset: float | None = None) -> jax.Array:
    """(K, P, P) f32 patches around keypoints xy (float (K, 2), x then y);
    see ``patch_corners`` for the anchor.  Out-of-image reads are 0."""
    H, W = img.shape
    P = patch
    y0, x0 = patch_corners(xy, P, center_offset)
    # a P-wide zero border makes every slice whose corner lies in
    # [-P, H] x [-P, W] exact; corners further out clamp, but every row
    # or column they would read is outside the image and masked below
    padded = jnp.pad(img.astype(jnp.float32), P)
    tiles = jax.vmap(lambda y, x: jax.lax.dynamic_slice(
        padded, (y + P, x + P), (P, P)))(y0, x0)
    r = jnp.arange(P, dtype=jnp.int32)
    ys = y0[:, None] + r[None, :]
    xs = x0[:, None] + r[None, :]
    ok_y = (ys >= 0) & (ys < H)
    ok_x = (xs >= 0) & (xs < W)
    return jnp.where(ok_y[:, :, None] & ok_x[:, None, :], tiles, 0.0)


def sample_in_patches(patches: jax.Array, uv: jax.Array) -> jax.Array:
    """Sample patches at per-keypoint float coords (nearest).

    patches: (K, P, P) [row, col]; uv: (K, S, 2) in-patch (u=col, v=row)
    float coordinates.  Returns (K, S) f32.  Out-of-patch -> 0.
    """
    K, P, _ = patches.shape
    vi = _round_half_up(uv[..., 1]).astype(jnp.int32)
    ui = _round_half_up(uv[..., 0]).astype(jnp.int32)
    ok = (vi >= 0) & (vi < P) & (ui >= 0) & (ui < P)
    flat = jnp.clip(vi, 0, P - 1) * P + jnp.clip(ui, 0, P - 1)
    vals = jnp.take_along_axis(
        patches.reshape(K, P * P).astype(jnp.float32), flat, axis=1)
    return jnp.where(ok, vals, 0.0)


# ---------------------------------------------------------------------------
# Reference: the same reads as exact one-hot matmuls
# ---------------------------------------------------------------------------


def _onehot(idx: jax.Array, n: int) -> jax.Array:
    """f32 one-hot over a new trailing axis of size n; a zero row where idx
    is out of range."""
    grid = jax.lax.broadcasted_iota(jnp.int32, idx.shape + (n,), idx.ndim)
    return (grid == idx[..., None]).astype(jnp.float32)


def extract_patches_onehot(img: jax.Array, xy: jax.Array, patch: int,
                           center_offset: float | None = None) -> jax.Array:
    """Reference for ``extract_patches``:
    patch[k] = OY[k] @ img @ OX[k]^T with (P, H) / (P, W) one-hots."""
    H, W = img.shape
    K = xy.shape[0]
    P = patch
    y0, x0 = patch_corners(xy, P, center_offset)
    r = jnp.arange(P, dtype=jnp.int32)
    OY = _onehot(y0[:, None] + r[None, :], H)        # (K, P, H)
    OX = _onehot(x0[:, None] + r[None, :], W)        # (K, P, W)
    rows = jax.lax.dot_general(
        OY.reshape(K * P, H), img.astype(jnp.float32),
        (((1,), (0,)), ((), ())), precision=_HI,
        preferred_element_type=jnp.float32).reshape(K, P, W)
    return jax.lax.dot_general(
        rows, OX, (((2,), (2,)), ((0,), (0,))), precision=_HI,
        preferred_element_type=jnp.float32)


def sample_in_patches_onehot(patches: jax.Array, uv: jax.Array) -> jax.Array:
    """Reference for ``sample_in_patches``: two one-hot contractions over
    the patch axes."""
    K, P, _ = patches.shape
    OV = _onehot(_round_half_up(uv[..., 1]).astype(jnp.int32), P)
    OU = _onehot(_round_half_up(uv[..., 0]).astype(jnp.int32), P)
    A = jax.lax.dot_general(
        OV, patches.astype(jnp.float32), (((2,), (1,)), ((0,), (0,))),
        precision=_HI, preferred_element_type=jnp.float32)
    return jnp.sum(A * OU, axis=-1)
