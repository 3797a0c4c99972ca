"""Oriented BRIEF (ORB-style) descriptors, batched over keypoints.

Replaces OpenCV ORB::detectAndCompute's describe stage
(stereoFrame.cpp:113-116) —

- a (K, 48, 48) patch per keypoint is gathered from the blurred image
  (ops/patches.py), replacing both the dense 31x31 orientation
  convolutions and the per-pair image reads;
- orientation by intensity centroid is two constant-mask reductions over
  the patch (disc radius 15);
- steered BRIEF: a fixed 256-pair pattern (deterministic seeded Gaussian
  — descriptors must be internally consistent, not OpenCV bit-compatible)
  rotated by the keypoint angle and sampled inside the patch;
- output packed uint32[8] for the popcount-matmul matcher.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .descriptors import pack_bits
from .image import blur
from .patches import extract_patches, sample_in_patches

PATCH_R = 15          # Config::orbPatchSize=31 -> radius 15
N_PAIRS = 256
PATCH = 48            # patch side: covers rotated pattern (15*sqrt(2)~21.2)
CENTER = 23.0         # patch[r, c] = img[round(y)-23+r, round(x)-23+c]


def _brief_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 2, 2) sampling pairs ~ N(0, (patch/5)^2), clipped to the patch
    (the original BRIEF G-II construction)."""
    rng = np.random.default_rng(seed)
    sigma = PATCH_R * 2 / 5.0
    pat = rng.normal(0.0, sigma, size=(N_PAIRS, 2, 2))
    return np.clip(pat, -PATCH_R, PATCH_R)


def _centroid_kernels() -> tuple[np.ndarray, np.ndarray]:
    """(PATCH, PATCH) dx- and dy-weighted disc masks centered at CENTER."""
    rr, cc = np.mgrid[0:PATCH, 0:PATCH]
    dx = cc - CENTER
    dy = rr - CENTER
    disc = (dx**2 + dy**2 <= PATCH_R**2).astype(np.float32)
    return (dx * disc).astype(np.float32), (dy * disc).astype(np.float32)


_PATTERN = _brief_pattern()
_KX, _KY = _centroid_kernels()


def describe(img: jax.Array, xy: jax.Array, valid: jax.Array,
             blur_sigma: float = 2.0):
    """(K, 8) uint32 packed rotated-BRIEF descriptors + (K,) angles.

    img: full-resolution grayscale (float); xy: (K, 2) keypoint coords.
    """
    smoothed = blur(img, blur_sigma)
    patches = extract_patches(smoothed, xy, PATCH,
                              center_offset=CENTER)    # (K, 48, 48) f32
    # orientation by intensity centroid over the patch disc
    kx = jnp.asarray(_KX, patches.dtype)
    ky = jnp.asarray(_KY, patches.dtype)
    hi = jax.lax.Precision.HIGHEST
    m10 = jnp.einsum("krc,rc->k", patches, kx, precision=hi)
    m01 = jnp.einsum("krc,rc->k", patches, ky, precision=hi)
    theta = jnp.arctan2(m01, m10)
    norm = jnp.sqrt(m10 * m10 + m01 * m01)
    safe = norm > 1e-6
    c = jnp.where(safe, m10 / jnp.where(safe, norm, 1.0), 1.0)
    s = jnp.where(safe, m01 / jnp.where(safe, norm, 1.0), 0.0)

    # rotated pattern -> in-patch coords (nearest sampling, like OpenCV's
    # integer rounding); the sub-pixel keypoint offset shifts the center
    pat = jnp.asarray(_PATTERN, patches.dtype)        # (256, 2, 2)
    px, py = pat[..., 0], pat[..., 1]                 # (256, 2)
    rx = c[:, None, None] * px[None] - s[:, None, None] * py[None]
    ry = s[:, None, None] * px[None] + c[:, None, None] * py[None]
    frac = xy - jnp.floor(xy + 0.5)                   # (K, 2) in (-0.5, 0.5]
    u = CENTER + frac[:, 0:1, None] + rx              # (K, 256, 2)
    v = CENTER + frac[:, 1:2, None] + ry
    K = xy.shape[0]
    uv = jnp.stack([u, v], axis=-1).reshape(K, 2 * N_PAIRS, 2)
    vals = sample_in_patches(patches, uv).reshape(K, N_PAIRS, 2)

    bits = (vals[..., 0] < vals[..., 1]).astype(jnp.uint8)  # (K, 256)
    desc = pack_bits(bits)
    desc = jnp.where(valid[:, None], desc, 0)
    return desc, theta
