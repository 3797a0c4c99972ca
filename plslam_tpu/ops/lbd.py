"""Line Band Descriptor (LBD), batched over segments.

Replaces the vendored BinaryDescriptor (3rdparty/line_descriptor,
binary_descriptor_custom.cpp:836-848: band-based statistics over a line
support region, binarized to 256 bits).

Formulation: Q patches of (P x P) pixels are gathered at evenly spaced
centers along each segment (ops/patches.py) from both Sobel gradient
images.  Inside each patch a line-aligned (BANDS*BAND_W across) x
(S along) rotated grid is sampled; gradients are rotated into the line frame; each band
contributes mean/std of the 4 half-wave components (positive/negative
parallel and normal gradients — the classic LBD features) pooled over all
patches; the float feature vector is binarized by a fixed random-pair
comparison pattern into 256 bits, matching the binary-matcher interface.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .descriptors import pack_bits
from .image import blur, sobel
from .patches import extract_patches, sample_in_patches

BANDS = 9            # classic LBD: m = 9 bands
BAND_W = 5           # band width in px (45 across fits the patch radius)
Q_PATCHES = 6        # patches along the segment
S_ALONG = 6          # along-line samples per patch
PATCH = 48
CENTER = 23.0
FEAT_DIM = BANDS * 8  # mean+std of 4 half-wave components per band


def _pair_pattern(seed: int = 4321, max_band_gap: int = 2) -> np.ndarray:
    """(256, 2) index pairs over the feature vector for binarization.

    Pairs are drawn between features of NEARBY bands (|band gap| <=
    max_band_gap): local comparisons change less under viewpoint/photometric
    drift than long-range ones, which measurably lowers the wrong-match
    rate (scripts/line_match_quality.py)."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < 256:
        i = int(rng.integers(0, FEAT_DIM))
        j = int(rng.integers(0, FEAT_DIM))
        if i == j or abs(i // 8 - j // 8) > max_band_gap:
            continue
        out.append((i, j))
    return np.asarray(out, np.int64)


_PAIRS = _pair_pattern()


def _patch_centers(sp: jax.Array, ep: jax.Array) -> jax.Array:
    """(K, Q, 2) evenly spaced patch centers along each segment."""
    tq = (jnp.arange(Q_PATCHES, dtype=sp.dtype) + 0.5) / Q_PATCHES
    return sp[:, None, :] + tq[None, :, None] * (ep - sp)[:, None, :]


def describe(img: jax.Array, sp: jax.Array, ep: jax.Array, valid: jax.Array):
    """(K, 8) uint32 packed LBD descriptors for segments (sp, ep)."""
    g = blur(img, 1.4)
    gx, gy = sobel(g)
    K = sp.shape[0]
    c2 = _patch_centers(sp, ep).reshape(K * Q_PATCHES, 2)
    px = extract_patches(gx, c2, PATCH, center_offset=CENTER)  # (KQ, P, P)
    py = extract_patches(gy, c2, PATCH, center_offset=CENTER)
    d = ep - sp
    length = jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-6)
    dl = d / length                                     # line direction
    dn = jnp.stack([-dl[..., 1], dl[..., 0]], axis=-1)  # normal

    # line-aligned sample grid inside each patch
    half = (BANDS * BAND_W) / 2.0
    a_off = (jnp.arange(BANDS * BAND_W, dtype=sp.dtype) + 0.5) - half
    seg_span = jnp.minimum(length[:, 0] / Q_PATCHES, 2 * (CENTER - half / 2))
    s_off = ((jnp.arange(S_ALONG, dtype=sp.dtype) + 0.5) / S_ALONG - 0.5)
    # (K, A, S) offsets -> in-patch coords via line frame
    s_px = s_off[None, None, :] * seg_span[:, None, None]
    u = (CENTER + s_px * dl[:, None, None, 0]
         + a_off[None, :, None] * dn[:, None, None, 0])
    v = (CENTER + s_px * dl[:, None, None, 1]
         + a_off[None, :, None] * dn[:, None, None, 1])
    A = BANDS * BAND_W
    uv = jnp.stack([u, v], -1).reshape(K, A * S_ALONG, 2)
    uv_q = jnp.broadcast_to(uv[:, None], (K, Q_PATCHES, A * S_ALONG, 2)
                            ).reshape(K * Q_PATCHES, A * S_ALONG, 2)
    sx = sample_in_patches(px, uv_q).reshape(K, Q_PATCHES, A, S_ALONG)
    sy = sample_in_patches(py, uv_q).reshape(K, Q_PATCHES, A, S_ALONG)

    g_par = (sx * dl[:, None, None, None, 0]
             + sy * dl[:, None, None, None, 1])
    g_nrm = (sx * dn[:, None, None, None, 0]
             + sy * dn[:, None, None, None, 1])

    # half-wave components, pooled per band over (BAND_W, S, Q)
    feats = jnp.stack([
        jnp.maximum(g_par, 0.0), jnp.maximum(-g_par, 0.0),
        jnp.maximum(g_nrm, 0.0), jnp.maximum(-g_nrm, 0.0),
    ], axis=-1)                                         # (K, Q, A, S, 4)
    feats = feats.transpose(0, 2, 1, 3, 4).reshape(
        K, BANDS, BAND_W * Q_PATCHES * S_ALONG, 4)
    mean = jnp.mean(feats, axis=2)                      # (K, BANDS, 4)
    std = jnp.std(feats, axis=2)                        # (K, BANDS, 4)
    f = jnp.concatenate([mean, std], axis=-1).reshape(K, FEAT_DIM)
    # normalize (affine-light invariance)
    f = f / jnp.maximum(jnp.linalg.norm(f, axis=-1, keepdims=True), 1e-9)

    pairs = jnp.asarray(_PAIRS)
    bits = (f[:, pairs[:, 0]] > f[:, pairs[:, 1]]).astype(jnp.uint8)
    desc = pack_bits(bits)
    return jnp.where(valid[:, None], desc, 0)
