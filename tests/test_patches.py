"""Patch extraction and in-patch sampling vs direct-indexing oracles and
the one-hot-matmul reference."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from plslam_tpu.ops import lbd, orb
from plslam_tpu.ops.image import blur, sobel
from plslam_tpu.ops.patches import (extract_patches, extract_patches_onehot,
                                    sample_in_patches,
                                    sample_in_patches_onehot)


def test_extract_patches_matches_direct_indexing():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (64, 96)).astype(np.float32)
    xy = np.stack([rng.uniform(25, 70, 7), rng.uniform(25, 38, 7)], -1)
    P, off = 16, 7.5
    got = np.asarray(extract_patches(jnp.asarray(img), jnp.asarray(xy), P,
                                     center_offset=off))
    for k in range(7):
        x0 = int(round(xy[k, 0])) - 8
        y0 = int(round(xy[k, 1])) - 8
        want = img[y0:y0 + P, x0:x0 + P]
        np.testing.assert_allclose(got[k], want, rtol=1e-6)


def test_extract_patches_zero_pads_outside():
    img = jnp.ones((32, 32), jnp.float32)
    xy = jnp.asarray([[0.0, 0.0]])
    p = np.asarray(extract_patches(img, xy, 16))
    # center offset 7.5 -> rounds to 8; rows/cols with index <0 are zero
    assert p[0, 0, 0] == 0.0
    assert p[0, 15, 15] == 1.0


def test_sample_in_patches_nearest():
    rng = np.random.default_rng(1)
    patches = rng.uniform(0, 1, (3, 16, 16)).astype(np.float32)
    uv = np.stack([rng.uniform(0, 15, (3, 11)),
                   rng.uniform(0, 15, (3, 11))], -1)
    got = np.asarray(sample_in_patches(jnp.asarray(patches), jnp.asarray(uv)))
    for k in range(3):
        for s in range(11):
            ui = int(round(uv[k, s, 0]))
            vi = int(round(uv[k, s, 1]))
            np.testing.assert_allclose(got[k, s], patches[k, vi, ui],
                                       rtol=1e-6)


def test_sample_in_patches_bf16_exact_for_8bit():
    rng = np.random.default_rng(2)
    patches = rng.integers(0, 256, (2, 16, 16)).astype(np.float32)
    uv = np.stack([rng.uniform(0, 15, (2, 9)),
                   rng.uniform(0, 15, (2, 9))], -1)
    got = np.asarray(sample_in_patches(jnp.asarray(patches), jnp.asarray(uv)))
    for k in range(2):
        for s in range(9):
            ui, vi = int(round(uv[k, s, 0])), int(round(uv[k, s, 1]))
            assert got[k, s] == patches[k, vi, ui]


def _euroc_image(seed):
    """752x480 (EuRoC width) textured test image in 0..255."""
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.uniform(0, 255, (480, 752)), jnp.float32)


@pytest.mark.parametrize("stage", ["orb", "lbd"])
def test_gather_patches_match_onehot_reference(stage):
    """The gather path is bit-identical to the one-hot reference at EuRoC
    width, including patches that overhang every border and corners far
    outside the image.  ORB reads the blurred image around keypoints;
    LBD reads both Sobel gradient images around segment centers."""
    img = _euroc_image(3)
    H, W = img.shape
    rng = np.random.default_rng(4)
    inner = np.stack([rng.uniform(0, W - 1, 48), rng.uniform(0, H - 1, 48)],
                     -1)
    edges = np.asarray([[0.0, 0.0], [W - 1, H - 1], [0.0, H - 1],
                        [W - 1, 0.0], [3.5, 240.5], [748.5, 2.5],
                        [-30.0, 100.0], [900.0, -80.0]])
    xy = jnp.asarray(np.concatenate([inner, edges]), jnp.float32)
    if stage == "orb":
        fields = [blur(img, 2.0)]
        P, c = orb.PATCH, orb.CENTER
    else:
        fields = list(sobel(blur(img, 1.4)))
        P, c = lbd.PATCH, lbd.CENTER
    for f in fields:
        got = jax.jit(extract_patches, static_argnums=(2, 3))(f, xy, P, c)
        want = jax.jit(extract_patches_onehot, static_argnums=(2, 3))(f, xy, P, c)
        assert got.shape == (len(xy), P, P)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_gather_sampling_matches_onehot_reference():
    rng = np.random.default_rng(5)
    patches = jnp.asarray(rng.normal(0, 50, (20, 48, 48)), jnp.float32)
    # in-patch coords including out-of-patch samples (read as zero)
    uv = jnp.asarray(rng.uniform(-3, 50, (20, 512, 2)), jnp.float32)
    got = np.asarray(jax.jit(sample_in_patches)(patches, uv))
    want = np.asarray(jax.jit(sample_in_patches_onehot)(patches, uv))
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any()
