"""Native dataloader tests: PNG round trip, remap vs the JAX op, threaded
prefetch ordering."""

import os
import tempfile

import numpy as np
import pytest

from plslam_tpu.native import loader


@pytest.fixture(scope="module", autouse=True)
def native_lib():
    # decided here, not at import: the library is built from source on
    # first use, and every test worker must collect the same tests
    if not loader.available():
        pytest.skip("native library could not be built (g++ and libpng)")

try:
    import cv2
except Exception:
    cv2 = None


@pytest.fixture(scope="module")
def png_dir():
    rng = np.random.default_rng(0)
    d = tempfile.mkdtemp()
    files_l, files_r, imgs = [], [], []
    for i in range(6):
        img_l = rng.integers(0, 255, (48, 64), np.uint8)
        img_r = rng.integers(0, 255, (48, 64), np.uint8)
        pl = os.path.join(d, f"l_{i:03d}.png")
        pr = os.path.join(d, f"r_{i:03d}.png")
        assert cv2 is not None
        cv2.imwrite(pl, img_l)
        cv2.imwrite(pr, img_r)
        files_l.append(pl)
        files_r.append(pr)
        imgs.append((img_l, img_r))
    return files_l, files_r, imgs


def test_decode_png_exact(png_dir):
    files_l, _, imgs = png_dir
    got = loader.decode_png(files_l[0])
    np.testing.assert_array_equal(got, imgs[0][0].astype(np.float32))


def test_remap_matches_jax_op(png_dir):
    import jax.numpy as jnp

    from plslam_tpu.ops.image import remap as jax_remap

    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    map_x = rng.uniform(0, 63, (40, 50)).astype(np.float32)
    map_y = rng.uniform(0, 47, (40, 50)).astype(np.float32)
    native = loader.remap(np.round(img), map_x, map_y)
    import jax

    jref = np.asarray(jax.jit(jax_remap)(
        jnp.asarray(np.round(img)), jnp.asarray(map_x), jnp.asarray(map_y)))
    np.testing.assert_allclose(native, jref, atol=1e-3)


def test_threaded_loader_order_and_content(png_dir):
    files_l, files_r, imgs = png_dir
    ld = loader.NativeStereoLoader(files_l, files_r, 64, 48, n_threads=3)
    for i in range(len(files_l)):
        il, ir = ld.get(i)
        np.testing.assert_array_equal(il, imgs[i][0].astype(np.float32))
        np.testing.assert_array_equal(ir, imgs[i][1].astype(np.float32))
    ld.close()


def test_loader_with_rectification_maps(png_dir):
    files_l, files_r, imgs = png_dir
    # identity maps -> images unchanged
    yy, xx = np.mgrid[0:48, 0:64].astype(np.float32)
    maps = ((xx, yy), (xx, yy))
    ld = loader.NativeStereoLoader(files_l, files_r, 64, 48, maps=maps,
                                   n_threads=2)
    il, ir = ld.get(0)
    np.testing.assert_allclose(il, imgs[0][0].astype(np.float32), atol=1e-4)
    ld.close()
