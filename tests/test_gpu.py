"""Checks that need the GPU: the compiled gathers and the TF32 Hamming
matmul against their references.  They skip without a GPU; chip_smoke.py
runs the same comparisons at full width."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plslam_tpu.ops.descriptors import (hamming_distance_matrix,
                                        hamming_distance_matrix_popcount)
from plslam_tpu.ops.patches import extract_patches, extract_patches_onehot

pytestmark = pytest.mark.gpu


def test_gpu_patch_gather_matches_cpu_onehot(gpu_device):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (480, 752)).astype(np.float32)
    xy = np.stack([rng.uniform(-10, 760, 300), rng.uniform(-10, 490, 300)],
                  -1).astype(np.float32)
    fn = jax.jit(extract_patches, static_argnums=(2, 3))
    got = fn(jax.device_put(img, gpu_device), jax.device_put(xy, gpu_device),
             48, 23.0)
    cpu = jax.devices("cpu")[0]
    want = jax.jit(extract_patches_onehot, static_argnums=(2, 3))(
        jax.device_put(img, cpu), jax.device_put(xy, cpu), 48, 23.0)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_gpu_hamming_matmul_exact(gpu_device):
    rng = np.random.default_rng(1)
    d = [jax.device_put(jnp.asarray(
        rng.integers(0, 2**32, (1200, 8), dtype=np.uint64).astype(np.uint32)),
        gpu_device) for _ in range(2)]
    np.testing.assert_array_equal(
        np.asarray(jax.jit(hamming_distance_matrix)(*d)),
        np.asarray(jax.jit(hamming_distance_matrix_popcount)(*d)))
