"""Binary descriptor utilities: packing, unpacking, Hamming distance.

The reference computes 256-bit ORB/LBD Hamming distances with a scalar
popcount loop over 8 int32 words per pair (src2/matching.cpp:93-109).
Here the same computation is one matmul: unpack each descriptor to a +/-1
vector b in {-1,+1}^256, then

    popcount(a XOR b) = (256 - <a_pm, b_pm>) / 2

so an (N1, 256) x (256, N2) matmul produces the full distance matrix.  A
`lax.population_count` path is kept as the exact oracle.

Descriptors are stored packed as uint32[8] (256 bits) with a validity mask.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

DESC_WORDS = 8
DESC_BITS = DESC_WORDS * 32


def unpack_bits(desc: jax.Array) -> jax.Array:
    """(..., 8) uint32 -> (..., 256) int8 in {0, 1}; bit i of word w maps to
    position w*32 + i (LSB-first, matching the packing in pack_bits)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[..., :, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(desc.shape[:-1] + (DESC_BITS,)).astype(jnp.int8)


def pack_bits(bits: jax.Array) -> jax.Array:
    """(..., 256) {0,1} -> (..., 8) uint32, LSB-first per word."""
    b = bits.reshape(bits.shape[:-1] + (DESC_WORDS, 32)).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts, axis=-1, dtype=jnp.uint32)


def hamming_distance_matrix_popcount(d1: jax.Array, d2: jax.Array) -> jax.Array:
    """Exact (N1, N2) Hamming distances via XOR + population_count.

    Oracle path; O(N1*N2*8) VPU work.
    """
    x = jax.lax.population_count(d1[:, None, :] ^ d2[None, :, :])
    return jnp.sum(x, axis=-1).astype(jnp.int32)


def hamming_distance_matrix(d1: jax.Array, d2: jax.Array) -> jax.Array:
    """(N1, N2) Hamming distances via the +/-1 matmul identity.

    Exact at any matmul precision: +/-1 is exact in bf16 and TF32, and the
    dot of two {-1,+1}^256 vectors is an integer in [-256, 256], exact in
    an f32 accumulator.  So this one matmul states DEFAULT precision even
    inside a full-f32 scope.
    """
    b1 = unpack_bits(d1).astype(jnp.float32) * 2.0 - 1.0
    b2 = unpack_bits(d2).astype(jnp.float32) * 2.0 - 1.0
    dot = jax.lax.dot_general(
        b1, b2, (((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.DEFAULT,
        preferred_element_type=jnp.float32)
    return ((DESC_BITS - dot) * 0.5).astype(jnp.int32)
