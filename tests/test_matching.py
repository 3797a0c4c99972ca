"""Matching-kernel tests against a numpy brute-force oracle implementing the
reference semantics (matching.cpp matchNNR/match/matchGrid)."""

import jax
import jax.numpy as jnp
import numpy as np

from plslam_tpu.ops import descriptors as D
from plslam_tpu.ops import matching as M

RNG = np.random.default_rng(3)


def rand_desc(n):
    return RNG.integers(0, 2**32, size=(n, 8), dtype=np.uint32)


def np_hamming(a, b):
    bits_a = np.unpackbits(a.view(np.uint8), axis=-1, bitorder="little")
    bits_b = np.unpackbits(b.view(np.uint8), axis=-1, bitorder="little")
    return (bits_a[:, None, :] != bits_b[None, :, :]).sum(-1).astype(np.int32)


def np_mutual_nnr(dist, mask, nnr):
    """Oracle: strict NNR + mutual best (matching.cpp:63-89 semantics)."""
    d = np.where(mask, dist, 1 << 20)
    n1, n2 = d.shape
    m12 = -np.ones(n1, dtype=np.int64)
    for i in range(n1):
        order = np.argsort(d[i], kind="stable")
        b, s = d[i][order[0]], d[i][order[1]] if n2 > 1 else 1 << 20
        if b < (1 << 20) and b < nnr * s:
            m12[i] = order[0]
    m21 = -np.ones(n2, dtype=np.int64)
    for j in range(n2):
        order = np.argsort(d[:, j], kind="stable")
        m21[j] = order[0] if d[order[0], j] < (1 << 20) else -1
    for i in range(n1):
        if m12[i] >= 0 and m21[m12[i]] != i:
            m12[i] = -1
    return m12


def test_pack_unpack_roundtrip():
    d = jnp.asarray(rand_desc(13))
    f = jax.jit(lambda x: D.pack_bits(D.unpack_bits(x)))
    np.testing.assert_array_equal(np.asarray(f(d)), np.asarray(d))


def test_hamming_mxu_equals_popcount_and_numpy():
    d1 = rand_desc(33)
    d2 = rand_desc(47)
    j1, j2 = jnp.asarray(d1), jnp.asarray(d2)
    f_mat = jax.jit(D.hamming_distance_matrix)
    f_pop = jax.jit(D.hamming_distance_matrix_popcount)
    ref = np_hamming(d1, d2)
    np.testing.assert_array_equal(np.asarray(f_mat(j1, j2)), ref)
    np.testing.assert_array_equal(np.asarray(f_pop(j1, j2)), ref)


def test_match_mutual_nnr_vs_oracle():
    n1, n2 = 60, 55
    d1 = rand_desc(n1)
    # half of set2 = noisy copies of set1 entries -> real matches exist
    d2 = rand_desc(n2)
    for j in range(0, n2, 2):
        src = d1[j % n1].copy()
        # flip a few bits
        for _ in range(4):
            w = RNG.integers(0, 8)
            src[w] ^= np.uint32(1) << RNG.integers(0, 32)
        d2[j] = src
    mask = RNG.random((n1, n2)) < 0.9
    dist = np_hamming(d1, d2)
    ref = np_mutual_nnr(dist, mask, 0.9)

    f = jax.jit(lambda a, b, m: M.match_mutual_nnr(
        D.hamming_distance_matrix(a, b), m, 0.9))
    got = np.asarray(f(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(mask)).idx)
    # ties can be broken differently; require agreement wherever both matched
    agree = (got == ref) | (got == -1) | (ref == -1)
    assert agree.mean() > 0.97, (got, ref)
    # and the genuinely-planted strong matches must be found
    planted = [(j % n1, j) for j in range(0, n2, 2) if mask[j % n1, j]]
    hits = sum(1 for i, j in planted if got[i] == j)
    assert hits >= 0.8 * len(planted)


def test_invalid_never_matches():
    d1, d2 = rand_desc(10), rand_desc(10)
    valid1 = np.zeros(10, bool)
    mask = np.ones((10, 10), bool) & valid1[:, None]
    f = jax.jit(lambda a, b, m: M.match_mutual_nnr(
        D.hamming_distance_matrix(a, b), m, 0.9))
    got = np.asarray(f(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(mask)).idx)
    assert np.all(got == -1)


def test_stereo_mask_geometry():
    xy_l = jnp.asarray([[100.0, 50.0], [20.0, 50.0]])
    xy_r = jnp.asarray([[90.0, 50.5], [110.0, 50.0], [90.0, 80.0]])
    v = jnp.ones(2, bool), jnp.ones(3, bool)
    m = np.asarray(M.stereo_point_pair_mask(xy_l, xy_r, v[0], v[1], 60.0, 1.0))
    assert m[0, 0]          # disparity 10, same row
    assert not m[0, 1]      # negative disparity
    assert not m[0, 2]      # row mismatch
    assert not m[1, 0]      # would need disparity -70


def test_line_mask_direction_filter():
    sp1 = jnp.asarray([[0.0, 0.0]])
    ep1 = jnp.asarray([[10.0, 0.0]])
    sp2 = jnp.asarray([[0.0, 1.0], [0.0, 0.0]])
    ep2 = jnp.asarray([[10.0, 1.0], [0.0, 10.0]])  # parallel, perpendicular
    v1 = jnp.ones(1, bool)
    v2 = jnp.ones(2, bool)
    m = np.asarray(M.line_pair_mask(sp1, ep1, sp2, ep2, v1, v2, 5.0, 0.75))
    assert m[0, 0]
    assert not m[0, 1]


def test_full_segment_mask_catches_partial_fragments():
    """A short detected fragment lying along the MIDDLE of a long line
    must be a candidate (the reference rasterizes the full segment into
    grid cells, lineIterator.cpp:34-77): the symmetric point-to-segment
    mask accepts it, while both r3 approximations — midpoint windows and
    one-sided endpoint checks — reject it."""
    sp1 = jnp.asarray([[0.0, 100.0]])
    ep1 = jnp.asarray([[400.0, 100.0]])      # long line
    sp2 = jnp.asarray([[190.0, 101.0]])
    ep2 = jnp.asarray([[230.0, 101.0]])      # central fragment
    v = jnp.ones(1, bool)
    radius = 40.0
    full = M.line_pair_mask(sp1, ep1, sp2, ep2, v, v, radius, 0.75)
    assert bool(full[0, 0])
    # midpoint distance is |200-210| = 10 < radius here; shift the
    # fragment toward one end so midpoints drift apart
    sp2b = jnp.asarray([[300.0, 101.0]])
    ep2b = jnp.asarray([[340.0, 101.0]])
    full_b = M.line_pair_mask(sp1, ep1, sp2b, ep2b, v, v, radius, 0.75)
    assert bool(full_b[0, 0])
    mid1 = 0.5 * (sp1 + ep1)                 # (200, 100)
    mid2b = 0.5 * (sp2b + ep2b)              # (320, 101)
    midw = M.window_pair_mask(mid1, mid2b, v, v, radius, radius)
    assert not bool(midw[0, 0]), "midpoint window should miss this"
    # one-sided (endpoints of the LONG line vs the fragment): both long
    # endpoints are > radius from the fragment
    r2 = radius * radius
    d_s = M._point_segment_dist2(sp1, sp2b, ep2b)
    d_e = M._point_segment_dist2(ep1, sp2b, ep2b)
    assert not bool((d_s <= r2)[0, 0]) and not bool((d_e <= r2)[0, 0]), \
        "one-sided endpoint check should miss this"
