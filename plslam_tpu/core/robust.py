"""Robust statistics on padded (masked) residual arrays.

Behavioral spec: reference ``src2/auxiliar.cpp`` — vector_stdv_mad (:438),
vector_mean_stdv_mad (:387), robustWeightCauchy (:556).  The reference works
on std::vector<double> of the live residuals; here every array is
fixed-shape with a validity mask, so the median is taken over valid entries
only by sorting with +inf padding and indexing at n_valid // 2 (the
reference's upper-median choice, residues[n/2]).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

MAD_SCALE = 1.4826


def masked_median_upper(x: jax.Array, mask: jax.Array) -> jax.Array:
    """median = sorted(valid)[n_valid // 2], matching residues[n/2] in the
    reference.  Invalid entries are pushed to +inf; returns 0 if no valid."""
    n_valid = jnp.sum(mask.astype(jnp.int32))
    big = jnp.asarray(jnp.inf, dtype=x.dtype)
    xs = jnp.sort(jnp.where(mask, x, big))
    idx = jnp.clip(n_valid // 2, 0, x.shape[-1] - 1)
    med = xs[idx]
    return jnp.where(n_valid > 0, med, jnp.zeros_like(med))


def mad_stdv(x: jax.Array, mask: jax.Array) -> jax.Array:
    """1.4826 * median(|x - median(x)|) over valid entries
    (auxiliar.cpp vector_stdv_mad :438)."""
    med = masked_median_upper(x, mask)
    dev = jnp.abs(x - med)
    return MAD_SCALE * masked_median_upper(dev, mask)


def mean_stdv_mad(x: jax.Array, mask: jax.Array):
    """(mean, stdv) with the reference's trimmed mean
    (auxiliar.cpp vector_mean_stdv_mad :387): stdv by MAD; mean over samples
    < 2*stdv if those are >= 20% of the population, else plain mean."""
    stdv = mad_stdv(x, mask)
    n = jnp.sum(mask.astype(x.dtype))
    good = mask & (x < 2.0 * stdv)
    k = jnp.sum(good.astype(x.dtype))
    trimmed = jnp.sum(jnp.where(good, x, 0.0)) / jnp.maximum(k, 1.0)
    full = jnp.sum(jnp.where(mask, x, 0.0)) / jnp.maximum(n, 1.0)
    mean = jnp.where(k >= 0.2 * n, trimmed, full)
    mean = jnp.where(n > 0, mean, jnp.zeros_like(mean))
    return mean, stdv


def cauchy_weight(norm_res: jax.Array) -> jax.Array:
    """w = 1 / (1 + r^2) (auxiliar.cpp robustWeightCauchy :556)."""
    return 1.0 / (1.0 + norm_res * norm_res)


def clipped_mad_scale(res: jax.Array, mask: jax.Array,
                      th_min: float = 1e-4, th_max: float = 7.815 ** 0.5) -> jax.Array:
    """MAD scale clipped to [th_min, th_max] as in the pose optimizers
    (stereoFrameHandler.cpp:612-650)."""
    s = mad_stdv(res, mask)
    return jnp.clip(s, th_min, th_max)


def clipped_mad_scale_pair(res_a: jax.Array, mask_a: jax.Array,
                           res_b: jax.Array, mask_b: jax.Array,
                           th_min: float = 1e-4,
                           th_max: float = 7.815 ** 0.5):
    """Both modalities' clipped MAD scales with BATCHED sorts.

    The GN tracker needs the point and line scales every iteration; done
    separately that is 4 sorts per iteration (median + median-of-
    deviations, per modality).  A device sort is vectorized across leading
    axes, so padding the two residual vectors to a common width and
    sorting a (2, N) stack costs about one sort — this helper halves the
    sort count of the tracker's hottest sequential loop.  Per-row results
    are bit-identical to clipped_mad_scale (padding enters masked-False,
    i.e. +inf, beyond each row's true slots)."""
    n = max(res_a.shape[-1], res_b.shape[-1])
    dt = res_a.dtype

    def pad(x, fill):
        return jnp.pad(x, (0, n - x.shape[-1]), constant_values=fill)

    x = jnp.stack([pad(res_a.astype(dt), 0), pad(res_b.astype(dt), 0)])
    m = jnp.stack([pad(mask_a, False), pad(mask_b, False)])

    def med2(v):
        n_valid = jnp.sum(m.astype(jnp.int32), axis=-1)           # (2,)
        vs = jnp.sort(jnp.where(m, v, jnp.asarray(jnp.inf, dt)), axis=-1)
        idx = jnp.clip(n_valid // 2, 0, n - 1)
        got = jnp.take_along_axis(vs, idx[:, None], axis=-1)[:, 0]
        return jnp.where(n_valid > 0, got, jnp.zeros_like(got))

    med = med2(x)
    s = MAD_SCALE * med2(jnp.abs(x - med[:, None]))
    s = jnp.clip(s, th_min, th_max)
    return s[0], s[1]
