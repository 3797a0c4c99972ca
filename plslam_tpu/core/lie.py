"""SE(3)/SO(3) Lie-group operations as pure, batchable JAX functions.

Behavioral spec: reference ``src2/auxiliar.cpp`` (skew :29, expmap_se3 :124,
logmap_se3 :143, adjoint_se3 :175, uncTinv_se3 :184, unccomp_se3 :192,
inverse_se3 :111).  Twist layout follows the reference convention
``x = [t(3); w(3)]`` — translation first, rotation last.

Everything here is shape-polymorphic over leading batch dimensions (use
``jax.vmap``) and dtype-polymorphic (float32 on the accelerator, float64 in CPU tests).
All branches are implemented with ``jnp.where`` on Taylor-safe arguments so
the functions are jit- and grad-safe at theta -> 0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .numerics import cos as _cos

_EPS = 1e-8


def skew(v: jax.Array) -> jax.Array:
    """3-vector -> 3x3 skew-symmetric matrix (auxiliar.cpp:29)."""
    z = jnp.zeros_like(v[..., 0])
    return jnp.stack(
        [
            jnp.stack([z, -v[..., 2], v[..., 1]], axis=-1),
            jnp.stack([v[..., 2], z, -v[..., 0]], axis=-1),
            jnp.stack([-v[..., 1], v[..., 0], z], axis=-1),
        ],
        axis=-2,
    )


def unskew(M: jax.Array) -> jax.Array:
    """3x3 skew matrix -> 3-vector (auxiliar.cpp skewcoords :58)."""
    return jnp.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], axis=-1)


def _safe_norm(v: jax.Array):
    """(norm, small_mask) with a NaN-free gradient at v = 0.

    The squared norm is differentiable everywhere; sqrt's gradient blows up
    at 0, so the small branch routes sqrt through a constant 1 that never
    contributes to the output (standard where-trick)."""
    sq = jnp.sum(v * v, axis=-1)
    small = sq < 1e-8
    norm = jnp.sqrt(jnp.where(small, jnp.ones_like(sq), sq))
    return jnp.where(small, jnp.zeros_like(norm), norm), small


def _sinc_coeffs_sq(theta_sq: jax.Array, theta: jax.Array, small: jax.Array):
    """Taylor-safe (sin t/t, (1-cos t)/t^2, (t-sin t)/t^3).

    ``theta`` must already be guarded by ``small`` (from _safe_norm) so the
    untaken branch never produces NaN in value or gradient; the small branch
    depends only on theta_sq, which is smooth at 0."""
    t2 = theta_sq
    ts = jnp.where(small, jnp.ones_like(theta), theta)
    a = jnp.where(small, 1.0 - t2 / 6.0, jnp.sin(ts) / ts)
    b = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - _cos(ts)) / (ts * ts))
    c = jnp.where(small, 1.0 / 6.0 - t2 / 120.0, (ts - jnp.sin(ts)) / (ts * ts * ts))
    return a, b, c


def _sinc_coeffs(theta: jax.Array):
    small = theta < 1e-4
    return _sinc_coeffs_sq(theta * theta, theta, small)


def exp_so3(w: jax.Array) -> jax.Array:
    """Rodrigues' formula: axis-angle -> rotation matrix."""
    theta, small = _safe_norm(w)
    a, b, _ = _sinc_coeffs_sq(jnp.sum(w * w, axis=-1), theta, small)
    W = skew(w)
    I = jnp.eye(3, dtype=w.dtype)
    return I + a[..., None, None] * W + b[..., None, None] * (W @ W)


def log_so3(R: jax.Array) -> jax.Array:
    """Rotation matrix -> axis-angle (auxiliar.cpp logarithm_map_so3 :207)."""
    cos_t = jnp.clip((jnp.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    # Generic branch: w = theta * unskew(R - R^T) / (2 sin theta).
    w_raw = unskew(R - jnp.swapaxes(R, -1, -2))
    # ||R - R^T||-based sine: uniformly well-conditioned vs arccos.
    raw_norm, _ = _safe_norm(w_raw)
    sin_t = 0.5 * raw_norm
    theta = jnp.arctan2(sin_t, cos_t)
    small = theta < 1e-6
    # Near theta=0: w ~ 0.5*unskew(R - R^T).  Near theta=pi sin->0: use the
    # diagonal formula w_i = theta * sqrt((R_ii - cos)/ (1-cos)) with signs
    # from the off-diagonal symmetric part.
    near_pi = cos_t < -1.0 + 1e-6
    denom = jnp.where(small | near_pi, jnp.ones_like(sin_t), 2.0 * sin_t)
    w_generic = theta[..., None] * w_raw / denom[..., None]
    w_small = 0.5 * w_raw
    # theta ~ pi branch
    diag = jnp.diagonal(R, axis1=-2, axis2=-1)
    axis_sq = jnp.clip((diag - cos_t[..., None]) / (1.0 - cos_t[..., None] + _EPS), 0.0, None)
    axis = jnp.sqrt(axis_sq)
    # Fix signs using the skew part where possible, else the symmetric part.
    s01 = R[..., 0, 1] + R[..., 1, 0]
    s02 = R[..., 0, 2] + R[..., 2, 0]
    # pick the largest axis component as positive and sign the others
    sign1 = jnp.where(s01 >= 0, 1.0, -1.0)
    sign2 = jnp.where(s02 >= 0, 1.0, -1.0)
    axis = axis * jnp.stack(
        [jnp.ones_like(axis[..., 0]), sign1, sign2], axis=-1
    )
    nrm = jnp.linalg.norm(axis, axis=-1, keepdims=True)
    w_pi = theta[..., None] * axis / jnp.where(nrm > 0, nrm, 1.0)
    w = jnp.where(small[..., None], w_small, jnp.where(near_pi[..., None], w_pi, w_generic))
    return w


def left_jacobian_so3(w: jax.Array) -> jax.Array:
    """V(w) such that exp_se3 translation = V t (auxiliar.cpp:136)."""
    theta, small = _safe_norm(w)
    _, b, c = _sinc_coeffs_sq(jnp.sum(w * w, axis=-1), theta, small)
    W = skew(w)
    I = jnp.eye(3, dtype=w.dtype)
    return I + b[..., None, None] * W + c[..., None, None] * (W @ W)


def inv_left_jacobian_so3(w: jax.Array) -> jax.Array:
    """Closed-form inverse of the SO(3) left Jacobian."""
    theta, small = _safe_norm(w)
    W = skew(w)
    I = jnp.eye(3, dtype=w.dtype)
    t2 = jnp.sum(w * w, axis=-1)
    ts = jnp.where(small, jnp.ones_like(theta), theta)
    # coefficient of W @ W: (1/theta^2)(1 - (theta sin)/(2(1-cos)))
    half = 0.5 * ts
    cot = _cos(half) / jnp.sin(jnp.where(small, jnp.ones_like(half), half))
    coef = jnp.where(
        small,
        1.0 / 12.0 + t2 / 720.0,
        (1.0 - 0.5 * ts * cot) / (ts * ts),
    )
    return I - 0.5 * W + coef[..., None, None] * (W @ W)


def exp_se3(x: jax.Array) -> jax.Array:
    """Twist [t; w] -> 4x4 homogeneous transform (auxiliar.cpp expmap_se3 :124)."""
    t, w = x[..., :3], x[..., 3:]
    R = exp_so3(w)
    V = left_jacobian_so3(w)
    T = jnp.zeros(x.shape[:-1] + (4, 4), dtype=x.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(jnp.einsum("...ij,...j->...i", V, t))
    T = T.at[..., 3, 3].set(1.0)
    return T


def log_se3(T: jax.Array) -> jax.Array:
    """4x4 transform -> twist [t; w] (auxiliar.cpp logmap_se3 :143)."""
    R = T[..., :3, :3]
    w = log_so3(R)
    Vinv = inv_left_jacobian_so3(w)
    t = jnp.einsum("...ij,...j->...i", Vinv, T[..., :3, 3])
    return jnp.concatenate([t, w], axis=-1)


def inv_se3(T: jax.Array) -> jax.Array:
    """Closed-form SE(3) inverse (auxiliar.cpp inverse_se3 :111)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    Ti = jnp.zeros_like(T)
    Ti = Ti.at[..., :3, :3].set(Rt)
    Ti = Ti.at[..., :3, 3].set(-jnp.einsum("...ij,...j->...i", Rt, t))
    Ti = Ti.at[..., 3, 3].set(1.0)
    return Ti


def adjoint_se3(T: jax.Array) -> jax.Array:
    """6x6 adjoint for the [t; w] twist layout (auxiliar.cpp adjoint_se3 :175).

    Adj = [[R, skew(t) R], [0, R]].
    """
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    A = jnp.zeros(T.shape[:-2] + (6, 6), dtype=T.dtype)
    A = A.at[..., :3, :3].set(R)
    A = A.at[..., :3, 3:].set(skew(t) @ R)
    A = A.at[..., 3:, 3:].set(R)
    return A


def cov_Tinv(T: jax.Array, cov: jax.Array) -> jax.Array:
    """Covariance of T^-1 given cov of T (auxiliar.cpp uncTinv_se3 :184)."""
    A = adjoint_se3(inv_se3(T))
    return A @ cov @ jnp.swapaxes(A, -1, -2)


def cov_compose(T1: jax.Array, cov1: jax.Array, cov_inc: jax.Array) -> jax.Array:
    """Covariance of T1 * Tinc^-1 (auxiliar.cpp unccomp_se3 :192)."""
    A = adjoint_se3(T1)
    return cov1 + A @ cov_inc @ jnp.swapaxes(A, -1, -2)


def transform_point(T: jax.Array, P: jax.Array) -> jax.Array:
    """Apply a 4x4 transform to 3D point(s); broadcasts over batch dims."""
    return jnp.einsum("...ij,...j->...i", T[..., :3, :3], P) + T[..., :3, 3]


def se3_chordal_project(T: jax.Array) -> jax.Array:
    """Re-orthonormalize the rotation block via exp(log(T)).

    The reference repeatedly applies ``expmap_se3(logmap_se3(T))`` to keep
    chained poses on the manifold (stereoFrameHandler.cpp:385-389); this is
    the same operation.
    """
    return exp_se3(log_se3(T))
