"""Small-matrix linear algebra without LAPACK custom calls.

Small batched factorizations fuse into the surrounding programs as plain
jnp code instead of dispatching one library call each.  BA and the pose
tracker only ever need:

- batched 3x3 / 4x4 inverses (landmark blocks)       -> closed-form adjugate
- one small dense SPD solve (6x6 .. ~200x200)        -> scan Cholesky
- PSD checks / eigenvalue bounds of a 6x6 covariance -> Cholesky + Gershgorin

All routines are pure jnp (any dtype, any backend) and batch over leading
dimensions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def inv3x3(A: jax.Array) -> jax.Array:
    """Closed-form inverse of (..., 3, 3) via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / det
    adj = jnp.stack(
        [
            jnp.stack([co_a, -(b * i - c * h), b * f - c * e], axis=-1),
            jnp.stack([co_b, a * i - c * g, -(a * f - c * d)], axis=-1),
            jnp.stack([co_c, -(a * h - b * g), a * e - b * d], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def inv4x4(A: jax.Array) -> jax.Array:
    """Closed-form inverse of (..., 4, 4) via 2x2 blockwise inversion with
    a fallback-free Schur form: requires the (damped, SPD) top-left block to
    be invertible — always true for LM-damped Hessian blocks."""
    P = A[..., :2, :2]
    Q = A[..., :2, 2:]
    R = A[..., 2:, :2]
    S = A[..., 2:, 2:]

    def inv2(M):
        a, b = M[..., 0, 0], M[..., 0, 1]
        c, d = M[..., 1, 0], M[..., 1, 1]
        det = a * d - b * c
        inv_det = 1.0 / det
        return jnp.stack(
            [jnp.stack([d, -b], axis=-1), jnp.stack([-c, a], axis=-1)],
            axis=-2,
        ) * inv_det[..., None, None]

    Pi = inv2(P)
    M = S - R @ Pi @ Q          # Schur complement of P
    Mi = inv2(M)
    TL = Pi + Pi @ Q @ Mi @ R @ Pi
    TR = -Pi @ Q @ Mi
    BL = -Mi @ R @ Pi
    BR = Mi
    top = jnp.concatenate([TL, TR], axis=-1)
    bot = jnp.concatenate([BL, BR], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


# Unroll factorizations/substitutions up to this size: the 6x6 tracker
# solve and the <=64-dim Schur reduced-camera solves sit inside scan
# bodies where per-step loop overhead dominates; larger solves (PGO,
# multi-block reduced systems) stay lax.scan to bound compile time.  The
# thresholds are not yet tuned on the GPU.
_UNROLL_N = 64

# Above this size, hand over to XLA's native blocked Cholesky /
# TriangularSolve (jnp.linalg.cholesky + jax.scipy.linalg.solve_triangular).
# The scan forms run one COLUMN per sequential step — a 512-keyframe
# reduced camera system is a 3072x3072 solve, i.e. 3072 latency-bound
# scan steps, while the blocked HLOs run panel-at-a-time.  The scan forms
# stay for small/mid systems where they fuse into surrounding programs.
_BLOCKED_N = 192


def cholesky(A: jax.Array) -> jax.Array:
    """Lower-triangular Cholesky of one (n, n) SPD matrix via lax.scan over
    columns (no LAPACK).  Returns NaN columns on non-SPD input (caller
    checks with is_finite)."""
    n = A.shape[-1]
    dtype = A.dtype

    def body(L, j):
        col = A[:, j]
        # subtract sum_k<j L[:, k] * L[j, k]
        mask = jnp.arange(n) < j
        s = jnp.sum(L * jnp.where(mask, L[j], 0.0)[None, :], axis=1)
        v = col - s
        diag = jnp.sqrt(v[j])
        newcol = jnp.where(jnp.arange(n) >= j, v / diag, 0.0)
        newcol = newcol.at[j].set(diag)
        L = L.at[:, j].set(newcol)
        return L, None

    L = jnp.zeros((n, n), dtype)
    if n <= _UNROLL_N:
        # unrolled: a 6x6 solve inside a GN scan body pays per-step loop
        # overhead 3x (cholesky + 2 substitutions); static unrolling lets
        # XLA fuse the whole factorization into the surrounding program
        for j in range(n):
            L, _ = body(L, j)
        return L
    if n >= _BLOCKED_N:
        return jnp.linalg.cholesky(A)
    L, _ = jax.lax.scan(body, L, jnp.arange(n))
    return L


def solve_triangular_lower(L: jax.Array, b: jax.Array) -> jax.Array:
    """Solve L y = b for lower-triangular L via forward substitution."""
    n = L.shape[-1]

    def body(y, i):
        s = jnp.dot(L[i], y)
        yi = (b[i] - s) / L[i, i]
        return y.at[i].set(yi), None

    y = jnp.zeros_like(b)
    if n <= _UNROLL_N:
        for i in range(n):
            y, _ = body(y, i)
        return y
    if n >= _BLOCKED_N:
        from jax.scipy.linalg import solve_triangular

        return solve_triangular(L, b, lower=True)
    y, _ = jax.lax.scan(body, y, jnp.arange(n))
    return y


def solve_triangular_upper(U: jax.Array, b: jax.Array) -> jax.Array:
    """Solve U x = b for upper-triangular U via back substitution."""
    n = U.shape[-1]

    def body(x, i):
        j = n - 1 - i
        s = jnp.dot(U[j], x)
        xj = (b[j] - s) / U[j, j]
        return x.at[j].set(xj), None

    x = jnp.zeros_like(b)
    if n <= _UNROLL_N:
        for i in range(n):
            x, _ = body(x, i)
        return x
    if n >= _BLOCKED_N:
        from jax.scipy.linalg import solve_triangular

        return solve_triangular(U, b, lower=False)
    x, _ = jax.lax.scan(body, x, jnp.arange(n))
    return x


def solve_spd(A: jax.Array, b: jax.Array) -> jax.Array:
    """Solve A x = b for SPD A via scan-Cholesky; NaN on non-SPD."""
    L = cholesky(A)
    y = solve_triangular_lower(L, b)
    return solve_triangular_upper(L.T, y)


def is_spd(A: jax.Array) -> jax.Array:
    """True iff the scan-Cholesky succeeded with strictly positive diagonal."""
    L = cholesky(A)
    return jnp.all(jnp.isfinite(L)) & jnp.all(jnp.diagonal(L) > 0)


def gershgorin_bounds(A: jax.Array):
    """(lower, upper) bounds on the eigenvalues of a symmetric matrix."""
    diag = jnp.diagonal(A, axis1=-2, axis2=-1)
    off = jnp.sum(jnp.abs(A), axis=-1) - jnp.abs(diag)
    return jnp.min(diag - off, axis=-1), jnp.max(diag + off, axis=-1)
