"""SE(3) pose-graph optimization (loop-closure correction).

Behavioral spec: reference ``src/mapHandler.cpp`` —
loopClosureOptimizationEssGraphG2O (:5070-5299) and
loopClosureOptimizationCovGraphG2O (:5301-5531): g2o VertexSE3 per keyframe,
EdgeSE3 between consecutive / covisible pairs plus the loop-closure edges,
gauge fixed at KF0 (Cov variant :5368).

Design: all edge residuals e_ij = log(Zij^-1 T_i^-1 T_j) and
their Jacobians (per-edge jacfwd over the 12-dim tangent of the two incident
poses — exact, batched with vmap) are evaluated in one program; the sparse
Hessian is scatter-added into a dense (6K, 6K) system solved by scan-
Cholesky.  Keyframe counts here are <= a few hundred, so the dense reduced
system is small; the distributed variant shards edge assembly and psum-
reduces the blocks (parallel/dist_match.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import lie, linalg
from ..core.numerics import full_f32_matmuls


class PoseGraph(NamedTuple):
    T_w_k: jax.Array      # (K, 4, 4) keyframe poses (kf -> world)
    fixed: jax.Array      # (K,) bool gauge mask
    valid: jax.Array      # (K,) bool
    e_i: jax.Array        # (E,) int32 edge source
    e_j: jax.Array        # (E,) int32 edge target
    e_T: jax.Array        # (E, 4, 4) measured T_i^-1 T_j
    e_info: jax.Array     # (E,) scalar information weight
    e_valid: jax.Array    # (E,) bool


def edge_residual(Ti, Tj, Zij):
    """e = log(Zij^-1 Ti^-1 Tj) — zero when the measurement is satisfied."""
    return lie.log_se3(lie.inv_se3(Zij) @ lie.inv_se3(Ti) @ Tj)


def _edge_res_and_jac(Ti, Tj, Zij):
    """Residual + exact Jacobians wrt right-perturbations of Ti and Tj
    (T exp(delta)) via forward-mode autodiff on the 6+6 tangent."""

    def f(dij):
        di, dj = dij[:6], dij[6:]
        return edge_residual(Ti @ lie.exp_se3(di), Tj @ lie.exp_se3(dj), Zij)

    z = jnp.zeros(12, Ti.dtype)
    e = f(z)
    J = jax.jacfwd(f)(z)  # (6, 12)
    return e, J[:, :6], J[:, 6:]


def build_system(g: PoseGraph):
    """Assemble the (6K, 6K) Gauss-Newton system over all edges."""
    K = g.T_w_k.shape[0]
    dtype = g.T_w_k.dtype
    Ti = g.T_w_k[g.e_i]
    Tj = g.T_w_k[g.e_j]
    e, Ji, Jj = jax.vmap(_edge_res_and_jac)(Ti, Tj, g.e_T)
    w = jnp.where(g.e_valid, g.e_info, 0.0)

    H = jnp.zeros((K, K, 6, 6), dtype)
    b = jnp.zeros((K, 6), dtype)
    H = H.at[g.e_i, g.e_i].add(jnp.einsum("n,nij,nik->njk", w, Ji, Ji))
    H = H.at[g.e_j, g.e_j].add(jnp.einsum("n,nij,nik->njk", w, Jj, Jj))
    H = H.at[g.e_i, g.e_j].add(jnp.einsum("n,nij,nik->njk", w, Ji, Jj))
    H = H.at[g.e_j, g.e_i].add(jnp.einsum("n,nij,nik->njk", w, Jj, Ji))
    b = b.at[g.e_i].add(jnp.einsum("n,nij,ni->nj", w, Ji, e))
    b = b.at[g.e_j].add(jnp.einsum("n,nij,ni->nj", w, Jj, e))
    cost = jnp.sum(w * jnp.sum(e * e, axis=-1))
    return H, b, cost


def optimize(g: PoseGraph, iters: int = 10, damping: float = 1e-6) -> PoseGraph:
    """Gauss-Newton with gauge handling: fixed/invalid poses get identity
    rows, zero rhs.  Traced at full f32 matmul precision: reduced-
    precision passes corrupt Hessian-level algebra (same rationale as
    the BA solver entries)."""
    return full_f32_matmuls(_optimize)(g, iters, damping)


def _optimize(g: PoseGraph, iters: int, damping: float) -> PoseGraph:
    K = g.T_w_k.shape[0]
    dtype = g.T_w_k.dtype
    free = (g.valid & ~g.fixed).astype(dtype)

    def body(g, _):
        H, b, _ = build_system(g)
        I6 = jnp.eye(6, dtype=dtype)
        Hm = H * free[:, None, None, None] * free[None, :, None, None]
        Hm = Hm.at[jnp.arange(K), jnp.arange(K)].add(
            I6 * (1.0 - free)[:, None, None])
        Hm = Hm.at[jnp.arange(K), jnp.arange(K)].add(damping * I6)
        rhs = b * free[:, None]
        Hmat = Hm.transpose(0, 2, 1, 3).reshape(6 * K, 6 * K)
        delta = linalg.solve_spd(Hmat, rhs.reshape(-1)).reshape(K, 6)
        delta = jnp.where(jnp.all(jnp.isfinite(delta)), delta, jnp.zeros_like(delta))
        T_new = jax.vmap(lambda T, d: T @ lie.exp_se3(-d))(g.T_w_k, delta)
        return g._replace(T_w_k=T_new), None

    g, _ = jax.lax.scan(body, g, None, length=iters)
    return g


def correct_landmarks(T_old: jax.Array, T_new: jax.Array,
                      owner_kf: jax.Array, points: jax.Array):
    """Rigidly drag landmarks with their owner keyframe's pose correction
    (mapHandler.cpp:5219-5287): X' = T_new (T_old^-1 X)."""
    rel = jax.vmap(lambda a, b: a @ lie.inv_se3(b))(T_new, T_old)
    return jax.vmap(lie.transform_point)(rel[owner_kf], points)


def correct_plucker_landmarks(T_old, T_new, owner_kf, lines):
    from ..core.plucker import transform_plucker

    rel = jax.vmap(lambda a, b: a @ lie.inv_se3(b))(T_new, T_old)
    return jax.vmap(transform_plucker)(rel[owner_kf], lines)
