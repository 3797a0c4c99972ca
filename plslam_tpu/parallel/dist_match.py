"""Distributed feature matching and pose-graph optimization.

SURVEY.md §5/§2.4 distribution inventory:
- matching sharded by descriptor blocks: query descriptors split along the
  mesh axis, database replicated; each device computes its block of the
  Hamming matrix and local row-best candidates; the mutual check needs the
  column-best over ALL query rows, obtained with a psum-min reduction over
  the (value, index)-packed column scores.
- pose-graph optimization for long concatenated sequences: edges sharded
  across devices, per-edge Jacobian blocks psum-reduced into the global
  normal equations, replicated solve.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..backend import pgo as pgo_mod
from ..core import linalg
from ..core.numerics import full_f32_matmuls
from ..ops.descriptors import hamming_distance_matrix
from ..ops.matching import BIG

AXIS = "lm"


def make_dist_matcher(mesh: Mesh, nnr: float = 0.9):
    """Sharded mutual-NNR matcher.

    query desc/valid sharded along rows; database replicated.  Returns the
    same (idx, dist) contract as ops.matching.match_mutual_nnr.
    """

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(), P()),
        out_specs=(P(AXIS), P(AXIS)), check_vma=False)
    def run(desc_q, valid_q, desc_db, valid_db):
        n_local = desc_q.shape[0]
        dist = hamming_distance_matrix(desc_q, desc_db)
        mask = valid_q[:, None] & valid_db[None, :]
        d = jnp.where(mask, dist, BIG)
        # local row best / second-best
        best = jnp.min(d, axis=1)
        arg = jnp.argmin(d, axis=1).astype(jnp.int32)
        cols = jnp.arange(d.shape[1], dtype=jnp.int32)
        d2 = jnp.where(cols[None, :] == arg[:, None], BIG, d)
        second = jnp.min(d2, axis=1)
        ok = (best < BIG) & (best.astype(jnp.float32)
                             < nnr * second.astype(jnp.float32))
        # global column-best via packed (value, global_row) min-reduction
        shard = jax.lax.axis_index(AXIS)
        row_global = shard * n_local + jnp.arange(n_local, dtype=jnp.int32)
        packed = d.astype(jnp.int64) * (1 << 20) + row_global[:, None]
        col_best_local = jnp.min(packed, axis=0)
        col_best = jax.lax.pmin(col_best_local, AXIS)
        col_arg = (col_best % (1 << 20)).astype(jnp.int32)
        mutual = col_arg[arg] == row_global
        ok = ok & mutual
        idx = jnp.where(ok, arg, -1)
        return idx, jnp.where(ok, best, BIG)

    return jax.jit(run)


def make_dist_pgo(mesh: Mesh, iters: int = 10, damping: float = 1e-6):
    """Edge-sharded pose-graph Gauss-Newton.

    PoseGraph edge arrays sharded along the mesh axis (pad the edge count
    to a multiple of the device count, padding rows e_valid=False); poses
    replicated.  Returns the optimized PoseGraph (poses replicated).
    """

    espec = pgo_mod.PoseGraph(
        T_w_k=P(), fixed=P(), valid=P(),
        e_i=P(AXIS), e_j=P(AXIS), e_T=P(AXIS), e_info=P(AXIS),
        e_valid=P(AXIS))

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(espec,), out_specs=espec,
        check_vma=False)
    def run(g: pgo_mod.PoseGraph):
        K = g.T_w_k.shape[0]
        dtype = g.T_w_k.dtype
        free = (g.valid & ~g.fixed).astype(dtype)

        def body(g, _):
            H_part, b_part, _ = pgo_mod.build_system(g)
            H = jax.lax.psum(H_part, AXIS)
            b = jax.lax.psum(b_part, AXIS)
            I6 = jnp.eye(6, dtype=dtype)
            Hm = H * free[:, None, None, None] * free[None, :, None, None]
            Hm = Hm.at[jnp.arange(K), jnp.arange(K)].add(
                I6 * (1.0 - free)[:, None, None] + damping * I6)
            rhs = b * free[:, None]
            Hmat = Hm.transpose(0, 2, 1, 3).reshape(6 * K, 6 * K)
            delta = linalg.solve_spd(Hmat, rhs.reshape(-1)).reshape(K, 6)
            delta = jnp.where(jnp.all(jnp.isfinite(delta)), delta,
                              jnp.zeros_like(delta))
            from ..core import lie

            T_new = jax.vmap(lambda T, d: T @ lie.exp_se3(-d))(g.T_w_k, delta)
            return g._replace(T_w_k=T_new), None

        g, _ = jax.lax.scan(body, g, None, length=iters)
        return g

    # full f32 matmuls, like pgo.optimize: the edge Hessian blocks feed
    # the solve
    return jax.jit(full_f32_matmuls(run))


def shard_posegraph(mesh: Mesh, g: pgo_mod.PoseGraph) -> pgo_mod.PoseGraph:
    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    return pgo_mod.PoseGraph(
        T_w_k=put(g.T_w_k, P()), fixed=put(g.fixed, P()),
        valid=put(g.valid, P()),
        e_i=put(g.e_i, P(AXIS)), e_j=put(g.e_j, P(AXIS)),
        e_T=put(g.e_T, P(AXIS)), e_info=put(g.e_info, P(AXIS)),
        e_valid=put(g.e_valid, P(AXIS)))
