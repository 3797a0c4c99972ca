"""Sequence-block (kf-axis) sharded global bundle adjustment — EXACT.

The second distribution axis named by SURVEY.md §2.4/§5 and BASELINE
config 5: the landmark set of the whole map is partitioned into
landmark-disjoint chunks grouped by the keyframe-block that anchors them
(the block holding most of their observations — pure locality, so a
device's observations mostly reference its own trajectory segment), and
the chunks are sharded across the mesh.  Every chunk carries ALL
observations of its landmarks against the replicated global pose table,
so per LM iteration each device's Schur partials (additive over
observations, backend/ba.py schur_partials) psum-combine into the SAME
reduced camera system the single-chip chunked GBA assembles
(mapHandler.cpp:3022-3126 behavioral spec); the pose solve is replicated,
landmark back-substitution stays shard-local, and the LM accept/reject
runs on the psum'd global cost.  The distributed solve is therefore
algebraically identical to ``MapHandler.global_bundle_adjustment`` — no
consensus rounds, no block-Gauss-Seidel approximation — while wall-clock
scales with the largest shard and the only collectives are one
(K,K,6,6)+(K,6) psum per LM iteration.

Both line parameterizations: Pluecker lines are 4-DoF orth rows of the
chunk's line table; endpoint lines (the reference's GBA
parameterization, mapHandler.cpp:3128-3731) ride the chunk's point table
as endpoint pairs, exactly as in the single-chip assembly.
"""

from __future__ import annotations

from typing import NamedTuple

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import logging

from ..backend import ba as ba_mod
from ..core.camera import StereoCamera

log = logging.getLogger("plslam_tpu.dist_gba")

AXIS = "kf"

class BlockedGBA(NamedTuple):
    """Host-assembled inputs: chunk problems stacked on a leading axis
    (n_chunks = n_blocks * chunks_per_device), pose leaves unstacked."""

    prob: ba_mod.BAProblem          # chunk leaves (n_chunks, ...), poses flat
    metas: list                     # per-chunk _assemble_problem meta dicts
    kf_ids: list                    # pose slot s <-> keyframe kf_ids[s]
    block_kfs: list                 # per-device keyframe id lists (locality)
    pt_ids_glob: np.ndarray         # (Ng,) map row of each global point slot
    ls_ids_glob: np.ndarray         # (Lg,)
    pt_gid: np.ndarray              # (n_chunks, cap_pts) global slot (-1 pad);
    #                                 endpoint mode: endpoint rows get
    #                                 Ng + 2*line(+1)
    own_pt: np.ndarray              # (n_chunks, cap_pts) slot is optimized here
    ls_gid: np.ndarray              # (n_chunks, cap_ls)
    own_ls: np.ndarray              # (n_chunks, cap_ls)
    plucker: bool                   # line parameterization of the chunks


def partition_map(mapper, n_blocks: int) -> BlockedGBA:
    """Split the map's landmarks into landmark-disjoint, owner-block-sorted
    chunks (n_blocks devices x C chunks each) and assemble one padded
    BAProblem per chunk over ALL active keyframes.  Each landmark appears
    in exactly one chunk together with every one of its observations, so
    chunked Schur accumulation over the shards is exact."""
    from ..backend.mapping import _orth_from_plucker_meta, _pad_bucket

    mp = mapper.map
    cfg = mapper.cfg
    plucker = cfg.plucker_lines
    kf_ids = [k.id for k in mp.keyframes if k.active]
    blocks = np.array_split(np.asarray(kf_ids), n_blocks)
    block_of_kf = np.zeros(len(mp.keyframes), np.int64)
    for b, ids in enumerate(blocks):
        block_of_kf[ids] = b

    allmask = np.zeros(len(mp.keyframes), bool)
    allmask[kf_ids] = True
    pt_ids, ls_ids = mapper._ba_landmark_ids(allmask)
    Ng = len(pt_ids)
    g_of_pt = np.full(mp.n_pt, -1, np.int64)
    g_of_pt[pt_ids] = np.arange(Ng)
    g_of_ls = np.full(mp.n_ls, -1, np.int64)
    g_of_ls[ls_ids] = np.arange(len(ls_ids))

    # owner block = argmax of per-block observation counts.  This is ONLY
    # a sort key for locality (a device's chunk references mostly its own
    # trajectory block); correctness never depends on it because every
    # chunk carries all of its landmarks' observations.
    def owner(tb, n_lm, ids):
        sel = tb.valid[: tb.n] & allmask[tb.kf[: tb.n]]
        cnt = np.zeros((n_lm, n_blocks), np.int64)
        np.add.at(cnt, (tb.lm[: tb.n][sel],
                        block_of_kf[tb.kf[: tb.n][sel]]), 1)
        return cnt[ids].argmax(axis=1) if len(ids) else np.zeros(0, np.int64)

    pt_sorted = pt_ids[np.argsort(owner(mp.pobs, mp.n_pt, pt_ids),
                                  kind="stable")]
    ls_sorted = ls_ids[np.argsort(owner(mp.lobs, mp.n_ls, ls_ids),
                                  kind="stable")]

    # the same per-chunk capacity invariant the single-chip GBA uses
    cap_p, cap_l, cap_p_eff, cap_l_eff = mapper._gba_chunk_caps()
    # chunks per device: smallest C such that every chunk fits the caps
    C = max(1,
            -(-Ng // (n_blocks * cap_p_eff)),
            -(-len(ls_ids) // (n_blocks * cap_l_eff)))
    n_chunks = n_blocks * C
    pt_chunks = np.array_split(pt_sorted, n_chunks)
    ls_chunks = np.array_split(ls_sorted, n_chunks)
    cap_k = _pad_bucket(len(kf_ids), lo=8)

    probs, metas = [], []
    gids_p, owns_p, gids_l, owns_l = [], [], [], []
    for pc, lc in zip(pt_chunks, ls_chunks):
        prob, meta = mapper._assemble_problem(
            kf_ids, pc, lc, cap_p, cap_l, cfg.ba_pobs, cfg.ba_lobs,
            fix_rule="kf0", cap_k=cap_k)
        # host-side Pluecker -> orth (global_bundle_adjustment parity)
        prob = _orth_from_plucker_meta(prob, meta)
        gp = np.full(cap_p, -1, np.int64)
        gp[: len(pc)] = g_of_pt[pc]
        op = np.zeros(cap_p, bool)
        op[: len(pc)] = True
        gl = np.full(cap_l, -1, np.int64)
        ol = np.zeros(cap_l, bool)
        if plucker:
            gl[: len(lc)] = g_of_ls[lc]
            ol[: len(lc)] = True
        elif len(lc):
            # endpoint rows of the point table, owned with their line
            ep_base = meta["ep_base"]
            sl = np.arange(len(lc))
            gsl = g_of_ls[lc]
            for off in (0, 1):
                rows = ep_base + 2 * sl + off
                gp[rows] = Ng + 2 * gsl + off
                op[rows] = True
        probs.append(prob)
        metas.append(meta)
        gids_p.append(gp)
        owns_p.append(op)
        gids_l.append(gl)
        owns_l.append(ol)

    stacked = jax.tree.map(lambda *xs: np.stack(xs), *probs)
    stacked = stacked._replace(
        T_c_w=probs[0].T_c_w, pose_fixed=probs[0].pose_fixed,
        pose_valid=probs[0].pose_valid)
    log.info("kf-block GBA: %d KFs, %d points + %d lines in %d chunks "
             "(%d devices x %d)", len(kf_ids), Ng, len(ls_ids), n_chunks,
             n_blocks, C)
    return BlockedGBA(
        prob=stacked, metas=metas, kf_ids=kf_ids,
        block_kfs=[list(ids) for ids in blocks],
        pt_ids_glob=pt_ids, ls_ids_glob=ls_ids,
        pt_gid=np.stack(gids_p), own_pt=np.stack(owns_p),
        ls_gid=np.stack(gids_l), own_ls=np.stack(owns_l),
        plucker=plucker)


def _problem_specs(endpoint_lines: bool, axis: str = AXIS) -> ba_mod.BAProblem:
    """Per-leaf PartitionSpecs (pose leaves replicated, chunk leaves
    sharded) — one definition shared with the landmark-sharded BA."""
    from .dist_ba import problem_specs

    return problem_specs(axis, endpoint_lines)


def make_kf_block_gba(mesh: Mesh, cam: StereoCamera,
                      cfg: ba_mod.BAConfig,
                      endpoint_lines: bool = False, axis: str = AXIS):
    """Jitted shard_map program: the chunked two-round Schur GBA
    (backend/ba.py bundle_adjust_chunked) with its chunk axis sharded over
    the mesh axis ``axis`` and the reduced camera system / LM costs
    psum-combined — algebraically identical to the single-chip solve."""
    pspec = _problem_specs(endpoint_lines, axis)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(pspec,),
        out_specs=(P(), P(axis), P(axis), P(axis), P(axis), P(axis)),
        check_vma=False)
    def run(prob: ba_mod.BAProblem):
        res = ba_mod.bundle_adjust_chunked(prob, cam, cfg, axis_name=axis)
        return (res.problem.T_c_w, res.problem.points,
                res.problem.lines_orth, res.problem.lines_scale,
                res.p_active, res.l_active)

    return jax.jit(run)


def distributed_global_bundle_adjustment(mapper, mesh: Mesh,
                                         rounds: int = 2):
    """Run the kf-block sharded GBA on a mesh and write results back into
    the map (poses, points, lines) — same write-back path as the
    single-chip ``global_bundle_adjustment`` (including chi^2-gated
    observation pruning).  ``rounds`` is accepted for API compatibility
    but unused: the sharded solve is exact, not an iterated consensus.
    ``mesh`` is one-dimensional; chunks shard over its axis.

    Locking matches the @_locked single-chip path: any deferred local-BA
    result is applied FIRST (or its stale write-back would later land on
    top of the GBA correction), and the partition + write-back hold the
    mapper's map lock against the mapping/loop-closure workers."""
    del rounds
    (axis,) = mesh.axis_names
    n_blocks = mesh.devices.size
    mapper.flush_ba()
    with mapper._map_lock:
        blk = partition_map(mapper, n_blocks)
        run = make_kf_block_gba(mesh, mapper.cam, mapper.ba_cfg,
                                endpoint_lines=not blk.plucker, axis=axis)

        specs = _problem_specs(not blk.plucker, axis)

        def put(x, spec):
            return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))

        prob_dev = jax.tree.map(put, blk.prob, specs)
        (T_c_w, points, orth, scale, p_active, l_active) = jax.device_get(
            run(prob_dev))

        jump = mapper._pose_jump(blk.kf_ids, T_c_w)
        if mapper.cfg.gba_max_jump > 0 and (
                not np.isfinite(jump) or jump > mapper.cfg.gba_max_jump):
            log.warning("kf-block GBA discarded: max pose jump %.2f m "
                        "exceeds gba_max_jump=%.2f (solver divergence "
                        "guard)", jump, mapper.cfg.gba_max_jump)
            return blk

        mp = mapper.map
        for s, kfid in enumerate(blk.kf_ids):
            mp.keyframes[kfid].T_w_k = np.linalg.inv(
                np.asarray(T_c_w[s], np.float64))
        for c, meta in enumerate(blk.metas):
            mapper._write_back_landmarks(
                points[c], orth[c], scale[c], p_active[c], l_active[c],
                meta)
    return blk
