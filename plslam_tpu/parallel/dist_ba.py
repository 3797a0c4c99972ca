"""Distributed Schur-complement bundle adjustment over a device mesh.

The reference has no distributed story (threads only, SURVEY.md §2.4); this
is the scaling design mandated by BASELINE.json: landmarks and their
observations are sharded across devices along the "lm" mesh axis, each
device assembles its partial camera-Hessian and Schur-correction blocks,
and the small reduced camera system is combined with ``psum`` and
solved replicated; landmark back-substitution stays local to each shard.

Implementation: ``shard_map`` over a 1-axis mesh.  The per-shard math
reuses backend/ba.py's residual/Jacobian kernels on a shard-local
BAProblem view (global pose array, local landmark slices).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..backend import ba as ba_mod
from ..core import lie
from ..core.camera import StereoCamera
from ..core.plucker import orth_plus

AXIS = "lm"


def _local_assemble(prob: ba_mod.BAProblem, cam: StereoCamera,
                    cfg: ba_mod.BAConfig, lam, p_active, l_active):
    """Shard-local assembly + Schur partials.  Runs inside shard_map: prob
    holds the full (replicated) poses but only this shard's landmarks/obs.
    Returns partial (S, rhs) for psum plus local landmark terms."""
    a = ba_mod.assemble(prob, cam, cfg, p_active, l_active)
    K = a.Hcc.shape[0]
    dtype = a.Hcc.dtype
    Hpp_inv, _ = ba_mod._damped_inv(
        a.Hpp, lam, prob.point_valid, 3,
        ba_mod.point_block_floor(prob, cfg))
    Hll_inv, _ = ba_mod._damped_inv(a.Hll, lam, prob.line_valid, 4,
                                    cfg.tikhonov)

    # precision HIGHEST: reduced-precision matmul passes wreck Hessian-level accuracy
    # (see ba.schur_partials)
    hi = jax.lax.Precision.HIGHEST
    S_partial = jnp.zeros((K, K, 6, 6), dtype)
    S_partial = S_partial - jnp.einsum("kpab,pbc,qpdc->kqad", a.Wp,
                                       Hpp_inv, a.Wp, precision=hi)
    S_partial = S_partial - jnp.einsum("klab,lbc,qldc->kqad", a.Wl,
                                       Hll_inv, a.Wl, precision=hi)
    rhs_partial = a.bc - jnp.einsum("kpab,pbc,pc->ka", a.Wp, Hpp_inv,
                                    a.bp, precision=hi)
    rhs_partial = rhs_partial - jnp.einsum("klab,lbc,lc->ka", a.Wl,
                                           Hll_inv, a.bl, precision=hi)
    return a, Hpp_inv, Hll_inv, S_partial, rhs_partial


def _dist_lm_iteration(prob, cam, cfg, lam, p_active, l_active):
    """One distributed LM iteration (runs under shard_map); the reduced
    system is psum'd over the landmark axis."""
    a, Hpp_inv, Hll_inv, S_partial, rhs_partial = _local_assemble(
        prob, cam, cfg, lam, p_active, l_active)
    # combine partial camera blocks across shards, then the SAME
    # damped/refined reduced solve as the single-device path
    Hcc = jax.lax.psum(a.Hcc, AXIS)
    S_off = jax.lax.psum(S_partial, AXIS)
    rhs = jax.lax.psum(rhs_partial, AXIS)
    free = prob.pose_valid & ~prob.pose_fixed
    dpose = ba_mod.solve_reduced(Hcc, S_off, rhs, lam, free)

    # local landmark back-substitution (precision: see above)
    hi = jax.lax.Precision.HIGHEST
    tp = a.bp - jnp.einsum("kpab,ka->pb", a.Wp, dpose, precision=hi)
    dpoint = jnp.einsum("pbc,pc->pb", Hpp_inv, tp, precision=hi)
    tl = a.bl - jnp.einsum("klab,ka->lb", a.Wl, dpose, precision=hi)
    dline = jnp.einsum("lbc,lc->lb", Hll_inv, tl, precision=hi)
    return dpose, dpoint, dline


def _dist_cost(prob, cam, cfg, p_active, l_active):
    """Cauchy cost, matching assemble()'s IRLS weights (the LM
    accept/reject test must use the same objective the step minimized)."""
    e_p, _, _ = ba_mod.point_obs_residuals(prob, cam)
    e_l, _, _ = ba_mod.line_obs_residuals(prob, cam)
    c = jnp.sum(jnp.where(p_active,
                          ba_mod.cauchy_cost(e_p) * prob.p_sigma2, 0.0))
    c = c + jnp.sum(jnp.where(l_active,
                              ba_mod.cauchy_cost(e_l) * prob.l_sigma2, 0.0))
    return jax.lax.psum(c, AXIS)


_POSE_FIELDS = ("T_c_w", "pose_fixed", "pose_valid")


def problem_specs(axis: str = AXIS,
                  endpoint_lines: bool = False) -> ba_mod.BAProblem:
    """Per-leaf PartitionSpecs: pose leaves replicated, every landmark/obs
    leaf sharded along ``axis``.  ``endpoint_lines`` must mirror the problem's layout: the
    optional p_lo/p_is_line leaves exist only in endpoint mode and must be
    None (not a spec leaf) otherwise, or tree mapping over (problem,
    specs) fails with a structure mismatch."""
    none_fields = () if endpoint_lines else ("p_lo", "p_is_line")
    return ba_mod.BAProblem(**{
        f: (None if f in none_fields else
            (P() if f in _POSE_FIELDS else P(axis)))
        for f in ba_mod.BAProblem._fields})


def make_dist_bundle_adjust(mesh: Mesh, cam: StereoCamera,
                            cfg: ba_mod.BAConfig, iters: int = 10,
                            endpoint_lines: bool = False):
    """Build the jitted shard_map BA step for a given mesh.

    The returned function takes a BAProblem whose landmark/observation
    arrays are sharded along their leading axis (use
    ``shard_problem(mesh, prob)``) and runs ``iters`` accepted/rejected LM
    iterations of the distributed Schur solve over a mesh with the "lm"
    axis (``parallel.mesh.make_mesh``); ``endpoint_lines`` selects the endpoint-parameterized problem layout
    (p_lo/p_is_line present).
    """

    # replicated leaves: poses + validity; sharded leaves: landmarks + obs
    pspec = problem_specs(AXIS, endpoint_lines)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(pspec,),
        out_specs=(pspec, P()), check_vma=False)
    @ba_mod._f32_matmuls
    def run(prob: ba_mod.BAProblem):
        p_active = prob.p_valid
        l_active = prob.l_valid
        lam0 = jnp.asarray(cfg.lambda_init, prob.points.dtype)
        cost0 = _dist_cost(prob, cam, cfg, p_active, l_active)

        def body(carry, _):
            prob, lam, cost = carry
            dpose, dpoint, dline = _dist_lm_iteration(
                prob, cam, cfg, lam, p_active, l_active)
            T_new = jax.vmap(lambda d, T: lie.exp_se3(-d) @ T)(dpose, prob.T_c_w)
            cand = prob._replace(
                T_c_w=T_new,
                points=prob.points - dpoint,
                lines_orth=jax.vmap(orth_plus)(prob.lines_orth, -dline))
            new_cost = _dist_cost(cand, cam, cfg, p_active, l_active)
            ok = (new_cost < cost) & jnp.isfinite(new_cost)
            prob = jax.tree.map(
                lambda new, old: jnp.where(
                    jnp.reshape(ok, (1,) * new.ndim), new, old), cand, prob)
            lam = jnp.clip(jnp.where(ok, lam / cfg.lambda_factor,
                                     lam * cfg.lambda_factor), 1e-9, 1e6)
            cost = jnp.where(ok, new_cost, cost)
            return (prob, lam, cost), None

        (prob, _, cost), _ = jax.lax.scan(
            body, (prob, lam0, cost0), None, length=iters)
        return prob, cost

    return jax.jit(run)


def shard_problem(mesh: Mesh, prob: ba_mod.BAProblem) -> ba_mod.BAProblem:
    """Device_put each leaf with its distributed sharding (the endpoint
    layout is inferred from the problem).  Landmark slot indices
    (p_lm / l_lm) must already be *shard-local* (host assembly groups
    observations by landmark shard)."""
    specs = problem_specs(AXIS, endpoint_lines=prob.p_lo is not None)

    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(put, prob, specs)
