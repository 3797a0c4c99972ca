"""Frame-to-frame pose tracking: batched robust Gauss-Newton.

Behavioral spec: reference ``src2/stereoFrameHandler.cpp`` —
optimizePose (:307), gaussNewtonOptimizationforPluker (:803),
optimizeFunctionsUsingPluker (:564), optimizeFunctionsRobust (:1010),
removeOutliers (:1303), isGoodSolution (:292), needNewKF (:1465),
f2fLineSegmentOverlap (:186).

The reference accumulates per-feature 6x6 outer products in a scalar loop;
here residuals and Jacobians for all features are computed as one batched
program and reduced with einsum — H = sum_i w_i J_i J_i^T is a single
(N,6)x(N,6) contraction.

Update convention: delta solves H delta = g with g = sum w_i J_i r_i, and
the pose update is DT <- exp(-delta) @ DT (left-multiplicative, equivalent
to the reference's ``DT = inverse(exp(inc)) * DT`` at :831 after the sign
of J is fixed to the exact derivative; verified against jax.grad in tests).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import lie, linalg, robust
from ..core.camera import StereoCamera
from ..core.plucker import transform_plucker
from .features import TrackedLines, TrackedPoints

HOMOG_TH = 1e-7  # Config::homogTh (config.cpp:84)


class TrackerConfig(NamedTuple):
    """Optimizer tunables (defaults = reference config.cpp:36-113)."""

    max_iters: int = 5
    max_iters_ref: int = 10
    min_error: float = 1e-7
    min_error_change: float = 1e-7
    inlier_k: float = 4.0
    min_features: int = 10
    use_lines: bool = True
    use_points: bool = True
    plucker_lines: bool = True  # USE_LINE_PLUKER mode
    min_entropy_ratio: float = 0.85
    max_kf_t_dist: float = 5.0
    max_kf_r_dist: float = 15.0
    # Line-outlier hardening beyond the reference (its MAD-only rejection
    # has a 50% breakdown point, fatal at the handful of line matches a
    # low-texture frame yields): defer lines to the refinement round while
    # points are plentiful, and absolutely gate line residuals at the
    # round-1 pose.
    defer_lines_min_pts: int = 30
    line_abs_gate: float = 3.0
    # Run the GN loop as a lax.while_loop with the reference's stopping
    # rules as the loop condition (True, default) instead of a fixed-length
    # masked scan.  Results are identical — converged scan iterations were
    # already no-ops — but the while form skips their device time: GN
    # typically converges in 3-6 evaluations, not the 5+10 budget.
    early_exit: bool = True


# ---------------------------------------------------------------------------
# Residuals and Jacobians
# ---------------------------------------------------------------------------


def point_residuals(DT: jax.Array, pts: TrackedPoints, cam: StereoCamera):
    """Scalar reprojection residual r_i = ||proj(DT P_i) - obs_i|| and its
    6-vec Jacobian wrt the left-multiplicative twist (spec:
    stereoFrameHandler.cpp:654-698)."""
    P_ = lie.transform_point(DT, pts.P)
    proj = cam.project(P_)
    e = proj - pts.obs  # (N, 2)
    r = jnp.linalg.norm(e, axis=-1)
    x, y, z = P_[..., 0], P_[..., 1], P_[..., 2]
    z2 = jnp.maximum(z * z, HOMOG_TH)
    fxz = cam.fx / jnp.maximum(z, HOMOG_TH)
    fyz = cam.fy / jnp.maximum(z, HOMOG_TH)
    # Closed-form J = [c | P' x c] with c = (e^T Jproj) / r: the chain
    # e^T Jproj [I | -skew(P')] collapses because row a . (-skew(P)) =
    # P x a — pure elementwise ops, no (N,2,3)x(N,3,6) batched matmuls
    # (the GN loop is latency-bound on tiny-op count)
    rs = jnp.maximum(r, HOMOG_TH)
    c = jnp.stack(
        [e[..., 0] * fxz / rs,
         e[..., 1] * fyz / rs,
         -(e[..., 0] * cam.fx * x + e[..., 1] * cam.fy * y) / z2 / rs],
        axis=-1)  # (N, 3)
    J = jnp.concatenate([c, jnp.cross(P_, c)], axis=-1)
    return r, J


def line_residuals_plucker(DT: jax.Array, ls: TrackedLines, cam: StereoCamera):
    """Pluecker-mode line residual (stereoFrameHandler.cpp:702-785):
    r = sqrt(e0^2 + e1^2) with e_i the signed distance of observed endpoint i
    to the projected infinite line l = K_L n_c."""
    Lc = transform_plucker(DT, ls.NDc)  # (N, 6)
    n_c, d_c = Lc[..., :3], Lc[..., 3:]
    l = jnp.einsum("ij,nj->ni", cam.plucker_K, n_c)  # (N, 3)
    lx, ly, lz = l[..., 0], l[..., 1], l[..., 2]
    fm = 1.0 / jnp.sqrt(jnp.maximum(lx * lx + ly * ly, HOMOG_TH))
    e0 = (ls.sobs[..., 0] * lx + ls.sobs[..., 1] * ly + lz) * fm
    e1 = (ls.eobs[..., 0] * lx + ls.eobs[..., 1] * ly + lz) * fm
    r = jnp.sqrt(e0 * e0 + e1 * e1)
    # d e_i / d l  (chain rule of the normalized point-line distance)
    a0, b0 = ls.sobs[..., 0], ls.sobs[..., 1]
    a1, b1 = ls.eobs[..., 0], ls.eobs[..., 1]
    de0 = jnp.stack([a0 * fm - lx * e0 * fm * fm,
                     b0 * fm - ly * e0 * fm * fm, fm], axis=-1)
    de1 = jnp.stack([a1 * fm - lx * e1 * fm * fm,
                     b1 * fm - ly * e1 * fm * fm, fm], axis=-1)
    # Closed form: de^T K_L [-skew(d_c) | -skew(n_c)] = [d_c x u | n_c x u]
    # with u = K_L^T de (row a . (-skew(v)) = v x a) — replaces the
    # (3,3)x(N,3,6) einsum chain with elementwise crosses
    rs = jnp.maximum(r, HOMOG_TH)
    de = (de0 * e0[..., None] + de1 * e1[..., None]) / rs[..., None]
    u = jnp.einsum("ji,nj->ni", cam.plucker_K, de)  # K_L^T de  (N, 3)
    J = jnp.concatenate([jnp.cross(d_c, u), jnp.cross(n_c, u)], axis=-1)
    return r, J, e0, e1


def line_residuals_endpoint(DT: jax.Array, ls: TrackedLines, cam: StereoCamera):
    """Endpoint-mode line residual (stereoFrameHandler.cpp:1196-1277):
    e_i = l_obs . [proj(DT P_i); 1] for the two 3D endpoints."""
    sP_ = lie.transform_point(DT, ls.sP)
    eP_ = lie.transform_point(DT, ls.eP)
    sp = cam.project(sP_)
    ep = cam.project(eP_)
    lo = ls.le_obs
    e0 = lo[..., 0] * sp[..., 0] + lo[..., 1] * sp[..., 1] + lo[..., 2]
    e1 = lo[..., 0] * ep[..., 0] + lo[..., 1] * ep[..., 1] + lo[..., 2]
    r = jnp.sqrt(e0 * e0 + e1 * e1)

    def endpoint_J(P_):
        # closed form lxy^T Jproj [I | -skew(P')] = [a | P' x a] with
        # a = lxy^T Jproj (see point_residuals)
        x, y, z = P_[..., 0], P_[..., 1], P_[..., 2]
        z2 = jnp.maximum(z * z, HOMOG_TH)
        zs = jnp.maximum(z, HOMOG_TH)
        a = jnp.stack(
            [lo[..., 0] * cam.fx / zs,
             lo[..., 1] * cam.fy / zs,
             -(lo[..., 0] * cam.fx * x + lo[..., 1] * cam.fy * y) / z2],
            axis=-1)  # (N, 3)
        return jnp.concatenate([a, jnp.cross(P_, a)], axis=-1)  # (N, 6)

    Js = endpoint_J(sP_)
    Je = endpoint_J(eP_)
    J = (Js * e0[..., None] + Je * e1[..., None]) / jnp.maximum(r, HOMOG_TH)[..., None]
    return r, J, sp, ep


def f2f_line_overlap(sp_obs, ep_obs, sp_proj, ep_proj):
    """Overlap in [0,1] of the projected segment with the observed one
    (stereoFrameHandler.cpp f2fLineSegmentOverlap :186-300).  The reference's
    three branches are all orthogonal projection onto the observed line; the
    general formula covers them."""
    l = ep_obs - sp_obs  # (N, 2)
    denom = jnp.maximum(jnp.sum(l * l, axis=-1), 1e-12)
    lam_s = jnp.sum((sp_proj - sp_obs) * l, axis=-1) / denom
    lam_e = jnp.sum((ep_proj - sp_obs) * l, axis=-1) / denom
    lam_min = jnp.minimum(lam_s, lam_e)
    lam_max = jnp.maximum(lam_s, lam_e)
    return jnp.clip(jnp.minimum(lam_max, 1.0) - jnp.maximum(lam_min, 0.0), 0.0, 1.0)


# ---------------------------------------------------------------------------
# H, g assembly
# ---------------------------------------------------------------------------


def build_normal_equations(
    DT: jax.Array,
    pts: TrackedPoints,
    ls: TrackedLines,
    cam: StereoCamera,
    cfg: TrackerConfig,
):
    """One evaluation of (H, g, err) with MAD scaling + Cauchy weights +
    line overlap weights (optimizeFunctionsUsingPluker / Robust)."""
    dtype = DT.dtype
    H = jnp.zeros((6, 6), dtype)
    g = jnp.zeros((6,), dtype)
    e_sum = jnp.zeros((), dtype)
    n_sum = jnp.zeros((), dtype)

    if cfg.use_points:
        m_p = pts.valid & pts.inlier
        r_p, J_p = point_residuals(DT, pts, cam)
        # sanitize masked rows BEFORE they touch H/g: padded rows can carry
        # degenerate geometry (z=0 projections -> inf/NaN), and a zero
        # weight does not kill a NaN contribution (0*NaN = NaN)
        r_p = jnp.where(m_p, r_p, 0.0)
        J_p = jnp.where(m_p[..., None], J_p, 0.0)

    if cfg.use_lines:
        m_l = ls.valid & ls.inlier
        if cfg.plucker_lines:
            r_l, J_l, _, _ = line_residuals_plucker(DT, ls, cam)
            # the Pluecker branch scales the gradient residue by sqrt(sigma2)
            # (stereoFrameHandler.cpp:760 ``r = err_i_norm * sqrt(s2)``)
            r_g = r_l * jnp.sqrt(ls.sigma2)
        else:
            r_l, J_l, _, _ = line_residuals_endpoint(DT, ls, cam)
            r_g = r_l
        r_l = jnp.where(m_l, r_l, 0.0)
        r_g = jnp.where(m_l, r_g, 0.0)
        J_l = jnp.where(m_l[..., None], J_l, 0.0)

    # MAD scales: one batched (2, N) sort pair for both modalities instead
    # of four sequential sorts — this runs every GN iteration
    if cfg.use_points and cfg.use_lines:
        s_p, s_l = robust.clipped_mad_scale_pair(r_p, m_p, r_l, m_l)
    elif cfg.use_points:
        s_p = robust.clipped_mad_scale(r_p, m_p)
    elif cfg.use_lines:
        s_l = robust.clipped_mad_scale(r_l, m_l)

    # ONE augmented weighted Gram for H, g AND err: with per-row
    # a = [J | r_grad | r], G = sum_n w_n a_n a_n^T (8x8) gives
    # H = G[:6,:6], g = G[:6,6], e_sum = G[7,7].  This replaces six
    # small einsums/reductions with a single (8,N)x(N,8) contraction —
    # the GN loop is latency-bound on tiny-op count, not FLOPs.
    rows = []
    if not (cfg.use_points or cfg.use_lines):
        return H, g, jnp.zeros((), dtype)
    if cfg.use_points:
        w_p = robust.cauchy_weight(r_p / s_p)
        w_p = jnp.where(m_p, w_p, 0.0)
        rows.append((w_p, J_p, r_p, r_p, m_p))
    if cfg.use_lines:
        sp_proj = cam.project(lie.transform_point(DT, ls.sP))
        ep_proj = cam.project(lie.transform_point(DT, ls.eP))
        overlap = f2f_line_overlap(ls.sp, ls.ep, sp_proj, ep_proj)
        w_l = robust.cauchy_weight(r_l / s_l) * overlap
        w_l = jnp.where(m_l, w_l, 0.0)
        rows.append((w_l, J_l, r_g, r_l, m_l))

    w = jnp.concatenate([t[0] for t in rows])
    A = jnp.concatenate([
        jnp.concatenate([t[1], t[2][:, None], t[3][:, None]], axis=-1)
        for t in rows])                                   # (N, 8)
    G = jnp.einsum("n,ni,nj->ij", w, A, A)
    H = H + G[:6, :6]
    g = g + G[:6, 6]
    e_sum = e_sum + G[7, 7]
    n_sum = n_sum + sum(jnp.sum(t[4].astype(dtype)) for t in rows)

    err = e_sum / jnp.maximum(n_sum, 1.0)
    return H, g, err


# ---------------------------------------------------------------------------
# Gauss-Newton loop
# ---------------------------------------------------------------------------


class GNResult(NamedTuple):
    DT: jax.Array
    cov: jax.Array
    err: jax.Array
    good: jax.Array  # bool scalar


def gauss_newton(
    DT0: jax.Array,
    pts: TrackedPoints,
    ls: TrackedLines,
    cam: StereoCamera,
    cfg: TrackerConfig,
    max_iters: int,
) -> GNResult:
    """GN with the reference's stopping rules
    (gaussNewtonOptimizationforPluker :803-853).  Default form: a
    lax.while_loop whose condition IS the stopping rule (converges in 3-6
    evaluations typically).  cfg.early_exit=False keeps the equivalent
    fixed-length masked scan (converged iterations become no-ops) —
    bit-identical results, useful as an A/B and for exotic transforms."""

    dtype = DT0.dtype

    def body(carry, _):
        DT, err_prev, done, good = carry
        H, g, err = build_normal_equations(DT, pts, ls, cam, cfg)
        stop = (jnp.abs(err - err_prev) < cfg.min_error_change) | (err < cfg.min_error)
        # solve H delta = g; guard invalid systems (scan-Cholesky: no
        # LAPACK custom calls, works on any backend/dtype).  ONE
        # factorization serves both the solve and the SPD check — the
        # loop is latency-bound, and is_spd(H) runs the identical
        # Cholesky, so refactorizing doubled the chain for nothing.
        L = linalg.cholesky(H)
        delta = linalg.solve_triangular_upper(
            L.T, linalg.solve_triangular_lower(L, g))
        finite = jnp.all(jnp.isfinite(delta))
        ok = (finite & jnp.all(jnp.isfinite(L))
              & jnp.all(jnp.diagonal(L) > 0))
        new_good = good & (ok | stop)
        step = jnp.where(done | stop | ~ok, jnp.zeros_like(delta), delta)
        DT_new = lie.exp_se3(-step) @ DT
        small = jnp.linalg.norm(step) < cfg.min_error_change
        done_new = done | stop | ~ok | small
        return (DT_new, jnp.where(done, err_prev, err), done_new, new_good), None

    init = (DT0, jnp.asarray(9.9e8, dtype), jnp.asarray(False), jnp.asarray(True))
    if cfg.early_exit:
        i0 = jnp.asarray(0, jnp.int32)

        def w_cond(carry):
            i, (DT, err_prev, done, good) = carry
            return (i < max_iters) & ~done

        def w_body(carry):
            i, inner = carry
            new_inner, _ = body(inner, None)
            return (i + 1, new_inner)

        _, (DT, err, _, good) = jax.lax.while_loop(w_cond, w_body, (i0, init))
    else:
        (DT, err, _, good), _ = jax.lax.scan(body, init, None, length=max_iters)
    H, g, err_final = build_normal_equations(DT, pts, ls, cam, cfg)
    cov = linalg.solve_spd(H, jnp.eye(6, dtype=dtype))
    cov = jnp.where(good, cov, jnp.eye(6, dtype=dtype))
    return GNResult(DT=DT, cov=cov, err=jnp.where(good, err_final, -1.0), good=good)


def remove_outliers(
    DT: jax.Array,
    pts: TrackedPoints,
    ls: TrackedLines,
    cam: StereoCamera,
    cfg: TrackerConfig,
):
    """MAD-threshold outlier rejection (removeOutliers :1303-1463):
    residual_i * sqrt(sigma2_i), flag |r - mean| > inlier_k * mad_stdv."""
    if cfg.use_points:
        r_p, _ = point_residuals(DT, pts, cam)
        r_p = r_p * jnp.sqrt(pts.sigma2)
        m_p = pts.valid  # reference computes stats over all matched, :1320
        mean_p, stdv_p = robust.mean_stdv_mad(r_p, m_p)
        keep_p = jnp.abs(r_p - mean_p) <= cfg.inlier_k * stdv_p
        pts = pts._replace(inlier=pts.inlier & (keep_p | ~pts.valid))
    if cfg.use_lines:
        if cfg.plucker_lines:
            r_l, _, _, _ = line_residuals_plucker(DT, ls, cam)
        else:
            r_l, _, _, _ = line_residuals_endpoint(DT, ls, cam)
        r_l = r_l * jnp.sqrt(ls.sigma2)
        m_l = ls.valid
        mean_l, stdv_l = robust.mean_stdv_mad(r_l, m_l)
        keep_l = jnp.abs(r_l - mean_l) <= cfg.inlier_k * stdv_l
        # absolute gate: MAD breaks down at the small line counts of
        # low-texture frames (2 bad of 4 matched lines is a 50% outlier
        # fraction); a wrong match sits tens-to-hundreds of px off
        keep_l = keep_l & (jnp.abs(r_l) <= cfg.line_abs_gate)
        ls = ls._replace(inlier=ls.inlier & (keep_l | ~ls.valid))
    return pts, ls


def is_good_solution(DT: jax.Array, cov: jax.Array, err: jax.Array) -> jax.Array:
    """isGoodSolution (:292): cov eigenvalues in [0, 1], err in [0, 1],
    finite pose."""
    # Eigenvalue checks via Cholesky (PSD) + Gershgorin upper bound — the
    # reference uses exact eigvals (:292); Gershgorin is conservative but
    # the covariances in question are orders of magnitude below the 1.0
    # threshold, so the acceptance region is effectively identical.
    lo, hi = linalg.gershgorin_bounds(cov)
    psd = linalg.is_spd(cov + 1e-18 * jnp.eye(6, dtype=cov.dtype))
    return (
        psd
        & (hi <= 1.0)
        & (err >= 0.0)
        & (err <= 1.0)
        & jnp.all(jnp.isfinite(DT))
    )


class PoseEstimate(NamedTuple):
    DT: jax.Array        # frame-to-frame motion (prev <- curr convention
    #                      of the reference: x_curr = DT^-1 applied later)
    cov: jax.Array
    err: jax.Array
    n_inliers: jax.Array
    good: jax.Array


def optimize_pose(
    pts: TrackedPoints,
    ls: TrackedLines,
    cam: StereoCamera,
    cfg: TrackerConfig,
    DT_init: jax.Array | None = None,
) -> tuple[PoseEstimate, TrackedPoints, TrackedLines]:
    """Full two-stage solve (optimizePose :307-430): GN -> outlier removal
    -> refinement, with identity fallback when anything degenerates."""
    dtype = pts.P.dtype
    I4 = jnp.eye(4, dtype=dtype)
    DT0 = I4 if DT_init is None else DT_init

    n0 = (jnp.sum((pts.valid & pts.inlier).astype(jnp.int32))
          + jnp.sum((ls.valid & ls.inlier).astype(jnp.int32)))
    enough0 = n0 >= cfg.min_features

    # round 1: when points are plentiful they fix the pose alone — a wrong
    # line match among few lines would otherwise drag GN into its basin;
    # in line-dominant frames lines participate as in the reference
    n_pts0 = jnp.sum((pts.valid & pts.inlier).astype(jnp.int32))
    defer = cfg.use_points & (n_pts0 >= cfg.defer_lines_min_pts)
    ls_r1 = ls._replace(inlier=ls.inlier & ~defer)
    first = gauss_newton(DT0, pts, ls_r1, cam, cfg, cfg.max_iters)
    good1 = is_good_solution(first.DT, first.cov, first.err) & enough0

    pts2, ls2 = remove_outliers(first.DT, pts, ls, cam, cfg)
    # keep original masks if the first solve was bad
    pts2 = pts2._replace(inlier=jnp.where(good1, pts2.inlier, pts.inlier))
    ls2 = ls2._replace(inlier=jnp.where(good1, ls2.inlier, ls.inlier))

    n1 = (jnp.sum((pts2.valid & pts2.inlier).astype(jnp.int32))
          + jnp.sum((ls2.valid & ls2.inlier).astype(jnp.int32)))
    enough1 = n1 >= cfg.min_features

    # refine FROM the round-1 estimate (optimizePose :352 keeps DT), not
    # from scratch — restarting loses the basin round 1 found
    DT_ref0 = jnp.where(good1, first.DT, DT0)
    refined = gauss_newton(DT_ref0, pts2, ls2, cam, cfg, cfg.max_iters_ref)
    use_refined = good1 & enough1

    DT = jnp.where(use_refined, refined.DT, jnp.where(good1, first.DT, I4))
    cov = jnp.where(use_refined, refined.cov, jnp.where(good1, first.cov, jnp.zeros((6, 6), dtype)))
    err = jnp.where(use_refined, refined.err, jnp.where(good1, first.err, -1.0))

    final_good = is_good_solution(DT, cov, err) & enough0
    DT = jnp.where(final_good, DT, I4)
    cov = jnp.where(final_good, cov, jnp.zeros((6, 6), dtype))
    err = jnp.where(final_good, err, -1.0)

    est = PoseEstimate(DT=DT, cov=cov, err=err, n_inliers=n1, good=final_good)
    return est, pts2, ls2


def keyframe_entropy_ratio(cov_prev_accum: jax.Array, entropy_first: jax.Array):
    """Differential entropy of the accumulated pose covariance relative to
    the first frame after the last KF (needNewKF :1465-1516)."""
    L = linalg.cholesky(cov_prev_accum)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.abs(jnp.diagonal(L))))
    entropy = 3.0 * (1.0 + jnp.log(2.0 * jnp.pi)) + 0.5 * logdet
    return entropy / entropy_first, entropy
