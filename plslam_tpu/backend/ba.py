"""Bundle adjustment: batched Levenberg-Marquardt with explicit Schur
complement, replacing the reference's g2o solver and hand-rolled LM.

Behavioral spec: reference ``src/mapHandler.cpp`` —
localBundleAdjustmentForPlukerWithG2O (:5851-6323, the LBA actually used in
Pluecker mode), levMarquardtOptimizationLBA (:2334, endpoint mode), and the
edge math of ``g2o_types/g2o_types.h`` (EdgePosePoint :206, EdgePoseLine
:302).  The two-round schedule — optimize, deactivate chi^2 > 5.991 edges,
re-optimize (:6119-6152) — is kept.

Design:
- every observation's residual/Jacobian is computed in one batched program;
- per-landmark 3x3 / 4x4 Hessian blocks reduce with segment_sum;
- camera-landmark coupling W is materialized as a dense (K, L, 6, d) tensor
  (zero where cam k never sees landmark l), so the reduced camera system
  S = Hcc - W Hll^-1 W^T is two batched einsums.
  K (local keyframes) is small (<= 32); L is the padded landmark capacity.
  For the distributed global BA, W is sharded along K (parallel/dist_ba.py)
  and S is psum-reduced.

Problem layout: poses are T_c_w (world->camera, like g2o's inverse-pose
vertices, mapHandler.cpp:5940) with left-multiplicative twist updates;
points are 3-vec world positions; lines are 4-DoF orthonormal coordinates
of world Pluecker lines with box-plus updates.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import lie, linalg
from ..core.numerics import full_f32_matmuls
from ..core.camera import StereoCamera
from ..core.plucker import (
    jac_plucker_wrt_orth,
    orth_plus,
    orth_to_plucker,
    plucker_motion_matrix,
    plucker_to_orth,
)

CHI2_TH = 5.991  # 2-DoF chi-square 95% gate (mapHandler.cpp:5978, :6131)
HOMOG = 1e-7


# Solver entries trace at full f32 matmul precision: reduced-precision
# matmul passes corrupt Jacobian chains and normal-equation algebra at the
# 1e-3 level, which compounds over LM iterations (measured with bf16
# passes: the 500-frame e2e ATE regressed 17-57% when only the Schur
# einsums were exact but the residual/Jacobian and refinement matmuls
# were not).
_f32_matmuls = full_f32_matmuls


class BAProblem(NamedTuple):
    """Padded, fixed-shape BA problem.

    K poses, P point landmarks, L line landmarks, Np point obs, Nl line obs.
    """

    # state
    T_c_w: jax.Array       # (K, 4, 4) world->camera
    pose_fixed: jax.Array  # (K,) bool — gauge / non-local KFs
    pose_valid: jax.Array  # (K,) bool
    points: jax.Array      # (P, 3) world points
    point_valid: jax.Array # (P,) bool
    lines_orth: jax.Array  # (L, 4) orthonormal world lines
    lines_scale: jax.Array # (L,) norm of the Pluecker 6-vec (orth rep is unit)
    line_valid: jax.Array  # (L,) bool
    # point observations
    p_cam: jax.Array       # (Np,) int32 pose slot
    p_lm: jax.Array        # (Np,) int32 point slot
    p_uv: jax.Array        # (Np, 2) observed pixel
    p_sigma2: jax.Array    # (Np,) inverse-variance weight
    p_valid: jax.Array     # (Np,) bool
    # line observations (two endpoints on the observed segment)
    l_cam: jax.Array       # (Nl,) int32
    l_lm: jax.Array        # (Nl,) int32
    l_sobs: jax.Array      # (Nl, 2)
    l_eobs: jax.Array      # (Nl, 2)
    l_sigma2: jax.Array    # (Nl,)
    l_valid: jax.Array     # (Nl,) bool
    # endpoint-line mode (levMarquardtOptimizationLBA/GBA :2334/:3128):
    # a 3D line is its two endpoints, each a regular 3-DoF entry of the
    # ``points`` table whose observation is the signed distance of the
    # projected endpoint to the observed image line.  When ``p_lo`` is
    # given, ``p_is_line`` selects per point-obs between the 2-vec
    # reprojection residual and the 1-vec point-to-line residual.
    p_lo: jax.Array | None = None       # (Np, 3) observed line eq (a,b,c)
    p_is_line: jax.Array | None = None  # (Np,) bool


class BAConfig(NamedTuple):
    iters1: int = 5            # first round (mapHandler.cpp:6121)
    iters2: int = 10           # post-gating round (:6152)
    lambda_init: float = 1e-4  # LM damping (slamConfig lambda_lba)
    lambda_factor: float = 10.0
    huber_delta: float = CHI2_TH ** 0.5
    chi2_gate: float = CHI2_TH
    optimize_lines: bool = True
    optimize_points: bool = True
    # trace-relative Tikhonov floor of the landmark-block damped inverse.
    # Small (1e-6) for regular 3-DoF points and 4-DoF orth lines: a larger
    # floor damps the weakly-constrained depth direction of low-parallax
    # points and visibly stalls convergence on clean problems.
    tikhonov: float = 1e-6
    # Endpoint-line slot damping comes in TWO regimes, because the two
    # solve classes want opposite trade-offs (measured r5):
    #
    # COLD/GLOBAL solves (chunked GBA, kf-block sharded GBA): endpoints
    # start far from the optimum and weak-but-real directions (low-
    # parallax depth) must converge.  The r4 isotropic 1e-4 floor damped
    # those too and stalled the ring-oracle GBA at 0.039 where a
    # reference-faithful dense f64 endpoint LM reaches 0.0058
    # (scripts/endpoint_gba_ab.py); DIRECTIONAL damping of only the
    # computed null vector (point_block_aniso) plus the light uniform
    # floor reaches 0.0059-0.0064 — oracle parity, robust across
    # strengths 1e-4..1e-3 and iteration budgets.
    # ``tikhonov_endpoint`` is that directional strength.
    #
    # WARM/INCREMENTAL solves (per-keyframe local BA, landmark-sharded
    # dist BA): endpoints start near-correct and the job is STABILITY
    # over hundreds of repeated capacity-capped f32 solves.  There,
    # rank-1 endpoint blocks (one or two near-parallel observations)
    # have a 2-DoF weak space that a single cross-derived null vector
    # cannot cover, and the undamped second direction accumulates noise:
    # the 156-KF loop-closure scenario lands at 0.47 m ATE with the
    # aniso scheme vs 0.0018-0.0024 with the r4 isotropic floor.
    # ``tikhonov_endpoint_warm`` is that isotropic floor, applied by
    # point_block_floor in the dense/dist LBA paths.
    tikhonov_endpoint: float = 1e-4
    tikhonov_endpoint_warm: float = 1e-4
    # Early exit of the LM loop: stop after ``lm_exit_streak`` consecutive
    # iterations whose relative cost decrease is below
    # ``lm_min_rel_decrease`` (a rejected step counts as zero decrease).
    # Incremental local BAs start from an already-converged local map —
    # measured cost trajectories are FLAT to 4 digits across all 15
    # iterations on warm maps, so the fixed schedule burns ~35 ms of
    # device time per keyframe doing rejected steps.  Cold problems
    # (first keyframes, GBA, oracles) keep improving every iteration and
    # run the full budget.  early_exit=False restores the fixed scan.
    early_exit: bool = True
    lm_min_rel_decrease: float = 1e-6
    lm_exit_streak: int = 2


# ---------------------------------------------------------------------------
# Residuals / Jacobians per observation
# ---------------------------------------------------------------------------


def point_obs_residuals(prob: BAProblem, cam: StereoCamera):
    """2-vec reprojection residual per point obs + Jacobians wrt pose twist
    (6) and world point (3).  Spec: g2o_types.h EdgePosePoint :206-300 (sign
    conventions adapted to e = proj - obs with exp(delta) T updates)."""
    T = prob.T_c_w[prob.p_cam]                     # (Np, 4, 4)
    Pw = prob.points[prob.p_lm]                    # (Np, 3)
    Pc = lie.transform_point(T, Pw)
    proj = cam.project(Pc)
    e = proj - prob.p_uv                           # (Np, 2)
    x, y, z = Pc[..., 0], Pc[..., 1], Pc[..., 2]
    zs = jnp.maximum(z, HOMOG)
    z2 = zs * zs
    zeros = jnp.zeros_like(z)
    Jproj = jnp.stack(
        [
            jnp.stack([cam.fx / zs, zeros, -cam.fx * x / z2], axis=-1),
            jnp.stack([zeros, cam.fy / zs, -cam.fy * y / z2], axis=-1),
        ],
        axis=-2,
    )                                              # (Np, 2, 3)
    I3 = jnp.broadcast_to(jnp.eye(3, dtype=Pc.dtype), Pc.shape[:-1] + (3, 3))
    dPc_ddelta = jnp.concatenate([I3, -lie.skew(Pc)], axis=-1)  # (Np, 3, 6)
    J_pose = jnp.einsum("nij,njk->nik", Jproj, dPc_ddelta)      # (Np, 2, 6)
    R = T[..., :3, :3]
    J_pt = jnp.einsum("nij,njk->nik", Jproj, R)                 # (Np, 2, 3)

    if prob.p_lo is not None:
        # endpoint-line observations: e = lo . [proj; 1] in row 0, row 1
        # zeroed; J rows chain through the same projection Jacobians
        lo = prob.p_lo
        e_line = (lo[..., 0] * proj[..., 0] + lo[..., 1] * proj[..., 1]
                  + lo[..., 2])
        lxy = lo[..., :2]
        Jl_pose = jnp.einsum("ni,nik->nk", lxy, J_pose)   # (Np, 6)
        Jl_pt = jnp.einsum("ni,nik->nk", lxy, J_pt)       # (Np, 3)
        zero = jnp.zeros_like(e_line)
        is_l = prob.p_is_line
        e = jnp.where(is_l[:, None],
                      jnp.stack([e_line, zero], axis=-1), e)
        J_pose = jnp.where(is_l[:, None, None],
                           jnp.stack([Jl_pose, jnp.zeros_like(Jl_pose)],
                                     axis=-2), J_pose)
        J_pt = jnp.where(is_l[:, None, None],
                         jnp.stack([Jl_pt, jnp.zeros_like(Jl_pt)],
                                   axis=-2), J_pt)
    return e, J_pose, J_pt


def line_obs_residuals(prob: BAProblem, cam: StereoCamera):
    """2-vec endpoint-to-projected-line residual per line obs + Jacobians
    wrt pose twist (6) and orthonormal line update (4).  Spec: g2o_types.h
    EdgePoseLine :302-453."""
    T = prob.T_c_w[prob.l_cam]                     # (Nl, 4, 4)
    orth = prob.lines_orth[prob.l_lm]              # (Nl, 4)
    scale = prob.lines_scale[prob.l_lm]            # (Nl,)
    Lw = orth_to_plucker(orth) * scale[..., None]  # (Nl, 6)
    H = plucker_motion_matrix(T)                   # (Nl, 6, 6)
    Lc = jnp.einsum("nij,nj->ni", H, Lw)
    n_c, d_c = Lc[..., :3], Lc[..., 3:]
    l = jnp.einsum("ij,nj->ni", cam.plucker_K, n_c)
    lx, ly, lz = l[..., 0], l[..., 1], l[..., 2]
    fm2 = jnp.maximum(lx * lx + ly * ly, HOMOG)
    fm = 1.0 / jnp.sqrt(fm2)
    e0 = (prob.l_sobs[..., 0] * lx + prob.l_sobs[..., 1] * ly + lz) * fm
    e1 = (prob.l_eobs[..., 0] * lx + prob.l_eobs[..., 1] * ly + lz) * fm
    e = jnp.stack([e0, e1], axis=-1)               # (Nl, 2)
    # d e_i / d l
    a0, b0 = prob.l_sobs[..., 0], prob.l_sobs[..., 1]
    a1, b1 = prob.l_eobs[..., 0], prob.l_eobs[..., 1]
    de0 = jnp.stack([a0 * fm - lx * e0 * fm * fm,
                     b0 * fm - ly * e0 * fm * fm, fm], axis=-1)
    de1 = jnp.stack([a1 * fm - lx * e1 * fm * fm,
                     b1 * fm - ly * e1 * fm * fm, fm], axis=-1)
    de_dl = jnp.stack([de0, de1], axis=-2)         # (Nl, 2, 3)
    # d l / d n_c = K_L ; d n_c / d pose-delta = [-skew(d_c) | -skew(n_c)]
    dn = jnp.concatenate([-lie.skew(d_c), -lie.skew(n_c)], axis=-1)  # (Nl,3,6)
    dl_dpose = jnp.einsum("ij,njk->nik", cam.plucker_K, dn)
    J_pose = jnp.einsum("nij,njk->nik", de_dl, dl_dpose)             # (Nl,2,6)
    # d l / d orth-delta = K_L * (H * d Lw / d orth)[:3].
    # jac_plucker_wrt_orth normalizes internally (unit-line Jacobian), so
    # the landmark's fixed scale multiplies it: Lw = scale * L_unit(orth).
    dLw = jac_plucker_wrt_orth(Lw) * scale[..., None, None]  # (Nl, 6, 4)
    dLc = jnp.einsum("nij,njk->nik", H, dLw)       # (Nl, 6, 4)
    dl_dorth = jnp.einsum("ij,njk->nik", cam.plucker_K, dLc[..., :3, :])
    J_line = jnp.einsum("nij,njk->nik", de_dl, dl_dorth)             # (Nl,2,4)
    return e, J_pose, J_line


def cauchy_weight(e: jax.Array) -> jax.Array:
    """IRLS weight of the unit-scale Cauchy loss on the residual norm —
    the reference's robustWeightCauchy (auxiliar.cpp:556), used by every
    LBA/GBA observation (mapHandler.cpp:2411, :2512, :3193).  Redescending:
    a gross outlier's influence r/(1+r^2) -> 0, where Huber's stays
    constant — with sparse line observations that constant pull is enough
    to drag the whole local window (seen as trajectory stretch)."""
    r2 = jnp.sum(e * e, axis=-1)
    return 1.0 / (1.0 + r2)


def cauchy_cost(e: jax.Array) -> jax.Array:
    """rho(r) = log(1 + r^2), the loss whose IRLS weight is cauchy_weight."""
    r2 = jnp.sum(e * e, axis=-1)
    return jnp.log1p(r2)


def _w(e: jax.Array, robust: bool) -> jax.Array:
    """Per-observation IRLS weight: Cauchy in the robust round, 1 in the
    pure-LSQ round (the reference clears kernels after gating,
    mapHandler.cpp:6133/:6147 setRobustKernel(0))."""
    return cauchy_weight(e) if robust else jnp.ones(e.shape[:-1], e.dtype)


def _rho(e: jax.Array, robust: bool) -> jax.Array:
    return cauchy_cost(e) if robust else jnp.sum(e * e, axis=-1)


def chi2(e: jax.Array, sigma2: jax.Array) -> jax.Array:
    return jnp.sum(e * e, axis=-1) * sigma2


# ---------------------------------------------------------------------------
# Normal equations + Schur complement
# ---------------------------------------------------------------------------


class _Assembled(NamedTuple):
    Hcc: jax.Array    # (K, 6, 6) block diagonal of camera Hessian
    bc: jax.Array     # (K, 6)
    Hpp: jax.Array    # (P, 3, 3)
    bp: jax.Array     # (P, 3)
    Wp: jax.Array     # (K, P, 6, 3)
    Hll: jax.Array    # (L, 4, 4)
    bl: jax.Array     # (L, 4)
    Wl: jax.Array     # (K, L, 6, 4)
    cost: jax.Array


def _use_matmul_accumulate() -> bool:
    """Accelerators accumulate the (K, P, 6, 3) blocks as one-hot matmuls
    instead of scatter-adds.  On CPU (the f64 test backend) scatters are
    faster and the one-hot matrices are large, so keep them there."""
    return jax.default_backend() not in ("cpu",)


def _accumulate(cam_idx, lm_idx, K, n_lm, w, Jc, Jl, e, dtype):
    """Weighted normal-equation blocks of one modality: returns
    (Hcc, bc, Hll_blocks, bl, W) accumulated per camera / landmark /
    (camera, landmark) pair."""
    d = Jl.shape[-1]
    Gcc = jnp.einsum("n,nij,nik->njk", w, Jc, Jc)       # (N, 6, 6)
    gc = jnp.einsum("n,nij,ni->nj", w, Jc, e)           # (N, 6)
    Gll = jnp.einsum("n,nij,nik->njk", w, Jl, Jl)       # (N, d, d)
    gl = jnp.einsum("n,nij,ni->nj", w, Jl, e)           # (N, d)
    Gcl = jnp.einsum("n,nij,nik->njk", w, Jc, Jl)       # (N, 6, d)
    if _use_matmul_accumulate():
        # HIGHEST precision: Hessian accumulation needs full f32
        hi = jax.lax.Precision.HIGHEST
        ohc = (cam_idx[None, :] == jnp.arange(K)[:, None]).astype(dtype)
        ohl = (lm_idx[None, :] == jnp.arange(n_lm)[:, None]).astype(dtype)
        Hcc = jnp.einsum("kn,nab->kab", ohc, Gcc, precision=hi)
        bc = jnp.einsum("kn,na->ka", ohc, gc, precision=hi)
        Hll = jnp.einsum("pn,nab->pab", ohl, Gll, precision=hi)
        bl = jnp.einsum("pn,na->pa", ohl, gl, precision=hi)
        W = jnp.einsum("kn,pn,nab->kpab", ohc, ohl, Gcl, precision=hi)
        return Hcc, bc, Hll, bl, W
    Hcc = jnp.zeros((K, 6, 6), dtype).at[cam_idx].add(Gcc)
    bc = jnp.zeros((K, 6), dtype).at[cam_idx].add(gc)
    Hll = jnp.zeros((n_lm, d, d), dtype).at[lm_idx].add(Gll)
    bl = jnp.zeros((n_lm, d), dtype).at[lm_idx].add(gl)
    W = jnp.zeros((K, n_lm, 6, d), dtype).at[cam_idx, lm_idx].add(Gcl)
    return Hcc, bc, Hll, bl, W


def assemble(prob: BAProblem, cam: StereoCamera, cfg: BAConfig,
             p_active: jax.Array, l_active: jax.Array,
             robust: bool = True) -> _Assembled:
    K = prob.T_c_w.shape[0]
    P = prob.points.shape[0]
    L = prob.lines_orth.shape[0]
    dtype = prob.points.dtype

    e_p, Jc_p, Jp_p = point_obs_residuals(prob, cam)
    w_p = _w(e_p, robust) * prob.p_sigma2
    w_p = jnp.where(p_active, w_p, 0.0)
    Hcc, bc, Hpp, bp, Wp = _accumulate(
        prob.p_cam, prob.p_lm, K, P, w_p, Jc_p, Jp_p, e_p, dtype)
    cost = jnp.sum(jnp.where(p_active, _rho(e_p, robust) * prob.p_sigma2, 0.0))

    e_l, Jc_l, Jl_l = line_obs_residuals(prob, cam)
    w_l = _w(e_l, robust) * prob.l_sigma2
    w_l = jnp.where(l_active, w_l, 0.0)
    Hcc_l, bc_l, Hll, bl, Wl = _accumulate(
        prob.l_cam, prob.l_lm, K, L, w_l, Jc_l, Jl_l, e_l, dtype)
    Hcc = Hcc + Hcc_l
    bc = bc + bc_l
    cost = cost + jnp.sum(
        jnp.where(l_active, _rho(e_l, robust) * prob.l_sigma2, 0.0))

    return _Assembled(Hcc, bc, Hpp, bp, Wp, Hll, bl, Wl, cost)


def _damped_inv(Hblocks: jax.Array, lam: jax.Array, valid: jax.Array,
                dim: int, floor=1e-6, extra: jax.Array | None = None):
    """Per-landmark damped inverse (H + lam*diag(H))^-1; identity for
    invalid/unobserved landmarks (their delta is zeroed anyway).
    ``floor`` is the trace-relative Tikhonov floor — a scalar, or a
    per-block (n,) array.  ``extra`` adds a per-block damping matrix
    (point_block_aniso's targeted null-space term)."""
    diag = jnp.eye(dim, dtype=Hblocks.dtype)
    tr = jnp.einsum("nii->n", Hblocks)
    # trace-relative Tikhonov: an absolute 1e-12 floor is nothing against
    # trace ~1e4 in f32
    damped = (Hblocks + lam * Hblocks * diag
              + (floor * tr + 1e-12)[:, None, None] * diag)
    if extra is not None:
        damped = damped + extra
    observed = tr > 1e-12
    use = valid & observed
    safe = jnp.where(use[:, None, None], damped, diag)
    inv = linalg.inv3x3(safe) if dim == 3 else linalg.inv4x4(safe)
    return jnp.where(use[:, None, None], inv, 0.0), use


def point_block_floor(prob: BAProblem, cfg: BAConfig) -> jax.Array:
    """Per-slot isotropic Tikhonov floor for WARM/INCREMENTAL solves
    (dense local BA, landmark-sharded dist BA): endpoint-line slots get
    cfg.tikhonov_endpoint_warm, true 3-DoF points keep cfg.tikhonov.
    See the BAConfig two-regime rationale."""
    P = prob.points.shape[0]
    base = jnp.full(P, cfg.tikhonov, prob.points.dtype)
    if prob.p_is_line is None:
        return base
    is_ep = jnp.zeros(P, bool).at[prob.p_lm].max(prob.p_is_line)
    return jnp.where(is_ep, jnp.maximum(cfg.tikhonov,
                                        cfg.tikhonov_endpoint_warm), base)


def point_block_floor_global(prob: BAProblem, cfg: BAConfig) -> jax.Array:
    """Uniform light floor for COLD/GLOBAL solves (chunked/sharded GBA),
    paired with point_block_aniso's targeted null-space damping.  See the
    BAConfig two-regime rationale."""
    P = prob.points.shape[0]
    return jnp.full(P, cfg.tikhonov, prob.points.dtype)


def point_block_aniso(prob: BAProblem, cfg: BAConfig,
                      Hpp: jax.Array) -> jax.Array | None:
    """Targeted null-space damping for endpoint-line point slots.

    A point-to-line residual pair leaves the along-line direction of each
    endpoint exactly flat: the endpoint's 3x3 Hessian block is rank-2 and
    f32 rounding noise in the gradient's null component produces updates
    of order |b|/(floor*tr) along it (observed as endpoint drift that
    pollutes the pose solve).  Instead of raising the isotropic floor
    (which damps the constrained directions and stalls convergence), damp
    ONLY the null direction: for a rank-2 block the null vector is the
    cross product of its two most independent columns (columns span the
    row space).  Damping strength cfg.tikhonov_endpoint * trace, applied
    solely to endpoint slots.  For a block that happens to be
    well-conditioned the extra term is negligible relative to its
    eigenvalues."""
    if prob.p_is_line is None:
        return None
    P = prob.points.shape[0]
    is_ep = jnp.zeros(P, bool).at[prob.p_lm].max(prob.p_is_line)
    c0, c1, c2 = Hpp[..., 0], Hpp[..., 1], Hpp[..., 2]
    crosses = jnp.stack([jnp.cross(c0, c1), jnp.cross(c1, c2),
                         jnp.cross(c0, c2)], axis=1)        # (P, 3, 3)
    norms = jnp.linalg.norm(crosses, axis=-1)               # (P, 3)
    best = jnp.take_along_axis(
        crosses, jnp.argmax(norms, axis=1)[:, None, None], axis=1)[:, 0]
    null = best / jnp.maximum(
        jnp.linalg.norm(best, axis=-1, keepdims=True), 1e-30)
    tr = jnp.einsum("nii->n", Hpp)
    aniso = (cfg.tikhonov_endpoint * tr)[:, None, None] * \
        null[:, :, None] * null[:, None, :]
    return jnp.where(is_ep[:, None, None], aniso, 0.0)


def schur_partials(a: _Assembled, prob: BAProblem, lam: jax.Array,
                   cfg: BAConfig = BAConfig(), mode: str = "warm"):
    """Landmark-marginalized partial contributions to the reduced camera
    system: S_off = -W Hll^-1 W^T and rhs = bc - W Hll^-1 b.  These are
    linear in the observation set, so chunked/sharded assemblies sum them
    (the distributed Schur reduction of SURVEY.md §2.4).

    Precision HIGHEST on the marginalization einsums: reduced-precision
    matmul passes wreck the Schur correction (measured with bf16 passes:
    the LM stalls at cost 204 vs 0.056 with exact f32 on an otherwise
    identical solve) — Hessian-level accuracy needs full f32, the same
    lesson as _accumulate."""
    hi = jax.lax.Precision.HIGHEST
    if mode == "global":
        # cold/global regime: light uniform floor + targeted null-space
        # damping (see the BAConfig two-regime rationale)
        floor = point_block_floor_global(prob, cfg)
        extra = point_block_aniso(prob, cfg, a.Hpp)
    else:
        # warm/incremental regime: raised isotropic endpoint floor
        floor = point_block_floor(prob, cfg)
        extra = None
    Hpp_inv, _ = _damped_inv(a.Hpp, lam, prob.point_valid, 3, floor,
                             extra=extra)
    Hll_inv, _ = _damped_inv(a.Hll, lam, prob.line_valid, 4, cfg.tikhonov)
    S_off = -jnp.einsum("kpab,pbc,qpdc->kqad", a.Wp, Hpp_inv, a.Wp,
                        precision=hi)
    S_off = S_off - jnp.einsum("klab,lbc,qldc->kqad", a.Wl, Hll_inv, a.Wl,
                               precision=hi)
    rhs = a.bc - jnp.einsum("kpab,pbc,pc->ka", a.Wp, Hpp_inv, a.bp,
                            precision=hi)
    rhs = rhs - jnp.einsum("klab,lbc,lc->ka", a.Wl, Hll_inv, a.bl,
                           precision=hi)
    return Hpp_inv, Hll_inv, S_off, rhs


def solve_reduced(Hcc: jax.Array, S_off: jax.Array, rhs: jax.Array,
                  lam: jax.Array, free: jax.Array) -> jax.Array:
    """Solve the damped reduced camera system for the pose update.

    Hcc: (K, 6, 6) block-diagonal camera Hessian; S_off: (K, K, 6, 6)
    Schur correction; rhs: (K, 6); free: (K,) bool of non-fixed poses.
    """
    K = Hcc.shape[0]
    dtype = Hcc.dtype
    I6 = jnp.eye(6, dtype=dtype)
    Hcc_d = Hcc + lam * Hcc * I6
    S = S_off.at[jnp.arange(K), jnp.arange(K)].add(Hcc_d)

    # Fixed/invalid poses: replace their rows/cols by identity, rhs by 0.
    fmask = free.astype(dtype)
    S = S * fmask[:, None, None, None] * fmask[None, :, None, None]
    S = S.at[jnp.arange(K), jnp.arange(K)].add(
        I6 * (1.0 - fmask)[:, None, None])
    rhs = rhs * fmask[:, None]

    Smat = S.transpose(0, 2, 1, 3).reshape(6 * K, 6 * K)
    # gauge regularization for safety
    Smat = Smat + 1e-10 * jnp.eye(6 * K, dtype=dtype)
    b = rhs.reshape(-1)
    # ONE factorization shared by the solve and its refinement step —
    # the second solve_spd refactorized the identical matrix, doubling
    # the sequential-depth cost of the latency-bound LM iteration
    L = linalg.cholesky(Smat)

    def _solve(v):
        return linalg.solve_triangular_upper(
            L.T, linalg.solve_triangular_lower(L, v))

    x = _solve(b)
    # one step of iterative refinement: the reduced system's conditioning
    # (~1e6 on large maps) is at the edge of f32 Cholesky — the raw
    # solution's residual error is summation-order dependent (the same
    # problem solved as one 4096-landmark einsum vs 8 psum'd shards gave
    # visibly different LM steps on some hosts); refinement recovers
    # several digits for one extra cheap 6Kx6K substitution pair and
    # makes chunked, sharded, and single-device paths agree again
    x = x + _solve(b - Smat @ x)
    dpose = x.reshape(K, 6)
    return dpose * fmask[:, None]


def back_substitute(a: _Assembled, Hpp_inv, Hll_inv, dpose, cfg: BAConfig):
    """Landmark back-substitution dx = Hll^-1 (b - W^T dpose)
    (precision HIGHEST — see schur_partials)."""
    hi = jax.lax.Precision.HIGHEST
    tp = a.bp - jnp.einsum("kpab,ka->pb", a.Wp, dpose, precision=hi)
    dpoint = jnp.einsum("pbc,pc->pb", Hpp_inv, tp, precision=hi)
    tl = a.bl - jnp.einsum("klab,ka->lb", a.Wl, dpose, precision=hi)
    dline = jnp.einsum("lbc,lc->lb", Hll_inv, tl, precision=hi)
    if not cfg.optimize_points:
        dpoint = jnp.zeros_like(dpoint)
    if not cfg.optimize_lines:
        dline = jnp.zeros_like(dline)
    return dpoint, dline


def solve_schur(a: _Assembled, prob: BAProblem, cfg: BAConfig, lam: jax.Array):
    """One damped Schur solve: reduced camera system then back-substitution.

    Returns (dpose (K,6), dpoint (P,3), dline (L,4)).
    """
    free = prob.pose_valid & ~prob.pose_fixed
    Hpp_inv, Hll_inv, S_off, rhs = schur_partials(a, prob, lam, cfg)
    dpose = solve_reduced(a.Hcc, S_off, rhs, lam, free)
    dpoint, dline = back_substitute(a, Hpp_inv, Hll_inv, dpose, cfg)
    return dpose, dpoint, dline


def apply_update(prob: BAProblem, dpose, dpoint, dline) -> BAProblem:
    """State update: T <- exp(-d) T (descent step since b = J^T e),
    points x <- x - dx, lines orth boxplus(-dl)."""
    T_new = jax.vmap(lambda d, T: lie.exp_se3(-d) @ T)(dpose, prob.T_c_w)
    pts_new = prob.points - dpoint
    lines_new = jax.vmap(orth_plus)(prob.lines_orth, -dline)
    return prob._replace(T_c_w=T_new, points=pts_new, lines_orth=lines_new)


def total_cost(prob: BAProblem, cam: StereoCamera, cfg: BAConfig,
               p_active, l_active, robust: bool = True) -> jax.Array:
    e_p, _, _ = point_obs_residuals(prob, cam)
    e_l, _, _ = line_obs_residuals(prob, cam)
    c = jnp.sum(jnp.where(p_active, _rho(e_p, robust) * prob.p_sigma2, 0.0))
    c = c + jnp.sum(jnp.where(l_active, _rho(e_l, robust) * prob.l_sigma2, 0.0))
    return c


@_f32_matmuls
def lm_rounds(prob: BAProblem, cam: StereoCamera, cfg: BAConfig,
              p_active, l_active, iters: int, robust: bool = True):
    """Fixed-iteration LM with accept/reject damping (the reference's
    levMarquardt loop :2530-2600 expressed as a scan)."""

    def body(carry, _):
        prob, lam, cost = carry
        a = assemble(prob, cam, cfg, p_active, l_active, robust)
        dpose, dpoint, dline = solve_schur(a, prob, cfg, lam)
        cand = apply_update(prob, dpose, dpoint, dline)
        new_cost = total_cost(cand, cam, cfg, p_active, l_active, robust)
        ok = (new_cost < cost) & jnp.isfinite(new_cost)
        rel = jnp.where(ok, (cost - new_cost) / jnp.maximum(cost, 1e-30),
                        0.0)
        prob = jax.tree.map(
            lambda new, old: jnp.where(ok, new, old) if new.ndim == 0 else
            jnp.where(jnp.reshape(ok, (1,) * new.ndim), new, old),
            cand, prob)
        lam = jnp.where(ok, lam / cfg.lambda_factor, lam * cfg.lambda_factor)
        lam = jnp.clip(lam, 1e-9, 1e6)
        cost = jnp.where(ok, new_cost, cost)
        return (prob, lam, cost), rel

    cost0 = total_cost(prob, cam, cfg, p_active, l_active, robust)
    lam0 = jnp.asarray(cfg.lambda_init, prob.points.dtype)
    if cfg.early_exit:
        # stop after lm_exit_streak consecutive no-progress iterations —
        # see BAConfig.early_exit.  The prefix of iterations up to the
        # exit is identical to the fixed scan; what is skipped is the
        # tail after the streak (which could in principle still accept a
        # step after further lambda escalation — not observed in
        # practice, and the reference's LM breaks on no-improvement too)
        def w_cond(c):
            i, streak, _ = c
            return (i < iters) & (streak < cfg.lm_exit_streak)

        def w_body(c):
            i, streak, inner = c
            new_inner, rel = body(inner, None)
            streak = jnp.where(rel > cfg.lm_min_rel_decrease, 0, streak + 1)
            return (i + 1, streak, new_inner)

        _, _, (prob, _, cost) = jax.lax.while_loop(
            w_cond, w_body,
            (jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
             (prob, lam0, cost0)))
        return prob, cost
    (prob, _, cost), _ = jax.lax.scan(body, (prob, lam0, cost0), None, length=iters)
    return prob, cost


class BAResult(NamedTuple):
    problem: BAProblem
    p_active: jax.Array
    l_active: jax.Array
    cost: jax.Array


@_f32_matmuls
def bundle_adjust(prob: BAProblem, cam: StereoCamera,
                  cfg: BAConfig = BAConfig()) -> BAResult:
    """Two-round BA with chi^2 gating between rounds
    (localBundleAdjustmentForPlukerWithG2O :6119-6152)."""
    p_active = prob.p_valid
    l_active = prob.l_valid
    prob, _ = lm_rounds(prob, cam, cfg, p_active, l_active, cfg.iters1,
                        robust=True)
    # gate, then re-optimize (:6133-6152; the hand-rolled endpoint-mode
    # LBA keeps Cauchy for every iteration, mapHandler.cpp:2411 — dropping
    # the kernel after gating measurably hurts on marginal problems, so
    # the robust weight stays on in round 2 as well)
    e_p, _, _ = point_obs_residuals(prob, cam)
    e_l, _, _ = line_obs_residuals(prob, cam)
    p_active = p_active & (chi2(e_p, prob.p_sigma2) <= cfg.chi2_gate)
    l_active = l_active & (chi2(e_l, prob.l_sigma2) <= cfg.chi2_gate)
    prob, cost = lm_rounds(prob, cam, cfg, p_active, l_active, cfg.iters2,
                           robust=True)
    return BAResult(problem=prob, p_active=p_active, l_active=l_active, cost=cost)


# ---------------------------------------------------------------------------
# Chunked global BA: Schur accumulation over fixed-shape landmark tiles
# ---------------------------------------------------------------------------

# Leaves of BAProblem that carry a leading chunk axis in the stacked
# global problem (poses are shared across chunks).
_CHUNK_LEAVES = (
    "points", "point_valid", "lines_orth", "lines_scale", "line_valid",
    "p_cam", "p_lm", "p_uv", "p_sigma2", "p_valid",
    "l_cam", "l_lm", "l_sobs", "l_eobs", "l_sigma2", "l_valid",
    "p_lo", "p_is_line",
)


def _chunk_xs(prob: BAProblem) -> dict:
    return {f: getattr(prob, f) for f in _CHUNK_LEAVES
            if getattr(prob, f) is not None}


def _mk_chunk(prob: BAProblem, T: jax.Array, x: dict) -> BAProblem:
    return prob._replace(T_c_w=T, **x)


@_f32_matmuls
def bundle_adjust_chunked(prob: BAProblem, cam: StereoCamera,
                          cfg: BAConfig = BAConfig(),
                          axis_name: str | None = None) -> BAResult:
    """Global BA over ALL landmarks, tiled in fixed-shape chunks.

    ``prob`` carries a leading chunk axis C on every landmark/observation
    leaf (see _CHUNK_LEAVES) and shared unstacked pose leaves.  Per LM
    iteration, a lax.scan over chunks accumulates the reduced camera
    system (Schur partials are additive over observations), the pose
    update is solved ONCE on the full system, then a second scan
    back-substitutes every chunk's landmarks.  This is the no-silent-caps
    equivalent of the reference's all-landmark GBA
    (mapHandler.cpp:3022-3126), restructured so each device program stays
    fixed-shape regardless of map size.

    ``axis_name``: when running inside shard_map with the chunk axis
    sharded over a mesh, name of the mesh axis to psum the reduced camera
    system and costs over.  Every chunk must own its landmarks TOGETHER
    WITH ALL their observations (landmark-disjoint chunks), which makes
    the sharded solve algebraically identical to the single-device one —
    the exact kf-block distributed GBA of parallel/dist_gba.py.
    """
    free = prob.pose_valid & ~prob.pose_fixed
    xs = _chunk_xs(prob)

    def _allsum(x):
        return x if axis_name is None else jax.lax.psum(x, axis_name)

    def cost_all(T, state, p_act, l_act, robust):
        def body(c, inp):
            x, spts, sls, pa, la = inp
            pr = _mk_chunk(prob, T, x)._replace(points=spts, lines_orth=sls)
            return c + total_cost(pr, cam, cfg, pa, la, robust), None

        c, _ = jax.lax.scan(
            body, jnp.asarray(0.0, prob.points.dtype),
            (xs, state[0], state[1], p_act, l_act))
        return _allsum(c)

    def lm_iter(carry, _, robust):
        T, state, lam, cost, p_act, l_act = carry
        K = T.shape[0]
        dtype = prob.points.dtype

        # pass 1: accumulate the reduced camera system over chunks
        def pass1(acc, inp):
            x, spts, sls, pa, la = inp
            pr = _mk_chunk(prob, T, x)._replace(points=spts, lines_orth=sls)
            a = assemble(pr, cam, cfg, pa, la, robust)
            _, _, S_off, rhs = schur_partials(a, pr, lam, cfg,
                                              mode="global")
            Hcc_s, S_s, rhs_s = acc
            return (Hcc_s + a.Hcc, S_s + S_off, rhs_s + rhs), None

        acc0 = (jnp.zeros((K, 6, 6), dtype), jnp.zeros((K, K, 6, 6), dtype),
                jnp.zeros((K, 6), dtype))
        (Hcc, S_off, rhs), _ = jax.lax.scan(
            pass1, acc0, (xs, state[0], state[1], p_act, l_act))
        Hcc = _allsum(Hcc)
        S_off = _allsum(S_off)
        rhs = _allsum(rhs)
        dpose = solve_reduced(Hcc, S_off, rhs, lam, free)
        T_new = jax.vmap(lambda d, Ti: lie.exp_se3(-d) @ Ti)(dpose, T)

        # pass 2: back-substitute each chunk's landmarks + candidate cost
        def pass2(c, inp):
            x, spts, sls, pa, la = inp
            pr = _mk_chunk(prob, T, x)._replace(points=spts, lines_orth=sls)
            a = assemble(pr, cam, cfg, pa, la, robust)
            Hpp_inv, _ = _damped_inv(
                a.Hpp, lam, pr.point_valid, 3,
                point_block_floor_global(pr, cfg),
                extra=point_block_aniso(pr, cfg, a.Hpp))
            Hll_inv, _ = _damped_inv(a.Hll, lam, pr.line_valid, 4,
                                     cfg.tikhonov)
            dpoint, dline = back_substitute(a, Hpp_inv, Hll_inv, dpose, cfg)
            new_pts = spts - dpoint
            new_ls = jax.vmap(orth_plus)(sls, -dline)
            cand = pr._replace(T_c_w=T_new, points=new_pts,
                               lines_orth=new_ls)
            return c + total_cost(cand, cam, cfg, pa, la,
                                   robust), (new_pts, new_ls)

        new_cost, (cand_pts, cand_ls) = jax.lax.scan(
            pass2, jnp.asarray(0.0, dtype), (xs, state[0], state[1],
                                             p_act, l_act))
        new_cost = _allsum(new_cost)
        ok = (new_cost < cost) & jnp.isfinite(new_cost)
        sel = lambda new, old: jnp.where(  # noqa: E731
            jnp.reshape(ok, (1,) * new.ndim), new, old)
        T = sel(T_new, T)
        state = (sel(cand_pts, state[0]), sel(cand_ls, state[1]))
        lam = jnp.clip(jnp.where(ok, lam / cfg.lambda_factor,
                                 lam * cfg.lambda_factor), 1e-9, 1e6)
        cost = jnp.where(ok, new_cost, cost)
        return (T, state, lam, cost, p_act, l_act), None

    def rounds(T, state, p_act, l_act, iters, robust):
        lam0 = jnp.asarray(cfg.lambda_init, prob.points.dtype)
        cost0 = cost_all(T, state, p_act, l_act, robust)
        (T, state, _, cost, _, _), _ = jax.lax.scan(
            lambda c, x: lm_iter(c, x, robust),
            (T, state, lam0, cost0, p_act, l_act), None,
            length=iters)
        return T, state, cost

    def gate(T, state, p_act, l_act):
        def body(_, inp):
            x, spts, sls, pa, la = inp
            pr = _mk_chunk(prob, T, x)._replace(points=spts, lines_orth=sls)
            e_p, _, _ = point_obs_residuals(pr, cam)
            e_l, _, _ = line_obs_residuals(pr, cam)
            pa2 = pa & (chi2(e_p, pr.p_sigma2) <= cfg.chi2_gate)
            la2 = la & (chi2(e_l, pr.l_sigma2) <= cfg.chi2_gate)
            return None, (pa2, la2)

        _, (p2, l2) = jax.lax.scan(
            body, None, (xs, state[0], state[1], p_act, l_act))
        return p2, l2

    T = prob.T_c_w
    state = (prob.points, prob.lines_orth)
    p_act, l_act = prob.p_valid, prob.l_valid
    T, state, _ = rounds(T, state, p_act, l_act, cfg.iters1, robust=True)
    p_act, l_act = gate(T, state, p_act, l_act)
    T, state, cost = rounds(T, state, p_act, l_act, cfg.iters2, robust=True)
    out = prob._replace(T_c_w=T, points=state[0], lines_orth=state[1])
    return BAResult(problem=out, p_active=p_act, l_active=l_act, cost=cost)


# ---------------------------------------------------------------------------
# Packed transport: the local-BA hot path
# ---------------------------------------------------------------------------
# A BAProblem has ~22 leaves, each its own host->device transfer if
# uploaded separately.  The packed entry ships THREE dense buffers
# (f32 / i32 / bool), slices them back into a BAProblem inside the trace
# (free), and returns ONE f32 buffer with everything write-back consumes.


class ProblemLayout(NamedTuple):
    K: int
    P: int
    L: int
    Np: int
    Nl: int
    has_lo: bool
    # lines travel as normalized (||d||=1) world Pluecker 6-vectors and the
    # orth conversion happens IN-TRACE — a host-side conversion is an extra
    # device round trip per BA
    plucker_io: bool = False


def pack_problem_np(p: "BAProblem", lines_plucker=None):
    """Flatten a numpy-leaved BAProblem into (f32, i32, bool) buffers.
    With ``lines_plucker`` (L, 6, ||d||=1), the line state ships raw and
    both directions of the orth conversion run inside the trace."""
    import numpy as np

    lay = ProblemLayout(K=p.T_c_w.shape[0], P=p.points.shape[0],
                        L=p.lines_orth.shape[0], Np=p.p_cam.shape[0],
                        Nl=p.l_cam.shape[0], has_lo=p.p_lo is not None,
                        plucker_io=lines_plucker is not None)
    lines_f = ([lines_plucker.ravel()] if lay.plucker_io
               else [p.lines_orth.ravel(), p.lines_scale.ravel()])
    f = [p.T_c_w.ravel(), p.points.ravel(), *lines_f,
         p.p_uv.ravel(), p.p_sigma2.ravel(),
         p.l_sobs.ravel(), p.l_eobs.ravel(), p.l_sigma2.ravel()]
    if lay.has_lo:
        f.append(p.p_lo.ravel())
    i = [p.p_cam.ravel(), p.p_lm.ravel(), p.l_cam.ravel(), p.l_lm.ravel()]
    b = [p.pose_fixed, p.pose_valid, p.point_valid, p.line_valid,
         p.p_valid, p.l_valid]
    if lay.has_lo:
        b.append(p.p_is_line)
    return (np.concatenate(f).astype(np.float32),
            np.concatenate(i).astype(np.int32),
            np.concatenate(b).astype(bool), lay)


def unpack_problem(f: jax.Array, i: jax.Array, b: jax.Array,
                   lay: ProblemLayout) -> BAProblem:
    K, P, L, Np, Nl = lay.K, lay.P, lay.L, lay.Np, lay.Nl

    def take(buf, pos, n, shape):
        return buf[pos: pos + n].reshape(shape), pos + n

    pos = 0
    T, pos = take(f, pos, K * 16, (K, 4, 4))
    points, pos = take(f, pos, P * 3, (P, 3))
    if lay.plucker_io:
        Lw, pos = take(f, pos, L * 6, (L, 6))
        scale = jnp.linalg.norm(Lw, axis=-1)
        safe = jnp.maximum(scale, 1e-12)[:, None]
        orth = jax.vmap(plucker_to_orth)(Lw / safe)
    else:
        orth, pos = take(f, pos, L * 4, (L, 4))
        scale, pos = take(f, pos, L, (L,))
    p_uv, pos = take(f, pos, Np * 2, (Np, 2))
    p_sig, pos = take(f, pos, Np, (Np,))
    l_sobs, pos = take(f, pos, Nl * 2, (Nl, 2))
    l_eobs, pos = take(f, pos, Nl * 2, (Nl, 2))
    l_sig, pos = take(f, pos, Nl, (Nl,))
    p_lo = None
    if lay.has_lo:
        p_lo, pos = take(f, pos, Np * 3, (Np, 3))
    ipos = 0
    p_cam, ipos = take(i, ipos, Np, (Np,))
    p_lm, ipos = take(i, ipos, Np, (Np,))
    l_cam, ipos = take(i, ipos, Nl, (Nl,))
    l_lm, ipos = take(i, ipos, Nl, (Nl,))
    bpos = 0
    pose_fixed, bpos = take(b, bpos, K, (K,))
    pose_valid, bpos = take(b, bpos, K, (K,))
    point_valid, bpos = take(b, bpos, P, (P,))
    line_valid, bpos = take(b, bpos, L, (L,))
    p_valid, bpos = take(b, bpos, Np, (Np,))
    l_valid, bpos = take(b, bpos, Nl, (Nl,))
    p_is_line = None
    if lay.has_lo:
        p_is_line, bpos = take(b, bpos, Np, (Np,))
    return BAProblem(
        T_c_w=T, pose_fixed=pose_fixed, pose_valid=pose_valid,
        points=points, point_valid=point_valid, lines_orth=orth,
        lines_scale=scale, line_valid=line_valid,
        p_cam=p_cam, p_lm=p_lm, p_uv=p_uv, p_sigma2=p_sig, p_valid=p_valid,
        l_cam=l_cam, l_lm=l_lm, l_sobs=l_sobs, l_eobs=l_eobs,
        l_sigma2=l_sig, l_valid=l_valid, p_lo=p_lo, p_is_line=p_is_line)


def bundle_adjust_packed(f: jax.Array, i: jax.Array, b: jax.Array,
                         cam: StereoCamera, cfg: BAConfig,
                         lay: ProblemLayout) -> jax.Array:
    """bundle_adjust over packed buffers; returns one f32 result buffer:
    [T' (K*16) | points' (P*3) | orth' (L*4) | p_active (Np) | l_active (Nl)]."""
    prob = unpack_problem(f, i, b, lay)
    res = bundle_adjust(prob, cam, cfg)
    if lay.plucker_io:
        # return normalized (||d||=1) world Pluecker directly — the
        # optimizer's 6-vec scale cancels in that normalization
        Lw = jax.vmap(orth_to_plucker)(res.problem.lines_orth)
        dn = jnp.maximum(jnp.linalg.norm(Lw[:, 3:], axis=-1), 1e-12)
        lines_out = (Lw / dn[:, None]).ravel()
    else:
        lines_out = res.problem.lines_orth.ravel()
    out = jnp.concatenate([
        res.problem.T_c_w.ravel(), res.problem.points.ravel(),
        lines_out,
        res.p_active.astype(jnp.float32),
        res.l_active.astype(jnp.float32),
        res.cost.astype(jnp.float32)[None]])
    return out


def unpack_result_np(out, lay: ProblemLayout):
    """Host-side split of the packed result buffer."""
    import numpy as np

    out = np.asarray(out)
    K, P, L, Np, Nl = lay.K, lay.P, lay.L, lay.Np, lay.Nl
    pos = 0
    T = out[pos: pos + K * 16].reshape(K, 4, 4); pos += K * 16
    points = out[pos: pos + P * 3].reshape(P, 3); pos += P * 3
    ld = 6 if lay.plucker_io else 4
    orth = out[pos: pos + L * ld].reshape(L, ld); pos += L * ld
    p_active = out[pos: pos + Np] > 0.5; pos += Np
    l_active = out[pos: pos + Nl] > 0.5; pos += Nl
    cost = float(out[pos])
    return T, points, orth, p_active, l_active, cost
