"""Stereo visual odometry driver — the StereoFrameHandler equivalent.

Behavioral spec: reference ``src2/stereoFrameHandler.cpp`` — initialize
(:35), insertStereoPair (:54), updateFrame incl. the adaptative FAST
protocol (:66-86), optimizePose (:307), pose chaining + covariance
composition (:385-394), needNewKF (:1465), currFrameIsKF (:1518).

Dispatch discipline (in place of the reference's thread overlap): the
per-frame hot path is exactly ONE device program — batched point AND line
detection on the stacked (2, H, W) stereo pair, stereo matching for both
modalities, f2f association, the robust GN pose solve, keyframe
statistics, and the device-side adaptative-FAST update, fused into a
single XLA program.  The chain is strictly sequential regardless
(detection N consumes state N-1's adaptative FAST threshold), so the
fused form costs nothing in overlap and keeps the host's per-frame work
to one jit call, with NO host synchronization inside the loop: all
sequential state (pose, covariances, FAST threshold, motion-model warm
start) stays on device as a VOState pytree; the host only forwards opaque
device arrays.  scripts/ab_fused_step.py times the fused step against the
two-dispatch split.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .core import lie
from .core.camera import StereoCamera
from .core.numerics import full_f32_matmuls
from .frontend import f2f
from .frontend.frame import (
    FrontendConfig,
    _match_stereo_lines,
    _match_stereo_points,
    make_batched_detectors,
)
from .frontend.features import StereoFeatures
from .frontend.tracker import TrackerConfig, optimize_pose


class FrameResult(NamedTuple):
    T_f_w: jax.Array        # camera->world pose of this frame
    DT: jax.Array           # motion: prev-frame points -> curr frame
    DT_cov: jax.Array
    err: jax.Array
    n_inliers: jax.Array
    good: jax.Array
    is_kf: jax.Array
    entropy_ratio: jax.Array


class VOState(NamedTuple):
    features: StereoFeatures
    T_f_w: jax.Array
    T_f_w_cov: jax.Array
    T_prevKF: jax.Array
    cov_prevKF_accum: jax.Array
    entropy_first: jax.Array
    frames_since_kf: jax.Array
    prev_was_kf: jax.Array
    fast_th: jax.Array      # adaptative FAST threshold (device scalar)
    prev_DT: jax.Array      # motion-model warm start
    prev_good: jax.Array


class VOParams(NamedTuple):
    """Static host-side knobs of the fused step."""

    adaptative_fast: bool = True
    fast_min_th: float = 5.0
    fast_max_th: float = 50.0
    fast_inc_th: float = 5.0
    fast_feat_th: int = 50
    fast_err_th: float = 0.5
    use_motion_model: bool = False


def _entropy(cov):
    from .core import linalg

    L = linalg.cholesky(cov + 1e-18 * jnp.eye(6, dtype=cov.dtype))
    logdet = 2.0 * jnp.sum(jnp.log(jnp.abs(jnp.diagonal(L))))
    return 3.0 * (1.0 + jnp.log(2.0 * jnp.pi)) + 0.5 * logdet


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
@full_f32_matmuls
def _match_and_track(kp_pair, seg_pair, state: VOState, cam: StereoCamera,
                     fcfg: FrontendConfig, tcfg: TrackerConfig,
                     prm: VOParams):
    """Fused per-frame program: stereo matching (points+lines) + f2f
    association + pose GN + KF statistics + adaptative-FAST update.  Full
    f32 matmuls: the GN tracker's Jacobian chains and 6x6 Hessian einsums
    lose sub-pixel pose accuracy in reduced precision."""
    (kp, pdesc) = kp_pair
    (seg, ldesc) = seg_pair
    take = lambda tree, i: jax.tree.map(lambda x: x[i], tree)
    points = _match_stereo_points(take(kp, 0), pdesc[0], take(kp, 1),
                                  pdesc[1], cam, fcfg)
    line_set = _match_stereo_lines(take(seg, 0), ldesc[0], take(seg, 1),
                                   ldesc[1], cam, fcfg)
    feats = StereoFeatures(points=points, lines=line_set)

    pts, ls, _, _ = f2f.track_frame_to_frame(state.features, feats)
    I4 = jnp.eye(4, dtype=state.T_f_w.dtype)
    DT_init = (jnp.where(state.prev_good, state.prev_DT, I4)
               if prm.use_motion_model else I4)
    est, pts_out, _ = optimize_pose(pts, ls, cam, tcfg, DT_init=DT_init)

    # pose chaining (optimizePose :385-394)
    DT_pose = lie.inv_se3(est.DT)
    T_f_w = lie.se3_chordal_project(state.T_f_w @ DT_pose)
    T_f_w = jnp.where(est.good, T_f_w, state.T_f_w)
    cov = lie.cov_compose(state.T_f_w, state.T_f_w_cov, est.cov)
    cov = jnp.where(est.good, cov, state.T_f_w_cov)

    # needNewKF (:1465)
    ent_now = _entropy(est.cov)
    entropy_first = jnp.where(
        state.prev_was_kf,
        jnp.where(jnp.isfinite(ent_now), ent_now, -9.9e8),
        state.entropy_first)
    adj = lie.adjoint_se3(state.T_prevKF)
    cov_accum = (state.cov_prevKF_accum
                 + adj @ lie.cov_Tinv(DT_pose, est.cov) @ adj.T)
    entropy_ratio = _entropy(cov_accum) / entropy_first
    dX = lie.log_se3(lie.inv_se3(T_f_w) @ state.T_prevKF)
    t_dist = jnp.linalg.norm(dX[:3])
    r_dist = jnp.linalg.norm(dX[3:]) * (180.0 / jnp.pi)
    is_kf = (
        (entropy_ratio < tcfg.min_entropy_ratio)
        | ~jnp.isfinite(entropy_ratio)
        | ~est.good
        | (t_dist > tcfg.max_kf_t_dist)
        | (r_dist > tcfg.max_kf_r_dist)
        | (state.frames_since_kf >= 10)
    )

    # adaptative FAST threshold (updateFrame :66-86), on device.
    # The reference counts POINT inliers only (n_inliers_pt).
    th = state.fast_th
    if prm.adaptative_fast:
        n = jnp.sum((pts_out.valid & pts_out.inlier).astype(jnp.int32))
        inc = prm.fast_inc_th
        feat = prm.fast_feat_th
        bad = ~est.good | (est.err > prm.fast_err_th)
        th = jnp.where(bad | (n < feat), th - 2 * inc,
                       jnp.where(n < 2 * feat, th - inc,
                                 jnp.where(n > 4 * feat, th + 2 * inc,
                                           jnp.where(n > 3 * feat, th + inc,
                                                     th))))
        th = jnp.clip(th, prm.fast_min_th, prm.fast_max_th)

    res = FrameResult(T_f_w=T_f_w, DT=est.DT, DT_cov=est.cov, err=est.err,
                      n_inliers=est.n_inliers, good=est.good, is_kf=is_kf,
                      entropy_ratio=entropy_ratio)
    new_state = VOState(
        features=feats, T_f_w=T_f_w, T_f_w_cov=cov,
        T_prevKF=state.T_prevKF, cov_prevKF_accum=cov_accum,
        entropy_first=entropy_first,
        frames_since_kf=state.frames_since_kf + 1,
        prev_was_kf=jnp.asarray(False),
        fast_th=th, prev_DT=est.DT, prev_good=est.good)
    return res, new_state


def _fresh_state(feats: StereoFeatures, fast_th: float, dtype) -> VOState:
    """Initial VOState (shared by initialize() and prewarm() so both build
    the exact same jit signature)."""
    I = jnp.eye(4, dtype=dtype)
    Z = jnp.zeros((6, 6), dtype=dtype)
    return VOState(
        features=feats, T_f_w=I, T_f_w_cov=Z, T_prevKF=I,
        cov_prevKF_accum=Z, entropy_first=jnp.asarray(-9.9e8, dtype),
        frames_since_kf=jnp.asarray(0, jnp.int32),
        prev_was_kf=jnp.asarray(True),
        fast_th=jnp.asarray(fast_th, jnp.float32),
        prev_DT=I, prev_good=jnp.asarray(False),
    )


class VisualOdometry:
    """Host-side driver; all sequential state lives on device."""

    def __init__(self, cam: StereoCamera,
                 fcfg: FrontendConfig = FrontendConfig(),
                 tcfg: TrackerConfig = TrackerConfig(),
                 dtype=jnp.float32,
                 adaptative_fast: bool = True,
                 use_motion_model: bool = False,
                 **fast_params):
        self.cam = cam
        self.fcfg = fcfg
        self.tcfg = tcfg
        self.dtype = dtype
        self.params = VOParams(adaptative_fast=adaptative_fast,
                               use_motion_model=use_motion_model,
                               **fast_params)
        self._det_pts, self._det_ls = make_batched_detectors(fcfg)
        # ONE fused detection dispatch: the point and line programs share
        # the stacked (2, H, W) input (nested jits inline into a single
        # XLA program)
        self._det_both = jax.jit(
            lambda imgs, th: (self._det_pts(imgs, th), self._det_ls(imgs)))

        def _match_pair(kp_pair, seg_pair):
            (kp, pdesc) = kp_pair
            (seg, ldesc) = seg_pair
            take = lambda tree, i: jax.tree.map(lambda x: x[i], tree)
            points = _match_stereo_points(take(kp, 0), pdesc[0], take(kp, 1),
                                          pdesc[1], cam, fcfg)
            line_set = _match_stereo_lines(take(seg, 0), ldesc[0],
                                           take(seg, 1), ldesc[1], cam, fcfg)
            return StereoFeatures(points=points, lines=line_set)

        self._match_pair = jax.jit(full_f32_matmuls(_match_pair))

        # ONE fused per-frame program: detection + stereo match + f2f +
        # GN track + KF stats.  The chain is strictly sequential anyway
        # (detection N consumes state N-1's adaptative fast_th), so
        # splitting it into two dispatches buys no pipelining.
        @full_f32_matmuls
        def _step(img_l, img_r, state: VOState):
            # the (2, H, W) stack happens INSIDE the program: an eager
            # jnp.stack would be one extra per-frame dispatch
            imgs = jnp.stack([img_l, img_r])
            kp_pair = self._det_pts(imgs, state.fast_th)
            seg_pair = self._det_ls(imgs)
            return _match_and_track.__wrapped__(
                kp_pair, seg_pair, state, cam, fcfg, tcfg, self.params)

        self._step = jax.jit(_step)
        self.state: Optional[VOState] = None

    def _extract_pair(self, img_l, img_r, fast_th):
        imgs = jnp.stack([img_l, img_r])
        kp_pair, seg_pair = self._det_both(imgs, fast_th)
        return kp_pair, seg_pair

    def _extract(self, img_l, img_r, fast_th=None):
        """Full StereoFeatures extraction (used at init / by the mapper)."""
        th = jnp.asarray(self.fcfg.fast_th if fast_th is None else fast_th,
                         jnp.float32)
        kp_pair, seg_pair = self._extract_pair(img_l, img_r, th)
        return self._match_pair(kp_pair, seg_pair)

    def initialize(self, img_l, img_r) -> StereoFeatures:
        feats = self._extract(img_l, img_r)
        self.state = _fresh_state(feats, self.fcfg.fast_th, self.dtype)
        return feats

    def prewarm(self, img_shape, img_dtype=jnp.float32, progress=None):
        """Compile the whole per-frame pipeline AHEAD of the first frame,
        with the four programs (point detector, line detector, stereo
        matcher, fused match+track) compiling CONCURRENTLY — XLA releases
        the GIL, so the cold-cache wall drops from the sum of the four
        compiles to roughly the slowest one.  Shapes come from
        jax.eval_shape (no device work), so this costs zero FLOPs and
        populates both the in-process executable cache and the persistent
        compilation cache.  ``progress`` is an optional callable fed
        one-line status strings (driver liveness)."""
        import concurrent.futures as cf

        say = progress or (lambda s: None)
        imgs = jax.ShapeDtypeStruct((2, *img_shape), img_dtype)
        th = jax.ShapeDtypeStruct((), jnp.float32)
        kp, seg = jax.eval_shape(self._det_both, imgs, th)
        feats = jax.eval_shape(self._match_pair, kp, seg)
        state = jax.eval_shape(
            lambda f: _fresh_state(f, self.fcfg.fast_th, self.dtype), feats)
        jobs = [
            ("fused point+line detector",
             lambda: self._det_both.lower(imgs, th).compile()),
            ("stereo matcher",
             lambda: self._match_pair.lower(kp, seg).compile()),
            ("fused frame step (detect+match+track)",
             lambda: self._step.lower(
                 jax.ShapeDtypeStruct(img_shape, img_dtype),
                 jax.ShapeDtypeStruct(img_shape, img_dtype),
                 state).compile()),
        ]
        with cf.ThreadPoolExecutor(len(jobs)) as ex:
            futs = {ex.submit(fn): name for name, fn in jobs}
            for f in cf.as_completed(futs):
                f.result()
                say(f"compiled: {futs[f]}")

    def process(self, img_l, img_r) -> FrameResult:
        """Track one new stereo pair (ONE device dispatch, no host sync).
        Call ``mark_keyframe()`` afterwards if the mapping layer accepted
        the KF (currFrameIsKF :1518 semantics)."""
        assert self.state is not None, "call initialize() first"
        res, new_state = self._step(img_l, img_r, self.state)
        self.state = new_state
        return res

    def mark_keyframe(self):
        """Reset the KF statistics after the mapping layer inserts a KF."""
        st = self.state
        Z = jnp.zeros((6, 6), dtype=self.dtype)
        self.state = st._replace(
            T_prevKF=st.T_f_w, cov_prevKF_accum=Z,
            frames_since_kf=jnp.asarray(0, jnp.int32),
            prev_was_kf=jnp.asarray(True),
        )

    @property
    def current_features(self) -> StereoFeatures:
        return self.state.features

    @property
    def pose(self):
        return self.state.T_f_w
