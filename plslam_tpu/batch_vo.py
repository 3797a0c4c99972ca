"""Batched multi-sequence visual odometry — the data-parallel front-end.

The reference tracks one stereo stream on CPU threads; on an accelerator
the natural scaling axis for offline/production workloads is the
*sequence batch*: B independent stereo streams tracked in lockstep by
vmapping the entire per-frame program (detection, stereo matching, f2f
association, robust GN, keyframe statistics) over a leading sequence axis.
One device then amortizes every kernel across B streams; across devices,
shard the batch axis over a mesh with jax.sharding (SURVEY.md §2.4:
"DP = per-frame / per-feature batching").

Semantics per stream are EXACTLY VisualOdometry's: the same functions are
reused under vmap / flat image batching, so a batch reproduces the scalar
pipeline to f32 accumulation noise (test_batch_vo.py asserts this).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from .core.camera import StereoCamera
from .core.numerics import full_f32_matmuls
from .frontend.frame import (FrontendConfig, _match_stereo_lines,
                             _match_stereo_points, _pairs,
                             make_batched_detectors, make_sharded_detectors)
from .frontend.features import StereoFeatures
from .frontend.tracker import TrackerConfig
from .vo import VOParams, VOState, _match_and_track


class BatchedVisualOdometry:
    """Track B independent stereo sequences in lockstep.

    process() takes (B, H, W) left/right images and returns a FrameResult
    whose leaves carry a leading (B,) axis.  To distribute across chips,
    pass ``sharding`` (a NamedSharding over the batch axis); images and
    state stay placed on it and XLA partitions every kernel.
    """

    def __init__(self, batch: int, cam: StereoCamera,
                 fcfg: FrontendConfig = FrontendConfig(),
                 tcfg: TrackerConfig = TrackerConfig(),
                 dtype=jnp.float32,
                 adaptative_fast: bool = True,
                 use_motion_model: bool = False,
                 sharding=None):
        self.B = batch
        self.cam = cam
        self.fcfg = fcfg
        self.tcfg = tcfg
        self.dtype = dtype
        self.sharding = sharding
        self.params = VOParams(adaptative_fast=adaptative_fast,
                               use_motion_model=use_motion_model)
        det_pts, det_ls = make_batched_detectors(fcfg)
        # Detection runs as ONE flat (2B, H, W) batch program — the same
        # formulation the sharded per-device path uses — in one dispatch
        # for the whole batch.  Under a mesh sharding the batch axis must
        # stay partitioned, so each device runs that program on its local
        # sub-batch (make_sharded_detectors).
        self._det_both_flat = jax.jit(lambda imgs, th: (
            _pairs(det_pts, imgs, jnp.repeat(th, 2)),
            _pairs(det_ls, imgs)))
        if sharding is not None:
            self._det_pts_v, self._det_ls_v = make_sharded_detectors(
                fcfg, sharding)
        else:
            self._det_pts_v = self._det_ls_v = None

        def _match_pair(kp_pair, seg_pair):
            (kp, pdesc) = kp_pair
            (seg, ldesc) = seg_pair
            take = lambda tree, i: jax.tree.map(lambda x: x[i], tree)
            points = _match_stereo_points(take(kp, 0), pdesc[0], take(kp, 1),
                                          pdesc[1], cam, fcfg)
            line_set = _match_stereo_lines(take(seg, 0), ldesc[0],
                                           take(seg, 1), ldesc[1], cam, fcfg)
            return StereoFeatures(points=points, lines=line_set)

        self._match_pair = jax.jit(full_f32_matmuls(jax.vmap(_match_pair)))
        self._step = jax.jit(
            jax.vmap(functools.partial(
                _match_and_track.__wrapped__,  # un-jitted body
                cam=cam, fcfg=fcfg, tcfg=tcfg, prm=self.params),
                in_axes=(0, 0, 0)))
        self.state: Optional[VOState] = None

    def _place(self, x):
        return x if self.sharding is None else jax.device_put(x, self.sharding)

    def _detect(self, imgs, th):
        if self.sharding is not None:
            return self._det_pts_v(imgs, th), self._det_ls_v(imgs)
        return self._det_both_flat(imgs, th)

    def _stack(self, img_l, img_r):
        imgs = jnp.stack([jnp.asarray(img_l, self.dtype),
                          jnp.asarray(img_r, self.dtype)], axis=1)
        assert imgs.shape[0] == self.B, (imgs.shape, self.B)
        return self._place(imgs)

    def initialize(self, img_l, img_r) -> StereoFeatures:
        """img_l/img_r: (B, H, W) first frames of every sequence."""
        imgs = self._stack(img_l, img_r)
        th0 = jnp.full((self.B,), self.fcfg.fast_th, jnp.float32)
        kp_pair, seg_pair = self._detect(imgs, th0)
        feats = self._match_pair(kp_pair, seg_pair)
        B = self.B
        I = jnp.broadcast_to(jnp.eye(4, dtype=self.dtype), (B, 4, 4))
        Z = jnp.zeros((B, 6, 6), self.dtype)
        self.state = VOState(
            features=feats, T_f_w=I, T_f_w_cov=Z, T_prevKF=I,
            cov_prevKF_accum=Z,
            entropy_first=jnp.full((B,), -9.9e8, self.dtype),
            frames_since_kf=jnp.zeros((B,), jnp.int32),
            prev_was_kf=jnp.ones((B,), bool),
            fast_th=jnp.full((B,), self.fcfg.fast_th, jnp.float32),
            prev_DT=I, prev_good=jnp.zeros((B,), bool),
        )
        return feats

    def process(self, img_l, img_r):
        """One tracking step for every sequence; (B,)-leading FrameResult."""
        assert self.state is not None, "call initialize() first"
        imgs = self._stack(img_l, img_r)
        kp_pair, seg_pair = self._detect(imgs, self.state.fast_th)
        res, new_state = self._step(kp_pair, seg_pair, self.state)
        self.state = new_state
        return res

    def mark_keyframe(self, mask):
        """Reset KF statistics for the sequences where ``mask`` is True."""
        st = self.state
        m = jnp.asarray(mask)
        Z = jnp.zeros_like(st.cov_prevKF_accum)
        sel = lambda new, old: jnp.where(
            m.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)
        self.state = st._replace(
            T_prevKF=sel(st.T_f_w, st.T_prevKF),
            cov_prevKF_accum=sel(Z, st.cov_prevKF_accum),
            frames_since_kf=sel(jnp.zeros_like(st.frames_since_kf),
                                st.frames_since_kf),
            prev_was_kf=sel(jnp.ones_like(st.prev_was_kf), st.prev_was_kf),
        )
