"""Full SLAM pipeline: tracking front-end + mapping back-end + global BA.

Behavioral spec: reference ``app/plslam_dataset.cpp`` main loop (:43-194):
per frame — insertStereoPair, optimizePose, needNewKF -> KeyFrame ->
MapHandler::addKeyFrame; at the end — finishSLAM, globalBundleAdjustment
(:169-176), SaveKeyFrameTrajectoryTUM.

The reference couples Pluecker mode with a disabled loop-closure thread
(README.md:12, mapHandler.cpp:1221-1226); the config system enforces the
same coupling here.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from .backend import ba as ba_mod
from .backend.mapping import MapConfig, MapHandler
from .config import PLSLAMConfig
from .core.camera import StereoCamera
from .io.trajectory import save_tum
from .vo import VisualOdometry


@dataclass
class FrameLog:
    """Structured per-frame metrics (replaces the reference's cout logging,
    SURVEY.md §5 observability)."""

    frame: int
    t_total: float
    n_inliers: int
    err: float
    good: bool
    is_kf: bool
    entropy_ratio: float


class PLSLAM:
    def __init__(self, cam: StereoCamera, config: PLSLAMConfig | None = None,
                 map_cfg: MapConfig | None = None):
        self.config = config or PLSLAMConfig()
        if self.config.use_line_plucker and self.config.use_loop_closure:
            # README.md:12 — loop closing must stay disabled in Pluecker mode
            raise ValueError(
                "loop closure cannot be enabled in Pluecker line mode "
                "(reference constraint, README.md:12); set "
                "use_line_plucker=False for the loop-closure baseline")
        self.cam = cam
        width = int(cam.width)
        self.vo = VisualOdometry(
            cam, self.config.frontend(max(width, int(cam.height))),
            self.config.tracker())
        mcfg = map_cfg or MapConfig(
            use_lines=self.config.has_lines,
            plucker_lines=self.config.use_line_plucker,
            min_lm_obs=self.config.min_lm_obs,
            min_lm_cov_graph=self.config.min_lm_cov_graph,
            min_kf_local_map=self.config.min_kf_local_map,
            has_refinement=self.config.has_refinement,
            min_pt_matches=self.config.min_pt_matches,
        )
        self.mapper = MapHandler(cam, mcfg, self.config.ba(),
                         tracker_cfg=self.config.tracker())
        self.loop_closer = None
        if self.config.use_loop_closure:
            from .backend.loop import LoopCloser

            self.loop_closer = LoopCloser(cam, self.mapper,
                                          self.config.loop_cfg())
        self.loop_reports: list[dict] = []
        self.logs: list[FrameLog] = []
        self.kf_timestamps: list[float] = []
        self._frame_idx = 0
        self._initialized = False
        self._T_anchor = np.eye(4)

        # multithread mode (SlamConfig::multithreadSLAM, default true):
        # mapping runs on a worker thread fed by a KF queue, overlapping
        # the back-end's BA with the front-end's next-frame dispatches —
        # the analog of the reference's handler + local-mapping threads
        # (mapHandler.cpp:1143-1248).  JAX dispatch is thread-safe; the
        # mapper's state is touched only by the worker, and the tracker
        # never reads the map, so the only shared structure is the queue.
        self._kf_queue: queue.Queue | None = None
        self._map_thread: threading.Thread | None = None
        self._map_errors: list[BaseException] = []
        # dedicated loop-closure worker (the reference's loop-closure
        # thread, mapHandler.cpp:1302-1386): BoW encoding + candidate
        # verification must not hold up the bounded KF queue, or a loop
        # event back-pressures the tracker through the mapping worker
        self._lc_queue: queue.Queue | None = None
        self._lc_thread: threading.Thread | None = None
        if self.config.multithread_slam:
            # bounded: the device executes dispatches FIFO, so an unbounded
            # tracker run-ahead makes every mapping fetch wait behind the
            # queued VO work of all the frames in between (measured ~2x on
            # the KF-every-frame stress bench); maxsize=2 keeps tracking
            # and mapping overlapped without the pile-up
            self._kf_queue = queue.Queue(maxsize=2)
            self._map_thread = threading.Thread(
                target=self._mapping_worker, name="plslam-mapper",
                daemon=True)
            self._map_thread.start()
            if self.loop_closer is not None:
                self._lc_queue = queue.Queue()
                self._lc_thread = threading.Thread(
                    target=self._lc_worker, name="plslam-loopcloser",
                    daemon=True)
                self._lc_thread.start()

    # -- mapping thread ----------------------------------------------------

    def _mapping_worker(self):
        """Pop (pose, features) jobs until the None sentinel
        (mapHandler.cpp:1229-1248 finishSLAM semantics)."""
        while True:
            job = self._kf_queue.get()
            try:
                if job is None:
                    return
                pose, feats = job
                self._insert_keyframe(pose, feats)
            except BaseException as e:  # surfaced at finish()
                self._map_errors.append(e)
            finally:
                self._kf_queue.task_done()

    def _lc_worker(self):
        """Pop keyframe ids until the None sentinel; detection and
        verification run lock-free on immutable KF feature arrays, only a
        successful closure's correction takes the map lock (loop.py
        on_new_keyframe)."""
        while True:
            kf_id = self._lc_queue.get()
            try:
                if kf_id is None:
                    return
                report = self.loop_closer.on_new_keyframe(kf_id)
                if report:
                    self.loop_reports.append(report)
            except BaseException as e:  # surfaced at finish()
                self._map_errors.append(e)
            finally:
                self._lc_queue.task_done()

    def _insert_keyframe(self, pose, feats):
        # defer_ba: the local-BA fetch + write-back overlaps the NEXT
        # keyframe's association (one combined sync), the pipeline analog
        # of the reference's LBA thread lag (mapHandler.cpp:1251-1300)
        self.mapper.add_keyframe(pose, feats, defer_ba=True)
        if (self.config.viz_every_kf > 0
                and len(self.mapper.map.keyframes)
                % self.config.viz_every_kf == 0):
            # live scene export at KF cadence (slamScene updateSceneSafe
            # analog): rewrite the self-contained HTML; runs on the
            # mapping worker so it never blocks tracking.  The map lock
            # keeps the export from reading a half-applied loop-closure
            # correction (the LC worker rewrites every pose under it).
            from .viz_scene import export_scene_html

            try:
                with self.mapper._map_lock:
                    export_scene_html(self.mapper, self.config.viz_path)
            except Exception:   # viz must never kill the mapping worker
                pass
        if self.loop_closer is not None:
            kf_id = len(self.mapper.map.keyframes) - 1
            if self._lc_queue is not None:
                self._lc_queue.put(kf_id)
            else:
                report = self.loop_closer.on_new_keyframe(kf_id)
                if report:
                    self.loop_reports.append(report)

    def insert_keyframe_features(self, pose: np.ndarray, feats,
                                 timestamp: float = 0.0):
        """Feature-level keyframe insertion (replay / simulation path):
        push a (pose, StereoFeatures) pair through the SAME queue + worker
        as live tracking, bypassing image extraction.  Lets large-scale
        synthetic sequences exercise the threaded mapping back-end and
        loop closer exactly as a live run would."""
        self.kf_timestamps.append(timestamp)
        if len(self.mapper.map.keyframes) == 0:
            self.mapper.initialize(np.asarray(pose, np.float64), feats)
            if self.loop_closer is not None:
                if self._lc_queue is not None:
                    self._lc_queue.put(0)
                else:
                    self.loop_closer.on_new_keyframe(0)
            return
        job = (np.asarray(pose, np.float64), feats)
        if self._kf_queue is not None:
            self._kf_queue.put(job)
        else:
            self._insert_keyframe(*job)

    def wait_until_idle(self):
        """Block until the mapping and loop-closure queues have drained
        (for tests and for callers that read the map mid-run)."""
        if self._kf_queue is not None:
            self._kf_queue.join()
        if self._lc_queue is not None:
            self._lc_queue.join()
        # apply any deferred local-BA result so readers see a consistent map
        self.mapper.flush_ba()

    # -- per-frame ---------------------------------------------------------

    @staticmethod
    @jax.jit
    def _pack_frame_scalars(res):
        """One (21,) f32 fetch for everything the host needs per frame:
        one device round trip instead of five scalar fetches."""
        return jnp.concatenate([
            jnp.stack([res.is_kf.astype(jnp.float32),
                       res.n_inliers.astype(jnp.float32),
                       res.err.astype(jnp.float32),
                       res.good.astype(jnp.float32),
                       res.entropy_ratio.astype(jnp.float32)]),
            res.T_f_w.reshape(-1).astype(jnp.float32)])

    def process(self, img_l, img_r, timestamp: float = 0.0):
        t0 = time.time()
        il = jnp.asarray(img_l, jnp.float32)
        ir = jnp.asarray(img_r, jnp.float32)
        if not self._initialized:
            feats = self.vo.initialize(il, ir)
            if len(self.mapper.map.keyframes) == 0:
                self.mapper.initialize(np.eye(4), feats)
            else:
                # resume from a checkpoint: anchor the fresh VO chain at
                # the last restored keyframe (auto-checkpoints are cut at
                # KF cadence, so the next dataset frame continues there)
                # and let this frame extend the map as a new keyframe
                self._T_anchor = self.mapper.map.keyframes[-1].T_w_k.copy()
                job = (self._T_anchor.copy(), feats)
                if self._kf_queue is not None:
                    self._kf_queue.put(job)
                else:
                    self._insert_keyframe(*job)
            self.kf_timestamps.append(timestamp)
            self._initialized = True
            self._frame_idx += 1
            return None
        prev_feats = (self.vo.current_features
                      if self.config.overlay_every > 0 else None)
        res = self.vo.process(il, ir)
        sc = np.asarray(self._pack_frame_scalars(res))
        is_kf = bool(sc[0] > 0.5)
        if (self.config.overlay_every > 0
                and self._frame_idx % self.config.overlay_every == 0):
            self._render_overlay(il, prev_feats, res)
        if is_kf:
            pose = self._T_anchor @ sc[5:21].reshape(4, 4).astype(np.float64)
            feats = self.vo.current_features
            self.vo.mark_keyframe()
            self.kf_timestamps.append(timestamp)
            if self._kf_queue is not None:
                self._kf_queue.put((pose, feats))
            else:
                self._insert_keyframe(pose, feats)
            if self.config.checkpoint_every_kf > 0:
                self.maybe_autocheckpoint()
        self.logs.append(FrameLog(
            frame=self._frame_idx, t_total=time.time() - t0,
            n_inliers=int(sc[1]), err=float(sc[2]),
            good=bool(sc[3] > 0.5), is_kf=is_kf,
            entropy_ratio=float(sc[4])))
        self._frame_idx += 1
        return res

    def _render_overlay(self, il, prev_feats, res):
        """Per-frame diagnosis overlay + residual dump (viz_frame).  Never
        lets a viz failure kill tracking."""
        try:
            from . import viz_frame

            diag = viz_frame.compute_frame_diagnostics(
                prev_feats, self.vo.current_features, res.DT, self.cam,
                self.config.tracker())
            d = self.config.overlay_dir
            viz_frame.render_frame_overlay(
                np.asarray(il), diag,
                os.path.join(d, f"overlay_{self._frame_idx:06d}.png"),
                frame_id=self._frame_idx)
            viz_frame.dump_residuals_jsonl(
                diag, os.path.join(d, "residuals.jsonl"), self._frame_idx)
        except Exception:
            import logging

            logging.getLogger(__name__).exception("overlay render failed")

    # -- end of run --------------------------------------------------------

    def finish(self, run_gba: bool = True, mesh=None):
        """finishSLAM + globalBundleAdjustment (app:169-176): drain and
        join the mapping thread, then run the final global solve (on
        ``mesh`` when one is passed — see global_bundle_adjustment)."""
        if self._map_thread is not None:
            self._kf_queue.put(None)
            self._map_thread.join()
            self._map_thread = None
            self._kf_queue = None
        if self._lc_thread is not None:
            self._lc_queue.put(None)
            self._lc_thread.join()
            self._lc_thread = None
            self._lc_queue = None
        if self._map_errors:
            raise self._map_errors[0]
        if run_gba and len(self.mapper.map.keyframes) >= 3:
            self.global_bundle_adjustment(mesh=mesh)
        return self.keyframe_trajectory()

    def global_bundle_adjustment(self, mesh=None):
        """GBA over all KFs and ALL landmarks with no silent truncation
        (mapHandler.cpp globalBundleAdjustment :3022).

        Single-chip: tiled in fixed-shape landmark chunks with accumulated
        Schur reduction.  With a multi-device ``jax.sharding.Mesh``: the
        same chunked solve sharded over the mesh along the keyframe-block
        (sequence/"SP") axis, psum-combining the reduced camera system per
        LM iteration — algebraically identical to the single-chip solve
        (parallel/dist_gba.py, BASELINE config 5)."""
        if mesh is not None and mesh.devices.size > 1:
            from .parallel.dist_gba import (
                distributed_global_bundle_adjustment)
            return distributed_global_bundle_adjustment(self.mapper, mesh)
        return self.mapper.global_bundle_adjustment()

    def keyframe_trajectory(self):
        return self.mapper.keyframe_trajectory()

    def save_trajectory_tum(self, path: str):
        """TUM t x y z qx qy qz qw per keyframe
        (SaveKeyFrameTrajectoryTUM :5818)."""
        save_tum(path, self.kf_timestamps, self.keyframe_trajectory())

    # -- checkpoint / resume (SURVEY.md §5: absent in the reference) ------

    def save_checkpoint(self, path: str):
        """Serialize the full map state; safe mid-run (drains the mapping
        queue first so the worker isn't mutating the map)."""
        from .io.checkpoint import save_map

        self.wait_until_idle()
        save_map(path, self.mapper, loop_closer=self.loop_closer)

    def load_checkpoint(self, path: str):
        """Restore map state into this pipeline's mapper (resume / offline
        GBA on a saved map)."""
        from .io.checkpoint import load_map

        self.wait_until_idle()
        load_map(path, self.mapper, loop_closer=self.loop_closer)
        # the next processed frame re-initializes VO anchored at the last
        # restored KF (live continuation); offline GBA/trajectory queries
        # work immediately
        self._initialized = False

    def maybe_autocheckpoint(self):
        # cadence from the front-end's accepted-KF count (the mapper's
        # count lags behind the worker thread); the filename is taken
        # AFTER save_checkpoint drains the queue so it matches the state
        n = len(self.kf_timestamps)
        if self.config.checkpoint_every_kf > 0 and n > 0 \
                and n % self.config.checkpoint_every_kf == 0:
            import os

            os.makedirs(self.config.checkpoint_dir, exist_ok=True)
            self.wait_until_idle()
            self.save_checkpoint(os.path.join(
                self.config.checkpoint_dir,
                f"map_kf{len(self.mapper.map.keyframes):05d}.npz"))

    def save_logs_jsonl(self, path: str):
        """Per-frame structured metrics as JSON lines (SURVEY.md §5: the
        observability the reference's cout logging lacked)."""
        import json

        with open(path, "w") as f:
            for log in self.logs:
                f.write(json.dumps(vars(log)) + "\n")
