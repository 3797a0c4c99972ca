"""Unified configuration tree, YAML-compatible with the reference.

Behavioral spec: reference ``src2/config.cpp`` (Config singleton, ~50 keys,
defaults :36-113, loader :132-206) and ``src/slamConfig.cpp`` (SlamConfig
subclass, ~30 SLAM keys, defaults :43-86).  The same YAML files the
reference ships (config/config/config_euroc.yaml etc.) load here: every
key name is preserved; unknown keys are ignored with a warning, missing
keys keep the reference default (the loadSafe protocol).

The dataclasses fan out into the typed per-subsystem configs
(FrontendConfig, TrackerConfig, BAConfig, ...) consumed by the jitted code.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class PLSLAMConfig:
    # kf decision (config.cpp:38-41)
    min_entropy_ratio: float = 0.85
    max_kf_t_dist: float = 5.0
    max_kf_r_dist: float = 15.0
    # StVO options (:44-52)
    has_points: bool = True
    has_lines: bool = True
    use_fld_lines: bool = False
    lr_in_parallel: bool = True
    pl_in_parallel: bool = True
    best_lr_matches: bool = True
    adaptative_fast: bool = True
    use_motion_model: bool = False
    # point tracking (:56-59)
    max_dist_epip: float = 1.0
    min_disp: float = 1.0
    min_ratio_12_p: float = 0.9
    # line tracking (:61-68)
    line_sim_th: float = 0.75
    stereo_overlap_th: float = 0.75
    f2f_overlap_th: float = 0.75
    min_line_length: float = 0.025
    line_horiz_th: float = 0.1
    min_ratio_12_l: float = 0.9
    ls_min_disp_ratio: float = 0.7
    # adaptative FAST (:71-75)
    fast_min_th: int = 5
    fast_max_th: int = 50
    fast_inc_th: int = 5
    fast_feat_th: int = 50
    fast_err_th: float = 0.5
    # optimization (:79-86)
    homog_th: float = 1e-7
    min_features: int = 10
    max_iters: int = 5
    max_iters_ref: int = 10
    min_error: float = 1e-7
    min_error_change: float = 1e-7
    inlier_k: float = 4.0
    # matching (:90-92).  matching_strategy (0 = pure descriptor, 1 =
    # window + descriptor) is parsed by the reference (config.cpp:90,:184)
    # but never read by any of its code paths — dead upstream, parsed here
    # for YAML compatibility only.  This build always uses windowed +
    # descriptor matching with a global fallback (ops/matching.py).
    matching_strategy: int = 0
    matching_s_ws: int = 10
    matching_f2f_ws: int = 3
    # ORB (:95-102).  orb_wta_k is parsed by the reference
    # (config.cpp:99,:192) but never forwarded to cv::ORB::create — dead
    # upstream; the descriptor here is fixed 2-point steered BRIEF
    # (ops/orb.py), matching OpenCV's WTA_K=2 default.
    orb_nfeatures: int = 1200
    orb_scale_factor: float = 1.2
    orb_nlevels: int = 4
    orb_edge_th: int = 19
    orb_wta_k: int = 2
    orb_score: int = 1
    orb_patch_size: int = 31
    orb_fast_th: int = 20
    # LSD (:104-113)
    # lsd_nfeatures/min_line_length/lsd_ang_th map onto the tile-parallel
    # detector (ops/lines.py).  lsd_refine / lsd_scale / lsd_sigma_scale /
    # lsd_quant / lsd_log_eps / lsd_density_th / lsd_n_bins parameterize
    # the reference LSD's NFA region grower (LSDDetector_custom.cpp) and
    # have NO analog in the reformulated detector — parsed for YAML
    # compatibility, intentionally unused (the detector's own knobs live
    # in ops/lines.LineDetectorConfig).
    lsd_nfeatures: int = 300
    lsd_refine: int = 0
    lsd_scale: float = 1.2
    lsd_sigma_scale: float = 0.6
    lsd_quant: float = 2.0
    lsd_ang_th: float = 22.5
    lsd_log_eps: float = 1.0
    lsd_density_th: float = 0.6
    lsd_n_bins: int = 1024
    # ---- SLAM tier (slamConfig.cpp:43-86) ----
    fast_matching: bool = False
    has_refinement: bool = False
    multithread_slam: bool = True
    min_lm_obs: int = 5
    max_common_fts_kf: float = 0.9
    max_kf_epip_p: float = 1.0
    max_kf_epip_l: float = 1.0
    max_point_point_error: float = 0.1
    max_point_line_error: float = 0.1
    max_dir_line_error: float = 0.1
    min_lm_ess_graph: int = 150
    min_lm_cov_graph: int = 75
    min_kf_local_map: int = 3
    lambda_lba_lm: float = 1e-5
    lambda_lba_k: float = 10.0
    max_iters_lba: int = 15
    vocabulary_p: str = ""
    vocabulary_l: str = ""
    vocab_refresh_kfs: int = 50  # retrain online vocab every N KFs (0 = once)
    # checkpointing (not in the reference; SURVEY.md §5 restartability)
    checkpoint_every_kf: int = 0   # 0 = off
    checkpoint_dir: str = "checkpoints"
    # live scene export: rewrite a self-contained WebGL HTML of the map
    # every N keyframes (slamScene updateSceneSafe per-KF cadence,
    # src/slamScene.cpp — a growing file the user can reload mid-run,
    # the batch-environment analog of the MRPT live window).  0 = off.
    viz_every_kf: int = 0
    viz_path: str = "scene.html"
    # per-frame diagnosis overlays (plotStereoFrame /
    # plotStereoFrameProjerr analogs, stereoFrame.cpp:655,
    # stereoFrameHandler.cpp:1615): every N frames, render the tracked
    # features + f2f match segments + per-feature residual ramp onto the
    # left frame (PNG) and append a per-feature residual JSONL record.
    # 0 = off (the overlay recomputes the association for that frame and
    # costs one small fetch — a debug feature).
    overlay_every: int = 0
    overlay_dir: str = "overlays"

    lc_res: float = 1.0
    lc_unc: float = 0.01
    lc_inl: float = 0.3
    lc_trs: float = 1.5
    lc_rot: float = 35.0
    max_iters_pgo: int = 100
    lc_kf_dist: int = 50
    lc_kf_max_dist: int = 50
    lc_nkf_closest: int = 4
    lc_inlier_ratio: float = 30.0
    min_pt_matches: int = 10
    min_ls_matches: int = 6
    kf_inlier_ratio: float = 30.0
    # Pluecker mode toggle (USE_LINE_PLUKER compile flag in the reference;
    # a runtime switch here).  NOTE: loop closure must stay disabled in
    # Pluecker mode (README.md:12) — enforced in pipeline construction.
    use_line_plucker: bool = True
    use_loop_closure: bool = False

    @classmethod
    def from_yaml(cls, path: str) -> "PLSLAMConfig":
        import yaml  # only YAML loading needs it

        cfg = cls()
        with open(path) as f:
            # yaml-cpp (the reference's loader) tolerates literal TABs as
            # whitespace — config/config/config.yaml ships with one — but
            # strict YAML forbids them; normalize for interchange
            data = yaml.safe_load(f.read().replace("\t", " ")) or {}
        names = {f.name for f in dataclasses.fields(cls)}
        for k, v in data.items():
            if k in names:
                setattr(cfg, k, v)
        return cfg

    # ---- fan-out into the typed jit-side configs ----

    def frontend(self, image_max_dim: int = 752):
        from .frontend.frame import FrontendConfig

        cell = image_max_dim / 64.0  # GRID_COLS (stereoFrame.h:52)
        return FrontendConfig(
            n_points=self.orb_nfeatures,
            n_lines=max(64, (self.lsd_nfeatures + 63) // 64 * 64),
            n_levels=self.orb_nlevels,
            scale_factor=self.orb_scale_factor,
            fast_th=float(self.orb_fast_th),
            edge_th=self.orb_edge_th,
            max_dist_epip=self.max_dist_epip,
            min_disp=self.min_disp,
            nnr=self.min_ratio_12_p,
            stereo_window=self.matching_s_ws * cell,
            stereo_row_tol=max(self.max_dist_epip, cell * 0.85),
            line_sim_th=self.line_sim_th,
            line_horiz_th=self.line_horiz_th,
            ls_min_disp_ratio=self.ls_min_disp_ratio,
            stereo_overlap_th=self.stereo_overlap_th,
            min_line_length_frac=self.min_line_length,
            line_window=self.matching_s_ws * cell,
            line_orient_bins=min(32, max(8, round(360.0 / max(
                self.lsd_ang_th, 1e-6)))),
        )

    def tracker(self):
        from .frontend.tracker import TrackerConfig

        return TrackerConfig(
            max_iters=self.max_iters,
            max_iters_ref=self.max_iters_ref,
            min_error=self.min_error,
            min_error_change=self.min_error_change,
            inlier_k=self.inlier_k,
            min_features=self.min_features,
            use_lines=self.has_lines,
            use_points=self.has_points,
            plucker_lines=self.use_line_plucker,
            min_entropy_ratio=self.min_entropy_ratio,
            max_kf_t_dist=self.max_kf_t_dist,
            max_kf_r_dist=self.max_kf_r_dist,
        )

    def map_cfg(self):
        from .backend.mapping import MapConfig

        return MapConfig(
            min_lm_obs=self.min_lm_obs,
            min_lm_cov_graph=self.min_lm_cov_graph,
            min_kf_local_map=self.min_kf_local_map,
            max_kf_epip_p=self.max_kf_epip_p,
            max_kf_epip_l=self.max_kf_epip_l,
            nnr=self.min_ratio_12_p,
            use_lines=self.has_lines,
            plucker_lines=self.use_line_plucker,
            min_pt_matches=self.min_pt_matches,
            max_common_fts_kf=self.max_common_fts_kf,
            has_refinement=self.has_refinement,
            kf_inlier_ratio=self.kf_inlier_ratio,
            min_features=self.min_features,
        )

    def loop_cfg(self):
        from .backend.loop import LoopConfig

        return LoopConfig(
            lc_kf_dist=self.lc_kf_dist,
            lc_nkf_closest=self.lc_nkf_closest,
            lc_res=self.lc_res,
            lc_unc=self.lc_unc,
            lc_trs=self.lc_trs,
            lc_rot=self.lc_rot,
            min_pt_matches=self.min_pt_matches,
            min_ls_matches=self.min_ls_matches,
            lc_inlier_ratio=self.lc_inlier_ratio,
            lc_kf_max_dist=self.lc_kf_max_dist,
            vocabulary_file=self.vocabulary_p,
            vocabulary_file_l=self.vocabulary_l,
            vocab_refresh_kfs=self.vocab_refresh_kfs,
            pgo_iters=min(self.max_iters_pgo, 25),
            fuse_dist=self.max_point_point_error,
            fuse_dist_pl=self.max_point_line_error,
            fuse_dist_dir=self.max_dir_line_error,
        )

    def ba(self):
        from .backend.ba import BAConfig

        return BAConfig(
            iters1=5,
            iters2=self.max_iters_lba - 5,
            lambda_init=self.lambda_lba_lm,
            lambda_factor=self.lambda_lba_k,
        )
