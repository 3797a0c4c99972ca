"""IO-layer tests: ground-truth parsing (against the reference's shipped
EuRoC data), TUM round trip, timestamp association."""

import os

import numpy as np
import pytest

from plslam_tpu.io.euroc import load_groundtruth
from plslam_tpu.io.trajectory import (
    associate_timestamps,
    ate_rmse,
    rotation_to_quat,
    save_tum,
    umeyama_alignment,
)

REF_GT = "/root/reference/config/asl/gt-ass/mh_01/groundtruth.txt"
# value-compatible mirrors of the reference's config YAMLs
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


@pytest.mark.skipif(not os.path.exists(REF_GT), reason="reference data absent")
def test_parse_reference_groundtruth():
    t, pos = load_groundtruth(REF_GT)
    assert pos.shape[1] == 3
    assert len(pos) > 100
    # EuRoC MH_01 spans tens of meters
    extent = pos.max(0) - pos.min(0)
    assert extent.max() > 5.0


def test_umeyama_recovers_rigid_transform():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 3))
    ang = 0.7
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]])
    t = np.array([1.0, -2.0, 0.5])
    y = (R @ x.T).T + t
    s, R2, t2 = umeyama_alignment(x, y)
    np.testing.assert_allclose(R2, R, atol=1e-10)
    np.testing.assert_allclose(t2, t, atol=1e-10)
    assert ate_rmse(x, y, align=True) < 1e-10


def test_quat_roundtrip():
    rng = np.random.default_rng(1)
    for _ in range(5):
        v = rng.normal(size=3)
        ang = np.linalg.norm(v)
        axis = v / ang
        K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]])
        R = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
        q = rotation_to_quat(R)
        np.testing.assert_allclose(np.linalg.norm(q), 1.0, atol=1e-12)


def test_tum_save_format(tmp_path):
    poses = [np.eye(4), np.eye(4)]
    poses[1][:3, 3] = [1, 2, 3]
    p = tmp_path / "t.txt"
    save_tum(str(p), [0.0, 0.1], poses)
    rows = [l.split() for l in open(p).read().splitlines()]
    assert len(rows) == 2 and len(rows[0]) == 8
    assert float(rows[1][1]) == 1.0


def test_associate_timestamps():
    t_est = [0.0, 1.0, 2.0, 3.0]
    t_gt = [0.005, 0.9, 1.99, 5.0]
    ie, ig = associate_timestamps(t_est, t_gt, max_dt=0.05)
    assert list(ie) == [0, 2]
    assert list(ig) == [0, 2]


def test_kitti_params_and_layout(tmp_path):
    """The KITTI parameter files (fx/fy scalar calibration form,
    image_2/image_3 subfolders; configs/ mirrors the reference's) load and
    read."""
    import cv2
    import numpy as np

    from plslam_tpu.io.euroc import StereoDirDataset, load_euroc_calib

    calib = load_euroc_calib(os.path.join(CONFIGS, "kitti00-02.yaml"))
    assert abs(calib.fx - 718.856) < 1e-3
    assert abs(calib.baseline - 0.537165719) < 1e-6
    assert calib.width == 1241 and calib.height == 376

    for sub in ("image_2", "image_3"):
        (tmp_path / sub).mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        img = rng.integers(0, 255, (376, 1241), dtype=np.uint8)
        for sub in ("image_2", "image_3"):
            cv2.imwrite(str(tmp_path / sub / f"{i:06d}.png"), img)
    ds = StereoDirDataset(str(tmp_path), calib,
                          subfolder_l="image_2/", subfolder_r="image_3/")
    assert len(ds) == 3
    il, ir, t = ds[1]
    assert il.shape == (376, 1241)
    assert abs(t - 0.1) < 1e-9  # counter filenames -> 10 Hz timestamps


def test_reference_run_configs_load():
    """Every run-config YAML the reference ships (mirrored in configs/
    config*.yaml) loads into PLSLAMConfig with its keys applied (loadSafe
    semantics: unknown keys ignored, missing keys keep defaults)."""
    import glob

    from plslam_tpu.config import PLSLAMConfig

    paths = sorted(glob.glob(os.path.join(CONFIGS, "config*.yaml")))
    assert len(paths) >= 6
    for p in paths:
        cfg = PLSLAMConfig.from_yaml(p)
        assert cfg.orb_nfeatures > 0 and cfg.lsd_nfeatures >= 0
        fc = cfg.frontend()
        assert fc.n_points > 0
        cfg.tracker(), cfg.loop_cfg(), cfg.ba()
    # spot-check a known value from config_euroc.yaml against the file
    import yaml as _y

    euroc = os.path.join(CONFIGS, "config_euroc.yaml")
    with open(euroc) as f:
        raw = _y.safe_load(f)
    cfg = PLSLAMConfig.from_yaml(euroc)
    assert cfg.orb_nfeatures == raw["orb_nfeatures"]
    assert cfg.min_ratio_12_p == raw["min_ratio_12_p"]


def test_reference_euroc_camera_params_load():
    """The EuRoC camera YAML (configs/ mirror of the reference's) builds a
    camera + rectification maps (pinholeStereoCamera.cpp:30-129 both calib
    forms)."""
    from plslam_tpu.io.euroc import load_euroc_calib

    calib = load_euroc_calib(os.path.join(CONFIGS, "euroc_params.yaml"))
    assert calib.fx > 0 and calib.baseline > 0
    assert not calib.identity_maps          # EuRoC form builds remap grids
    assert calib.map_l[0].shape == (calib.height, calib.width)


def test_repo_configs_self_contained():
    """The repo ships its own run + dataset YAMLs (configs/), regenerated
    through the library's loader (scripts/mirror_reference_configs.py) —
    loading them must not require /root/reference, and when the reference
    is present the loaded values must agree with its originals."""
    import glob
    import os

    from plslam_tpu.config import PLSLAMConfig
    from plslam_tpu.io.euroc import load_euroc_calib

    root = os.path.join(os.path.dirname(__file__), "..", "configs")
    run_cfgs = sorted(glob.glob(os.path.join(root, "config*.yaml")))
    assert len(run_cfgs) >= 6
    for p in run_cfgs:
        cfg = PLSLAMConfig.from_yaml(p)
        assert cfg.orb_nfeatures > 0
        ref = os.path.join("/root/reference/config/config",
                           os.path.basename(p))
        if os.path.exists(ref):
            assert cfg == PLSLAMConfig.from_yaml(ref), p
    cams = [p for p in sorted(glob.glob(os.path.join(root, "*.yaml")))
            if not os.path.basename(p).startswith("config")]
    assert len(cams) >= 6
    for p in cams:
        calib = load_euroc_calib(p)
        assert calib.fx > 0 and calib.baseline > 0
        ref = os.path.join("/root/reference/config/dataset_params",
                           os.path.basename(p))
        if os.path.exists(ref):
            rc = load_euroc_calib(ref)
            assert (calib.fx, calib.fy, calib.cx, calib.cy,
                    calib.baseline) == (rc.fx, rc.fy, rc.cx, rc.cy,
                                        rc.baseline), p
