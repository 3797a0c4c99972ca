"""Offline visualization — the slamScene / sceneRepresentation analog.

The reference renders a live MRPT 3D window (src/slamScene.cpp:
trajectory, keyframes, point/line landmarks, covisibility graph;
src2/sceneRepresentation.cpp for pure VO).  A batch pipeline has no
interactive window; this module renders the same artifacts to image files
with matplotlib (Agg), after or during a run:

- ``plot_trajectory``   — estimated (and optionally ground-truth) path
- ``plot_map``          — 3D point/line landmarks + keyframe poses
- ``plot_covisibility`` — the full_graph covisibility weights
- ``render_run``        — one call producing the standard set of figures
"""

from __future__ import annotations

import os

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory(traj, path: str, gt=None, title: str = "trajectory"):
    """Top-down (x-z) and height profiles of a (N, 4, 4) pose trajectory;
    overlays ground truth when given (the result/xyz.png-style artifact of
    the reference README)."""
    plt = _plt()
    traj = np.asarray(traj)
    p = traj[:, :3, 3]
    fig, axes = plt.subplots(1, 2, figsize=(11, 5))
    axes[0].plot(p[:, 0], p[:, 2], "-", lw=1.5, label="estimate")
    if gt is not None:
        g = np.asarray(gt)
        g = g[:, :3, 3] if g.ndim == 3 else g
        axes[0].plot(g[:, 0], g[:, 2], "--", lw=1.0, label="ground truth")
    axes[0].set_xlabel("x [m]")
    axes[0].set_ylabel("z [m]")
    axes[0].axis("equal")
    axes[0].legend()
    axes[0].set_title(title)
    axes[1].plot(p[:, 1], lw=1.2)
    axes[1].set_xlabel("keyframe")
    axes[1].set_ylabel("y [m]")
    axes[1].set_title("height")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_map(mapper, path: str, max_points: int = 5000):
    """3D scatter of point landmarks, segments for line landmarks, and
    keyframe positions (slamScene landmark/KF rendering)."""
    plt = _plt()
    m = mapper.map
    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(111, projection="3d")

    pts = m.pt_w[m.pt_valid] if len(m.pt_valid) else np.zeros((0, 3))
    if len(pts):
        P = pts[:max_points]
        ax.scatter(P[:, 0], P[:, 2], P[:, 1], s=2, c="#1f77b4",
                   alpha=0.5, label=f"points ({len(pts)})")

    # line landmarks are world Pluecker 6-vectors; draw the segment seen
    # by the last observing keyframe, lifted to world
    n_ls = 0
    ls_obs = m.ls_obs  # materialize the flat-table view once
    for i in range(len(m.ls_valid)):
        if not m.ls_valid[i] or not ls_obs[i]:
            continue
        kf_id, fi = ls_obs[i][-1]
        kf_rec = m.keyframes[kf_id]
        T = kf_rec.T_w_k
        sp = T[:3, :3] @ kf_rec.ls_sP[fi] + T[:3, 3]
        ep = T[:3, :3] @ kf_rec.ls_eP[fi] + T[:3, 3]
        ax.plot([sp[0], ep[0]], [sp[2], ep[2]], [sp[1], ep[1]],
                c="#d62728", lw=1.0, alpha=0.8)
        n_ls += 1

    if m.keyframes:
        kf = np.stack([k.T_w_k[:3, 3] for k in m.keyframes])
        ax.plot(kf[:, 0], kf[:, 2], kf[:, 1], "k.-", lw=1.2, ms=4,
                label=f"keyframes ({len(m.keyframes)})")
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_zlabel("y")
    ax.legend(loc="upper left")
    ax.set_title(f"map: {len(pts)} points, {n_ls} lines")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_covisibility(mapper, path: str):
    """Heatmap of the covisibility counts (full_graph) and the KF graph
    edges above the local-map threshold (updateSceneGraphs analog)."""
    plt = _plt()
    G = np.asarray(mapper.map.covis, dtype=float)
    fig, axes = plt.subplots(1, 2, figsize=(11, 5))
    im = axes[0].imshow(G, cmap="viridis")
    fig.colorbar(im, ax=axes[0], shrink=0.8)
    axes[0].set_title("covisibility counts (full_graph)")
    axes[0].set_xlabel("keyframe")

    kfs = mapper.map.keyframes
    kf = (np.stack([k.T_w_k[:3, 3] for k in kfs]) if kfs
          else np.zeros((0, 3)))
    axes[1].plot(kf[:, 0], kf[:, 2], "k.", ms=5)
    th = mapper.cfg.min_lm_cov_graph
    n = len(kf)
    for i in range(n):
        for j in range(i + 1, n):
            if G[i, j] >= th:
                axes[1].plot([kf[i, 0], kf[j, 0]], [kf[i, 2], kf[j, 2]],
                             "g-", lw=0.6, alpha=0.6)
    axes[1].axis("equal")
    axes[1].set_title(f"covisibility graph (>= {th} shared)")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_frame(img, feats, path: str, title: str = "stereo frame"):
    """Left image with detected/matched features overlaid — the
    plotStereoFrame debug render (stereoFrame.cpp:655): matched stereo
    points as circles, line segments as colored strokes."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(9, 6))
    ax.imshow(np.asarray(img), cmap="gray", vmin=0, vmax=255)
    pts = feats.points
    uv = np.asarray(pts.uv)
    ok = np.asarray(pts.valid)
    ax.plot(uv[ok, 0], uv[ok, 1], "o", ms=3, mfc="none", mec="#2ca02c",
            label=f"stereo points ({int(ok.sum())})")
    ls = feats.lines
    sp, ep = np.asarray(ls.sp), np.asarray(ls.ep)
    lok = np.asarray(ls.valid)
    n_l = int(lok.sum())
    for i in np.nonzero(lok)[0]:
        ax.plot([sp[i, 0], ep[i, 0]], [sp[i, 1], ep[i, 1]],
                "-", c="#d62728", lw=1.2)
    ax.plot([], [], "-", c="#d62728", label=f"stereo lines ({n_l})")
    ax.set_xlim(0, img.shape[1])
    ax.set_ylim(img.shape[0], 0)
    ax.legend(loc="upper right")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def render_run(slam, out_dir: str, gt=None) -> list[str]:
    """Standard artifact set for a finished PLSLAM run."""
    from .viz_scene import export_scene_html

    os.makedirs(out_dir, exist_ok=True)
    traj = slam.keyframe_trajectory()
    out = [
        plot_trajectory(traj, os.path.join(out_dir, "trajectory.png"),
                        gt=gt),
        plot_map(slam.mapper, os.path.join(out_dir, "map.png")),
        plot_covisibility(slam.mapper,
                          os.path.join(out_dir, "covisibility.png")),
        export_scene_html(slam.mapper, os.path.join(out_dir, "scene.html"),
                          gt=gt),
    ]
    return out
