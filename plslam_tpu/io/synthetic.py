"""Synthetic stereo sequence renderer for end-to-end tests and benchmarks.

Renders a random 3D scene of blob landmarks and 3D line segments into both
cameras of a moving stereo rig (no dataset download needed; SURVEY.md §4
calls for golden-value tests on synthetic scenes).  Host-side numpy — this
stands in for the dataset layer in tests.  ``ba_problem`` builds a
synthetic bundle-adjustment problem (every camera sees every landmark)
for the BA tests, benchmarks and the GPU smoke run.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


class SyntheticScene:
    def __init__(self, n_points=300, n_lines=40, seed=0,
                 width=376, height=240, fx=217.6, fy=217.6,
                 cx=183.7, cy=126.1, baseline=0.110074):
        rng = np.random.default_rng(seed)
        self.width, self.height = width, height
        self.fx, self.fy, self.cx, self.cy, self.b = fx, fy, cx, cy, baseline
        # scatter landmarks in a box in front of the initial camera
        self.P = np.stack([
            rng.uniform(-6, 6, n_points),
            rng.uniform(-4, 4, n_points),
            rng.uniform(2.0, 14.0, n_points),
        ], axis=-1)
        self.P_bright = rng.uniform(120, 250, n_points)
        A = np.stack([
            rng.uniform(-6, 6, n_lines),
            rng.uniform(-4, 4, n_lines),
            rng.uniform(2.0, 14.0, n_lines),
        ], axis=-1)
        B = A + np.stack([
            rng.uniform(-2.5, 2.5, n_lines),
            rng.uniform(-2.5, 2.5, n_lines),
            rng.uniform(-1.0, 1.0, n_lines),
        ], axis=-1)
        self.LA, self.LB = A, B
        self.L_bright = rng.uniform(140, 250, n_lines)
        self.rng = rng

    def project(self, T_c_w: np.ndarray, X: np.ndarray):
        Xc = (T_c_w[:3, :3] @ X.T).T + T_c_w[:3, 3]
        z = Xc[:, 2]
        u = self.cx + self.fx * Xc[:, 0] / np.maximum(z, 1e-6)
        v = self.cy + self.fy * Xc[:, 1] / np.maximum(z, 1e-6)
        return u, v, z

    def _splat(self, img, u, v, brightness, sigma=1.1, rad=3):
        """Anti-aliased Gaussian splats at fractional positions (arrays of
        centres and brightnesses), max-composited into ``img`` — integer
        rasterization would bake +-0.5 px quantization into the 'true'
        feature positions and dominate stereo depth error."""
        x0 = np.floor(u).astype(np.int64)
        y0 = np.floor(v).astype(np.int64)
        ok = ((rad <= x0) & (x0 < self.width - rad - 1)
              & (rad <= y0) & (y0 < self.height - rad - 1))
        u, v, x0, y0, b = u[ok], v[ok], x0[ok], y0[ok], brightness[ok]
        d = np.arange(-rad, rad + 1)
        ys = y0[:, None, None] + d[None, :, None]
        xs = x0[:, None, None] + d[None, None, :]
        g = np.exp(-((xs - u[:, None, None]) ** 2
                     + (ys - v[:, None, None]) ** 2) / (2 * sigma * sigma))
        ys, xs = np.broadcast_arrays(ys, xs)
        np.maximum.at(img, (ys, xs), b[:, None, None] * g)

    def _render(self, T_c_w: np.ndarray, noise: float,
                gain: float = 1.0, bias: float = 0.0,
                occluders=None) -> np.ndarray:
        img = np.full((self.height, self.width), 30.0, np.float32)
        u, v, z = self.project(T_c_w, self.P)
        ok = (z > 0.5)
        self._splat(img, u[ok], v[ok], self.P_bright[ok])
        ua, va, za = self.project(T_c_w, self.LA)
        ub, vb, zb = self.project(T_c_w, self.LB)
        lx, ly, lb = [], [], []
        for i in range(len(ua)):
            if za[i] <= 0.5 or zb[i] <= 0.5:
                continue
            n = int(max(abs(ub[i] - ua[i]), abs(vb[i] - va[i])) * 2.0) + 2
            t = np.linspace(0, 1, n)
            lx.append(ua[i] + t * (ub[i] - ua[i]))
            ly.append(va[i] + t * (vb[i] - va[i]))
            lb.append(np.full(n, self.L_bright[i]))
        if lx:
            self._splat(img, np.concatenate(lx), np.concatenate(ly),
                        np.concatenate(lb), sigma=0.9, rad=2)
        # near-field occluders: textureless panels at camera-frame depth —
        # drawn over the scene with stereo-consistent disparity, they
        # ERASE whatever features fall behind them (dropout robustness)
        if occluders is not None:
            for (xc, yc, zo, w2, h2) in occluders:
                uo = self.cx + self.fx * xc / zo
                vo = self.cy + self.fy * yc / zo
                du = self.fx * w2 / zo
                dv = self.fy * h2 / zo
                x0 = int(np.clip(uo - du, 0, self.width))
                x1 = int(np.clip(uo + du, 0, self.width))
                y0 = int(np.clip(vo - dv, 0, self.height))
                y1 = int(np.clip(vo + dv, 0, self.height))
                img[y0:y1, x0:x1] = 55.0
        # photometric model: exposure gain + black-level bias (rolling
        # illumination across a sequence) and sensor noise
        img = img * gain + bias
        if noise > 0:
            img = img + self.rng.normal(0, noise, img.shape).astype(np.float32)
        return np.clip(img, 0, 255).astype(np.float32)

    def render_stereo(self, T_w_c: np.ndarray, noise: float = 1.0,
                      gain: float = 1.0, bias: float = 0.0,
                      n_occluders: int = 0):
        """(left, right) images for a camera->world pose.

        ``gain``/``bias`` model per-frame exposure / illumination change
        (roll them across a sequence for the EuRoC-like evaluation);
        ``n_occluders`` drops that many
        textureless near-field panels into BOTH views with consistent
        disparity, erasing the features behind them."""
        T_c_w = np.linalg.inv(T_w_c)
        occ = None
        if n_occluders > 0:
            # camera-frame panels (x_center, y_center, depth, half_w, half_h)
            occ = [(float(self.rng.uniform(-1.5, 1.5)),
                    float(self.rng.uniform(-1.0, 1.0)),
                    float(self.rng.uniform(1.2, 2.5)),
                    float(self.rng.uniform(0.15, 0.45)),
                    float(self.rng.uniform(0.15, 0.45)))
                   for _ in range(n_occluders)]
        img_l = self._render(T_c_w, noise, gain, bias, occ)
        # right camera: shifted by baseline along +x of the camera frame
        T_shift = np.eye(4)
        T_shift[0, 3] = -self.b
        occ_r = ([(x - self.b, y, z, w2, h2) for x, y, z, w2, h2 in occ]
                 if occ else None)
        img_r = self._render(T_shift @ T_c_w, noise, gain, bias, occ_r)
        return img_l, img_r


def circular_trajectory(n_frames: int, step_t=0.06, step_r=0.008):
    """Gentle forward + yaw motion: list of (4x4) camera->world poses."""
    poses = [np.eye(4)]
    for i in range(1, n_frames):
        xi_t = np.array([0.01 * np.sin(i * 0.4), 0.005 * np.cos(i * 0.3), step_t])
        c, s = np.cos(step_r), np.sin(step_r)
        Rz = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        T = np.eye(4)
        T[:3, :3] = Rz
        T[:3, 3] = xi_t
        poses.append(poses[-1] @ T)
    return poses


def loop_trajectory(n_frames: int, width: float = 1.2, depth: float = 3.0,
                    laps: float = 1.0):
    """Camera->world poses around a closed loop in the x-z plane (an
    ellipse ``width`` across and ``depth`` forward, starting at the
    origin), the camera facing +z throughout with a gentle yaw sway.
    With laps > 1 the end of the run revisits the start: a loop closure
    for the scenes above, which lie in front of the start pose."""
    poses = []
    for i in range(n_frames):
        th = 2 * np.pi * laps * i / n_frames
        yaw = 0.05 * np.sin(th)
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        T[:3, 3] = [0.5 * width * np.sin(th), 0.0,
                    0.5 * depth * (1 - np.cos(th))]
        poses.append(T)
    return poses


@jax.jit
def _build_ba_problem(cam, poses_xi, Pw, LA, LB, pert_xi, pert_P, pert_orth,
                      noise_uv, noise_s, noise_e):
    from ..backend.ba import BAProblem
    from ..core import lie
    from ..core.plucker import plucker_from_two_points, plucker_to_orth

    K = poses_xi.shape[0]
    P = Pw.shape[0]
    L = LA.shape[0]
    dtype = Pw.dtype
    T_w_c = jax.vmap(lie.exp_se3)(poses_xi)         # camera->world
    T_c_w = jax.vmap(lie.inv_se3)(T_w_c)

    # observations: every camera sees every landmark
    cam_idx_p = jnp.repeat(jnp.arange(K, dtype=jnp.int32), P)
    lm_idx_p = jnp.tile(jnp.arange(P, dtype=jnp.int32), K)
    Pc = jax.vmap(lie.transform_point)(T_c_w[cam_idx_p], Pw[lm_idx_p])
    uv = cam.project(Pc) + noise_uv

    cam_idx_l = jnp.repeat(jnp.arange(K, dtype=jnp.int32), L)
    lm_idx_l = jnp.tile(jnp.arange(L, dtype=jnp.int32), K)
    sA = cam.project(jax.vmap(lie.transform_point)(
        T_c_w[cam_idx_l], LA[lm_idx_l])) + noise_s
    eB = cam.project(jax.vmap(lie.transform_point)(
        T_c_w[cam_idx_l], LB[lm_idx_l])) + noise_e

    Lw = plucker_from_two_points(LA, LB)
    scale = jnp.linalg.norm(Lw, axis=-1)
    orth = plucker_to_orth(Lw / scale[:, None])

    # perturb initial state (keep pose 0 fixed as gauge)
    T_c_w_init = jax.vmap(lambda d, T: lie.exp_se3(d) @ T)(pert_xi, T_c_w)
    points_init = Pw + pert_P
    orth_init = orth + pert_orth

    prob = BAProblem(
        T_c_w=T_c_w_init,
        pose_fixed=jnp.arange(K) == 0,
        pose_valid=jnp.ones(K, bool),
        points=points_init,
        point_valid=jnp.ones(P, bool),
        lines_orth=orth_init,
        lines_scale=scale,
        line_valid=jnp.ones(L, bool),
        p_cam=cam_idx_p, p_lm=lm_idx_p, p_uv=uv,
        p_sigma2=jnp.ones(K * P, dtype), p_valid=jnp.ones(K * P, bool),
        l_cam=cam_idx_l, l_lm=lm_idx_l, l_sobs=sA, l_eobs=eB,
        l_sigma2=jnp.ones(K * L, dtype), l_valid=jnp.ones(K * L, bool),
    )
    return prob, T_c_w, Pw, Lw


def ba_problem(cam, K=5, P=30, L=12, noise=0.0, pert=0.02, seed=11):
    """A perturbed bundle-adjustment problem: K cameras, P points and L
    lines, every camera observing every landmark through ``cam`` (whose
    dtype the problem takes).  Returns (problem, true T_c_w, true points,
    true Pluecker lines); pose 0 is the fixed gauge."""
    rng = np.random.default_rng(seed)
    dtype = cam.fx.dtype
    poses_xi = jnp.asarray(
        np.concatenate(
            [rng.uniform(-0.5, 0.5, (K, 2)), rng.uniform(-0.1, 0.1, (K, 1)),
             rng.uniform(-0.05, 0.05, (K, 3))], axis=1), dtype)
    Pw = jnp.asarray(np.stack(
        [rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(4, 10, P)],
        axis=-1), dtype)
    LA = jnp.asarray(np.stack(
        [rng.uniform(-3, 3, L), rng.uniform(-2, 2, L), rng.uniform(4, 10, L)],
        axis=-1), dtype)
    LB = LA + jnp.asarray(np.stack(
        [rng.uniform(-1.5, 1.5, L), rng.uniform(-1.5, 1.5, L),
         rng.uniform(-0.5, 0.5, L)], axis=-1), dtype)
    pert_xi = jnp.asarray(rng.normal(size=(K, 6)) * pert, dtype)
    pert_xi = pert_xi.at[0].set(0.0)
    pert_P = jnp.asarray(rng.normal(size=(P, 3)) * pert, dtype)
    pert_orth = jnp.asarray(rng.normal(size=(L, 4)) * pert * 0.5, dtype)
    noise_uv = jnp.asarray(rng.normal(size=(K * P, 2)) * noise, dtype)
    noise_s = jnp.asarray(rng.normal(size=(K * L, 2)) * noise, dtype)
    noise_e = jnp.asarray(rng.normal(size=(K * L, 2)) * noise, dtype)
    return _build_ba_problem(cam, poses_xi, Pw, LA, LB, pert_xi, pert_P,
                             pert_orth, noise_uv, noise_s, noise_e)
