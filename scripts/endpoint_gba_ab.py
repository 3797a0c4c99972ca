"""Endpoint-GBA convergence A/B oracle (VERDICT r4 weak #3).

Question: our endpoint-mode GBA converges ~10x looser than Pluecker on the
ring oracle.  Is that inherent to the endpoint parameterization with
point-to-line-only constraints (the reference's PRIMARY GBA,
/root/reference/src/mapHandler.cpp:3128-3731), or a defect in our solver?

Method: build ONE ring problem, then solve it three ways —
  a) our Pluecker-mode chunked GBA (mapper.global_bundle_adjustment),
  b) our endpoint-mode chunked GBA (same, cfg.plucker_lines=False),
  c) a REFERENCE-FAITHFUL endpoint LM oracle: float64, dense normal
     equations over [poses | points | line endpoints], residuals exactly
     the reference's — 2D point reprojection and the signed distance of
     each projected 3D line endpoint to the observed image line
     (levMarquardtOptimizationGBA residual forms, mapHandler.cpp:3193 and
     :2411-ff) — Cauchy IRLS weights (robustWeightCauchy, w = 1/(1+r^2)),
     lambda*diag(H) damping with x10 accept/reject, pose 0 fixed (gauge).
     Jacobians per observation come from jax.jacfwd in f64 (exact), so the
     oracle's behavior is governed purely by the parameterization and the
     LM protocol, not by hand-derived derivatives.

If (c) lands near (a)'s floor, our endpoint path has a bug; if (c) lands
near (b), the parameterization class owns the gap.

Run: JAX_PLATFORMS=cpu python scripts/endpoint_gba_ab.py
"""

import json
import os
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_enable_x64", True)
from plslam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

import __graft_entry__ as G

N_KF, N_PTS, N_LS = 16, 1024, 128
SEED = 3


def build(plucker: bool):
    import dataclasses

    mapper, truth = G._build_ring_map(rng_seed=SEED, n_kf=N_KF,
                                      n_pts=N_PTS, n_ls=N_LS,
                                      pose_noise=0.01, lm_noise=0.03)
    mapper.cfg = dataclasses.replace(mapper.cfg, plucker_lines=plucker)
    return mapper, truth


def pt_err(mapper, pt_true):
    mp = mapper.map
    el = np.where(mp.pt_valid & (mp.pt_nobs >= 2))[0]
    return float(np.median(np.linalg.norm(mp.pt_w[el] - pt_true[el],
                                          axis=1)))


def pose_err(mapper, T_true):
    T = np.stack([k.T_w_k[:3, 3] for k in mapper.map.keyframes])
    return float(np.linalg.norm(T - T_true[:, :3, 3], axis=1).mean())


# ---------------------------------------------------------------------------
# (c) reference-faithful dense endpoint LM
# ---------------------------------------------------------------------------


def extract_problem(mapper):
    """Pull the obs tables into flat arrays (f64)."""
    mp = mapper.map
    kfs = mp.keyframes
    T0 = np.stack([np.linalg.inv(k.T_w_k) for k in kfs])  # T_c_w
    # live point landmarks with >= 2 obs
    pt_ids = np.where(mp.pt_valid & (mp.pt_nobs >= 2))[0]
    pslot = np.full(mp.n_pt, -1, np.int64)
    pslot[pt_ids] = np.arange(len(pt_ids))
    X0 = mp.pt_w[pt_ids].astype(np.float64)
    tb = mp.pobs
    rows = np.where(tb.valid[: tb.n] & (pslot[tb.lm[: tb.n]] >= 0))[0]
    p_cam = tb.kf[rows]
    p_lm = pslot[tb.lm[rows]]
    p_uv = np.stack([kfs[k].pt_uv[f] for k, f in
                     zip(p_cam, tb.fi[rows])]).astype(np.float64)
    # line landmarks as endpoint pairs
    ls_ids = np.where(mp.ls_valid & (mp.ls_nobs >= 2))[0]
    lslot = np.full(mp.n_ls, -1, np.int64)
    lslot[ls_ids] = np.arange(len(ls_ids))
    E0 = mp.ls_epw[ls_ids].astype(np.float64)            # (L, 2, 3)
    tb = mp.lobs
    rows = np.where(tb.valid[: tb.n] & (lslot[tb.lm[: tb.n]] >= 0))[0]
    l_cam = tb.kf[rows]
    l_lm = lslot[tb.lm[rows]]
    lo = []
    for k, f in zip(l_cam, tb.fi[rows]):
        sp, ep = kfs[k].ls_sp[f], kfs[k].ls_ep[f]
        l = np.cross([*sp, 1.0], [*ep, 1.0])
        lo.append(l / max(np.hypot(l[0], l[1]), 1e-12))
    lo = np.asarray(lo, np.float64)
    return (T0, X0, E0, p_cam, p_lm, p_uv, l_cam, l_lm, lo, pt_ids, ls_ids)


def faithful_endpoint_lm(mapper, iters: int = 40):
    (T0, X0, E0, p_cam, p_lm, p_uv, l_cam, l_lm, lo,
     pt_ids, ls_ids) = extract_problem(mapper)
    cam = mapper.cam
    fx, fy = float(cam.fx), float(cam.fy)
    cx, cy = float(cam.cx), float(cam.cy)
    K, P, L = len(T0), len(X0), len(E0)
    NP6 = 6 * (K - 1)  # pose 0 fixed (gauge)

    from plslam_tpu.core import lie

    T0j = jnp.asarray(T0)

    def proj(Pc):
        z = jnp.maximum(Pc[2], 1e-9)
        return jnp.array([cx + fx * Pc[0] / z, cy + fy * Pc[1] / z])

    def pose_of(xi, k):
        # chart: T_c_w(k) = exp(xi_k) @ T0_c_w(k); k=0 fixed
        return jnp.where(k == 0, T0j[k],
                         lie.exp_se3(xi[k - 1]) @ T0j[k])

    def point_res(xi, X, k, p, uv):
        Pc = lie.transform_point(pose_of(xi, k), X[p])
        return proj(Pc) - uv

    def line_res(xi, E, k, l, lobs):
        T = pose_of(xi, k)
        e = []
        for q in range(2):
            u = proj(lie.transform_point(T, E[l, q]))
            e.append(lobs[0] * u[0] + lobs[1] * u[1] + lobs[2])
        return jnp.stack(e)

    # per-obs Jacobians wrt the INVOLVED parameters only, then dense H
    def pt_res_local(xi_k, Xp, T0k, uv, fixed):
        T = jnp.where(fixed, T0k, lie.exp_se3(xi_k) @ T0k)
        return proj(lie.transform_point(T, Xp)) - uv

    def ls_res_local(xi_k, Eq, T0k, lobs, fixed):
        T = jnp.where(fixed, T0k, lie.exp_se3(xi_k) @ T0k)
        e = []
        for q in range(2):
            u = proj(lie.transform_point(T, Eq[q]))
            e.append(lobs[0] * u[0] + lobs[1] * u[1] + lobs[2])
        return jnp.stack(e)

    pt_val_jac = jax.jit(jax.vmap(
        lambda xi_k, Xp, T0k, uv, fixed: (
            pt_res_local(xi_k, Xp, T0k, uv, fixed),
            jax.jacfwd(pt_res_local, argnums=(0, 1))(
                xi_k, Xp, T0k, uv, fixed))))
    ls_val_jac = jax.jit(jax.vmap(
        lambda xi_k, Eq, T0k, lobs, fixed: (
            ls_res_local(xi_k, Eq, T0k, lobs, fixed),
            jax.jacfwd(ls_res_local, argnums=(0, 1))(
                xi_k, Eq, T0k, lobs, fixed))))

    n_par = NP6 + 3 * P + 6 * L
    xi = np.zeros((K - 1, 6))
    X = X0.copy()
    E = E0.copy()

    def eval_all(xi, X, E):
        rp, (Jp_pose, Jp_X) = pt_val_jac(
            jnp.asarray(xi)[np.maximum(p_cam - 1, 0)],
            jnp.asarray(X)[p_lm], T0j[p_cam], jnp.asarray(p_uv),
            jnp.asarray(p_cam == 0))
        rl, (Jl_pose, Jl_E) = ls_val_jac(
            jnp.asarray(xi)[np.maximum(l_cam - 1, 0)],
            jnp.asarray(E)[l_lm], T0j[l_cam], jnp.asarray(lo),
            jnp.asarray(l_cam == 0))
        return (np.asarray(rp), np.asarray(Jp_pose), np.asarray(Jp_X),
                np.asarray(rl), np.asarray(Jl_pose), np.asarray(Jl_E))

    def cost_of(rp, rl):
        return float(np.sum(np.log1p(np.sum(rp * rp, -1)))
                     + np.sum(np.log1p(np.sum(rl * rl, -1))))

    def assemble(rp, Jp_pose, Jp_X, rl, Jl_pose, Jl_E):
        Hd = np.zeros((n_par, n_par))
        g = np.zeros(n_par)
        w_p = 1.0 / (1.0 + np.sum(rp * rp, -1))          # Cauchy IRLS
        w_l = 1.0 / (1.0 + np.sum(rl * rl, -1))
        # block index helpers
        for ci in range(1, K):
            m = p_cam == ci
            if m.any():
                Jc = Jp_pose[m]                          # (n, 2, 6)
                sl = slice(6 * (ci - 1), 6 * ci)
                Hd[sl, sl] += np.einsum("n,nij,nik->jk", w_p[m], Jc, Jc)
                g[sl] += np.einsum("n,nij,ni->j", w_p[m], Jc, rp[m])
        pX = NP6 + 3 * p_lm
        for a in range(3):
            for b in range(3):
                np.add.at(Hd, (pX + a, pX + b),
                          w_p * np.einsum("nia,nib->n", Jp_X[..., a:a + 1],
                                          Jp_X[..., b:b + 1]))
        gX = np.einsum("n,nij->nj", w_p, rp[:, :, None] * Jp_X)
        np.add.at(g, pX[:, None] + np.arange(3)[None], gX)
        # pose-point cross blocks
        for ci in range(1, K):
            m = p_cam == ci
            if m.any():
                cross = np.einsum("n,nia,nib->nab", w_p[m], Jp_pose[m],
                                  Jp_X[m])
                rows = np.arange(6 * (ci - 1), 6 * ci)
                cols = (NP6 + 3 * p_lm[m])[:, None] + np.arange(3)[None]
                for a in range(6):
                    np.add.at(Hd, (rows[a], cols),
                              cross[:, a, :])
                    np.add.at(Hd, (cols, rows[a]),
                              cross[:, a, :])
        # lines: endpoint blocks (Jl_E is (n, 2, 2, 3): res x (endpoint q, 3))
        Jl_E = Jl_E.reshape(len(rl), 2, 6)
        lE = NP6 + 3 * P + 6 * l_lm
        for a in range(6):
            for b in range(6):
                np.add.at(Hd, (lE + a, lE + b),
                          w_l * np.einsum("ni,ni->n", Jl_E[:, :, a],
                                          Jl_E[:, :, b]))
        gE = np.einsum("n,nij->nj", w_l, rl[:, :, None] * Jl_E)
        np.add.at(g, lE[:, None] + np.arange(6)[None], gE)
        for ci in range(1, K):
            m = l_cam == ci
            if m.any():
                cross = np.einsum("n,nia,nib->nab", w_l[m], Jl_pose[m],
                                  Jl_E[m])
                rows = np.arange(6 * (ci - 1), 6 * ci)
                cols = (NP6 + 3 * P + 6 * l_lm[m])[:, None] + np.arange(6)[None]
                for a in range(6):
                    np.add.at(Hd, (rows[a], cols), cross[:, a, :])
                    np.add.at(Hd, (cols, rows[a]), cross[:, a, :])
                Jc = Jl_pose[m]
                sl = slice(6 * (ci - 1), 6 * ci)
                Hd[sl, sl] += np.einsum("n,nij,nik->jk", w_l[m], Jc, Jc)
                g[sl] += np.einsum("n,nij,ni->j", w_l[m], Jc, rl[m])
        return Hd, g

    lam = 1e-4
    rp, Jpp, JpX, rl, Jlp, JlE = eval_all(xi, X, E)
    cost = cost_of(rp, rl)
    cost_hist = [cost]
    for it in range(iters):
        Hd, g = assemble(rp, Jpp, JpX, rl, Jlp, JlE)
        Hdamp = Hd + lam * np.diag(np.diag(Hd)) + 1e-12 * np.eye(n_par)
        try:
            delta = np.linalg.solve(Hdamp, g)
        except np.linalg.LinAlgError:
            lam *= 10.0
            continue
        xi_c = xi - delta[:NP6].reshape(K - 1, 6)
        X_c = X - delta[NP6:NP6 + 3 * P].reshape(P, 3)
        E_c = E - delta[NP6 + 3 * P:].reshape(L, 2, 3)
        rp_c, Jpp_c, JpX_c, rl_c, Jlp_c, JlE_c = eval_all(xi_c, X_c, E_c)
        c_new = cost_of(rp_c, rl_c)
        if np.isfinite(c_new) and c_new < cost:
            xi, X, E = xi_c, X_c, E_c
            rp, Jpp, JpX, rl, Jlp, JlE = rp_c, Jpp_c, JpX_c, rl_c, Jlp_c, JlE_c
            cost = c_new
            lam = max(lam / 10.0, 1e-9)
        else:
            lam = min(lam * 10.0, 1e6)
        cost_hist.append(cost)
    return xi, X, E, pt_ids, cost_hist


def main():
    out = {"n_kf": N_KF, "n_pts": N_PTS, "n_ls": N_LS}
    # (a) our Pluecker GBA
    mapper, (T_true, pt_true) = build(plucker=True)
    out["pre"] = {"pt": round(pt_err(mapper, pt_true), 5),
                  "pose": round(pose_err(mapper, T_true), 5)}
    t0 = time.time()
    mapper.global_bundle_adjustment()
    out["ours_plucker"] = {"pt": round(pt_err(mapper, pt_true), 5),
                           "pose": round(pose_err(mapper, T_true), 5),
                           "wall_s": round(time.time() - t0, 1)}
    # (b) our endpoint GBA
    mapper, _ = build(plucker=False)
    t0 = time.time()
    mapper.global_bundle_adjustment()
    out["ours_endpoint"] = {"pt": round(pt_err(mapper, pt_true), 5),
                            "pose": round(pose_err(mapper, T_true), 5),
                            "wall_s": round(time.time() - t0, 1)}
    # (c) reference-faithful dense f64 endpoint LM on the same problem
    mapper, _ = build(plucker=False)
    t0 = time.time()
    xi, X, E, pt_ids, hist = faithful_endpoint_lm(mapper)
    errs = np.linalg.norm(X - pt_true[pt_ids], axis=1)
    out["oracle_endpoint_f64"] = {
        "pt": round(float(np.median(errs)), 5),
        "wall_s": round(time.time() - t0, 1),
        "cost_first_last": [round(hist[0], 2), round(hist[-1], 2)],
        "iters_used": len(hist) - 1}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
