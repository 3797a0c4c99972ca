"""Bundle-adjustment tests: Jacobian autodiff oracles, cost decrease, and
synthetic-scene convergence with a fixed gauge (SURVEY.md §4: property tests
— BA decreases cost; golden tests on tiny synthetic scenes)."""

import jax
import jax.numpy as jnp
import numpy as np

from plslam_tpu.core import lie
from plslam_tpu.core.camera import StereoCamera
from plslam_tpu.core.plucker import (
    orth_to_plucker,
)
from plslam_tpu.backend import ba
from plslam_tpu.io.synthetic import ba_problem

RNG = np.random.default_rng(11)
CAM = StereoCamera.create(435.2, 435.2, 367.4, 252.2, 0.110074, dtype=jnp.float64)
CFG = ba.BAConfig()


def make_problem(**kw):
    return ba_problem(CAM, **kw)


def test_point_obs_jacobians_vs_autodiff():
    prob, *_ = make_problem(K=2, P=5, L=3)

    e0, Jc, Jp = jax.jit(ba.point_obs_residuals)(prob, CAM)

    def e_of_pose_delta(d):
        T = jax.vmap(lambda dd, T: lie.exp_se3(dd) @ T)(d, prob.T_c_w)
        return ba.point_obs_residuals(prob._replace(T_c_w=T), CAM)[0]

    Jc_auto = jax.jit(jax.jacfwd(e_of_pose_delta))(jnp.zeros((2, 6), jnp.float64))
    # gather per-obs blocks
    Jc_auto = Jc_auto[jnp.arange(prob.p_cam.shape[0]), :, prob.p_cam, :]
    np.testing.assert_allclose(np.asarray(Jc), np.asarray(Jc_auto), atol=1e-4)

    def e_of_points(pp):
        return ba.point_obs_residuals(prob._replace(points=pp), CAM)[0]

    Jp_auto = jax.jit(jax.jacfwd(e_of_points))(prob.points)
    Jp_auto = Jp_auto[jnp.arange(prob.p_lm.shape[0]), :, prob.p_lm, :]
    np.testing.assert_allclose(np.asarray(Jp), np.asarray(Jp_auto), atol=1e-4)


def test_line_obs_jacobians_vs_autodiff():
    prob, *_ = make_problem(K=2, P=5, L=4)

    e0, Jc, Jl = jax.jit(ba.line_obs_residuals)(prob, CAM)

    def e_of_pose_delta(d):
        T = jax.vmap(lambda dd, T: lie.exp_se3(dd) @ T)(d, prob.T_c_w)
        return ba.line_obs_residuals(prob._replace(T_c_w=T), CAM)[0]

    Jc_auto = jax.jit(jax.jacfwd(e_of_pose_delta))(jnp.zeros((2, 6), jnp.float64))
    Jc_auto = Jc_auto[jnp.arange(prob.l_cam.shape[0]), :, prob.l_cam, :]
    np.testing.assert_allclose(np.asarray(Jc), np.asarray(Jc_auto), atol=1e-4)

    from plslam_tpu.core.plucker import orth_plus

    def e_of_line_delta(d):
        o = jax.vmap(orth_plus)(prob.lines_orth, d)
        return ba.line_obs_residuals(prob._replace(lines_orth=o), CAM)[0]

    Jl_auto = jax.jit(jax.jacfwd(e_of_line_delta))(jnp.zeros((4, 4), jnp.float64))
    Jl_auto = Jl_auto[jnp.arange(prob.l_lm.shape[0]), :, prob.l_lm, :]
    np.testing.assert_allclose(np.asarray(Jl), np.asarray(Jl_auto), atol=1e-4)


def test_ba_converges_clean():
    prob, T_c_w_true, Pw_true, Lw_true = make_problem(noise=0.0, pert=0.03)
    res = jax.jit(ba.bundle_adjust, static_argnums=2)(prob, CAM, CFG)
    # a noise-free problem must reach (numerically) zero residual cost
    assert float(res.cost) < 1e-8, float(res.cost)
    # pose recovery (gauge fixed at pose 0; these are monocular
    # observations, so global scale is a true gauge freedom — the
    # optimizer may settle on a zero-residual configuration a small
    # similarity away from the generating one)
    dT = np.asarray(jax.vmap(lambda a, b: lie.log_se3(a @ lie.inv_se3(b)))(
        res.problem.T_c_w, T_c_w_true))
    assert np.abs(dT).max() < 5e-3, dT
    # point recovery up to that scale-gauge wiggle
    dP = np.asarray(res.problem.points - Pw_true)
    assert np.abs(dP).max() < 2.5e-2, np.abs(dP).max()
    # line recovery: compare normalized Pluecker
    Lw_est = np.asarray(jax.jit(jax.vmap(orth_to_plucker))(res.problem.lines_orth)
                        ) * np.asarray(res.problem.lines_scale)[:, None]
    Lw_ref = np.asarray(Lw_true)
    err = np.abs(Lw_est / np.linalg.norm(Lw_est, axis=1, keepdims=True)
                 - Lw_ref / np.linalg.norm(Lw_ref, axis=1, keepdims=True)).max()
    assert err < 1e-2, err


def test_ba_cost_decreases_with_noise():
    prob, *_ = make_problem(noise=0.5, pert=0.05)
    c0 = float(jax.jit(ba.total_cost, static_argnums=2)(
        prob, CAM, CFG, prob.p_valid, prob.l_valid))
    res = jax.jit(ba.bundle_adjust, static_argnums=2)(prob, CAM, CFG)
    assert float(res.cost) < c0 * 0.5, (c0, float(res.cost))


def test_chi2_gate_deactivates_outliers():
    prob, *_ = make_problem(noise=0.2, pert=0.02)
    uv = np.asarray(prob.p_uv).copy()
    bad = RNG.choice(len(uv), size=8, replace=False)
    uv[bad] += 50.0
    prob = prob._replace(p_uv=jnp.asarray(uv))
    res = jax.jit(ba.bundle_adjust, static_argnums=2)(prob, CAM, CFG)
    active = np.asarray(res.p_active)
    assert active[bad].sum() == 0
    # inliers largely kept
    keep = np.ones(len(uv), bool); keep[bad] = False
    assert active[keep].mean() > 0.9


def test_fixed_pose_untouched():
    prob, T_true, _, _ = make_problem(pert=0.03)
    res = jax.jit(ba.bundle_adjust, static_argnums=2)(prob, CAM, CFG)
    np.testing.assert_allclose(
        np.asarray(res.problem.T_c_w[0]), np.asarray(prob.T_c_w[0]), atol=0)


def test_padded_obs_rows_have_zero_effect():
    """Invariant (r1 review weak #6): padded observation rows — cam=0,
    lm=0, valid=False, arbitrary garbage observations — must not change
    the solution at all.  Correctness must not silently depend on the
    garbage being benign."""
    prob, *_ = make_problem(K=3, P=10, L=4)
    run = jax.jit(lambda p: ba.lm_rounds(p, CAM, CFG, p.p_valid,
                                         p.l_valid, 5))
    clean, _ = run(prob)

    garbage = 1e8
    z32 = lambda n: jnp.zeros(n, jnp.int32)
    dt = prob.p_uv.dtype
    padded = prob._replace(
        p_cam=jnp.concatenate([prob.p_cam, z32(7)]),
        p_lm=jnp.concatenate([prob.p_lm, z32(7)]),
        p_uv=jnp.concatenate([prob.p_uv, jnp.full((7, 2), garbage, dt)]),
        p_sigma2=jnp.concatenate([prob.p_sigma2, jnp.full(7, garbage, dt)]),
        p_valid=jnp.concatenate([prob.p_valid, jnp.zeros(7, bool)]),
        l_cam=jnp.concatenate([prob.l_cam, z32(5)]),
        l_lm=jnp.concatenate([prob.l_lm, z32(5)]),
        l_sobs=jnp.concatenate([prob.l_sobs, jnp.full((5, 2), -garbage, dt)]),
        l_eobs=jnp.concatenate([prob.l_eobs, jnp.full((5, 2), garbage, dt)]),
        l_sigma2=jnp.concatenate([prob.l_sigma2, jnp.full(5, garbage, dt)]),
        l_valid=jnp.concatenate([prob.l_valid, jnp.zeros(5, bool)]),
    )
    run_p = jax.jit(lambda p: ba.lm_rounds(p, CAM, CFG, p.p_valid,
                                           p.l_valid, 5))
    dirty, _ = run_p(padded)
    for name in ("T_c_w", "points", "lines_orth"):
        np.testing.assert_array_equal(np.asarray(getattr(clean, name)),
                                      np.asarray(getattr(dirty, name)),
                                      err_msg=name)
