"""Parity of the port's geometric bundle adjustment
(models/geometric_ba.py, optim/ba.py's scatter-add step and solver, the
forward-mode default of optim/fused.py) with the JAX package's, on
``synth_ba_problem`` at toy size.

Held at the ROADMAP's three levels: the build (f64: cost and every
normal-equation piece to 1e-8 relative, where only association order
differs; f32: cost rtol 2e-4, pieces atol 3e-3 x max|ref| with rtol
2e-3), the damped solve on the same normal equations, and the final cost
of a solve (rtol 2e-4), never the accept sequence.  The closed-form rj is
held to the forward-mode default at rtol 1e-6 / atol 1e-8 in all four
camera models (tests/test_geometric_ba.py:164-190).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.core import cameras as jcam
from photometric_bundle_adjustment_tpu.models import geometric_ba as jgeo
from photometric_bundle_adjustment_tpu.models import synthetic as jsyn
from photometric_bundle_adjustment_tpu.optim import ba as jba
from photometric_bundle_adjustment_tpu.optim import fused as jfused
from photometric_bundle_adjustment_tpu_torch import interop
from photometric_bundle_adjustment_tpu_torch.core import cameras as tcam
from photometric_bundle_adjustment_tpu_torch.core import se3 as tse3
from photometric_bundle_adjustment_tpu_torch.models import geometric_ba as tgeo
from photometric_bundle_adjustment_tpu_torch.models import synthetic as tsyn
from photometric_bundle_adjustment_tpu_torch.optim import ba as tba
from photometric_bundle_adjustment_tpu_torch.optim import fused as tfused
from photometric_bundle_adjustment_tpu_torch.optim.schur_plan import (
    DenseLmSchurPlan,
)

torch.set_num_threads(1)

K, L, S = 6, 48, 4
MODELS = ("pinhole", "eucm", "ds", "kb4")
NEQ_NAMES = ["H_cc", "S_corr0", "rhs_corr0", "H_pp", "g_c", "g_p", "M",
             "inv0"]
# (cost rtol, piece atol as a fraction of max|ref|, piece rtol)
TOL = {"f32": (2e-4, 3e-3, 2e-3), "f64": (1e-8, 1e-8, 1e-8)}


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close_scaled(port, ref, frac, rtol=0.0, msg=""):
    port, ref = _np(port), _np(ref)
    scale = max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(port, ref, atol=frac * scale, rtol=rtol,
                               err_msg=msg)


def _pair(model="pinhole", dtype="f64", pixel_noise=0.5, seed=0, **kw):
    """The JAX problem and the port's of the same seed."""
    jdt = jnp.float32 if dtype == "f32" else jnp.float64
    tdt = torch.float32 if dtype == "f32" else torch.float64
    args = dict(model=model, K=kw.get("K", K), L=kw.get("L", L),
                obs_per_landmark=kw.get("S", S), seed=seed,
                pixel_noise=pixel_noise)
    jp = jsyn.synth_ba_problem(dtype=jdt, **args)
    tp = tsyn.synth_ba_problem(dtype=tdt, device="cpu", **args)
    return jp, tp


def _heavy_tailed(jp):
    """The JAX problem with most landmarks cut to one observation
    (valid=0 rows): S_max * L > 3 x the valid rows, the chunk branch of
    ``_accel_plan``."""
    valid = np.ones(np.shape(jp.obs.valid), bool)
    lm = np.asarray(jp.obs.landmark)
    slot = np.arange(valid.shape[0]) // L
    valid[(lm >= 2) & (slot > 0)] = False
    return jp._replace(obs=jp.obs._replace(
        valid=jnp.asarray(valid, jp.inv_depth.dtype)))


@pytest.mark.parametrize("model,noise", [("pinhole", 0.0), ("kb4", 0.6)])
def test_synth_ba_problem_matches_jax(model, noise):
    (jp, jposes, jrho), (tp, tposes, trho) = _pair(model, pixel_noise=noise)
    for name in ("anchor_cam", "target_cam", "landmark", "valid"):
        np.testing.assert_array_equal(_np(getattr(tp.obs, name)),
                                      _np(getattr(jp.obs, name)), name)
    for name in tp.obs.aux._fields:
        np.testing.assert_allclose(_np(getattr(tp.obs.aux, name)),
                                   _np(getattr(jp.obs.aux, name)),
                                   atol=1e-9, err_msg=name)
    for t, j in ((tp.cam_states, jp.cam_states), (tp.inv_depth, jp.inv_depth),
                 (tposes, jposes), (trho, jrho)):
        assert t.dtype == torch.float64
        np.testing.assert_allclose(_np(t), _np(j), atol=1e-9)
    np.testing.assert_array_equal(_np(tp.fixed_cams), _np(jp.fixed_cams))


@pytest.mark.parametrize("model", MODELS)
def test_test_params_match_jax(model):
    np.testing.assert_array_equal(tcam.test_params(model).numpy(),
                                  np.asarray(jcam.test_params(model)))


def _gathered(p):
    o = p.obs
    return (tba.take_rows(p.cam_states, o.anchor_cam),
            tba.take_rows(p.cam_states, o.target_cam),
            p.inv_depth[o.landmark], o.aux)


@pytest.mark.parametrize("model", MODELS)
def test_rj_closed_form_matches_forward_mode_and_jax(model):
    (jp, _, _), (tp, _, _) = _pair(model, pixel_noise=0.6)
    args = _gathered(tp)
    r, J = tgeo.make_rj_fn(model)(*args)
    r_f, J_f = tba.forward_mode_rj(tgeo.make_residual_fn(model),
                                   tgeo.cam_retract, 6)(*args)
    assert J.shape == (S * L, 2, 13)
    np.testing.assert_allclose(r.numpy(), r_f.numpy(), atol=1e-10)
    np.testing.assert_allclose(J.numpy(), J_f.numpy(), rtol=1e-6, atol=1e-8)
    o = jp.obs
    r_j, J_j = jax.vmap(jgeo.make_rj_fn(model))(
        jp.cam_states[o.anchor_cam], jp.cam_states[o.target_cam],
        jp.inv_depth[o.landmark], o.aux)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_j), atol=1e-10)
    np.testing.assert_allclose(J.numpy(), np.asarray(J_j), rtol=1e-6,
                               atol=1e-8)


@pytest.mark.parametrize("rj", ["closed", "forward"])
def test_make_ba_step_and_schur_solve_match_jax(rj):
    """The scatter-add build and the Schur solve, f64, Huber 1, with the
    closed form and with the forward-mode default on both sides."""
    (jp, _, _), (tp, _, _) = _pair(pixel_noise=0.6)
    jrj = jgeo.make_rj_fn("pinhole") if rj == "closed" else None
    trj = tgeo.make_rj_fn("pinhole") if rj == "closed" else None
    _, jbuild = jba.make_ba_step(jgeo.make_residual_fn("pinhole"),
                                 jgeo.cam_retract, 6, rj_fn=jrj)
    _, tbuild = tba.make_ba_step(tgeo.make_residual_fn("pinhole"),
                                 tgeo.cam_retract, 6, rj_fn=trj)
    ref = jbuild(jp, jba.BAConfig())
    out = tbuild(tp, tba.BAConfig())
    shapes = [(), (K, K, 6, 6), (K, L, 6), (L,), (K, 6), (L,)]
    for name, a, b, shape in zip(["cost", "H_cc", "H_cp", "H_pp", "g_c",
                                  "g_p"], out, ref, shapes):
        assert tuple(a.shape) == shape, name
        _close_scaled(a, b, 1e-8, rtol=1e-8, msg=name)
    for lam in (1e-4, 1e-1):
        dc_j, dp_j = jba.schur_solve(*ref[1:], jnp.asarray(lam),
                                     ~jp.fixed_cams, jp.lm_valid, jba.BAConfig())
        dc, dp = tba.schur_solve(*out[1:], lam, ~tp.fixed_cams, tp.lm_valid,
                                 tba.BAConfig())
        _close_scaled(dc, dc_j, 1e-8, msg=f"delta_c at lambda {lam}")
        _close_scaled(dp, dp_j, 1e-8, msg=f"delta_p at lambda {lam}")
    # an indefinite system gives NaN deltas, as the reference's Cholesky
    dc, dp = tba.schur_solve(-out[1], *out[2:], 1e-4, ~tp.fixed_cams,
                             tp.lm_valid, tba.BAConfig())
    assert torch.isnan(dc).all() and torch.isnan(dp).any()


def test_make_ba_solver_matches_jax():
    (jp, _, _), (tp, _, _) = _pair(pixel_noise=0.6)
    _, ref = jgeo.make_solver("pinhole")(jp, jba.BAConfig(max_iterations=5))
    _, res = tgeo.make_solver("pinhole")(tp, tba.BAConfig(max_iterations=5))
    assert float(res.cost) < float(res.initial_cost)
    np.testing.assert_allclose(float(res.initial_cost),
                               float(ref.initial_cost), rtol=1e-10)
    np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=2e-4)


@pytest.mark.parametrize("rj", ["closed", "forward"])
@pytest.mark.parametrize("kind", ["chunk", "dense"])
def test_fused_builds_match_jax(kind, rj):
    """``make_fused_ba_solver``'s chunk and dense builds with the geometric
    rj, and with ``rj_fn=None`` (forward mode), in f32."""
    (jp, _, _), (tp, _, _) = _pair(dtype="f32", pixel_noise=0.6)
    cost_rtol, frac, rtol = TOL["f32"]
    args = (jgeo.make_residual_fn("pinhole"), jgeo.cam_retract, 6)
    jsolve = jfused.make_fused_ba_solver(
        *args, rj_fn=jgeo.make_rj_fn("pinhole") if rj == "closed" else None)
    tsolve = tfused.make_fused_ba_solver(
        tgeo.make_residual_fn("pinhole"), tgeo.cam_retract, 6,
        rj_fn=tgeo.make_rj_fn("pinhole") if rj == "closed" else None)
    if kind == "chunk":
        jplan = jfused.plan_for_problem(jp, host=False)
        tplan = tfused.plan_for_problem(tp)
    else:
        jp, jplan = jfused.densify_problem(jp)
        tp, tplan = tfused.densify_problem(tp)
    with jax.default_matmul_precision("float32"):
        ref_cost, ref_neq = jsolve.build(jp, jplan, jba.BAConfig())
    cost, neq = tsolve.build(tp, tplan, tba.BAConfig())
    np.testing.assert_allclose(float(cost), float(ref_cost), rtol=cost_rtol)
    for name, a, b in zip(NEQ_NAMES, neq, ref_neq):
        _close_scaled(a, b, frac, rtol=rtol, msg=f"{kind} {rj} {name}")


@pytest.mark.parametrize("branch", ["dense", "chunk"])
def test_bundle_adjustment_matches_jax(branch):
    """``bundle_adjustment`` against the JAX package's accelerator path
    (its ``_accel_plan`` and ``make_fused_solver``) on both branches, f64:
    the same branch, the cost falls, the final cost agrees."""
    (jp, _, _), _ = _pair(pixel_noise=0.6, seed=2)
    if branch == "chunk":
        jp = _heavy_tailed(jp)
    tp = interop.geometric_problem_from_numpy(jp, "cpu")
    cfg = dict(max_iterations=8)
    jp2, jplan = jgeo._accel_plan(jp)
    _, ref = jgeo.make_fused_solver("pinhole")(jp2, jplan,
                                               jba.BAConfig(**cfg))
    _, tplan = tgeo._accel_plan(tp)
    assert isinstance(tplan, DenseLmSchurPlan) == (branch == "dense")
    assert type(tplan).__name__ == type(jplan).__name__
    solved, res = tgeo.bundle_adjustment(tp, "pinhole", tba.BAConfig(**cfg))
    assert float(res.cost) < float(res.initial_cost)
    np.testing.assert_allclose(float(res.initial_cost),
                               float(ref.initial_cost), rtol=1e-10)
    np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=2e-4)
    assert solved.cam_states.shape == (K, 7)


@pytest.mark.parametrize("model,use_fused", [("pinhole", None), ("kb4", None),
                                             ("pinhole", False)])
def test_bundle_adjustment_converges_to_ground_truth(model, use_fused):
    """Zero pixel noise: the perturbed scene converges back to ground truth
    (tests/test_geometric_ba.py:70-92), gauge fixed by two cameras; through
    ``bundle_adjustment``, or with ``use_fused=False`` the scatter-add
    reference solver ``make_solver``."""
    problem, poses_gt, rho_gt = tsyn.synth_ba_problem(
        model, K=5, L=60, obs_per_landmark=3, seed=4, pose_noise=0.02,
        depth_noise=0.05, device="cpu")
    cfg = tba.BAConfig(max_iterations=30, huber_delta=1.0,
                       function_tolerance=1e-16)
    if use_fused is False:
        solved, res = tgeo.make_solver(model)(problem, cfg)
    else:
        solved, res = tgeo.bundle_adjustment(problem, model, cfg)
    assert float(res.cost) < 1e-14, float(res.cost)
    err = tse3.log(tse3.compose(tse3.inverse(poses_gt), solved.cam_states))
    assert float(torch.linalg.norm(err, dim=-1).max()) < 1e-7
    np.testing.assert_allclose(solved.inv_depth.numpy(), rho_gt.numpy(),
                               rtol=1e-6)


def test_geometric_problem_round_trip():
    """A JAX problem into the port and back through numpy, unchanged."""
    (jp, _, _), _ = _pair(dtype="f32")
    tp = interop.geometric_problem_from_numpy(jp, "cpu")
    assert tp.inv_depth.dtype == torch.float32
    assert tp.obs.anchor_cam.dtype == torch.int64
    back = interop.problem_to_numpy(tp)
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(tuple(back))):
        np.testing.assert_array_equal(np.asarray(a), b)
