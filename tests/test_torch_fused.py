"""Parity of the port's plan-based fused solver (optim/fused.py) and the
photometric solvers built on it (models/photometric_ba.py) with the JAX
package's, on ``synth_pba_problem(K=5, L=96, H=64, W=96)``.

Held at the three levels of the ROADMAP: the build (cost rtol 2e-4,
normal-equation pieces atol 3e-3 * max|ref| with rtol 2e-3 in f32; 1e-8
relative in f64, where only the association order differs), the damped
solve on the same normal equations, and the final cost of a solve (rtol
2e-4), never the accept sequence.  The kernel-sampled solvers run their
plain sampler here and are held to the JAX gather solve at the JAX
package's own kernel-vs-gather tolerances (cost rtol 1e-4, poses and
depths atol 2e-4; tests/test_photometric_ba.py).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.core import cameras as jcam
from photometric_bundle_adjustment_tpu.models import photometric_ba as jpba
from photometric_bundle_adjustment_tpu.models import synthetic as jsyn
from photometric_bundle_adjustment_tpu.optim import ba as jba
from photometric_bundle_adjustment_tpu.optim import fused as jfused
from photometric_bundle_adjustment_tpu_torch import interop
from photometric_bundle_adjustment_tpu_torch.models import photometric_ba as tpba
from photometric_bundle_adjustment_tpu_torch.optim import ba as tba
from photometric_bundle_adjustment_tpu_torch.optim import fused as tfused

torch.set_num_threads(1)

K, L, H, W = 5, 96, 64, 96
HUBER = 9.0
NEQ_NAMES = ["H_cc", "S_corr0", "rhs_corr0", "H_pp", "g_c", "g_p", "M",
             "inv0"]
# (cost rtol, piece atol as a fraction of max|ref|, piece rtol)
TOL = {"f32": (2e-4, 3e-3, 2e-3), "f64": (1e-8, 1e-8, 1e-8)}


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close_scaled(port, ref, frac, rtol=0.0, msg=""):
    port, ref = _np(port), _np(ref)
    scale = max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(port, ref, atol=frac * scale, rtol=rtol,
                               err_msg=msg)


def _assert_plans_equal(port, ref):
    for name, a, b in zip(type(ref)._fields, port, ref):
        if isinstance(b, tuple):
            _assert_plans_equal(a, b)
        else:
            assert a.dtype == torch.int64, name
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=name)


def _with_model(problem, model: str):
    """The JAX problem seen through ``model``: its distortion terms from
    the reference's test intrinsics on the problem's own focal lengths and
    centre (the images stay the pinhole renders)."""
    if model == "pinhole":
        return problem
    intr = np.asarray(problem.obs.aux.intr_ref).copy()
    intr[:, 4:] = np.asarray(jcam.test_params(model))[4:]
    intr = jnp.asarray(intr, problem.inv_depth.dtype)
    aux = problem.obs.aux._replace(intr_ref=intr, intr_target=intr)
    return problem._replace(obs=problem.obs._replace(aux=aux))


def _make_case(dtype, model="pinhole"):
    jdt = jnp.float32 if dtype == "f32" else jnp.float64
    problem, images_flat, _, _, _, _ = jsyn.synth_pba_problem(
        K=K, L=L, H=H, W=W, pose_noise=0.01, depth_noise=0.05, dtype=jdt)
    images_flat = jnp.asarray(np.asarray(images_flat), jdt)
    problem = jax.tree_util.tree_map(
        lambda x: x.astype(jdt) if hasattr(x, "dtype")
        and jnp.issubdtype(x.dtype, jnp.floating) else x, problem)
    problem = _with_model(problem, model)
    tproblem = interop.problem_from_numpy(problem, "cpu")
    timages = interop.array_from_numpy(images_flat, "cpu")
    return SimpleNamespace(
        model=model, problem=problem, images=images_flat, tproblem=tproblem,
        timages=timages,
        jsolve=jpba.make_fused_solver(model, images_flat, H, W),
        tsolve=tpba.make_fused_solver(model, timages, H, W, device="cpu"))


@pytest.fixture(scope="module")
def cases():
    """f32 and f64 pinhole cases, and the f32 problem in double sphere
    (the camera model of the EuRoC-scale map)."""
    out = {d: _make_case(d) for d in ("f32", "f64")}
    out["ds"] = _make_case("f32", "ds")
    return out


def _plans(case, kind):
    """(JAX problem, JAX plan, port problem, port plan) of one layout."""
    if kind == "chunk":
        return (case.problem, jfused.plan_for_problem(case.problem, host=False),
                case.tproblem, tfused.plan_for_problem(case.tproblem))
    jp, jplan = jfused.densify_problem(case.problem)
    tp, tplan = tfused.densify_problem(case.tproblem)
    return jp, jplan, tp, tplan


def test_plan_for_problem_matches_jax(cases):
    c = cases["f32"]
    _, jplan, _, tplan = _plans(c, "chunk")
    _assert_plans_equal(tplan, jplan)
    kw = dict(pair_chunk=16, lm_chunk=4, pow2_buckets=False)
    _assert_plans_equal(tfused.plan_for_problem(c.tproblem, **kw),
                        jfused.plan_for_problem(c.problem, host=False, **kw))


def test_densify_problem_matches_jax(cases):
    c = cases["f32"]
    # drop a few observations so the layout has padding slots
    valid = np.asarray(c.problem.obs.valid).copy()
    valid[::7] = 0
    jprob = c.problem._replace(obs=c.problem.obs._replace(
        valid=jnp.asarray(valid)))
    tprob = c.tproblem._replace(obs=c.tproblem.obs._replace(
        valid=torch.as_tensor(valid)))
    jp, jplan = jfused.densify_problem(jprob)
    tp, tplan = tfused.densify_problem(tprob)
    _assert_plans_equal(tplan, jplan)
    assert (np.asarray(jp.obs.valid) == 0).any()
    for name in ("anchor_cam", "target_cam", "landmark", "valid"):
        np.testing.assert_array_equal(_np(getattr(tp.obs, name)),
                                      _np(getattr(jp.obs, name)),
                                      err_msg=name)
    for name in tp.obs.aux._fields:
        np.testing.assert_array_equal(_np(getattr(tp.obs.aux, name)),
                                      _np(getattr(jp.obs.aux, name)),
                                      err_msg=name)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("kind", ["chunk", "dense"])
def test_build_matches_jax(cases, kind, dtype):
    c = cases[dtype]
    cost_rtol, frac, rtol = TOL[dtype]
    jp, jplan, tp, tplan = _plans(c, kind)
    ref_cost, ref_neq = c.jsolve.build(
        jp, jplan, jba.BAConfig(huber_delta=HUBER))
    cost, neq = c.tsolve.build(tp, tplan, tba.BAConfig(huber_delta=HUBER))
    assert neq[0].dtype == (torch.float32 if dtype == "f32" else torch.float64)
    np.testing.assert_allclose(float(cost), float(ref_cost), rtol=cost_rtol)
    for name, a, b in zip(NEQ_NAMES, neq, ref_neq):
        _close_scaled(a, b, frac, rtol=rtol, msg=f"{kind} {dtype} {name}")


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_solve_lam_matches_jax(cases, dtype):
    c = cases[dtype]
    frac = 2e-3 if dtype == "f32" else 1e-8
    jp, jplan, _, _ = _plans(c, "chunk")
    cfg = jba.BAConfig(huber_delta=HUBER)
    _, ref_neq = c.jsolve.build(jp, jplan, cfg)
    neq = tuple(interop.array_from_numpy(a, "cpu") for a in ref_neq)
    for lam in (1e-4, 1e-1):
        dc_ref, dp_ref = c.jsolve.solve_lam(
            ref_neq, jplan, jnp.asarray(lam, ref_neq[0].dtype),
            ~jp.fixed_cams, cfg)
        dc, dp = tfused.solve_lam(neq, lam, ~c.tproblem.fixed_cams,
                                  tba.BAConfig(huber_delta=HUBER))
        _close_scaled(dc, dc_ref, frac, msg=f"delta_c at lambda {lam}")
        _close_scaled(dp, dp_ref, frac, msg=f"delta_p at lambda {lam}")
    # an indefinite system gives NaN deltas, so the LM loop rejects the try
    bad = (-neq[0],) + neq[1:]
    dc, dp = tfused.solve_lam(bad, 1e-4, ~c.tproblem.fixed_cams,
                              tba.BAConfig())
    assert torch.isnan(dc).all() and torch.isnan(dp).any()


@pytest.fixture(scope="module")
def jax_solves(cases):
    """The JAX gather solves (5 iterations, Huber 9), keyed by (case,
    layout, cost_from_build): of the f32 pinhole problem the classic and
    fused-cost loops on the chunk plan and the classic loop on the
    slot-major layout; of the double-sphere problem the classic loop on
    the chunk plan."""
    out = {}
    for name, kind, cfb in (("f32", "chunk", False), ("f32", "chunk", True),
                            ("f32", "dense", False), ("ds", "chunk", False)):
        c = cases[name]
        jp, jplan, _, _ = _plans(c, kind)
        cfg = jba.BAConfig(max_iterations=5, huber_delta=HUBER,
                           cost_from_build=cfb)
        out[name, kind, cfb] = c.jsolve(jp, jplan, cfg)
    return out


@pytest.mark.parametrize("cost_from_build", [False, True])
def test_solve_loops_match_jax(cases, jax_solves, cost_from_build):
    c = cases["f32"]
    _, _, tp, tplan = _plans(c, "chunk")
    cfg = tba.BAConfig(max_iterations=5, huber_delta=HUBER,
                       cost_from_build=cost_from_build)
    _, res = c.tsolve(tp, tplan, cfg)
    _, ref = jax_solves["f32", "chunk", cost_from_build]
    np.testing.assert_allclose(float(res.initial_cost),
                               float(ref.initial_cost), rtol=2e-4)
    np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=2e-4)
    assert float(res.cost) < float(res.initial_cost)
    assert res.iterations > 0 and res.tries >= res.iterations
    if cost_from_build:
        assert (res.builds, res.residual_passes) == (res.tries + 1, 0)
    else:
        assert res.residual_passes == res.tries + 1
        assert res.iterations <= res.builds <= res.iterations + 1


def test_imagesort_problem_matches_jax(cases):
    c = cases["f32"]
    # drop image 3 entirely: it gets no group
    keep = np.asarray(c.problem.obs.target_cam) != 3
    jprob = c.problem._replace(obs=jax.tree_util.tree_map(
        lambda x: x[keep], c.problem.obs))
    tprob = c.tproblem._replace(obs=type(c.tproblem.obs)(*(
        type(x)(*(y[torch.as_tensor(keep)] for y in x)) if isinstance(x, tuple)
        else x[torch.as_tensor(keep)] for x in c.tproblem.obs)))
    jp, jiog, jcnt = jpba.imagesort_problem(jprob, K)
    tp, tiog, tcnt = tpba.imagesort_problem(tprob, K)
    np.testing.assert_array_equal(tiog, jiog)
    np.testing.assert_array_equal(tcnt, jcnt)
    assert 3 not in tiog
    for name in ("anchor_cam", "target_cam", "landmark", "valid"):
        np.testing.assert_array_equal(_np(getattr(tp.obs, name)),
                                      _np(getattr(jp.obs, name)),
                                      err_msg=name)
    for name in tp.obs.aux._fields:
        np.testing.assert_array_equal(_np(getattr(tp.obs.aux, name)),
                                      _np(getattr(jp.obs.aux, name)),
                                      err_msg=name)


@pytest.mark.parametrize("solver,case", [("kernel_fused", "f32"),
                                         ("kernel_dense", "f32"),
                                         ("kernel_fused", "ds")])
def test_kernel_solvers_match_jax_gather_solve(cases, jax_solves, solver,
                                               case):
    """The kernel-sampled solvers on the plain sampler against the JAX
    package's gather solve: kernel_fused on the image-sorted problem with
    its chunk plan (the JAX reference on the original order),
    kernel_dense on the slot-major layout (the JAX reference on the same
    layout); in pinhole, and kernel_fused in double sphere."""
    c = cases[case]
    cfg = tba.BAConfig(max_iterations=5, huber_delta=HUBER)
    if solver == "kernel_fused":
        tp, iog, gcnt = tpba.imagesort_problem(c.tproblem, K)
        solve = tpba.make_kernel_fused_solver(c.model, c.timages, H, W,
                                              iog, gcnt, device="cpu")
        p, res = solve(tp, tfused.plan_for_problem(tp), cfg)
        p_ref, r_ref = jax_solves[case, "chunk", False]
    else:
        tp, tplan = tfused.densify_problem(c.tproblem)
        solve = tpba.make_kernel_dense_solver(c.model, c.timages, H, W, tp,
                                              K, device="cpu")
        p, res = solve(tp, tplan, cfg)
        p_ref, r_ref = jax_solves[case, "dense", False]
    np.testing.assert_allclose(float(res.cost), float(r_ref.cost), rtol=1e-4)
    np.testing.assert_allclose(_np(p.cam_states.pose),
                               _np(p_ref.cam_states.pose), atol=2e-4)
    np.testing.assert_allclose(_np(p.inv_depth), _np(p_ref.inv_depth),
                               atol=2e-4)
    assert float(res.cost) < float(res.initial_cost)


@pytest.mark.parametrize("model", ["pinhole", "eucm", "ds", "kb4"])
def test_rj_fn_matches_jax(cases, model):
    """The batched closed-form residual and Jacobian (f64) against the JAX
    package's vmapped ``make_rj_fn`` and ``make_residual_fn``, in every
    camera model of the port."""
    c = cases["f64"]
    problem = _with_model(c.problem, model)
    tproblem = interop.problem_from_numpy(problem, "cpu")
    o = problem.obs
    cams = problem.cam_states
    args_j = (jax.tree_util.tree_map(lambda x: x[o.anchor_cam], cams),
              jax.tree_util.tree_map(lambda x: x[o.target_cam], cams),
              problem.inv_depth[o.landmark], o.aux)
    to = tproblem.obs
    args_t = (tba.take_rows(tproblem.cam_states, to.anchor_cam),
              tba.take_rows(tproblem.cam_states, to.target_cam),
              tproblem.inv_depth[to.landmark], to.aux)
    r_ref, J_ref = jax.vmap(jpba.make_rj_fn(model, c.images, H, W))(*args_j)
    res_ref = jax.vmap(jpba.make_residual_fn(model, c.images, H, W))(*args_j)
    r, J = tpba.make_rj_fn(model, c.timages, H, W)(*args_t)
    res = tpba.make_residual_fn(model, c.timages, H, W)(*args_t)
    assert r.shape == (o.valid.shape[0], 8) and J.shape == r.shape + (17,)
    assert np.isfinite(_np(r)).all() and np.isfinite(_np(J)).all()
    _close_scaled(r, r_ref, 1e-10)
    _close_scaled(res, res_ref, 1e-10)
    _close_scaled(J, J_ref, 1e-9)
