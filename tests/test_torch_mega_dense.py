"""Parity of the port's dense slot-major megakernel family (build_mega_plan,
build_mega2, solve_lam2) and of the kernel's bf16 tier with the JAX
package, on the same numpy-seeded problems.

The JAX side runs its Pallas kernel in interpret mode on the CPU, as
tests/test_pba_mega.py does; the port runs the kernel's plain PyTorch
version, which is what ``mega_fused`` calls for CPU tensors.  The JAX f32
kernel samples through split-bf16 panels (about 2^-15 relative), so the
normal equations are held to the ROADMAP's parity tolerances (cost rtol
2e-4, pieces atol 3e-3 * max|ref| with rtol 2e-3) and the damped-solve
deltas to atol 2e-3 * max|ref|.  The bf16 tier rounds the image taps to
bf16 (and the JAX tier its y-weights too), so it is held at the JAX
package's bf16 tier: cost rtol 2e-2, pieces atol 3e-2 * max|ref| with
rtol 5e-2.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.core import se3 as jse3
from photometric_bundle_adjustment_tpu.models import synthetic as jsynth
from photometric_bundle_adjustment_tpu.ops import pba_mega as jmega
from photometric_bundle_adjustment_tpu.optim import ba as jba
from photometric_bundle_adjustment_tpu.optim import fused as jfused
from photometric_bundle_adjustment_tpu_torch import interop
from photometric_bundle_adjustment_tpu_torch.models import synthetic
from photometric_bundle_adjustment_tpu_torch.ops import pba_mega as tmega
from photometric_bundle_adjustment_tpu_torch.optim import ba as tba
from photometric_bundle_adjustment_tpu_torch.optim import fused as tfused
from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine
from scripts.profile_pba import build_euroc_scale_pba

torch.set_num_threads(1)

HUBER = 9.0
NEQ2_NAMES = ["H_cc", "S_corr0", "rhs_corr0", "g_c", "g_p", "Ms", "inv0",
              "s"]
PARITY = (2e-4, 3e-3, 2e-3)       # cost rtol, pieces atol x max|ref|, rtol
BF16_TIER = (2e-2, 3e-2, 5e-2)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close_scaled(port, ref, frac, rtol=0.0, msg=""):
    port, ref = _np(port), _np(ref)
    scale = max(np.abs(ref).max(), 1e-6)
    np.testing.assert_allclose(port, ref, atol=frac * scale, rtol=rtol,
                               err_msg=msg)


def _cfgs(**kw):
    return (jba.BAConfig(huber_delta=HUBER, schur_matmul_precision="highest",
                         **kw),
            tba.BAConfig(huber_delta=HUBER, **kw))


@pytest.fixture(scope="module")
def case():
    """``synth_pba_problem(K=6, L=64, seed=4)`` in f32 (the problem of
    ``test_mega2_matches_mega_deltas``), densified by each package, and
    the dense solver of each."""
    problem, images_flat, H, W, _, _ = jsynth.synth_pba_problem(
        K=6, L=64, dtype=jnp.float32, seed=4)
    K = problem.cam_states.pose.shape[0]
    jprob_d, jplan_d = jfused.densify_problem(problem, pow2_buckets=False)
    tproblem = interop.problem_from_numpy(problem, "cpu")
    tprob_d, tplan_d = tfused.densify_problem(tproblem, pow2_buckets=False)
    images = interop.array_from_numpy(images_flat, "cpu")
    jsolve = jmega.make_mega_solver("pinhole", images_flat, H, W, jprob_d, K,
                                    jplan_d, interpret=True)
    tsolve = tmega.make_mega_solver("pinhole", images, H, W, tprob_d,
                                    tplan_d, device="cpu")
    return SimpleNamespace(problem=problem, tproblem=tproblem, jprob_d=jprob_d,
                           jplan_d=jplan_d, tprob_d=tprob_d, tplan_d=tplan_d,
                           images=images, H=H, W=W, K=K, jsolve=jsolve,
                           tsolve=tsolve)


def test_dense_plan_tables_identical(case):
    """The port's dense plan is the JAX plan with group rows mapped to slot
    rows (the JAX layout's ``order``): the kernel's columns are the slot
    rows themselves, empty slots zero columns."""
    jplan, jmeta, jidx = jmega.build_mega_plan(case.jprob_d, case.jplan_d,
                                               case.K)
    tplan, rows = tmega.build_mega_plan(case.tprob_d, case.tplan_d)
    valid = _np(case.tprob_d.obs.valid) != 0
    Os = valid.size
    assert not valid.all()            # the layout has empty slots
    np.testing.assert_array_equal(rows, np.where(valid, np.arange(Os), -1))
    # the pair chunks name the same slot rows; each package's dummies
    # gather a zero row (JAX: its padding row zrow, the port: an empty
    # slot).  The JAX package pads the chunk count to a multiple of 64
    # with dummy chunks; the port's count is exact
    n = tplan.pg.shape[0]
    j_slot = np.r_[jmeta["order"], -1]
    jpg = j_slot[np.asarray(jplan.pg)]
    tpg = np.where(valid[np.clip(tplan.pg, 0, Os - 1)], tplan.pg, -1)
    np.testing.assert_array_equal(tpg, jpg[:n])
    assert (rows[tplan.pg[tpg < 0]] == -1).all()
    assert (jpg[n:] == -1).all()
    assert (np.asarray(jplan.cc_rows4)[n:] == case.K ** 2).all()
    for name in ("lm_cam", "anchor_cam_of_lm"):
        np.testing.assert_array_equal(_np(getattr(tplan, name)),
                                      np.asarray(getattr(jplan, name)),
                                      err_msg=name)
    # the slot rows of the JAX layout's group rows, and no padding here
    order = jmeta["order"]
    np.testing.assert_array_equal(np.sort(order[order >= 0]),
                                  np.flatnonzero(valid))
    assert jmeta["Og"] > rows.size
    consts = tmega.make_mega_consts("pinhole", case.tprob_d, rows)
    assert consts.d3.shape == (3 * tmega.P, Os)
    np.testing.assert_array_equal(_np(consts.timg) < 0, ~valid)


def test_build_mega2_matches_jax(case):
    cfg_j, cfg_t = _cfgs(max_iterations=1)
    ref_cost, ref_neq = case.jsolve.build(case.jprob_d, cfg_j)
    cost, neq = case.tsolve.build(case.tprob_d, cfg_t)
    np.testing.assert_allclose(float(cost), float(ref_cost), rtol=PARITY[0])
    assert neq[3].shape == (tmega.C, case.K)          # g_c component-major
    for name, a, b in zip(NEQ2_NAMES, neq, ref_neq):
        assert a.shape == b.shape, name
        _close_scaled(a, b, PARITY[1], rtol=PARITY[2], msg=f"neq piece {name}")


@pytest.mark.parametrize("fixed", [(0, 1), (0, 3)])
def test_solve_lam2_matches_jax(case, fixed):
    """The JAX normal equations through both packages' solve_lam2.  A fixed
    camera that is not the last one masks different rows in the
    component-major (tile) and camera-major (repeat) orders."""
    cfg_j, cfg_t = _cfgs(max_iterations=1)
    _, ref_neq = case.jsolve.build(case.jprob_d, cfg_j)
    free = np.ones(case.K, bool)
    free[list(fixed)] = False
    with jax.default_matmul_precision("float32"):
        dc_ref, dp_ref = jmega.solve_lam2(
            ref_neq, jnp.asarray(1e-4, jnp.float32), jnp.asarray(free), cfg_j)
    neq_t = tuple(interop.array_from_numpy(a, "cpu") for a in ref_neq)
    dc, dp = case.tsolve.solve_lam(neq_t, 1e-4, torch.as_tensor(free), cfg_t)
    assert dc.shape == (case.K, tmega.C)
    assert (dc[torch.as_tensor(~free)] == 0).all()
    _close_scaled(dc, dc_ref, 2e-3, msg="delta_c")
    _close_scaled(dp, dp_ref, 2e-3, msg="delta_p")


def test_dense_matches_chunk_family(case):
    """The JAX package's ``test_mega2_matches_mega_deltas``, inside the
    port: the dense family on the slot-major problem and the chunk family
    on the original order give the same cost and damped-solve deltas."""
    cfg = tba.BAConfig(max_iterations=1, huber_delta=HUBER)
    chunk = tmega.make_mega_solver("pinhole", case.images, case.H, case.W,
                                   case.tproblem, device="cpu")
    c1, neq1 = chunk.build(case.tproblem, cfg)
    c2, neq2 = case.tsolve.build(case.tprob_d, cfg)
    np.testing.assert_allclose(float(c2), float(c1), rtol=1e-6)
    free = ~case.tproblem.fixed_cams
    dc1, dp1 = chunk.solve_lam(neq1, 1e-4, free, cfg)
    dc2, dp2 = case.tsolve.solve_lam(neq2, 1e-4, free, cfg)
    _close_scaled(dc2, dc1, 2e-3, msg="delta_c")
    _close_scaled(dp2, dp1, 2e-3, msg="delta_p")


@pytest.fixture(scope="module")
def noise_case():
    """``euroc_scale_pba`` at toy size, its poses but the two fixed ones
    perturbed by 1e-3 (as in ``test_mega_solve_reduces_cost_like_gather``):
    noise images with non-integer intensities, so the bf16 stack really
    rounds."""
    problem, images_flat, H, W = build_euroc_scale_pba(
        K=12, L=48, obs_per_lm=3, H=64, W=96, seed=4, dtype=jnp.float32)
    K = problem.cam_states.pose.shape[0]
    assert (np.asarray(images_flat) != np.round(images_flat)).any()
    noise = np.random.default_rng(7).normal(0, 1e-3, (K, 6))
    noise[:2] = 0.0
    pose = jax.vmap(jse3.right_plus)(problem.cam_states.pose,
                                     jnp.asarray(noise, jnp.float32))
    problem = problem._replace(
        cam_states=problem.cam_states._replace(pose=pose))
    jprob_d, jplan_d = jfused.densify_problem(problem, pow2_buckets=False)
    tprob_d, tplan_d = tfused.densify_problem(
        interop.problem_from_numpy(problem, "cpu"), pow2_buckets=False)
    jsolve = jmega.make_mega_solver("pinhole", images_flat, H, W, jprob_d, K,
                                    jplan_d, interpret=True)
    tsolve = tmega.make_mega_solver(
        "pinhole", interop.array_from_numpy(images_flat, "cpu"), H, W,
        tprob_d, tplan_d, device="cpu")
    return SimpleNamespace(jprob_d=jprob_d, tprob_d=tprob_d, jsolve=jsolve,
                           tsolve=tsolve)


def test_dense_solver_matches_jax(noise_case):
    """The fused-cost LM loop of both dense solvers from the same perturbed
    start, with the problem and tolerances of
    ``test_mega_solve_reduces_cost_like_gather``."""
    cfg_j, cfg_t = _cfgs(max_iterations=4, cost_from_build=True)
    c = noise_case
    prob_j, res_j = c.jsolve(c.jprob_d, cfg_j)
    prob_t, res_t = c.tsolve(c.tprob_d, cfg_t)
    assert float(res_t.cost) < float(res_t.initial_cost)
    assert res_t.tries >= res_t.iterations > 0
    np.testing.assert_allclose(float(res_t.initial_cost),
                               float(res_j.initial_cost), rtol=PARITY[0])
    np.testing.assert_allclose(float(res_t.cost), float(res_j.cost),
                               rtol=5e-3)
    np.testing.assert_allclose(_np(prob_t.cam_states.pose),
                               np.asarray(prob_j.cam_states.pose), atol=1e-4)


def _hold_at_tier(cost, neq, ref_cost, ref_neq, tol, label):
    np.testing.assert_allclose(float(cost), float(ref_cost), rtol=tol[0],
                               err_msg=label)
    for name, a, b in zip(NEQ2_NAMES, neq, ref_neq):
        _close_scaled(a, b, tol[1], rtol=tol[2], msg=f"{label}: {name}")


def test_bf16_tier_against_f32_and_jax(noise_case):
    """One solver, both tiers: the port's bf16 build against its f32 build
    and against the JAX package's bf16 build, at the JAX bf16 tier."""
    cfg_j, cfg_t = _cfgs(max_iterations=1)
    c = noise_case
    cost32, neq32 = c.tsolve.build(c.tprob_d, cfg_t)
    cost16, neq16 = c.tsolve.build(c.tprob_d, cfg_t._replace(sample_bf16=True))
    # the tier is on: the bf16 build is not the f32 build
    assert float(cost16) != float(cost32)
    assert not torch.equal(neq16[0], neq32[0])
    _hold_at_tier(cost16, neq16, cost32, neq32, BF16_TIER, "bf16 vs f32")
    ref_cost, ref_neq = c.jsolve.build(c.jprob_d,
                                       cfg_j._replace(sample_bf16=True))
    _hold_at_tier(cost16, neq16, ref_cost, ref_neq, BF16_TIER,
                  "bf16 vs JAX bf16")
    # the f32 build is unchanged by a bf16 build in between
    cost32b, _ = c.tsolve.build(c.tprob_d, cfg_t)
    assert float(cost32b) == float(cost32)


def test_bf16_reference_widens_the_stack(noise_case):
    """The plain version of the bf16 tier is the f32 plain version on the
    widened stack, exactly."""
    s = noise_case.tsolve
    p = noise_case.tprob_d
    args = (p.cam_states, p.inv_depth, s.consts, HUBER)
    bf = s.images.to(torch.bfloat16)
    out = tmega.mega_fused("pinhole", bf, *args)
    assert torch.equal(out, tmega.mega_fused_reference("pinhole", bf.float(),
                                                       *args))
    assert not torch.equal(out, tmega.mega_fused("pinhole", s.images, *args))


def test_refine_photometric_bf16_lowers_cost():
    pipe = synthetic.synth_pba_pipe(K=12, L=96, obs_per_lm=3, long_tracks=6,
                                    seed=1)
    res = pba_refine.refine_photometric(pipe, levels=2, max_iterations=4,
                                        sample_bf16=True, log=lambda s: None,
                                        device="cpu")
    assert len(pipe.photometric_levels) == 2
    for lv in pipe.photometric_levels:
        assert np.isfinite(lv["cost"]) and lv["cost"] < lv["initial_cost"], lv
    assert float(res.cost) < float(res.initial_cost)
