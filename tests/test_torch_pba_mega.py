"""Parity of the port's megakernel solve (ops/pba_mega.py) with the JAX
package's chunk-plan family, on the same numpy-seeded toy problem
(K=12 cameras, L=48 landmarks, 3 observations each, 64x96 images).

The JAX side runs its Pallas kernel in interpret mode on the CPU, as
tests/test_pba_mega.py does; the port runs the kernel's plain PyTorch
version, which is what ``mega_rj`` calls for CPU tensors.  The JAX f32
kernel samples through split-bf16 panels (about 2^-15 relative), so
Jacobian and payload rows are held to atol 3e-3 * max|ref| and the
normal equations to the reference's own build tolerances (cost rtol 2e-4,
pieces atol 3e-3 * max|ref| with rtol 2e-3).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.core import cameras as jcam
from photometric_bundle_adjustment_tpu.ops import pba_mega as jmega
from photometric_bundle_adjustment_tpu.optim import ba as jba
from photometric_bundle_adjustment_tpu_torch import interop
from photometric_bundle_adjustment_tpu_torch.ops import pba_mega as tmega
from photometric_bundle_adjustment_tpu_torch.optim import ba as tba
from scripts.profile_pba import build_euroc_scale_pba

torch.set_num_threads(1)

HUBER = 9.0
NEQ_NAMES = ["H_cc", "S_corr0", "rhs_corr0", "H_pp", "g_c", "g_p", "M",
             "inv0"]


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close_scaled(port, ref, frac, rtol=0.0, msg=""):
    port, ref = _np(port), _np(ref)
    scale = max(np.abs(ref).max(), 1e-6)
    np.testing.assert_allclose(port, ref, atol=frac * scale, rtol=rtol,
                               err_msg=msg)


def _toy_problem(model="pinhole", seed=2):
    problem, images_flat, H, W = build_euroc_scale_pba(
        K=12, L=48, obs_per_lm=3, H=64, W=96, seed=seed, dtype=jnp.float32,
    )
    K = problem.cam_states.pose.shape[0]
    rng = np.random.default_rng(seed + 100)
    affine = np.stack([rng.normal(0, 0.05, K), rng.normal(0, 3.0, K)], -1)
    problem = problem._replace(cam_states=problem.cam_states._replace(
        affine=jnp.asarray(affine, jnp.float32)))
    if model != "pinhole":
        intr = np.asarray(jcam.test_params(model, jnp.float32)).copy()
        intr[:4] = [60.0, 60.0, W / 2, H / 2]
        O = problem.obs.valid.shape[0]
        aux = problem.obs.aux._replace(
            intr_ref=jnp.tile(jnp.asarray(intr), (O, 1)),
            intr_target=jnp.tile(jnp.asarray(intr), (O, 1)),
        )
        problem = problem._replace(obs=problem.obs._replace(aux=aux))
    return problem, images_flat, H, W


def _jax_consts(model, problem, K):
    cplan, meta, idx = jmega.build_chunk_mega_plan(problem, K)
    return cplan, meta, idx, jmega.make_mega_consts(model, problem, meta, idx)


def _port_consts(model, tproblem, K):
    cplan, meta, idx = tmega.build_chunk_mega_plan(tproblem, K)
    return cplan, meta, idx, tmega.make_mega_consts(model, tproblem, meta, idx)


@pytest.fixture(scope="module")
def case():
    model = "pinhole"
    problem, images_flat, H, W = _toy_problem(model)
    K = problem.cam_states.pose.shape[0]
    tproblem = interop.problem_from_numpy(problem, "cpu")
    images = interop.array_from_numpy(images_flat, "cpu").reshape(-1, H, W)
    jmega_solver = jmega.make_mega_solver(
        model, images_flat, H, W, problem, K, interpret=True
    )
    tsolver = tmega.make_mega_solver(
        model, interop.array_from_numpy(images_flat, "cpu"), H, W, tproblem,
        K, device="cpu",
    )
    return SimpleNamespace(model=model, problem=problem, tproblem=tproblem,
                           images=images, H=H, W=W, K=K, jsolve=jmega_solver,
                           tsolve=tsolver)


def test_chunk_plan_arrays_identical(case):
    jc, jmeta, jidx, jconsts = _jax_consts(case.model, case.problem, case.K)
    tc, tmeta, tidx, tconsts = _port_consts(case.model, case.tproblem, case.K)
    for name in ("pg", "cc_rows4", "lm_cam", "anchor_cam_of_lm"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name),
                                      err_msg=name)
    for name in ("lm", "gc_a", "gc_t"):
        for leaf in ("gidx", "rows"):
            np.testing.assert_array_equal(
                getattr(getattr(tc, name), leaf),
                getattr(getattr(jc, name), leaf), err_msg=f"{name}.{leaf}")
    for key in ("order", "take", "Og", "zrow"):
        np.testing.assert_array_equal(tmeta[key], jmeta[key], err_msg=key)
    # the JAX tuple also carries each row's target image, which the port's
    # kernel reads per group from iog instead
    jidx = jidx[:3] + jidx[4:]
    for a, b in zip(tidx, jidx):
        np.testing.assert_array_equal(a, b)
    for name in ("an", "tn", "lm", "iog", "cnt"):
        np.testing.assert_array_equal(_np(getattr(tconsts, name)),
                                      _np(getattr(jconsts, name)),
                                      err_msg=name)
    for name in ("d3", "intr_t", "refp"):
        np.testing.assert_allclose(_np(getattr(tconsts, name)),
                                   _np(getattr(jconsts, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("model", ["pinhole", "eucm", "ds", "kb4"])
def test_warp_slabs_matches_jax(model):
    problem, _, _, _ = _toy_problem(model, seed=5)
    K = problem.cam_states.pose.shape[0]
    tproblem = interop.problem_from_numpy(problem, "cpu")
    *_, jconsts = _jax_consts(model, problem, K)
    *_, tconsts = _port_consts(model, tproblem, K)
    ref = jmega.warp_slabs(model, problem.cam_states, problem.inv_depth,
                           jconsts)
    port = tmega.warp_slabs(model, tproblem.cam_states, tproblem.inv_depth,
                            tconsts)
    np.testing.assert_array_equal(_np(port[2]), _np(ref[2]))
    for name, a, b in zip(["ux", "uy", "GA", "GB"],
                          [port[0], port[1], port[3], port[4]],
                          [ref[0], ref[1], ref[3], ref[4]]):
        _close_scaled(a, b, 1e-5, rtol=1e-4, msg=name)


def _kernel_inputs(case):
    """The JAX warp of the toy problem, with a few observations pushed off
    the image and one made non-finite; numpy arrays."""
    consts = case.jsolve.consts
    ux, uy, _, GA, GB = jmega.warp_slabs(
        case.model, case.problem.cam_states, case.problem.inv_depth, consts)
    ux, uy = np.array(ux), np.array(uy)
    ux[:, 3] -= 200.0           # left of the image
    uy[:, 5] += 150.0           # below the image
    ux[:, 7] = -1e6             # a non-finite projection
    uy[:, 7] = -1e6
    A = np.asarray(case.problem.cam_states.affine)
    an, tn = np.asarray(consts.an), np.asarray(consts.tn)
    aff = np.stack([A[an, 0], A[an, 1], A[tn, 0], A[tn, 1]], 0)
    return dict(ux=ux, uy=uy, GA=np.array(GA), GB=np.array(GB),
                refp=np.array(consts.refp), aff=aff.astype(np.float32),
                iog=np.array(consts.iog), cnt=np.array(consts.cnt))


def test_mega_rj_reference_matches_jax_kernel(case):
    x = _kernel_inputs(case)
    consts = case.jsolve.consts
    ref = np.asarray(jmega.mega_rj(
        case.jsolve.images_pad, x["ux"], x["uy"], x["GA"], x["GB"],
        x["refp"], x["aff"], consts.iog, consts.cnt, consts.ictl,
        consts.inxt, HW=case.jsolve.HW, huber_delta=HUBER, interpret=True,
    ))
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    port = tmega.mega_rj(case.images, t["ux"], t["uy"], t["GA"], t["GB"],
                         t["refp"], t["aff"], t["iog"], t["cnt"], HUBER)
    port = _np(port)
    assert port.shape == ref.shape == (tmega.OUT_ROWS, x["ux"].shape[1])
    # the non-finite projection poisons its residuals and cost with NaN
    assert np.isnan(port[tmega.ROW_COST, 7]) and np.isnan(ref[tmega.ROW_COST, 7])
    ok = np.isfinite(ref[tmega.ROW_COST])
    assert ok.sum() == ok.size - 1
    np.testing.assert_allclose(port[tmega.ROW_COST, ok].sum(),
                               ref[tmega.ROW_COST, ok].sum(), rtol=2e-4)
    for name, rows in [("J", slice(0, 136)), ("r*sw", slice(136, 144)),
                       ("cost", slice(144, 145)), ("A0", slice(145, 162)),
                       ("A1", slice(162, 179)), ("pad", slice(179, 184))]:
        _close_scaled(port[rows][:, ok], ref[rows][:, ok], 3e-3, msg=name)


def test_mega_rj_padding_rows_are_exact_zeros(case):
    x = _kernel_inputs(case)
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    # garbage (non-finite) slabs in the padding rows must not leak out
    lane = np.arange(x["ux"].shape[1]) % tmega.GROUP
    pad = lane >= np.repeat(x["cnt"], tmega.GROUP)
    assert pad.any()
    t["GA"][:, torch.as_tensor(pad)] = float("nan")
    t["ux"][:, torch.as_tensor(pad)] = -1e6
    out = _np(tmega.mega_rj(case.images, t["ux"], t["uy"], t["GA"], t["GB"],
                            t["refp"], t["aff"], t["iog"], t["cnt"], HUBER))
    assert (out[:, pad] == 0.0).all()
    assert np.isfinite(out[:, ~pad & (np.arange(pad.size) != 7)]).all()


def test_build_mega_chunk_matches_jax(case):
    cfg_j = jba.BAConfig(max_iterations=1, huber_delta=HUBER,
                         schur_matmul_precision="highest")
    cfg_t = tba.BAConfig(max_iterations=1, huber_delta=HUBER)
    ref_cost, ref_neq = case.jsolve.build(case.problem, cfg_j)
    cost, neq = case.tsolve.build(case.tproblem, cfg_t)
    np.testing.assert_allclose(float(cost), float(ref_cost), rtol=2e-4)
    for name, a, b in zip(NEQ_NAMES, neq, ref_neq):
        _close_scaled(a, b, 3e-3, rtol=2e-3, msg=f"neq piece {name}")


def test_solve_lam_matches_jax(case):
    cfg_j = jba.BAConfig(max_iterations=1, huber_delta=HUBER,
                         schur_matmul_precision="highest")
    cfg_t = tba.BAConfig(max_iterations=1, huber_delta=HUBER)
    _, ref_neq = case.jsolve.build(case.problem, cfg_j)
    free_j = ~case.problem.fixed_cams
    free_t = ~case.tproblem.fixed_cams
    neq_t = tuple(interop.array_from_numpy(a, "cpu") for a in ref_neq)
    for lam in (1e-4, 1e-1):
        dc_ref, dp_ref = case.jsolve.solve_lam(
            ref_neq, jnp.asarray(lam, jnp.float32), free_j, cfg_j)
        dc, dp = case.tsolve.solve_lam(neq_t, lam, free_t, cfg_t)
        _close_scaled(dc, dc_ref, 2e-3, msg=f"delta_c at lambda {lam}")
        _close_scaled(dp, dp_ref, 2e-3, msg=f"delta_p at lambda {lam}")


def test_solve_lam_rejects_indefinite_system(case):
    cfg = tba.BAConfig()
    _, neq = case.tsolve.build(case.tproblem, cfg)
    # a negative-definite camera block: Cholesky fails, the step is NaN
    bad = (-neq[0],) + tuple(neq[1:])
    dc, dp = case.tsolve.solve_lam(bad, 1e-4, ~case.tproblem.fixed_cams, cfg)
    assert torch.isnan(dc).all() and torch.isnan(dp).any()


def test_solver_rejects_unported_paths(case):
    """Both paths that were once refused are ported: a plan that is not a
    ``DenseLmSchurPlan`` is still rejected, and the bf16 tier now runs
    (tests/test_torch_mega_dense.py holds both against the JAX package)."""
    with pytest.raises(TypeError, match="DenseLmSchurPlan"):
        tmega.make_mega_solver(case.model, case.images.reshape(-1), case.H,
                               case.W, case.tproblem, case.K,
                               plan_slot=object(), device="cpu")
    _, res = case.tsolve(case.tproblem, tba.BAConfig(
        max_iterations=2, huber_delta=HUBER, sample_bf16=True))
    assert np.isfinite(float(res.cost))
    assert float(res.cost) < float(res.initial_cost)
