"""Parity of the port's megakernel solve (ops/pba_mega.py) with the JAX
package's chunk-plan family, on the same numpy-seeded toy problem
(K=12 cameras, L=48 landmarks, 3 observations each, 64x96 images).

The JAX side runs its warp and its Pallas kernel in interpret mode on the
CPU, as tests/test_pba_mega.py does, on its group layout (observations
sorted by target image, each image's range padded to 256 rows); its
outputs are permuted to the port's observation columns through the JAX
package's own layout (``mega_layout``'s ``order``).  The port runs the
kernel's plain PyTorch version, which is what ``mega_fused`` calls for CPU
tensors.  The JAX f32 kernel samples through split-bf16 panels (about
2^-15 relative), so Jacobian and payload rows are held to atol
3e-3 * max|ref| and the normal equations to the reference's own build
tolerances (cost rtol 2e-4, pieces atol 3e-3 * max|ref| with rtol 2e-3).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from photometric_bundle_adjustment_tpu.core import cameras as jcam
from photometric_bundle_adjustment_tpu.ops import patch_sample as jps
from photometric_bundle_adjustment_tpu.ops import pba_mega as jmega
from photometric_bundle_adjustment_tpu.optim import ba as jba
from photometric_bundle_adjustment_tpu_torch import interop
from photometric_bundle_adjustment_tpu_torch.ops import pba_mega as tmega
from photometric_bundle_adjustment_tpu_torch.optim import ba as tba
from photometric_bundle_adjustment_tpu_torch.optim import schur_plan as nsp
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


def _port_consts(model, tproblem):
    """The port's layout and consts; the plan and rows as numpy arrays,
    the consts made from the layout's own (tensor) rows."""
    cplan, rows = tmega.build_chunk_mega_plan(tproblem)
    consts = tmega.make_mega_consts(model, tproblem, rows)
    return pytree.tree_map(_np, cplan), _np(rows), consts


def _numpy_layout(tproblem):
    """The chunk layout as the host built it with numpy: the valid rows
    stable-sorted by target image, ``schur_plan.build_schur_plan`` on
    them, and the zero column."""
    o = tproblem.obs
    vidx = np.flatnonzero(_np(o.valid) != 0)
    vidx = vidx[np.argsort(_np(o.aux.target_img)[vidx], kind="stable")]
    plan = nsp.build_schur_plan(
        _np(o.anchor_cam)[vidx], _np(o.target_cam)[vidx],
        _np(o.landmark)[vidx], tproblem.cam_states.pose.shape[0],
        tproblem.inv_depth.shape[0], pair_chunk=tmega.PAIR_CHUNK,
        lm_chunk=tmega.LM_CHUNK, cam_chunk=tmega.CAM_CHUNK,
        pow2_buckets=False)
    return plan, np.r_[vidx, -1]


def _heavy_problem(tproblem, seed=4, O=900):
    """``tproblem``'s cameras and landmarks under a heavy-tailed graph of O
    rows: three tracks of 60 to 90 observations, the rest short, about a
    tenth of the rows invalid and five landmarks with no valid
    observation; every per-observation table gathered from the toy's
    rows so that each has O rows."""
    rng = np.random.default_rng(seed)
    K = tproblem.cam_states.pose.shape[0]
    L = tproblem.inv_depth.shape[0]
    heavy = np.repeat([3, 17, 40], [60, 75, 90])
    lm = rng.permutation(np.r_[heavy, rng.integers(0, L, O - heavy.size)])
    valid = rng.random(O) > 0.1
    valid[np.isin(lm, [5, 9, 21, 30, 44])] = False
    an = rng.integers(0, K, O)
    tn = (an + rng.integers(1, K, O)) % K
    o = tproblem.obs
    src = torch.as_tensor(rng.integers(0, o.valid.shape[0], O))
    aux = o.aux._replace(**{f: getattr(o.aux, f)[src]
                            for f in o.aux._fields})
    aux = aux._replace(target_img=torch.as_tensor(
        tn, dtype=aux.target_img.dtype))
    obs = o._replace(**{f: getattr(o, f)[src] for f in o._fields
                        if f != "aux"}, aux=aux)
    obs = obs._replace(
        anchor_cam=torch.as_tensor(an, dtype=o.anchor_cam.dtype),
        target_cam=torch.as_tensor(tn, dtype=o.target_cam.dtype),
        landmark=torch.as_tensor(lm, dtype=o.landmark.dtype),
        valid=torch.as_tensor(valid, dtype=o.valid.dtype))
    return tproblem._replace(obs=obs)


def _jax_columns(meta, rows):
    """The JAX group row of each port column but the last (the zero
    column): the inverse of the JAX layout's ``order``."""
    rows = _np(rows)
    order = meta["order"]
    g_of_obs = np.full(order.max() + 1, -1)
    g_of_obs[order[order >= 0]] = np.flatnonzero(order >= 0)
    return g_of_obs[rows[:-1]]


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
        device="cpu",
    )
    return SimpleNamespace(model=model, problem=problem, tproblem=tproblem,
                           images=images, images_flat=images_flat, H=H, W=W,
                           K=K, jsolve=jmega_solver, tsolve=tsolver)


def test_chunk_plan_arrays_identical(case):
    """The port's chunk plan is the JAX plan with group rows mapped to
    observation rows: both name the same observations in every chunk."""
    jc, jmeta, jidx, jconsts = _jax_consts(case.model, case.problem, case.K)
    tc, rows, tconsts = _port_consts(case.model, case.tproblem)
    # the JAX plans index group rows (Og = their dummy, padding rows none),
    # the port's its columns (the last, the zero column, is the dummy)
    j_obs = np.r_[jmeta["order"], -1]
    assert rows[-1] == -1 and (rows[:-1] >= 0).all()
    np.testing.assert_array_equal(rows[tc.pg], j_obs[np.asarray(jc.pg)])
    for name in ("cc_rows4", "lm_cam", "anchor_cam_of_lm"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name),
                                      err_msg=name)
    for name in ("lm", "gc_a", "gc_t"):
        t, j = getattr(tc, name), getattr(jc, name)
        np.testing.assert_array_equal(rows[t.gidx], j_obs[np.asarray(j.gidx)],
                                      err_msg=f"{name}.gidx")
        np.testing.assert_array_equal(t.rows, j.rows, err_msg=f"{name}.rows")
    # no padding: one column per valid observation, plus the zero column
    assert rows.size == int((np.asarray(case.problem.obs.valid) != 0).sum()) + 1
    assert jmeta["Og"] > rows.size
    jcol = _jax_columns(jmeta, rows)
    for name in ("an", "tn", "lm", "timg"):
        np.testing.assert_array_equal(_np(getattr(tconsts, name))[:-1],
                                      _np(getattr(jconsts, name))[jcol],
                                      err_msg=name)
    assert int(tconsts.timg[-1]) == -1
    np.testing.assert_array_equal(_np(tconsts.cols),
                                  np.stack([_np(tconsts.an), _np(tconsts.tn),
                                            _np(tconsts.lm), _np(tconsts.timg)]))
    for name in ("d3", "intr_t", "refp"):
        np.testing.assert_allclose(_np(getattr(tconsts, name))[:, :-1],
                                   _np(getattr(jconsts, name))[:, jcol],
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("graph", ["toy", "heavy"])
def test_chunk_layout_equals_numpy_plan(case, graph):
    """``build_chunk_mega_plan`` on the problem's device against the numpy
    layout the host built: the rows, and every leaf of the plan in value,
    shape and int64 dtype."""
    tproblem = (case.tproblem if graph == "toy"
                else _heavy_problem(case.tproblem))
    plans = tmega.CHUNK_PLANS
    layout = tmega.build_chunk_mega_plan(tproblem)
    assert tmega.CHUNK_PLANS == plans + 1
    ref_plan, ref_rows = _numpy_layout(tproblem)
    valid = _np(tproblem.obs.valid) != 0
    if graph == "heavy":
        assert not valid.all() and np.bincount(
            _np(tproblem.obs.landmark)[valid]).max() >= 60
    assert ref_rows.size == valid.sum() + 1
    cplan, rows = layout
    assert rows.dtype == torch.int64
    np.testing.assert_array_equal(_np(rows), ref_rows)
    port = pytree.tree_leaves(cplan)
    ref = pytree.tree_leaves(ref_plan,
                             is_leaf=lambda x: isinstance(x, np.ndarray))
    assert len(port) == len(ref) > 0
    for i, (a, b) in enumerate(zip(port, ref)):
        assert torch.is_tensor(a) and a.dtype == torch.int64, i
        assert tuple(a.shape) == b.shape, i
        np.testing.assert_array_equal(_np(a), b, err_msg=f"leaf {i}")


@pytest.mark.parametrize("model", ["pinhole", "eucm", "ds", "kb4"])
def test_warp_slabs_matches_jax(model):
    problem, _, _, _ = _toy_problem(model, seed=5)
    K = problem.cam_states.pose.shape[0]
    tproblem = interop.problem_from_numpy(problem, "cpu")
    _, jmeta, _, jconsts = _jax_consts(model, problem, K)
    _, rows, tconsts = _port_consts(model, tproblem)
    ref = jmega.warp_slabs(model, problem.cam_states, problem.inv_depth,
                           jconsts)
    port = tmega.warp_slabs(model, tproblem.cam_states, tproblem.inv_depth,
                            tconsts)
    jcol = _jax_columns(jmeta, rows)
    np.testing.assert_array_equal(_np(port[2])[:, :-1], _np(ref[2])[:, jcol])
    for name, a, b in zip(["ux", "uy", "GA", "GB"],
                          [port[0], port[1], port[3], port[4]],
                          [ref[0], ref[1], ref[3], ref[4]]):
        _close_scaled(_np(a)[:, :-1], _np(b)[:, jcol], 1e-5, rtol=1e-4,
                      msg=name)


def _pushed_state(problem):
    """The toy state with observations made off-image and non-finite
    through the state: camera 5 shifted sideways by 1.5 (its targets leave
    the image), landmark 7 at a negative inverse depth, landmark 11 at an
    infinite one (its projections are not finite)."""
    pose = np.array(problem.cam_states.pose)
    pose[5, 0] += 1.5
    rho = np.array(problem.inv_depth)
    rho[7] = -abs(rho[7])
    rho[11] = np.inf
    return problem._replace(
        cam_states=problem.cam_states._replace(pose=jnp.asarray(pose)),
        inv_depth=jnp.asarray(rho))


@pytest.mark.parametrize("model", ["pinhole", "eucm", "ds", "kb4"])
def test_fused_plain_matches_jax_kernel(case, model):
    """The kernel's plain version (``mega_fused`` on CPU tensors) against
    the JAX warp and Pallas kernel (interpret mode), in every camera
    model, with off-image and non-finite observations."""
    problem, images_flat, H, W = _toy_problem(model)
    problem = _pushed_state(problem)
    K = problem.cam_states.pose.shape[0]
    _, jmeta, _, consts = _jax_consts(model, problem, K)
    ux, uy, _, GA, GB = jmega.warp_slabs(
        model, problem.cam_states, problem.inv_depth, consts)
    A = np.asarray(problem.cam_states.affine)
    an, tn = np.asarray(consts.an), np.asarray(consts.tn)
    aff = np.stack([A[an, 0], A[an, 1], A[tn, 0], A[tn, 1]], 0)
    pad, HW = jps.pad_images(jnp.asarray(images_flat).reshape(-1, H, W))
    ref = np.asarray(jmega.mega_rj(
        jmega.split_pack_images(pad), ux, uy, GA, GB, consts.refp,
        aff.astype(np.float32), consts.iog, consts.cnt, consts.ictl,
        consts.inxt, HW=HW, huber_delta=HUBER, interpret=True))
    tproblem = interop.problem_from_numpy(problem, "cpu")
    _, rows, tconsts = _port_consts(model, tproblem)
    port = _np(tmega.mega_fused(model, case.images, tproblem.cam_states,
                                tproblem.inv_depth, tconsts, HUBER))
    assert port.shape == (tmega.OUT_ROWS, rows.size)
    assert (port[:, -1] == 0).all()          # the zero column
    ref = ref[:, _jax_columns(jmeta, rows)]
    port = port[:, :-1]
    ux_t = _np(ux)[:, _jax_columns(jmeta, rows)]
    # some observations left the image, some are not finite
    assert ((ux_t < 0) | (ux_t > W - 1)).any(axis=0).sum() >= 3
    nan = np.isnan(ref[tmega.ROW_COST])
    assert nan.sum() >= 2
    np.testing.assert_array_equal(np.isnan(port[tmega.ROW_COST]), nan)
    ok = ~nan
    np.testing.assert_allclose(port[tmega.ROW_COST, ok].sum(),
                               ref[tmega.ROW_COST, ok].sum(), rtol=2e-4)
    for name, rows_ in [("J", slice(0, 136)), ("r*sw", slice(136, 144)),
                        ("cost", slice(144, 145)), ("A0", slice(145, 162)),
                        ("A1", slice(162, 179)), ("pad", slice(179, 184))]:
        _close_scaled(port[rows_][:, ok], ref[rows_][:, ok], 3e-3, msg=name)


def test_zero_columns_are_exact_zeros(case):
    """Columns with a negative image are exact zeros whatever the state of
    their cameras: a NaN pose must not leak out."""
    rows = np.r_[-1, 0, 1, 2, -1, 3, -1]
    consts = tmega.make_mega_consts(case.model, case.tproblem, rows)
    cams = case.tproblem.cam_states
    pose = cams.pose.clone()
    pose[int(consts.an[0])] = float("nan")
    out = _np(tmega.mega_fused(case.model, case.images,
                               cams._replace(pose=pose),
                               case.tproblem.inv_depth, consts, HUBER))
    zero = rows < 0
    assert (out[:, zero] == 0.0).all()
    assert np.isnan(out[tmega.ROW_COST, ~zero]).any()
    good = _np(tmega.mega_fused(case.model, case.images, cams,
                                case.tproblem.inv_depth, consts, HUBER))
    assert (good[:, zero] == 0.0).all() and np.isfinite(good).all()


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
                               case.W, case.tproblem, plan_slot=object(),
                               device="cpu")
    _, res = case.tsolve(case.tproblem, tba.BAConfig(
        max_iterations=2, huber_delta=HUBER, sample_bf16=True))
    assert np.isfinite(float(res.cost))
    assert float(res.cost) < float(res.initial_cost)
