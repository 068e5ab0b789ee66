"""The port's geometric BA on the real EuRoC V1 map that the repo holds,
against the JAX package's, with no dataset: ``runs/map_r5_run20.pkl``
(164 cameras, 5,468 landmarks), the cached corners
``runs/cache_r5/corners.pkl`` and ``refbaseline/artifacts/ref_opt_calib.json``
(double sphere).

``SfmPipeline.from_map(...)._build_ba_problem()`` gives exactly the JAX
``SfmPipeline._build_ba_problem`` arrays on their valid prefix (the JAX
tail is padding: valid 0, fixed cameras, invalid landmarks; the port
pads nothing).  The map is heavy-tailed, so ``bundle_adjustment`` takes
the chunk branch.  The solves (3 iterations, f64, Huber 1) agree with the
JAX solve at cost rtol 2e-4, on the map as saved and on the map with its
free poses and inverse depths perturbed from a seed.  The calibration
and evaluation copies agree with the JAX package's.
"""

import pickle
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.core import se3 as jse3
from photometric_bundle_adjustment_tpu.io import calib_io as jcalib
from photometric_bundle_adjustment_tpu.models import geometric_ba as jgeo
from photometric_bundle_adjustment_tpu.optim import ba as jba
from photometric_bundle_adjustment_tpu.pipeline import sfm_pipeline as jsfm
from photometric_bundle_adjustment_tpu.utils import evaluation as jeval
from photometric_bundle_adjustment_tpu_torch.io import calib_io as tcalib
from photometric_bundle_adjustment_tpu_torch.models import geometric_ba as tgeo
from photometric_bundle_adjustment_tpu_torch.optim import ba as tba
from photometric_bundle_adjustment_tpu_torch.optim.schur_plan import SchurPlan
from photometric_bundle_adjustment_tpu_torch.pipeline import sfm_pipeline as tsfm
from photometric_bundle_adjustment_tpu_torch.utils import evaluation as teval

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MAP = ROOT / "runs" / "map_r5_run20.pkl"
CORNERS = ROOT / "runs" / "cache_r5" / "corners.pkl"
CALIB = ROOT / "refbaseline" / "artifacts" / "ref_opt_calib.json"
TRAJ = ROOT / "refbaseline" / "artifacts" / "run_v1_trajectory.txt"


@pytest.fixture(scope="module")
def pipes():
    with open(MAP, "rb") as f:
        m = pickle.load(f)
    with open(CORNERS, "rb") as f:
        corners = pickle.load(f)["data"]
    tpipe = tsfm.SfmPipeline.from_map(m, corners, tcalib.load_calibration(
        str(CALIB)), log=lambda *a: None, device="cpu")
    # the JAX pipeline as apps/pba.py --map-in sets it up, on placeholder
    # images (only their keys are read) and the cached corners
    images = {f: np.zeros((2, 2), np.uint8) for f in corners}
    jpipe = jsfm.SfmPipeline(images, jcalib.load_calibration(str(CALIB)),
                             log=lambda *a: None)
    jpipe.corners = corners
    jpipe.cameras = dict(m["cameras"])
    jpipe.tracks = dict(m["tracks"])
    jpipe.landmarks = {
        t: jsfm.Landmark(d["inv_depth"], dict(d["obs"]),
                         dict(d.get("outlier_obs", {})))
        for t, d in m["landmarks"].items()}
    return tpipe, jpipe


@pytest.fixture(scope="module")
def problems(pipes):
    tpipe, jpipe = pipes
    return tpipe._build_ba_problem(), jpipe._build_ba_problem()


def test_from_map_and_landmarks_match_jax(pipes):
    tpipe, jpipe = pipes
    assert tpipe.fcids == sorted(jpipe.fcids)
    assert len(tpipe.cameras) == 164 and len(tpipe.landmarks) == 5468
    for t in list(jpipe.landmarks)[::97]:
        tl, jl = tpipe.landmarks[t], jpipe.landmarks[t]
        assert tl.anchor() == jl.anchor()
        for a, b in zip(tl.sorted_obs_arrays(), jl.sorted_obs_arrays()):
            np.testing.assert_array_equal(a, b)


def test_build_ba_problem_matches_jax(problems):
    (tp, tcams, tlms), (jp, jcams, jlms) = problems
    assert tcams == jcams and tlms == jlms
    K, L = len(tcams), len(tlms)
    O = tp.obs.valid.shape[0]
    assert (K, L, O) == (164, 5468, 28786 - 5468)
    np.testing.assert_array_equal(tp.cam_states.numpy(),
                                  np.asarray(jp.cam_states)[:K])
    np.testing.assert_array_equal(tp.inv_depth.numpy(),
                                  np.asarray(jp.inv_depth)[:L])
    for name in ("anchor_cam", "target_cam", "landmark", "valid"):
        np.testing.assert_array_equal(
            getattr(tp.obs, name).numpy(),
            np.asarray(getattr(jp.obs, name))[:O], err_msg=name)
    for name in tp.obs.aux._fields:
        np.testing.assert_array_equal(
            getattr(tp.obs.aux, name).numpy(),
            np.asarray(getattr(jp.obs.aux, name))[:O], err_msg=name)
    np.testing.assert_array_equal(tp.fixed_cams.numpy(),
                                  np.asarray(jp.fixed_cams)[:K])
    assert tp.lm_valid.all() and tp.obs.valid.all()
    assert tp.inv_depth.dtype == torch.float64
    # the JAX tail is padding only
    assert (np.asarray(jp.obs.valid)[O:] == 0).all()
    assert np.asarray(jp.fixed_cams)[K:].all()
    assert not np.asarray(jp.lm_valid)[L:].any()


def _perturbed(jp, K, L, seed=0):
    """The JAX problem with its free poses moved by 2e-3 tangent noise and
    its inverse depths by 1% (numpy seed)."""
    rng = np.random.default_rng(seed)
    free = ~np.asarray(jp.fixed_cams)
    free[K:] = False
    d = np.zeros(np.shape(jp.cam_states)[:1] + (6,))
    d[free] = rng.normal(0, 2e-3, (int(free.sum()), 6))
    poses = np.asarray(jse3.right_plus(jp.cam_states, jnp.asarray(d)))
    rho = np.asarray(jp.inv_depth).copy()
    rho[:L] *= 1.0 + rng.normal(0, 0.01, L)
    return jp._replace(cam_states=jnp.asarray(poses),
                       inv_depth=jnp.asarray(rho))


@pytest.mark.parametrize("state", ["saved", "perturbed"])
def test_real_map_solve_matches_jax(problems, state):
    (tp, tcams, tlms), (jp, _, _) = problems
    K, L = len(tcams), len(tlms)
    if state == "perturbed":
        jp = _perturbed(jp, K, L)
        tp = tp._replace(
            cam_states=torch.as_tensor(np.asarray(jp.cam_states)[:K]),
            inv_depth=torch.as_tensor(np.asarray(jp.inv_depth)[:L]))
    _, plan = tgeo._accel_plan(tp)
    assert isinstance(plan, SchurPlan)
    _, ref = jgeo.bundle_adjustment(jp, "ds", jba.BAConfig(max_iterations=3))
    solved, res = tgeo.bundle_adjustment(tp, "ds",
                                         tba.BAConfig(max_iterations=3))
    np.testing.assert_allclose(float(res.initial_cost),
                               float(ref.initial_cost), rtol=1e-10)
    np.testing.assert_allclose(float(res.cost), float(ref.cost), rtol=2e-4)
    assert float(res.cost) <= float(res.initial_cost)
    if state == "perturbed":
        assert float(res.cost) < 0.5 * float(res.initial_cost)
    assert torch.isfinite(solved.cam_states).all()


def test_calibration_and_evaluation_copies_match_jax(pipes):
    tpipe, _ = pipes
    tc, jc = tcalib.load_calibration(str(CALIB)), jcalib.load_calibration(
        str(CALIB))
    np.testing.assert_array_equal(tc.T_i_c, jc.T_i_c)
    np.testing.assert_array_equal(tc.intrinsics, jc.intrinsics)
    assert (tc.cam_types, tc.widths, tc.heights, tc.num_cams) == (
        jc.cam_types, jc.widths, jc.heights, jc.num_cams)
    ref = {}
    for line in TRAJ.read_text().splitlines():
        f = line.split()
        if f and f[0] == "CAMERA":
            ref[(int(f[1]), int(f[2]))] = np.array(f[3:10], float)
    common = {k: v for k, v in tpipe.cameras.items() if k in ref}
    est = teval.trajectory_from_cameras(common)
    gt = teval.trajectory_from_cameras({k: ref[k] for k in common})
    np.testing.assert_array_equal(est, jeval.trajectory_from_cameras(common))
    for with_scale in (False, True):
        s, R, t = teval.umeyama_alignment(est, gt, with_scale)
        s_j, R_j, t_j = jeval.umeyama_alignment(est, gt, with_scale)
        np.testing.assert_allclose(R, R_j, atol=1e-12)
        np.testing.assert_allclose(t, t_j, atol=1e-12)
        assert s == pytest.approx(s_j, rel=1e-12)
        rmse = teval.ate_rmse(est, gt, with_scale)
        assert rmse == pytest.approx(jeval.ate_rmse(est, gt, with_scale),
                                     rel=1e-12)
        # the saved map lies within centimetres of the reference run
        assert rmse < 0.05, rmse


def test_saved_map_is_converged(problems):
    """The saved map is the JAX pipeline's last BA: in f64 no LM step
    lowers its cost, and a zero retraction alone raises it, by about
    0.003 of 6,863, since it renormalises the map's f32-stored
    quaternions."""
    (tp, _, _), _ = problems
    cost_fn = tba.make_residual_cost(tgeo.make_residual_fn("ds"))
    cfg = tba.BAConfig()
    c0 = float(cost_fn(tp, cfg))
    zero = tp._replace(cam_states=tgeo.cam_retract(
        tp.cam_states, torch.zeros(tp.cam_states.shape[0], 6,
                                   dtype=torch.float64)))
    rise = float(cost_fn(zero, cfg)) - c0
    assert 0.002 < rise < 0.004, rise
    _, res = tgeo.bundle_adjustment(tp, "ds", tba.BAConfig(max_iterations=2))
    assert res.iterations == 0 and float(res.cost) == c0
