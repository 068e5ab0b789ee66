"""The port's landmark-sharded distributed solve (``parallel/dist_fused``)
on the CPU: Gloo, ranks as spawned processes (``parallel/mesh.spawn``).

* ``prepare`` against the JAX package's on the geometric
  ``synth_ba_problem(K=12, L=96, 4 obs)`` and on the real EuRoC V1 map of
  ``runs/`` (heavy-tailed: up to 96 observations a landmark), chunk and
  dense layouts: every shard's observations, local indices, landmarks,
  ``lm_global_index`` and plans equal (the JAX plans are padded to common
  chunk counts; their tails are the dummies).
* One spawned group of D = 4 ranks runs every multi-rank case once: the
  photometric ``synth_pba_problem(K=4, L=64)`` against the JAX package's
  distributed solve at D = 4 (initial cost within 1e-6 relative, final
  cost within 1e-4 after 3 iterations); the geometric problem against the
  port's single-device fused solve in the chunk and dense layouts, at
  tests/test_dist_fused.py:36-50's bounds; one damped PCG solve at a fixed
  lambda against the dense Cholesky of the same reduced system (f64, CG
  to 1e-10); the partitioned LM against the replicated LM at K=24, L=192
  (tests/test_dist_fused.py:139-146's bounds).  Every case ends with
  bit-equal camera states on all ranks.
* ``mesh.selftest`` holds each collective to its definition at D = 4 and
  D = 1; a failing rank fails the call with its traceback; ``fused``
  refuses normal equations built without the Schur Gram; the multi-rank
  dry run of ``entry``.
"""

import datetime
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.models import photometric_ba as jpba
from photometric_bundle_adjustment_tpu.models import synthetic as jsyn
from photometric_bundle_adjustment_tpu.optim import ba as jba
from photometric_bundle_adjustment_tpu.parallel import dist_fused as jdist
from photometric_bundle_adjustment_tpu.parallel import mesh as jmesh
from photometric_bundle_adjustment_tpu_torch import entry, interop
from photometric_bundle_adjustment_tpu_torch.io import calib_io
from photometric_bundle_adjustment_tpu_torch.models import geometric_ba
from photometric_bundle_adjustment_tpu_torch.optim import ba, fused
from photometric_bundle_adjustment_tpu_torch.parallel import dist_fused, mesh
from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
    SfmPipeline,
)

torch.set_num_threads(1)

D = 4
TIMEOUT = datetime.timedelta(seconds=60)
WALL = 600.0
ROOT = Path(__file__).resolve().parents[1]


def spawn(fn, n, *args):
    return mesh.spawn(fn, n, *args, device="cpu", timeout=TIMEOUT,
                      wall_limit=WALL, threads=1, log=lambda s: None)


def _geo_jax(K=12, L=96, seed=0, dtype=jnp.float32, drop=0.0):
    """The JAX geometric problem (optionally 25% of its observations
    invalid, tests/test_dist_fused.py:74-77) and the port's copy on the
    CPU."""
    jp, _, _ = jsyn.synth_ba_problem(model="pinhole", K=K, L=L,
                                     obs_per_landmark=4, pixel_noise=0.5,
                                     seed=seed, dtype=dtype)
    if drop:
        rng = np.random.default_rng(3)
        v = np.asarray(jp.obs.valid).copy()
        v[rng.random(v.shape[0]) < drop] = 0
        jp = jp._replace(obs=jp.obs._replace(valid=jnp.asarray(v)))
    return jp, interop.geometric_problem_from_numpy(jp, "cpu")


def _real_map():
    """The real V1 map as a port problem (f64, CPU) and the JAX
    BAProblem of the same arrays."""
    with open(ROOT / "runs" / "map_r5_run20.pkl", "rb") as f:
        m = pickle.load(f)
    with open(ROOT / "runs" / "cache_r5" / "corners.pkl", "rb") as f:
        corners = pickle.load(f)["data"]
    calib = calib_io.load_calibration(
        str(ROOT / "refbaseline" / "artifacts" / "ref_opt_calib.json"))
    pipe = SfmPipeline.from_map(m, corners, calib, log=lambda s: None,
                                device="cpu")
    tp, _, _ = pipe._build_ba_problem(dtype=torch.float64)
    n = interop.problem_to_numpy(tp)
    jp = jba.BAProblem(
        cam_states=jnp.asarray(n.cam_states), inv_depth=jnp.asarray(n.inv_depth),
        obs=jba.BAObservations(
            anchor_cam=jnp.asarray(n.obs.anchor_cam),
            target_cam=jnp.asarray(n.obs.target_cam),
            landmark=jnp.asarray(n.obs.landmark),
            aux=tuple(jnp.asarray(a) for a in n.obs.aux),
            valid=jnp.asarray(n.obs.valid)),
        fixed_cams=jnp.asarray(n.fixed_cams), lm_valid=jnp.asarray(n.lm_valid))
    return jp, tp


def _assert_plan_prefix(jplan_d, tplan, dummies: dict):
    """Each field of the port's plan equals the JAX stacked plan's row
    block of its shard on its own rows; the JAX rows past them are the
    padding dummies."""
    for name, dummy in dummies.items():
        j = jplan_d
        t = tplan
        for part in name.split("."):
            j, t = getattr(j, part), getattr(t, part)
        j, t = np.asarray(j), np.asarray(t)
        np.testing.assert_array_equal(j[:t.shape[0]], t, err_msg=name)
        assert (j[t.shape[0]:] == dummy).all(), name


@pytest.mark.parametrize("which", ["synth", "realmap"])
@pytest.mark.parametrize("layout", ["chunk", "dense"])
def test_prepare_matches_jax(which, layout):
    jp, tp = _geo_jax() if which == "synth" else _real_map()
    js = jdist.prepare(jp, jmesh.make_mesh(D), layout=layout)
    ts = dist_fused.prepare(tp, D, layout=layout)
    np.testing.assert_array_equal(ts.lm_global_index, js.lm_global_index)
    L_s = ts.problems[0].inv_depth.shape[0]
    O_s = ts.problems[0].obs.valid.shape[0]
    assert js.problem.inv_depth.shape[0] == D * L_s
    assert js.problem.obs.valid.shape[0] == D * O_s
    # the shard of every landmark, and the contiguous ranges
    shard_of = ts.lm_global_index // L_s
    np.testing.assert_array_equal(shard_of, np.asarray(js.lm_global_index)
                                  // L_s)
    assert (np.diff(shard_of) >= 0).all() and set(shard_of) == set(range(D))
    np.testing.assert_array_equal(np.bincount(shard_of, minlength=D),
                                  ts.lm_count)
    K = tp.cam_states.shape[0]
    jo = js.problem.obs
    for d, tpd in enumerate(ts.problems):
        rows, lms = slice(d * O_s, (d + 1) * O_s), slice(d * L_s, (d + 1) * L_s)
        to = tpd.obs
        for name in ("anchor_cam", "target_cam", "landmark", "valid"):
            np.testing.assert_array_equal(getattr(to, name),
                                          np.asarray(getattr(jo, name))[rows],
                                          err_msg=f"shard {d} {name}")
        for ta, ja in zip(to.aux, jo.aux):
            np.testing.assert_array_equal(ta, np.asarray(ja)[rows])
        np.testing.assert_array_equal(
            tpd.inv_depth, np.asarray(js.problem.inv_depth)[lms])
        np.testing.assert_array_equal(
            tpd.lm_valid, np.asarray(js.problem.lm_valid)[lms])
        jplan = jax.tree_util.tree_map(lambda x, d=d: np.asarray(x)[d],
                                       js.plans)
        if layout == "chunk":
            _assert_plan_prefix(jplan, ts.plans[d], {
                "pg": O_s, "cc_rows4": K * K, "lm.gidx": O_s,
                "lm.rows": L_s, "gc_a.gidx": O_s, "gc_a.rows": K,
                "gc_t.gidx": O_s, "gc_t.rows": K, "lm_cam": K})
            np.testing.assert_array_equal(jplan.anchor_cam_of_lm,
                                          ts.plans[d].anchor_cam_of_lm)
        else:
            _assert_plan_prefix(jplan, ts.plans[d], {"pg": O_s,
                                                     "cc_rows4": K * K})
            for name in ("obs_anchor_cam", "obs_target_cam", "lm_cam",
                         "anchor_cam_of_lm"):
                np.testing.assert_array_equal(
                    getattr(jplan, name), getattr(ts.plans[d], name),
                    err_msg=name)


@pytest.fixture(scope="module")
def problems():
    jpho, imgs, H, W, _, _ = jsyn.synth_pba_problem(K=4, L=64,
                                                    dtype=jnp.float32)
    geo = _geo_jax()
    dense = _geo_jax(drop=0.25)
    big = _geo_jax(K=24, L=192)
    big64 = _geo_jax(K=24, L=192, dtype=jnp.float64)
    return dict(pho=(jpho, np.asarray(imgs), H, W), geo=geo, dense=dense,
                big=big, big64=big64)


@pytest.fixture(scope="module")
def ranks(problems):
    """Every multi-rank case on one spawned group of D ranks."""
    jpho, imgs, H, W = problems["pho"]
    tpho = interop.problem_from_numpy(jpho, "cpu")
    pho = dist_fused.Family("photometric", "pinhole",
                            torch.as_tensor(imgs), H, W)
    geo = dist_fused.Family("geometric", "pinhole")
    cfg_geo = ba.BAConfig(max_iterations=8, huber_delta=1.0)
    cfg_big = ba.BAConfig(max_iterations=6, huber_delta=1.0)
    big = dist_fused.prepare(problems["big"][1], D)
    calls = [
        (dist_fused.solve_rank,
         (dist_fused.prepare(tpho, D), pho,
          ba.BAConfig(max_iterations=3, huber_delta=9.0)), {}),
        (dist_fused.solve_rank,
         (dist_fused.prepare(problems["geo"][1], D), geo, cfg_geo), {}),
        (dist_fused.solve_rank,
         (dist_fused.prepare(problems["dense"][1], D, layout="dense"), geo,
          cfg_geo), {}),
        (dist_fused.step_rank,
         (dist_fused.prepare(problems["big64"][1], D), geo,
          ba.BAConfig(huber_delta=1.0), 1e-3), dict(n_cg=1000, cg_tol=1e-10)),
        (dist_fused.solve_rank, (big, geo, cfg_big), {}),
        (dist_fused.solve_rank, (big, geo, cfg_big),
         dict(camera_partition=True, n_cg=600, cg_tol=1e-12)),
    ]
    keys = ["pho", "geo", "dense", "step", "rep", "pcg"]
    return dict(zip(keys, spawn(mesh.run_calls, D, calls)))


def test_ranks_end_bit_equal(ranks):
    for key in ("pho", "geo", "dense", "rep", "pcg"):
        assert ranks[key]["ranks_bit_equal"], key


def test_photometric_matches_jax_distributed(problems, ranks):
    """The case of the JAX package's ``test_distributed_fused_photometric``
    on both packages at D = 4."""
    jpho, imgs, H, W = problems["pho"]
    cfg = jba.BAConfig(max_iterations=3, huber_delta=9.0)
    m = jmesh.make_mesh(D)
    flat = jnp.asarray(imgs)
    solve = jdist.make_distributed_fused_solver(
        jpba.make_residual_fn("pinhole", flat, H, W), jpba.cam_retract, 8, m,
        rj_fn=jpba.make_rj_fn("pinhole", flat, H, W))
    _, jr = solve(jdist.prepare(jpho, m), cfg)
    got = ranks["pho"]
    j0, j1 = float(jr.initial_cost), float(jr.cost)
    assert abs(got["initial_cost"] - j0) <= 1e-6 * j0
    assert abs(got["cost"] - j1) <= 1e-4 * j1 + 1e-9
    assert got["cost"] <= got["initial_cost"]
    # one psum of (cost, H_cc, S_corr0, rhs_corr0, g_c) per build
    assert got["calls"]["build.psum"] == got["builds"]
    KC = 4 * 8
    assert got["bytes"]["build.psum"] == got["builds"] * 4 * (
        1 + 2 * KC * KC + 2 * KC)


@pytest.mark.parametrize("case", ["geo", "dense"])
def test_geometric_matches_single_device(problems, ranks, case):
    """tests/test_dist_fused.py:36-50's bounds against the port's
    single-device fused solve, in the chunk and the dense layout."""
    _, tp = problems[case]
    cfg = ba.BAConfig(max_iterations=8, huber_delta=1.0)
    if case == "dense":
        p, plan = fused.densify_problem(tp)
    else:
        p, plan = tp, fused.plan_for_problem(tp)
    ps, rs = geometric_ba.make_fused_solver("pinhole")(p, plan, cfg)
    got = ranks[case]
    init = float(rs.initial_cost)
    assert abs(got["initial_cost"] - init) < 1e-6 * init + 1e-9
    assert abs(got["cost"] - float(rs.cost)) <= 1e-4 * float(rs.cost) + 1e-9
    assert np.abs(got["cam_states"] - ps.cam_states.numpy()).max() < 1e-4


def test_pcg_step_matches_dense_cholesky(ranks):
    """One damped solve at lambda = 1e-3 of the same reduced system (f64):
    the partitioned PCG, run to relative residual 1e-10, against the
    replicated Cholesky."""
    s = ranks["step"]
    scale = np.abs(s["cholesky"]).max()
    assert np.abs(s["pcg"] - s["cholesky"]).max() <= 1e-7 * scale
    assert 0 < s["pcg_cg_iterations"] < 1000
    assert s["cholesky_cg_iterations"] == 0


def test_partitioned_lm_matches_replicated(ranks):
    """tests/test_dist_fused.py:139-146's bounds at K=24, L=192."""
    rep, pcg = ranks["rep"], ranks["pcg"]
    assert np.isfinite(pcg["cost"])
    assert abs(pcg["cost"] - rep["cost"]) <= 1e-4 * rep["cost"] + 1e-9
    assert np.abs(pcg["cam_states"] - rep["cam_states"]).max() < 1e-3
    assert pcg["cg_iterations"] > 0 and rep["cg_iterations"] == 0
    # the partitioned build forms no Gram: H_cc's rows arrive by
    # psum_scatter, and the CG loop's collectives are camera-sized
    assert "build.psum_scatter" in pcg["calls"]
    assert pcg["calls"]["cg.psum_scatter"] == pcg["cg_iterations"]


def test_mesh_collectives_selftest():
    for n in (D, 1):
        out = spawn(mesh.selftest, n)
        assert out["world"] == n and out["backend"] == "gloo"
        assert len(out["checks"]) == (9 if n % 2 == 0 else 8)


def test_failing_rank_fails_the_call():
    """A rank that raises fails the whole call, with its traceback."""
    _, tp = _geo_jax(K=4, L=8)
    with pytest.raises(Exception, match="unknown problem family 'nope'"):
        spawn(dist_fused.solve_rank, 2, dist_fused.prepare(tp, 2),
              dist_fused.Family("nope", "x"), ba.BAConfig())


def test_solve_lam_refuses_normal_equations_without_gram(problems):
    _, tp = problems["geo"]
    solve = geometric_ba.make_fused_solver("pinhole")
    cfg = ba.BAConfig(skip_schur_gram=True)
    _, neq = solve.build(tp, fused.plan_for_problem(tp), cfg)
    assert neq[1] is None and neq[2] is not None
    with pytest.raises(ValueError, match="skip_schur_gram"):
        fused.solve_lam(neq, 1e-3, ~tp.fixed_cams, cfg)


def test_dryrun_multichip_on_cpu():
    out = entry.dryrun_multichip(2, device="cpu", log=lambda s: None,
                                 timeout=TIMEOUT, wall_limit=WALL, threads=1)
    for path in ("fused", "partitioned"):
        assert np.isfinite(out[path][1]) and out[path][1] <= out[path][0]
    assert out["pgo"][1] < out["pgo"][0]


def test_refine_photometric_distributed_writes_back(monkeypatch):
    """On ``synth_pba_pipe``, 2 ranks: the distributed solution agrees with
    the single-device fused solve (the ``parity`` dict: cost within 1e-3
    relative, poses within 1e-3) and is written into the map through
    ``lm_global_index``: the map's poses and inverse depths are those of
    the single-device solve, within the same bounds."""
    from photometric_bundle_adjustment_tpu_torch.models import (
        photometric_ba as pba,
    )
    from photometric_bundle_adjustment_tpu_torch.models import synthetic
    from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine

    pipe = synthetic.synth_pba_pipe(K=8, L=48, seed=1)
    problem, imgs, H, W, cams, lms = pba_refine.build_photometric_problem(
        pipe, device="cpu")
    cfg = ba.BAConfig(max_iterations=4, huber_delta=9.0,
                      function_tolerance=1e-8)
    ps, rs = pba.make_fused_solver("ds", imgs, H, W, device="cpu")(
        problem, fused.plan_for_problem(problem), cfg)
    monkeypatch.setattr(mesh, "DEFAULT_TIMEOUT", TIMEOUT)
    monkeypatch.setattr(mesh, "DEFAULT_WALL_LIMIT", WALL)
    lines = []
    res, parity = pba_refine.refine_photometric_distributed(
        pipe, n_ranks=2, max_iterations=4, log=lines.append, device="cpu")
    assert parity["cost_rel"] <= 1e-3 and parity["pose_maxdiff"] <= 1e-3
    assert float(res.cost) < float(res.initial_cost)
    assert abs(parity["cost_single"] - float(rs.cost)) <= 1e-6 * float(rs.cost)
    np.testing.assert_allclose(np.stack([pipe.cameras[f] for f in cams]),
                               ps.cam_states.pose.double().numpy(), atol=1e-3)
    np.testing.assert_allclose([pipe.landmarks[t].inv_depth for t in lms],
                               ps.inv_depth.double().numpy(), rtol=1e-2)
    assert sorted(pipe.photometric_affine) == cams
    st = pipe.distributed_stats
    assert st["ranks"] == 2 and st["backend"] == "gloo"
    assert st["ranks_bit_equal"]
    assert sum(st["valid_obs"]) == int((problem.obs.valid != 0).sum())
    assert any(s.startswith("  distributed pba (2 ranks") for s in lines)
