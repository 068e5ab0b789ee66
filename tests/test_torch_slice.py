"""The port's photometric solve end to end: parity of ``refine_photometric``
with the JAX package's on one synthetic map, and the guards around it (no
JAX import, the CPU plain path on a wide image, no silent device
fallback), and the profiling entry point on the plain path."""

import copy
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.pipeline import pba_refine as jrefine
from photometric_bundle_adjustment_tpu_torch import interop
from photometric_bundle_adjustment_tpu_torch.models import photometric_ba as pba
from photometric_bundle_adjustment_tpu_torch.models import synthetic
from photometric_bundle_adjustment_tpu_torch.ops import pba_mega
from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine

torch.set_num_threads(1)


def test_refine_photometric_matches_jax():
    """Both packages refine deep copies of one map (2 levels, 3 iterations
    each).  The JAX package runs its CPU path (gather sampler, classic LM
    loop), the port its megakernel chunk family; accept sequences may
    differ by rounding, so only costs and the final poses are compared.
    L=144 rather than 48: with 48 landmarks the 80 free camera unknowns are
    so weakly constrained that f32 rounding alone moves the two packages'
    poses up to 3e-4 apart."""
    pipe = synthetic.synth_pba_pipe(K=12, L=144, H=64, W=96, obs_per_lm=3,
                                    long_tracks=6, seed=0)
    pipe_j, pipe_t = copy.deepcopy(pipe), copy.deepcopy(pipe)
    lines = []
    res_j = jrefine.refine_photometric(pipe_j, levels=2, max_iterations=3,
                                       log=lines.append)
    res_t = pba_refine.refine_photometric(pipe_t, levels=2, max_iterations=3,
                                          log=lambda s: None, device="cpu")

    init_j = [float(re.search(r"cost (\S+) ->", s).group(1))
              for s in lines if s.startswith("  pba level")]
    init_t = [lv["initial_cost"] for lv in pipe_t.photometric_levels]
    assert [lv["level"] for lv in pipe_t.photometric_levels] == [1, 0]
    np.testing.assert_allclose(init_t, init_j, rtol=2e-4)
    np.testing.assert_allclose(float(res_t.initial_cost),
                               float(res_j.initial_cost), rtol=2e-4)
    np.testing.assert_allclose(float(res_t.cost), float(res_j.cost),
                               rtol=5e-3)
    assert float(res_t.cost) < float(res_t.initial_cost)
    for lv in pipe_t.photometric_levels:
        assert lv["cost"] < lv["initial_cost"] and lv["iterations"] > 0
    keys = sorted(pipe.cameras)
    np.testing.assert_allclose(
        np.stack([pipe_t.cameras[k] for k in keys]),
        np.stack([pipe_j.cameras[k] for k in keys]), atol=1e-4)
    for k in keys:
        np.testing.assert_allclose(pipe_t.photometric_affine[k],
                                   np.asarray(pipe_j.photometric_affine[k]),
                                   atol=1e-3)
    lm = sorted(pipe.landmarks)
    np.testing.assert_allclose(
        [pipe_t.landmarks[j].inv_depth for j in lm],
        [pipe_j.landmarks[j].inv_depth for j in lm], rtol=1e-3)


def test_port_imports_and_solves_without_jax():
    """With ``jax`` and the JAX package blocked, every module of the port
    imports (the package is walked, so later slices are covered too), the
    photometric solve runs, and so does the front end on the CPU."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["photometric_bundle_adjustment_tpu"] = None
        import numpy as np
        import torch
        import photometric_bundle_adjustment_tpu_torch as port
        names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                       port.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        from photometric_bundle_adjustment_tpu_torch.features import match, pair_matching
        from photometric_bundle_adjustment_tpu_torch.models import synthetic
        from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine
        from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import SfmPipeline
        from photometric_bundle_adjustment_tpu_torch.models import photometric_ba as pba
        from photometric_bundle_adjustment_tpu_torch.optim import ba, fused
        torch.set_num_threads(1)
        pipe = synthetic.synth_pba_pipe(K=8, L=32, seed=3)
        res = pba_refine.refine_photometric(pipe, levels=1, max_iterations=2,
                                            log=lambda s: None, device="cpu")
        assert float(res.cost) < float(res.initial_cost), res
        prob, imgs, H, W = synthetic.euroc_scale_pba(
            K=12, L=48, obs_per_lm=3, H=64, W=96, device="cpu")
        cfg = ba.BAConfig(max_iterations=2, huber_delta=9.0)
        solve = pba.make_kernel_fused_solver("pinhole", imgs, H, W, prob,
                                             device="cpu")
        _, r = solve(prob, fused.plan_for_problem(prob), cfg)
        assert float(r.cost) < float(r.initial_cost), r
        p3, plan3 = fused.densify_problem(prob)
        solve = pba.make_kernel_dense_solver("pinhole", imgs, H, W, p3,
                                             device="cpu")
        _, r = solve(p3, plan3, cfg._replace(cost_from_build=True))
        assert float(r.cost) < float(r.initial_cost), r
        seq = synthetic.synth_stereo_sequence(n_frames=2, H=120, W=160,
                                              cell=2.0, device="cpu")
        sfm = SfmPipeline(seq.images, seq.calib, log=lambda *a: None,
                          device="cpu")
        sfm.detect_keypoints()
        sfm.match_stereo()
        ids = np.array(sfm._pair_worklist())
        _, valid, desc, _ = sfm._stack_features()
        table = pair_matching.match_pairs(desc, valid, ids[:, 0], ids[:, 1])
        pairs, pvalid, count = match.matches_to_pairs(
            table, sfm.cfg.max_matches_per_pair)
        assert sum(len(m["matches"]) for m in sfm.matches.values()) > 0
        assert int(count.sum()) > 0
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "photometric_bundle_adjustment_tpu"
               or m.startswith("photometric_bundle_adjustment_tpu.")]
        assert all(sys.modules[m] is None for m in bad), bad
        print("OK", len(names), float(res.initial_cost), float(res.cost))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")
    # every module of the package was imported, this slice's included
    assert int(proc.stdout.split()[1]) >= 20


def test_plain_path_wide_image():
    """W=8448 through the plain path: on a linear ramp the bilinear value
    is exact and the gradient is (a, b)."""
    images, cams, rho, consts, (a, b, c) = synthetic.wide_image_state(device="cpu")
    out = pba_mega.mega_fused("pinhole", images, cams, rho, consts, 0.0)
    ux, uy, _, GA, GB = pba_mega.warp_slabs("pinhole", cams, rho, consts)
    N = consts.cols.shape[1]
    assert out.shape == (pba_mega.OUT_ROWS, N)
    valid = consts.timg >= 0
    assert (ux[:, valid] > 8000).all() and (ux[:, valid] < 8448 - 1.5).all()
    assert torch.isfinite(out).all()
    assert (out[:, ~valid] == 0).all()
    ramp = (a * ux.double() + b * uy.double() + c).float()
    # squared loss: sw = 1, r = I(u) - refp = I(u); GB[0] = 0, so the
    # first Jacobian column is gx GA[0] = a GA[0]
    np.testing.assert_allclose(out[136:144, valid].numpy(),
                               ramp[:, valid].numpy(), rtol=2e-6)
    assert (GB[:pba_mega.P] == 0).all()
    # the gradient is a difference of two f32 taps near 100 (ulp 7.6e-6)
    J = out[:136].reshape(pba_mega.P, 17, N)
    np.testing.assert_allclose(J[:, 0, valid].numpy(),
                               (a * GA[:pba_mega.P, valid]).numpy(),
                               atol=3e-5 * float(GA[:pba_mega.P].abs().max()))
    np.testing.assert_allclose(out[pba_mega.ROW_COST, valid].numpy(),
                               0.5 * (ramp[:, valid].double() ** 2).sum(0).numpy(),
                               rtol=1e-5)


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the guard is for hosts without it")
    pipe = synthetic.synth_pba_pipe(K=4, L=8, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pba_refine.refine_photometric(pipe, levels=1, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pba_refine.refine_photometric(pipe, levels=1, sample_bf16=True,
                                      device="cuda")
    images, cams, rho, consts, _ = synthetic.wide_image_state(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pba_mega.mega_fused("pinhole", images, cams, rho, consts, 9.0)


def _entry_point_calls():
    """Each public entry point of the port, called without a device."""
    from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
        SfmPipeline,
    )

    pipe = synthetic.synth_pba_pipe(K=4, L=8, seed=0)
    problem, images_flat, H, W, _, _ = pba_refine.build_photometric_problem(
        pipe, device="cpu")
    from photometric_bundle_adjustment_tpu_torch.optim import fused

    from photometric_bundle_adjustment_tpu_torch.scripts import (
        exp_roll,
        grid_overhead,
    )

    prob_d, plan_d = fused.densify_problem(problem)
    return {
        "make_fused_solver": lambda: pba.make_fused_solver(
            "ds", images_flat, H, W),
        "make_kernel_fused_solver": lambda: pba.make_kernel_fused_solver(
            "ds", images_flat, H, W, problem),
        "make_kernel_dense_solver": lambda: pba.make_kernel_dense_solver(
            "ds", images_flat, H, W, prob_d),
        "euroc_scale_pba": lambda: synthetic.euroc_scale_pba(
            K=12, L=8, H=32, W=48),
        "refine_photometric": lambda: pba_refine.refine_photometric(
            pipe, levels=1, log=lambda s: None),
        "build_photometric_problem": lambda:
            pba_refine.build_photometric_problem(pipe),
        "make_mega_solver": lambda: pba_mega.make_mega_solver(
            "ds", images_flat, H, W, problem),
        "make_mega_solver_dense": lambda: pba_mega.make_mega_solver(
            "ds", images_flat, H, W, prob_d, plan_d),
        "grid_overhead": lambda: grid_overhead.main([]),
        "exp_roll": lambda: exp_roll.main([]),
        "synth_pba_problem": lambda: synthetic.synth_pba_problem(),
        "wide_image_state": lambda: synthetic.wide_image_state(),
        "synth_stereo_sequence": lambda: synthetic.synth_stereo_sequence(
            n_frames=1, H=40, W=60),
        "SfmPipeline": lambda: SfmPipeline(pipe.images, pipe.calib),
        "descriptors_from_numpy": lambda: interop.descriptors_from_numpy(
            np.zeros((2, 8), np.uint32)),
    }


@pytest.mark.parametrize("name", [
    "make_fused_solver", "make_kernel_fused_solver",
    "make_kernel_dense_solver", "euroc_scale_pba", "refine_photometric", "build_photometric_problem", "make_mega_solver",
    "make_mega_solver_dense", "grid_overhead", "exp_roll",
    "synth_pba_problem", "wide_image_state", "synth_stereo_sequence",
    "SfmPipeline",
    "descriptors_from_numpy"])
def test_entry_points_default_to_cuda(name):
    """Without a device argument every entry point runs on the card; on a
    host without CUDA that request raises, and nothing falls back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the guard is for hosts without it")
    call = _entry_point_calls()[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_profile_solve_on_plain_path():
    """The profiling entry point runs the level-0 try on the CPU plain path
    and reports every phase; the device fields stay empty off the card."""
    from photometric_bundle_adjustment_tpu_torch import profile_solve

    res = profile_solve.main([
        "--device", "cpu", "--K", "12", "--L", "48", "--H", "64", "--W", "96",
        "--obs-per-lm", "3", "--long-tracks", "4", "--tries", "2",
        "--reps", "2"])
    # the valid observations and the one zero column: no padding
    assert res["K"] == 12 and res["columns"] == res["observations"] + 1
    for k in ("build_ms", "megakernel_ms", "solve_lam_ms", "wall_ms"):
        assert np.isfinite(res[k]) and res[k] > 0, k
    assert res["top_self_ms"] and res["top_by"] == "self_cpu_time_total"
    assert res["device_busy_ms"] is None and res["peak_device_mib"] is None


@pytest.mark.parametrize("family,bf16", [("chunk", True), ("dense", False),
                                         ("dense", True)])
def test_profile_solve_mega_families_on_plain_path(family, bf16):
    """``--family dense`` profiles the megakernel solver's dense slot-major
    family on ``euroc_scale_pba``, ``--bf16`` the kernel's bf16 tier."""
    from photometric_bundle_adjustment_tpu_torch import profile_solve

    res = profile_solve.main([
        "--device", "cpu", "--family", family, "--K", "12", "--L", "48",
        "--H", "64", "--W", "96", "--obs-per-lm", "3", "--long-tracks", "4",
        "--tries", "2", "--reps", "2"] + (["--bf16"] if bf16 else []))
    assert (res["family"], res["bf16"]) == (family, bf16)
    assert res["K"] == 12
    if family == "dense":
        # 48 landmarks x 4 slots, the empty ones zero columns
        assert (res["observations"], res["columns"]) == (48 * 3, 48 * 4)
    else:
        assert res["columns"] == res["observations"] + 1
    for k in ("build_ms", "megakernel_ms", "solve_lam_ms", "wall_ms"):
        assert np.isfinite(res[k]) and res[k] > 0, k
    assert np.isfinite(res["assembly_ms"])
    assert res["device_busy_ms"] is None and res["peak_device_mib"] is None


@pytest.mark.parametrize("solver", ["fused", "kernel_fused", "kernel_dense"])
def test_profile_solve_fused_solvers_on_plain_path(solver):
    """``--solver`` profiles each plan-based fused solver on the uniform
    EuRoC-scale problem, here at toy size on the CPU plain path."""
    from photometric_bundle_adjustment_tpu_torch import profile_solve

    res = profile_solve.main([
        "--device", "cpu", "--solver", solver, "--K", "12", "--L", "48",
        "--H", "64", "--W", "96", "--obs-per-lm", "3", "--tries", "2",
        "--reps", "2"])
    assert res["solver"] == solver and res["K"] == 12
    assert res["observations"] == 48 * 3 <= res["rows"]
    for k in ("build_ms", "warp_ms", "sample_ms", "rj_ms", "solve_lam_ms",
              "wall_ms"):
        assert np.isfinite(res[k]) and res[k] > 0, k
    assert np.isfinite(res["assembly_ms"])
    assert res["device_busy_ms"] is None and res["peak_device_mib"] is None
