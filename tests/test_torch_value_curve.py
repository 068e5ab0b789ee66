"""The port's photometric value curve (``scripts/pba_value_curve.py``)
against the root JAX script and the JAX TPU run's committed record.

(a) ``perturb_cameras`` against the JAX script's function (loaded by
    path; conftest enables x64) on ``synth_pba_pipe``'s cameras, 1e-12.
(b) ``perturb_cameras`` of ``runs/map_r5_run12.pkl`` against the JAX TPU
    run's ``runs/vc_init_<mm>mm.pkl`` (which it rounded to f32), 2e-6.
(c) ``score_ate`` of the committed rung maps against
    ``runs/value_curve.json``'s ATE columns (printed to two decimals).
(d) ``stereo_baseline_stats`` of the same maps against its baseline pairs.
(e) ``run_ladder`` on the CPU against the JAX ``perturb_cameras`` and
    ``refine_photometric`` on copies of one map, at
    tests/test_torch_slice.py::test_refine_photometric_matches_jax's
    tolerances, and its rows' keys against the JAX script's row.
Then the EuRoC route of ``main`` on a small EuRoC-layout directory
written from the same map (its rows equal (e)'s), its refusal of a
missing dataset, and the guard that keeps the JAX run's records.
"""

import ast
import copy
import importlib.util
import json
import pickle
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.pipeline import pba_refine as jrefine
from photometric_bundle_adjustment_tpu_torch.io import calib_io
from photometric_bundle_adjustment_tpu_torch.models import synthetic
from photometric_bundle_adjustment_tpu_torch.scripts import pba_value_curve as vc
from photometric_bundle_adjustment_tpu_torch.utils import evaluation

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
JAX_SCRIPT = ROOT / "scripts" / "pba_value_curve.py"
RUNS = ROOT / "runs"
PIPE = dict(K=12, L=144, H=64, W=96, obs_per_lm=3, long_tracks=6, seed=0)
RUNGS = [0.0, 0.02]


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_pba_value_curve",
                                                  JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_row_keys() -> list:
    """The keys of the JAX script's ``row`` dict, in its order."""
    for node in ast.walk(ast.parse(JAX_SCRIPT.read_text())):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "row"):
            return [k.value for k in node.value.keys]
    raise AssertionError("no row dict in the JAX script")


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def pipe():
    return synthetic.synth_pba_pipe(**PIPE)


def _gt_score(poses_gt):
    frames = sorted(f for f, c in poses_gt if c == 0)
    gt = np.stack([poses_gt[(f, 0)][:3] for f in frames])

    def score(p):
        est = evaluation.trajectory_from_cameras(p.cameras)
        return (100 * evaluation.ate_rmse(est, gt, with_scale=False),
                100 * evaluation.ate_rmse(est, gt, with_scale=True))

    return score


@pytest.fixture(scope="module")
def ladder(pipe):
    """The port's ladder and the JAX package's refinements of the same
    rungs, on copies of one map."""
    work = copy.deepcopy(pipe)
    rows = vc.run_ladder(work, RUNGS, _gt_score(pipe.poses_gt), levels=2,
                         max_iterations=3, device="cpu")
    jscript = _jax_script()
    jax_runs = []
    for sigma in RUNGS:
        pj = copy.deepcopy(pipe)
        pj.cameras = jscript.perturb_cameras(dict(pipe.cameras), sigma)
        lines = []
        res = jrefine.refine_photometric(pj, levels=2, max_iterations=3,
                                         huber_delta=9.0, log=lines.append)
        init = [float(re.search(r"cost (\S+) ->", s).group(1))
                for s in lines if s.startswith("  pba level")]
        jax_runs.append((res, init))
    return work, rows, jax_runs


@pytest.mark.parametrize("sigma", [0.0, 0.02, 0.2])
def test_perturb_matches_jax_script(pipe, sigma):
    jscript = _jax_script()
    want = jscript.perturb_cameras(dict(pipe.cameras), sigma)
    got = vc.perturb_cameras(pipe.cameras, sigma)
    assert list(got) == list(want) == list(pipe.cameras)
    for f in want:
        np.testing.assert_allclose(got[f], np.asarray(want[f]), rtol=0,
                                   atol=1e-12)
    for f in vc.GAUGE:
        np.testing.assert_array_equal(got[f], pipe.cameras[f])
    if sigma:
        assert max(np.abs(got[f] - pipe.cameras[f]).max()
                   for f in got) > sigma / 10


@pytest.mark.parametrize("mm", [20, 50, 100, 200])
def test_perturb_reproduces_committed_tpu_rung(mm):
    m = _load(RUNS / "map_r5_run12.pkl")
    want = _load(RUNS / f"vc_init_{mm}mm.pkl")["cameras"]
    got = vc.perturb_cameras(m["cameras"], mm / 1000)
    assert list(got) == list(want)
    for f in want:
        np.testing.assert_allclose(got[f], np.asarray(want[f], np.float64),
                                   rtol=0, atol=2e-6)


def _committed_rows():
    with open(RUNS / "value_curve.json") as f:
        return {round(r["sigma_cm"] * 10): r for r in json.load(f)["rows"]}


@pytest.mark.parametrize("kind", ["init", "pba"])
@pytest.mark.parametrize("mm", [0, 20, 50])
def test_score_ate_reproduces_committed_rows(mm, kind):
    row = _committed_rows()[mm]
    se3_cm, sim3_cm = vc.score_ate(str(RUNS / f"vc_{kind}_{mm}mm.pkl"),
                                   str(ROOT / vc.REF_DUMP))
    assert abs(se3_cm - row[f"ate_{kind}_se3_cm"]) <= 0.005
    assert abs(sim3_cm - row[f"ate_{kind}_sim3_cm"]) <= 0.005
    m = _load(RUNS / f"vc_{kind}_{mm}mm.pkl")
    assert vc.score_ate({"cameras": m["cameras"]},
                        str(ROOT / vc.REF_DUMP)) == (se3_cm, sim3_cm)


@pytest.mark.parametrize("kind", ["init", "pba"])
@pytest.mark.parametrize("mm", [0, 20, 50])
def test_baseline_stats_reproduce_committed_rows(mm, kind):
    row = _committed_rows()[mm]
    got = vc.stereo_baseline_stats(
        _load(RUNS / f"vc_{kind}_{mm}mm.pkl")["cameras"])
    np.testing.assert_allclose(got, row[f"baseline_{kind}_m"], rtol=0,
                               atol=2e-6)


def test_baseline_stats_without_a_pair():
    assert vc.stereo_baseline_stats({(0, 0): np.r_[0.0, 0, 0, 0, 0, 0, 1]}) \
        is None


def test_ladder_matches_jax(pipe, ladder):
    work, rows, jax_runs = ladder
    keys = _jax_row_keys()
    for sigma, row, (jres, jinit) in zip(RUNGS, rows, jax_runs):
        assert list(row)[:len(keys)] == keys
        assert list(row)[len(keys):] == ["seconds", "levels"]
        assert row["sigma_cm"] == sigma * 100
        init = [lv["initial_cost"] for lv in row["levels"]]
        assert [lv["level"] for lv in row["levels"]] == [1, 0]
        np.testing.assert_allclose(init, jinit, rtol=2e-4)
        np.testing.assert_allclose(row["initial_cost"],
                                   float(jres.initial_cost), rtol=2e-4)
        np.testing.assert_allclose(row["cost"], float(jres.cost), rtol=5e-3)
        for lv in row["levels"]:
            assert lv["cost"] < lv["initial_cost"]
        assert row["iterations"] > 0 and row["seconds"] > 0
        for k in ("baseline_init_m", "baseline_pba_m"):
            assert len(row[k]) == 2 and all(np.isfinite(row[k]))
    # the 2 cm rung starts from another map than the unperturbed one
    assert rows[1]["ate_init_se3_cm"] != rows[0]["ate_init_se3_cm"]
    # the ladder leaves the unperturbed map in place
    for f in pipe.cameras:
        np.testing.assert_array_equal(work.cameras[f], pipe.cameras[f])
    assert [lm.inv_depth for lm in work.landmarks.values()] == [
        lm.inv_depth for lm in pipe.landmarks.values()]


def _write_euroc(pipe, d: Path):
    """An EuRoC-layout directory of ``pipe``'s images (PNG bytes under the
    .jpg names: lossless), its calibration, map, corners cache and a
    reference trajectory dump of its rendered poses."""
    from PIL import Image

    data = d / "dataset"
    data.mkdir()
    frames = sorted({f for f, _ in pipe.images})
    (data / "timestamps.txt").write_text(
        "".join(f"{1000 + f}\n" for f in frames))
    for (f, c), img in pipe.images.items():
        Image.fromarray(img).save(data / f"{1000 + f}_{c}.jpg", format="PNG")
    calib_io.save_calibration(str(d / "calib.json"), calib_io.Calibration(
        pipe.calib.T_i_c, pipe.calib.intrinsics, list(pipe.calib.cam_types)))
    with open(d / "map.pkl", "wb") as f:
        pickle.dump({"cameras": pipe.cameras, "landmarks": {
            t: {"inv_depth": lm.inv_depth, "obs": dict(lm.obs),
                "outlier_obs": {}} for t, lm in pipe.landmarks.items()}}, f)
    (d / "cache").mkdir()
    with open(d / "cache" / "corners.pkl", "wb") as f:
        pickle.dump({"n_images": len(pipe.images), "data": pipe.corners}, f)
    (d / "ref.txt").write_text("".join(
        f"CAMERA {f} {c} " + " ".join(repr(float(x)) for x in T) + "\n"
        for (f, c), T in pipe.poses_gt.items()))
    return data


def test_euroc_route_on_a_written_dataset(pipe, ladder, tmp_path):
    """``main``'s EuRoC route loads what the JAX script's main loads and
    gives the rows ``run_ladder`` gives on the same map in memory."""
    data = _write_euroc(pipe, tmp_path)
    out = tmp_path / "vc.json"
    got = vc.main([
        "--dataset-path", str(data), "--map", str(tmp_path / "map.pkl"),
        "--cam-calib", str(tmp_path / "calib.json"),
        "--cache-dir", str(tmp_path / "cache"),
        "--ref-dump", str(tmp_path / "ref.txt"), "--rungs", "0,0.02",
        "--out", str(out), "--device", "cpu"])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(got))
    assert got["backend"] == "torch" and got["device"] == "cpu"
    assert got["card"] is None
    np.testing.assert_allclose(
        got["calibrated_baseline_m"],
        np.linalg.norm(pipe.calib.T_i_c[1, :3] - pipe.calib.T_i_c[0, :3]))
    want = vc.run_ladder(
        copy.deepcopy(pipe), RUNGS,
        lambda p: vc.score_ate({"cameras": p.cameras},
                               str(tmp_path / "ref.txt")), device="cpu")
    for row, ref in zip(got["rows"], want):
        for k in ("cost", "initial_cost", "iterations", "baseline_init_m",
                  "baseline_pba_m"):
            assert row[k] == pytest.approx(ref[k], rel=1e-12), k
        for k in ("ate_init_se3_cm", "ate_init_sim3_cm", "ate_pba_se3_cm",
                  "ate_pba_sim3_cm"):
            assert row[k] == pytest.approx(ref[k], rel=1e-9), k


def test_euroc_route_names_the_missing_dataset(tmp_path):
    missing = tmp_path / "euroc_V1"
    with pytest.raises(FileNotFoundError, match=re.escape(str(missing))):
        vc.main(["--dataset-path", str(missing), "--device", "cpu",
                 "--out", str(tmp_path / "vc.json")])
    assert not (tmp_path / "vc.json").exists()


def test_committed_tpu_records_are_refused():
    for name in ("value_curve.json", "value_curve_edge.json"):
        path = RUNS / name
        before = path.read_bytes()
        with pytest.raises(ValueError, match="another run's record"):
            vc.main(["--room", "--frames", "1", "--device", "cpu",
                     "--out", str(path)])
        assert path.read_bytes() == before
