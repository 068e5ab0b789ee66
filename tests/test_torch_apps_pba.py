"""``apps/pba``: the port's photometric refinement of a map it built,
against the JAX package's app, on the CPU.

The input is tests/test_torch_sfm.py's EuRoC-layout directory (the first
3 frames of the indoor room as JPEGs, and their calibration).  The
port's ``apps/sfm`` maps it once; then:

* with ``--map-in``: both apps refine that map;
* without it: the port's app runs ``SfmPipeline.run`` itself, and the
  JAX app refines the map the port's run handed to ``refine_map``.

Both refine 3 levels of 3 iterations each (the JAX package on its CPU
path, the gather sampler and the classic loop; the port on the
megakernel's plain version), and the outputs are compared at
tests/test_torch_slice.py::test_refine_photometric_matches_jax's
tolerances: initial costs per level rtol 2e-4, the final cost rtol 5e-3,
poses atol 1e-4, affine atol 1e-3, inverse depths rtol 1e-3.
``--distributed 2`` refines the map on two spawned ranks (Gloo) and
prints its agreement with the single-device solve: cost within 1e-3
relative, poses within 1e-3."""

import ast
import datetime
import pickle
import re

import numpy as np
import pytest
import torch
from test_torch_sfm import APP_FRAMES, _write_euroc_dir, sequence

from photometric_bundle_adjustment_tpu.apps import pba as japp
from photometric_bundle_adjustment_tpu_torch.apps import pba as app
from photometric_bundle_adjustment_tpu_torch.apps import sfm as sfm_app
from photometric_bundle_adjustment_tpu_torch.parallel import mesh

torch.set_num_threads(1)

ITERATIONS = "3"
LEVEL = re.compile(r"pba level (\d) \((\d+)x(\d+)\): cost (\S+) -> (\S+)")


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """(data dir, calibration JSON, corners cache dir, the port's
    geometric map pickle)."""
    root = tmp_path_factory.mktemp("pba")
    data, calib = _write_euroc_dir(root, sequence(), APP_FRAMES)
    cache = root / "cache"
    map_path = root / "map.pkl"
    assert sfm_app.main([
        "--dataset-path", str(data), "--cam-calib", str(calib),
        "--map-out", str(map_path), "--stats-out", "", "--device", "cpu",
        "--cache-dir", str(cache)]) == 0
    return data, calib, cache, map_path


def levels(out: str):
    """[(level, initial cost, final cost)] of the printed level lines."""
    return [(int(m[0]), float(m[3]), float(m[4]))
            for m in LEVEL.findall(out)]


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("map_in", [True, False])
def test_pba_app_matches_jax(tmp_path, mapped, map_in, monkeypatch, capsys):
    monkeypatch.setenv("PBA_TPU_COMPILE_CACHE", str(tmp_path / "xla"))
    data, calib, cache, map_path = mapped
    common = ["--dataset-path", str(data), "--cam-calib", str(calib),
              "--pba-iterations", ITERATIONS, "--device", "cpu"]
    port_out, jax_out = tmp_path / "port.pkl", tmp_path / "jax.pkl"
    if map_in:
        # the port reads the corners cache, the JAX app detects again
        args = ["--map-in", str(map_path), "--cache-dir", str(cache)]
        geo_path = map_path
    else:
        args = []
        geo_path = tmp_path / "geo.pkl"
        refine = app.refine_map

        def keep_map(pipe, **kw):
            with open(geo_path, "wb") as f:
                pickle.dump({"cameras": dict(pipe.cameras),
                             "tracks": dict(pipe.tracks),
                             "landmarks": {
                                 t: {"inv_depth": lm.inv_depth,
                                     "obs": dict(lm.obs),
                                     "outlier_obs": dict(lm.outlier_obs)}
                                 for t, lm in pipe.landmarks.items()}}, f)
            return refine(pipe, **kw)

        monkeypatch.setattr(app, "refine_map", keep_map)
    assert app.main(common + args + ["--map-out", str(port_out)]) == 0
    out_t = capsys.readouterr().out
    assert ("Geometric SfM done" in out_t) != map_in
    assert japp.main(common + ["--map-in", str(geo_path),
                               "--map-out", str(jax_out)]) == 0
    out_j = capsys.readouterr().out

    lv_t, lv_j = levels(out_t), levels(out_j)
    assert [lv[0] for lv in lv_t] == [lv[0] for lv in lv_j] == [2, 1, 0]
    np.testing.assert_allclose([lv[1] for lv in lv_t],
                               [lv[1] for lv in lv_j], rtol=2e-4)
    np.testing.assert_allclose(lv_t[-1][2], lv_j[-1][2], rtol=5e-3)
    for _, c0, c1 in lv_t:
        assert c1 < c0

    got, want, geo = load(port_out), load(jax_out), load(geo_path)
    assert list(got["timestamps"]) == list(want["timestamps"])
    keys = sorted(want["cameras"])
    assert sorted(got["cameras"]) == keys == sorted(geo["cameras"])
    np.testing.assert_allclose(
        np.stack([got["cameras"][k] for k in keys]),
        np.stack([want["cameras"][k] for k in keys]), atol=1e-4)
    for k in keys:
        np.testing.assert_allclose(got["affine"][k],
                                   np.asarray(want["affine"][k]), atol=1e-3)
    assert list(got["landmarks"]) == list(want["landmarks"]) == list(
        geo["landmarks"])
    tids = list(want["landmarks"])
    np.testing.assert_allclose(
        [got["landmarks"][t]["inv_depth"] for t in tids],
        [want["landmarks"][t]["inv_depth"] for t in tids], rtol=1e-3)
    for t in tids:
        assert got["landmarks"][t]["obs"] == geo["landmarks"][t]["obs"]


def test_pba_app_refuses_distributed(tmp_path, capsys):
    """``--distributed`` is no longer refused (the distributed solvers are
    ported): the flag parses and the app goes on to its input checks,
    here a missing calibration."""
    with pytest.raises(SystemExit) as e:
        app.main(["--dataset-path", str(tmp_path), "--distributed", "4",
                  "--device", "cpu", "--cam-calib",
                  str(tmp_path / "missing.json")])
    assert e.value.code == 2
    err = capsys.readouterr().err.strip().splitlines()[-1]
    assert err.endswith(f"error: could not load camera calibration "
                        f"{tmp_path / 'missing.json'}")


def test_pba_app_distributed(tmp_path, mapped, capsys, monkeypatch):
    monkeypatch.setattr(mesh, "DEFAULT_TIMEOUT",
                        datetime.timedelta(seconds=60))
    monkeypatch.setattr(mesh, "DEFAULT_WALL_LIMIT", 600.0)
    data, calib, cache, map_path = mapped
    out = tmp_path / "dist.pkl"
    assert app.main(["--dataset-path", str(data), "--cam-calib", str(calib),
                     "--pba-iterations", ITERATIONS, "--device", "cpu",
                     "--map-in", str(map_path), "--cache-dir", str(cache),
                     "--distributed", "2", "--map-out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "backend gloo" in text and "distributed pba (2 ranks" in text
    line = [s for s in text.splitlines()
            if s.startswith("Distributed-vs-single parity: ")]
    parity = ast.literal_eval(line[0].split(": ", 1)[1])
    assert parity["cost_rel"] <= 1e-3 and parity["pose_maxdiff"] <= 1e-3
    assert parity["cost_dist"] < parity["cost_single"] * (1 + 1e-3)
    got, geo = load(out), load(map_path)
    assert sorted(got["cameras"]) == sorted(geo["cameras"])
    assert sorted(got["affine"]) == sorted(geo["cameras"])
    moved = max(np.abs(got["cameras"][k] - geo["cameras"][k]).max()
                for k in geo["cameras"])
    assert 0 < moved < 0.1
