"""Calibration: the port's ``io/calib_io``, ``models/calibration`` and
``apps/calibrate`` against the JAX package's, on the CPU in f64.

The inputs are synthesised (``synthetic.synth_aprilgrid``: the rig of
``refbaseline/artifacts/ref_opt_calib.json`` (ds) or
tests/data/opt_calib_kb4.json (kb4) in front of the 6x6 AprilGrid,
0.1 px of noise, numpy seed 0), since the reference's euroc_calib is not
in the repository.  Files in the reference's cereal layout are written
by one package and read by the other; ``calibrate`` runs in both
packages on 8 frames from the same perturbed start (final parameters
within 1e-8, costs within rtol 1e-8); both apps run on a directory the
test writes, and their ``opt_calib.json`` files agree within 1e-8."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.apps import calibrate as japp
from photometric_bundle_adjustment_tpu.core import cameras as jcameras
from photometric_bundle_adjustment_tpu.io import calib_io as jcalib_io
from photometric_bundle_adjustment_tpu.models import calibration as jcalib
from photometric_bundle_adjustment_tpu_torch.apps import calibrate as app
from photometric_bundle_adjustment_tpu_torch.core import cameras
from photometric_bundle_adjustment_tpu_torch.io import calib_io
from photometric_bundle_adjustment_tpu_torch.models import (
    calibration,
    synthetic,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALIB = {"ds": os.path.join(ROOT, "refbaseline", "artifacts",
                            "ref_opt_calib.json"),
         "kb4": os.path.join(ROOT, "tests", "data", "opt_calib_kb4.json")}
FRAMES, NOISE_PX = 8, 0.1
ATOL, RTOL = 1e-8, 1e-8


def grid(model, n_frames=FRAMES):
    c = calib_io.load_calibration(CALIB[model])
    return synthetic.synth_aprilgrid(c.intrinsics, c.T_i_c, model,
                                     n_frames=n_frames, noise_px=NOISE_PX)


def perturbed_ds(g, seed=1):
    """Double-sphere-form initial intrinsics: the truth moved by a few
    pixels and 5% (the kb4 distortion then starts at 0 in
    ``initialize``)."""
    rng = np.random.default_rng(seed)
    intr = np.array(g.intrinsics)
    intr[:, :4] += rng.normal(0, [5, 5, 3, 3], (len(intr), 4))
    intr[:, 4:6] = [-0.24, 0.57] if g.model != "ds" else intr[:, 4:6] * 1.05
    intr[:, 6:] = 0.0
    return intr


def pose_json(p):
    return dict(zip(("px", "py", "pz", "qx", "qy", "qz", "qw"),
                    map(float, p)))


def write_calib_dir(root, g, ds_intr, image_size=True):
    """A euroc_calib-layout directory in the reference's cereal JSON:
    init_poses.json, detected_corners.json,
    calibration-double-sphere.json, and one blank image per camera for
    the image size."""
    key = lambda f, c: {"first": int(f), "second": int(c)}   # noqa: E731
    corners = [{"key": key(f, c), "value": {
        "value0": [{"value0": float(u), "value1": float(v)}
                   for u, v in d["corners"]],
        "value1": [int(i) for i in d["corner_ids"]]}}
        for (f, c), d in sorted(g.corners.items())]
    poses = [{"key": key(f, c), "value": {"value0": pose_json(T)}}
             for (f, c), T in sorted(g.init_poses.items())]
    ds = {"cam.T_i_c": [pose_json(T) for T in g.T_i_c],
          "cam.intrinsics": [
              dict(zip(("fx", "fy", "cx", "cy", "xi", "alpha"),
                       map(float, k[:6]))) for k in ds_intr],
          "cam.accel_bias": [0.0, 0.0, 0.0]}
    for name, root_obj in (("detected_corners.json", corners),
                           ("init_poses.json", poses),
                           ("calibration-double-sphere.json", ds)):
        (root / name).write_text(json.dumps({"value0": root_obj}))
    if image_size:
        Image = pytest.importorskip("PIL.Image")
        f0 = min(f for f, _ in g.corners)
        for c in range(len(g.intrinsics)):
            Image.fromarray(np.zeros((g.H, g.W), np.uint8)).save(
                root / f"{f0}_{c}.jpg")
    return root


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_opt_calib_round_trip_between_packages(tmp_path, writer):
    """``save_calibration`` of one package, ``load_calibration`` of the
    other; both write the same file, byte for byte."""
    c = calib_io.load_calibration(CALIB["kb4"])
    args = (c.T_i_c, c.intrinsics, ["kb4", "kb4"], [752, 752], [480, 480])
    port_path, jax_path = tmp_path / "port.json", tmp_path / "jax.json"
    calib_io.save_calibration(str(port_path), calib_io.Calibration(*args))
    jcalib_io.save_calibration(str(jax_path), jcalib_io.Calibration(*args))
    assert port_path.read_text() == jax_path.read_text()
    path = str(port_path if writer == "port" else jax_path)
    back = (jcalib_io if writer == "port" else calib_io).load_calibration(path)
    np.testing.assert_array_equal(back.T_i_c, c.T_i_c)
    np.testing.assert_array_equal(back.intrinsics, c.intrinsics)
    assert (back.cam_types, back.widths, back.heights) == (
        ["kb4", "kb4"], [752, 752], [480, 480])
    assert calib_io.pose_to_json(c.T_i_c[1]) == jcalib_io.pose_to_json(
        c.T_i_c[1])


def test_dataset_files_read_alike(tmp_path):
    """The three euroc_calib inputs read the same in both packages."""
    g = grid("ds")
    write_calib_dir(tmp_path, g, g.intrinsics, image_size=False)
    for name in ("load_detected_corners", "load_init_poses"):
        got = getattr(calib_io, name)(str(tmp_path / (
            "detected_corners.json" if "corners" in name
            else "init_poses.json")))
        want = getattr(jcalib_io, name)(str(tmp_path / (
            "detected_corners.json" if "corners" in name
            else "init_poses.json")))
        assert list(got) == list(want) and len(got) == 2 * FRAMES
        for k in want:
            if isinstance(want[k], dict):
                np.testing.assert_array_equal(got[k]["corners"],
                                              want[k]["corners"])
                np.testing.assert_array_equal(got[k]["corner_ids"],
                                              want[k]["corner_ids"])
                assert got[k]["corner_ids"].dtype == np.int32
            else:
                np.testing.assert_array_equal(got[k], want[k])
    path = str(tmp_path / "calibration-double-sphere.json")
    got, want = (calib_io.load_ds_calibration(path),
                 jcalib_io.load_ds_calibration(path))
    np.testing.assert_array_equal(got.intrinsics, want.intrinsics)
    np.testing.assert_array_equal(got.T_i_c, want.T_i_c)
    assert got.cam_types == want.cam_types == ["ds", "ds"]


def test_synth_aprilgrid():
    """Seeded; corners inside the image with N(0, 0.1 px) noise about the
    true projections; at the defaults euroc_calib's size."""
    g = grid("ds")
    g2 = grid("ds")
    assert g.corners.keys() == g2.corners.keys()
    for k in g.corners:
        np.testing.assert_array_equal(g.corners[k]["corners"],
                                      g2.corners[k]["corners"])
    grid3d = calibration.aprilgrid_corners_3d()
    np.testing.assert_array_equal(grid3d, jcalib.aprilgrid_corners_3d())
    res = []
    from photometric_bundle_adjustment_tpu_torch.core import se3
    for (f, c), d in g.corners.items():
        uv = d["corners"]
        assert np.all((uv > -1) & (uv < [g.W + 1, g.H + 1]))
        T = se3.compose(torch.as_tensor(g.T_w_i[f]),
                        torch.as_tensor(g.T_i_c[c]))
        p_c = se3.act(se3.inverse(T), torch.as_tensor(grid3d[d["corner_ids"]]))
        res.append(uv - cameras.project(
            "ds", torch.as_tensor(g.intrinsics[c]), p_c).numpy())
    res = np.concatenate(res)
    assert abs(res.std() - NOISE_PX) < 0.01 and abs(res.mean()) < 0.01
    full = synthetic.synth_aprilgrid(g.intrinsics, g.T_i_c, "ds")
    n_res = 2 * sum(len(d["corner_ids"]) for d in full.corners.values())
    assert len({f for f, _ in full.corners}) == 52
    assert 22_000 < n_res < 28_000, n_res


def start(g, ds_intr):
    """Both packages' data and initial parameters (the app's start: body
    poses from cam-0 init poses, intrinsics through ``initialize``)."""
    frames = sorted({f for f, _ in g.corners})
    T_w_i0 = np.stack([g.init_poses[(f, 0)] for f in frames])
    intr0 = np.stack([np.asarray(jcameras.initialize(
        g.model, jnp.asarray(k))) for k in ds_intr])
    grid3d = calibration.aprilgrid_corners_3d()
    data_t = calibration.build_data(g.corners, frames, grid3d, device="cpu")
    data_j = jcalib.build_data(g.corners, frames, grid3d)
    init_t = calibration.CalibParams(*(torch.as_tensor(x) for x in (
        T_w_i0, g.T_i_c, intr0)))
    init_j = jcalib.CalibParams(*(jnp.asarray(x) for x in (
        T_w_i0, g.T_i_c, intr0)))
    return data_t, data_j, init_t, init_j


@pytest.mark.parametrize("model", ["ds", "kb4"])
def test_calibrate_matches_jax(model):
    g = grid(model)
    data_t, data_j, init_t, init_j = start(g, perturbed_ds(g))
    for a, b in zip(data_t, data_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    p_t, r_t = calibration.calibrate(model, data_t, init_t)
    p_j, r_j = jcalib.calibrate(model, data_j, init_j)
    for a, b in zip(p_t, p_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL)
    np.testing.assert_allclose(float(r_t.cost), float(r_j.cost), rtol=RTOL)
    np.testing.assert_allclose(float(r_t.initial_cost),
                               float(r_j.initial_cost), rtol=RTOL)
    # camera 0's extrinsics held; the fit reaches the noise
    np.testing.assert_array_equal(p_t.T_i_c[0].numpy(), g.T_i_c[0])
    n_res = data_t.uv.shape[0] * 2
    rmse = np.sqrt(2 * float(r_t.cost) / n_res)
    assert abs(rmse - NOISE_PX) < 0.1 * NOISE_PX, rmse


@pytest.mark.parametrize("model", ["ds", "kb4"])
def test_calibrate_app_matches_jax(tmp_path, model, monkeypatch, capsys):
    """Both apps on one written directory (``--device cpu``); the two
    opt_calib.json files agree within 1e-8 and carry the image size."""
    monkeypatch.setenv("PBA_TPU_COMPILE_CACHE", str(tmp_path / "xla"))
    g = grid(model)
    root = write_calib_dir(tmp_path, g, perturbed_ds(g))
    outs = {}
    for name, main in (("port", app.main), ("jax", japp.main)):
        out = tmp_path / f"{name}.json"
        assert main(["--dataset-path", str(root), "--cam-model", model,
                     "--output", str(out), "--device", "cpu"]) == 0
        outs[name] = calib_io.load_calibration(str(out))
    log = capsys.readouterr().out
    assert log.count("Converged in") == 2
    got, want = outs["port"], outs["jax"]
    np.testing.assert_allclose(got.intrinsics, want.intrinsics, rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got.T_i_c, want.T_i_c, rtol=0, atol=ATOL)
    assert got.cam_types == want.cam_types == [model, model]
    assert got.widths == want.widths == [g.W, g.W]
    assert got.heights == want.heights == [g.H, g.H]
    # against the truth, in pixels of projection; 8 frames leave the image
    # corners bare, where kb4's distortion is extrapolated (measured 0.85 px)
    assert calibration.projection_gap(model, got.intrinsics, g.intrinsics,
                                      g.W, g.H) < 1.5


def test_calibrate_app_rejects_unknown_model(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        app.main(["--dataset-path", str(tmp_path), "--cam-model", "fisheye",
                  "--device", "cpu"])
    assert e.value.code == 2
    assert "not implemented" in capsys.readouterr().err
