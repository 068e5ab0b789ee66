"""Slice G, the tools, against the JAX package on the CPU:
``describe.detect_and_describe`` on one seeded image (corners and masks
equal, angles within 1e-5 rad, descriptor bits within
tests/test_torch_features.py's flip share), ``apps/build_voc`` on a
temporary EuRoC-layout folder of seeded JPEGs (the same vocabulary file
contents: centroids, tree and words), each ``utils/visualize`` function's
PNG pixel for pixel against the JAX function's on the same inputs (the
real V1 map of ``runs/`` for the reprojections and the scene), and
``utils/roofline`` on known numbers."""

import pickle
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from photometric_bundle_adjustment_tpu.apps import build_voc as jvoc
from photometric_bundle_adjustment_tpu.features import describe as jdescribe
from photometric_bundle_adjustment_tpu.io import calib_io as jcalib
from photometric_bundle_adjustment_tpu.pipeline import sfm_pipeline as jsfm
from photometric_bundle_adjustment_tpu.utils import visualize as jvis
from photometric_bundle_adjustment_tpu_torch import interop
from photometric_bundle_adjustment_tpu_torch.apps import build_voc
from photometric_bundle_adjustment_tpu_torch.features import describe
from photometric_bundle_adjustment_tpu_torch.io import calib_io
from photometric_bundle_adjustment_tpu_torch.models import synthetic
from photometric_bundle_adjustment_tpu_torch.pipeline import sfm_pipeline as tsfm
from photometric_bundle_adjustment_tpu_torch.utils import roofline, visualize

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ANGLE_ATOL, BIT_FLIP_SHARE = 1e-5, 5e-4


@pytest.fixture(scope="module")
def frames():
    """Two stereo frames (4 images) of the front-end sequence, 120x160."""
    seq = synthetic.synth_stereo_sequence(n_frames=2, H=120, W=160, cell=2.0,
                                          device="cpu")
    return {k: seq.images[k] for k in sorted(seq.images)}


def test_detect_and_describe_matches_jax(frames):
    img = frames[(0, 0)]
    got = interop.features_to_numpy(dict(zip(
        ("uv", "valid", "angles", "desc"),
        describe.detect_and_describe(torch.as_tensor(img), num_features=300))))
    ref = [np.asarray(x) for x in jdescribe.detect_and_describe(
        jnp.asarray(img), num_features=300)]
    np.testing.assert_array_equal(got["uv"], ref[0])
    np.testing.assert_array_equal(got["valid"], ref[1])
    v = ref[1]
    assert v.sum() > 30
    np.testing.assert_allclose(got["angles"][v], ref[2][v], atol=ANGLE_ATOL)
    flips = np.unpackbits((got["desc"][v] ^ ref[3][v]).view(np.uint8)).sum()
    assert flips <= BIT_FLIP_SHARE * v.sum() * 256


def test_build_voc_matches_jax(tmp_path, frames, capsys):
    data = tmp_path / "data"
    data.mkdir()
    stamps = [1000, 2000]
    (data / "timestamps.txt").write_text("".join(f"{t}\n" for t in stamps))
    for (f, c), img in frames.items():
        Image.fromarray(img).save(data / f"{stamps[f]}_{c}.jpg", quality=95)
    args = ["--dataset-path", str(data), "--max-frames", "2",
            "--num-features", "300", "--branching", "4", "--levels", "2",
            "--device", "cpu"]
    assert build_voc.main(args + ["--output", str(tmp_path / "t.pkl")]) == 0
    out_t = capsys.readouterr().out
    assert jvoc.main(args + ["--output", str(tmp_path / "j.pkl")]) == 0
    out_j = capsys.readouterr().out
    assert out_t.replace("t.pkl", "j.pkl") == out_j
    with open(tmp_path / "t.pkl", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "j.pkl", "rb") as f:
        want = pickle.load(f)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["centroids"], want["centroids"])
    assert got["children"] == want["children"]
    assert list(got["leaf_word"]) == list(want["leaf_word"])


def _pixels(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"))


def _same_png(a, b):
    pa, pb = _pixels(a), _pixels(b)
    assert pa.shape == pb.shape and pa.shape[0] > 100
    np.testing.assert_array_equal(pa, pb)


@pytest.fixture(scope="module")
def map_pipes():
    """The real V1 map in both packages' pipelines, on blank images."""
    with open(ROOT / "runs" / "map_r5_run20.pkl", "rb") as f:
        m = pickle.load(f)
    with open(ROOT / "runs" / "cache_r5" / "corners.pkl", "rb") as f:
        corners = pickle.load(f)["data"]
    calib = str(ROOT / "refbaseline" / "artifacts" / "ref_opt_calib.json")
    images = {f: np.zeros((480, 752), np.uint8) for f in corners}
    tpipe = tsfm.SfmPipeline.from_map(m, corners, calib_io.load_calibration(
        calib), log=lambda *a: None, device="cpu")
    tpipe.images = images
    jpipe = jsfm.SfmPipeline(images, jcalib.load_calibration(calib),
                             log=lambda *a: None)
    jpipe.corners = corners
    jpipe.cameras = dict(m["cameras"])
    jpipe.tracks = dict(m["tracks"])
    jpipe.landmarks = {
        t: jsfm.Landmark(d["inv_depth"], dict(d["obs"]),
                         dict(d.get("outlier_obs", {})))
        for t, d in m["landmarks"].items()}
    return tpipe, jpipe


def test_visualize_images_match_jax(tmp_path, frames):
    img1, img2 = frames[(0, 0)], frames[(1, 0)]
    rng = np.random.default_rng(0)
    uv1 = rng.uniform(0, 120, (40, 2))
    uv2 = rng.uniform(0, 120, (40, 2))
    pairs = rng.integers(0, 40, (30, 2))
    for mod, tag in ((visualize, "t"), (jvis, "j")):
        mod.draw_keypoints(img1, uv1, str(tmp_path / f"k{tag}.png"))
        mod.draw_matches(img1, img2, uv1, uv2, pairs,
                         str(tmp_path / f"m{tag}.png"))
    _same_png(tmp_path / "kt.png", tmp_path / "kj.png")
    _same_png(tmp_path / "mt.png", tmp_path / "mj.png")


def test_visualize_map_matches_jax(tmp_path, map_pipes):
    tpipe, jpipe = map_pipes
    fcid = sorted(tpipe.cameras)[80]
    visualize.draw_reprojections(tpipe, fcid, str(tmp_path / "rt.png"))
    jvis.draw_reprojections(jpipe, fcid, str(tmp_path / "rj.png"))
    _same_png(tmp_path / "rt.png", tmp_path / "rj.png")
    visualize.draw_scene(tpipe, str(tmp_path / "st.png"))
    jvis.draw_scene(jpipe, str(tmp_path / "sj.png"))
    _same_png(tmp_path / "st.png", tmp_path / "sj.png")


@pytest.mark.parametrize("model", ["ds", "kb4"])
def test_visualize_epipolar_curves_match_jax(tmp_path, frames, model):
    path = {"ds": ROOT / "refbaseline" / "artifacts" / "ref_opt_calib.json",
            "kb4": ROOT / "tests" / "data" / "opt_calib_kb4.json"}[model]
    c = calib_io.load_calibration(str(path))
    T = np.array([0.11, -0.01, 0.002, 0.01, -0.02, 0.005, 0.9997])
    T[3:] /= np.linalg.norm(T[3:])
    img = np.zeros((480, 752), np.uint8)
    uv = np.array([[100.0, 200.0], [400.0, 300.0]])
    for mod, tag in ((visualize, "t"), (jvis, "j")):
        mod.draw_epipolar_curves(img, T, model, np.asarray(c.intrinsics[0]),
                                 str(tmp_path / f"e{tag}.png"), uv=uv)
    _same_png(tmp_path / "et.png", tmp_path / "ej.png")


def test_roofline_on_known_numbers():
    t, by = roofline.bound_ms(flops=67e9, bytes_=6.7e9)
    assert by == "bytes" and t == pytest.approx(2.0)
    t, by = roofline.bound_ms(flops=134e9, bytes_=3.35e9)
    assert by == "operations" and t == pytest.approx(2.0)
    t, by = roofline.bound_ms(flops=1.979e12, bytes_=0.0,
                              ops_per_s=roofline.H100_INT8_OPS_PER_S)
    assert by == "operations" and t == pytest.approx(1.0)
    r = roofline.roofline(1e-3, 33.5e9, 0.8375e9)
    assert r["bound"] == "operations"
    assert r["tflops"] == pytest.approx(33.5)
    assert r["gbps"] == pytest.approx(837.5)
    assert r["pct_ops_peak"] == pytest.approx(50.0)
    assert r["pct_bytes_peak"] == pytest.approx(25.0)
    assert roofline.roofline(1.0, 1e9, 1e9)["bound"] == "latency/overhead"
    assert roofline.roofline(1e-3, 0.0, 1.675e9)["bound"] == "bytes"
