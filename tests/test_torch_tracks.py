"""The port's track builders against the JAX package's, and the indoor
scene the map stages run on.

``native_tracks.build_tracks`` (the port's own copy of the C++ union-find,
built with g++ into ``build/native/``) must give the JAX package's native
builder's dict bit for bit: the same track ids (union-find roots), the
same tracks and the same insertion order, since every later stage of the
pipeline orders by them.  Against the plain ``tracks.build_tracks`` (a
copy of the JAX package's pure-Python builder, whose ids are other roots)
the set of tracks is equal.  Random match graphs, the conflicting track of
tests/test_pipeline.py and the empty graph.

``synthetic.synth_stereo_sequence``: the default call renders the images
it rendered before ``room_radius`` existed (a checksum at small size); the
indoor room (``INDOOR_ROOM_RADIUS``) puts the median stereo parallax at
detected corners above SfmConfig's 1 degree triangulation gate, where the
default room's sits below it; and over the whole 82-frame trajectory no
camera sees a wall closer than the outlier thresholds."""

import hashlib

import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.pipeline import (
    native_tracks as jnative_tracks,
)
from photometric_bundle_adjustment_tpu.pipeline import tracks as jtracks
from photometric_bundle_adjustment_tpu_torch.core import cameras, se3
from photometric_bundle_adjustment_tpu_torch.features import describe
from photometric_bundle_adjustment_tpu_torch.models import synthetic
from photometric_bundle_adjustment_tpu_torch.pipeline import (
    native_tracks,
    tracks,
)
from photometric_bundle_adjustment_tpu_torch.pipeline.config import SfmConfig

torch.set_num_threads(1)

# sha256 of the default scene's images (3 frames of 60x94, sorted by
# fcid), rendered by this module's code before ``room_radius`` existed
DEFAULT_SCENE_SHA256 = (
    "c0a4d71a1b5554a4c5887e01270b49252d3adfc96df6aa4cb422b829debe848d")


def random_matches(seed, n_imgs=30, n_pairs=200, n_feat=400):
    """A random match graph (the generator of tests/test_aux.py), with
    a few empty pairs."""
    rng = np.random.default_rng(seed)
    imgs = [(f, c) for f in range(n_imgs // 2) for c in range(2)]
    matches = {}
    for _ in range(n_pairs):
        i, j = rng.integers(0, len(imgs), 2)
        if i == j:
            continue
        n = int(rng.integers(0, 60))
        matches[(imgs[i], imgs[j])] = np.stack(
            [rng.choice(n_feat, n, replace=False),
             rng.choice(n_feat, n, replace=False)], -1)
    return matches


def ordered(tr: dict):
    return [(t, list(v.items())) for t, v in tr.items()]


@pytest.mark.parametrize("seed,min_len", [(0, 3), (1, 3), (2, 2), (3, 4)])
def test_native_tracks_match_jax(seed, min_len):
    m = random_matches(seed)
    got = native_tracks.build_tracks(m, min_len)
    assert ordered(got) == ordered(jnative_tracks.build_tracks(m, min_len))
    plain = tracks.build_tracks(m, min_len)
    assert ordered(plain) == ordered(jtracks.build_tracks(m, min_len))
    assert {frozenset(t.items()) for t in got.values()} == \
        {frozenset(t.items()) for t in plain.values()}
    assert len(got) == len(plain) > 0


def test_native_tracks_conflicts_and_lengths():
    """The cases of tests/test_pipeline.py: a 4-track and a 3-track; a
    loop back into image (0, 0) with a new feature is dropped."""
    m = {((0, 0), (0, 1)): [(1, 2), (3, 4)],
         ((0, 1), (1, 0)): [(2, 7), (4, 9)],
         ((1, 0), (1, 1)): [(7, 5)]}
    got = native_tracks.build_tracks(m, 3)
    assert sorted(len(t) for t in got.values()) == [3, 4]
    assert ordered(got) == ordered(jnative_tracks.build_tracks(m, 3))
    m2 = {((0, 0), (0, 1)): [(1, 2)],
          ((0, 1), (1, 0)): [(2, 7)],
          ((1, 0), (0, 0)): [(7, 8)]}
    for build in (native_tracks.build_tracks, tracks.build_tracks):
        assert build(m2, 2) == {}
    assert native_tracks.build_tracks({}, 3) == {}
    assert native_tracks.build_tracks({((0, 0), (0, 1)): np.zeros((0, 2))},
                                      2) == {}


def test_native_library_is_built_into_the_checkout():
    lib = native_tracks._get_lib()
    assert lib is native_tracks._get_lib()
    built = list(native_tracks.BUILD_DIR.glob("libtrackbuilder-*.so"))
    assert built and native_tracks.BUILD_DIR.parts[-2:] == ("build", "native")


def test_default_scene_unchanged():
    seq = synthetic.synth_stereo_sequence(n_frames=3, H=60, W=94,
                                          device="cpu")
    h = hashlib.sha256()
    for k in sorted(seq.images):
        h.update(np.ascontiguousarray(seq.images[k]).tobytes())
    assert h.hexdigest() == DEFAULT_SCENE_SHA256
    assert seq.radius == synthetic._ROOM_RADIUS


def _parallax_deg(seq) -> np.ndarray:
    """The angle (degrees) the stereo baseline subtends at the room point
    of each corner detected in frame 0's left image."""
    img = torch.as_tensor(seq.images[(0, 0)][None])
    uv, valid, _, _ = describe.detect_and_describe_all(
        img, batch=1, num_features=SfmConfig().num_features_per_image)
    uv = uv[0][valid[0]].double()
    p_w = seq.world_points(np.zeros(len(uv), np.int64), uv)
    o0 = torch.as_tensor(seq.poses_gt[(0, 0)][:3])
    o1 = torch.as_tensor(seq.poses_gt[(0, 1)][:3])
    a, b = p_w - o0, p_w - o1
    cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))
    return np.degrees(np.arccos(np.clip(cos.numpy(), -1, 1)))


def test_indoor_scene_parallax_clears_the_gate():
    gate = SfmConfig().min_triangulation_angle_deg
    indoor = synthetic.synth_stereo_sequence(
        n_frames=1, room_radius=synthetic.INDOOR_ROOM_RADIUS, device="cpu")
    par = _parallax_deg(indoor)
    assert len(par) > 200
    assert np.median(par) > gate, np.median(par)
    default = synthetic.synth_stereo_sequence(n_frames=1, device="cpu")
    assert np.median(_parallax_deg(default)) < gate


def test_indoor_trajectory_keeps_clear_of_the_walls():
    """Every camera of the 82-frame trajectory, on a grid of its pixels:
    the room points it sees lie farther than the camera-distance and z
    outlier thresholds."""
    cfg = SfmConfig()
    intr, poses, _, center = synthetic._stereo_rig(82, 752, "ds")
    ys, xs = torch.meshgrid(torch.arange(0, 480, 8.0, dtype=torch.float64),
                            torch.arange(0, 752, 8.0, dtype=torch.float64),
                            indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)
    dmin = zmin = np.inf
    for i in range(poses.shape[0]):
        d = cameras.unproject_unit("ds", torch.as_tensor(intr[i % 2]), pix)
        d = d[torch.isfinite(d).all(-1)]
        o = se3.translation(poses[i])
        dw = se3.quat_rotate(se3.rotation(poses[i]), d)
        depth = synthetic._room_depth(o, dw, center,
                                      synthetic.INDOOR_ROOM_RADIUS)
        p_c = se3.act(se3.inverse(poses[i]), o + depth[:, None] * dw)
        dmin = min(dmin, float(p_c.norm(dim=-1).min()))
        zmin = min(zmin, float(p_c[:, 2].min()))
    assert dmin > 10 * cfg.camera_center_distance_outlier_threshold_meter
    assert zmin > 10 * cfg.z_coordinate_outlier_threshold_meter
