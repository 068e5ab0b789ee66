"""The port's cereal files (``io/cereal_io.py``) against the JAX
package's: on tests/test_cereal_io.py's ``_rand_map`` draws (numpy seeds
0, 1 and 2) both packages write byte-equal map, corners and matches
files, each loads the other's, and the bitset helpers agree and
round-trip."""

import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.io import cereal_io as jcio
from photometric_bundle_adjustment_tpu_torch.io import cereal_io as cio

torch.set_num_threads(1)

SEEDS = [0, 1, 2]


def _rand_map(rng):
    """tests/test_cereal_io.py's draws: corners of three images, one
    matched pair, tracks, outlier tracks, cameras and landmarks."""
    corners = {}
    for fcid in [(0, 0), (0, 1), (3, 0)]:
        n = int(rng.integers(1, 6))
        corners[fcid] = {
            "uv": rng.uniform(0, 700, (n, 2)),
            "angles": rng.uniform(-3, 3, n),
            "descriptors": rng.integers(0, 2**32, (n, 8), dtype=np.uint32),
        }
    matches = {
        ((0, 0), (0, 1)): {
            "T_i_j": np.array([0.1, -0.2, 0.3, 0.0, 0.0, 0.0, 1.0]),
            "inliers": rng.integers(0, 5, (3, 2)).astype(np.int32),
            "matches": rng.integers(0, 5, (4, 2)).astype(np.int32),
        },
    }
    tracks = {7: {(0, 0): 1, (0, 1): 2}, 9: {(3, 0): 0}}
    outliers = {11: {(0, 0): 3}}
    cameras = {fcid: np.array([0.0, 0.1, 0.2, 0.0, 0.0, 0.0, 1.0])
               for fcid in corners}
    landmarks = {
        7: {"inv_depth": 0.25, "obs": {(0, 0): 1, (0, 1): 2},
            "outlier_obs": {}},
        9: {"inv_depth": 1.5, "obs": {(3, 0): 0}, "outlier_obs": {(0, 0): 4}},
    }
    return corners, matches, tracks, outliers, cameras, landmarks


def _assert_same(a, b):
    """Equal nested dicts/lists of numbers and arrays, keys in one order."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _write_both(tmp_path, name, save_j, save_t, *args):
    pj, pt = str(tmp_path / f"{name}_jax.cereal"), str(tmp_path /
                                                      f"{name}_torch.cereal")
    save_j(pj, *args)
    save_t(pt, *args)
    with open(pj, "rb") as f, open(pt, "rb") as g:
        assert f.read() == g.read(), name
    return pj, pt


@pytest.mark.parametrize("seed", SEEDS)
def test_map_files_byte_equal_and_cross_load(seed, tmp_path):
    parts = _rand_map(np.random.default_rng(seed))
    pj, pt = _write_both(tmp_path, "map", jcio.save_map_cereal,
                         cio.save_map_cereal, *parts)
    ref = jcio.load_map_cereal(pj)
    _assert_same(cio.load_map_cereal(pj), ref)
    _assert_same(jcio.load_map_cereal(pt), ref)
    _assert_same(cio.load_map_cereal(pt), ref)
    corners, _, tracks, outliers, cameras, _ = parts
    assert ref["feature_tracks"] == tracks
    assert ref["outlier_tracks"] == outliers
    for fcid in cameras:
        np.testing.assert_array_equal(ref["cameras"][fcid], cameras[fcid])
        np.testing.assert_array_equal(ref["corners"][fcid]["descriptors"],
                                      corners[fcid]["descriptors"])


@pytest.mark.parametrize("seed", SEEDS)
def test_stage_caches_byte_equal_and_cross_load(seed, tmp_path):
    corners, matches, *_ = _rand_map(np.random.default_rng(seed))
    pj, pt = _write_both(tmp_path, "corners", jcio.save_corners_cereal,
                         cio.save_corners_cereal, corners)
    ref = jcio.load_corners_cereal(pj)
    _assert_same(cio.load_corners_cereal(pj), ref)
    _assert_same(jcio.load_corners_cereal(pt), ref)
    for fcid, kp in corners.items():
        np.testing.assert_array_equal(ref[fcid]["descriptors"],
                                      kp["descriptors"])
        np.testing.assert_allclose(ref[fcid]["uv"], kp["uv"], rtol=1e-6)
    pj, pt = _write_both(tmp_path, "matches", jcio.save_matches_cereal,
                         cio.save_matches_cereal, matches)
    ref = jcio.load_matches_cereal(pj)
    _assert_same(cio.load_matches_cereal(pj), ref)
    _assert_same(jcio.load_matches_cereal(pt), ref)
    key = ((0, 0), (0, 1))
    np.testing.assert_array_equal(ref[key]["inliers"],
                                  matches[key]["inliers"])


@pytest.mark.parametrize("seed", SEEDS)
def test_bitset_helpers_match_and_round_trip(seed):
    rng = np.random.default_rng(seed)
    for _ in range(5):
        w = rng.integers(0, 2**32, 8, dtype=np.uint32)
        b = cio._words_to_bitset_bytes(w)
        assert b == jcio._words_to_bitset_bytes(w)
        assert np.array_equal(cio._bitset_bytes_to_words(b), w)
        assert np.array_equal(jcio._bitset_bytes_to_words(b), w)
    # bit i of the bitset is bit (7 - i % 8) of byte i // 8
    words = np.zeros(8, np.uint32)
    words[1] = 1 << 5
    assert cio._words_to_bitset_bytes(words)[4] == 0x04
