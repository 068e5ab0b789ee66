"""The port's ring all-pairs matcher (``pair_matching.ring_match_all_pairs``)
on the CPU (Gloo, D = 4 spawned ranks) against the JAX package's ring on
a 4-device mesh, on tests/test_pair_matching.py's
``synth_features(I=8, F=96, seed=3)``: pairs, valid masks and counts
bit-equal for every (a, b), the diagonal included, and equal to the port's
``match_pairs`` on each pair and to a 2-rank ring that the entry point
spawns itself; one ``match_batch`` a ring step (the
Hamming kernel's plain version here: it counts no launch) and D - 1
descriptor shifts per rank; an image count that D does not divide is a
``ValueError``."""

import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu.features import (
    pair_matching as jpair,
)
from photometric_bundle_adjustment_tpu.parallel import mesh as jmesh
from photometric_bundle_adjustment_tpu_torch import interop
from photometric_bundle_adjustment_tpu_torch.features import match, pair_matching
from photometric_bundle_adjustment_tpu_torch.parallel import mesh
from tests.test_pair_matching import synth_features

torch.set_num_threads(1)

D, MM = 4, 48


@pytest.fixture(scope="module")
def features():
    desc, valid, _ = synth_features(I=8, F=96, seed=3)
    return (np.asarray(desc), np.asarray(valid),
            interop.descriptors_from_numpy(np.asarray(desc), "cpu"),
            torch.as_tensor(np.asarray(valid)))


@pytest.fixture(scope="module")
def ring(features):
    _, _, desc, valid = features
    return mesh.spawn(pair_matching.ring_rank, D, desc, valid, MM, 70, 1.2,
                      device="cpu", timeout=datetime.timedelta(seconds=60),
                      wall_limit=600.0, threads=1, log=lambda s: None)


def test_ring_matches_jax_ring(features, ring):
    jdesc, jvalid, _, _ = features
    pairs, pvalid, count = jpair.ring_match_all_pairs(
        jnp.asarray(jdesc), jnp.asarray(jvalid), jmesh.make_mesh(D),
        max_matches=MM, threshold=70, ratio=1.2)
    np.testing.assert_array_equal(ring["pairs"], np.asarray(pairs))
    np.testing.assert_array_equal(ring["pvalid"], np.asarray(pvalid))
    np.testing.assert_array_equal(ring["count"], np.asarray(count))
    off = ring["count"][~np.eye(8, dtype=bool)]
    assert off.min() >= 40
    # D - 1 shifts of the descriptor block and of its mask per rank
    assert ring["calls"] == {"ring.ppermute": 2 * (D - 1)}


def test_ring_matches_match_pairs(features, ring):
    _, _, desc, valid = features
    a, b = np.meshgrid(np.arange(8), np.arange(8), indexing="ij")
    table = pair_matching.match_pairs(desc, valid, a.ravel(), b.ravel())
    p, v, c = match.matches_to_pairs(table, MM)
    np.testing.assert_array_equal(ring["pairs"].reshape(64, MM, 2), p.numpy())
    np.testing.assert_array_equal(ring["pvalid"].reshape(64, MM), v.numpy())
    np.testing.assert_array_equal(ring["count"].reshape(64), c.numpy())


def test_ring_spawned_by_the_entry_point(features, ring, monkeypatch):
    """``ring_match_all_pairs`` without a group spawns its own ranks (2
    here) and returns the (I, I, ...) arrays: those of the 4-rank ring."""
    monkeypatch.setattr(mesh, "DEFAULT_TIMEOUT",
                        datetime.timedelta(seconds=60))
    monkeypatch.setattr(mesh, "DEFAULT_WALL_LIMIT", 600.0)
    _, _, desc, valid = features
    got = pair_matching.ring_match_all_pairs(desc, valid, 2, max_matches=MM,
                                             device="cpu")
    for g, key in zip(got, ("pairs", "pvalid", "count")):
        np.testing.assert_array_equal(g.numpy(), ring[key])


def test_ring_rejects_indivisible_image_count(features):
    _, _, desc, valid = features
    with pytest.raises(ValueError, match="not divisible"):
        pair_matching.ring_match_all_pairs(desc[:6], valid[:6], D,
                                           max_matches=16, device="cpu")
