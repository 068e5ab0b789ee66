"""Parity of the port's front-end features with the JAX package on the CPU:
the Hamming best-two matcher (against the XLA route and against the Pallas
TPU kernel body run in interpret mode), the ratio test at its f32
boundary, the mutual matcher and its compaction, Shi-Tomasi detection
(tie order included), orientation and BRIEF descriptors, and the copied
sampling pattern.  Inputs come from numpy seeds and go through both
packages unchanged."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from photometric_bundle_adjustment_tpu.features import describe as jdescribe
from photometric_bundle_adjustment_tpu.features import detect as jdetect
from photometric_bundle_adjustment_tpu.features import match as jmatch
from photometric_bundle_adjustment_tpu.features import (
    pair_matching as jpair_matching,
)
from photometric_bundle_adjustment_tpu.ops import hamming as jhamming
from photometric_bundle_adjustment_tpu_torch import interop
from photometric_bundle_adjustment_tpu_torch.features import (
    describe,
    detect,
    match,
    pair_matching,
)
from photometric_bundle_adjustment_tpu_torch.models import synthetic
from photometric_bundle_adjustment_tpu_torch.ops import hamming

torch.set_num_threads(1)


def checkerboard(h=120, w=160, sq=16):
    y, x = np.mgrid[0:h, 0:w]
    return (((y // sq) + (x // sq)) % 2 * 255).astype(np.uint8)


@functools.cache
def rendered_frames():
    """Two stereo frames (4 images) of the front-end sequence, 120x160."""
    seq = synthetic.synth_stereo_sequence(n_frames=2, H=120, W=160, cell=2.0,
                                          device="cpu")
    return np.stack([seq.images[k] for k in sorted(seq.images)])


def t_desc(d):
    return interop.descriptors_from_numpy(d, "cpu")


# ---------------------------------------------------------------------------
# Hamming best-two
# ---------------------------------------------------------------------------


@functools.cache
def _pallas_best_two():
    """The TPU kernel body ``hamming._match_kernel`` launched with
    ``best_two_nn``'s own BlockSpecs, in interpret mode."""
    T = jhamming.TILE_M

    def run(d1, d2, n2):
        N1 = d1.shape[0]
        out = pl.pallas_call(
            jhamming._match_kernel,
            grid=(N1 // T,),
            in_specs=[
                pl.BlockSpec((T, 8), lambda i: (i, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec(memory_space=pltpu.VMEM),
                pl.BlockSpec(memory_space=pltpu.SMEM),
            ],
            out_specs=[pl.BlockSpec((1, T), lambda i: (0, i),
                                    memory_space=pltpu.VMEM)] * 3,
            out_shape=[jax.ShapeDtypeStruct((1, N1), jnp.int32)] * 3,
            interpret=True,
        )(d1, d2, jnp.asarray(n2, jnp.int32).reshape(1))
        return out[0][0], out[1][0], out[2][0]

    return jax.jit(run)


N1, N2 = 256, 384


def _descriptor_case(case: str):
    """(d1 (N1, 8), d2 (N2, 8)) uint32 and the count n2 of valid d2 rows."""
    rng = np.random.default_rng(7)
    d1 = rng.integers(0, 2**32, (N1, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (N2, 8), dtype=np.uint32)
    n2 = {"random": 300, "n2=0": 0, "n2=1": 1, "n2=F-1": N2 - 1,
          "ties": N2}[case]
    if case == "ties":
        # duplicated rows: exact ties at the best distance and between
        # second and best, plus rows of d1 equal to rows of d2
        d2[100:200] = d2[:100]
        d2[300:] = d2[200:284]
        d1[:64] = d2[rng.integers(0, N2, 64)]
        d1[64:96] = d2[5] ^ np.uint32(1)
    return d1, d2, n2


@pytest.mark.parametrize("case", ["random", "n2=0", "n2=1", "n2=F-1", "ties"])
def test_best_two_bit_identical_to_xla_and_pallas(case):
    """The port's plain best-two (the kernel's CPU form) against the XLA
    route and the Pallas kernel in interpret mode: bit-identical."""
    d1, d2, n2 = _descriptor_case(case)
    valid2 = np.arange(N2) < n2
    ref_xla = jmatch._best_two_xla(jnp.asarray(d1), jnp.asarray(d2),
                                   jnp.asarray(valid2))
    ref_tpu = _pallas_best_two()(jnp.asarray(d1), jnp.asarray(d2), n2)
    zero = np.zeros(1, np.int64)
    got = hamming.best_two_nn(t_desc(d1)[None], t_desc(d2)[None],
                              torch.as_tensor(valid2)[None], zero, zero)
    for g, rx, rt in zip(got, ref_xla, ref_tpu):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(rx))
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(rt))
    if case == "n2=0":
        assert (got[0] == hamming.BIG).all() and (got[2] == 0).all()
    if case == "n2=1":
        assert (got[1] == hamming.BIG).all()
    if case == "ties":
        assert (got[0] == got[1]).any()


def test_best_two_any_mask_and_worklist():
    """A non-prefix mask and a worklist of pairs over one descriptor stack:
    each pair bit-identical to the XLA route on that pair."""
    rng = np.random.default_rng(11)
    I, F = 5, 200
    desc = rng.integers(0, 2**32, (I, F, 8), dtype=np.uint32)
    desc[3, :50] = desc[1, 10:60]
    valid = rng.random((I, F)) < 0.8
    a = np.array([0, 3, 1, 4, 3, 2])
    b = np.array([1, 1, 3, 0, 2, 2])
    got = hamming.best_two_nn(t_desc(desc), t_desc(desc),
                              torch.as_tensor(valid), a, b)
    for p in range(len(a)):
        ref = jmatch._best_two_xla(jnp.asarray(desc[a[p]]),
                                   jnp.asarray(desc[b[p]]),
                                   jnp.asarray(valid[b[p]]))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[p].numpy(), np.asarray(r))


def test_hamming_matrix_and_popcount_against_numpy():
    """Distances against numpy's xor plus bit count, words with the top
    bit set included (int32 ``>>`` would be arithmetic)."""
    rng = np.random.default_rng(2)
    d1 = rng.integers(0, 2**32, (17, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (9, 8), dtype=np.uint32)
    d1[0] = 0xFFFFFFFF
    d2[0] = 0x80000000
    ref = np.unpackbits((d1[:, None] ^ d2[None]).view(np.uint8),
                        axis=-1).sum(-1).astype(np.int32)
    got = match.hamming_matrix(t_desc(d1), t_desc(d2))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmatch.hamming_matrix(jnp.asarray(d1),
                                                      jnp.asarray(d2))))


def test_ratio_test_f32_boundary():
    """The accept rule in float32, as the XLA route evaluates it.  At ratio
    1.2, (60, 72) accepts in both f32 and double; (25, 30), (45, 54) and
    (50, 60) reject in f32 though double accepts them (the native matcher's
    rule)."""
    best = np.array([60, 60, 59, 25, 25, 45, 50, 50, 69, 70], np.int32)
    second = np.array([72, 71, 70, 30, 31, 54, 60, 61, 83, 84], np.int32)
    bidx = np.arange(len(best), dtype=np.int32)
    ok = np.ones(len(best), bool)
    ref = np.asarray(jmatch._one_way(jnp.asarray(best), jnp.asarray(second),
                                     jnp.asarray(bidx), jnp.asarray(ok), 70,
                                     1.2))
    got = match._one_way(torch.as_tensor(best), torch.as_tensor(second),
                         torch.as_tensor(bidx), torch.as_tensor(ok), 70, 1.2)
    np.testing.assert_array_equal(got.numpy(), ref)
    accepted = got.numpy() >= 0
    assert accepted[0] and not accepted[3] and not accepted[5] \
        and not accepted[6]
    assert all(float(s) >= b * 1.2 for b, s in [(25, 30), (45, 54), (50, 60)])
    assert not accepted[-1]  # best must be < threshold


def _planted_pair(seed=0, n1=150, n2=170, n_true=100, flips=12):
    """d2 holds noisy copies of n_true rows of d1, with invalid rows."""
    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 2**32, (n1, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (n2, 8), dtype=np.uint32)
    src = rng.permutation(n1)[:n_true]
    dst = rng.permutation(n2)[:n_true]
    noisy = d1[src].copy()
    bits = np.unpackbits(noisy.view(np.uint8), axis=1)
    for r in range(n_true):
        bits[r, rng.choice(256, rng.integers(0, flips), replace=False)] ^= 1
    d2[dst] = np.packbits(bits, axis=1).view(np.uint32)
    d2[dst[:5]] = d2[dst[5:10]]   # duplicates: ratio-test rejections
    v1 = rng.random(n1) < 0.9
    v2 = rng.random(n2) < 0.9
    return d1, d2, v1, v2


@pytest.mark.parametrize("seed", [0, 1])
def test_match_descriptors_mutual_bit_identical(seed):
    d1, d2, v1, v2 = _planted_pair(seed)
    ref = np.asarray(jmatch.match_descriptors(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2),
        70, 1.2))
    got = match.match_descriptors(t_desc(d1), t_desc(d2), torch.as_tensor(v1),
                                  torch.as_tensor(v2), 70, 1.2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref >= 0).sum() > 50


def test_matches_to_pairs_and_compaction():
    d1, d2, v1, v2 = _planted_pair(3)
    m12 = np.array(jmatch.match_descriptors(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2)))
    for mm in (64, 200):
        ref = jmatch.matches_to_pairs(jnp.asarray(m12), mm)
        got = match.matches_to_pairs(torch.as_tensor(m12), mm)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    table = np.stack([m12, np.roll(m12, 7), np.full_like(m12, -1)])
    ref = jpair_matching.compact_matches_np(table, 64)
    got = pair_matching.compact_matches_np(table, 64)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
        assert g.dtype == r.dtype
    # a budget above F: the JAX package's numpy copy raises there, so the
    # port is held to its matches_to_pairs, row by row
    got = pair_matching.compact_matches_np(table, 200)
    for p in range(len(table)):
        ref = jmatch.matches_to_pairs(jnp.asarray(table[p]), 200)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[p], np.asarray(r))


# ---------------------------------------------------------------------------
# detection and description
# ---------------------------------------------------------------------------

# f32 filters in the same order of terms; XLA may contract a*b + c into
# FMAs where torch does not, so scores agree to a few ulps of the map
SCORE_RTOL, SCORE_ATOL_REL = 1e-5, 1e-6


def _images(kind):
    return checkerboard()[None] if kind == "checkerboard" else rendered_frames()


@pytest.mark.parametrize("kind", ["checkerboard", "rendered"])
def test_shi_tomasi_score_matches_jax(kind):
    imgs = _images(kind)
    got = detect.shi_tomasi_score(torch.as_tensor(imgs)).numpy()
    for i, img in enumerate(imgs):
        ref = np.asarray(jdetect.shi_tomasi_score(jnp.asarray(img)))
        np.testing.assert_allclose(got[i], ref, rtol=SCORE_RTOL,
                                   atol=SCORE_ATOL_REL * np.abs(ref).max())


@pytest.mark.parametrize("kind,num_features,min_distance", [
    ("checkerboard", 100, 4), ("checkerboard", 1500, 8),
    ("rendered", 1500, 8), ("rendered", 40, 8)])
def test_detect_keypoints_identical_with_tie_order(kind, num_features,
                                                   min_distance):
    """uv and valid identical in every slot: the checkerboard's corners
    tie exactly, and both packages order ties by flat index."""
    imgs = _images(kind)
    uv, valid, score = detect.detect_keypoints(
        torch.as_tensor(imgs), num_features=num_features,
        min_distance=min_distance)
    for i, img in enumerate(imgs):
        ruv, rvalid, rscore = detect_j(img, num_features, min_distance)
        np.testing.assert_array_equal(uv[i].numpy(), ruv)
        np.testing.assert_array_equal(valid[i].numpy(), rvalid)
        np.testing.assert_allclose(score[i].numpy(), rscore, rtol=SCORE_RTOL)
        assert rvalid.sum() >= 10
    if kind == "checkerboard":
        s = score[0][valid[0]].numpy()
        assert (s[1:] == s[:-1]).any(), "expected exact ties"


def detect_j(img, num_features, min_distance):
    return tuple(np.asarray(x) for x in jdetect.detect_keypoints(
        jnp.asarray(img), num_features=num_features,
        min_distance=min_distance))


def test_brief_pattern_copy_equals_jax():
    with np.load(jdescribe.os.path.join(jdescribe.os.path.dirname(
            jdescribe.__file__), "brief_pattern.npz")) as z:
        ref = {k: z[k] for k in z.files}
    got = describe.brief_pattern()
    assert sorted(ref) == sorted(got)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
        assert got[k].dtype == ref[k].dtype


# Angles: atan2 of moments that are sums of up to ~700 taps in the same
# order; the two libraries' atan2 differ by an ulp or so
ANGLE_ATOL = 1e-5
# Descriptor bits can flip only where round(c px - s py) lands on .5 after
# the libraries' cos/sin differ by an ulp: allow 1 bit in 2,000
BIT_FLIP_SHARE = 5e-4


def _angle_desc_case():
    imgs = rendered_frames()
    uv, valid, _ = detect.detect_keypoints(torch.as_tensor(imgs))
    return imgs, uv, valid


def test_compute_angles_matches_jax():
    imgs, uv, valid = _angle_desc_case()
    got = describe.compute_angles(torch.as_tensor(imgs), uv).numpy()
    for i, img in enumerate(imgs):
        ref = np.asarray(jdescribe.compute_angles(jnp.asarray(img),
                                                  jnp.asarray(uv[i].numpy())))
        v = valid[i].numpy()
        np.testing.assert_allclose(got[i][v], ref[v], atol=ANGLE_ATOL)


def test_compute_descriptors_bits_match_jax():
    """Fed the same (JAX) angles, descriptors agree bit for bit but for a
    stated small share."""
    imgs, uv, valid = _angle_desc_case()
    flips = total = 0
    for i, img in enumerate(imgs):
        v = valid[i].numpy()
        ang = jdescribe.compute_angles(jnp.asarray(img),
                                       jnp.asarray(uv[i].numpy()))
        ref = np.asarray(jdescribe.compute_descriptors(
            jnp.asarray(img), jnp.asarray(uv[i].numpy()), ang))[v]
        got = describe.compute_descriptors(
            torch.as_tensor(img)[None], uv[i][None],
            torch.as_tensor(np.array(ang))[None])
        got = interop.descriptors_to_numpy(got[0])[v]
        flips += int(np.unpackbits((got ^ ref).view(np.uint8)).sum())
        total += got.size * 32
    assert flips <= BIT_FLIP_SHARE * total, (flips, total)


def test_detect_and_describe_all_matches_jax():
    """Three images in sub-batches of 2: the port runs a short last batch
    where the JAX package pads with a zero image."""
    imgs = rendered_frames()[:3]
    got = describe.detect_and_describe_all(torch.as_tensor(imgs), batch=2,
                                           num_features=300)
    padded = np.concatenate([imgs, np.zeros_like(imgs[:1])])
    ref = [np.asarray(x)[:3] for x in jdescribe.detect_and_describe_all(
        jnp.asarray(padded), batch=2, num_features=300)]
    feats = interop.features_to_numpy(dict(zip(("uv", "valid", "angles",
                                                 "desc"), got)))
    np.testing.assert_array_equal(feats["uv"], ref[0])
    np.testing.assert_array_equal(feats["valid"], ref[1])
    v = ref[1]
    np.testing.assert_allclose(feats["angles"][v], ref[2][v], atol=ANGLE_ATOL)
    flips = np.unpackbits((feats["desc"][v] ^ ref[3][v]).view(np.uint8)).sum()
    assert flips <= BIT_FLIP_SHARE * v.sum() * 256
    assert feats["desc"].dtype == np.uint32
