"""The port's CUDA kernels on the card: built from csrc/, held against
their plain PyTorch versions, and their wrappers' guards; the front end
and the kernel-sampled photometric solvers on the card against the CPU
plain path.  Marked ``cuda``; each test skips where no CUDA device is
present.  The megakernel (both tiers) and the patch sampler contract
a*b + c into FMAs and the plain versions do not, so they agree to about
one ulp per operation: atol 1e-4 * max|ref| (per row block for the
megakernel).  The Hamming kernel is integer arithmetic and the window
read a copy: both must be bit-identical.  The grid probe's output must be
exactly zero and its checksums agree within rtol 1e-5 (the order of the
sums differs).

Run on a GPU host (the repository's conftest imports JAX, which GPU hosts
need not have, hence ``--noconftest``):

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

import copy

import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu_torch import interop
from photometric_bundle_adjustment_tpu_torch.features import pair_matching
from photometric_bundle_adjustment_tpu_torch.models import synthetic
from photometric_bundle_adjustment_tpu_torch.models import photometric_ba as pba
from photometric_bundle_adjustment_tpu_torch.ops import hamming, pba_mega
from photometric_bundle_adjustment_tpu_torch.ops import patch_sample as ps
from photometric_bundle_adjustment_tpu_torch.optim import ba, fused
from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine
from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
    SfmPipeline,
)
from photometric_bundle_adjustment_tpu_torch.scripts import exp_roll
from photometric_bundle_adjustment_tpu_torch.scripts import grid_overhead as go

pytestmark = pytest.mark.cuda

P, GROUP = pba_mega.P, pba_mega.GROUP


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(device, H=64, W=96, Kimg=3, counts=(256, 130, 7), seed=0):
    gen = torch.Generator().manual_seed(seed)
    ng = len(counts)
    Og = ng * GROUP

    def rand(*shape, lo=0.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(shape, generator=gen)).to(device)

    images = rand(Kimg, H, W, hi=255.0)
    ux = rand(P, Og, lo=-5.0, hi=W + 4.0)
    uy = rand(P, Og, lo=-5.0, hi=H + 4.0)
    ux[:, 11] = -1e6                         # a non-finite projection
    uy[:, 11] = -1e6
    GA = torch.randn((13 * P, Og), generator=gen).to(device)
    GB = torch.randn((13 * P, Og), generator=gen).to(device)
    refp = rand(P, Og, hi=255.0)
    aff = (0.1 * torch.randn((4, Og), generator=gen)).to(device)
    iog = torch.tensor([i % Kimg for i in range(ng)], dtype=torch.int32,
                       device=device)
    cnt = torch.tensor(counts, dtype=torch.int32, device=device)
    return images, ux, uy, GA, GB, refp, aff, iog, cnt


def _assert_matches(out, ref):
    nan = torch.isnan(ref[pba_mega.ROW_COST])
    assert torch.equal(torch.isnan(out[pba_mega.ROW_COST]), nan)
    for rows in (slice(0, 136), slice(136, 144), slice(144, 145),
                 slice(145, 162), slice(162, 179), slice(179, 184)):
        a, b = out[rows][:, ~nan].cpu(), ref[rows][:, ~nan].cpu()
        scale = max(float(b.abs().max()), 1e-6)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4 * scale)


@pytest.mark.parametrize("width", [96, 8448])
def test_kernel_matches_plain_version(cuda, width):
    args = _inputs(cuda, W=width)
    before = pba_mega.KERNEL_LAUNCHES
    out = pba_mega.mega_rj(*args, 9.0)
    torch.cuda.synchronize()
    assert pba_mega.KERNEL_LAUNCHES == before + 1
    ref = pba_mega.mega_rj_reference(*args, 9.0)
    _assert_matches(out, ref)
    cnt = args[-1].long().repeat_interleave(GROUP)
    pad = (torch.arange(out.shape[1], device=cuda) % GROUP) >= cnt
    assert (out[:, pad] == 0).all()


@pytest.mark.parametrize("width", [96, 8448])
def test_bf16_kernel_matches_plain_version(cuda, width):
    images, *rest = _inputs(cuda, W=width, seed=5)
    bf = images.to(torch.bfloat16)
    before = (pba_mega.KERNEL_LAUNCHES, pba_mega.KERNEL_LAUNCHES_BF16)
    out = pba_mega.mega_rj(bf, *rest, 9.0)
    torch.cuda.synchronize()
    assert (pba_mega.KERNEL_LAUNCHES,
            pba_mega.KERNEL_LAUNCHES_BF16) == (before[0], before[1] + 1)
    _assert_matches(out, pba_mega.mega_rj_reference(bf.float(), *rest, 9.0))
    # the tier is on: rounding the stack moves the payload
    assert not torch.equal(out, pba_mega.mega_rj(images, *rest, 9.0))


def test_kernel_squared_loss(cuda):
    args = _inputs(cuda, seed=3)
    _assert_matches(pba_mega.mega_rj(*args, 0.0),
                    pba_mega.mega_rj_reference(*args, 0.0))


def test_wrapper_rejects_bad_inputs(cuda):
    images, ux, uy, GA, GB, refp, aff, iog, cnt = _inputs(cuda)
    with pytest.raises(ValueError, match="float32"):
        pba_mega.mega_rj(images, ux.double(), uy, GA, GB, refp, aff, iog,
                         cnt, 9.0)
    with pytest.raises(ValueError, match="contiguous"):
        pba_mega.mega_rj(images, ux, uy, GA.T.contiguous().T, GB, refp, aff,
                         iog, cnt, 9.0)
    with pytest.raises(ValueError, match="multiple"):
        pba_mega.mega_rj(images, ux[:, :100], uy[:, :100], GA, GB, refp, aff,
                         iog, cnt, 9.0)
    with pytest.raises(ValueError, match="is on cpu"):
        pba_mega.mega_rj(images, ux, uy, GA, GB, refp, aff, iog.cpu(), cnt,
                         9.0)
    # bf16 is taken for the image stack only
    with pytest.raises(ValueError, match="float32"):
        pba_mega.mega_rj(images.to(torch.bfloat16), ux.to(torch.bfloat16),
                         uy, GA, GB, refp, aff, iog, cnt, 9.0)
    with pytest.raises(ValueError, match="bfloat16"):
        pba_mega.mega_rj(images.half(), ux, uy, GA, GB, refp, aff, iog, cnt,
                         9.0)


def test_refine_on_card_matches_cpu(cuda):
    pipe = synthetic.synth_pba_pipe(K=12, L=144, obs_per_lm=3, long_tracks=6,
                                    seed=0)
    runs = []
    for dev in (cuda, "cpu"):
        p = copy.deepcopy(pipe)
        res = pba_refine.refine_photometric(p, levels=2, max_iterations=3,
                                            log=lambda s: None, device=dev)
        runs.append((float(res.initial_cost), float(res.cost),
                     np.stack([p.cameras[k] for k in sorted(p.cameras)])))
    (i_g, c_g, p_g), (i_c, c_c, p_c) = runs
    np.testing.assert_allclose(i_g, i_c, rtol=2e-4)
    np.testing.assert_allclose(c_g, c_c, rtol=5e-3)
    np.testing.assert_allclose(p_g, p_c, atol=1e-4)


def _descriptor_stack(kind: str, I=6, F=300, seed=0):
    """(desc (I, F, 8) uint32, valid (I, F) bool): random, or heavy with
    exact ties (rows repeated within and across images)."""
    rng = np.random.default_rng(seed)
    desc = rng.integers(0, 2**32, (I, F, 8), dtype=np.uint32)
    valid = rng.random((I, F)) < 0.85
    if kind == "ties":
        desc[:, F // 2:] = desc[:, :F - F // 2]
        desc[1:] = np.where(rng.random((I - 1, F, 1)) < 0.5, desc[:1], desc[1:])
        desc[2, :20] = desc[2, 0]
    return desc, valid


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_hamming_kernel_bit_identical(cuda, kind):
    desc, valid = _descriptor_stack(kind)
    d = interop.descriptors_from_numpy(desc, cuda)
    v = torch.as_tensor(valid, device=cuda)
    ids = np.array([(i, j) for i in range(6) for j in range(6)])
    before = hamming.KERNEL_LAUNCHES
    out = hamming.best_two_nn(d, d, v, ids[:, 0], ids[:, 1])
    torch.cuda.synchronize()
    assert hamming.KERNEL_LAUNCHES == before + 1
    ref = hamming.best_two_nn_reference(d, d, v, ids[:, 0], ids[:, 1])
    for o, r in zip(out, ref):
        assert torch.equal(o, r)
    if kind == "ties":
        assert bool((out[0] == out[1]).any())
    # a single row block of 1 valid column, and none
    v1 = torch.zeros_like(v)
    v1[:, 0] = True
    for mask, second in ((v1, hamming.BIG), (torch.zeros_like(v), hamming.BIG)):
        o = hamming.best_two_nn(d, d, mask, [0, 1], [2, 3])
        r = hamming.best_two_nn_reference(d, d, mask, [0, 1], [2, 3])
        assert all(torch.equal(x, y) for x, y in zip(o, r))
        assert bool((o[1] == second).all())


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_hamming_both_kernel_bit_identical(cuda, kind):
    """One launch gives both directions, bit for bit the plain version's:
    one stack on both sides, two stacks of ragged sizes (I1 != I2, N1 =
    300 against N2 = 77), N = 1, and all-false or one-valid masks."""
    desc, valid = _descriptor_stack(kind)
    d = interop.descriptors_from_numpy(desc, cuda)
    v = torch.as_tensor(valid, device=cuda)
    d2, v2 = d[:4, :77].contiguous(), v[:4, :77].contiguous()
    one = torch.zeros_like(v)
    one[:, 3] = True
    ids = np.array([(i, j) for i in range(6) for j in range(6)])
    cases = [(d, v, d, v, ids[:, 0], ids[:, 1]),
             (d, v, d2, v2, ids[:, 0], ids[:, 1] % 4),
             (d[:, :1].contiguous(), v[:, :1].contiguous(),
              d[:, 5:6].contiguous(), v[:, 5:6].contiguous(), [0, 3], [1, 3]),
             (d, torch.zeros_like(v), d2, torch.zeros_like(v2), [0, 5], [1, 2]),
             (d, one, d, one, [0, 1, 4], [2, 1, 3])]
    for d1_, v1_, d2_, v2_, a, b in cases:
        before = hamming.KERNEL_LAUNCHES
        out = hamming.best_two_both(d1_, v1_, d2_, v2_, a, b)
        torch.cuda.synchronize()
        assert hamming.KERNEL_LAUNCHES == before + 1
        ref = hamming.best_two_both_reference(d1_, v1_, d2_, v2_, a, b)
        for o, r in zip(out, ref):
            assert torch.equal(o, r)
        fwd = hamming.best_two_nn(d1_, d2_, v2_, a, b)
        assert all(torch.equal(o, r) for o, r in zip(fwd, ref[:3]))
        if kind == "ties" and d1_ is d2_ and v1_ is v:
            assert bool((out[0] == out[1]).any() and (out[3] == out[4]).any())


def test_hamming_both_wrapper_rejects_bad_inputs(cuda):
    desc, valid = _descriptor_stack("random")
    d = interop.descriptors_from_numpy(desc, cuda)
    v = torch.as_tensor(valid, device=cuda)
    with pytest.raises(ValueError, match="valid1"):
        hamming.best_two_both(d, v[:, :10], d, v, [0], [1])
    with pytest.raises(ValueError, match="valid1 must be"):
        hamming.best_two_both(d, v.int(), d, v, [0], [1])
    with pytest.raises(ValueError, match="out of range"):
        hamming.best_two_both(d, v, d, v, [6], [1])
    big = torch.zeros((1, 8000, 8), dtype=torch.int32, device=cuda)
    vbig = torch.ones((1, 8000), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        hamming.best_two_both(big, vbig, big, vbig, [0], [0])


def test_hamming_wrapper_rejects_bad_inputs(cuda):
    desc, valid = _descriptor_stack("random")
    d = interop.descriptors_from_numpy(desc, cuda)
    v = torch.as_tensor(valid, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        hamming.best_two_nn(d.long(), d, v, [0], [1])
    with pytest.raises(ValueError, match="out of range"):
        hamming.best_two_nn(d, d, v, [0], [6])
    with pytest.raises(ValueError, match="is on cpu"):
        hamming.best_two_nn(d, d, v.cpu(), [0], [1])
    with pytest.raises(ValueError, match="contiguous"):
        hamming.best_two_nn(d[:, ::2], d, v, [0], [1])


def test_front_end_on_card_matches_cpu(cuda):
    """Detection, description, stereo matching and all-pairs matching on
    the card against the CPU plain path, on one small sequence: corners
    identical, descriptors but for a stated share of bits (cos/sin and
    the moment sums round differently on the card), match lists
    identical wherever the descriptors are."""
    seq = synthetic.synth_stereo_sequence(n_frames=4, H=240, W=376,
                                          device="cpu")
    pipes = {}
    for dev in (cuda, "cpu"):
        p = SfmPipeline(seq.images, seq.calib, log=lambda *a: None,
                        device=dev)
        p.detect_keypoints()
        p.match_stereo()
        pipes[torch.device(dev).type] = p
    g, c = pipes["cuda"], pipes["cpu"]
    flips = bits = 0
    for k in c.fcids:
        np.testing.assert_array_equal(g.corners[k]["uv"], c.corners[k]["uv"])
        np.testing.assert_array_equal(g.corners[k]["valid"],
                                      c.corners[k]["valid"])
        v = c.corners[k]["valid"]
        np.testing.assert_allclose(g.corners[k]["angles"][v],
                                   c.corners[k]["angles"][v], atol=1e-4)
        x = g.corners[k]["desc"][v] ^ c.corners[k]["desc"][v]
        flips += int(np.unpackbits(x.view(np.uint8)).sum())
        bits += x.size * 32
    assert flips <= 5e-4 * bits, (flips, bits)
    if flips == 0:
        for key in c.matches:
            for f in ("matches", "inliers"):
                np.testing.assert_array_equal(g.matches[key][f],
                                              c.matches[key][f])
    ids = np.array(c._pair_worklist())
    tables = []
    for p in (g, c):
        _, valid, desc, _ = p._stack_features()
        tables.append(pair_matching.match_pairs(desc, valid, ids[:, 0],
                                                ids[:, 1]).cpu().numpy())
    if flips == 0:
        np.testing.assert_array_equal(tables[0], tables[1])
    assert (tables[0] >= 0).sum() > 0


def _sampler_inputs(device, H=64, W=96, Kimg=3, counts=(128, 70, 5), seed=0):
    gen = torch.Generator().manual_seed(seed)
    Opad = len(counts) * ps.GROUP

    def rand(*shape, lo=0.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(shape, generator=gen)).to(device)

    images = rand(Kimg, H, W, hi=255.0)
    ux = rand(ps.P, Opad, lo=-5.0, hi=W + 4.0)
    uy = rand(ps.P, Opad, lo=-5.0, hi=H + 4.0)
    ux[:, 11] = -1e6                         # a non-finite projection
    uy[:, 11] = -1e6
    iog = torch.tensor([i % Kimg for i in range(len(counts))],
                       dtype=torch.int32, device=device)
    cnt = torch.tensor(counts, dtype=torch.int32, device=device)
    return images, ux, uy, iog, cnt, (H, W)


@pytest.mark.parametrize("want_grads", [True, False])
def test_patch_sample_kernel_matches_plain_version(cuda, want_grads):
    args = _sampler_inputs(cuda)
    before = ps.KERNEL_LAUNCHES
    out = ps.sample_patches_grouped(*args, want_grads)
    torch.cuda.synchronize()
    assert ps.KERNEL_LAUNCHES == before + 1
    ref = ps.sample_patches_reference(*args, want_grads)
    scale = float(args[0].abs().max())
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=1e-4 * scale)
    cnt = args[4].long().repeat_interleave(ps.GROUP)
    pad = (torch.arange(out[0].shape[1], device=cuda) % ps.GROUP) >= cnt
    assert all(bool((a[:, pad] == 0).all()) for a in out)
    if not want_grads:
        assert not out[1].any() and not out[2].any()


def test_patch_sample_wrapper_rejects_bad_inputs(cuda):
    images, ux, uy, iog, cnt, HW = _sampler_inputs(cuda)
    with pytest.raises(ValueError, match="float32"):
        ps.sample_patches_grouped(images, ux.double(), uy, iog, cnt, HW)
    with pytest.raises(ValueError, match="contiguous"):
        ps.sample_patches_grouped(images, ux.T.contiguous().T, uy, iog, cnt,
                                  HW)
    with pytest.raises(ValueError, match="multiple"):
        ps.sample_patches_grouped(images, ux[:, :100], uy[:, :100], iog, cnt,
                                  HW)
    with pytest.raises(ValueError, match="is on cpu"):
        ps.sample_patches_grouped(images, ux, uy, iog.cpu(), cnt, HW)
    with pytest.raises(ValueError, match="images3d must be"):
        ps.sample_patches_grouped(images, ux, uy, iog, cnt, (32, 96))


@pytest.mark.parametrize("solver", ["kernel_fused", "kernel_dense"])
def test_kernel_solvers_on_card_match_cpu(cuda, solver):
    """Both kernel-sampled solvers on the card against the CPU plain path
    on one small problem; every build and residual pass on the card
    launches the sampler once."""
    problem, images, H, W = synthetic.euroc_scale_pba(
        K=12, L=96, obs_per_lm=3, H=64, W=96, device="cpu")
    cfg = ba.BAConfig(max_iterations=5, huber_delta=9.0,
                      cost_from_build=solver == "kernel_dense")
    if solver == "kernel_fused":
        problem, iog, cnt = pba.imagesort_problem(problem, 12)
        plan = fused.plan_for_problem(problem)
    else:
        problem, plan = fused.densify_problem(problem)
    runs = []
    for dev in (cuda, "cpu"):
        if solver == "kernel_fused":
            solve = pba.make_kernel_fused_solver("pinhole", images, H, W, iog,
                                                 cnt, device=dev)
        else:
            solve = pba.make_kernel_dense_solver("pinhole", images, H, W,
                                                 problem, 12, device=dev)
        before = ps.KERNEL_LAUNCHES
        p, res = solve(problem, plan, cfg)
        launches = ps.KERNEL_LAUNCHES - before
        runs.append((float(res.initial_cost), float(res.cost),
                     p.cam_states.pose.cpu().numpy()))
        if dev == cuda:
            assert launches == res.builds + res.residual_passes > 0
    (i_g, c_g, p_g), (i_c, c_c, p_c) = runs
    np.testing.assert_allclose(i_g, i_c, rtol=2e-4)
    np.testing.assert_allclose(c_g, c_c, rtol=5e-3)
    np.testing.assert_allclose(p_g, p_c, atol=1e-4)
    assert c_g < i_g


@pytest.mark.parametrize("index", range(11))
def test_grid_probe_matches_plain_version(cuda, index):
    v = go.variants()[index]
    lanes, images = go.make_inputs(cuda, seed=2)
    args = go.variant_args(v, lanes, images)
    before = go.KERNEL_LAUNCHES
    out, checksum = go.probe(**args)
    torch.cuda.synchronize()
    assert go.KERNEL_LAUNCHES == before + 1
    _, ref = go.probe_reference(**args)
    assert go.check(out, checksum, ref, v.label) <= 1e-5


@pytest.mark.parametrize("mode", exp_roll.MODES)
def test_window_kernel_bit_identical(cuda, mode):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((64, 24, 256), generator=gen).to(cuda)
    s = torch.tensor([0, 1, 13, 127, 128, -3, 129, 300] * 8,
                     dtype=torch.int32, device=cuda)
    before = exp_roll.KERNEL_LAUNCHES
    out = exp_roll.window(x, s, mode)
    torch.cuda.synchronize()
    assert exp_roll.KERNEL_LAUNCHES == before + 1
    ref = exp_roll.window_reference(x, s, mode)
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert torch.equal(out.nan_to_num(), ref.nan_to_num())
    assert exp_roll.main(["--device", "cuda", mode]) == {mode: True}
