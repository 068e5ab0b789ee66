"""The port's CUDA kernels on the card: built from csrc/, held against
their plain PyTorch versions, and their wrappers' guards; the front end
and the photometric solvers on the card against the CPU plain path, and
builds that repeat bit for bit.  Marked ``cuda``; each test skips where no
CUDA device is present.  The megakernel (every camera model, both tiers)
and the patch sampler contract a*b + c into FMAs and the plain versions
do not, so they agree to about one ulp per operation: atol 1e-4 * max|ref|
(per row block for the megakernel).  The Hamming kernel is integer
arithmetic and the window read a copy: both must be bit-identical.  The grid probe's output must be
exactly zero and its checksums agree within rtol 1e-5 (its inputs are
small integers, so the sums are in fact exact), two calls bit-equal.

RANSAC (no kernel of its own) runs on the card against the CPU on the
same injected samples, in f64: the inlier masks differ in at most 0.1% of
their entries, the poses agree within 1e-6; ``match_all`` on the card
launches the Hamming kernel once.  The SfM map stages' batched geometry
(no kernel of its own either) on the card against the CPU in f64: within
1e-9, a localisation wave within 1e-6; ``SfmPipeline.run`` on the card
from images to a finished map, held to the rendered truth.

Slice E on the card against the CPU: ``apps/pba.refine_map`` of a map the
port's SfM built (the refinement's tolerances), ``calibrate`` in f64
(within 1e-9 relative) and ``global_initialize`` (within 1e-6).

Slice F on the card: D = 2 spawned ranks sharing ``cuda:0`` under Gloo
(every collective against its definition; ``dist_fused`` replicated and
camera-partitioned against the single-device fused solve at
tests/test_dist_fused.py's bounds, the ranks bit-equal;
``ring_match_all_pairs`` bit-equal to ``match_pairs``, the Hamming kernel
launched twice per rank) and one rank under NCCL (the collectives, and
``dist_fused`` against the single-device solve).

The port's ``bench.main`` on the card at toy sizes: the ``_cuda`` lines
in the JAX main's order, strict JSON, no error, the kernels launched once
a call.

Run on a GPU host (the repository's conftest imports JAX, which GPU hosts
need not have, hence ``--noconftest``):

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

import copy

import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu_torch import interop
from photometric_bundle_adjustment_tpu_torch.core import se3
from photometric_bundle_adjustment_tpu_torch.features import match, pair_matching, ransac
from photometric_bundle_adjustment_tpu_torch.models import geometric_ba, synthetic
from photometric_bundle_adjustment_tpu_torch.models import photometric_ba as pba
from photometric_bundle_adjustment_tpu_torch.ops import geo_mega, hamming, pba_mega
from photometric_bundle_adjustment_tpu_torch.ops import patch_sample as ps
from photometric_bundle_adjustment_tpu_torch.optim import ba, fused
from photometric_bundle_adjustment_tpu_torch.parallel import dist_fused, mesh
from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine
from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
    SfmPipeline,
)
from photometric_bundle_adjustment_tpu_torch.scripts import exp_roll
from photometric_bundle_adjustment_tpu_torch.scripts import grid_overhead as go

pytestmark = pytest.mark.cuda

# the reference's test intrinsics' distortion terms (camera_models.h),
# put on the toy problem's own focal lengths and centre
DISTORTION = {"pinhole": [0.0, 0.0, 0.0, 0.0],
              "eucm": [0.51231234, 0.9, 0.0, 0.0],
              "ds": [0.5 * -0.150694, 0.5 * 1.48785, 0.0, 0.0],
              "kb4": [0.00693023, -0.0013828, -0.000272596, -0.000452646]}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _mega_inputs(device, model="pinhole", seed=0):
    """A toy problem in ``model`` on ``device``, its state pushed so that
    some observations leave the image (camera 5 shifted by 1.5), some lie
    behind the camera (landmark 7 at a negative inverse depth) and some
    are not finite (landmark 11 at an infinite one), and the kernel's
    columns of it (valid observations sorted by image, one zero column).
    Returns (images, cams, rho, consts)."""
    problem, images, H, W = synthetic.euroc_scale_pba(
        K=12, L=96, obs_per_lm=3, H=64, W=96, seed=seed, device=device)
    aux = problem.obs.aux
    intr = aux.intr_ref.clone()
    intr[:, 4:] = torch.tensor(DISTORTION[model], device=device)
    problem = problem._replace(obs=problem.obs._replace(
        aux=aux._replace(intr_ref=intr, intr_target=intr.clone())))
    _, rows = pba_mega.build_chunk_mega_plan(problem)
    consts = pba_mega.make_mega_consts(model, problem, rows)
    pose = problem.cam_states.pose.clone()
    pose[5, 0] += 1.5
    rho = problem.inv_depth.clone()
    rho[7] = -rho[7].abs()
    rho[11] = float("inf")
    cams = problem.cam_states._replace(pose=pose)
    return images.reshape(-1, H, W).contiguous(), cams, rho, consts


def _assert_matches(out, ref):
    nan = torch.isnan(ref[pba_mega.ROW_COST])
    assert torch.equal(torch.isnan(out[pba_mega.ROW_COST]), nan)
    for rows in (slice(0, 136), slice(136, 144), slice(144, 145),
                 slice(145, 162), slice(162, 179), slice(179, 184)):
        a, b = out[rows][:, ~nan].cpu(), ref[rows][:, ~nan].cpu()
        scale = max(float(b.abs().max()), 1e-6)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4 * scale)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("model", pba_mega.MODELS)
def test_fused_kernel_matches_plain_version(cuda, model, bf16):
    """The kernel against ``mega_fused_reference`` on the same inputs (the
    bf16 tier against the plain version on the widened stack), with
    off-image, behind-camera and non-finite observations and a zero
    column; each launch counted in its tier's counter."""
    images, cams, rho, consts = _mega_inputs(cuda, model)
    if bf16:
        images = images.to(torch.bfloat16)
    ref = pba_mega.mega_fused_reference(model, images.float(), cams, rho,
                                        consts, 9.0)
    nan = torch.isnan(ref[pba_mega.ROW_COST])
    assert 0 < int(nan.sum()) < nan.numel() // 2
    before = (pba_mega.KERNEL_LAUNCHES, pba_mega.KERNEL_LAUNCHES_BF16)
    out = pba_mega.mega_fused(model, images, cams, rho, consts, 9.0)
    torch.cuda.synchronize()
    after = (pba_mega.KERNEL_LAUNCHES, pba_mega.KERNEL_LAUNCHES_BF16)
    assert after == ((before[0], before[1] + 1) if bf16
                     else (before[0] + 1, before[1]))
    _assert_matches(out, ref)
    assert (out[:, consts.timg < 0] == 0).all()
    if bf16:
        # the tier is on: rounding the stack moves the payload
        out32 = pba_mega.mega_fused(model, images.float(), cams, rho, consts,
                                    9.0)
        assert not torch.equal(out, out32)


def test_fused_kernel_wide_image(cuda):
    """W=8448, wider than the TPU kernel's 14-bit column field, through
    the pinhole toy state, against the plain version."""
    images, cams, rho, consts, _ = synthetic.wide_image_state(device=cuda)
    ref = pba_mega.mega_fused_reference("pinhole", images, cams, rho, consts,
                                        0.0)
    out = pba_mega.mega_fused("pinhole", images, cams, rho, consts, 0.0)
    _assert_matches(out, ref)
    assert (out[:, consts.timg < 0] == 0).all()


def test_fused_kernel_squared_loss(cuda):
    images, cams, rho, consts = _mega_inputs(cuda, "ds", seed=3)
    _assert_matches(
        pba_mega.mega_fused("ds", images, cams, rho, consts, 0.0),
        pba_mega.mega_fused_reference("ds", images, cams, rho, consts, 0.0))


def test_fused_wrapper_rejects_bad_inputs(cuda):
    images, cams, rho, consts = _mega_inputs(cuda)
    with pytest.raises(ValueError, match="camera model"):
        pba_mega.mega_fused("fisheye", images, cams, rho, consts, 9.0)
    with pytest.raises(ValueError, match="float32"):
        pba_mega.mega_fused("pinhole", images, cams, rho.double(), consts,
                            9.0)
    with pytest.raises(ValueError, match="contiguous"):
        pba_mega.mega_fused("pinhole", images, cams, rho, consts._replace(
            d3=consts.d3.T.contiguous().T), 9.0)
    with pytest.raises(ValueError, match="must be"):
        pba_mega.mega_fused("pinhole", images, cams, rho, consts._replace(
            refp=consts.refp[:, :-1].contiguous()), 9.0)
    with pytest.raises(ValueError, match="is on cpu"):
        pba_mega.mega_fused("pinhole", images, cams, rho, consts._replace(
            cols=consts.cols.cpu()), 9.0)
    with pytest.raises(ValueError, match="int32"):
        pba_mega.mega_fused("pinhole", images, cams, rho, consts._replace(
            cols=consts.cols.long()), 9.0)
    with pytest.raises(ValueError, match="bfloat16"):
        pba_mega.mega_fused("pinhole", images.half(), cams, rho, consts, 9.0)


def _family_solvers(device):
    """The four solvers whose builds must repeat bit for bit, each with a
    build function of no argument, on ``euroc_scale_pba`` at toy size."""
    problem, images, H, W = synthetic.euroc_scale_pba(
        K=12, L=96, obs_per_lm=3, H=64, W=96, device=device)
    prob_d, plan_d = fused.densify_problem(problem)
    cfg = ba.BAConfig(huber_delta=9.0)
    chunk = pba_mega.make_mega_solver("pinhole", images, H, W, problem,
                                      device=device)
    dense = pba_mega.make_mega_solver("pinhole", images, H, W, prob_d, plan_d,
                                      device=device)
    kf = pba.make_kernel_fused_solver("pinhole", images, H, W, problem,
                                      device=device)
    kd = pba.make_kernel_dense_solver("pinhole", images, H, W, prob_d,
                                      device=device)
    plan = fused.plan_for_problem(problem)
    return {
        "mega_chunk": lambda: chunk.build(problem, cfg),
        "mega_dense": lambda: dense.build(prob_d, cfg),
        "mega_dense_bf16": lambda: dense.build(
            prob_d, cfg._replace(sample_bf16=True)),
        "kernel_fused": lambda: kf.build(problem, plan, cfg),
        "kernel_dense": lambda: kd.build(prob_d, plan_d, cfg),
    }


@pytest.mark.parametrize("solver", ["mega_chunk", "mega_dense",
                                    "mega_dense_bf16", "kernel_fused",
                                    "kernel_dense"])
def test_builds_repeat_bit_for_bit(cuda, solver):
    """Two builds of the same input on the card are bit-equal: every sum of
    the assembly runs in an order fixed on the host, no scatter-add."""
    build = _family_solvers(cuda)[solver]
    c1, neq1 = build()
    c2, neq2 = build()
    assert torch.equal(c1, c2)
    for a, b in zip(neq1, neq2):
        assert torch.equal(a, b)


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


def _sampler_inputs(device, H=64, W=96, Kimg=3, O=203, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape, lo=0.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(shape, generator=gen)).to(device)

    images = rand(Kimg, H, W, hi=255.0)
    ux = rand(ps.P, O, lo=-5.0, hi=W + 4.0)
    uy = rand(ps.P, O, lo=-5.0, hi=H + 4.0)
    ux[:, 11] = -1e6                         # a non-finite projection
    uy[:, 11] = -1e6
    img = torch.randint(0, Kimg, (O,), generator=gen, dtype=torch.int32)
    img[::17] = -1                           # zero columns
    return images, ux, uy, img.to(device), (H, W)


@pytest.mark.parametrize("want_grads", [True, False])
def test_patch_sample_kernel_matches_plain_version(cuda, want_grads):
    args = _sampler_inputs(cuda)
    before = ps.KERNEL_LAUNCHES
    out = ps.sample_patches(*args, want_grads)
    torch.cuda.synchronize()
    assert ps.KERNEL_LAUNCHES == before + 1
    ref = ps.sample_patches_reference(*args, want_grads)
    scale = float(args[0].abs().max())
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=1e-4 * scale)
    zero = args[3] < 0
    assert all(bool((a[:, zero] == 0).all()) for a in out)
    if not want_grads:
        assert not out[1].any() and not out[2].any()


def test_patch_sample_wrapper_rejects_bad_inputs(cuda):
    images, ux, uy, img, HW = _sampler_inputs(cuda)
    with pytest.raises(ValueError, match="float32"):
        ps.sample_patches(images, ux.double(), uy, img, HW)
    with pytest.raises(ValueError, match="contiguous"):
        ps.sample_patches(images, ux.T.contiguous().T, uy, img, HW)
    with pytest.raises(ValueError, match="must be"):
        ps.sample_patches(images, ux[:, :100], uy[:, :100], img, HW)
    with pytest.raises(ValueError, match="is on cpu"):
        ps.sample_patches(images, ux, uy, img.cpu(), HW)
    with pytest.raises(ValueError, match="int32"):
        ps.sample_patches(images, ux, uy, img.long(), HW)
    with pytest.raises(ValueError, match="images3d must be"):
        ps.sample_patches(images, ux, uy, img, (32, 96))


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
        plan = fused.plan_for_problem(problem)
    else:
        problem, plan = fused.densify_problem(problem)
    runs = []
    for dev in (cuda, "cpu"):
        if solver == "kernel_fused":
            solve = pba.make_kernel_fused_solver("pinhole", images, H, W,
                                                 problem, device=dev)
        else:
            solve = pba.make_kernel_dense_solver("pinhole", images, H, W,
                                                 problem, device=dev)
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


# (ng, iog, lane inputs, image stack (kimg, H, W) or None, code entries per
# step): irregular image indices, H*W not a multiple of the kernel's slice
GRID_PATTERNS = {
    "repeats-ng7": (7, [5, 0, 5, 2, 0, 6, 5], 7, (8, 130, 128), 3),
    "runs-ng160": (160, [g * 40 // 160 for g in range(160)], 7, (164, 8, 16),
                   256),
    "constant-ng160-no-lanes": (160, [3] * 160, 0, (164, 130, 128), 0),
    "distinct-ng160": (160, [(7 * g) % 164 for g in range(160)], 2,
                       (164, 130, 128), 0),
    "no-image-ng7": (7, [1, 1, 0, 4, 2, 2, 9], 2, None, 1),
    "nothing-ng7": (7, [0, 3, 3, 3, 1, 0, 2], 0, None, 0),
}


def _grid_pattern(device, name):
    ng, iog, n_lanes, shape, per_step = GRID_PATTERNS[name]
    rng = np.random.default_rng(11)

    def ints(*s, hi=4, dtype=np.float32):
        return torch.as_tensor(rng.integers(0, hi, s).astype(dtype),
                               device=device)

    args = dict(lanes=[ints(r, ng * go.GROUP)
                       for r in go.LANE_ROWS[:n_lanes]],
                iog=torch.tensor(iog, dtype=torch.int32, device=device),
                images=None if shape is None else ints(*shape))
    if per_step:
        args.update(cnt=ints(ng, hi=300, dtype=np.int32),
                    code=ints(ng * per_step, hi=5, dtype=np.int32))
    return args


@pytest.mark.parametrize("name", GRID_PATTERNS)
def test_grid_probe_irregular_patterns(cuda, name):
    args = _grid_pattern(cuda, name)
    before = go.KERNEL_LAUNCHES
    out, checksum = go.probe(**args)
    again = go.probe(**args)[1]
    torch.cuda.synchronize()
    assert go.KERNEL_LAUNCHES == before + 2
    _, ref = go.probe_reference(**args)
    assert go.check(out, checksum, ref, name) == 0
    assert torch.equal(checksum, again)


def test_grid_probe_index_outside_the_stack_is_nan(cuda):
    args = _grid_pattern(cuda, "repeats-ng7")
    args["iog"][3] = args["images"].shape[0]
    checksum = go.probe(**args)[1].cpu()
    assert torch.isnan(checksum[3]) and torch.isfinite(checksum[:3]).all()
    args["iog"][3] = 2
    _, ref = go.probe_reference(**args)
    assert torch.equal(checksum[4:], ref[4:].cpu())


def test_grid_probe_replays_in_a_cuda_graph(cuda):
    # the kernel's ticket resets itself: every replay sums anew
    args = _grid_pattern(cuda, "runs-ng160")
    go.probe(**args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, checksum = go.probe(**args)
    _, ref = go.probe_reference(**args)
    for _ in range(3):
        out.fill_(1.0)
        checksum.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert go.check(out, checksum, ref, "replay") == 0


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


def _geo_problem(device, dtype, heavy=False):
    """``synth_ba_problem`` at toy size; ``heavy`` cuts most landmarks to
    one observation (valid 0), the chunk branch of ``_accel_plan``."""
    problem, _, _ = synthetic.synth_ba_problem(
        "pinhole", K=12, L=96, obs_per_landmark=4, pixel_noise=0.5, seed=3,
        dtype=dtype, device=device)
    if heavy:
        valid = problem.obs.valid.clone()
        slot = torch.arange(valid.shape[0], device=device) // 96
        valid[(problem.obs.landmark >= 4) & (slot > 0)] = 0
        problem = problem._replace(obs=problem.obs._replace(valid=valid))
    return problem


def _geo_builds(device, dtype):
    """The geometric builds, each a function of no argument."""
    problem = _geo_problem(device, dtype)
    prob_d, plan_d = fused.densify_problem(problem, pow2_buckets=False)
    plan = fused.plan_for_problem(problem, pow2_buckets=False)
    chunk = geo_mega.make_geo_solver("pinhole", problem, device=device)
    dense = geo_mega.make_geo_solver("pinhole", prob_d, plan_d, device=device)
    fs = geometric_ba.make_fused_solver("pinhole")
    cfg = ba.BAConfig()
    return {
        "geo_chunk": lambda: chunk.build(problem, cfg),
        "geo_dense": lambda: dense.build(prob_d, cfg),
        "fused_chunk": lambda: fs.build(problem, plan, cfg),
        "fused_dense": lambda: fs.build(prob_d, plan_d, cfg),
    }


@pytest.mark.parametrize("build", ["geo_chunk", "geo_dense", "fused_chunk",
                                   "fused_dense"])
def test_geo_builds_repeat_bit_for_bit_and_match_cpu(cuda, build):
    """Two geometric builds on the card are bit-equal, and agree with the
    CPU's f64 build of the same problem at the port's f32 tolerances (cost
    rtol 2e-4, pieces atol 3e-3 x max|ref| with rtol 2e-3)."""
    run = _geo_builds(cuda, torch.float32)[build]
    c1, neq1 = run()
    c2, neq2 = run()
    assert torch.equal(c1, c2)
    assert all(torch.equal(a, b) for a, b in zip(neq1, neq2))
    c_ref, neq_ref = _geo_builds("cpu", torch.float64)[build]()
    np.testing.assert_allclose(float(c1), float(c_ref), rtol=2e-4)
    for a, b in zip(neq1, neq_ref):
        b = b.numpy()
        np.testing.assert_allclose(a.cpu().double().numpy(), b, rtol=2e-3,
                                   atol=3e-3 * np.abs(b).max())


def test_geo_forward_mode_rj_on_card(cuda):
    """The forward-mode Jacobian (``rj_fn=None``) on the card against the
    closed form there and against the CPU's f64 forward mode."""
    res_fn = geometric_ba.make_residual_fn("ds")
    out = {}
    for dev, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        p = _geo_problem(dev, dtype)
        o = p.obs
        args = (p.cam_states[o.anchor_cam], p.cam_states[o.target_cam],
                p.inv_depth[o.landmark], o.aux)
        out[dtype] = ba.forward_mode_rj(res_fn, geometric_ba.cam_retract,
                                        6)(*args)
        if dtype == torch.float32:
            closed = geometric_ba.make_rj_fn("ds")(*args)
    (r, J), (r64, J64) = out[torch.float32], out[torch.float64]
    scale = float(J64.abs().max())
    np.testing.assert_allclose(J.cpu().numpy(), closed[1].cpu().numpy(),
                               atol=1e-4 * scale)
    np.testing.assert_allclose(J.cpu().double().numpy(), J64.numpy(),
                               atol=1e-3 * scale)
    np.testing.assert_allclose(r.cpu().double().numpy(), r64.numpy(),
                               atol=1e-2)


@pytest.mark.parametrize("heavy", [False, True])
def test_geo_bundle_adjustment_on_card_matches_cpu(cuda, heavy):
    """``bundle_adjustment`` on both ``_accel_plan`` branches in f32 on the
    card against the CPU's f64 solve: the cost falls, final costs agree to
    rtol 1e-3."""
    runs = []
    for dev, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        p = _geo_problem(dev, dtype, heavy)
        _, plan = geometric_ba._accel_plan(p)
        assert isinstance(plan, fused.DenseLmSchurPlan) != heavy
        _, res = geometric_ba.bundle_adjustment(
            p, "pinhole", ba.BAConfig(max_iterations=10))
        assert float(res.cost) < float(res.initial_cost)
        runs.append(float(res.cost))
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-3)


def _two_view_batch(B=8, M=256, outliers=0.3, seed=0):
    """B two-view problems of M correspondences in f64 on the CPU, a share
    of each replaced by random directions and the last rows of some
    invalid: (f0, f1, valid, p0), p0 the points in camera 0's frame."""
    rng = np.random.default_rng(seed)
    T = se3.exp(torch.as_tensor(rng.normal(0, 0.2, (B, 6))))
    p1 = torch.as_tensor(rng.uniform(-2, 2, (B, M, 3)) + np.array([0, 0, 6.0]))
    p0 = se3.act(T[:, None], p1)
    f0 = p0 / torch.linalg.norm(p0, dim=-1, keepdim=True)
    f1 = p1 / torch.linalg.norm(p1, dim=-1, keepdim=True)
    n_out = int(M * outliers)
    bad = torch.as_tensor(rng.normal(size=(B, n_out, 3)))
    bad[..., 2] = bad[..., 2].abs() + 1
    f1[:, :n_out] = bad / torch.linalg.norm(bad, dim=-1, keepdim=True)
    valid = torch.ones(B, M, dtype=torch.bool)
    valid[::3, -20:] = False
    return f0, f1, valid, p0


@pytest.mark.parametrize("solver", ["nister", "eight_point"])
def test_relative_pose_on_card_matches_cpu(cuda, solver):
    f0, f1, valid, _ = _two_view_batch()
    idx = ransac._sample_indices(torch.Generator().manual_seed(0), 64,
                                 5 if solver == "nister" else 8, valid)
    runs = [[x.cpu() for x in ransac.ransac_relative_pose(
        f0.to(dev), f1.to(dev), valid.to(dev), num_hypotheses=64,
        solver=solver, idx=idx.to(dev))] for dev in (cuda, "cpu")]
    (Tg, inl_g, n_g), (Tc, inl_c, n_c) = runs
    assert float((inl_g != inl_c).double().mean()) <= 1e-3
    cos = torch.sum(se3.translation(Tg) * se3.translation(Tc), -1)
    assert float(torch.arccos(torch.clamp(cos, -1.0, 1.0)).max()) <= 1e-6
    np.testing.assert_allclose(Tg.numpy(), Tc.numpy(), atol=1e-6)
    assert (n_c > 100).all()


@pytest.mark.parametrize("solver", ["p3p", "dlt"])
def test_pnp_on_card_matches_cpu(cuda, solver):
    # camera 1 localised against the points in camera 0's frame
    _, f1, valid, p0 = _two_view_batch(seed=1)
    idx = ransac._sample_indices(torch.Generator().manual_seed(1), 128,
                                 3 if solver == "p3p" else 6, valid)
    runs = [[x.cpu() for x in ransac.ransac_pnp(
        f1.to(dev), p0.to(dev), valid.to(dev), num_hypotheses=128,
        solver=solver, idx=idx.to(dev))] for dev in (cuda, "cpu")]
    (Tg, inl_g), (Tc, inl_c) = runs
    assert float((inl_g != inl_c).double().mean()) <= 1e-3
    np.testing.assert_allclose(Tg.numpy(), Tc.numpy(), atol=1e-6)


def test_ransac_draws_on_the_card(cuda):
    """Samples drawn by a generator on the card give the same outcome as
    on the CPU: every problem's inliers found, and at most one of its 76
    random outliers kept (a random bearing lands on the epipolar geometry
    within the threshold about once in 600)."""
    f0, f1, valid, _ = _two_view_batch(seed=2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    _, inl, n = ransac.ransac_relative_pose(
        f0.to(cuda), f1.to(cuda), valid.to(cuda), gen, threshold=1e-7)
    inl = inl.cpu()
    assert int(inl[:, :76].sum(-1).max()) <= 1
    assert bool((n.cpu() >= valid[:, 76:].sum(-1)).all())


def test_match_all_on_card(cuda):
    """``match_all`` on the card: one Hamming launch for the whole
    worklist, the worklist and (where the descriptors agree bit for bit)
    every match list equal to the CPU's, and relative rotations near the
    ground truth."""
    seq = synthetic.synth_stereo_sequence(n_frames=4, H=240, W=376,
                                          device="cpu")
    pipes = {}
    for dev in (cuda, "cpu"):
        p = SfmPipeline(seq.images, seq.calib, log=lambda *a: None,
                        device=dev)
        p.detect_keypoints()
        p.match_stereo()
        before = hamming.KERNEL_LAUNCHES
        p.match_all()
        pipes[torch.device(dev).type] = (p, hamming.KERNEL_LAUNCHES - before)
    (g, launches), (c, _) = pipes["cuda"], pipes["cpu"]
    assert launches == 1
    assert g._pair_worklist() == c._pair_worklist()
    assert sorted(g.matches) == sorted(c.matches)
    same = all(np.array_equal(g.corners[k]["desc"], c.corners[k]["desc"])
               for k in c.fcids)
    errs = []
    for (a, b), md in g.matches.items():
        if same:
            np.testing.assert_array_equal(md["matches"],
                                          c.matches[(a, b)]["matches"])
        if a[0] == b[0] or not len(md["inliers"]):
            continue
        T_gt = se3.compose(se3.inverse(torch.as_tensor(seq.poses_gt[a])),
                           torch.as_tensor(seq.poses_gt[b]))
        T = torch.as_tensor(md["T_i_j"])
        errs.append(float(torch.linalg.norm(se3.so3_log(se3.quat_mul(
            se3.quat_conj(se3.rotation(T)), se3.rotation(T_gt))))))
    assert len(errs) >= 20 and max(errs) <= 6e-2 and np.median(errs) <= 2e-2


def _map_rows(seed=0, n=300):
    """Rows of the map stages' geometry on the indoor room: pixels of
    image (0, 0), their room points, and where the stereo partner (0, 1)
    sees them."""
    seq = synthetic.synth_stereo_sequence(
        n_frames=2, H=120, W=188, room_radius=synthetic.INDOOR_ROOM_RADIUS,
        device="cpu")
    rng = np.random.default_rng(seed)
    uv0 = rng.uniform([10, 10], [178, 110], (n, 2))
    keys = sorted(seq.poses_gt)
    src = np.zeros(n, np.int64)
    p_w = seq.world_points(src, uv0)
    uv1, _ = seq.correspondences(src, np.full(n, keys.index((0, 1))), uv0)
    intr = np.asarray(seq.calib.intrinsics)
    T0 = np.tile(seq.poses_gt[(0, 0)], (n, 1))
    T1 = np.tile(seq.poses_gt[(0, 1)], (n, 1))
    rho = 1.0 / np.linalg.norm(p_w.numpy() - T0[:, :3], axis=1)
    return seq, uv0, uv1, intr[[0] * n], intr[[1] * n], T0, T1, rho


def test_map_geometry_on_card_matches_cpu(cuda):
    """The map stages' batched helpers (``lm_positions``, ``project_obs``,
    ``triangulate_rows``) on the card against the CPU, f64: within 1e-9,
    the parallax gate's decisions equal."""
    from photometric_bundle_adjustment_tpu_torch.pipeline import (
        sfm_pipeline as sfm,
    )

    seq, uv0, uv1, intr, intr1, T0, T1, rho = _map_rows()
    out = []
    for dev in (cuda, torch.device("cpu")):
        def t(x):
            return torch.as_tensor(x, dtype=torch.float64, device=dev)

        p_w = sfm.lm_positions("ds", t(uv0), t(intr), t(T0), t(rho))
        proj = sfm.project_obs("ds", t(uv0), t(intr), t(T0), t(rho), t(uv1),
                               t(intr1), t(T1))
        inv, ok = sfm.triangulate_rows("ds", t(uv0), t(uv1), t(intr),
                                       t(intr1), t(T0), t(T1),
                                       float(np.cos(np.deg2rad(1.0))))
        out.append([x.cpu() for x in (p_w, proj, inv, ok)])
    (pg, jg, ig, og), (pc, jc, ic, oc) = out
    np.testing.assert_allclose(pg.numpy(), pc.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(jg.numpy(), jc.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(ig.numpy(), ic.numpy(), rtol=1e-9)
    assert torch.equal(og, oc) and bool(oc.any())
    # the room points are the truth: projection errors near zero
    assert float(jc[:, 2].max()) < 1e-3


def test_localize_batch_on_card_matches_cpu(cuda):
    """A wave of 3 cameras on the same injected samples: poses within
    1e-6 and inlier masks differing in at most 0.1% of their entries."""
    from photometric_bundle_adjustment_tpu_torch.pipeline import (
        sfm_pipeline as sfm,
    )

    seq, uv0, uv1, intr, intr1, T0, T1, rho = _map_rows(seed=1)
    n = len(uv0)
    B, M = 3, n
    # every wave member localises camera (0, 1) against the anchors in
    # (0, 0); member b sees the first n - 40 b rows, the rest padding
    valid = np.zeros((B, M), bool)
    for b in range(B):
        valid[b, :n - 40 * b] = True
    idx = ransac._sample_indices(torch.Generator().manual_seed(0), 128, 3,
                                 torch.as_tensor(valid))
    out = []
    for dev in (cuda, torch.device("cpu")):
        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x),
                                   dtype=torch.float64, device=dev)

        T, inl = sfm.localize_batch(
            "ds", t(np.broadcast_to(uv1, (B, M, 2))), t(intr1[:B]),
            t(np.broadcast_to(uv0, (B, M, 2))),
            t(np.broadcast_to(intr, (B, M, 8))),
            t(np.broadcast_to(T0, (B, M, 7))), t(np.broadcast_to(rho, (B, M))),
            torch.as_tensor(valid, device=dev), None, 3.0, 128,
            idx=idx.to(dev))
        out.append((T.cpu(), inl.cpu()))
    (Tg, ig), (Tc, ic) = out
    assert float((ig != ic).double().mean()) <= 1e-3
    np.testing.assert_allclose(Tg.numpy(), Tc.numpy(), rtol=0, atol=1e-6)
    for b in range(B):
        np.testing.assert_allclose(Tc[b].numpy(), seq.poses_gt[(0, 1)],
                                   atol=1e-3)


def test_sfm_run_on_card(cuda):
    """``SfmPipeline.run`` on the card from images to DONE (4 frames of
    the indoor room at 480x752): every image registered, the Hamming
    kernel launched twice (match_stereo, match_all), the map within 5 mm
    of the rendered trajectory, as on the CPU (other RANSAC samples, so
    the two maps are held to the truth, not to each other)."""
    from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
        Stage,
    )
    from photometric_bundle_adjustment_tpu_torch.scripts import sfm_run

    seq = synthetic.synth_stereo_sequence(
        n_frames=4, room_radius=synthetic.INDOOR_ROOM_RADIUS, device="cpu")
    for dev in (cuda, "cpu"):
        p = SfmPipeline(seq.images, seq.calib, log=lambda *a: None,
                        device=dev)
        before = hamming.KERNEL_LAUNCHES
        p.run()
        assert p.stage == Stage.DONE
        m = sfm_run.measure(p, seq)
        assert m["cameras"] == 8 and m["ate_m"] < 5e-3 and m["rms_px"] < 1.0
        if dev == cuda:
            assert hamming.KERNEL_LAUNCHES - before == 2


def _sfm_pipe_to_tracks(n_frames=4):
    """A CPU pipeline of the indoor room's first frames, run until its
    tracks exist, and the sequence."""
    seq = synthetic.synth_stereo_sequence(
        n_frames=n_frames, room_radius=synthetic.INDOOR_ROOM_RADIUS,
        device="cpu")
    p = SfmPipeline(seq.images, seq.calib, log=lambda *a: None, device="cpu")
    while not p.tracks and p.next_step():
        pass
    return p, seq


def test_refine_sfm_map_on_card_matches_cpu(cuda):
    """``apps/pba.refine_map`` of an SfM map the port built (4 frames of
    the indoor room, 3 levels of 3 iterations) on the card and on the CPU
    from the same map: every level's initial cost within rtol 2e-4, the
    final cost within rtol 5e-3, poses within 1e-4, the megakernel
    launched on the card only, the cost falling at every level."""
    from photometric_bundle_adjustment_tpu_torch.apps import pba as pba_app

    p, _ = _sfm_pipe_to_tracks()
    p.run()
    out = {}
    for dev in (cuda, "cpu"):
        q = copy.deepcopy(p)
        before = pba_mega.KERNEL_LAUNCHES
        lv = pba_app.refine_map(q, iterations=3, log=lambda *a: None,
                                device=dev)
        out[str(dev)] = (q, lv, pba_mega.KERNEL_LAUNCHES - before)
    (qg, lg, ng), (qc, lc, nc) = out[str(cuda)], out["cpu"]
    assert ng > 0 and nc == 0
    np.testing.assert_allclose([v["initial_cost"] for v in lg],
                               [v["initial_cost"] for v in lc], rtol=2e-4)
    np.testing.assert_allclose(lg[-1]["cost"], lc[-1]["cost"], rtol=5e-3)
    for v in lg:
        assert v["cost"] < v["initial_cost"]
    keys = sorted(p.cameras)
    np.testing.assert_allclose(np.stack([qg.cameras[k] for k in keys]),
                               np.stack([qc.cameras[k] for k in keys]),
                               atol=1e-4)


@pytest.mark.parametrize("model", ["ds", "kb4"])
def test_calibrate_on_card_matches_cpu(cuda, model):
    """``models/calibration.calibrate`` in f64 on the card and on the CPU
    on 8 synthetic AprilGrid frames: parameters within 1e-9 relative."""
    import os

    from photometric_bundle_adjustment_tpu_torch.core import cameras
    from photometric_bundle_adjustment_tpu_torch.io import calib_io
    from photometric_bundle_adjustment_tpu_torch.models import calibration

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = {"ds": "refbaseline/artifacts/ref_opt_calib.json",
            "kb4": "tests/data/opt_calib_kb4.json"}[model]
    c = calib_io.load_calibration(os.path.join(root, path))
    g = synthetic.synth_aprilgrid(c.intrinsics, c.T_i_c, model, n_frames=8)
    frames = sorted({f for f, _ in g.corners})
    intr0 = np.array(g.intrinsics)
    intr0[:, :4] += np.random.default_rng(1).normal(0, 3, (2, 4))
    intr0 = np.stack([cameras.initialize(model, torch.as_tensor(k)).numpy()
                      for k in intr0])
    res = []
    for dev in (cuda, "cpu"):
        data = calibration.build_data(g.corners, frames,
                                      calibration.aprilgrid_corners_3d(),
                                      device=dev)
        init = calibration.CalibParams(*(
            torch.as_tensor(x, dtype=torch.float64, device=dev) for x in (
                np.stack([g.init_poses[(f, 0)] for f in frames]), g.T_i_c,
                intr0)))
        params, r = calibration.calibrate(model, data, init)
        res.append(([x.cpu().numpy() for x in params], float(r.cost)))
    (pg, cg), (pc, cc) = res
    for a, b in zip(pg, pc):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9 * np.abs(b).max())
    np.testing.assert_allclose(cg, cc, rtol=1e-9)


def test_global_initialize_on_card_matches_cpu(cuda):
    """``pipeline/global_init.global_initialize`` on the card and on the
    CPU from one pipeline's match table and tracks (4 frames of the indoor
    room): cameras within 1e-6, the same landmark ids, inverse depths
    within 1e-6."""
    from photometric_bundle_adjustment_tpu_torch.pipeline import global_init

    p, seq = _sfm_pipe_to_tracks()
    out = []
    for dev in (cuda, "cpu"):
        q = SfmPipeline(seq.images, seq.calib, log=lambda *a: None,
                        device=dev)
        q.corners, q.matches = p.corners, p.matches
        q.tracks = copy.deepcopy(p.tracks)
        assert len(global_init.global_initialize(
            q, log=lambda *a: None)) == 8
        out.append(interop.map_state_to_numpy(q))
    got, want = out
    assert list(got["cameras"]) == list(want["cameras"])
    for f, T in want["cameras"].items():
        np.testing.assert_allclose(got["cameras"][f], T, rtol=0, atol=1e-6)
    assert list(got["landmarks"]) == list(want["landmarks"])
    np.testing.assert_allclose(
        [d["inv_depth"] for d in got["landmarks"].values()],
        [d["inv_depth"] for d in want["landmarks"].values()],
        rtol=0, atol=1e-6)


def _dist_case():
    """The geometric synth_ba_problem(K=12, L=96) in f32, its port
    single-device fused solve on the card, and the config."""
    problem, _, _ = synthetic.synth_ba_problem(
        "pinhole", K=12, L=96, obs_per_landmark=4, pixel_noise=0.5,
        dtype=torch.float32, device="cpu")
    cfg = ba.BAConfig(max_iterations=8, huber_delta=1.0)
    p = ba.problem_to(problem, "cuda")
    ps, rs = geometric_ba.make_fused_solver("pinhole")(
        p, fused.plan_for_problem(p), cfg)
    return problem, cfg, ps.cam_states.cpu().numpy(), rs


def _hold_to_single(out, cams, rs, cam_tol=1e-4):
    init = float(rs.initial_cost)
    assert abs(out["initial_cost"] - init) < 1e-6 * init + 1e-9
    assert abs(out["cost"] - float(rs.cost)) <= 1e-4 * float(rs.cost) + 1e-9
    assert np.abs(out["cam_states"] - cams).max() < cam_tol
    assert out["ranks_bit_equal"]


def test_dist_fused_two_ranks_share_the_card(cuda):
    problem, cfg, cams, rs = _dist_case()
    sh = dist_fused.prepare(problem, 2)
    fam = dist_fused.Family("geometric", "pinhole")
    st, rep, pcg = mesh.spawn(
        mesh.run_calls, 2,
        [(mesh.selftest, (), {}), (dist_fused.solve_rank, (sh, fam, cfg), {}),
         (dist_fused.solve_rank, (sh, fam, cfg),
          dict(camera_partition=True, n_cg=600))],
        device=cuda, wall_limit=600.0)
    assert st["backend"] == "gloo" and st["device"] == "cuda:0"
    assert len(st["checks"]) == 9
    _hold_to_single(rep, cams, rs)
    assert abs(pcg["cost"] - rep["cost"]) <= 1e-4 * rep["cost"] + 1e-9
    assert np.abs(pcg["cam_states"] - rep["cam_states"]).max() < 1e-3
    assert pcg["ranks_bit_equal"] and pcg["cg_iterations"] > 0


def test_dist_fused_one_rank_nccl(cuda):
    problem, cfg, cams, rs = _dist_case()
    st, out = mesh.spawn(
        mesh.run_calls, 1,
        [(mesh.selftest, (), {}),
         (dist_fused.solve_rank, (dist_fused.prepare(problem, 1),
                                  dist_fused.Family("geometric", "pinhole"),
                                  cfg), {})],
        device=cuda, wall_limit=600.0)
    assert st["backend"] == "nccl" and len(st["checks"]) == 8
    _hold_to_single(out, cams, rs)


def test_ring_two_ranks_share_the_card(cuda):
    rng = np.random.default_rng(3)
    base = rng.integers(0, 2**32, (96, 8), dtype=np.uint32)
    desc = np.stack([base ^ rng.integers(0, 2, (96, 8)).astype(np.uint32)
                     for _ in range(6)])
    d = interop.descriptors_from_numpy(desc, "cpu")
    v = torch.ones((6, 96), dtype=torch.bool)
    out = mesh.spawn(pair_matching.ring_rank, 2, d, v, 48, 70, 1.2,
                     device=cuda, wall_limit=600.0)
    a, b = np.meshgrid(np.arange(6), np.arange(6), indexing="ij")
    table = pair_matching.match_pairs(d.to(cuda), v.to(cuda), a.ravel(),
                                      b.ravel())
    p, pv, c = (x.cpu().numpy() for x in match.matches_to_pairs(table, 48))
    np.testing.assert_array_equal(out["pairs"].reshape(36, 48, 2), p)
    np.testing.assert_array_equal(out["pvalid"].reshape(36, 48), pv)
    np.testing.assert_array_equal(out["count"].reshape(36), c)
    assert out["launches"] == [2, 2]


def test_bench_main_on_card_at_toy_sizes(cuda, capsys):
    import json
    import math

    from photometric_bundle_adjustment_tpu_torch import bench

    def not_strict(name):
        raise ValueError(name)

    toy = {"match": dict(I=8, F=128, C=2, MM=128, hyps=8),
           "pba": dict(K=12, L=48, obs_per_lm=3, H=64, W=96),
           "step": dict(K=6, L=64), "final": dict(K=6, L=64),
           "detect": dict(H=64, W=96, B=2, F=128),
           "geometry": dict(M_loc=128, M_rows=256, hyps=8)}
    assert bench.main(cuda, cpu_baselines=False, sizes=toy) == 0
    lines = [json.loads(x, parse_constant=not_strict)
             for x in capsys.readouterr().out.splitlines()]
    assert [x["metric"] for x in lines] == [
        "match_pairs_per_s_cuda", "pba_lm_iters_per_s_cuda",
        "pba_lm_iters_per_s_cuda_bf16", "keyframes_per_s_cuda",
        "ba_lm_iters_per_s_cuda"]
    for x in lines:
        assert "error" not in x and math.isfinite(x["value"]), x
        assert x["device"] == torch.cuda.get_device_name(cuda)
        assert x["peak_device_mib"] > 0, x
    for x in lines[:3]:
        k = x["kernel"]
        assert k["launches"] == k["calls"] > 0 and k["bound_ms"] > 0, k
    assert lines[-1]["graph_iters_per_s"] > 0
    assert lines[-1]["roofline"]["bound"] in ("bytes", "operations")
