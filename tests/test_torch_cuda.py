"""The port's CUDA megakernel on the card: built from csrc/, held against
its plain PyTorch version, and its wrapper's guards.  Marked ``cuda``; each
test skips where no CUDA device is present.  The kernel contracts a*b + c
into FMAs and the plain version does not, so rows agree to about one ulp
per operation: atol 1e-4 * max|ref| per row block.

Run on a GPU host (the repository's conftest imports JAX, which GPU hosts
need not have, hence ``--noconftest``):

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

import copy

import numpy as np
import pytest
import torch

from photometric_bundle_adjustment_tpu_torch.models import synthetic
from photometric_bundle_adjustment_tpu_torch.ops import pba_mega
from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine

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
