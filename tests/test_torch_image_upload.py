"""The refinement's image stack (``pipeline/pba_refine``,
``pba.problem.images``): the images cross to the device in their own
dtype and are widened there; ``build_photometric_problem`` returns, bit
for bit, the float32 stack built on the host image by image, and the
counters ``IMAGE_UPLOADS`` and ``IMAGE_UPLOAD_BYTES`` count the copies
from the host to another device and their bytes (none on the CPU).

The ``cuda`` test runs the pinned copy on the card against the CPU:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_image_upload.py
"""

import copy

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from benchmark import scenes
from photometric_bundle_adjustment_tpu_torch.models import photometric_ba as pba
from photometric_bundle_adjustment_tpu_torch.models import synthetic
from photometric_bundle_adjustment_tpu_torch.pipeline import pba_refine

torch.set_num_threads(1)

PIPES = {
    "synth": lambda: synthetic.synth_pba_pipe(K=8, L=48, H=48, W=64,
                                              obs_per_lm=3),
    "room": lambda: scenes.room_pipe(K=12, L=120, H=96, W=128, obs_per_lm=5,
                                     long_tracks=8, max_track=10, seed=3),
}


@pytest.fixture(scope="module", params=sorted(PIPES))
def pipe(request):
    p = PIPES[request.param]()
    assert all(im.dtype == np.uint8 for im in p.images.values())
    return p


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _recast(pipe, dtype):
    """A copy of ``pipe`` whose images are ``dtype``: the same values, or
    for float64 values that float32 rounds."""
    out = copy.deepcopy(pipe)
    for f, im in out.images.items():
        out.images[f] = (im.astype(dtype) / 3.0 if dtype == np.float64
                         else im.astype(dtype))
    return out


def _host_stack(pipe) -> torch.Tensor:
    """The float32 stack as the host built it image by image."""
    cams = sorted(pipe.cameras)
    H, W = pipe.images[cams[0]].shape
    stack = np.zeros((len(cams), H, W), np.float32)
    for i, f in enumerate(cams):
        stack[i] = pipe.images[f].astype(np.float32)
    return torch.from_numpy(stack.reshape(-1))


def _build(pipe, device="cpu"):
    """``build_photometric_problem`` and the counters' growth."""
    uploads = pba_refine.IMAGE_UPLOADS
    nbytes = pba_refine.IMAGE_UPLOAD_BYTES
    out = pba_refine.build_photometric_problem(pipe, device=device)
    return (out, pba_refine.IMAGE_UPLOADS - uploads,
            pba_refine.IMAGE_UPLOAD_BYTES - nbytes)


def _host_ref_patch(problem, stack, H, W) -> torch.Tensor:
    """Each observation's reference patch sampled from ``stack``."""
    return pba.extract_ref_patches(stack, problem.obs.anchor_cam,
                                   problem.obs.aux.uv_ref, H, W)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64],
                         ids=["uint8", "float32", "float64"])
def test_stack_is_the_host_stack(pipe, dtype):
    p = pipe if dtype == np.uint8 else _recast(pipe, dtype)
    (problem, images_flat, H, W, cams, _), uploads, nbytes = _build(p)
    want = _host_stack(p)
    assert images_flat.dtype == torch.float32
    assert images_flat.shape == (len(cams) * H * W,)
    assert torch.equal(images_flat, want)
    assert torch.equal(problem.obs.aux.ref_patch,
                       _host_ref_patch(problem, want, H, W))
    assert uploads == nbytes == 0


def test_uint8_and_float32_pipes_build_one_problem(pipe):
    (a, fa, *_), _, _ = _build(pipe)
    (b, fb, *_), _, _ = _build(_recast(pipe, np.float32))
    assert torch.equal(fa, fb)
    leaves_a, leaves_b = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(leaves_a) == len(leaves_b) > 0
    for x, y in zip(leaves_a, leaves_b):
        assert torch.equal(x, y)


def test_refine_uint8_equals_float32(pipe):
    """The whole refinement from the two pipes: bit-equal answers."""
    out = []
    for p in (copy.deepcopy(pipe), _recast(pipe, np.float32)):
        pba_refine.refine_photometric(p, max_iterations=3, levels=3,
                                      device="cpu", log=lambda *a: None)
        out.append(p)
    a, b = out
    for f in a.cameras:
        assert np.array_equal(a.cameras[f], b.cameras[f])
        assert np.array_equal(a.photometric_affine[f],
                              b.photometric_affine[f])
    assert all(a.landmarks[t].inv_depth == b.landmarks[t].inv_depth
               for t in a.landmarks)
    assert [lv["cost"] for lv in a.photometric_levels] == [
        lv["cost"] for lv in b.photometric_levels]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.float64],
                         ids=["uint8", "float32", "float64"])
def test_card_stack_is_the_host_stack(pipe, cuda, dtype):
    """The pinned copy and the card's cast against the host's float32
    stack, twice (the second call reuses the pinned block)."""
    p = pipe if dtype == np.uint8 else _recast(pipe, dtype)
    want = _host_stack(p)
    for _ in range(2):
        (problem, images_flat, H, W, cams, _), uploads, nbytes = _build(
            p, cuda)
        assert images_flat.device.type == "cuda"
        assert images_flat.dtype == torch.float32
        assert torch.equal(images_flat.cpu(), want)
        assert uploads == 1
        assert nbytes == np.dtype(dtype).itemsize * len(cams) * H * W
