"""Photometric patch sampling on observation columns.

Port of the Pallas TPU kernel ``photometric_bundle_adjustment_tpu/ops/
patch_sample.py`` (``_make_kernel``, launched by ``sample_patches_grouped``).
For each observation column and each of its 8 patch points the sampler
returns the bilinear value and the image gradient (d/dx, d/dy) of the
column's own image, ``img[o]``; a column whose image index is negative
comes out as exact zeros.

Semantics are those of the gather sampler
(``models/photometric_ba.bilinear_sample_and_grad``) and of the
megakernel: exact 4-tap bilinear with the clamp [0, W-1.001] x
[0, H-1.001], zero gradient where a coordinate was clamped.  Differences
from the TPU kernel, on purpose:

- no image groups: the TPU kernel needs observations sorted by target
  image, each image's range padded to 128-row groups (its
  ``group_layout``); here every column names its image, so the columns are
  the problem's own rows;
- no window clamp: the TPU kernel samples from a 24x256 window quantised
  to its (8, 128) tiles and clamps points beyond it (past about 3x patch
  stretch); here every point reads the image directly;
- the image stack is taken unpadded, (Kimg, H, W): the TPU kernel's lane
  padding (``pad_images``) and its segmentation of the call to fit SMEM
  exist for the TPU's alignment rules and are not ported.

Two forms:

- ``sample_patches`` launches the CUDA kernel of ``csrc/patch_sample.cu``
  on CUDA tensors (or raises); on CPU tensors it runs the plain version.
  It never falls back from the card.
- ``sample_patches_reference``, the plain PyTorch version.

Callers replace non-finite coordinates by -1e6 before sampling (the corner
value, zero gradient) and poison the value with NaN afterwards.
"""

from __future__ import annotations

import ctypes

import torch

from photometric_bundle_adjustment_tpu_torch.models import photometric_ba as pba
from photometric_bundle_adjustment_tpu_torch.ops import _build

P = 8        # DSO patch size

# Launches of the CUDA kernel by ``sample_patches`` in this process.
KERNEL_LAUNCHES = 0


def sample_patches_reference(images3d, ux, uy, img, HW,
                             want_grads: bool = True):
    """Plain PyTorch version: ``(val, gx, gy)``, each (P, O).

    ``images3d`` (Kimg, H, W); ``ux``/``uy`` (P, O) pixel coordinates;
    ``img`` (O,) the image of each column, negative for a zero column;
    ``HW`` the image size.  ``want_grads=False`` gives zero gradients."""
    H, W = HW
    ok = img >= 0
    val, gx, gy = pba.bilinear_sample_and_grad(
        images3d.reshape(-1), torch.where(ok, img, 0).long()[None, :],
        torch.stack([ux, uy], dim=-1), H, W)
    zero = torch.zeros_like(val)
    val = torch.where(ok, val, zero)
    if not want_grads:
        return val, zero, zero.clone()
    return val, torch.where(ok, gx, zero), torch.where(ok, gy, zero)


def _lib():
    lib = _build.load("patch_sample")
    if lib.patch_sample.argtypes is None:
        lib.patch_sample.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,      # images, H, W
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ux, uy, img
            ctypes.c_int, ctypes.c_int,                       # O, grads
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # val, gx, gy
            ctypes.c_void_p,                                  # stream
        ]
        lib.patch_sample.restype = ctypes.c_int
        lib.patch_sample_error_string.restype = ctypes.c_char_p
        lib.patch_sample_error_string.argtypes = [ctypes.c_int]
    return lib


def _check_kernel_inputs(images3d, ux, uy, img, HW):
    dev = images3d.device
    if images3d.dim() != 3 or tuple(images3d.shape[1:]) != tuple(HW):
        raise ValueError(f"images3d must be (Kimg, {HW[0]}, {HW[1]}), got "
                         f"{tuple(images3d.shape)}")
    if ux.dim() != 2 or ux.shape[1] == 0:
        raise ValueError(f"ux must be ({P}, O) with O > 0, got "
                         f"{tuple(ux.shape)}")
    O = ux.shape[1]
    f32 = torch.float32
    expect = {
        "images3d": (images3d, tuple(images3d.shape), f32),
        "ux": (ux, (P, O), f32), "uy": (uy, (P, O), f32),
        "img": (img, (O,), torch.int32),
    }
    for name, (t, shape, dtype) in expect.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, images on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def sample_patches(images3d, ux, uy, img, HW, want_grads: bool = True):
    """``(val, gx, gy)``, each (P, O); arguments as
    ``sample_patches_reference``.

    On CUDA tensors it launches the kernel of ``csrc/patch_sample.cu`` on
    the current stream (or raises; ``img`` int32, every index below the
    stack's image count); on CPU tensors it runs the plain version."""
    global KERNEL_LAUNCHES
    if images3d.device.type == "cpu":
        return sample_patches_reference(images3d, ux, uy, img, HW,
                                        want_grads)
    if images3d.device.type != "cuda":
        raise ValueError(
            f"sample_patches: unsupported device {images3d.device}")
    _check_kernel_inputs(images3d, ux, uy, img, HW)
    H, W = HW
    O = ux.shape[1]
    lib = _lib()
    val, gx, gy = (torch.empty((P, O), dtype=torch.float32,
                               device=images3d.device) for _ in range(3))
    stream = torch.cuda.current_stream(images3d.device).cuda_stream
    err = lib.patch_sample(images3d.data_ptr(), H, W, ux.data_ptr(),
                           uy.data_ptr(), img.data_ptr(), O, int(want_grads),
                           val.data_ptr(), gx.data_ptr(), gy.data_ptr(),
                           stream)
    if err != 0:
        msg = lib.patch_sample_error_string(err).decode()
        raise RuntimeError(f"patch_sample launch failed: {msg} ({err})")
    KERNEL_LAUNCHES += 1
    return val, gx, gy
