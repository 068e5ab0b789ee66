"""Photometric patch sampling over observations grouped by target image.

Port of the Pallas TPU kernel ``photometric_bundle_adjustment_tpu/ops/
patch_sample.py`` (``_make_kernel``, launched by ``sample_patches_grouped``).
Observations are sorted by target image and each image's range is padded
to a multiple of ``GROUP`` rows (``group_layout``, on the host, once per
solve); every group of 128 rows samples one image.  For each observation
column and each of its 8 patch points the sampler returns the bilinear
value and the image gradient (d/dx, d/dy).

Semantics are those of the gather sampler
(``models/photometric_ba.bilinear_sample_and_grad``) and of the
megakernel: exact 4-tap bilinear with the clamp [0, W-1.001] x
[0, H-1.001], zero gradient where a coordinate was clamped.  Differences
from the TPU kernel, on purpose:

- no window clamp: the TPU kernel samples from a 24x256 window quantised
  to its (8, 128) tiles and clamps points beyond it (past about 3x patch
  stretch); here every point reads the image directly;
- padding slots (lane >= the group's count) come out as exact zeros,
  where the TPU kernel leaves garbage;
- the image stack is taken unpadded, (Kimg, H, W): the TPU kernel's lane
  padding (``pad_images``) and its segmentation of the call to fit SMEM
  exist for the TPU's alignment rules and are not ported.

Two forms:

- ``sample_patches_grouped`` launches the CUDA kernel of
  ``csrc/patch_sample.cu`` on CUDA tensors (or raises); on CPU tensors it
  runs the plain version.  It never falls back from the card.
- ``sample_patches_reference``, the plain PyTorch version.

Callers replace non-finite coordinates by -1e6 before sampling (the corner
value, zero gradient) and poison the value with NaN afterwards.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch.models import photometric_ba as pba
from photometric_bundle_adjustment_tpu_torch.ops import _build

P = 8        # DSO patch size
GROUP = 128  # observation rows per group (one CUDA block)

# Launches of the CUDA kernel by ``sample_patches_grouped`` in this process.
KERNEL_LAUNCHES = 0


def group_layout(target_img: np.ndarray, n_images: int):
    """Host-side layout: sort observations by target image and pad each
    image's range to a multiple of GROUP.  Returns ``(order, img_of_group,
    group_counts)``: ``order`` (Opad,) maps group rows to observation rows
    (-1 for padding slots); reorder every per-observation array with
    ``np.where(order >= 0, arr[order], fill)``.  Images without
    observations get no group."""
    target_img = np.asarray(target_img)
    counts = np.bincount(target_img, minlength=n_images)
    padded = -(-counts // GROUP) * GROUP
    offs = np.r_[0, np.cumsum(padded)]
    order = np.full(offs[-1], -1, np.int64)
    sort_idx = np.argsort(target_img, kind="stable")
    starts = np.r_[0, np.cumsum(counts)]
    for i in np.flatnonzero(counts):
        order[offs[i]: offs[i] + counts[i]] = sort_idx[starts[i]: starts[i + 1]]
    img_of_group = np.repeat(np.arange(n_images), padded // GROUP)
    # valid slots per group: full groups, then the image's remainder
    slot_base = np.arange(offs[-1]) - np.repeat(offs[:-1], padded)
    grp_start = slot_base[::GROUP]
    cnt_img = np.repeat(counts, padded // GROUP)
    group_counts = np.clip(cnt_img - grp_start, 0, GROUP)
    return order, img_of_group.astype(np.int32), group_counts.astype(np.int32)


def sample_patches_reference(images3d, ux, uy, img_of_group, group_counts,
                             HW, want_grads: bool = True):
    """Plain PyTorch version: ``(val, gx, gy)``, each (P, Opad).

    ``images3d`` (Kimg, H, W); ``ux``/``uy`` (P, Opad) pixel coordinates in
    group layout; ``img_of_group``/``group_counts`` (Opad / GROUP,) the
    image and valid-row count of each group; ``HW`` the image size.
    Padding slots are exact zeros; ``want_grads=False`` gives zero
    gradients."""
    H, W = HW
    Opad = ux.shape[1]
    rows = torch.arange(Opad, device=ux.device)
    grp = rows // GROUP
    slot_ok = (rows % GROUP) < group_counts.long()[grp]
    img = img_of_group.long()[grp]
    val, gx, gy = pba.bilinear_sample_and_grad(
        images3d.reshape(-1), img[None, :], torch.stack([ux, uy], dim=-1),
        H, W)
    zero = torch.zeros_like(val)
    val = torch.where(slot_ok, val, zero)
    if not want_grads:
        return val, zero, zero.clone()
    return val, torch.where(slot_ok, gx, zero), torch.where(slot_ok, gy, zero)


def _kernel_fn():
    fn = _build.load("patch_sample").patch_sample
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,      # images, H, W
            ctypes.c_void_p, ctypes.c_void_p,                 # ux, uy
            ctypes.c_void_p, ctypes.c_void_p,                 # iog, cnt
            ctypes.c_int, ctypes.c_int,                       # Opad, grads
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # val, gx, gy
            ctypes.c_void_p,                                  # stream
        ]
        fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(images3d, ux, uy, img_of_group, group_counts, HW):
    dev = images3d.device
    if images3d.dim() != 3 or tuple(images3d.shape[1:]) != tuple(HW):
        raise ValueError(f"images3d must be (Kimg, {HW[0]}, {HW[1]}), got "
                         f"{tuple(images3d.shape)}")
    if ux.dim() != 2:
        raise ValueError(f"ux must be ({P}, Opad), got {tuple(ux.shape)}")
    Opad = ux.shape[1]
    if Opad == 0 or Opad % GROUP:
        raise ValueError(f"Opad={Opad} must be a positive multiple of {GROUP}")
    ng = Opad // GROUP
    f32, i32 = torch.float32, torch.int32
    expect = {
        "images3d": (images3d, tuple(images3d.shape), f32),
        "ux": (ux, (P, Opad), f32), "uy": (uy, (P, Opad), f32),
        "img_of_group": (img_of_group, (ng,), i32),
        "group_counts": (group_counts, (ng,), i32),
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


def sample_patches_grouped(images3d, ux, uy, img_of_group, group_counts, HW,
                           want_grads: bool = True):
    """``(val, gx, gy)``, each (P, Opad); arguments as
    ``sample_patches_reference``.

    On CUDA tensors it launches the kernel of ``csrc/patch_sample.cu`` on
    the current stream (or raises); on CPU tensors it runs the plain
    version."""
    global KERNEL_LAUNCHES
    if images3d.device.type == "cpu":
        return sample_patches_reference(images3d, ux, uy, img_of_group,
                                        group_counts, HW, want_grads)
    if images3d.device.type != "cuda":
        raise ValueError(
            f"sample_patches_grouped: unsupported device {images3d.device}")
    _check_kernel_inputs(images3d, ux, uy, img_of_group, group_counts, HW)
    H, W = HW
    Opad = ux.shape[1]
    fn = _kernel_fn()
    val, gx, gy = (torch.empty((P, Opad), dtype=torch.float32,
                               device=images3d.device) for _ in range(3))
    stream = torch.cuda.current_stream(images3d.device).cuda_stream
    err = fn(images3d.data_ptr(), H, W, ux.data_ptr(), uy.data_ptr(),
             img_of_group.data_ptr(), group_counts.data_ptr(), Opad,
             int(want_grads), val.data_ptr(), gx.data_ptr(), gy.data_ptr(),
             stream)
    if err != 0:
        lib = _build.load("patch_sample")
        lib.patch_sample_error_string.restype = ctypes.c_char_p
        lib.patch_sample_error_string.argtypes = [ctypes.c_int]
        msg = lib.patch_sample_error_string(err).decode()
        raise RuntimeError(f"patch_sample launch failed: {msg} ({err})")
    KERNEL_LAUNCHES += 1
    return val, gx, gy
