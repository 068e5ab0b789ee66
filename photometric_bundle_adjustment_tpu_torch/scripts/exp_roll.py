"""Windowed reads at a run-time lane shift on the card: kernel #5's
counterpart.

    python3 -m photometric_bundle_adjustment_tpu_torch.scripts.exp_roll \
        [roll|dynslice|rollstatic]

Port of ``scripts/exp_roll.py``: read the (24, 128) window of a (24, 256)
f32 tile at lane shift s, by a roll at a run-time shift (``roll``), a
slice at a run-time unaligned start (``dynslice``) or a roll by the
constant 8 (``rollstatic``).  The kernel, ``csrc/exp_roll.cu``, takes a
batch of B tiles and B shifts; the script's call is B = 1 on
``arange(24 * 256)`` at s = 13, checked against the script's numpy
expressions.  Prints ``<mode> ok: <bool>`` for each mode asked (all three
by default), as the script does.
"""

from __future__ import annotations

import argparse
import ctypes
import math

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch import device as devices
from photometric_bundle_adjustment_tpu_torch.ops import _build

ROWS, COLS, WIN = 24, 256, 128
SHIFT = 13           # the script's run-time shift
STATIC_SHIFT = 8     # rollstatic's constant
MODES = ("roll", "dynslice", "rollstatic")

# Launches of the CUDA kernel by ``window`` in this process.
KERNEL_LAUNCHES = 0


def window_reference(x: torch.Tensor, shifts: torch.Tensor,
                     mode: str) -> torch.Tensor:
    """Plain PyTorch version: (B, 24, 128) windows of the (B, 24, 256)
    tiles ``x`` at the (B,) int32 ``shifts``.  ``roll`` reads column
    (c + s) mod 256; ``dynslice`` columns s .. s + 127, NaN where the
    window would leave the tile (s outside [0, 128]); ``rollstatic``
    columns 8 .. 135, whatever ``shifts`` holds."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    B = x.shape[0]
    s = shifts.long()[:, None]
    if mode == "rollstatic":
        s = torch.full_like(s, STATIC_SHIFT)
    c = torch.arange(WIN, device=x.device)[None, :]
    if mode == "roll":
        idx = (c + s) % COLS
        return x.gather(2, idx[:, None, :].expand(B, ROWS, WIN))
    inside = (s >= 0) & (s <= COLS - WIN)                     # (B, 1)
    idx = torch.where(inside, c + s, c)
    out = x.gather(2, idx[:, None, :].expand(B, ROWS, WIN))
    return torch.where(inside[:, :, None], out,
                       torch.full_like(out, math.nan))


def _kernel_fn():
    fn = _build.load("exp_roll").exp_roll
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, p, p]
        fn.restype = i
    return fn


def window(x: torch.Tensor, shifts: torch.Tensor, mode: str) -> torch.Tensor:
    """The windows of ``window_reference``.  On CUDA tensors it launches
    the kernel of ``csrc/exp_roll.cu`` on the current stream (or raises);
    on CPU tensors it runs the plain version."""
    global KERNEL_LAUNCHES
    if x.device.type == "cpu":
        return window_reference(x, shifts, mode)
    if x.device.type != "cuda":
        raise ValueError(f"window: unsupported device {x.device}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    B = x.shape[0]
    if x.dtype != torch.float32 or x.shape != (B, ROWS, COLS) or B == 0:
        raise ValueError(f"x must be (B, {ROWS}, {COLS}) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if shifts.dtype != torch.int32 or shifts.shape != (B,):
        raise ValueError(f"shifts must be ({B},) int32")
    if shifts.device != x.device:
        raise ValueError(f"shifts is on {shifts.device}, x on {x.device}")
    if not (x.is_contiguous() and shifts.is_contiguous()):
        raise ValueError("x and shifts must be contiguous")
    out = torch.empty((B, ROWS, WIN), device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel_fn()(x.data_ptr(), shifts.data_ptr(), B, MODES.index(mode),
                       out.data_ptr(), stream)
    if err != 0:
        lib = _build.load("exp_roll")
        lib.exp_roll_error_string.restype = ctypes.c_char_p
        lib.exp_roll_error_string.argtypes = [ctypes.c_int]
        msg = lib.exp_roll_error_string(err).decode()
        raise RuntimeError(f"exp_roll launch failed: {msg} ({err})")
    KERNEL_LAUNCHES += 1
    return out


def script_case(device):
    """The script's input: one tile ``arange(24 * 256)`` and the shift 13."""
    x = torch.arange(ROWS * COLS, dtype=torch.float32, device=device)
    return (x.reshape(1, ROWS, COLS),
            torch.tensor([SHIFT], dtype=torch.int32, device=device))


def numpy_expected(x: np.ndarray, mode: str) -> np.ndarray:
    """The script's numpy expression for one (24, 256) tile at shift 13."""
    if mode == "dynslice":
        return x[:, SHIFT:SHIFT + WIN]
    s = STATIC_SHIFT if mode == "rollstatic" else SHIFT
    return np.roll(x, -s, axis=1)[:, :WIN]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", choices=MODES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = devices.resolve(args.device)
    x, s = script_case(device)
    ok = {}
    for mode in [args.mode] if args.mode else MODES:
        out = window(x, s, mode)[0].cpu().numpy()
        ok[mode] = bool(np.array_equal(out, numpy_expected(
            x[0].cpu().numpy(), mode)))
        print(mode, "ok:", ok[mode])
    return ok


if __name__ == "__main__":
    main()
