"""The fixed cost of the megakernel's grid on the card, as input blocks are
added: kernel #4's counterpart.

    python3 -m photometric_bundle_adjustment_tpu_torch.scripts.grid_overhead

Port of ``scripts/grid_overhead.py``, at its constants: 160 blocks of 256
threads, each writing a (184, 256) f32 block of zeros, with 0 to 7 lane
inputs of (r, 40,960) f32, an image-index array and, per variant, a
(480, 896) f32 image block read at that index, the full harness's count
and code arrays, or the largest dynamic shared memory a block may take.
The kernel is ``csrc/grid_overhead.cu``; every block sums what it read
into a (160,) checksum, so no bound input goes unread.  It runs the
script's 11 variants in its order (``run_variant``'s five,
``run_full_shape``'s three, ``run_img_revisit``'s three), holds each
against its plain version and prints one line per variant: its time on the
device (a CUDA graph of 20 calls, replayed), its plain version's, and its
reckoned bound.  Inputs are small integers from a seed, so every checksum
is exact in f32 whatever the order of the sums.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
from typing import NamedTuple

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch import device as devices
from photometric_bundle_adjustment_tpu_torch.ops import _build

NG = 160
GROUP = 256
OUT_ROWS = 184
Hp, Wp = 480, 896
Kimg = 164
LANE_ROWS = (8, 8, 2, 104, 104, 8, 4)

# Launches of the CUDA kernel by ``probe`` in this process.
KERNEL_LAUNCHES = 0


class Variant(NamedTuple):
    label: str
    n_lanes: int
    image: bool
    iog: tuple            # image index of each block
    code_len: int         # 0: no count/code arrays (one index array bound)
    scratch: bool


def variants(ng: int = NG, kimg: int = Kimg) -> list[Variant]:
    """The script's 11 variants, in its order."""
    spread = tuple(g * kimg // ng for g in range(ng))
    runs4 = tuple(g * 40 // ng for g in range(ng))
    out = [Variant(label, n, img, spread, 0, False) for label, n, img in [
        ("grid+out only", 0, False),
        ("+ image block (prefetch-indexed)", 0, True),
        ("+ 2 lane inputs", 2, True),
        ("+ all 7 lane inputs", 7, True),
        ("7 lane inputs, no image", 7, False),
    ]]
    out += [
        Variant("3 prefetch (small code), no scratch", 7, True, runs4, ng,
                False),
        Variant(f"3 prefetch ({ng * GROUP} code), no scratch", 7, True, runs4,
                ng * GROUP, False),
        Variant(f"3 prefetch ({ng * GROUP} code) + scratch", 7, True, runs4,
                ng * GROUP, True),
    ]
    out += [Variant(label, 0, True, iog, 0, False) for label, iog in [
        ("img block: constant index", (0,) * ng),
        ("img block: 4-runs", runs4),
        ("img block: all distinct", tuple(g % kimg for g in range(ng))),
    ]]
    return out


def make_inputs(device, seed: int = 0, ng: int = NG, hp: int = Hp,
                wp: int = Wp, kimg: int = Kimg):
    """The 7 lane inputs (r, ng*256) and the (kimg, hp, wp) image stack,
    f32 integers in [0, 4) drawn with numpy from ``seed``, on ``device``."""
    rng = np.random.default_rng(seed)

    def ints(*shape):
        return torch.as_tensor(rng.integers(0, 4, shape).astype(np.float32),
                               device=device)

    return [ints(r, ng * GROUP) for r in LANE_ROWS], ints(kimg, hp, wp)


def variant_args(v: Variant, lanes, images) -> dict:
    """The keyword arguments of ``probe`` for variant ``v``."""
    dev = images.device
    ng = len(v.iog)
    args = dict(lanes=lanes[:v.n_lanes],
                iog=torch.tensor(v.iog, dtype=torch.int32, device=dev),
                images=images if v.image else None, scratch=v.scratch)
    if v.code_len:
        args["cnt"] = torch.full((ng,), GROUP, dtype=torch.int32, device=dev)
        args["code"] = torch.ones((v.code_len,), dtype=torch.int32,
                                  device=dev)
    return args


def probe_reference(lanes, iog, images=None, cnt=None, code=None,
                    scratch: bool = False):
    """Plain PyTorch version: ``(out, checksum)``, the (184, ng*256) zeros
    and for each block g the sum of its 256 columns of every lane input,
    of image ``iog[g]``, of ``iog[g]`` itself and, with the full harness,
    of ``cnt[g]`` and its ``code_len / ng`` entries of ``code``."""
    ng = iog.shape[0]
    dev = iog.device
    cs = iog.float()
    for x in lanes:
        cs = cs + x.reshape(x.shape[0], ng, GROUP).sum(dim=(0, 2))
    if images is not None:
        cs = cs + images.reshape(images.shape[0], -1).sum(dim=1)[iog.long()]
    if cnt is not None:
        cs = cs + cnt.float() + code.reshape(ng, -1).float().sum(dim=1)
    return torch.zeros((OUT_ROWS, ng * GROUP), device=dev), cs


def _check_inputs(lanes, iog, images, cnt, code):
    ng = iog.shape[0]
    dev = iog.device
    if iog.dtype != torch.int32 or iog.dim() != 1 or ng == 0:
        raise ValueError("iog must be a non-empty (ng,) int32 tensor")
    if len(lanes) > len(LANE_ROWS):
        raise ValueError(f"at most {len(LANE_ROWS)} lane inputs")
    named = [(f"lane {i}", x, torch.float32) for i, x in enumerate(lanes)]
    if images is not None:
        named.append(("images", images, torch.float32))
        if images.dim() != 3 or (images.shape[1] * images.shape[2]) % 4:
            raise ValueError("images must be (Kimg, H, W) with H*W % 4 == 0")
    if (cnt is None) != (code is None):
        raise ValueError("cnt and code are bound together")
    if cnt is not None:
        named += [("cnt", cnt, torch.int32), ("code", code, torch.int32)]
        if cnt.shape != (ng,) or code.dim() != 1 or code.numel() % ng:
            raise ValueError("cnt must be (ng,), code (k * ng,)")
    for i, x in enumerate(lanes):
        if x.dim() != 2 or x.shape[1] != ng * GROUP:
            raise ValueError(f"lane {i} must be (r, {ng * GROUP})")
    for name, t, dtype in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, iog on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _kernel_fn():
    fn = _build.load("grid_overhead").grid_overhead
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, p, p, p, p, ctypes.c_longlong, p, p, i, i, p, p,
                       p]
        fn.restype = i
    return fn


@functools.lru_cache(maxsize=None)
def max_scratch_bytes() -> int:
    """The most dynamic shared memory one block of the kernel may take on
    the current CUDA device: the counterpart of the TPU harness's 4 MiB of
    VMEM scratch."""
    fn = _build.load("grid_overhead").grid_overhead_max_smem
    fn.argtypes, fn.restype = [], ctypes.c_int
    n = fn()
    if n <= 0:
        raise RuntimeError("grid_overhead: cannot query the shared memory "
                           "limit")
    return n


def probe(lanes, iog, images=None, cnt=None, code=None,
          scratch: bool = False):
    """``(out, checksum)`` of ``probe_reference``.  On CUDA tensors it
    launches the kernel of ``csrc/grid_overhead.cu`` on the current stream
    (or raises), one block per entry of ``iog``, with ``scratch`` the most
    dynamic shared memory a block may take; on CPU tensors it runs the
    plain version."""
    global KERNEL_LAUNCHES
    if iog.device.type == "cpu":
        return probe_reference(lanes, iog, images, cnt, code, scratch)
    if iog.device.type != "cuda":
        raise ValueError(f"probe: unsupported device {iog.device}")
    _check_inputs(lanes, iog, images, cnt, code)
    ng = iog.shape[0]
    out = torch.empty((OUT_ROWS, ng * GROUP), device=iog.device)
    checksum = torch.empty((ng,), device=iog.device)
    ptrs = (ctypes.c_void_p * len(LANE_ROWS))(*[x.data_ptr() for x in lanes])
    rows = (ctypes.c_int * len(LANE_ROWS))(*[x.shape[0] for x in lanes])

    def ptr(t):
        return None if t is None else t.data_ptr()

    img_elems = 0 if images is None else images.shape[1] * images.shape[2]
    stream = torch.cuda.current_stream(iog.device).cuda_stream
    err = _kernel_fn()(ng, len(lanes), ptrs, rows, iog.data_ptr(),
                       ptr(images), img_elems, ptr(cnt), ptr(code),
                       0 if code is None else code.numel(),
                       max_scratch_bytes() if scratch else 0, out.data_ptr(),
                       checksum.data_ptr(), stream)
    if err != 0:
        lib = _build.load("grid_overhead")
        lib.grid_overhead_error_string.restype = ctypes.c_char_p
        lib.grid_overhead_error_string.argtypes = [ctypes.c_int]
        msg = lib.grid_overhead_error_string(err).decode()
        raise RuntimeError(f"grid_overhead launch failed: {msg} ({err})")
    KERNEL_LAUNCHES += 1
    return out, checksum


def bound_bytes(args: dict) -> int:
    """Bytes one call must move: the output written once, each bound input
    read once, each distinct image once."""
    iog = args["iog"]
    ng = iog.shape[0]
    n = 4 * OUT_ROWS * ng * GROUP + 4 * ng
    n += sum(4 * x.numel() for x in args["lanes"])
    if args["images"] is not None:
        im = args["images"]
        n += 4 * im.shape[1] * im.shape[2] * int(torch.unique(iog).numel())
    if args.get("cnt") is not None:
        n += 4 * (args["cnt"].numel() + args["code"].numel())
    return n


def check(out, checksum, ref_checksum, label: str) -> float:
    """Raise unless ``out`` is exactly zero and the checksums agree within
    rtol 1e-5; returns the checksums' largest relative error."""
    if not bool((out == 0).all()):
        raise RuntimeError(f"{label}: output is not all zero")
    rel = float(((checksum - ref_checksum).abs()
                 / ref_checksum.abs().clamp_min(1e-30)).max())
    if not rel <= 1e-5:
        raise RuntimeError(f"{label}: checksum rel err {rel} > 1e-5")
    return rel


def run(device="cuda", seed: int = 0, log=print) -> list[dict]:
    """Every variant once against its plain version, then timed on the
    device (kernel, plain, kernel, plain: each a CUDA graph of 20 calls)
    beside its reckoned bound.  Returns one dict per variant."""
    from photometric_bundle_adjustment_tpu_torch.profile_solve import (
        H100_BYTES_PER_S,
        graph_ms,
    )

    device = devices.resolve(device)
    gpu = device.type == "cuda"
    lanes, images = make_inputs(device, seed)
    rows = []
    for v in variants():
        args = variant_args(v, lanes, images)
        out, cs = probe(**args)
        _, ref = probe_reference(**args)
        err = check(out, cs, ref, v.label)
        row = dict(label=v.label, max_rel_err=err,
                   max_abs_err=float((cs - ref).abs().max()),
                   bound_ms=1e3 * bound_bytes(args) / H100_BYTES_PER_S,
                   ms=None, plain_ms=None)
        if gpu:
            ms = [graph_ms(lambda: probe(**args))]
            plain = [graph_ms(lambda: probe_reference(**args))]
            ms.append(graph_ms(lambda: probe(**args)))
            plain.append(graph_ms(lambda: probe_reference(**args)))
            row.update(ms=float(np.mean(ms)), plain_ms=float(np.mean(plain)))
        if gpu and v.scratch:
            row["scratch_bytes"] = max_scratch_bytes()
        rows.append(row)
        log(f"{v.label}: " + (f"{row['ms']:.4f} ms on the device, plain "
                              f"{row['plain_ms']:.4f} ms, " if gpu else
                              "not timed off the card, ")
            + f"bound {row['bound_ms']:.4f} ms (bytes); checksum rel err "
            f"{err:.1e}")
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = devices.resolve(args.device)
    print("device:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else "cpu")
    rows = run(device)
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
