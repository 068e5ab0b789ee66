"""The fixed cost of the megakernel's grid on the card, as input blocks are
added: kernel #4's counterpart.

    python3 -m photometric_bundle_adjustment_tpu_torch.scripts.grid_overhead

Port of ``scripts/grid_overhead.py``, at its constants: 160 TPU grid steps,
each writing a (184, 256) f32 block of zeros, with 0 to 7 lane inputs of
(r, 40,960) f32, an image-index array and, per variant, a (480, 896) f32
image block read at that index, the full harness's count and code arrays,
or the largest dynamic shared memory a block may take.  The kernel is
``csrc/grid_overhead.cu``: its grid is sized from the card's SM count, not
from the 160 steps, and walks the work units that ``plan`` cuts (output
tiles, lane tiles, slices of each distinct image); ``emulate`` runs the
same unit loop in numpy.  Per step it sums what it read into a (160,)
checksum, so no bound input goes unread.  The entry point runs the
script's 11 variants in its order (``run_variant``'s five,
``run_full_shape``'s three, ``run_img_revisit``'s three), holds each
against its plain version and prints one line per variant: its time on the
device (a CUDA graph of 20 calls, replayed), its plain version's, its
reckoned bound and the kernel's share of it.  Inputs are small integers
from a seed, so every checksum is exact in f32 whatever the order of the
sums.
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
# csrc/grid_overhead.cu: threads per block, 16-byte loads in flight per
# thread, most images in a stack
THREADS = 512
DEPTH = 8
MAX_IMAGES = 1024
UNIT4 = THREADS * DEPTH         # float4 a lane unit or image slice reads

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


class Plan(NamedTuple):
    """The kernel's work units; the fields up to ``img_slot0`` are its C
    struct ``Plan``, in order."""
    out4: int             # float4 in the output
    out_tile4: int        # float4 per output tile
    img_elems: int        # floats per image (0: no image stack)
    ng: int               # TPU grid steps
    n_out: int            # output tiles, a multiple of the grid
    n_lanes: int
    chunk_rows: int       # concatenated lane rows per lane unit
    n_chunks: int         # lane units per step (the first sums cnt, code)
    code_per_block: int   # code entries per step (0: no cnt/code)
    kimg: int
    slice_elems: int      # floats per image slice
    n_slices: int         # slices per image
    img_slot0: int        # slot of the first image partial
    grid: int             # CUDA blocks
    row0: tuple           # first stacked row of each lane, and the total
    n_slots: int          # partial sums: ng * n_chunks, then the images'


@functools.lru_cache(maxsize=None)
def plan(ng: int, lane_rows: tuple, kimg: int, img_elems: int, n_sm: int,
         code_len: int = 0) -> Plan:
    """Cut a call into the kernel's work units for a card of ``n_sm`` SMs
    (one block each).  Every unit moves at most ``UNIT4`` float4 (64 KB):
    the output in ``n_out`` tiles, a multiple of the grid so that every
    block zeroes the same share; each step's lane rows, stacked in lane
    order, in chunks of ``chunk_rows`` x 256 columns (with ``code_len``, a
    step's first chunk also sums its count and code entries); each image
    of ``img_elems`` floats (0: none) in ``n_slices`` slices.  Slot
    ``g * n_chunks + c`` holds lane unit (g, c) and slot ``img_slot0 +
    j * n_slices + s`` slice s of the j-th distinct image of iog in
    ascending order: at most min(ng, kimg) of them."""
    if ng <= 0 or n_sm <= 0 or len(lane_rows) > len(LANE_ROWS):
        raise ValueError("plan: bad ng, n_sm or lane count")
    if img_elems % 4 or (img_elems and not 0 < kimg <= MAX_IMAGES):
        raise ValueError(f"plan: images must hold 1 to {MAX_IMAGES} images "
                         "of a multiple of 4 floats")
    if code_len % ng:
        raise ValueError("plan: code_len must be a multiple of ng")
    out4 = OUT_ROWS * ng * GROUP // 4
    n_out = n_sm * -(-out4 // (n_sm * UNIT4))
    row0 = tuple(int(r) for r in np.concatenate([[0], np.cumsum(lane_rows)]))
    chunk_rows = UNIT4 // (GROUP // 4)
    n_chunks = -(-row0[-1] // chunk_rows) or int(code_len > 0)
    slice_elems = 4 * UNIT4
    n_slices = -(-img_elems // slice_elems)
    img_slot0 = ng * n_chunks
    return Plan(out4=out4, out_tile4=-(-out4 // n_out), img_elems=img_elems,
                ng=ng, n_out=n_out, n_lanes=len(lane_rows),
                chunk_rows=chunk_rows, n_chunks=n_chunks,
                code_per_block=code_len // ng, kimg=kimg,
                slice_elems=slice_elems, n_slices=n_slices,
                img_slot0=img_slot0, grid=n_sm, row0=row0,
                n_slots=img_slot0 + min(ng, kimg) * n_slices)


def emulate(p: Plan, lanes, iog, images=None, cnt=None, code=None):
    """The kernel's unit loop over plan ``p`` in numpy, block by block:
    ``(out, checksum, reads)``, where ``reads`` counts how often each
    element was touched: ``out`` (writes), ``lanes`` (one array per lane),
    ``images`` (kimg, img_elems) and ``code``.  Inputs are numpy arrays.
    Sums are f32 but not in the kernel's order within a unit, which
    small-integer inputs make exact either way.  An index of iog outside
    the stack gives a NaN checksum, as on the card."""
    f32 = np.float32
    out = np.full(4 * p.out4, np.nan, f32)
    reads = dict(out=np.zeros(4 * p.out4, np.int8),
                 lanes=[np.zeros(x.shape, np.int8) for x in lanes])
    imgs = None if images is None else images.reshape(images.shape[0], -1)
    if imgs is not None:
        reads["images"] = np.zeros(imgs.shape, np.int8)
    if code is not None:
        reads["code"] = np.zeros(code.shape, np.int8)
    used = [] if imgs is None else sorted(
        {int(k) for k in iog if 0 <= k < p.kimg})
    n_lane_units = p.ng * p.n_chunks
    n_units = p.n_out + n_lane_units + len(used) * p.n_slices
    slots = np.full(max(p.n_slots, 1), np.nan, f32)

    def lane_unit(g, c):
        acc = f32(0)
        r_lo = c * p.chunk_rows
        r_hi = min(r_lo + p.chunk_rows, p.row0[-1])
        cols = slice(g * GROUP, (g + 1) * GROUP)
        for i, x in enumerate(lanes):
            lo, hi = max(r_lo, p.row0[i]), min(r_hi, p.row0[i + 1])
            if lo < hi:
                rows = slice(lo - p.row0[i], hi - p.row0[i])
                acc += x[rows, cols].sum(dtype=f32)
                reads["lanes"][i][rows, cols] += 1
        if c == 0 and code is not None:
            seg = slice(g * p.code_per_block, (g + 1) * p.code_per_block)
            acc += code[seg].sum(dtype=f32) + f32(cnt[g])
            reads["code"][seg] += 1
        return acc

    def image_unit(k, s):
        seg = slice(s * p.slice_elems,
                    min((s + 1) * p.slice_elems, p.img_elems))
        reads["images"][k, seg] += 1
        return imgs[k, seg].sum(dtype=f32)

    for b in range(p.grid):
        for u in range(b, p.n_out, p.grid):
            seg = slice(4 * u * p.out_tile4,
                        4 * min((u + 1) * p.out_tile4, p.out4))
            out[seg] = 0
            reads["out"][seg] += 1
        for u in range(p.n_out + b, n_units, p.grid):
            v = u - p.n_out
            if v < n_lane_units:
                slots[v] = lane_unit(*divmod(v, p.n_chunks))
            else:
                j, s = divmod(v - n_lane_units, p.n_slices)
                slots[p.img_slot0 + v - n_lane_units] = image_unit(used[j], s)
    # the last block: each used image's slices, then each step's slots
    totals = {k: slots[p.img_slot0 + j * p.n_slices:
                       p.img_slot0 + (j + 1) * p.n_slices].sum(dtype=f32)
              for j, k in enumerate(used)}
    checksum = np.empty(p.ng, f32)
    for g in range(p.ng):
        k = int(iog[g])
        cs = f32(k) + slots[g * p.n_chunks:(g + 1) * p.n_chunks].sum(dtype=f32)
        if imgs is not None:
            cs += totals.get(k, f32(np.nan))
        checksum[g] = cs
    return out.reshape(OUT_ROWS, p.ng * GROUP), checksum, reads


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
        if t.dtype == torch.float32 and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


class _PlanArgs(ctypes.Structure):
    """``Plan`` in csrc/grid_overhead.cu."""
    _fields_ = [(f, ctypes.c_longlong if f in ("out4", "out_tile4",
                                               "img_elems") else ctypes.c_int)
                for f in Plan._fields[:Plan._fields.index("img_slot0") + 1]]


def _kernel_fn():
    fn = _build.load("grid_overhead").grid_overhead
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ctypes.POINTER(_PlanArgs), i, p, p, p, p, p, p, i, p,
                       p, p, p]
        fn.restype = i
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    launches the kernel of ``csrc/grid_overhead.cu`` once on the current
    stream (or raises), one block per SM over the units of ``plan``, with
    ``scratch`` the most dynamic shared memory a block may take; it makes
    no host sync, so a CUDA graph can capture it.  Calls on one device
    must not overlap (the kernel's ticket is one per device).  On CPU
    tensors it runs the plain version."""
    global KERNEL_LAUNCHES
    if iog.device.type == "cpu":
        return probe_reference(lanes, iog, images, cnt, code, scratch)
    if iog.device.type != "cuda":
        raise ValueError(f"probe: unsupported device {iog.device}")
    _check_inputs(lanes, iog, images, cnt, code)
    ng = iog.shape[0]
    dev = iog.device
    p = plan(ng, tuple(x.shape[0] for x in lanes),
             0 if images is None else images.shape[0],
             0 if images is None else images.shape[1] * images.shape[2],
             _sm_count(dev.index), 0 if code is None else code.numel())
    out = torch.empty((OUT_ROWS, ng * GROUP), device=dev)
    checksum = torch.empty((ng,), device=dev)
    slots = torch.empty((max(p.n_slots, 1),), device=dev)
    ptrs = (ctypes.c_void_p * len(LANE_ROWS))(*[x.data_ptr() for x in lanes])
    row0 = (ctypes.c_int * len(p.row0))(*p.row0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = _PlanArgs(*p[:len(_PlanArgs._fields_)])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel_fn()(ctypes.byref(args), p.grid, ptrs, row0,
                       iog.data_ptr(), ptr(images), ptr(cnt), ptr(code),
                       max_scratch_bytes() if scratch else 0, out.data_ptr(),
                       checksum.data_ptr(), slots.data_ptr(), stream)
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
    """Every variant once against its plain version and, on the card, a
    second call held bit-equal to the first; then timed on the device
    (kernel, plain, kernel, plain: each a CUDA graph of 20 calls) beside its
    reckoned bound.  Returns one dict per variant (``share``: the bound
    over the kernel's time)."""
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
        if not torch.equal(probe(**args)[1], cs):
            raise RuntimeError(f"{v.label}: two calls differ")
        row = dict(label=v.label, max_rel_err=err,
                   max_abs_err=float((cs - ref).abs().max()),
                   bound_ms=1e3 * bound_bytes(args) / H100_BYTES_PER_S,
                   ms=None, plain_ms=None, share=None)
        if gpu:
            ms = [graph_ms(lambda: probe(**args))]
            plain = [graph_ms(lambda: probe_reference(**args))]
            ms.append(graph_ms(lambda: probe(**args)))
            plain.append(graph_ms(lambda: probe_reference(**args)))
            row.update(ms=float(np.mean(ms)), plain_ms=float(np.mean(plain)))
            row["share"] = row["bound_ms"] / row["ms"]
        if gpu and v.scratch:
            row["scratch_bytes"] = max_scratch_bytes()
        rows.append(row)
        log(f"{v.label}: " + (f"{row['ms']:.4f} ms on the device, plain "
                              f"{row['plain_ms']:.4f} ms, " if gpu else
                              "not timed off the card, ")
            + f"bound {row['bound_ms']:.4f} ms (bytes)"
            + (f", {row['share']:.1%} of it" if gpu else "")
            + f"; checksum rel err {err:.1e}, two calls bit-equal")
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
