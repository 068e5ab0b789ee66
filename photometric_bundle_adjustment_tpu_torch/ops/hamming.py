"""Brute-force 256-bit Hamming best-two matching over a worklist of pairs.

Port of the Pallas TPU kernel ``photometric_bundle_adjustment_tpu/ops/
hamming.py`` (``_match_kernel``, launched by ``best_two_nn`` once per
match direction).  For every row of ``desc1[a[p]]``: the best and
second-best Hamming distance and the best index against the valid rows of
``desc2[b[p]]``, ties going to the lowest index, invalid rows reading as
``BIG``; ``best_two_both`` also gives the same for every row of
``desc2[b[p]]`` against the valid rows of ``desc1[a[p]]``, from the same
distances (Hamming distance is symmetric).

Descriptors are (…, 8) words of 256 bits.  The JAX package holds them as
uint32; the port holds the same bits as int32 (``interop``), because
torch's uint32 supports few operations, and the kernel reads them as
``uint32_t``.

Two forms of each function:

- ``best_two_both`` and ``best_two_nn`` launch the CUDA kernel of
  ``csrc/hamming.cu`` on CUDA tensors: one launch for the whole worklist,
  both directions from one distance tile on the tensor cores
  (``best_two_nn`` runs the same kernel without the column epilogue).
  The kernel refuses descriptor blocks whose staging does not fit in a
  block's shared memory (``smem_bytes``).  On
  CPU tensors they run the plain versions.  They never fall back from the
  card.
- ``best_two_both_reference`` and ``best_two_nn_reference``: the popcount
  distance matrix plus ``best_two_from`` in plain torch, in chunks of
  pairs; the first reduces one matrix along both axes, as the JAX
  package's XLA route does.

The TPU kernel masks by a count of valid columns; both forms here take
the mask itself (see ``csrc/hamming.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from photometric_bundle_adjustment_tpu_torch.ops import _build

BIG = 1 << 20
WORDS = 8
# pairs per distance matrix in the plain version (SfmConfig.match_chunk_pairs)
CHUNK_PAIRS = 32
# what the kernel's entry returns for blocks too large for shared memory
CUDA_ERROR_INVALID_VALUE = 1

KERNEL_LAUNCHES = 0


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of 32-bit words held in an int64 tensor with values
    in [0, 2^32): the bit-parallel reduction of the TPU kernel's
    ``_popcount``.  int64, because ``>>`` on int32 is arithmetic and would
    smear the sign bit of words with the top bit set."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(…, N1, N2) int32 Hamming distances between (…, N1, 8) and
    (…, N2, 8) int32 descriptor rows (xor plus popcount, word by word)."""
    u1 = d1.to(torch.int64) & 0xFFFFFFFF
    u2 = d2.to(torch.int64) & 0xFFFFFFFF
    acc = None
    for w in range(WORDS):
        pc = popcount32(u1[..., :, None, w] ^ u2[..., None, :, w])
        acc = pc if acc is None else acc + pc
    return acc.to(torch.int32)


def best_two_from(dist: torch.Tensor, dim: int):
    """(best, second, best_idx) along ``dim`` of a masked distance matrix
    (invalid entries already ``BIG``), int32.  The index is the lowest
    column that reaches the minimum, taken as the TPU kernel takes it (the
    min of the matching column indices), not from ``argmin``."""
    best = dist.amin(dim)
    shape = [1] * dist.dim()
    shape[dim] = dist.shape[dim]
    col = torch.arange(dist.shape[dim], dtype=torch.int32,
                       device=dist.device).reshape(shape)
    big = torch.tensor(BIG, dtype=torch.int32, device=dist.device)
    bidx = torch.where(dist == best.unsqueeze(dim), col, big).amin(dim)
    second = torch.where(col == bidx.unsqueeze(dim), big, dist).amin(dim)
    return best.to(torch.int32), second.to(torch.int32), bidx.to(torch.int32)


def _pair_index(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device).reshape(-1)


def best_two_nn_reference(desc1, desc2, valid2, a, b):
    """Plain version of the kernel: for each pair p, (best, second, idx)
    of the rows of ``desc1[a[p]]`` against the valid rows of
    ``desc2[b[p]]``.  desc1 (I1, N1, 8) int32, desc2 (I2, N2, 8) int32,
    valid2 (I2, N2) bool, a and b (P,) integer; returns three (P, N1)
    int32 tensors.  Works in chunks of ``CHUNK_PAIRS`` pairs so that the
    (chunk, N1, N2) distance matrix stays small."""
    dev = desc1.device
    a, b = _pair_index(a, dev), _pair_index(b, dev)
    N1 = desc1.shape[1]
    big = torch.tensor(BIG, dtype=torch.int32, device=dev)
    outs = []
    for s in range(0, a.shape[0], CHUNK_PAIRS):
        aa, bb = a[s:s + CHUNK_PAIRS], b[s:s + CHUNK_PAIRS]
        dist = hamming_matrix(desc1[aa], desc2[bb])
        outs.append(best_two_from(
            torch.where(valid2[bb][:, None, :], dist, big), 2))
    if not outs:
        empty = torch.empty((0, N1), dtype=torch.int32, device=dev)
        return empty, empty.clone(), empty.clone()
    return tuple(torch.cat(x) for x in zip(*outs))


def best_two_both_reference(desc1, valid1, desc2, valid2, a, b):
    """Plain version of the kernel in both directions: one distance
    matrix per chunk of pairs, reduced along both axes.  Returns
    (best12, second12, idx12), each (P, N1), equal to
    ``best_two_nn_reference(desc1, desc2, valid2, a, b)``, and
    (best21, second21, idx21), each (P, N2), equal to
    ``best_two_nn_reference(desc2, desc1, valid1, b, a)``; all int32."""
    dev = desc1.device
    a, b = _pair_index(a, dev), _pair_index(b, dev)
    N1, N2 = desc1.shape[1], desc2.shape[1]
    big = torch.tensor(BIG, dtype=torch.int32, device=dev)
    outs = []
    for s in range(0, a.shape[0], CHUNK_PAIRS):
        aa, bb = a[s:s + CHUNK_PAIRS], b[s:s + CHUNK_PAIRS]
        dist = hamming_matrix(desc1[aa], desc2[bb])
        outs.append(
            best_two_from(torch.where(valid2[bb][:, None, :], dist, big), 2)
            + best_two_from(torch.where(valid1[aa][:, :, None], dist, big), 1))
    if not outs:
        return tuple(torch.empty((0, n), dtype=torch.int32, device=dev)
                     for n in (N1, N1, N1, N2, N2, N2))
    return tuple(torch.cat(x) for x in zip(*outs))


def _lib() -> ctypes.CDLL:
    """The built kernel library, its entry points bound once."""
    lib = _build.load("hamming")
    if lib.hamming_best_two.argtypes is None:
        lib.hamming_best_two.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,   # d1, valid1, N1
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,   # d2, valid2, N2
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,   # a, b, P
            ctypes.c_void_p, ctypes.c_void_p,                 # outputs, stream
        ]
        lib.hamming_best_two.restype = ctypes.c_int
        lib.hamming_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.hamming_smem_bytes.restype = ctypes.c_longlong
        lib.hamming_error_string.argtypes = [ctypes.c_int]
        lib.hamming_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(N1: int, N2: int, both: bool = True) -> int:
    """Dynamic shared memory of one block of the kernel for blocks of N1
    and N2 descriptors (both staged, plus the key bases and, for both
    directions, the column partials)."""
    return int(_lib().hamming_smem_bytes(N1, N2, int(both)))


def check_kernel_inputs(desc1, valid1, desc2, valid2, a, b):
    """Raise ValueError unless the kernel can take these inputs: dtypes,
    shapes, one device, contiguity, alignment, pair indices in range (one
    host sync, for the range)."""
    dev = desc1.device
    checks = [("desc1", desc1, 3, torch.int32), ("desc2", desc2, 3, torch.int32),
              ("valid2", valid2, 2, torch.bool)]
    if valid1 is not None:
        checks.append(("valid1", valid1, 2, torch.bool))
    for name, t, dim, dtype in checks:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, desc1 on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != dim or (dim == 3 and t.shape[2] != WORDS):
            raise ValueError(f"{name} has shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, v, d in (("valid1", valid1, desc1), ("valid2", valid2, desc2)):
        if v is not None and tuple(v.shape) != tuple(d.shape[:2]):
            raise ValueError(f"{name} {tuple(v.shape)} does not match its "
                             f"descriptors {tuple(d.shape)}")
    if desc1.data_ptr() % 16 or desc2.data_ptr() % 16:
        raise ValueError("descriptor stacks must be 16-byte aligned")
    if a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ")
    lo, hi = torch.stack([a.min(), b.min(), a.max() - desc1.shape[0],
                          b.max() - desc2.shape[0]]).reshape(2, 2).tolist()
    if min(lo) < 0 or max(hi) >= 0:
        raise ValueError("pair indices out of range of the descriptor stacks")


def _launch(desc1, valid1, desc2, valid2, a, b):
    """One kernel launch over the worklist on the current stream: the
    forward outputs, and the backward ones too when ``valid1`` is given."""
    dev = desc1.device
    if dev.type != "cuda":
        raise ValueError(f"hamming kernel: unsupported device {dev}")
    a = torch.as_tensor(a, device=dev).to(torch.int32).reshape(-1).contiguous()
    b = torch.as_tensor(b, device=dev).to(torch.int32).reshape(-1).contiguous()
    P, N1, N2 = a.shape[0], desc1.shape[1], desc2.shape[1]
    widths = (N1,) * 3 + ((N2,) * 3 if valid1 is not None else ())
    outs = [torch.empty((P, n), dtype=torch.int32, device=dev) for n in widths]
    if P == 0:
        return tuple(outs)
    check_kernel_inputs(desc1, valid1, desc2, valid2, a, b)
    enqueue(desc1, valid1, desc2, valid2, a, b, outs)
    return tuple(outs)


def enqueue(desc1, valid1, desc2, valid2, a, b, outs):
    """The kernel's launch on the current stream into the preallocated
    ``outs`` ((P, N1) x 3, then (P, N2) x 3 when ``valid1`` is given,
    int32), for inputs that passed ``check_kernel_inputs`` (``a`` and
    ``b`` contiguous int32 on the device): no host sync, so a caller that
    checks once can capture launches in a CUDA graph."""
    global KERNEL_LAUNCHES
    dev = desc1.device
    P, N1, N2 = a.shape[0], desc1.shape[1], desc2.shape[1]
    lib = _lib()
    ptrs = (ctypes.c_void_p * 6)(*[o.data_ptr() for o in outs])
    err = lib.hamming_best_two(
        desc1.data_ptr(), 0 if valid1 is None else valid1.data_ptr(), N1,
        desc2.data_ptr(), valid2.data_ptr(), N2, a.data_ptr(), b.data_ptr(),
        P, ctypes.addressof(ptrs), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = f"{lib.hamming_error_string(err).decode()} ({err})"
        if err == CUDA_ERROR_INVALID_VALUE:
            raise ValueError(
                f"hamming_best_two refused N1={N1}, N2={N2}: {msg}; a block "
                f"would stage {smem_bytes(N1, N2, valid1 is not None)} bytes "
                f"in shared memory, past the kernel's limit")
        raise RuntimeError(f"hamming_best_two launch failed: {msg}")
    KERNEL_LAUNCHES += 1


def best_two_nn(desc1, desc2, valid2, a, b):
    """(best, second, idx), each (P, N1) int32, for the rows of
    ``desc1[a[p]]`` against ``desc2[b[p]]``; arguments as
    ``best_two_nn_reference``.

    On CUDA tensors it launches the kernel of ``csrc/hamming.cu`` once for
    the whole worklist on the current stream, without the column
    epilogue (or raises); on CPU tensors it runs the plain version."""
    if desc1.device.type == "cpu":
        return best_two_nn_reference(desc1, desc2, valid2, a, b)
    return _launch(desc1, None, desc2, valid2, a, b)


def best_two_both(desc1, valid1, desc2, valid2, a, b):
    """Both match directions of every pair from one distance tile:
    (best12, second12, idx12), each (P, N1), and (best21, second21,
    idx21), each (P, N2), int32; arguments and results as
    ``best_two_both_reference``.

    On CUDA tensors it launches the kernel of ``csrc/hamming.cu`` once for
    the whole worklist on the current stream (or raises); on CPU tensors
    it runs the plain version."""
    if desc1.device.type == "cpu":
        return best_two_both_reference(desc1, valid1, desc2, valid2, a, b)
    return _launch(desc1, valid1, desc2, valid2, a, b)
