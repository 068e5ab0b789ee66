"""Descriptor matching: Hamming distance, ratio test, mutual cross-check.

Port of ``photometric_bundle_adjustment_tpu/features/match.py``, with the
reference's matchSets/matchDescriptors semantics (keypoints.h:223-278): a
left feature matches right feature j iff

- j minimises the Hamming distance (ties to the lowest j),
- the best distance is < threshold (70 by default),
- the second-best distance is >= best * ratio (1.2 by default),
- and the right-to-left match agrees (mutual cross-check).

The ratio test runs in float32, as the JAX package's XLA route evaluates
it: ``float32(second) >= float32(best) * float32(ratio)``.  The native C++
matcher of the JAX package (``features/native_match.py``) evaluates it in
double, so the two differ where the f32 product rounds up past an integer
that the f64 product equals: at ratio 1.2, (best, second) = (25, 30),
(45, 54) and (50, 60) are rejected here and accepted in double.  At
(60, 72), both round to exactly 72 and accept.

Both directions come from one call of ``ops.hamming.best_two_both``: on
CUDA tensors the Hamming kernel, one launch for a whole worklist of pairs
and both directions, from one distance tile (Hamming distance is
symmetric, as the JAX package's XLA route uses); on CPU tensors its plain
version.  No flag chooses between them.
Descriptors are int32 words holding the JAX package's uint32 bits;
results use -1 for "no match".
"""

from __future__ import annotations

import torch

from photometric_bundle_adjustment_tpu_torch.ops import hamming

# the kernel's arithmetic and its plain version live in ops.hamming
BIG = hamming.BIG
hamming_matrix = hamming.hamming_matrix
_best_two_from = hamming.best_two_from


def _one_way(best, second, bidx, valid1, threshold: int, ratio: float):
    """matchSets accept rule (keypoints.h:247-253), in float32."""
    r = torch.tensor(ratio, dtype=torch.float32, device=best.device)
    ok = (best < threshold) & (second.float() >= best.float() * r) & valid1
    return torch.where(ok, bidx, torch.full_like(bidx, -1))


def _mutual(m12: torch.Tensor, m21: torch.Tensor) -> torch.Tensor:
    """Keep m12[..., i] only where m21[..., m12[i]] == i."""
    n2 = m21.shape[-1]
    back = torch.gather(m21, -1, m12.clamp(0, n2 - 1).long())
    rows = torch.arange(m12.shape[-1], dtype=m12.dtype, device=m12.device)
    keep = (m12 >= 0) & (back == rows)
    return torch.where(keep, m12, torch.full_like(m12, -1))


def match_batch(desc1, valid1, desc2, valid2, a, b, threshold: int = 70,
                ratio: float = 1.2) -> torch.Tensor:
    """Mutual best matches for a worklist of pairs: (P, N1) int32, entry
    [p, i] the index into desc2[b[p]] matched by row i of desc1[a[p]], or
    -1.  desc1 (I1, N1, 8) int32, valid1 (I1, N1) bool, desc2 and valid2
    likewise, a and b (P,) integer."""
    dev = desc1.device
    a = torch.as_tensor(a, dtype=torch.int64, device=dev).reshape(-1)
    b = torch.as_tensor(b, dtype=torch.int64, device=dev).reshape(-1)
    b1, s1, i1, b2, s2, i2 = hamming.best_two_both(desc1, valid1, desc2,
                                                   valid2, a, b)
    m12 = _one_way(b1, s1, i1, valid1[a], threshold, ratio)
    m21 = _one_way(b2, s2, i2, valid2[b], threshold, ratio)
    return _mutual(m12, m21)


def match_descriptors(d1, d2, valid1, valid2, threshold: int = 70,
                      ratio: float = 1.2) -> torch.Tensor:
    """Mutual best matches of one pair (matchDescriptors,
    keypoints.h:259-278).  d1 (N1, 8) and d2 (N2, 8) int32, valid masks
    (N1,) and (N2,) bool.  Returns (N1,) int32: index into d2 or -1."""
    zero = torch.zeros(1, dtype=torch.int64, device=d1.device)
    return match_batch(d1[None], valid1[None], d2[None], valid2[None], zero,
                       zero, threshold, ratio)[0]


def matches_to_pairs(m12: torch.Tensor, max_matches: int):
    """Compact (…, N1) match vectors into fixed-size (…, max_matches, 2)
    index pairs, a validity mask and a count, matched rows first in row
    order; padding rows are (0, 0)."""
    N1 = m12.shape[-1]
    is_match = m12 >= 0
    order = torch.argsort((~is_match).to(torch.int8), dim=-1, stable=True)
    if N1 < max_matches:
        pad = torch.zeros(order.shape[:-1] + (max_matches - N1,),
                          dtype=order.dtype, device=order.device)
        order = torch.cat([order, pad], dim=-1)
    rows = order[..., :max_matches]
    cols = torch.gather(m12, -1, rows)
    count = torch.clamp(is_match.sum(-1), max=max_matches).to(torch.int32)
    k = torch.arange(max_matches, device=m12.device)
    valid = k < count[..., None]
    zero = torch.zeros((), dtype=torch.int32, device=m12.device)
    pairs = torch.stack([torch.where(valid, rows.to(torch.int32), zero),
                         torch.where(valid, cols.to(torch.int32), zero)],
                        dim=-1)
    return pairs, valid, count
