"""All-pairs descriptor matching over a worklist of image pairs.

Port of the descriptor half of ``photometric_bundle_adjustment_tpu/
features/pair_matching.py``: the replacement of the reference's TBB
``parallel_for`` over image pairs (sfm.cpp:1294-1319).  ``match_pairs``
has the contract of the JAX package's native matcher
(``native_match.match_pairs``) and of its vmapped chunk matcher, with the
f32 ratio test of the latter (``features.match``).  On the card the whole
worklist is one kernel launch per direction.

The relative-pose RANSAC that follows in the JAX package
(``make_pair_matcher``, ``make_mega_pair_matcher``, ``make_ransac_chunk``)
comes with the RANSAC slice, the ring matcher with the distributed slice.
"""

from __future__ import annotations

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch.features import match


def match_pairs(desc: torch.Tensor, valid: torch.Tensor, i1, i2,
                threshold: int = 70, ratio: float = 1.2) -> torch.Tensor:
    """(P, F) int32 match table: row p holds, for each feature of image
    i1[p], its mutual best match in image i2[p] or -1
    (matchDescriptors semantics, keypoints.h:259-278).

    desc (I, F, 8) int32, valid (I, F) bool, i1 and i2 (P,) image
    indices; runs on the descriptors' device."""
    i1 = np.asarray(i1, np.int64).reshape(-1)
    i2 = np.asarray(i2, np.int64).reshape(-1)
    I = desc.shape[0]
    if i1.shape != i2.shape:
        raise ValueError(f"i1 {i1.shape} and i2 {i2.shape} differ")
    if i1.size and (min(i1.min(), i2.min()) < 0 or max(i1.max(), i2.max()) >= I):
        raise ValueError(f"pair indices out of range of {I} images")
    return match.match_batch(desc, valid, desc, valid, i1, i2, threshold,
                             ratio)


def compact_matches_np(m12_all: np.ndarray, max_matches: int):
    """Vectorised numpy analogue of ``match.matches_to_pairs`` over a
    (P, F) match table: returns (pairs (P, MM, 2) int32, pvalid (P, MM)
    bool, count (P,) int32).

    Where F < MM the row order is padded with zeros, as
    ``matches_to_pairs`` pads it; the JAX package's copy raises a
    broadcast error there."""
    P, F = m12_all.shape
    ism = m12_all >= 0
    order = np.argsort(~ism, axis=1, kind="stable")
    if F < max_matches:
        order = np.pad(order, ((0, 0), (0, max_matches - F)))
    rows = order[:, :max_matches].astype(np.int32)
    cols = m12_all[np.arange(P)[:, None], rows].astype(np.int32)
    count = np.minimum(ism.sum(1), max_matches).astype(np.int32)
    k = np.arange(max_matches, dtype=np.int32)
    pvalid = k[None, :] < count[:, None]
    pairs = np.stack(
        [np.where(pvalid, rows, 0), np.where(pvalid, cols, 0)], axis=-1
    )
    return pairs, pvalid, count
