"""Chunked segment sums for plan-based normal-equation assembly.

Port of ``_chunk_sum`` from ``photometric_bundle_adjustment_tpu/optim/fused.py``,
the one piece of that module the photometric chunk build uses.
"""

from __future__ import annotations

import torch

from photometric_bundle_adjustment_tpu_torch.optim.schur_plan import ChunkPlan


def _chunk_sum(payload: torch.Tensor, plan: ChunkPlan, n_rows: int):
    """payload (N+1, D) with zero last row -> (n_rows, D).

    ``plan.gidx`` (NC, B) gathers payload rows that are summed per chunk;
    ``plan.rows`` (NC,) scatters each chunk sum to its output row (row
    ``n_rows`` is the dropped dummy).  Both are int64 tensors on the
    payload's device."""
    partial = payload[plan.gidx].sum(dim=1)                   # (NC, D)
    out = torch.zeros((n_rows + 1, payload.shape[1]), dtype=payload.dtype,
                      device=payload.device)
    return out.index_add_(0, plan.rows, partial)[:n_rows]
