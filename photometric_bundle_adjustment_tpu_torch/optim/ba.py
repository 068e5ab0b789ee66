"""Bundle-adjustment problem and solver types.

Port of the types of ``photometric_bundle_adjustment_tpu/optim/ba.py``:
the problem is struct-of-arrays with static shapes (K cameras, L scalar
inverse-depth landmarks, O observation rows with a validity mask for
padding), and the solver is configured by a plain tuple of constants.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BAObservations(NamedTuple):
    """Flat observation table (padding rows have ``valid == 0``)."""

    anchor_cam: torch.Tensor  # (O,) int64 camera index of the landmark's anchor
    target_cam: torch.Tensor  # (O,) int64 camera index of this observation
    landmark: torch.Tensor    # (O,) int64 landmark index
    aux: tuple                # per-observation constants, leaves (O, ...)
    valid: torch.Tensor       # (O,) float, 1 for a real observation


class BAProblem(NamedTuple):
    cam_states: tuple         # leaves (K, ...)
    inv_depth: torch.Tensor   # (L,)
    obs: BAObservations
    fixed_cams: torch.Tensor  # (K,) bool, gauge fixing
    lm_valid: torch.Tensor    # (L,) bool, padding landmarks are False


class BAConfig(NamedTuple):
    max_iterations: int = 20
    huber_delta: float = 1.0          # <= 0 means squared loss
    init_lambda: float = 1e-4
    min_lambda: float = 1e-12
    max_lambda: float = 1e8
    function_tolerance: float = 1e-10
    max_retries: int = 6              # consecutive rejected tries
    min_inv_depth_hessian: float = 1e-12
    # bf16 patch sampling in the megakernel: not ported yet (ROADMAP,
    # "sample_bf16 tier"); the solver raises if it is set
    sample_bf16: bool = False


def problem_to(tree, device):
    """Copy of a problem (or any tuple tree of tensors) on ``device``."""
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, tuple):
        return type(tree)(*(problem_to(x, device) for x in tree))
    return tree


class BAResult(NamedTuple):
    cost: torch.Tensor          # final robust cost (0-d)
    initial_cost: torch.Tensor  # robust cost at the start (0-d)
    iterations: int             # accepted LM steps
    lam: float                  # final damping
    tries: int = 0              # normal-equation builds at trial points
