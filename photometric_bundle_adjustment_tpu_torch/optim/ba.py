"""Bundle-adjustment problem and solver types, and the robust cost.

Port of the types of ``photometric_bundle_adjustment_tpu/optim/ba.py``:
the problem is struct-of-arrays with static shapes (K cameras, L scalar
inverse-depth landmarks, O observation rows with a validity mask for
padding), and the solver is configured by a plain tuple of constants.
Also the Huber weights and cost and the residual-cost pass of
``make_ba_step``; its scatter-add normal-equation build is not ported
(``optim/fused.py`` assembles the normal equations).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

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
    # fused-cost LM loop (optim.fused only): the build at each trial point
    # is the accept check, and on acceptance its normal equations seed the
    # next iteration; no separate residual pass runs
    cost_from_build: bool = False
    # the megakernel's bf16 tier (ops/pba_mega.py): sample a bf16 copy of
    # the image stack, taps and arithmetic in f32
    sample_bf16: bool = False


def _robust_weights(r2: torch.Tensor, delta: float) -> torch.Tensor:
    """Huber rho'(s) on squared block norms (Ceres HuberLoss semantics)."""
    if delta <= 0:
        return torch.ones_like(r2)
    sqrt_s = torch.sqrt(torch.clamp(r2, min=1e-300))
    return torch.where(r2 <= delta * delta, torch.ones_like(r2), delta / sqrt_s)


def _robust_cost(r2: torch.Tensor, delta: float) -> torch.Tensor:
    """0.5 sum rho(r2): the Huber cost of squared block norms (0-d)."""
    if delta <= 0:
        return 0.5 * torch.sum(r2)
    sqrt_s = torch.sqrt(torch.clamp(r2, min=1e-300))
    rho = torch.where(r2 <= delta * delta, r2,
                      2.0 * delta * sqrt_s - delta * delta)
    return 0.5 * torch.sum(rho)


def take_rows(tree, idx: torch.Tensor):
    """Every leaf of a tuple tree of tensors indexed by ``idx`` along its
    leading axis (the cameras or landmarks of each observation)."""
    return type(tree)(*(x[idx] for x in tree))


def make_residual_cost(residual_fn: Callable):
    """The residual-cost pass of the JAX package's ``make_ba_step``.

    ``residual_fn(cam_a, cam_c, rho, aux) -> (O, R)`` is batched over the
    observation axis: ``cam_a``/``cam_c`` hold the anchor and target
    camera of every observation, ``rho`` (O,) its inverse depth, ``aux``
    the per-observation constants.  Returns ``residual_cost(problem,
    cfg)``, the robust cost (0-d) over the valid observations."""

    def residual_cost(problem: BAProblem, cfg: BAConfig) -> torch.Tensor:
        o = problem.obs
        r = residual_fn(take_rows(problem.cam_states, o.anchor_cam),
                        take_rows(problem.cam_states, o.target_cam),
                        problem.inv_depth[o.landmark], o.aux)
        # mask by selection, not product: a padding row's NaN must not
        # poison the cost
        r = torch.where(o.valid[:, None] != 0, r, torch.zeros_like(r))
        return _robust_cost(torch.sum(r * r, dim=-1), cfg.huber_delta)

    return residual_cost


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
    tries: int = 0              # trial points evaluated
    builds: int = 0             # normal-equation builds (optim.fused)
    residual_passes: int = 0    # residual-only cost passes (optim.fused)
