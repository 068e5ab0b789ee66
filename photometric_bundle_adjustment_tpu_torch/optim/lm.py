"""Damped Levenberg-Marquardt on product manifolds.

Port of ``photometric_bundle_adjustment_tpu/optim/lm.py``, the generic
small-problem solver (the reference's Ceres autodiff NLLS with a local
parameterization, src/test_ceres_se3.cpp:69-76, calibration.cpp:410-418).
The caller supplies

  * ``params``: a tensor or a tuple tree of tensors;
  * ``retract(params, delta)``: maps a flat tangent vector (D,) back onto
    the manifold (e.g. right-plus T * exp(dx) per pose block);
  * ``residual_fn(params)``: the flat residual vector (R,).

J is taken through ``residual_fn(retract(params, delta))`` at delta = 0
with ``torch.func.jacfwd``, so it is the minimal-coordinate Jacobian.
Robustification follows Ceres' loss in its IRLS form: residual blocks of
``block_size`` are reweighted by sqrt(rho'(s)) with Huber rho, and the
cost is 0.5 sum rho(s).  The loop runs on the host, one host sync per
try; the inner lambda loop (x4 per reject, up to 8 tries) and the
stopping tests are the JAX package's.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class LMConfig(NamedTuple):
    max_iterations: int = 20
    function_tolerance: float = 1e-12
    gradient_tolerance: float = 1e-14
    parameter_tolerance: float = 1e-14
    init_lambda: float = 1e-4
    min_lambda: float = 1e-14
    max_lambda: float = 1e10
    # Huber loss parameter; <= 0 disables robustification
    huber_delta: float = -1.0
    # residual block size used for robust weighting (2 = pixel residuals)
    block_size: int = 2


class LMResult(NamedTuple):
    cost: torch.Tensor          # final cost 0.5 sum rho(s) (0-d)
    initial_cost: torch.Tensor  # (0-d)
    iterations: int             # outer iterations run
    lam: float                  # final damping
    grad_max: float             # max |g| over free directions, last iteration


def huber_weights(r: torch.Tensor, delta: float, block_size: int) -> torch.Tensor:
    """Per-residual IRLS weights sqrt(rho'(s)) for Huber rho on squared block
    norms s = ||r_block||^2; rho(s) = s for s <= delta^2 else
    2 delta sqrt(s) - delta^2 (Ceres HuberLoss convention)."""
    rb = r.reshape(-1, block_size)
    s = torch.sum(rb * rb, dim=-1)
    sqrt_s = torch.sqrt(torch.clamp(s, min=1e-300))
    w = torch.where(s <= delta * delta, torch.ones_like(s), delta / sqrt_s)
    return torch.sqrt(w).repeat_interleave(block_size)


def huber_cost(r: torch.Tensor, delta: float, block_size: int) -> torch.Tensor:
    rb = r.reshape(-1, block_size)
    s = torch.sum(rb * rb, dim=-1)
    sqrt_s = torch.sqrt(torch.clamp(s, min=1e-300))
    rho = torch.where(s <= delta * delta, s, 2.0 * delta * sqrt_s - delta * delta)
    return 0.5 * torch.sum(rho)


def _cost_of(r: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    if cfg.huber_delta > 0:
        return huber_cost(r, cfg.huber_delta, cfg.block_size)
    return 0.5 * torch.sum(r * r)


def lm_solve(residual_fn: Callable, params, retract: Callable,
             tangent_dim: int, cfg: LMConfig = LMConfig(),
             fixed_mask: torch.Tensor | None = None):
    """Minimise 0.5 sum rho(residual_fn(params)^2) over the manifold, on
    the device of the residuals.

    ``fixed_mask``: optional bool (D,), tangent directions held constant
    (gauge fixing).  Returns ``(params, LMResult)``."""
    D = tangent_dim
    r0 = residual_fn(params)
    dtype, dev = r0.dtype, r0.device
    zeros = torch.zeros(D, dtype=dtype, device=dev)
    free = (torch.ones(D, dtype=dtype, device=dev) if fixed_mask is None
            else (~fixed_mask.to(dev)).to(dtype))

    def weighted_r_J(p):
        r = residual_fn(p)
        J = torch.func.jacfwd(lambda d: residual_fn(retract(p, d)))(zeros)
        if cfg.huber_delta > 0:
            w = huber_weights(r, cfg.huber_delta, cfg.block_size)
            r = r * w
            J = J * w[:, None]
        return r, J * free[None, :]

    def try_step(p, H, g, diag, lam):
        A = H + torch.diag(lam * diag) + torch.diag(1e-32 + (1.0 - free))
        delta = -torch.linalg.solve(A, g) * free
        return retract(p, delta), delta

    init_cost = _cost_of(r0, cfg)
    p, cost, cost_f = params, init_cost, float(init_cost)
    lam = float(cfg.init_lambda)
    it, gmax = 0, math.inf
    while it < cfg.max_iterations:
        r, J = weighted_r_J(p)
        g = J.T @ r
        H = J.T @ J
        diag = torch.clamp(torch.diagonal(H), 1e-12, 1e32)
        gmax = float(torch.max(torch.abs(g) * free))

        # inner loop: raise lambda until a try lowers the cost (bounded)
        accepted, tries = False, 0
        while not accepted and tries < 8 and lam <= cfg.max_lambda:
            p_try, _ = try_step(p, H, g, diag, lam)
            new_cost = _cost_of(residual_fn(p_try), cfg)
            c_new = float(new_cost)
            accepted = c_new < cost_f and math.isfinite(c_new)
            if not accepted:
                lam *= 4.0
            tries += 1
        small_decrease = small_step = False
        if accepted:
            # re-take the step at the accepted lambda
            p, delta = try_step(p, H, g, diag, lam)
            cost = _cost_of(residual_fn(p), cfg)
            c_acc = float(cost)
            small_decrease = abs(cost_f - c_acc) <= (
                cfg.function_tolerance * max(cost_f, 1e-300))
            small_step = float(torch.linalg.norm(delta)) <= \
                cfg.parameter_tolerance
            cost_f = c_acc
            lam = max(lam / 4.0, cfg.min_lambda)
        it += 1
        if (not accepted or gmax <= cfg.gradient_tolerance
                or small_decrease or small_step):
            break
    return p, LMResult(cost=cost, initial_cost=init_cost, iterations=it,
                       lam=lam, grad_max=gmax)
