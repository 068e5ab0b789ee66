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
    2 delta sqrt(s) - delta^2 (Ceres HuberLoss convention).  Blocks run
    along the last axis; leading axes are batch axes."""
    rb = r.reshape(r.shape[:-1] + (-1, block_size))
    s = torch.sum(rb * rb, dim=-1)
    sqrt_s = torch.sqrt(torch.clamp(s, min=1e-300))
    w = torch.where(s <= delta * delta, torch.ones_like(s), delta / sqrt_s)
    return torch.sqrt(w).repeat_interleave(block_size, dim=-1)


def huber_cost(r: torch.Tensor, delta: float, block_size: int) -> torch.Tensor:
    """0.5 sum rho(s) over the last axis of r."""
    rb = r.reshape(r.shape[:-1] + (-1, block_size))
    s = torch.sum(rb * rb, dim=-1)
    sqrt_s = torch.sqrt(torch.clamp(s, min=1e-300))
    rho = torch.where(s <= delta * delta, s, 2.0 * delta * sqrt_s - delta * delta)
    return 0.5 * torch.sum(rho, dim=-1)


def _cost_of(r: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """The cost of the residuals along the last axis of r."""
    if cfg.huber_delta > 0:
        return huber_cost(r, cfg.huber_delta, cfg.block_size)
    return 0.5 * torch.sum(r * r, dim=-1)


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


def lm_solve_batched(residual_fn: Callable, params: torch.Tensor,
                     retract: Callable, tangent_dim: int,
                     cfg: LMConfig = LMConfig(),
                     fixed_mask: torch.Tensor | None = None):
    """``lm_solve`` on B independent problems at once: what
    ``jax.vmap(lm_solve)`` computes.

    ``params`` (B, P), ``residual_fn`` (B, P) -> (B, R) row by row,
    ``retract`` (B, P), (B, D) -> (B, P).  Every element keeps its own
    lambda, cost, iteration count and done flag; an element whose loop
    condition fails is frozen, as a vmapped ``while_loop`` freezes it.
    The inner loop's up to 8 tries per element (lambda x4 on each
    reject, while lambda <= max_lambda) do not depend on each other's
    outcome but for the stop, so all 8 are evaluated at once (the solves
    batched, the retraction and the residual vmapped over the try axis)
    and each element takes its first accepted try, which is what
    ``lm_solve`` re-takes; no try syncs the host.  Powers of 4 scale
    lambda exactly, so the tried lambdas are ``lm_solve``'s.  The stop
    tests are ``lm_solve``'s.  J comes from ``tangent_dim`` forward-mode
    passes, vmapped over the tangent basis.  The host syncs once per
    outer iteration, to stop when no element is left.

    Returns ``(params (B, P), LMResult)`` with (B,) tensors as fields."""
    D = tangent_dim
    r0 = residual_fn(params)
    B, dtype, dev = r0.shape[0], r0.dtype, r0.device
    zeros = torch.zeros(B, D, dtype=dtype, device=dev)
    free = (torch.ones(D, dtype=dtype, device=dev) if fixed_mask is None
            else (~fixed_mask.to(dev)).to(dtype))
    basis = torch.eye(D, dtype=dtype, device=dev)[:, None, :].expand(D, B, D)

    def weighted_r_J(p):
        r = residual_fn(p)

        def column(t):
            return torch.func.jvp(lambda d: residual_fn(retract(p, d)),
                                  (zeros,), (t,))[1]

        J = torch.func.vmap(column)(basis).permute(1, 2, 0)   # (B, R, D)
        if cfg.huber_delta > 0:
            w = huber_weights(r, cfg.huber_delta, cfg.block_size)
            r = r * w
            J = J * w[..., None]
        return r, J * free

    tries = 8
    scale = 4.0 ** torch.arange(tries, dtype=dtype, device=dev)[:, None]

    def try_steps(p, H, g, diag, lam):
        """The 8 tries at lambda 4^k lam: (lambdas (8, B), params (8, B,
        P), steps (8, B, D), costs (8, B))."""
        lams = lam * scale
        A = (H + torch.diag_embed(lams[..., None] * diag)
             + torch.diag(1e-32 + (1.0 - free)))
        rhs = g[..., None].expand(A.shape[:-1] + (1,))
        delta = -torch.linalg.solve_ex(A, rhs)[0][..., 0] * free
        p_try = torch.func.vmap(retract, in_dims=(None, 0))(p, delta)
        cost = _cost_of(torch.func.vmap(residual_fn)(p_try), cfg)
        return lams, p_try, delta, cost

    rows = torch.arange(B, device=dev)
    init_cost = _cost_of(r0, cfg)
    p, cost = params, init_cost
    lam = torch.full((B,), cfg.init_lambda, dtype=dtype, device=dev)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    gmax = torch.full((B,), math.inf, dtype=dtype, device=dev)
    for _ in range(cfg.max_iterations):
        act = ~done & (it < cfg.max_iterations)
        if not bool(act.any()):
            break
        r, J = weighted_r_J(p)
        g = torch.einsum("brd,br->bd", J, r)
        H = J.transpose(1, 2) @ J
        diag = torch.clamp(torch.diagonal(H, dim1=-2, dim2=-1), 1e-12, 1e32)
        gmax_new = torch.amax(torch.abs(g) * free, dim=-1)

        # the inner loop: lambda raised until a try lowers the cost
        # (bounded); the tries run while lambda <= max_lambda, and the
        # first that lowers the cost is taken
        lams, p_try, delta, new_cost = try_steps(p, H, g, diag, lam)
        tried = lams <= cfg.max_lambda
        ok = (new_cost < cost) & torch.isfinite(new_cost) & tried
        accepted = ok.any(0)
        k = torch.argmax(ok.to(torch.int8), dim=0)
        lam_i = torch.where(accepted, lams[k, rows],
                            lam * 4.0 ** tried.sum(0).to(dtype))
        p_acc, delta_acc, acc_cost = p_try[k, rows], delta[k, rows], \
            new_cost[k, rows]
        cost_new = torch.where(accepted, acc_cost, cost)
        small_decrease = torch.abs(cost - cost_new) <= (
            cfg.function_tolerance * torch.clamp(cost, min=1e-300))
        small_step = torch.linalg.norm(delta_acc, dim=-1) <= \
            cfg.parameter_tolerance
        done_new = (~accepted | (gmax_new <= cfg.gradient_tolerance)
                    | (accepted & (small_decrease | small_step))
                    | (it + 1 >= cfg.max_iterations))
        take = act & accepted
        p = torch.where(take[:, None], p_acc, p)
        cost = torch.where(take, acc_cost, cost)
        lam = torch.where(act, torch.where(
            accepted, torch.clamp(lam_i / 4.0, min=cfg.min_lambda), lam_i),
            lam)
        gmax = torch.where(act, gmax_new, gmax)
        done = torch.where(act, done_new, done)
        it = it + act.to(it.dtype)
    return p, LMResult(cost=cost, initial_cost=init_cost, iterations=it,
                       lam=lam, grad_max=gmax)
