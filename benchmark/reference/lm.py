"""The plain Schur-complement Levenberg-Marquardt solve both reference
solvers use.

A problem has K cameras with a C-dimensional tangent, L scalar landmarks
(inverse depths) and O observation rows, each tying an anchor camera, a
target camera and a landmark through R residuals.  ``normal_equations``
takes the residuals' Jacobian by forward mode through the retraction (2C+1
``jvp`` passes, one per tangent column), weights each row by the Huber
IRLS weight of its squared norm, and sums the normal equations with
``index_add_`` into dense blocks (the 2C+1 passes run as one, batched by
``vmap``).  ``damped_step`` eliminates the
landmarks and solves the damped reduced camera system by Cholesky.

The damping and the loops are the solve the configurations state: the
camera diagonal scaled by ``lam`` (``lam * diag(H_cc)``), the landmark
block by ``(1 + lam)``, frame 0's cameras pinned; lambda starts at 1e-4,
is divided by 3 on an accepted step and multiplied by 10 on a rejected
one; a step is accepted when the cost falls and stays finite; the loop
ends after ``max_iterations`` accepted steps, on a relative cost change
within ``function_tolerance``, or after 6 rejected tries in a row
(``lm_classic``: 6 tries at one linearisation; ``lm_fused``: 6
consecutive rejects, each try relinearising at the trial point).

Everything runs in the dtype of the state it is given.  The Jacobian
products and the Schur complement are matrix products, so ``tf32``
decides whether they round to TF32 on the card (the photometric
configuration's control).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch

MAX_RETRIES = 6
INIT_LAMBDA, MIN_LAMBDA, MAX_LAMBDA = 1e-4, 1e-12, 1e8
MIN_INV_DEPTH_HESSIAN = 1e-12


@dataclass
class Rows:
    """Observation rows: anchor and target camera, landmark (O,) int64,
    and the per-row constants the residual reads."""

    anchor: torch.Tensor
    target: torch.Tensor
    landmark: torch.Tensor
    const: dict


def huber(r2: torch.Tensor, delta: float):
    """(IRLS weight, 0.5 * rho) of squared row norms (Ceres' HuberLoss)."""
    s = torch.sqrt(torch.clamp(r2, min=1e-300))
    inl = r2 <= delta * delta
    w = torch.where(inl, torch.ones_like(r2), delta / s)
    rho = torch.where(inl, r2, 2.0 * delta * s - delta * delta)
    return w, 0.5 * rho


@contextlib.contextmanager
def tf32(on: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class SchurLM:
    """The solve of one problem family.

    ``residual(cams_a, cams_t, rho, const) -> (O, R)`` over rows, where
    ``cams_*`` are (O, P) camera parameter rows; ``retract(cams (n, P),
    delta (n, C)) -> cams``; ``delta`` the Huber threshold."""

    def __init__(self, residual, retract, C: int, delta: float,
                 fixed: torch.Tensor):
        self.residual, self.retract, self.C = residual, retract, C
        self.delta = delta
        self.free = (~fixed).to(torch.bool)

    def rows_residual(self, cams, rho, rows: Rows):
        return self.residual(cams[rows.anchor], cams[rows.target],
                             rho[rows.landmark], rows.const)

    def cost(self, cams, rho, rows: Rows) -> torch.Tensor:
        r = self.rows_residual(cams, rho, rows)
        return huber(torch.sum(r * r, dim=-1), self.delta)[1].sum()

    def normal_equations(self, cams, rho, rows: Rows):
        """(cost, H_cc (KC, KC), W (KC, L), H_pp (L,), g_c (KC,), g_p (L,))
        at the state ``(cams, rho)``."""
        C = self.C
        ca, ct = cams[rows.anchor], cams[rows.target]
        rl = rho[rows.landmark]
        O = rl.shape[0]

        def f(d):
            return self.residual(self.retract(ca, d[:, :C]),
                                 self.retract(ct, d[:, C:2 * C]),
                                 rl + d[:, 2 * C], rows.const)

        zero = rl.new_zeros((O, 2 * C + 1))
        basis = torch.eye(2 * C + 1, dtype=rl.dtype, device=rl.device)
        basis = basis[:, None, :].expand(2 * C + 1, O, 2 * C + 1)
        r = f(zero)
        J = torch.func.vmap(lambda e: torch.func.jvp(f, (zero,), (e,))[1])(
            basis).permute(1, 2, 0)                        # (O, R, 2C+1)
        r2 = torch.sum(r * r, dim=-1)
        w, rho_cost = huber(r2, self.delta)
        cost = rho_cost.sum()
        K, L = cams.shape[0], rho.shape[0]
        an, tn, lm = rows.anchor, rows.target, rows.landmark
        Ja, Jt, Jp = J[..., :C], J[..., C:2 * C], J[..., 2 * C]
        wJa, wJt, wJp = (w[:, None, None] * Ja, w[:, None, None] * Jt,
                         w[:, None] * Jp)
        blocks = torch.cat([
            torch.einsum("ori,orj->oij", wJa, Ja),
            torch.einsum("ori,orj->oij", wJa, Jt),
            torch.einsum("ori,orj->oij", wJt, Ja),
            torch.einsum("ori,orj->oij", wJt, Jt)])
        idx = torch.cat([an * K + an, an * K + tn, tn * K + an, tn * K + tn])
        H_cc = (r.new_zeros((K * K, C * C)).index_add_(
            0, idx, blocks.reshape(-1, C * C))
            .reshape(K, K, C, C).permute(0, 2, 1, 3).reshape(K * C, K * C))
        H_cp = r.new_zeros((K * L, C)).index_add_(
            0, torch.cat([an * L + lm, tn * L + lm]),
            torch.cat([torch.einsum("ori,or->oi", wJa, Jp),
                       torch.einsum("ori,or->oi", wJt, Jp)]))
        W = H_cp.reshape(K, L, C).permute(0, 2, 1).reshape(K * C, L)
        H_pp = r.new_zeros(L).index_add_(0, lm, (wJp * Jp).sum(-1))
        g_c = r.new_zeros((K, C)).index_add_(
            0, torch.cat([an, tn]),
            torch.cat([torch.einsum("ori,or->oi", wJa, r),
                       torch.einsum("ori,or->oi", wJt, r)])).reshape(-1)
        g_p = r.new_zeros(L).index_add_(0, lm, (wJp * r).sum(-1))
        return cost, (H_cc, W, H_pp, g_c, g_p)

    def damped_step(self, neq, lam: float):
        """(delta_c (K, C), delta_p (L,)); NaN where the damped reduced
        system is not positive definite."""
        H_cc, W, H_pp, g_c, g_p = neq
        C = self.C
        K = H_cc.shape[0] // C
        inv = 1.0 / (torch.clamp(H_pp, min=MIN_INV_DEPTH_HESSIAN)
                     * (1.0 + lam))
        Wi = W * inv[None, :]
        d = torch.clamp(torch.diagonal(H_cc), 1e-12, 1e32)
        S = H_cc + torch.diag(lam * d) - Wi @ W.T
        b = -(g_c - Wi @ g_p)
        m = self.free.to(S.dtype).repeat_interleave(C)
        S = S * m[:, None] * m[None, :] + torch.diag(1.0 - m)
        chol, info = torch.linalg.cholesky_ex(S)
        dc = torch.cholesky_solve((b * m)[:, None], chol)[:, 0] * m
        if int(info) != 0:
            dc = torch.full_like(dc, math.nan)
        dp = -(g_p + W.T @ dc) * inv
        return dc.reshape(K, C), dp


@dataclass
class Result:
    cams: torch.Tensor
    rho: torch.Tensor
    cost: float
    initial_cost: float
    iterations: int
    tries: int


def lm_classic(lm: SchurLM, cams, rho, rows: Rows, max_iterations: int,
               function_tolerance: float) -> Result:
    """One linearisation per iteration, then tries at growing lambda,
    each judged by a residual pass."""
    cost = float(lm.cost(cams, rho, rows))
    init, lam, iters, tries = cost, INIT_LAMBDA, 0, 0
    for _ in range(max_iterations):
        _, neq = lm.normal_equations(cams, rho, rows)
        accepted, n = False, 0
        while not accepted and n < MAX_RETRIES and lam <= MAX_LAMBDA:
            dc, dp = lm.damped_step(neq, lam)
            c_try = lm.retract(cams, dc)
            r_try = rho + dp
            new = float(lm.cost(c_try, r_try, rows))
            n += 1
            accepted = new < cost and math.isfinite(new)
            if not accepted:
                lam *= 10.0
        tries += n
        if not accepted:
            break
        small = abs(cost - new) <= function_tolerance * max(cost, 1e-300)
        cams, rho, cost = c_try, r_try, new
        lam = max(lam / 3.0, MIN_LAMBDA)
        iters += 1
        if small:
            break
    return Result(cams, rho, cost, init, iters, tries)


def lm_fused(lm: SchurLM, cams, rho, rows: Rows, max_iterations: int,
             function_tolerance: float) -> Result:
    """Each try relinearises at the trial point; the linearisation's cost
    is the accept test and, on acceptance, seeds the next step."""
    c0, neq = lm.normal_equations(cams, rho, rows)
    cost = init = float(c0)
    lam, iters, tries, rejects = INIT_LAMBDA, 0, 0, 0
    while iters < max_iterations and tries < max_iterations * MAX_RETRIES:
        dc, dp = lm.damped_step(neq, lam)
        c_try, r_try = lm.retract(cams, dc), rho + dp
        ct, neq_try = lm.normal_equations(c_try, r_try, rows)
        new = float(ct)
        tries += 1
        small = False
        if new < cost and math.isfinite(new):
            small = abs(cost - new) <= function_tolerance * max(cost, 1e-300)
            cams, rho, cost, neq = c_try, r_try, new, neq_try
            lam = max(lam / 3.0, MIN_LAMBDA)
            rejects = 0
            iters += 1
        else:
            lam *= 10.0
            rejects += 1
        if small or rejects >= MAX_RETRIES or lam > MAX_LAMBDA:
            break
    return Result(cams, rho, cost, init, iters, tries)
