"""Fused Schur-LM bundle-adjustment solver driven by host-precomputed plans.

Port of ``photometric_bundle_adjustment_tpu/optim/fused.py``, its dense
one-hot-lifting solver (``_make_dense_fused_ba_solver``): the same problem
layout (``ba.BAProblem``), LM semantics (damped trust region with
accept/reject, Huber IRLS, gauge masking) and normal equations.  The
assembly follows the gather/Gram-chunk plans of ``optim/schur_plan``; the
Schur complement uses the dense per-landmark coupling matrix M (L, K*C),
so that

  * the correction S_corr0 = M^T diag(inv_hpp) M is one matrix product and
    the back-substitution a matrix-vector product;
  * the damped system is analytic in lambda,
    S(lam) = H_cc + lam diag(H_cc) - S_corr0 / (1 + lam),
    so each LM retry costs one dense Cholesky of the (K*C, K*C) system.

Two plan types, two builds: a ``SchurPlan`` (any observation order,
``plan_for_problem``) runs ``build_chunk``; a ``DenseLmSchurPlan`` (the
slot-major order of ``densify_problem``) runs ``build_dense``.  Plans hold
int64 tensors on the problem's device.

The JAX package's entry-pair CPU solver (``optim/fused_host.py``) is not
ported (ROADMAP, "Not to port: ``fused_host``").  Matrix products run in
full f32: TF32 is off in every build and solve (``full_f32``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch.optim import ba
from photometric_bundle_adjustment_tpu_torch.optim.schur_plan import (
    ChunkPlan,
    DenseLmSchurPlan,
    SchurPlan,
    build_dense_lm_plan,
    build_schur_plan,
)


def plan_to(plan, device):
    """A plan (``SchurPlan`` or ``DenseLmSchurPlan``, numpy or tensor
    leaves) with int64 tensor leaves on ``device``."""
    if isinstance(plan, tuple):
        return type(plan)(*(plan_to(x, device) for x in plan))
    return torch.as_tensor(plan, device=device).long()


def plan_for_problem(problem: ba.BAProblem, **kwargs):
    """The chunked ``SchurPlan`` of a problem's observation graph, built on
    the host, as int64 tensors on the problem's device.  ``kwargs`` go to
    ``build_schur_plan`` (chunk sizes, ``pow2_buckets``)."""
    o = problem.obs
    K = problem.cam_states[0].shape[0]
    L = problem.inv_depth.shape[0]
    plan = build_schur_plan(
        o.anchor_cam.cpu().numpy(), o.target_cam.cpu().numpy(),
        o.landmark.cpu().numpy(), K, L,
        valid=o.valid.cpu().numpy() != 0, **kwargs,
    )
    return plan_to(plan, problem.inv_depth.device)


def densify_problem(problem: ba.BAProblem, **kwargs):
    """Host-side reorder of a problem into the slot-major landmark-dense
    layout.

    Returns ``(problem2, DenseLmSchurPlan)``: observation row ``s*L + l``
    of ``problem2`` is the s-th observation of landmark l (padding slots
    have valid=0 and copy row 0's constants), which turns every
    landmark-axis reduction of ``build_dense`` into a reshape and a sum
    over the leading slot axis.  Camera and landmark states are untouched;
    only the observation order differs.  ``kwargs`` go to
    ``build_dense_lm_plan``."""
    o = problem.obs
    K = problem.cam_states[0].shape[0]
    L = problem.inv_depth.shape[0]
    dev = problem.inv_depth.device
    an = o.anchor_cam.cpu().numpy()
    tn = o.target_cam.cpu().numpy()
    valid = o.valid.cpu().numpy()
    perm, plan = build_dense_lm_plan(
        an, tn, o.landmark.cpu().numpy(), K, L, valid=valid != 0, **kwargs
    )
    filled = perm >= 0
    S = plan.lm_cam.shape[0]
    take = torch.as_tensor(np.where(filled, perm, 0), device=dev)

    def idx(x):
        return torch.as_tensor(x, dtype=torch.int64, device=dev)

    obs2 = ba.BAObservations(
        anchor_cam=idx(np.where(filled, an[perm], 0)),
        target_cam=idx(np.where(filled, tn[perm], 0)),
        landmark=idx(np.tile(np.arange(L), S)),
        aux=ba.take_rows(o.aux, take),
        valid=torch.as_tensor(np.where(filled, valid[perm], 0),
                              dtype=o.valid.dtype, device=dev),
    )
    return problem._replace(obs=obs2), plan_to(plan, dev)


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


def _one_hot(idx, K: int, dtype):
    """one_hot with index K (the plans' dummy) mapping to a zero row."""
    return torch.nn.functional.one_hot(idx, K + 1)[..., :K].to(dtype)


def _cam_cc_blocks(J: torch.Tensor, pg: torch.Tensor, cc_rows4, K: int,
                   C: int):
    """H_cc (K*C, K*C) from camera-pair Gram chunks: the 2C x 2C Gram of
    each chunk's rows holds [Haa Hac; Hca Hcc] of its camera pair."""
    rows = J[pg]                                   # (NCp, Bp, R, 2C+1)
    rows2 = rows[..., : 2 * C].reshape(rows.shape[0], -1, 2 * C)
    G2 = torch.bmm(rows2.transpose(1, 2), rows2)   # (NCp, 2C, 2C)
    blocks = torch.stack(
        [G2[:, :C, :C], G2[:, :C, C:], G2[:, C:, :C], G2[:, C:, C:]], dim=1
    ).reshape(-1, C * C)
    H_cc = (
        torch.zeros((K * K + 1, C * C), dtype=J.dtype, device=J.device)
        .index_add_(0, cc_rows4.reshape(-1), blocks)[: K * K]
        .reshape(K, K, C, C)
    )
    return H_cc.permute(0, 2, 1, 3).reshape(K * C, K * C)


def _schur_terms(M, inv0, g_p):
    """S_corr0 = Mw^T M and rhs_corr0 = Mw^T g_p, Mw = diag(inv0) M, in
    full f32 (the caller's ``full_f32``)."""
    Mw = M * inv0[:, None]
    return Mw.T @ M, Mw.T @ g_p


def solve_lam(neq, lam: float, free_cam_mask: torch.Tensor,
              cfg: ba.BAConfig):
    """Damped reduced-camera solve + inverse-depth back-substitution: the
    cheap per-lambda retry on fixed normal equations
    ``(H_cc_mat, S_corr0, rhs_corr0, H_pp, g_c, g_p, M, inv0)``.

    Where the damped system is not positive definite (``cholesky_ex``
    reports it), the deltas are NaN, so the trial cost is NaN and the LM
    loop rejects the try, as the reference's NaN Cholesky does."""
    H_cc_mat, S_corr0, rhs_corr0, H_pp, g_c, g_p, M, inv0 = neq
    KC = H_cc_mat.shape[0]
    K = free_cam_mask.shape[0]
    C_ = KC // K
    dtype = g_c.dtype
    d_cc = torch.clamp(torch.diagonal(H_cc_mat), 1e-12, 1e32)
    S = H_cc_mat + torch.diag(lam * d_cc) - S_corr0 / (1.0 + lam)
    rhs = -(g_c.reshape(-1) - rhs_corr0 / (1.0 + lam))
    mask = free_cam_mask.to(dtype).repeat_interleave(C_)
    S = S * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
    chol, info = torch.linalg.cholesky_ex(S)
    delta_c = torch.cholesky_solve((rhs * mask)[:, None], chol)[:, 0] * mask
    delta_c = torch.where(info == 0, delta_c, torch.full_like(delta_c, math.nan))
    delta_p = -(g_p + M @ delta_c) * inv0 / (1.0 + lam)
    return delta_c.reshape(K, C_), delta_p


@contextlib.contextmanager
def full_f32():
    """Full-f32 matrix products: the Schur Gram and the Cholesky must not
    run in TF32 (reduced precision perturbs the solve through the
    ill-conditioned reduced system)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def make_fused_ba_solver(residual_fn: Callable, cam_retract: Callable,
                         cam_tangent_dim: int, rj_fn: Callable):
    """Returns ``solve(problem, plan, cfg) -> (problem, BAResult)``, with
    ``.build(problem, plan, cfg) -> (cost, neq)`` and ``.solve_lam(neq,
    lam, free, cfg)`` exposed.

    ``residual_fn(cam_a, cam_c, rho, aux) -> r (O, R)`` and ``rj_fn(...)
    -> (r (O, R), J (O, R, 2C+1) or (O, R*(2C+1)))`` are batched over the
    observation axis (see ``ba.make_residual_cost``); J's columns are
    [anchor tangent (C), target tangent (C), inverse depth].
    ``cam_retract(cams, delta (K, C))`` is batched over cameras.  The
    JAX package's ``jacfwd`` default for ``rj_fn`` is not ported (ROADMAP
    queue 1).  The solve runs on the device of the problem and plan."""
    C = cam_tangent_dim
    W = 2 * C + 1
    res_cost = ba.make_residual_cost(residual_fn)

    def _pad_obs(o: ba.BAObservations) -> ba.BAObservations:
        """Append npad = 8 - O % 8 zero rows (valid=0): the plans' dummy
        index O points at the first of them."""
        npad = 8 - o.valid.shape[0] % 8

        def pad1(x):
            return torch.cat([x, x.new_zeros((npad,) + tuple(x.shape[1:]))])

        return ba.BAObservations(
            anchor_cam=pad1(o.anchor_cam), target_cam=pad1(o.target_cam),
            landmark=pad1(o.landmark), aux=type(o.aux)(*map(pad1, o.aux)),
            valid=pad1(o.valid),
        )

    def _scaled_jacobians(problem: ba.BAProblem, cfg: ba.BAConfig):
        """sqrt(Huber weight)-scaled Jacobian rows (O', R, 2C+1),
        residuals (O', R) and the robust cost, over the observations and
        the zero padding rows of ``_pad_obs``."""
        o = _pad_obs(problem.obs)
        r, J = rj_fn(ba.take_rows(problem.cam_states, o.anchor_cam),
                     ba.take_rows(problem.cam_states, o.target_cam),
                     problem.inv_depth[o.landmark], o.aux)
        J = J.reshape(r.shape[0], r.shape[1], W)
        vmask = o.valid[:, None] != 0
        r = torch.where(vmask, r, torch.zeros_like(r))
        J = torch.where(vmask[:, :, None], J, torch.zeros_like(J))
        r2 = torch.sum(r * r, dim=-1)
        w = ba._robust_weights(r2, cfg.huber_delta) * o.valid
        cost = ba._robust_cost(r2, cfg.huber_delta)
        sw = torch.sqrt(w)
        return cost, J * sw[:, None, None], r * sw[:, None]

    def build_chunk(problem: ba.BAProblem, plan: SchurPlan,
                    cfg: ba.BAConfig):
        """Normal-equation assembly from the chunked segment-sum plans
        (any observation order)."""
        K = problem.cam_states[0].shape[0]
        L = problem.inv_depth.shape[0]
        cost, Jsw, rsw = _scaled_jacobians(problem, cfg)
        dtype = Jsw.dtype
        H_cc_mat = _cam_cc_blocks(Jsw, plan.pg, plan.cc_rows4, K, C)

        # thin couplings A[o] = Jsw[o]^T [swJp, swr]: (O', 2C+1, 2)
        right = torch.stack([Jsw[:, :, 2 * C], rsw], dim=-1)
        A = torch.einsum("ori,ors->ois", Jsw, right)

        # landmark reductions: anchor-merged Hap, H_pp, g_p in one pass
        pay_l = torch.cat([A[:, :C, 0], A[:, 2 * C:, 0], A[:, 2 * C:, 1]],
                          dim=1)
        red_l = _chunk_sum(pay_l, plan.lm, L)
        anchor_v, H_pp, g_p = red_l[:, :C], red_l[:, C], red_l[:, C + 1]
        g_c = (_chunk_sum(A[:, :C, 1], plan.gc_a, K)
               + _chunk_sum(A[:, C:2 * C, 1], plan.gc_t, K))

        inv0 = problem.lm_valid.to(dtype) / torch.clamp(
            H_pp, min=cfg.min_inv_depth_hessian)
        # M (L, K*C): each landmark's target couplings lifted to their
        # camera's column block, plus the anchor coupling
        oh = _one_hot(plan.lm_cam, K, dtype)                  # (NC, B, K)
        rows_t = A[:, C:2 * C, 0][plan.lm.gidx]                # (NC, B, C)
        part = torch.bmm(oh.transpose(1, 2), rows_t)          # (NC, K, C)
        M = (torch.zeros((L + 1, K * C), dtype=dtype, device=Jsw.device)
             .index_add_(0, plan.lm.rows, part.reshape(-1, K * C))[:L])
        oh_a = _one_hot(plan.anchor_cam_of_lm, K, dtype)      # (L, K)
        M = M + (oh_a[:, :, None] * anchor_v[:, None, :]).reshape(L, K * C)

        S_corr0, rhs_corr0 = _schur_terms(M, inv0, g_p)
        return cost, (H_cc_mat, S_corr0, rhs_corr0, H_pp, g_c, g_p, M, inv0)

    def build_dense(problem: ba.BAProblem, plan: DenseLmSchurPlan,
                    cfg: ba.BAConfig):
        """Normal-equation assembly for the slot-major layout of
        ``densify_problem``: landmark reductions are reshapes to (S, L, .)
        and sums over the slot axis; g_c and M are index-adds by camera
        (padding rows carry camera K, which lands in a dropped row)."""
        K = problem.cam_states[0].shape[0]
        L = problem.inv_depth.shape[0]
        S_ = plan.lm_cam.shape[0]
        cost, Jsw, rsw = _scaled_jacobians(problem, cfg)
        dtype, dev = Jsw.dtype, Jsw.device
        H_cc_mat = _cam_cc_blocks(Jsw, plan.pg, plan.cc_rows4, K, C)

        # thin couplings A0 = J^T J_rho, A1 = J^T r: (O', 2C+1) each
        A0 = torch.einsum("orw,or->ow", Jsw, Jsw[:, :, 2 * C])
        A1 = torch.einsum("orw,or->ow", Jsw, rsw)
        A0s = A0[: S_ * L].reshape(S_, L, W)
        red0 = A0s.sum(0)                                     # (L, W)
        anchor_v, H_pp = red0[:, :C], red0[:, 2 * C]
        g_p = A1[: S_ * L, 2 * C].reshape(S_, L).sum(0)

        Av = A1[: S_ * L]
        g_c = (torch.zeros((K + 1, C), dtype=dtype, device=dev)
               .index_add_(0, plan.obs_anchor_cam, Av[:, :C])
               .index_add_(0, plan.obs_target_cam, Av[:, C:2 * C])[:K])

        inv0 = problem.lm_valid.to(dtype) / torch.clamp(
            H_pp, min=cfg.min_inv_depth_hessian)
        lm_base = torch.arange(L, device=dev) * (K + 1)
        M = (torch.zeros((L * (K + 1), C), dtype=dtype, device=dev)
             .index_add_(0, (lm_base + plan.lm_cam).reshape(-1),
                         A0s[:, :, C:2 * C].reshape(-1, C))
             .index_add_(0, lm_base + plan.anchor_cam_of_lm, anchor_v))
        M = M.reshape(L, K + 1, C)[:, :K].reshape(L, K * C)

        S_corr0, rhs_corr0 = _schur_terms(M, inv0, g_p)
        return cost, (H_cc_mat, S_corr0, rhs_corr0, H_pp, g_c, g_p, M, inv0)

    def build(problem: ba.BAProblem, plan, cfg: ba.BAConfig):
        """One normal-equation assembly; everything lambda-independent."""
        with full_f32():
            if isinstance(plan, DenseLmSchurPlan):
                return build_dense(problem, plan, cfg)
            return build_chunk(problem, plan, cfg)

    def _solve_lam(neq, lam, free, cfg: ba.BAConfig):
        with full_f32():
            return solve_lam(neq, lam, free, cfg)

    def apply_step(problem: ba.BAProblem, delta_c, delta_p):
        return problem._replace(
            cam_states=cam_retract(problem.cam_states, delta_c),
            inv_depth=problem.inv_depth + delta_p)

    def solve_cost_from_build(problem: ba.BAProblem, plan, cfg: ba.BAConfig):
        """Fused-cost LM loop, one host sync per try: each try solves the
        damped system from the carried normal equations and builds at the
        trial point; the build's cost is the accept check and, on
        acceptance, its normal equations seed the next iteration.  Same
        accept criterion, lambda schedule (x10 per reject, /3 on accept)
        and termination as ``solve_classic``."""
        free = ~problem.fixed_cams
        init_cost, neq = build(problem, plan, cfg)
        cost, cost_f = init_cost, float(init_cost)
        lam = float(cfg.init_lambda)
        rejects = iters = tries = 0
        while (iters < cfg.max_iterations
               and tries < cfg.max_iterations * cfg.max_retries):
            dc, dp = _solve_lam(neq, lam, free, cfg)
            p_try = apply_step(problem, dc, dp)
            cost_try, neq_try = build(p_try, plan, cfg)
            c_try = float(cost_try)
            tries += 1
            ok = c_try < cost_f and math.isfinite(c_try)
            small = False
            if ok:
                small = abs(cost_f - c_try) <= (
                    cfg.function_tolerance * max(cost_f, 1e-300))
                problem, cost, cost_f, neq = p_try, cost_try, c_try, neq_try
                lam = max(lam / 3.0, cfg.min_lambda)
                rejects = 0
                iters += 1
            else:
                lam *= 10.0
                rejects += 1
            if small or rejects >= cfg.max_retries or lam > cfg.max_lambda:
                break
        return problem, ba.BAResult(
            cost=cost, initial_cost=init_cost, iterations=iters, lam=lam,
            tries=tries, builds=tries + 1)

    def solve_classic(problem: ba.BAProblem, plan, cfg: ba.BAConfig):
        """Classic LM loop: one build per iteration, then tries at growing
        lambda, each a damped solve and a residual pass (one host sync),
        until one lowers the cost.  Stops when no try is accepted, the
        cost change is within ``function_tolerance``, or after
        ``max_iterations`` iterations."""
        free = ~problem.fixed_cams
        with full_f32():
            init_cost = res_cost(problem, cfg)
        cost, cost_f = init_cost, float(init_cost)
        lam = float(cfg.init_lambda)
        iters = tries = builds = 0
        for _ in range(cfg.max_iterations):
            _, neq = build(problem, plan, cfg)
            builds += 1
            accepted, n_tries = False, 0
            while (not accepted and n_tries < cfg.max_retries
                   and lam <= cfg.max_lambda):
                dc, dp = _solve_lam(neq, lam, free, cfg)
                p_try = apply_step(problem, dc, dp)
                with full_f32():
                    new_cost = res_cost(p_try, cfg)
                c_new = float(new_cost)
                n_tries += 1
                accepted = c_new < cost_f and math.isfinite(c_new)
                if not accepted:
                    lam *= 10.0
            tries += n_tries
            if not accepted:
                break
            small = abs(cost_f - c_new) <= (
                cfg.function_tolerance * max(cost_f, 1e-300))
            problem, cost, cost_f = p_try, new_cost, c_new
            lam = max(lam / 3.0, cfg.min_lambda)
            iters += 1
            if small:
                break
        return problem, ba.BAResult(
            cost=cost, initial_cost=init_cost, iterations=iters, lam=lam,
            tries=tries, builds=builds, residual_passes=tries + 1)

    def solve(problem: ba.BAProblem, plan, cfg: ba.BAConfig = ba.BAConfig()):
        if cfg.cost_from_build:
            return solve_cost_from_build(problem, plan, cfg)
        return solve_classic(problem, plan, cfg)

    solve.build = build
    solve.solve_lam = _solve_lam
    return solve
