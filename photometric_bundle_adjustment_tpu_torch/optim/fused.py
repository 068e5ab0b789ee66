"""Fused Schur-LM bundle-adjustment solver driven by precomputed plans.

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
int64 tensors on the problem's device, where ``optim/schur_plan_torch``
builds them.

The JAX package's entry-pair CPU solver (``optim/fused_host.py``) is not
ported (ROADMAP, "Not to port: ``fused_host``").  Matrix products run in
full f32: TF32 is off in every build and solve (``full_f32``).
"""

from __future__ import annotations

from typing import Callable

import torch

from photometric_bundle_adjustment_tpu_torch.optim import ba, schur_plan_torch
from photometric_bundle_adjustment_tpu_torch.optim.ba import full_f32
from photometric_bundle_adjustment_tpu_torch.optim.schur_plan import (
    ChunkPlan,
    DenseLmSchurPlan,
    SchurPlan,
    SegmentTree,
)


def plan_to(plan, device):
    """A plan (``SchurPlan`` or ``DenseLmSchurPlan``, numpy or tensor
    leaves) with int64 tensor leaves on ``device``."""
    if type(plan) is tuple:
        return tuple(plan_to(x, device) for x in plan)
    if isinstance(plan, tuple):
        return type(plan)(*(plan_to(x, device) for x in plan))
    return torch.as_tensor(plan, device=device).long()


def plan_for_problem(problem: ba.BAProblem, **kwargs):
    """The chunked ``SchurPlan`` of a problem's observation graph, built on
    the problem's device (``schur_plan_torch.build_schur_plan``) as int64
    tensors.  ``kwargs`` go to the builder (chunk sizes,
    ``pow2_buckets``, ``tracks``)."""
    o = problem.obs
    return schur_plan_torch.build_schur_plan(
        o.anchor_cam, o.target_cam, o.landmark, ba.num_cams(problem),
        problem.inv_depth.shape[0], valid=o.valid != 0, **kwargs)


def densify_problem(problem: ba.BAProblem, **kwargs):
    """Reorder a problem into the slot-major landmark-dense layout, on its
    device.

    Returns ``(problem2, DenseLmSchurPlan)``: observation row ``s*L + l``
    of ``problem2`` is the s-th observation of landmark l (padding slots
    have valid=0 and copy row 0's constants), which turns every
    landmark-axis reduction of ``build_dense`` into a reshape and a sum
    over the leading slot axis.  Camera and landmark states are untouched;
    only the observation order differs.  ``kwargs`` go to
    ``schur_plan_torch.build_dense_lm_plan``."""
    o = problem.obs
    L = problem.inv_depth.shape[0]
    perm, plan = schur_plan_torch.build_dense_lm_plan(
        o.anchor_cam, o.target_cam, o.landmark, ba.num_cams(problem), L,
        valid=o.valid != 0, **kwargs)
    filled = perm >= 0
    take = torch.where(filled, perm, 0)
    obs2 = ba.BAObservations(
        anchor_cam=torch.where(filled, o.anchor_cam[take], 0),
        target_cam=torch.where(filled, o.target_cam[take], 0),
        landmark=torch.arange(L, device=perm.device).repeat(
            plan.lm_cam.shape[0]),
        aux=ba.take_rows(o.aux, take),
        valid=torch.where(filled, o.valid[take], 0).to(o.valid.dtype),
    )
    return problem._replace(obs=obs2), plan


# the bytes of one level's gathered chunk values, (chunks, B, D), above
# which ``tree_sum`` gathers and sums them a block of chunks at a time: a
# level pads every chunk to B rows, so wide rows of few values each (the
# camera lift of a 1,024-camera problem: 98,304 chunks of 2 rows of 6,144)
# would gather 38.7 GB at once
TREE_SUM_BLOCK_BYTES = 1 << 30


def _level_sums(values: torch.Tensor, multi: torch.Tensor) -> torch.Tensor:
    """``values[multi].sum(dim=1)``, in blocks of chunks whose gathered
    values stay within ``TREE_SUM_BLOCK_BYTES``."""
    per_chunk = multi.shape[1] * values.shape[1] * values.element_size()
    n = max(1, TREE_SUM_BLOCK_BYTES // per_chunk)
    if multi.shape[0] <= n:
        return values[multi].sum(dim=1)
    return torch.cat([values[multi[i:i + n]].sum(dim=1)
                      for i in range(0, multi.shape[0], n)])


def tree_sum(values: torch.Tensor, tree: SegmentTree) -> torch.Tensor:
    """values (N, D) summed into the output rows of ``tree`` (R, D) in the
    tree's fixed order: gathers and sums over a chunk axis, no
    scatter-add, so the result repeats bit for bit on the card."""
    values = torch.cat([values, values.new_zeros((1, values.shape[1]))])
    for single, multi in tree.levels:
        values = torch.cat([values[single], _level_sums(values, multi)])
    return values[tree.pick]


def _chunk_sum(payload: torch.Tensor, plan: ChunkPlan, n_rows: int):
    """payload (N+1, D) with zero last row -> (n_rows, D).

    ``plan.gidx`` (NC, B) gathers payload rows that are summed per chunk;
    ``plan.seg`` sums each chunk to its output row (``plan.rows``; row
    ``n_rows`` is the dropped dummy).  All are int64 tensors on the
    payload's device."""
    partial = payload[plan.gidx].sum(dim=1)                   # (NC, D)
    return tree_sum(partial, plan.seg)


def _one_hot(idx, K: int, dtype):
    """one_hot with index K (the plans' dummy) mapping to a zero row, made
    by a comparison (no int64 one-hot of K + 1 columns on the way)."""
    return (idx[..., None] == torch.arange(K, device=idx.device)).to(dtype)


def _cam_cc_blocks(J: torch.Tensor, pg: torch.Tensor, cc_seg: SegmentTree,
                   K: int, C: int):
    """H_cc (K*C, K*C) from camera-pair Gram chunks: the 2C x 2C Gram of
    each chunk's rows holds [Haa Hac; Hca Hcc] of its camera pair, summed
    into the K*K blocks by ``cc_seg`` (the plan's ``cc_rows4``)."""
    rows = J[pg]                                   # (NCp, Bp, R, 2C+1)
    rows2 = rows[..., : 2 * C].reshape(rows.shape[0], -1, 2 * C)
    G2 = torch.bmm(rows2.transpose(1, 2), rows2)   # (NCp, 2C, 2C)
    blocks = torch.stack(
        [G2[:, :C, :C], G2[:, :C, C:], G2[:, C:, :C], G2[:, C:, C:]], dim=1
    ).reshape(-1, C * C)
    H_cc = tree_sum(blocks, cc_seg).reshape(K, K, C, C)
    return H_cc.permute(0, 2, 1, 3).reshape(K * C, K * C)


def _schur_terms(M, inv0, g_p, skip_gram: bool = False):
    """S_corr0 = Mw^T M and rhs_corr0 = Mw^T g_p, Mw = diag(inv0) M, in
    full f32 (the caller's ``full_f32``); S_corr0 is None with
    ``skip_gram`` (``BAConfig.skip_schur_gram``)."""
    Mw = M * inv0[:, None]
    return (None if skip_gram else Mw.T @ M), Mw.T @ g_p


def damped_camera_solve(H_cc_mat, S_corr0, rhs_corr0, g_c, mask,
                        lam: float):
    """The damped reduced camera system
    (H_cc + lam diag(H_cc) - S_corr0 / (1 + lam)) dc = -(g_c - rhs_corr0 /
    (1 + lam)) with the rows and columns of ``mask`` == 0 (fixed cameras)
    pinned to dc = 0, by Cholesky; ``g_c`` and ``mask`` in the system's row
    order.  Returns dc flat.  Where the damped system is not positive
    definite (``cholesky_ex`` reports it), dc is NaN, so the trial cost is
    NaN and the LM loop rejects the try, as the reference's NaN Cholesky
    does."""
    d_cc = torch.clamp(torch.diagonal(H_cc_mat), 1e-12, 1e32)
    S = H_cc_mat + torch.diag(lam * d_cc) - S_corr0 / (1.0 + lam)
    rhs = -(g_c.reshape(-1) - rhs_corr0 / (1.0 + lam))
    S = S * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
    return ba.cholesky_solve_or_nan(S, rhs * mask) * mask


def solve_lam(neq, lam: float, free_cam_mask: torch.Tensor,
              cfg: ba.BAConfig):
    """Damped reduced-camera solve + inverse-depth back-substitution: the
    cheap per-lambda retry on fixed normal equations
    ``(H_cc_mat, S_corr0, rhs_corr0, H_pp, g_c, g_p, M, inv0)``, whose
    reduced system is camera-major (row k*C + c).  NaN deltas where the
    damped system is not positive definite (``damped_camera_solve``).
    Raises on normal equations built without the Schur Gram
    (``BAConfig.skip_schur_gram``): those are solved by the camera-partitioned
    PCG of ``parallel/dist_fused``."""
    H_cc_mat, S_corr0, rhs_corr0, H_pp, g_c, g_p, M, inv0 = neq
    if S_corr0 is None:
        raise ValueError("normal equations built with skip_schur_gram have "
                         "no Schur Gram S_corr0 to factor; solve them with "
                         "the camera-partitioned PCG (parallel/dist_fused)")
    K = free_cam_mask.shape[0]
    C_ = H_cc_mat.shape[0] // K
    mask = free_cam_mask.to(g_c.dtype).repeat_interleave(C_)
    delta_c = damped_camera_solve(H_cc_mat, S_corr0, rhs_corr0, g_c, mask, lam)
    delta_p = -(g_p + M @ delta_c) * inv0 / (1.0 + lam)
    return delta_c.reshape(K, C_), delta_p


def make_fused_ba_solver(residual_fn: Callable, cam_retract: Callable,
                         cam_tangent_dim: int, rj_fn: Callable | None = None):
    """Returns ``solve(problem, plan, cfg) -> (problem, BAResult)``, with
    ``.build(problem, plan, cfg) -> (cost, neq)`` and ``.solve_lam(neq,
    lam, free, cfg)`` exposed.

    ``residual_fn(cam_a, cam_c, rho, aux) -> r (O, R)`` and ``rj_fn(...)
    -> (r (O, R), J (O, R, 2C+1) or (O, R*(2C+1)))`` are batched over the
    observation axis (see ``ba.make_residual_cost``); J's columns are
    [anchor tangent (C), target tangent (C), inverse depth].
    ``cam_retract(cams, delta (K, C))`` is batched over cameras.
    ``rj_fn=None`` takes the JAX package's default, J by forward mode
    through the retraction (``ba.forward_mode_rj``: 2C+1 ``jvp`` passes
    over the batched residual).  The solve runs on the device of the
    problem and plan."""
    C = cam_tangent_dim
    W = 2 * C + 1
    res_cost = ba.make_residual_cost(residual_fn)
    if rj_fn is None:
        rj_fn = ba.forward_mode_rj(residual_fn, cam_retract, C)

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
        K = ba.num_cams(problem)
        L = problem.inv_depth.shape[0]
        cost, Jsw, rsw = _scaled_jacobians(problem, cfg)
        dtype = Jsw.dtype
        H_cc_mat = _cam_cc_blocks(Jsw, plan.pg, plan.cc_seg, K, C)

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
        M = tree_sum(part.reshape(-1, K * C), plan.lm.seg)
        oh_a = _one_hot(plan.anchor_cam_of_lm, K, dtype)      # (L, K)
        M = M + (oh_a[:, :, None] * anchor_v[:, None, :]).reshape(L, K * C)

        S_corr0, rhs_corr0 = _schur_terms(M, inv0, g_p, cfg.skip_schur_gram)
        return cost, (H_cc_mat, S_corr0, rhs_corr0, H_pp, g_c, g_p, M, inv0)

    def build_dense(problem: ba.BAProblem, plan: DenseLmSchurPlan,
                    cfg: ba.BAConfig):
        """Normal-equation assembly for the slot-major layout of
        ``densify_problem``: landmark reductions are reshapes to (S, L, .)
        and sums over the slot axis; g_c and M are fixed-order sums by
        camera (``plan.gc_seg``, ``plan.m_seg``; padding rows carry camera
        K, which is dropped)."""
        K = ba.num_cams(problem)
        L = problem.inv_depth.shape[0]
        S_ = plan.lm_cam.shape[0]
        cost, Jsw, rsw = _scaled_jacobians(problem, cfg)
        dtype = Jsw.dtype
        H_cc_mat = _cam_cc_blocks(Jsw, plan.pg, plan.cc_seg, K, C)

        # thin couplings A0 = J^T J_rho, A1 = J^T r: (O', 2C+1) each
        A0 = torch.einsum("orw,or->ow", Jsw, Jsw[:, :, 2 * C])
        A1 = torch.einsum("orw,or->ow", Jsw, rsw)
        A0s = A0[: S_ * L].reshape(S_, L, W)
        red0 = A0s.sum(0)                                     # (L, W)
        anchor_v, H_pp = red0[:, :C], red0[:, 2 * C]
        g_p = A1[: S_ * L, 2 * C].reshape(S_, L).sum(0)

        Av = A1[: S_ * L]
        g_c = tree_sum(torch.cat([Av[:, :C], Av[:, C:2 * C]]), plan.gc_seg)

        inv0 = problem.lm_valid.to(dtype) / torch.clamp(
            H_pp, min=cfg.min_inv_depth_hessian)
        M = tree_sum(torch.cat([A0s[:, :, C:2 * C].reshape(-1, C), anchor_v]),
                     plan.m_seg).reshape(L, K * C)

        S_corr0, rhs_corr0 = _schur_terms(M, inv0, g_p, cfg.skip_schur_gram)
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

    def solve(problem: ba.BAProblem, plan, cfg: ba.BAConfig = ba.BAConfig()):
        """``ba.lm_fused_cost`` with ``cfg.cost_from_build``, else
        ``ba.lm_classic`` (its residual passes through ``residual_fn``)."""
        free = ~problem.fixed_cams

        def solve_lam_at(neq, lam):
            return _solve_lam(neq, lam, free, cfg)

        if cfg.cost_from_build:
            return ba.lm_fused_cost(problem, lambda p: build(p, plan, cfg),
                                    solve_lam_at, apply_step, cfg)
        return ba.lm_classic(problem, lambda p: build(p, plan, cfg)[1],
                             solve_lam_at, lambda p: res_cost(p, cfg),
                             apply_step, cfg)

    solve.build = build
    solve.solve_lam = _solve_lam
    return solve
