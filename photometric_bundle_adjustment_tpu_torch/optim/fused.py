"""Fused Schur-LM bundle-adjustment solver driven by precomputed plans, and
the one normal-equation assembly and damped solve of every build of the
port.

Port of ``photometric_bundle_adjustment_tpu/optim/fused.py``, its dense
one-hot-lifting solver (``_make_dense_fused_ba_solver``): the same problem
layout (``ba.BAProblem``), LM semantics (damped trust region with
accept/reject, Huber IRLS, gauge masking) and normal equations.  The
Schur complement uses the dense per-landmark coupling matrix M (L, K*C),
so that

  * the correction S_corr0 = M^T diag(inv_hpp) M is one matrix product and
    the back-substitution a matrix-vector product;
  * the damped system is analytic in lambda,
    S(lam) = H_cc + lam diag(H_cc) - S_corr0 / (1 + lam),
    so each LM retry costs one dense Cholesky of the (K*C, K*C) system.

A build produces per-observation payload rows, the Huber-weighted
Jacobian rows and the thin couplings A0 = J^T J_rho, A1 = J^T r, and hands
them to ``assemble``: ``make_fused_ba_solver`` from a batched rj
function, ``ops/pba_mega`` from the photometric megakernel and
``ops/geo_mega`` from its geometric planes.  ``assemble`` follows the plan
type: a ``SchurPlan`` (any observation order, ``plan_for_problem``) sums
through chunked segment plans, a ``DenseLmSchurPlan`` (the slot-major order
of ``densify_problem``) by reshapes over the slot axis.  Both give the
camera-major system (row k*C + c) that ``solve_lam`` solves.  Plans hold
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
    landmark-axis reduction of ``assemble`` into a reshape and a sum
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


def pair_gram(J_rows: torch.Tensor, pg: torch.Tensor, cc_seg: SegmentTree,
              K: int, C: int) -> torch.Tensor:
    """H_cc (K*C, K*C), camera-major, from camera-pair Gram chunks over
    Jacobian rows ``J_rows`` (N, R*(2C+1)) whose 2C+1 columns repeat per
    residual: the 2C x 2C Gram of each chunk's rows (a strided view of
    the gathered rows, no copy) holds [Haa Hac; Hca Hcc] of its camera
    pair, summed into the K*K blocks in the fixed order of ``cc_seg``
    (the plan's ``cc_rows4``)."""
    rows = J_rows[pg]                              # (NCp, Bp, R*(2C+1))
    rows2 = rows.reshape(rows.shape[0], -1, 2 * C + 1)[..., :2 * C]
    G2 = torch.bmm(rows2.transpose(1, 2), rows2)   # (NCp, 2C, 2C)
    blocks = torch.stack(
        [G2[:, :C, :C], G2[:, :C, C:], G2[:, C:, :C], G2[:, C:, C:]], dim=1
    ).reshape(-1, C * C)
    H_cc = tree_sum(blocks, cc_seg).reshape(K, K, C, C)
    return H_cc.permute(0, 2, 1, 3).reshape(K * C, K * C)


def assemble(cost, J_rows: torch.Tensor, A0: torch.Tensor, A1: torch.Tensor,
             problem: ba.BAProblem, plan, cfg: ba.BAConfig):
    """The normal equations of one build from its payload rows.

    ``J_rows`` (N, R*(2C+1)) are the sqrt(Huber weight)-scaled Jacobian
    rows of the observation rows the plan indexes, ``A0 = J^T J_rho`` and
    ``A1 = J^T r`` (N, 2C+1) their thin couplings, columns in W order
    [anchor tangent (C), target tangent (C), inverse depth].  The row
    after the plan's observation rows, which its dummy entries name, is
    zero.
    With a ``SchurPlan`` the landmark reductions and g_c are chunked
    segment sums and M the one-hot lift of each landmark chunk's target
    couplings plus the anchor's; with a ``DenseLmSchurPlan`` (rows s*L +
    l) the landmark reductions are sums over the slot axis, g_c and M
    fixed-order sums by camera (``plan.gc_seg``, ``plan.m_seg``; padding
    rows carry camera K, which is dropped).

    Returns ``(cost, neq)`` with neq = (H_cc_mat, S_corr0, rhs_corr0,
    H_pp, g_c (K, C), g_p, M (L, K*C), inv0), the camera-major contract of
    ``solve_lam``; S_corr0 is None with ``cfg.skip_schur_gram``.  Call it
    under ``full_f32``."""
    K = ba.num_cams(problem)
    L = problem.inv_depth.shape[0]
    C = (A0.shape[1] - 1) // 2
    dtype = A0.dtype
    H_cc_mat = pair_gram(J_rows, plan.pg, plan.cc_seg, K, C)
    if isinstance(plan, DenseLmSchurPlan):
        S_ = plan.lm_cam.shape[0]
        A0s = A0[: S_ * L].reshape(S_, L, 2 * C + 1)
        red0 = A0s.sum(0)                                     # (L, W)
        anchor_v, H_pp = red0[:, :C], red0[:, 2 * C]
        g_p = A1[: S_ * L, 2 * C].reshape(S_, L).sum(0)
        Av = A1[: S_ * L]
        g_c = tree_sum(torch.cat([Av[:, :C], Av[:, C:2 * C]]), plan.gc_seg)
        M = tree_sum(torch.cat([A0s[:, :, C:2 * C].reshape(-1, C), anchor_v]),
                     plan.m_seg).reshape(L, K * C)
    else:
        # landmark reductions: anchor-merged Hap, H_pp, g_p in one pass
        pay_l = torch.cat([A0[:, :C], A0[:, 2 * C:], A1[:, 2 * C:]], dim=1)
        red_l = _chunk_sum(pay_l, plan.lm, L)
        anchor_v, H_pp, g_p = red_l[:, :C], red_l[:, C], red_l[:, C + 1]
        g_c = (_chunk_sum(A1[:, :C], plan.gc_a, K)
               + _chunk_sum(A1[:, C:2 * C], plan.gc_t, K))
        # M (L, K*C): each landmark's target couplings lifted to their
        # camera's column block (one-hot products of 0/1, exact), plus the
        # anchor coupling
        oh = _one_hot(plan.lm_cam, K, dtype)                  # (NC, B, K)
        rows_t = A0[:, C:2 * C][plan.lm.gidx]                  # (NC, B, C)
        part = torch.bmm(oh.transpose(1, 2), rows_t)          # (NC, K, C)
        M = tree_sum(part.reshape(-1, K * C), plan.lm.seg)
        oh_a = _one_hot(plan.anchor_cam_of_lm, K, dtype)      # (L, K)
        M = M + (oh_a[:, :, None] * anchor_v[:, None, :]).reshape(L, K * C)
    inv0 = problem.lm_valid.to(dtype) / torch.clamp(
        H_pp, min=cfg.min_inv_depth_hessian)
    # S_corr0 = Mw^T M and rhs_corr0 = Mw^T g_p, Mw = diag(inv0) M
    Mw = M * inv0[:, None]
    S_corr0 = None if cfg.skip_schur_gram else Mw.T @ M
    return cost, (H_cc_mat, S_corr0, Mw.T @ g_p, H_pp, g_c, g_p, M, inv0)


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

    def build(problem: ba.BAProblem, plan, cfg: ba.BAConfig):
        """One normal-equation assembly; everything lambda-independent."""
        with full_f32():
            cost, Jsw, rsw = _scaled_jacobians(problem, cfg)
            if isinstance(plan, DenseLmSchurPlan):
                A0 = torch.einsum("orw,or->ow", Jsw, Jsw[:, :, 2 * C])
                A1 = torch.einsum("orw,or->ow", Jsw, rsw)
            else:
                # both couplings from one product: (O', 2C+1, 2)
                right = torch.stack([Jsw[:, :, 2 * C], rsw], dim=-1)
                A = torch.einsum("ori,ors->ois", Jsw, right)
                A0, A1 = A[..., 0], A[..., 1]
            return assemble(cost, Jsw.reshape(Jsw.shape[0], -1), A0, A1,
                            problem, plan, cfg)

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
