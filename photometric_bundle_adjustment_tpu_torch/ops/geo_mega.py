"""Plane-layout geometric-BA build: warp, projection Jacobian, Huber weight
and per-observation Schur payloads as (rows, N) planes, then the
normal-equation assembly of either plan family and the damped solve.

Port of ``photometric_bundle_adjustment_tpu/ops/geo_mega.py``.  The
geometric residual is the 2-pixel reprojection error (reference:
``BundleAdjustmentReprojectionCostFunctor``, reprojection.h:74-118); there
is no image sampling, so this module has no kernel: the plane math is
plain PyTorch, as it is XLA in the JAX package.  ``_geo_payload`` lays out
one (55, N) plane per build, N the columns of ``GeoConsts``:

  [0:13)   J_x * sw  (residual x-row, W order [t_a(3) phi_a(3) t_c(3)
           phi_c(3) rho])
  [13:26)  J_y * sw
  26, 27   r_x * sw, r_y * sw
  28       per-observation robust cost 0.5 rho(|r|^2)
  [29:42)  A0 = J^T J_rho in W order
  [42:55)  A1 = J^T r in W order

A column whose row is -1 (the chunk plans' dummy, an empty slot) or whose
observation is not valid is exact zeros.  Two families, as the
photometric megakernel's (``ops/pba_mega.py``), whose plans and damped
solves they share:

  * chunk (``build_geo``): the problem's own rows plus one zero column,
    the chunk plans of ``fused.plan_for_problem``; ``fused.solve_lam``
    solves its camera-major system;
  * dense (``build_geo_dense2``): the slot-major rows of
    ``fused.densify_problem``, the ``pba_mega.MegaPlan`` of
    ``build_mega_plan``, landmark reductions as sums over the slot axis,
    the camera lifts as fixed-order sums with the anchor as one extra slot
    (no one-hot product: the JAX package's (K, S+1, L) mask would be 275
    MB a build at bench.py's size), a component-major system with the
    coupling scaled by sqrt(inv0); ``solve_lam2`` (``pba_mega``'s) solves
    it.

Every sum runs in an order fixed on the host (``fused.tree_sum``), so a
build repeats bit for bit on the card.  The JAX package's v1 dense build
(``build_geo_dense``, ``make_geo_solver(v2=False)``) stays a JAX-side
oracle (ROADMAP, "Not to port").
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch import device as devices
from photometric_bundle_adjustment_tpu_torch.core import camera_slab, cameras
from photometric_bundle_adjustment_tpu_torch.models.geometric_ba import (
    cam_retract,
)
from photometric_bundle_adjustment_tpu_torch.ops.pba_mega import (
    MegaPlan,
    _pair_gram,
    _rot_planes,
    build_mega_plan,
    solve_lam2,
)
from photometric_bundle_adjustment_tpu_torch.optim import ba, fused
from photometric_bundle_adjustment_tpu_torch.optim.schur_plan import (
    DenseLmSchurPlan,
    SchurPlan,
)

C = 6     # camera tangent: se3
W = 13    # [se3_a(6), se3_c(6), rho]
ROW_COST = 28


class GeoConsts(NamedTuple):
    """Static columns of a build, on the solve's device."""

    d3: torch.Tensor      # (3, N) unit anchor rays
    intr_t: torch.Tensor  # (8, N) target intrinsics
    uvt: torch.Tensor     # (2, N) measured target pixels
    an: torch.Tensor      # (N,) int64 anchor camera
    tn: torch.Tensor      # (N,) int64 target camera
    lm: torch.Tensor      # (N,) int64 landmark
    valid: torch.Tensor   # (N,) bool; False for zero columns


def build_geo_consts(model: str, problem: ba.BAProblem,
                     rows=None) -> GeoConsts:
    """The static columns of observation rows ``rows`` (-1: a zero column),
    in the problem's dtype and on its device; by default every row of the
    problem and one zero column after them (the chunk plans' dummy)."""
    o = problem.obs
    dev = problem.inv_depth.device
    if rows is None:
        rows = np.r_[np.arange(o.valid.shape[0]), -1]
    rows = torch.as_tensor(np.asarray(rows), device=dev)
    ok = rows >= 0
    take = torch.where(ok, rows, torch.zeros_like(rows))
    aux = o.aux
    d = cameras.unproject_unit(model, aux.intr_ref[take], aux.uv_ref[take])
    return GeoConsts(
        d3=d.T.contiguous(), intr_t=aux.intr_target[take].T.contiguous(),
        uvt=aux.uv_target[take].T.contiguous(),
        an=o.anchor_cam[take].long(), tn=o.target_cam[take].long(),
        lm=o.landmark[take].long(), valid=ok & (o.valid[take] != 0))


def build_geo_plan(problem: ba.BAProblem, **kwargs) -> SchurPlan:
    """The chunk plans over the problem's own rows (``fused.plan_for_problem``;
    ``kwargs`` go to ``build_schur_plan``), on the problem's device."""
    return fused.plan_for_problem(problem, **kwargs)


def _warp_geo(model: str, poses, inv_depth, consts: GeoConsts):
    """Plane-layout warp, projection and Jacobian coefficients over the
    columns of ``consts``: returns (ux, uy, GA, GB), pixel planes (1, N)
    and the (13, N) planes dpi_{u,v}/dtheta in W order.  Projections are
    not masked here; ``_geo_payload`` masks invalid columns."""
    pa = poses[consts.an]                                     # (N, 7)
    pc = poses[consts.tn]
    rho = inv_depth[consts.lm][None, :]                       # (1, N)
    Ra = _rot_planes(pa[:, 3:7])
    Rc = _rot_planes(pc[:, 3:7])
    # M = Rc^T Ra;  u = Rc^T (ta - tc)
    M = [[(Rc[0][j] * Ra[0][c] + Rc[1][j] * Ra[1][c]
           + Rc[2][j] * Ra[2][c])[None, :] for c in range(3)]
         for j in range(3)]
    dt = [pa[:, i] - pc[:, i] for i in range(3)]
    u = [(Rc[0][j] * dt[0] + Rc[1][j] * dt[1] + Rc[2][j] * dt[2])[None, :]
         for j in range(3)]
    d = [consts.d3[j:j + 1] for j in range(3)]                # 3 x (1, N)
    q = [M[j][0] * d[0] + M[j][1] * d[1] + M[j][2] * d[2] + rho * u[j]
         for j in range(3)]
    ux, uy, Jpi0, Jpi1 = camera_slab.project_slab(model, consts.intr_t,
                                                  q[0], q[1], q[2])

    def coeff(Jp):
        a = [Jp[0] * M[0][c] + Jp[1] * M[1][c] + Jp[2] * M[2][c]
             for c in range(3)]
        blocks = [rho * a[0], rho * a[1], rho * a[2]]
        # dphi_a: d x a
        blocks += [d[1] * a[2] - d[2] * a[1], d[2] * a[0] - d[0] * a[2],
                   d[0] * a[1] - d[1] * a[0]]
        # dt_c: -rho Jpi
        blocks += [-rho * Jp[0], -rho * Jp[1], -rho * Jp[2]]
        # dphi_c: Jpi x q
        blocks += [Jp[1] * q[2] - Jp[2] * q[1], Jp[2] * q[0] - Jp[0] * q[2],
                   Jp[0] * q[1] - Jp[1] * q[0]]
        # drho: Jpi . u
        blocks += [Jp[0] * u[0] + Jp[1] * u[1] + Jp[2] * u[2]]
        return torch.cat(blocks, dim=0)                       # (13, N)

    return ux, uy, coeff(Jpi0), coeff(Jpi1)


def _geo_payload(model: str, problem: ba.BAProblem, consts: GeoConsts,
                 cfg: ba.BAConfig):
    """``(cost, plane)``: the robust cost (0-d) and the (55, N) plane of
    the module docstring."""
    ux, uy, GA, GB = _warp_geo(model, problem.cam_states, problem.inv_depth,
                               consts)
    vb = consts.valid[None, :]                                # (1, N)
    zero = torch.zeros_like(ux)
    # where, not multiply: a zero column may project to inf or NaN
    rx = torch.where(vb, consts.uvt[0:1] - ux, zero)
    ry = torch.where(vb, consts.uvt[1:2] - uy, zero)
    r2 = rx * rx + ry * ry
    delta = float(cfg.huber_delta)
    if delta > 0:
        sq = torch.sqrt(torch.clamp(r2, min=1e-300))
        inl = r2 <= delta * delta
        wgt = torch.where(inl, torch.ones_like(r2), delta / sq)
        cost_row = 0.5 * torch.where(inl, r2, 2.0 * delta * sq - delta * delta)
    else:
        wgt = torch.ones_like(r2)
        cost_row = 0.5 * r2
    vrow = vb.to(rx.dtype)
    cost_row = cost_row * vrow
    sw = torch.sqrt(wgt * vrow)

    Jx = torch.where(vb, -GA * sw, torch.zeros_like(GA))      # (13, N)
    Jy = torch.where(vb, -GB * sw, torch.zeros_like(GB))
    rswx, rswy = rx * sw, ry * sw
    A0 = Jx * Jx[12:13] + Jy * Jy[12:13]
    A1 = Jx * rswx + Jy * rswy
    plane = torch.cat([Jx, Jy, rswx, rswy, cost_row, A0, A1], dim=0)
    return torch.sum(plane[ROW_COST]), plane


def build_geo(model: str, problem: ba.BAProblem, consts: GeoConsts,
              cplan: SchurPlan, cfg: ba.BAConfig):
    """Chunk-plan assembly over the problem's own rows (``consts`` of
    ``build_geo_consts(model, problem)``: the rows, then the zero column
    the plans' dummies gather).  Returns ``(cost, neq)`` with neq =
    (H_cc_mat, S_corr0, rhs_corr0, H_pp, g_c, g_p, M, inv0), the contract
    of ``fused.solve_lam`` (camera-major)."""
    K = ba.num_cams(problem)
    L = problem.inv_depth.shape[0]
    cost, plane = _geo_payload(model, problem, consts, cfg)
    outT = plane.T.contiguous()                               # (N, 55)
    dtype = outT.dtype
    H_cc = _pair_gram(outT[:, :26], cplan.pg, cplan.cc_seg, K, C)

    A0 = outT[:, 29:42]
    A1 = outT[:, 42:55]
    pay_l = torch.cat([A0[:, :C], A0[:, 12:13], A1[:, 12:13]], dim=1)
    red_l = fused._chunk_sum(pay_l, cplan.lm, L)
    anchor_v, H_pp, g_p = red_l[:, :C], red_l[:, C], red_l[:, C + 1]
    g_c = (fused._chunk_sum(A1[:, :C].contiguous(), cplan.gc_a, K)
           + fused._chunk_sum(A1[:, C:2 * C].contiguous(), cplan.gc_t, K))

    inv0 = problem.lm_valid.to(dtype) / torch.clamp(
        H_pp, min=cfg.min_inv_depth_hessian)
    # M (L, K*C): each landmark's target couplings lifted to their
    # camera's column block (one-hot products of 0/1, exact), plus the
    # anchor coupling
    oh = fused._one_hot(cplan.lm_cam, K, dtype)               # (NC, B, K)
    rows_t = A0[:, C:2 * C][cplan.lm.gidx]                    # (NC, B, C)
    part = torch.bmm(oh.transpose(1, 2), rows_t)              # (NC, K, C)
    M = fused.tree_sum(part.reshape(part.shape[0], K * C), cplan.lm.seg)
    oh_a = fused._one_hot(cplan.anchor_cam_of_lm, K, dtype)   # (L, K)
    M = M + (oh_a[:, :, None] * anchor_v[:, None, :]).reshape(L, K * C)

    S_corr0, rhs_corr0 = fused._schur_terms(M, inv0, g_p)
    H_cc_mat = H_cc.permute(0, 2, 1, 3).reshape(K * C, K * C)
    return cost, (H_cc_mat, S_corr0, rhs_corr0, H_pp, g_c, g_p, M, inv0)


def build_geo_dense2(model: str, problem: ba.BAProblem, consts: GeoConsts,
                     plan: MegaPlan, cfg: ba.BAConfig):
    """Dense slot-major assembly (``consts`` over the slot rows of
    ``build_mega_plan``, ``plan`` its ``MegaPlan`` on the device).
    Returns ``(cost, neq)`` with the contract of ``solve_lam2``: neq =
    (H_cc_mat, S_corr0, rhs_corr0, g_c, g_p, Ms, inv0, s).

    The reduced system is component-major (row c*K + k), ``g_c`` is
    (C, K), ``Ms`` (L, C*K) the camera coupling scaled by s = sqrt(inv0)
    (the JAX package's ``Ms_p`` transposed), so S_corr0 = Ms^T Ms."""
    K = ba.num_cams(problem)
    L = problem.inv_depth.shape[0]
    S_ = plan.lm_cam.shape[0]
    cost, plane = _geo_payload(model, problem, consts, cfg)
    dtype = plane.dtype
    outT = plane.T.contiguous()                               # (N, 55)
    H_cc = _pair_gram(outT[:, :26], plan.pg, plan.cc_seg, K, C)
    H_cc_mat = H_cc.permute(2, 0, 3, 1).reshape(K * C, K * C)

    AB = outT[:S_ * L, 29:55]                                 # slot rows
    A0r = AB[:, :W].reshape(S_, L, W)
    A1r = AB[:, W:].reshape(S_, L, W)
    red0 = A0r.sum(0)                                         # (L, 13)
    anchor_v, H_pp = red0[:, :C], red0[:, 12]
    g_p = A1r[:, :, 12].sum(0)

    inv0 = problem.lm_valid.to(dtype) / torch.clamp(
        H_pp, min=cfg.min_inv_depth_hessian)
    s = torch.sqrt(inv0)

    # lifts over S+1 slots, the anchor the extra one; camera K is dropped
    vt_ext = torch.cat([A0r[:, :, C:2 * C], anchor_v[None]], 0) \
        * s[None, :, None]                                    # (S+1, L, C)
    Ms = (fused.tree_sum(vt_ext.reshape(-1, C), plan.m_seg)
          .reshape(L, K, C).permute(0, 2, 1).reshape(L, C * K))
    a1_ext = torch.cat([A1r[:, :, C:2 * C], A1r[:, :, :C].sum(0)[None]], 0)
    g_c = fused.tree_sum(a1_ext.reshape(-1, C), plan.gc_seg).T  # (C, K)

    S_corr0 = Ms.T @ Ms                                       # (C*K, C*K)
    rhs_corr0 = (s * g_p) @ Ms
    return cost, (H_cc_mat, S_corr0, rhs_corr0, g_c, g_p, Ms, inv0, s)


def make_geo_solver(model: str, problem: ba.BAProblem, plan_slot=None, *,
                    device="cuda"):
    """Plane-layout geometric LM solver for a fixed observation graph, on
    ``device``.

    With ``plan_slot`` (the ``DenseLmSchurPlan`` of ``fused.densify_problem``;
    ``problem`` its slot-major problem): the dense family,
    ``build_geo_dense2`` + ``solve_lam2``.  Without it: the chunk family
    over the problem's own rows, ``build_geo`` + ``fused.solve_lam``.

    Returns ``solve(problem, cfg) -> (problem, BAResult)``, the fused-cost
    LM loop (``ba.lm_fused_cost``: one host sync per try), with
    ``.build(problem, cfg)``, ``.solve_lam(neq, lam, free, cfg)``, the
    ``.consts`` and the ``.plan`` exposed; ``solve`` takes a problem with
    the same observations and any state."""
    if plan_slot is not None and not isinstance(plan_slot, DenseLmSchurPlan):
        raise TypeError(f"plan_slot must be a DenseLmSchurPlan, got "
                        f"{type(plan_slot).__name__}")
    device = devices.resolve(device)
    problem = ba.problem_to(problem, device)
    if plan_slot is not None:
        plan_np, rows = build_mega_plan(problem, plan_slot)
        plan = fused.plan_to(plan_np, device)
        build_impl, solve_lam_impl = build_geo_dense2, solve_lam2
    else:
        plan, rows = build_geo_plan(problem, pow2_buckets=False), None
        build_impl, solve_lam_impl = build_geo, fused.solve_lam
    consts = build_geo_consts(model, problem, rows)

    def build(problem, cfg: ba.BAConfig):
        with fused.full_f32():
            return build_impl(model, problem, consts, plan, cfg)

    def _solve_lam(neq, lam, free, cfg: ba.BAConfig):
        with fused.full_f32():
            return solve_lam_impl(neq, lam, free, cfg)

    def apply_step(prob, dc, dp):
        return prob._replace(cam_states=cam_retract(prob.cam_states, dc),
                             inv_depth=prob.inv_depth + dp)

    def solve(problem: ba.BAProblem, cfg: ba.BAConfig = ba.BAConfig()):
        problem = ba.problem_to(problem, device)
        free = ~problem.fixed_cams
        return ba.lm_fused_cost(
            problem, lambda p: build(p, cfg),
            lambda neq, lam: _solve_lam(neq, lam, free, cfg), apply_step, cfg)

    solve.build = build
    solve.solve_lam = _solve_lam
    solve.consts = consts
    solve.plan = plan
    return solve
