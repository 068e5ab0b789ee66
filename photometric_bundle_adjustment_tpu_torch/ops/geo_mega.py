"""Plane-layout geometric-BA build: warp, projection Jacobian, Huber weight
and per-observation Schur payloads as (rows, N) planes, handed to the
normal-equation assembly and the damped solve of ``optim/fused``.

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

The columns are the problem's own rows and one zero column after them; a
column whose observation is not valid is exact zeros.  ``build_geo`` hands
the plane to ``fused.assemble`` with the plan of either family: the chunk
plans of ``fused.plan_for_problem`` over the problem's own order, or the
``DenseLmSchurPlan`` of ``fused.densify_problem`` over its slot-major
rows.  ``fused.solve_lam`` solves both.  Every sum runs in an order fixed
on the host (``fused.tree_sum``), so a build repeats bit for bit on the
card.  The JAX package's own dense builds, component-major, stay
JAX-side oracles (ROADMAP, "Not to port").
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
from photometric_bundle_adjustment_tpu_torch.optim import ba, fused
from photometric_bundle_adjustment_tpu_torch.optim.schur_plan import (
    DenseLmSchurPlan,
    SchurPlan,
)

C = 6     # camera tangent: se3
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


def build_geo_consts(model: str, problem: ba.BAProblem) -> GeoConsts:
    """The static columns of every row of the problem and one zero column
    after them (the plans' dummy), in the problem's dtype and on its
    device."""
    o = problem.obs
    dev = problem.inv_depth.device
    rows = torch.as_tensor(np.r_[np.arange(o.valid.shape[0]), -1],
                           device=dev)
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


def _geo_payload(model: str, problem: ba.BAProblem, consts: GeoConsts,
                 cfg: ba.BAConfig):
    """``(cost, plane)``: the robust cost (0-d) and the (55, N) plane of
    the module docstring."""
    poses = problem.cam_states
    ux, uy, GA, GB = camera_slab.warp_slab(
        model, poses[consts.an], poses[consts.tn],
        problem.inv_depth[consts.lm][None, :], consts.d3, consts.intr_t)
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


def build_geo(model: str, problem: ba.BAProblem, consts: GeoConsts, plan,
              cfg: ba.BAConfig):
    """The payload plane over the columns of ``consts`` (``build_geo_consts``
    of ``problem``: its rows, then the zero column the plans' dummies
    gather) + ``fused.assemble`` with ``plan`` (a ``SchurPlan`` or a
    ``DenseLmSchurPlan``).  Returns ``(cost, neq)`` with the contract of
    ``fused.solve_lam``."""
    cost, plane = _geo_payload(model, problem, consts, cfg)
    outT = plane.T.contiguous()                               # (N, 55)
    return fused.assemble(cost, outT[:, :26], outT[:, 29:42], outT[:, 42:55],
                          problem, plan, cfg)


def make_geo_solver(model: str, problem: ba.BAProblem, plan_slot=None, *,
                    device="cuda"):
    """Plane-layout geometric LM solver for a fixed observation graph, on
    ``device``.

    With ``plan_slot`` (the ``DenseLmSchurPlan`` of ``fused.densify_problem``;
    ``problem`` its slot-major problem): the dense family.  Without it:
    the chunk family over the problem's own rows (``build_geo_plan``).
    Both build with ``build_geo`` and solve with ``fused.solve_lam``.

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
        plan = fused.plan_to(plan_slot, device)
    else:
        plan = build_geo_plan(problem, pow2_buckets=False)
    consts = build_geo_consts(model, problem)

    def build(problem, cfg: ba.BAConfig):
        with fused.full_f32():
            return build_geo(model, problem, consts, plan, cfg)

    def _solve_lam(neq, lam, free, cfg: ba.BAConfig):
        with fused.full_f32():
            return fused.solve_lam(neq, lam, free, cfg)

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
