"""Geometric (reprojection) bundle adjustment with anchored inverse-depth
landmarks.

Port of ``photometric_bundle_adjustment_tpu/models/geometric_ba.py``.  The
residual is the analog of the reference's
``BundleAdjustmentReprojectionCostFunctor`` (reprojection.h:74-118):

    r = p_2d - pi_2( T_w_c2^-1 * T_w_c1 * ( pi_1^-1(p_2d_ref) / rho ) )

where camera 1 is the landmark's anchor (its first observation, which
contributes no residual), the anchor intrinsics are constants, and rho is
the scalar inverse depth.  Camera states are SE3 poses (K, 7) with
right-plus retraction; the gauge is fixed by masking cameras.

The residual and its closed-form Jacobian are batched over the
observation axis.  The solvers: ``make_solver`` (``optim/ba.make_ba_solver``,
scatter-add reference), ``make_fused_solver`` (``optim/fused``, plan-based
builds) and ``bundle_adjustment``, which picks the dense slot-major or the
chunk plan by ``_accel_plan`` on every device.  ``ops/geo_mega.py`` holds
the plane-layout builds of the same normal equations.  The JAX package's
``_use_manual_jacobians`` switch (``PBA_TPU_MANUAL_JAC``), its
``PBA_DUMP_BA_PROBLEM`` dump and its packed path are not ported (ROADMAP,
"Not to port"): the port always uses the closed form, and the
forward-mode Jacobian stays reachable through ``rj_fn=None``.

Spans (``utils/spans``): ``geo.problem`` (``build_problem``), ``geo.plan``
(``_accel_plan``, built on the device; each of its reads to the host a
``geo.plan.sync``) and ``geo.solve`` (the LM loop, whose ``lm.*`` spans
``optim/ba`` records).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch import device as devices
from photometric_bundle_adjustment_tpu_torch.core import camera_slab, cameras, se3
from photometric_bundle_adjustment_tpu_torch.optim import (
    ba,
    fused,
    schur_plan_torch,
)
from photometric_bundle_adjustment_tpu_torch.utils.spans import span


class GeometricObs(NamedTuple):
    """Per-observation constants, leading dim O."""

    uv_target: torch.Tensor    # (O, 2) measured pixel in the target image
    uv_ref: torch.Tensor       # (O, 2) anchor pixel of the landmark
    intr_ref: torch.Tensor     # (O, 8) anchor camera intrinsics (constant)
    intr_target: torch.Tensor  # (O, 8) target camera intrinsics


def make_residual_fn(model: str):
    """Residuals (O, 2) of every observation; ``pose_a``/``pose_c`` (O, 7),
    ``rho`` (O,).

    The warp is evaluated in ray form, q = R_c^T R_a d + rho R_c^T (t_a -
    t_c) (= rho p_c), and projected directly: every camera model is scale
    invariant (pi(s p) = pi(p) for s > 0), so this equals the reference's
    pi(T_c^-1 T_a (d / rho)) while staying sound as rho -> 0, where the
    d / rho form pushes 1/rho-sized intermediates through the Jacobian
    (real EuRoC maps hold landmarks at rho ~ 1e-5)."""

    def residual(pose_a, pose_c, rho, aux: GeometricObs):
        d = cameras.unproject_unit(model, aux.intr_ref, aux.uv_ref)
        qc_inv = se3.quat_conj(se3.rotation(pose_c))
        t_rel = se3.translation(pose_a) - se3.translation(pose_c)
        q = (se3.quat_rotate(qc_inv, se3.quat_rotate(se3.rotation(pose_a), d))
             + rho[:, None] * se3.quat_rotate(qc_inv, t_rel))
        return aux.uv_target - cameras.project(model, aux.intr_target, q)

    return residual


def cam_retract(pose: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Right-plus retraction, batched over leading dims."""
    return se3.right_plus(pose, delta)


def make_rj_fn(model: str):
    """Closed-form residuals (O, 2) and Jacobians (O, 2, 13), batched over
    the observation axis.

    Chain rule through the ray-form warp q = M d + rho u, M = R_c^T R_a,
    u = R_c^T (t_a - t_c), right-plus tangents in Sophus order [trans,
    rot]:

      dq/d(dt_a) = rho M,  dq/d(dphi_a) = -M [d]_x,  dq/d(dt_c) = -rho I,
      dq/d(dphi_c) = [q]_x,  dq/d(rho) = u,

    and dr/dq = -dpi/dq, the projection Jacobian of
    ``core/camera_slab.project_slab`` (analytic in all four models; the
    JAX package takes it by forward mode over the 3-vector).  No 1/rho
    anywhere, so near-infinity landmarks stay stable."""

    def rj(pose_a, pose_c, rho, aux: GeometricObs):
        d = cameras.unproject_unit(model, aux.intr_ref, aux.uv_ref)  # (O, 3)
        Ra = se3.quat_to_matrix(se3.rotation(pose_a))
        RcT = se3.quat_to_matrix(se3.rotation(pose_c)).transpose(1, 2)
        M = RcT @ Ra                                                # (O, 3, 3)
        u = (RcT @ (se3.translation(pose_a)
                    - se3.translation(pose_c))[:, :, None])[:, :, 0]
        q = (M @ d[:, :, None])[:, :, 0] + rho[:, None] * u         # (O, 3)
        ux, uy, J0, J1 = camera_slab.project_slab(
            model, aux.intr_target.T, q[None, :, 0], q[None, :, 1],
            q[None, :, 2])
        r = aux.uv_target - torch.stack([ux[0], uy[0]], dim=-1)
        Jq = torch.stack([torch.stack([j[0] for j in J0], dim=-1),
                          torch.stack([j[0] for j in J1], dim=-1)], dim=1)
        eye = torch.eye(3, dtype=rho.dtype, device=rho.device)
        dq = torch.cat([rho[:, None, None] * M,           # d t_a
                        -M @ se3.hat_so3(d),              # d phi_a
                        -rho[:, None, None] * eye,        # d t_c
                        se3.hat_so3(q),                   # d phi_c
                        u[:, :, None]], dim=2)            # d rho: (O, 3, 13)
        return r, -Jq @ dq

    return rj


@functools.lru_cache(maxsize=None)
def make_solver(model: str):
    """The scatter-add reference solver (``ba.make_ba_solver``) with the
    closed-form rj: ``solve(problem, cfg)``, on the problem's device."""
    return ba.make_ba_solver(make_residual_fn(model), cam_retract, 6,
                             rj_fn=make_rj_fn(model))


@functools.lru_cache(maxsize=None)
def make_fused_solver(model: str):
    """The plan-based fused solver (``fused.make_fused_ba_solver``) with the
    closed-form rj: ``solve(problem, plan, cfg)``, on the problem's
    device."""
    return fused.make_fused_ba_solver(make_residual_fn(model), cam_retract, 6,
                                      rj_fn=make_rj_fn(model))


def build_problem(poses, inv_depth, anchor_cam, target_cam, landmark,
                  uv_target, uv_ref, intr_ref, intr_target, valid, fixed_cams,
                  lm_valid=None, *, dtype=None, device="cuda") -> ba.BAProblem:
    """A geometric BAProblem on ``device``: poses (K, 7), inv_depth (L,),
    per-observation anchor/target camera, landmark, the two pixels and the
    two intrinsics rows, validity; fixed cameras (K,) and valid landmarks
    (L,).  Arguments may be numpy arrays or tensors; floats become
    ``dtype`` (default: inv_depth's dtype)."""
    device = devices.resolve(device)
    if dtype is None:
        dtype = (inv_depth.dtype if torch.is_tensor(inv_depth)
                 else torch.float64)

    def flt(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    def idx(x):
        return torch.as_tensor(x, device=device).long()

    def mask(x):
        return torch.as_tensor(x, device=device).bool()

    if lm_valid is None:
        lm_valid = np.ones(np.shape(inv_depth), bool)
    with span("geo.problem"):
        obs = ba.BAObservations(
            anchor_cam=idx(anchor_cam), target_cam=idx(target_cam),
            landmark=idx(landmark),
            aux=GeometricObs(uv_target=flt(uv_target), uv_ref=flt(uv_ref),
                             intr_ref=flt(intr_ref),
                             intr_target=flt(intr_target)),
            valid=mask(valid).to(dtype),
        )
        return ba.BAProblem(cam_states=flt(poses), inv_depth=flt(inv_depth),
                            obs=obs, fixed_cams=mask(fixed_cams),
                            lm_valid=mask(lm_valid))


def _accel_plan(problem: ba.BAProblem):
    """``(problem, plan)``: the slot-major dense layout
    (``fused.densify_problem``) when its padding is modest, S_max * L <=
    3 x the valid observations; else the chunk plan over the problem's own
    rows (heavy-tailed maps: real EuRoC maps reach 55 observations on a
    landmark against about 5 on average).  No power-of-two buckets:
    PyTorch compiles nothing per shape.  Both plans are built on the
    problem's device; the test reads its two counts in one
    ``geo.plan.sync``, from the landmark sort that either builder then
    takes."""
    o = problem.obs
    L = problem.inv_depth.shape[0]
    tracks = schur_plan_torch.sort_tracks(o.landmark, o.valid != 0, L)
    if max(tracks.longest, 1) * L <= 3 * max(tracks.n_valid, 1):
        return fused.densify_problem(problem, pow2_buckets=False,
                                     tracks=tracks)
    return problem, fused.plan_for_problem(problem, pow2_buckets=False,
                                           tracks=tracks)


def bundle_adjustment(problem: ba.BAProblem, model: str,
                      cfg: ba.BAConfig = ba.BAConfig()):
    """The Schur-LM solve of ``problem`` on its device; returns ``(problem,
    BAResult)``.  The reference's defaults: Huber 1 px, 20 iterations.

    The plan-based fused solver runs on ``_accel_plan``'s layout; the
    returned problem then holds the observations in that layout's order,
    and its camera states and inverse depths index as the input's do.
    ``make_solver`` is the scatter-add reference of the same solve.

    A problem without landmarks or without valid observations has nothing
    to solve: it comes back unchanged, at cost 0 and no iteration (the
    JAX package's plan builders raise there)."""
    o = problem.obs
    if problem.inv_depth.shape[0] == 0 or not bool((o.valid != 0).any()):
        zero = torch.zeros((), dtype=problem.inv_depth.dtype,
                           device=problem.inv_depth.device)
        return problem, ba.BAResult(cost=zero, initial_cost=zero,
                                    iterations=0, lam=cfg.init_lambda)
    with span("geo.plan"):
        problem, plan = _accel_plan(problem)
    with span("geo.solve"):
        return make_fused_solver(model)(problem, plan, cfg)
