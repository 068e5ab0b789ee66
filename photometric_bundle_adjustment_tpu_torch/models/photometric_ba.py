"""Photometric bundle adjustment: problem set-up, samplers, pyramid and
the plan-based fused solvers.

Port of ``photometric_bundle_adjustment_tpu/models/photometric_ba.py``.
Residual for one observation (landmark anchored in reference camera r,
seen in target camera t), per patch pixel k:

    r_k = ( I_t(pi_t(warp(uv_r + d_k, rho, T))) - b_t )
          - exp(a_t - a_r) * ( I_r(uv_r + d_k) - b_r )

with an 8-dim camera tangent [se3(6), a, b] and scalar inverse-depth
landmarks.  Images are sampled bilinearly from a flat ``(K*H*W,)`` buffer.

The residual and its closed-form Jacobian are batched over the observation
axis (``make_rj_fn``, ``make_residual_fn``), with one of two samplers:
per-tap gathers (``make_fused_solver``), or the patch-sampling kernel of
``ops/patch_sample.py`` on the problem's own rows
(``make_kernel_fused_solver``, chunk plans) or on the slot-major layout of
``optim.fused.densify_problem`` (``make_kernel_dense_solver``).  All of
them solve with ``optim.fused.make_fused_ba_solver``.  The JAX package's
``"tile"`` sampler option of ``make_rj_fn``/``make_residual_fn`` is not
ported (ROADMAP, "Not to port"): they take no ``sampler`` argument.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch import device as devices
from photometric_bundle_adjustment_tpu_torch.core import camera_slab, cameras, se3
from photometric_bundle_adjustment_tpu_torch.ops import patch_sample as ps
from photometric_bundle_adjustment_tpu_torch.optim import ba, fused

# DSO residual pattern: 8 pixels around the anchor
PATCH_OFFSETS = np.array(
    [[0, -2], [-1, -1], [1, -1], [-2, 0], [0, 0], [2, 0], [-1, 1], [0, 2]],
    np.float64,
)
PATCH_SIZE = len(PATCH_OFFSETS)


class PhotometricObs(NamedTuple):
    uv_ref: torch.Tensor      # (O, 2) anchor pixel
    ref_patch: torch.Tensor   # (O, 8) reference intensities at uv_ref + offsets
    target_img: torch.Tensor  # (O,) int64 image index of the target camera
    intr_ref: torch.Tensor    # (O, 8)
    intr_target: torch.Tensor  # (O, 8)


class PhotometricCams(NamedTuple):
    pose: torch.Tensor        # (K, 7)
    affine: torch.Tensor      # (K, 2) = (a, b)


def _bilinear_taps(images_flat, img_idx, uv, H: int, W: int):
    """Clamped bilinear coordinates and the 4 taps from the flat buffer."""
    x = torch.clamp(uv[..., 0], 0.0, W - 1.001)
    y = torch.clamp(uv[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    base = img_idx.long() * (H * W) + y0.long() * W + x0.long()
    v00 = images_flat[base]
    v01 = images_flat[base + 1]
    v10 = images_flat[base + W]
    v11 = images_flat[base + W + 1]
    return fx, fy, v00, v01, v10, v11


def bilinear_sample_flat(images_flat: torch.Tensor, img_idx: torch.Tensor,
                         uv: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Bilinear sample I[img_idx](uv) from a flat (K*H*W,) buffer.

    uv: (..., 2) float pixel coordinates (x, y).  Out-of-bounds clamps.
    """
    fx, fy, v00, v01, v10, v11 = _bilinear_taps(images_flat, img_idx, uv, H, W)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def bilinear_sample_and_grad(images_flat: torch.Tensor, img_idx: torch.Tensor,
                             uv: torch.Tensor, H: int, W: int):
    """Bilinear sample + analytic image gradient (dI/du, dI/dv); clamped
    (off-image) samples get zero gradient."""
    fx, fy, v00, v01, v10, v11 = _bilinear_taps(images_flat, img_idx, uv, H, W)
    val = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    gx = (v01 - v00) * (1 - fy) + (v11 - v10) * fy
    gy = (v10 - v00) * (1 - fx) + (v11 - v01) * fx
    in_x = (uv[..., 0] >= 0.0) & (uv[..., 0] <= W - 1.001)
    in_y = (uv[..., 1] >= 0.0) & (uv[..., 1] <= H - 1.001)
    gx = torch.where(in_x, gx, torch.zeros_like(gx))
    gy = torch.where(in_y, gy, torch.zeros_like(gy))
    return val, gx, gy


def cam_retract(cam: PhotometricCams, delta: torch.Tensor) -> PhotometricCams:
    """8-dim camera tangent [se3(6), da, db], batched over leading dims."""
    return PhotometricCams(
        pose=se3.right_plus(cam.pose, delta[..., :6]),
        affine=cam.affine + delta[..., 6:8],
    )


def build_problem(poses, affine, inv_depth, anchor_cam, target_cam, landmark,
                  uv_ref, ref_patch, target_img, intr_ref, intr_target, valid,
                  fixed_cams, lm_valid=None) -> ba.BAProblem:
    """Assemble a photometric BAProblem; all float arguments are tensors on
    one device, index and mask arguments may be numpy or tensors."""
    device = inv_depth.device

    def idx(x):
        return torch.as_tensor(x, device=device).long()

    def mask(x):
        return torch.as_tensor(x, device=device).bool()

    if lm_valid is None:
        lm_valid = torch.ones(inv_depth.shape, dtype=torch.bool, device=device)
    obs = ba.BAObservations(
        anchor_cam=idx(anchor_cam),
        target_cam=idx(target_cam),
        landmark=idx(landmark),
        aux=PhotometricObs(
            uv_ref=uv_ref,
            ref_patch=ref_patch,
            target_img=idx(target_img),
            intr_ref=intr_ref,
            intr_target=intr_target,
        ),
        valid=mask(valid).to(inv_depth.dtype),
    )
    return ba.BAProblem(
        cam_states=PhotometricCams(pose=poses, affine=affine),
        inv_depth=inv_depth,
        obs=obs,
        fixed_cams=mask(fixed_cams),
        lm_valid=mask(lm_valid),
    )


def extract_ref_patches(images_flat: torch.Tensor, img_idx: torch.Tensor,
                        uv_ref: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Sample the 8-pixel reference patches for all landmarks: (L, 8)."""
    offs = torch.as_tensor(PATCH_OFFSETS, dtype=uv_ref.dtype,
                           device=uv_ref.device)
    uv = uv_ref[:, None, :] + offs[None, :, :]
    return bilinear_sample_flat(images_flat, img_idx[:, None], uv, H, W)


# ---------------------------------------------------------------------------
# image pyramids (coarse-to-fine photometric optimisation)
# ---------------------------------------------------------------------------


def downsample2(images: torch.Tensor) -> torch.Tensor:
    """2x2 average-pool downsampling of (K, H, W) image stacks."""
    K, H, W = images.shape
    H2, W2 = H // 2, W // 2
    x = images[:, : H2 * 2, : W2 * 2].reshape(K, H2, 2, W2, 2)
    return x.mean(dim=(2, 4))


def build_pyramid(images: torch.Tensor, levels: int = 3):
    """Returns [(images_l, H_l, W_l)] for levels 0..levels-1 (0 = full res)."""
    out = []
    cur = images
    for _ in range(levels):
        _, H, W = cur.shape
        out.append((cur, H, W))
        cur = downsample2(cur)
    return out


def scale_intrinsics(intr: torch.Tensor, level: int) -> torch.Tensor:
    """Intrinsics for pyramid level ``level`` (pixel (0,0) is the center of
    the top-left pixel): f' = f/2^l, c' = (c + 0.5)/2^l - 0.5."""
    s = float(2**level)
    return torch.cat(
        [intr[..., 0:2] / s, (intr[..., 2:4] + 0.5) / s - 0.5, intr[..., 4:]],
        dim=-1,
    )


def scale_problem_to_level(problem: ba.BAProblem, level: int) -> ba.BAProblem:
    """Rescale a level-0 photometric problem's pixel quantities to a coarser
    pyramid level (anchor pixels + both intrinsics); ``ref_patch`` must be
    re-extracted from the level's reference images by the caller."""
    if level == 0:
        return problem
    s = float(2**level)
    aux = problem.obs.aux
    aux = aux._replace(
        uv_ref=(aux.uv_ref + 0.5) / s - 0.5,
        intr_ref=scale_intrinsics(aux.intr_ref, level),
        intr_target=scale_intrinsics(aux.intr_target, level),
    )
    return problem._replace(obs=problem.obs._replace(aux=aux))


# ---------------------------------------------------------------------------
# batched residual + closed-form Jacobian, any sampler
# ---------------------------------------------------------------------------


def _warp(model: str, cam_a: PhotometricCams, cam_c: PhotometricCams,
          rho: torch.Tensor, aux: PhotometricObs, jacobian: bool):
    """Ray-form warp q = M d + rho u of every observation's patch into its
    target camera (M = Rc^T Ra, u = Rc^T (t_a - t_c); no 1/rho, so
    near-infinity landmarks stay stable) and its projection, in plane
    layout: pixel planes ``ux``, ``uy`` (P, O).  With ``jacobian`` also the
    pieces of the geometric Jacobian: the bearings ``d`` and points ``q``
    as 3 planes (P, O) each, ``M`` (O, 3, 3), ``u`` (O, 3) and the two
    projection-Jacobian rows (3 planes each)."""
    offs = torch.as_tensor(PATCH_OFFSETS, dtype=rho.dtype, device=rho.device)
    uv_patch = aux.uv_ref[:, None, :] + offs                   # (O, P, 2)
    d = cameras.unproject_unit(model, aux.intr_ref[:, None, :], uv_patch)
    Ra = se3.quat_to_matrix(se3.rotation(cam_a.pose))          # (O, 3, 3)
    RcT = se3.quat_to_matrix(se3.rotation(cam_c.pose)).transpose(1, 2)
    M = RcT @ Ra
    u = (RcT @ (se3.translation(cam_a.pose)
                - se3.translation(cam_c.pose))[:, :, None])[:, :, 0]
    q = d @ M.transpose(1, 2) + rho[:, None, None] * u[:, None, :]
    qp = [q[..., j].T for j in range(3)]                        # 3 x (P, O)
    ux, uy, J0, J1 = camera_slab.project_slab(
        model, aux.intr_target.T, qp[0], qp[1], qp[2])
    if not jacobian:
        return ux, uy
    dp = [d[..., j].T for j in range(3)]
    return ux, uy, (dp, qp, M, u, J0, J1)


def _batched_fns(model: str, sample):
    """``(residual_fn, rj_fn)`` batched over the observation axis, with
    ``sample(ux, uy, aux, want_grads) -> (val, gx, gy)`` on finite pixel
    planes (P, O).

    A non-finite projection is sampled at -1e6 (the corner, zero
    gradient) and its value set to NaN afterwards, so its residual is NaN
    and the LM loop rejects the step (padding rows are masked before
    that).  ``rj_fn`` returns r (O, P) and J (O, P, 17) in the tangent
    order [se3_a(6), a_a, b_a, se3_c(6), a_c, b_c, rho]; its ``.warp`` and
    ``.sample`` are exposed for profiling."""

    def sampled(ux, uy, aux, want_grads):
        fin = torch.isfinite(ux) & torch.isfinite(uy)
        far = torch.full_like(ux, -1e6)
        val, gx, gy = sample(torch.where(fin, ux, far),
                             torch.where(fin, uy, far), aux, want_grads)
        return torch.where(fin, val, torch.full_like(val, float("nan"))), gx, gy

    def residual_planes(val, cam_a, cam_c, aux):
        e = torch.exp(cam_c.affine[:, 0] - cam_a.affine[:, 0])   # (O,)
        ref_term = aux.ref_patch.T - cam_a.affine[:, 1]          # (P, O)
        return (val - cam_c.affine[:, 1]) - e * ref_term, e, ref_term

    def residual_fn(cam_a, cam_c, rho, aux):
        ux, uy = _warp(model, cam_a, cam_c, rho, aux, jacobian=False)
        val, _, _ = sampled(ux, uy, aux, False)
        return residual_planes(val, cam_a, cam_c, aux)[0].T

    def rj_fn(cam_a, cam_c, rho, aux):
        ux, uy, (d, q, M, u, J0, J1) = _warp(model, cam_a, cam_c, rho, aux,
                                             jacobian=True)
        val, gx, gy = sampled(ux, uy, aux, True)
        r, e, ref_term = residual_planes(val, cam_a, cam_c, aux)
        # dI/dq = g^T Jpi, then the chain through q = M d + rho u: columns
        # [dt_a, dphi_a, dt_c, dphi_c, drho] of J_geo (13 planes)
        g = [gx * J0[j] + gy * J1[j] for j in range(3)]
        a = [g[0] * M[:, 0, c] + g[1] * M[:, 1, c] + g[2] * M[:, 2, c]
             for c in range(3)]
        geo = [rho * a[0], rho * a[1], rho * a[2],
               d[1] * a[2] - d[2] * a[1], d[2] * a[0] - d[0] * a[2],
               d[0] * a[1] - d[1] * a[0],
               -rho * g[0], -rho * g[1], -rho * g[2],
               g[1] * q[2] - g[2] * q[1], g[2] * q[0] - g[0] * q[2],
               g[0] * q[1] - g[1] * q[0],
               g[0] * u[:, 0] + g[1] * u[:, 1] + g[2] * u[:, 2]]
        e_ref = e * ref_term
        e_b = e.expand_as(r)
        J = torch.stack(geo[0:6] + [e_ref, e_b] + geo[6:12]
                        + [-e_ref, torch.full_like(r, -1.0), geo[12]], dim=-1)
        return r.T, J.transpose(0, 1)                          # (O, P, 17)

    rj_fn.warp = lambda cam_a, cam_c, rho, aux: _warp(
        model, cam_a, cam_c, rho, aux, jacobian=True)
    rj_fn.sample = sample
    return residual_fn, rj_fn


def _gather_sampler(images_flat: torch.Tensor, H: int, W: int):
    def sample(ux, uy, aux, want_grads):
        uv = torch.stack([ux, uy], dim=-1)
        img = aux.target_img[None, :]
        if want_grads:
            return bilinear_sample_and_grad(images_flat, img, uv, H, W)
        return bilinear_sample_flat(images_flat, img, uv, H, W), None, None

    return sample


def make_rj_fn(model: str, images_flat: torch.Tensor, H: int, W: int):
    """Closed-form residual + Jacobian (R=8, tangent 2*8+1=17), batched
    over the observation axis, with per-tap gather sampling of the flat
    image buffer (on its device).  The projection Jacobian comes from
    ``core/camera_slab.project_slab``."""
    return _batched_fns(model, _gather_sampler(images_flat, H, W))[1]


def make_residual_fn(model: str, images_flat: torch.Tensor, H: int, W: int):
    """Photometric residual (O, 8), batched over the observation axis."""
    return _batched_fns(model, _gather_sampler(images_flat, H, W))[0]


def default_config() -> ba.BAConfig:
    # Huber on intensities (DSO uses ~9 greyvalues)
    return ba.BAConfig(max_iterations=20, huber_delta=9.0)


def _solver_on(device: torch.device, residual_fn, rj_fn):
    """``optim.fused`` solver whose ``solve``/``build`` first move the
    problem and the plan to ``device`` (a no-op where they are there)."""
    inner = fused.make_fused_ba_solver(residual_fn, cam_retract, 8,
                                       rj_fn=rj_fn)

    def solve(problem, plan, cfg: ba.BAConfig = ba.BAConfig()):
        return inner(ba.problem_to(problem, device),
                     fused.plan_to(plan, device), cfg)

    solve.build = lambda problem, plan, cfg: inner.build(
        ba.problem_to(problem, device), fused.plan_to(plan, device), cfg)
    solve.solve_lam = inner.solve_lam
    solve.fns = (residual_fn, rj_fn)
    return solve


def make_fused_solver(model: str, images_flat: torch.Tensor, H: int, W: int,
                      *, device="cuda"):
    """Plan-based fused solver with gather sampling, on ``device``: call as
    ``solve(problem, fused.plan_for_problem(problem), cfg)`` (or with the
    pair of ``fused.densify_problem``).  Returns ``solve`` with ``.build``,
    ``.solve_lam`` and ``.fns`` (the batched residual and rj functions)."""
    device = devices.resolve(device)
    images_flat = images_flat.to(device)
    res_b, rj_b = _batched_fns(model, _gather_sampler(images_flat, H, W))
    return _solver_on(device, res_b, rj_b)


# ---------------------------------------------------------------------------
# kernel-sampled batched paths (ops/patch_sample.py)
# ---------------------------------------------------------------------------


def _column_images(problem: ba.BAProblem, device) -> torch.Tensor:
    """The sampler's image of every row of ``problem`` (-1 where the row is
    not valid) and of the up to 8 zero rows the fused build appends, as
    int32 on ``device``."""
    o = problem.obs
    img = torch.where(o.valid != 0, o.aux.target_img,
                      torch.full_like(o.aux.target_img, -1))
    img = torch.cat([img, img.new_full((8,), -1)])
    return img.to(device=device, dtype=torch.int32)


def make_batched_fns(model: str, images_flat: torch.Tensor, H: int, W: int,
                     img: torch.Tensor):
    """Kernel-sampled batched ``(residual_fn, rj_fn)``: sampling runs
    through ``ops.patch_sample.sample_patches`` with the column images
    ``img`` (``_column_images`` of the problem solved; the first n of them
    for n rows), on the images' device.  (The JAX package's
    ``batched_fns_padded`` takes its lane-padded image stack; the port has
    no padded stack, so this function is both.)"""
    images3d = images_flat.to(torch.float32).reshape(-1, H, W).contiguous()

    def sample(ux, uy, aux, want_grads):
        return ps.sample_patches(images3d, ux.contiguous(), uy.contiguous(),
                                 img[:ux.shape[1]], (H, W), want_grads)

    return _batched_fns(model, sample)


def make_kernel_fused_solver(model: str, images_flat: torch.Tensor, H: int,
                             W: int, problem: ba.BAProblem, *,
                             device="cuda"):
    """Fused solver whose sampling runs through the patch kernel, on
    ``device``: call as ``solve(problem, fused.plan_for_problem(problem),
    cfg)`` (chunk build), with a problem of the same observations as
    ``problem``, in their own order.  Returns ``solve`` with ``.build``,
    ``.solve_lam``, ``.fns`` and the ``.images`` stack."""
    device = devices.resolve(device)
    images_flat = images_flat.to(device=device, dtype=torch.float32)
    res_b, rj_b = make_batched_fns(model, images_flat, H, W,
                                   _column_images(problem, device))
    solve = _solver_on(device, res_b, rj_b)
    solve.images = images_flat.reshape(-1, H, W)
    return solve


def make_kernel_dense_solver(model: str, images_flat: torch.Tensor, H: int,
                             W: int, problem_slot: ba.BAProblem, *,
                             device="cuda"):
    """Fused dense-assembly solver (``build_dense``, slot-major layout)
    whose sampling runs through the patch kernel, on ``device``.

    ``problem_slot`` must be the slot-major problem of
    ``fused.densify_problem``; pass the matching ``DenseLmSchurPlan`` to
    ``solve``.  The kernel samples the slot rows as they are, empty slots
    as zero columns.  Returns ``solve`` with ``.build``, ``.solve_lam``
    and ``.fns``."""
    device = devices.resolve(device)
    images_flat = images_flat.to(device=device, dtype=torch.float32)
    return _solver_on(device, *make_batched_fns(
        model, images_flat, H, W, _column_images(problem_slot, device)))
