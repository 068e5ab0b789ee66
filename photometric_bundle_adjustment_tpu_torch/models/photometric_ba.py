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
axis (``make_rj_fn``, ``make_residual_fn``), with one of three samplers:
per-tap gathers (``make_fused_solver``), or the patch-sampling kernel of
``ops/patch_sample.py`` on observations grouped by target image
(``make_kernel_fused_solver``) or on the slot-major layout of
``optim.fused.densify_problem`` (``make_kernel_dense_solver``).  All three
solve with ``optim.fused.make_fused_ba_solver``.  The JAX package's
``"tile"`` sampler option of ``make_rj_fn``/``make_residual_fn`` is not
ported yet (ROADMAP queue 1): they take no ``sampler`` argument.
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


def imagesort_problem(problem: ba.BAProblem, n_images: int):
    """Host-side: reorder observations into ``ops.patch_sample.group_layout``
    order (sorted by target image, each image's range padded to the
    kernel's group size, padding slots valid=0).  Returns ``(problem2,
    img_of_group, group_counts)`` (the last two int32 numpy arrays) for
    ``make_kernel_fused_solver``."""
    o = problem.obs
    dev = problem.inv_depth.device
    order, iog, gcnt = ps.group_layout(o.aux.target_img.cpu().numpy(),
                                       n_images)
    take = torch.as_tensor(np.where(order >= 0, order, 0), device=dev)
    filled = torch.as_tensor(order >= 0, device=dev)

    def reorder(x, fill=None):
        x = x[take]
        if fill is None:
            return x
        sel = filled.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(sel, x, torch.full_like(x, fill))

    aux = o.aux
    # padding slots carry their group's image, so the kernel samples a
    # well-defined location (valid=0 zeroes their rows downstream)
    timg = torch.where(filled, aux.target_img[take], torch.as_tensor(
        np.repeat(iog, ps.GROUP), dtype=torch.int64, device=dev))
    aux2 = PhotometricObs(
        uv_ref=reorder(aux.uv_ref, 0.0),
        ref_patch=reorder(aux.ref_patch, 0.0),
        target_img=timg,
        intr_ref=reorder(aux.intr_ref),
        intr_target=reorder(aux.intr_target),
    )
    obs2 = ba.BAObservations(
        anchor_cam=reorder(o.anchor_cam, 0),
        target_cam=reorder(o.target_cam, 0),
        landmark=reorder(o.landmark, 0),
        aux=aux2,
        valid=reorder(o.valid, 0),
    )
    return problem._replace(obs=obs2), iog, gcnt


def _group_tensors(images_flat, H, W, img_of_group, group_counts, device):
    """The (Kimg, H, W) f32 image stack and the int32 group tables on
    ``device``, as the kernel takes them."""
    images3d = images_flat.to(device=device, dtype=torch.float32)
    images3d = images3d.reshape(-1, H, W).contiguous()

    def i32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int32, device=device)

    return images3d, i32(img_of_group), i32(group_counts)


def _pad_cols(a: torch.Tensor, n: int) -> torch.Tensor:
    """(P, m) -> (P, n) with zero columns appended."""
    return torch.nn.functional.pad(a, (0, n - a.shape[1]))


def make_batched_fns(model: str, images_flat: torch.Tensor, H: int, W: int,
                     img_of_group, group_counts):
    """Kernel-sampled batched ``(residual_fn, rj_fn)`` for a problem in
    ``imagesort_problem`` order; the tensors stay on the images' device.

    Sampling runs through ``ops.patch_sample.sample_patches_grouped`` on
    the first Og = len(img_of_group) * 128 rows; the rows the fused build
    appends after them are padding and sample as zeros.  (The JAX
    package's ``batched_fns_padded`` takes its lane-padded image stack; the
    port has no padded stack, so this function is both.)"""
    images3d, iog, gcnt = _group_tensors(images_flat, H, W, img_of_group,
                                         group_counts, images_flat.device)
    Og = iog.shape[0] * ps.GROUP

    def sample(ux, uy, aux, want_grads):
        val, gx, gy = ps.sample_patches_grouped(
            images3d, ux[:, :Og].contiguous(), uy[:, :Og].contiguous(), iog,
            gcnt, (H, W), want_grads)
        n = ux.shape[1]
        return tuple(_pad_cols(a, n) for a in (val, gx, gy))

    return _batched_fns(model, sample)


def make_kernel_fused_solver(model: str, images_flat: torch.Tensor, H: int,
                             W: int, img_of_group, group_counts, *,
                             device="cuda"):
    """Fused chunk-plan solver whose sampling runs through the patch
    kernel, on ``device``; solve problems produced by
    ``imagesort_problem`` with ``fused.plan_for_problem`` of them.
    Returns ``solve`` with ``.build``, ``.solve_lam``, ``.fns`` and the
    ``.images`` stack."""
    device = devices.resolve(device)
    images_flat = images_flat.to(device=device, dtype=torch.float32)
    res_b, rj_b = make_batched_fns(model, images_flat, H, W, img_of_group,
                                   group_counts)
    solve = _solver_on(device, res_b, rj_b)
    solve.images = images_flat.reshape(-1, H, W)
    return solve


def make_kernel_dense_solver(model: str, images_flat: torch.Tensor, H: int,
                             W: int, problem_slot: ba.BAProblem,
                             n_images: int, *, device="cuda"):
    """Fused dense-assembly solver (``build_dense``, slot-major layout)
    whose sampling runs through the patch kernel, on ``device``.

    ``problem_slot`` must be the slot-major problem of
    ``fused.densify_problem``; pass the matching ``DenseLmSchurPlan`` to
    ``solve``.  The kernel needs observations grouped by target image, the
    dense build needs them slot-major: two static permutations, ``take_g``
    (group row -> slot row) and ``g_of_s`` (slot row -> group row), bridge
    the two orders around the sampler only.  Returns ``solve`` with
    ``.build``, ``.solve_lam`` and ``.fns``."""
    device = devices.resolve(device)
    timg_slot = problem_slot.obs.aux.target_img.cpu().numpy()
    Os = timg_slot.shape[0]
    order, iog, gcnt = ps.group_layout(timg_slot, n_images)
    take_g = np.where(order >= 0, order, 0)
    g_of_s = np.zeros(Os, np.int64)
    g_of_s[order[order >= 0]] = np.flatnonzero(order >= 0)
    take_g = torch.as_tensor(take_g, device=device)
    g_of_s = torch.as_tensor(g_of_s, device=device)
    images3d, iog, gcnt = _group_tensors(images_flat, H, W, iog, gcnt, device)

    def sample(ux, uy, aux, want_grads):
        val, gx, gy = ps.sample_patches_grouped(
            images3d, ux[:, take_g], uy[:, take_g], iog, gcnt, (H, W),
            want_grads)
        n = ux.shape[1]
        return tuple(_pad_cols(a[:, g_of_s], n) for a in (val, gx, gy))

    return _solver_on(device, *_batched_fns(model, sample))
