"""Photometric-BA megakernel solve: warp, sample, Jacobian, Huber and Schur
payloads in one CUDA kernel, then chunk-plan assembly and a damped Schur
solve in PyTorch.

Port of the chunk-plan family of ``photometric_bundle_adjustment_tpu/ops/pba_mega.py``.
Each LM try runs:

  phase 1 (``warp_slabs``, PyTorch, plane layout): pose gathers, the
    ray-form warp q = M d + rho u, the model projection with its analytic
    Jacobian (``core/camera_slab.py``) and the two 13-column coefficient
    slabs GA/GB with J_geo[p, k] = gx[p] GA[k*P+p] + gy[p] GB[k*P+p];

  phase 2 (``mega_rj``, the CUDA kernel of ``csrc/pba_mega.cu``; its plain
    PyTorch version is ``mega_rj_reference``): sampling, residual, Huber
    weight, Jacobian rows and the per-observation Schur payloads, as one
    (184, Og) f32 array laid out as the TPU kernel's:

      [0:136)    sqrt(weight)-scaled Jacobian rows p-major: row p*17 + c,
                 c in W order [se3_a(6), aff_a(2), se3_c(6), aff_c(2), rho]
      [136:144)  r * sw
      144        per-observation robust cost 0.5 rho(|r|^2)
      [145:162)  A0 = J^T J_rho in W order
      [162:179)  A1 = J^T r
      [179:184)  zero

  phase 3 (``build_mega_chunk``): chunk-plan normal-equation assembly over
    the valid observations (``optim/schur_plan.build_schur_plan`` built in
    group space), and ``solve_lam``: the damped reduced camera system by
    Cholesky and back-substitution for the inverse depths.

Observations are laid out in 256-row groups sorted by target image
(``mega_layout``).  Rows with lane >= cnt of their group are padding and
come out of the kernel as exact zeros.  A non-finite projection makes that
observation's residual and cost NaN, so the LM loop rejects the step.
Sampling clamps to the image ([0, W-1.001]) with zero gradient outside it,
as the gather sampler of ``models/photometric_ba.py`` does; the TPU
kernel's 24x128 window clamp is a TPU artefact and is not ported.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch import device as devices
from photometric_bundle_adjustment_tpu_torch.core import camera_slab, cameras
from photometric_bundle_adjustment_tpu_torch.models.photometric_ba import (
    PATCH_OFFSETS,
    bilinear_sample_and_grad,
    cam_retract,
)
from photometric_bundle_adjustment_tpu_torch.ops import _build
from photometric_bundle_adjustment_tpu_torch.optim import ba
from photometric_bundle_adjustment_tpu_torch.optim.fused import (
    _chunk_sum,
    _one_hot,
    full_f32,
    plan_to,
    solve_lam,
)
from photometric_bundle_adjustment_tpu_torch.optim.schur_plan import (
    SchurPlan,
    build_schur_plan,
)

P = 8            # DSO patch size
GROUP = 256      # observations per group (one CUDA block)
OUT_ROWS = 184
ROW_COST = 144
C = 8            # camera tangent: se3(6) + affine(2)
# chunk sizes of the segment-sum plans (observations per chunk)
PAIR_CHUNK, LM_CHUNK, CAM_CHUNK = 32, 8, 256

# Launches of the CUDA kernel by ``mega_rj`` in this process.
KERNEL_LAUNCHES = 0


class MegaConsts(NamedTuple):
    """Static (per-solve) slabs in group order, on the solve's device."""

    d3: torch.Tensor      # (3P, Og) unit anchor-patch bearings, row j*P+p
    intr_t: torch.Tensor  # (8, Og) target intrinsics slab
    refp: torch.Tensor    # (P, Og) reference patch intensities
    an: torch.Tensor      # (Og,) int64 anchor camera
    tn: torch.Tensor      # (Og,) int64 target camera
    lm: torch.Tensor      # (Og,) int64 landmark
    iog: torch.Tensor     # (ng,) int32 image of group
    cnt: torch.Tensor     # (ng,) int32 valid observations per group


# ---------------------------------------------------------------------------
# host-side layout
# ---------------------------------------------------------------------------


def mega_layout(target_img: np.ndarray, valid: np.ndarray, n_images: int):
    """Group layout over VALID observations: rows sorted by target image,
    each image's range padded to a GROUP multiple.

    Returns ``(order, img_of_group, group_counts, g_of_s, zrow)``: ``order``
    maps group rows to slot rows (-1 = padding), ``g_of_s`` maps slot rows
    to group rows (invalid slots -> ``zrow``), and ``zrow`` is a padding
    group row, whose kernel output is exactly zero."""
    ti = np.asarray(target_img)
    v = np.asarray(valid).astype(bool)
    Os = ti.shape[0]
    vidx = np.flatnonzero(v)
    counts = np.bincount(ti[vidx], minlength=n_images)
    padded = -(-counts // GROUP) * GROUP
    if padded.sum() == counts.sum():
        # no padding row anywhere: append one empty group for the zero row
        padded[0] += GROUP
    offs = np.r_[0, np.cumsum(padded)]
    order = np.full(offs[-1], -1, np.int64)
    sort_idx = vidx[np.argsort(ti[vidx], kind="stable")]
    starts = np.r_[0, np.cumsum(counts)]
    for i in range(n_images):
        if counts[i]:
            order[offs[i]: offs[i] + counts[i]] = (
                sort_idx[starts[i]: starts[i] + counts[i]]
            )
    img_of_group = np.repeat(np.arange(n_images), padded // GROUP)
    slot_base = np.arange(offs[-1]) - np.repeat(offs[:-1], padded)
    grp_start = slot_base[::GROUP]
    cnt_img = np.repeat(counts, padded // GROUP)
    group_counts = np.clip(cnt_img - grp_start, 0, GROUP)
    zrow = int(np.flatnonzero(order < 0)[0])
    g_of_s = np.full(Os, zrow, np.int64)
    g_of_s[order[order >= 0]] = np.flatnonzero(order >= 0)
    return (order, img_of_group.astype(np.int32),
            group_counts.astype(np.int32), g_of_s, zrow)


def build_chunk_mega_plan(problem: ba.BAProblem, n_images: int):
    """Chunk-plan layout for a ragged photometric problem (host, numpy).

    Lays the kernel out over valid observations only and builds the
    chunked segment-sum plans of ``build_schur_plan`` directly in group
    space, with exact chunk counts (no power-of-two padding: PyTorch
    compiles nothing per shape).  Returns ``(cplan, meta, idx_arrays)``;
    feed ``meta`` and ``idx_arrays`` to ``make_mega_consts`` and ``cplan``
    to ``plan_to``."""
    o = problem.obs
    K = problem.cam_states.pose.shape[0]
    L = problem.inv_depth.shape[0]
    valid = o.valid.cpu().numpy() != 0
    timg = o.aux.target_img.cpu().numpy()
    order, iog, cnt, g_of_s, zrow = mega_layout(timg, valid, n_images)
    Og = order.shape[0]
    take = np.where(order >= 0, order, 0)
    an_g = o.anchor_cam.cpu().numpy()[take].astype(np.int32)
    tn_g = o.target_cam.cpu().numpy()[take].astype(np.int32)
    lm_g = o.landmark.cpu().numpy()[take].astype(np.int32)
    cplan = build_schur_plan(
        an_g, tn_g, lm_g, K, L, valid=(order >= 0),
        pair_chunk=PAIR_CHUNK, lm_chunk=LM_CHUNK, cam_chunk=CAM_CHUNK,
        pow2_buckets=False,
    )
    meta = dict(order=order, take=take, Og=Og, zrow=zrow)
    return cplan, meta, (an_g, tn_g, lm_g, iog, cnt)


def make_mega_consts(model: str, problem: ba.BAProblem, meta,
                     idx_arrays) -> MegaConsts:
    """The static group-order slabs, on the problem's device."""
    an_g, tn_g, lm_g, iog, cnt = idx_arrays
    dev = problem.inv_depth.device
    dtype = problem.inv_depth.dtype
    take = torch.as_tensor(meta["take"], device=dev)
    aux = problem.obs.aux
    offs = torch.as_tensor(PATCH_OFFSETS, dtype=dtype, device=dev)
    uv_patch = aux.uv_ref[take][:, None, :] + offs[None]      # (Og, P, 2)
    dirs = cameras.unproject_unit(
        model, aux.intr_ref[take][:, None, :], uv_patch
    )                                                         # (Og, P, 3)

    def idx(x, dt=torch.int64):
        return torch.as_tensor(np.asarray(x), device=dev).to(dt)

    return MegaConsts(
        d3=dirs.permute(2, 1, 0).reshape(3 * P, -1).contiguous(),
        intr_t=aux.intr_target[take].T.contiguous(),
        refp=aux.ref_patch[take].T.contiguous(),
        an=idx(an_g), tn=idx(tn_g), lm=idx(lm_g),
        iog=idx(iog, torch.int32), cnt=idx(cnt, torch.int32),
    )


# ---------------------------------------------------------------------------
# phase 1: warp + projection + Jacobian coefficient slabs
# ---------------------------------------------------------------------------


def _rot_planes(q):
    """Unit quaternion rows (N, 4) -> 3x3 list of (N,) rotation entries."""
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return [
        [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
    ]


def warp_slabs(model: str, cam_states, inv_depth, consts: MegaConsts):
    """Group-order plane-layout warp evaluation.

    Returns (ux, uy, fin, GA, GB): pixel planes (P, Og) with non-finite
    projections replaced by -1e6, the finite mask (P, Og), and the two
    (104, Og) Jacobian coefficient slabs (k-major rows k*P + p).
    """
    poses = cam_states.pose
    pa = poses[consts.an]                                     # (Og, 7)
    pc = poses[consts.tn]
    rho = inv_depth[consts.lm][None, :]                       # (1, Og)
    Ra = _rot_planes(pa[:, 3:7])
    Rc = _rot_planes(pc[:, 3:7])
    # M = Rc^T Ra;  u = Rc^T (ta - tc)
    M = [[(Rc[0][j] * Ra[0][c] + Rc[1][j] * Ra[1][c]
           + Rc[2][j] * Ra[2][c])[None, :] for c in range(3)]
         for j in range(3)]
    dt = [pa[:, i] - pc[:, i] for i in range(3)]
    u = [(Rc[0][j] * dt[0] + Rc[1][j] * dt[1] + Rc[2][j] * dt[2])[None, :]
         for j in range(3)]

    d = [consts.d3[j * P:(j + 1) * P] for j in range(3)]      # 3 x (P, Og)
    q = [M[j][0] * d[0] + M[j][1] * d[1] + M[j][2] * d[2] + rho * u[j]
         for j in range(3)]

    ux0, uy0, Jpi0, Jpi1 = camera_slab.project_slab(
        model, consts.intr_t, q[0], q[1], q[2]
    )

    def coeff(Jp):
        a = [Jp[0] * M[0][c] + Jp[1] * M[1][c] + Jp[2] * M[2][c]
             for c in range(3)]
        blocks = [rho * a[0], rho * a[1], rho * a[2]]
        # dphi_a: d x a
        blocks += [d[1] * a[2] - d[2] * a[1],
                   d[2] * a[0] - d[0] * a[2],
                   d[0] * a[1] - d[1] * a[0]]
        # dt_c: -rho * Jpi
        blocks += [-rho * Jp[0], -rho * Jp[1], -rho * Jp[2]]
        # dphi_c: Jpi x q
        blocks += [Jp[1] * q[2] - Jp[2] * q[1],
                   Jp[2] * q[0] - Jp[0] * q[2],
                   Jp[0] * q[1] - Jp[1] * q[0]]
        # drho: Jpi . u
        blocks += [Jp[0] * u[0] + Jp[1] * u[1] + Jp[2] * u[2]]
        return torch.cat(blocks, dim=0)                       # (104, Og)

    GA = coeff(Jpi0)
    GB = coeff(Jpi1)
    fin = torch.isfinite(ux0) & torch.isfinite(uy0)
    far = torch.full_like(ux0, -1e6)
    ux = torch.where(fin, ux0, far)
    uy = torch.where(fin, uy0, far)
    return ux, uy, fin, GA, GB


def affine_slab(affine: torch.Tensor, consts: MegaConsts) -> torch.Tensor:
    """(4, Og) rows [a_r, b_r, a_t, b_t] of the anchor and target cameras."""
    aa = affine[consts.an]
    at = affine[consts.tn]
    return torch.stack([aa[:, 0], aa[:, 1], at[:, 0], at[:, 1]], dim=0)


# ---------------------------------------------------------------------------
# phase 2: the megakernel and its plain version
# ---------------------------------------------------------------------------


def mega_rj_reference(images, ux, uy, GA, GB, refp, aff, iog, cnt,
                      huber_delta: float):
    """Plain PyTorch version of the megakernel: the (184, Og) payload.

    ``images`` is the (Kimg, H, W) stack; ``ux``/``uy`` (P, Og) are the
    pixel planes of ``warp_slabs``; ``GA``/``GB`` (104, Og); ``refp``
    (P, Og); ``aff`` (4, Og) rows [a_r, b_r, a_t, b_t]; ``iog``/``cnt``
    (Og / 256,) the image and valid-row count of each group."""
    _, H, W = images.shape
    Og = ux.shape[1]
    dev = ux.device
    rows = torch.arange(Og, device=dev)
    grp = rows // GROUP
    slot_ok = (rows % GROUP) < cnt.long()[grp]                # (Og,)
    img = iog.long()[grp]
    val, gx, gy = bilinear_sample_and_grad(
        images.reshape(-1), img[None, :], torch.stack([ux, uy], dim=-1), H, W
    )                                                         # (P, Og) each

    fin = ux > -1e5
    e = torch.exp(aff[2] - aff[0])                            # (Og,)
    ref_term = refp - aff[1]                                  # (P, Og)
    r = (val - aff[3]) - e * ref_term
    r = torch.where(fin, r, torch.full_like(r, math.nan))
    r2 = torch.sum(r * r, dim=0)                              # (Og,)
    if huber_delta > 0:
        sq = torch.sqrt(r2)
        inl = r2 <= huber_delta * huber_delta
        w = torch.where(inl, torch.ones_like(r2), huber_delta / sq)
        cost = 0.5 * torch.where(
            inl, r2, 2.0 * huber_delta * sq - huber_delta * huber_delta
        )
    else:
        w = torch.ones_like(r2)
        cost = 0.5 * r2
    sw = torch.sqrt(w)

    Jgeo = ((gx.repeat(13, 1) * GA + gy.repeat(13, 1) * GB) * sw
            ).reshape(13, P, Og)
    blocks17 = torch.cat([
        Jgeo[0:6],
        (e * ref_term * sw)[None], (e * sw).expand(P, Og)[None],
        Jgeo[6:12],
        (-e * ref_term * sw)[None], (-sw).expand(P, Og)[None],
        Jgeo[12:13],
    ], dim=0)                                                 # (17, P, Og)
    rsw = r * sw
    A0 = torch.sum(blocks17 * blocks17[16][None], dim=1)      # (17, Og)
    A1 = torch.sum(blocks17 * rsw[None], dim=1)
    out = torch.cat([
        blocks17.permute(1, 0, 2).reshape(P * 17, Og),
        rsw, cost[None], A0, A1,
        torch.zeros((OUT_ROWS - 179, Og), dtype=ux.dtype, device=dev),
    ], dim=0)
    # padding rows are exact zeros (the chunk plans gather dummies there)
    return torch.where(slot_ok[None, :], out, torch.zeros_like(out))


def _kernel_fn():
    fn = _build.load("pba_mega").pba_mega_rj
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,      # images, H, W
            ctypes.c_void_p, ctypes.c_void_p,                 # ux, uy
            ctypes.c_void_p, ctypes.c_void_p,                 # GA, GB
            ctypes.c_void_p, ctypes.c_void_p,                 # refp, aff
            ctypes.c_void_p, ctypes.c_void_p,                 # iog, cnt
            ctypes.c_int, ctypes.c_float,                     # Og, huber
            ctypes.c_void_p, ctypes.c_void_p,                 # out, stream
        ]
        fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(images, ux, uy, GA, GB, refp, aff, iog, cnt):
    dev = images.device
    if images.dim() != 3:
        raise ValueError(f"images must be (Kimg, H, W), got {tuple(images.shape)}")
    if ux.dim() != 2:
        raise ValueError(f"ux must be ({P}, Og), got {tuple(ux.shape)}")
    Og = ux.shape[1]
    if Og == 0 or Og % GROUP:
        raise ValueError(f"Og={Og} must be a positive multiple of {GROUP}")
    ng = Og // GROUP
    f32, i32 = torch.float32, torch.int32
    expect = {
        "images": (images, tuple(images.shape), f32),
        "ux": (ux, (P, Og), f32), "uy": (uy, (P, Og), f32),
        "GA": (GA, (13 * P, Og), f32), "GB": (GB, (13 * P, Og), f32),
        "refp": (refp, (P, Og), f32), "aff": (aff, (4, Og), f32),
        "iog": (iog, (ng,), i32), "cnt": (cnt, (ng,), i32),
    }
    for name, (t, shape, dtype) in expect.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, images on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def mega_rj(images, ux, uy, GA, GB, refp, aff, iog, cnt,
            huber_delta: float):
    """The megakernel payload (184, Og); arguments as ``mega_rj_reference``.

    On CUDA tensors it launches the kernel of ``csrc/pba_mega.cu`` on the
    current stream (or raises); on CPU tensors it runs the plain version."""
    global KERNEL_LAUNCHES
    if images.device.type == "cpu":
        return mega_rj_reference(images, ux, uy, GA, GB, refp, aff, iog, cnt,
                                 huber_delta)
    if images.device.type != "cuda":
        raise ValueError(f"mega_rj: unsupported device {images.device}")
    _check_kernel_inputs(images, ux, uy, GA, GB, refp, aff, iog, cnt)
    _, H, W = images.shape
    Og = ux.shape[1]
    fn = _kernel_fn()
    out = torch.empty((OUT_ROWS, Og), dtype=torch.float32,
                      device=images.device)
    stream = torch.cuda.current_stream(images.device).cuda_stream
    err = fn(images.data_ptr(), H, W, ux.data_ptr(), uy.data_ptr(),
             GA.data_ptr(), GB.data_ptr(), refp.data_ptr(), aff.data_ptr(),
             iog.data_ptr(), cnt.data_ptr(), Og, float(huber_delta),
             out.data_ptr(), stream)
    if err != 0:
        lib = _build.load("pba_mega")
        lib.pba_cuda_error_string.restype = ctypes.c_char_p
        lib.pba_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.pba_cuda_error_string(err).decode()
        raise RuntimeError(f"pba_mega_rj launch failed: {msg} ({err})")
    KERNEL_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# phase 3: chunk-plan assembly and the damped solve
# ---------------------------------------------------------------------------


def build_mega_chunk(model: str, images, problem: ba.BAProblem,
                     consts: MegaConsts, cplan: SchurPlan, cfg: ba.BAConfig):
    """Megakernel + chunk-plan assembly.  Returns ``(cost, neq)`` with
    neq = (H_cc_mat, S_corr0, rhs_corr0, H_pp, g_c, g_p, M, inv0)."""
    K = problem.cam_states.pose.shape[0]
    L = problem.inv_depth.shape[0]

    ux, uy, _fin, GA, GB = warp_slabs(
        model, problem.cam_states, problem.inv_depth, consts
    )
    aff = affine_slab(problem.cam_states.affine, consts)
    out = mega_rj(images, ux, uy, GA, GB, consts.refp, aff, consts.iog,
                  consts.cnt, float(cfg.huber_delta))

    cost = torch.sum(out[ROW_COST])
    # zero dummy row at index Og: the chunk plans' dummy gathers point there
    outT = torch.nn.functional.pad(out.T, (0, 0, 0, 1))       # (Og+1, 184)
    dtype = outT.dtype

    rows = outT[:, :136][cplan.pg]                            # (NCp, Bp, 136)
    rows2 = rows.reshape(rows.shape[0], -1, 17)[..., :16]
    G2 = torch.bmm(rows2.transpose(1, 2), rows2)              # (NCp, 16, 16)
    blocks = torch.stack(
        [G2[:, :C, :C], G2[:, :C, C:], G2[:, C:, :C], G2[:, C:, C:]], dim=1
    ).reshape(-1, C * C)
    H_cc = (
        torch.zeros((K * K + 1, C * C), dtype=dtype, device=out.device)
        .index_add_(0, cplan.cc_rows4.reshape(-1), blocks)[: K * K]
        .reshape(K, K, C, C)
    )

    A0 = outT[:, 145:162]                                     # (Og+1, 17)
    A1 = outT[:, 162:179]
    pay_l = torch.cat([A0[:, :C], A0[:, 16:17], A1[:, 16:17]], dim=1)
    red_l = _chunk_sum(pay_l, cplan.lm, L)
    anchor_v, H_pp, g_p = red_l[:, :C], red_l[:, C], red_l[:, C + 1]

    g_c = (_chunk_sum(A1[:, :C].contiguous(), cplan.gc_a, K)
           + _chunk_sum(A1[:, C:2 * C].contiguous(), cplan.gc_t, K))

    lm_mask = problem.lm_valid.to(dtype)
    inv0 = lm_mask / torch.clamp(H_pp, min=cfg.min_inv_depth_hessian)
    oh = _one_hot(cplan.lm_cam, K, dtype)                     # (NC, B, K)
    rows_t = A0[:, C:2 * C][cplan.lm.gidx]                    # (NC, B, C)
    part = torch.bmm(oh.transpose(1, 2), rows_t)              # (NC, K, C)
    M = (
        torch.zeros((L + 1, K * C), dtype=dtype, device=out.device)
        .index_add_(0, cplan.lm.rows, part.reshape(part.shape[0], K * C))[:L]
    )
    oh_a = _one_hot(cplan.anchor_cam_of_lm, K, dtype)         # (L, K)
    M = M + (oh_a[:, :, None] * anchor_v[:, None, :]).reshape(L, K * C)

    Mw = M * inv0[:, None]
    S_corr0 = Mw.T @ M                                        # (K*C, K*C)
    rhs_corr0 = Mw.T @ g_p

    H_cc_mat = H_cc.permute(0, 2, 1, 3).reshape(K * C, K * C)
    return cost, (H_cc_mat, S_corr0, rhs_corr0, H_pp, g_c, g_p, M, inv0)


def _check_cfg(cfg: ba.BAConfig):
    if cfg.sample_bf16:
        raise NotImplementedError(
            "sample_bf16 is not ported yet (ROADMAP queue 1, the "
            "sample_bf16 tier); use sample_bf16=False"
        )


def make_mega_solver(model: str, images_flat: torch.Tensor, H: int, W: int,
                     problem_slot: ba.BAProblem, n_images: int,
                     plan_slot=None, *, device="cuda"):
    """Megakernel photometric LM solver, chunk-plan family.

    Returns ``solve(problem, cfg) -> (problem, BAResult)``, with
    ``.build(problem, cfg)``, ``.solve_lam(neq, lam, free, cfg)``, the
    ``.images`` stack and the group-order ``.consts`` exposed.
    ``problem_slot`` fixes the observation graph; ``solve`` takes a problem
    with the same observations and any state.  Everything runs on
    ``device``."""
    if plan_slot is not None:
        raise NotImplementedError(
            "the dense slot-major family (build_mega2/solve_lam2, plan_slot) "
            "is not ported yet (ROADMAP queue 1, the dense family); call "
            "without plan_slot for the chunk family"
        )
    device = devices.resolve(device)
    problem_slot = ba.problem_to(problem_slot, device)
    images = images_flat.to(device=device, dtype=torch.float32)
    images = images.reshape(-1, H, W).contiguous()
    cplan_np, meta, idx_arrays = build_chunk_mega_plan(problem_slot, n_images)
    cplan = plan_to(cplan_np, device)
    consts = make_mega_consts(model, problem_slot, meta, idx_arrays)

    def build(problem, cfg: ba.BAConfig):
        _check_cfg(cfg)
        with full_f32():
            return build_mega_chunk(model, images, problem, consts, cplan, cfg)

    def _solve_lam(neq, lam, free, cfg: ba.BAConfig):
        with full_f32():
            return solve_lam(neq, lam, free, cfg)

    def apply_step(prob, dc, dp):
        return prob._replace(cam_states=cam_retract(prob.cam_states, dc),
                             inv_depth=prob.inv_depth + dp)

    def solve(problem: ba.BAProblem, cfg: ba.BAConfig = ba.BAConfig()):
        """Fused-cost LM loop: the build at the trial point is both the
        accept check and, on acceptance, the next normal equations.  One
        host sync per try (the cost comparison)."""
        problem = ba.problem_to(problem, device)
        free = ~problem.fixed_cams
        init_cost, neq = build(problem, cfg)
        cost = init_cost
        cost_f = float(cost)
        lam = float(cfg.init_lambda)
        rejects = iters = tries = 0
        while (iters < cfg.max_iterations
               and tries < cfg.max_iterations * cfg.max_retries):
            dc, dp = _solve_lam(neq, lam, free, cfg)
            p_try = apply_step(problem, dc, dp)
            cost_try, neq_try = build(p_try, cfg)
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
        return problem, ba.BAResult(cost=cost, initial_cost=init_cost,
                                    iterations=iters, lam=lam, tries=tries)

    solve.build = build
    solve.solve_lam = _solve_lam
    solve.images = images
    solve.consts = consts
    return solve
