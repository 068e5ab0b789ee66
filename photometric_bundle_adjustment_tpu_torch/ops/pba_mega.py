"""Photometric-BA megakernel solve: warp, sample, Jacobian, Huber and Schur
payloads in one CUDA kernel, then normal-equation assembly and a damped
Schur solve in PyTorch.

Port of ``photometric_bundle_adjustment_tpu/ops/pba_mega.py``, both of its
families: the chunk-plan family for ragged maps and the dense slot-major
family (``plan_slot``) for near-uniform observation counts.  Each LM try
runs:

  phase 1 (``mega_fused``, the CUDA kernel of ``csrc/pba_mega.cu``): for
    every column of the layout, from the state (poses, affine brightness,
    inverse depths) and the static columns of ``make_mega_consts``: the
    ray-form warp q = M d + rho u, the model projection with its analytic
    Jacobian, sampling, residual, Huber weight, Jacobian rows and the
    per-observation Schur payloads, as one (184, N) f32 array laid out as
    the TPU kernel's:

      [0:136)    sqrt(weight)-scaled Jacobian rows p-major: row p*17 + c,
                 c in W order [se3_a(6), aff_a(2), se3_c(6), aff_c(2), rho]
      [136:144)  r * sw
      144        per-observation robust cost 0.5 rho(|r|^2)
      [145:162)  A0 = J^T J_rho in W order
      [162:179)  A1 = J^T r
      [179:184)  zero

    Its plain PyTorch version, ``mega_fused_reference``, is the JAX
    package's two steps: ``warp_slabs`` (the warp, the projection
    (``core/camera_slab.py``) and the two 13-column coefficient slabs
    GA/GB with J_geo[p, k] = gx[p] GA[k*P+p] + gy[p] GB[k*P+p]), then
    ``mega_rj_reference``;

  phase 2, chunk family (``build_mega_chunk``): chunk-plan normal-equation
    assembly (``optim/schur_plan.build_schur_plan`` on the kernel's
    columns), and ``solve_lam``: the damped reduced camera system by
    Cholesky and back-substitution for the inverse depths;

  phase 2, dense family (``build_mega2``): on the slot-major columns of
    ``fused.densify_problem``, landmark reductions as sums over the slot
    axis, the camera lifts as fixed-order sums with the anchor as one
    extra slot, and a component-major reduced system (row c*K + k) with
    the coupling pre-scaled by sqrt(inv0); ``solve_lam2`` solves it.

``BAConfig.sample_bf16`` picks the kernel's bf16 tier for a build: the
kernel samples a bf16 copy of the image stack (made once per solver, by
the solver's ``stack``; ``STACK_CASTS`` counts the copies) and computes
in f32 as the f32 tier does.

The kernel's columns are observation rows: the chunk family's are the
valid observations sorted by target image plus one zero column for the
plans' dummies; the dense family's are the slot rows, empty slots zero
columns.  Each column reads its own image; there are no image groups and
no padding rows.  Every sum of the assembly runs in an order fixed on the
host (``optim/fused.tree_sum``), so a build repeats bit for bit.  A
non-finite projection makes that observation's residual and cost NaN, so
the LM loop rejects the step.  Sampling clamps to the image ([0, W-1.001])
with zero gradient outside it, as the gather sampler of
``models/photometric_ba.py`` does; the TPU kernel's 24x128 window clamp
is a TPU artefact and is not ported.
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
    damped_camera_solve,
    full_f32,
    plan_to,
    solve_lam,
    tree_sum,
)
from photometric_bundle_adjustment_tpu_torch.optim.schur_plan import (
    DenseLmSchurPlan,
    SchurPlan,
    SegmentTree,
    build_schur_plan,
    build_segment_tree,
)

P = 8            # DSO patch size
OUT_ROWS = 184
ROW_COST = 144
C = 8            # camera tangent: se3(6) + affine(2)
# chunk sizes of the segment-sum plans (observations per chunk)
PAIR_CHUNK, LM_CHUNK, CAM_CHUNK = 32, 8, 256
# the kernel's camera models, in the order of its template argument
MODELS = ("pinhole", "eucm", "ds", "kb4")

# Launches of the CUDA kernel by ``mega_fused`` in this process: the f32
# tier (an f32 image stack) and the bf16 tier (a bf16 stack).
KERNEL_LAUNCHES = 0
KERNEL_LAUNCHES_BF16 = 0
# Copies of an image stack to the bf16 tier's dtype by a solver's
# ``stack`` in this process, and the bytes of the copies made.
STACK_CASTS = 0
STACK_CAST_BYTES = 0


class MegaConsts(NamedTuple):
    """Static (per-solve) columns of the kernel, one per row of its
    output, on the solve's device.  A column whose image is -1 is a zero
    column (the plans' dummy, or an empty slot)."""

    d3: torch.Tensor      # (3P, N) unit anchor-patch bearings, row j*P+p
    intr_t: torch.Tensor  # (8, N) target intrinsics
    refp: torch.Tensor    # (P, N) reference patch intensities
    an: torch.Tensor      # (N,) int64 anchor camera
    tn: torch.Tensor      # (N,) int64 target camera
    lm: torch.Tensor      # (N,) int64 landmark
    timg: torch.Tensor    # (N,) int64 target image; -1 = zero column
    cols: torch.Tensor    # (4, N) int32 rows [an, tn, lm, timg]: the kernel's


class MegaPlan(NamedTuple):
    """Dense-family assembly plan over the slot rows of a
    ``DenseLmSchurPlan``; int64 on the solve's device."""

    pg: torch.Tensor          # (NCp, Bp) slot rows; dummy -> a zero column
    cc_seg: SegmentTree       # the pair-chunk blocks into the K*K rows
    lm_cam: torch.Tensor      # (S, L) target camera of each slot; K = padding
    anchor_cam_of_lm: torch.Tensor  # (L,) anchor camera; K = no observation
    m_seg: SegmentTree        # S slots + the anchor into L*K lift rows
    gc_seg: SegmentTree       # S slots + the anchor into the K cameras


# ---------------------------------------------------------------------------
# host-side layout
# ---------------------------------------------------------------------------


def _numpy(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def build_chunk_mega_plan(problem: ba.BAProblem):
    """Chunk-plan layout for a ragged photometric problem (host, numpy).

    The kernel's columns are the valid observations sorted by target image
    (stable: an image's taps are then read by neighbouring blocks; the
    problem's own order measured the same on the card), and one zero
    column after them, which the plans' dummy entries gather.
    The chunked segment-sum plans of ``build_schur_plan`` are built on
    those columns, with exact chunk counts (no power-of-two padding:
    PyTorch compiles nothing per shape).  Returns ``(cplan, rows)``:
    ``rows`` (N,) maps each column to its observation row (-1 for the zero
    column); feed it to ``make_mega_consts`` and ``cplan`` to
    ``plan_to``."""
    o = problem.obs
    K = problem.cam_states.pose.shape[0]
    L = problem.inv_depth.shape[0]
    vidx = np.flatnonzero(_numpy(o.valid) != 0)
    timg = _numpy(o.aux.target_img)
    vidx = vidx[np.argsort(timg[vidx], kind="stable")]
    cplan = build_schur_plan(
        _numpy(o.anchor_cam)[vidx], _numpy(o.target_cam)[vidx],
        _numpy(o.landmark)[vidx], K, L, pair_chunk=PAIR_CHUNK,
        lm_chunk=LM_CHUNK, cam_chunk=CAM_CHUNK, pow2_buckets=False,
    )
    return cplan, np.r_[vidx, -1]


def build_mega_plan(problem_slot: ba.BAProblem, plan_slot: DenseLmSchurPlan):
    """Dense-family layout for a slot-major problem (host, numpy).

    ``problem_slot``/``plan_slot`` come from ``fused.densify_problem``.
    The kernel's columns are the S x L slot rows, empty slots zero
    columns; the pair chunks' dummies gather the first empty slot, or one
    zero column appended where every slot is filled.  Returns ``(plan,
    rows)`` as ``build_chunk_mega_plan``: feed ``plan`` to ``plan_to``.
    The geometric dense build (``ops/geo_mega.py``) takes the same plan."""
    K = ba.num_cams(problem_slot)
    valid = _numpy(problem_slot.obs.valid) != 0
    Os = valid.shape[0]
    rows = np.where(valid, np.arange(Os), -1)
    empty = np.flatnonzero(~valid)
    if empty.size:
        zrow = int(empty[0])
    else:
        zrow, rows = Os, np.r_[rows, -1]
    pg = _numpy(plan_slot.pg)
    lm_cam = _numpy(plan_slot.lm_cam)
    anchor = _numpy(plan_slot.anchor_cam_of_lm)
    ext = np.concatenate([lm_cam, anchor[None]], 0)
    plan = MegaPlan(pg=np.where(pg >= Os, zrow, pg), cc_seg=plan_slot.cc_seg,
                    lm_cam=lm_cam, anchor_cam_of_lm=anchor,
                    m_seg=plan_slot.m_seg,
                    gc_seg=build_segment_tree(ext, K))
    return plan, rows


def make_mega_consts(model: str, problem: ba.BAProblem,
                     rows) -> MegaConsts:
    """The static columns of observation rows ``rows`` (-1: a zero
    column), on the problem's device."""
    dev = problem.inv_depth.device
    dtype = problem.inv_depth.dtype
    rows = torch.as_tensor(np.asarray(rows), device=dev)
    ok = rows >= 0
    take = torch.where(ok, rows, torch.zeros_like(rows))
    o = problem.obs
    aux = o.aux
    offs = torch.as_tensor(PATCH_OFFSETS, dtype=dtype, device=dev)
    uv_patch = aux.uv_ref[take][:, None, :] + offs[None]      # (N, P, 2)
    dirs = cameras.unproject_unit(
        model, aux.intr_ref[take][:, None, :], uv_patch
    )                                                         # (N, P, 3)
    an, tn, lm = (x[take].long() for x in (o.anchor_cam, o.target_cam,
                                            o.landmark))
    timg = torch.where(ok, aux.target_img[take].long(),
                       torch.full_like(take, -1))
    return MegaConsts(
        d3=dirs.permute(2, 1, 0).reshape(3 * P, -1).contiguous(),
        intr_t=aux.intr_target[take].T.contiguous(),
        refp=aux.ref_patch[take].T.contiguous(),
        an=an, tn=tn, lm=lm, timg=timg,
        cols=torch.stack([an, tn, lm, timg]).to(torch.int32).contiguous(),
    )


# ---------------------------------------------------------------------------
# phase 1, plain version: the warp slabs, then the payload from them
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
    """Plane-layout warp evaluation over the columns of ``consts``: the
    first half of the kernel's plain version.

    Returns (ux, uy, fin, GA, GB): pixel planes (P, N) with non-finite
    projections replaced by -1e6, the finite mask (P, N), and the two
    (104, N) Jacobian coefficient slabs (k-major rows k*P + p).
    """
    poses = cam_states.pose
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

    d = [consts.d3[j * P:(j + 1) * P] for j in range(3)]      # 3 x (P, N)
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
        return torch.cat(blocks, dim=0)                       # (104, N)

    GA = coeff(Jpi0)
    GB = coeff(Jpi1)
    fin = torch.isfinite(ux0) & torch.isfinite(uy0)
    far = torch.full_like(ux0, -1e6)
    ux = torch.where(fin, ux0, far)
    uy = torch.where(fin, uy0, far)
    return ux, uy, fin, GA, GB


def affine_slab(affine: torch.Tensor, consts: MegaConsts) -> torch.Tensor:
    """(4, N) rows [a_r, b_r, a_t, b_t] of the anchor and target cameras."""
    aa = affine[consts.an]
    at = affine[consts.tn]
    return torch.stack([aa[:, 0], aa[:, 1], at[:, 0], at[:, 1]], dim=0)


def mega_rj_reference(images, ux, uy, GA, GB, refp, aff, timg,
                      huber_delta: float):
    """The second half of the kernel's plain version: sampling, residual,
    Huber weight and the (184, N) payload from the warp's planes.

    ``images`` is the (Kimg, H, W) f32 or bf16 stack (a bf16 stack is
    widened to f32, which is exact); ``ux``/``uy`` (P, N) are the pixel
    planes of ``warp_slabs``; ``GA``/``GB`` (104, N); ``refp`` (P, N);
    ``aff`` (4, N) rows [a_r, b_r, a_t, b_t]; ``timg`` (N,) the image of
    each column, negative for a zero column."""
    images = images.float()
    _, H, W = images.shape
    N = ux.shape[1]
    ok = timg >= 0
    img = torch.where(ok, timg, torch.zeros_like(timg)).long()
    val, gx, gy = bilinear_sample_and_grad(
        images.reshape(-1), img[None, :], torch.stack([ux, uy], dim=-1), H, W
    )                                                         # (P, N) each

    fin = ux > -1e5
    e = torch.exp(aff[2] - aff[0])                            # (N,)
    ref_term = refp - aff[1]                                  # (P, N)
    r = (val - aff[3]) - e * ref_term
    r = torch.where(fin, r, torch.full_like(r, math.nan))
    r2 = torch.sum(r * r, dim=0)                              # (N,)
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
            ).reshape(13, P, N)
    blocks17 = torch.cat([
        Jgeo[0:6],
        (e * ref_term * sw)[None], (e * sw).expand(P, N)[None],
        Jgeo[6:12],
        (-e * ref_term * sw)[None], (-sw).expand(P, N)[None],
        Jgeo[12:13],
    ], dim=0)                                                 # (17, P, N)
    rsw = r * sw
    A0 = torch.sum(blocks17 * blocks17[16][None], dim=1)      # (17, N)
    A1 = torch.sum(blocks17 * rsw[None], dim=1)
    out = torch.cat([
        blocks17.permute(1, 0, 2).reshape(P * 17, N),
        rsw, cost[None], A0, A1,
        torch.zeros((OUT_ROWS - 179, N), dtype=ux.dtype, device=ux.device),
    ], dim=0)
    # zero columns are exact zeros (the chunk plans gather dummies there)
    return torch.where(ok[None, :], out, torch.zeros_like(out))


def mega_fused_reference(model: str, images, cam_states, inv_depth,
                         consts: MegaConsts, huber_delta: float):
    """Plain PyTorch version of the megakernel: ``warp_slabs`` then
    ``mega_rj_reference`` on the columns of ``consts``."""
    ux, uy, _, GA, GB = warp_slabs(model, cam_states, inv_depth, consts)
    aff = affine_slab(cam_states.affine, consts)
    return mega_rj_reference(images, ux, uy, GA, GB, consts.refp, aff,
                             consts.timg, huber_delta)


def _lib():
    lib = _build.load("pba_mega")
    if lib.pba_mega_fused.argtypes is None:
        lib.pba_mega_fused.argtypes = (
            [ctypes.c_int] * 2                               # model, bf16
            + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]  # images, H, W
            + [ctypes.c_void_p] * 7      # pose, affine, rho, cols, d3, intr, refp
            + [ctypes.c_int, ctypes.c_float]                 # N, huber
            + [ctypes.c_void_p, ctypes.c_void_p])            # out, stream
        lib.pba_mega_fused.restype = ctypes.c_int
        lib.pba_cuda_error_string.restype = ctypes.c_char_p
        lib.pba_cuda_error_string.argtypes = [ctypes.c_int]
    return lib


def _check_kernel_inputs(model, images, cam_states, inv_depth,
                         consts: MegaConsts):
    if model not in MODELS:
        raise ValueError(f"camera model {model!r} is not one of {MODELS}")
    if images.dim() != 3:
        raise ValueError(f"images must be (Kimg, H, W), got {tuple(images.shape)}")
    if images.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"images must be torch.float32 or torch.bfloat16, "
                         f"got {images.dtype}")
    N = consts.cols.shape[-1]
    K = cam_states.pose.shape[0]
    f32 = torch.float32
    expect = {
        "images": (images, tuple(images.shape), images.dtype),
        "pose": (cam_states.pose, (K, 7), f32),
        "affine": (cam_states.affine, (K, 2), f32),
        "inv_depth": (inv_depth, (inv_depth.shape[0],), f32),
        "cols": (consts.cols, (4, N), torch.int32),
        "d3": (consts.d3, (3 * P, N), f32),
        "intr_t": (consts.intr_t, (8, N), f32),
        "refp": (consts.refp, (P, N), f32),
    }
    for name, (t, shape, dtype) in expect.items():
        if t.device != images.device:
            raise ValueError(f"{name} is on {t.device}, images on "
                             f"{images.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if N == 0:
        raise ValueError("consts hold no column")


def mega_fused(model: str, images, cam_states, inv_depth,
               consts: MegaConsts, huber_delta: float):
    """The megakernel payload (184, N) of the columns of ``consts`` at the
    state (``cam_states``: pose (K, 7), affine (K, 2); ``inv_depth``
    (L,)), sampling the (Kimg, H, W) f32 or bf16 ``images``.

    On CUDA tensors it launches the kernel of ``csrc/pba_mega.cu`` on the
    current stream (or raises): the f32 tier for an f32 stack, the bf16
    tier for a bf16 one; the state tensors are made contiguous, the rest
    must be.  On CPU tensors it runs the plain version,
    ``mega_fused_reference``.  Indices in
    ``consts`` are trusted to be in range (``make_mega_consts`` makes them
    from the problem)."""
    global KERNEL_LAUNCHES, KERNEL_LAUNCHES_BF16
    if images.device.type == "cpu":
        return mega_fused_reference(model, images, cam_states, inv_depth,
                                    consts, huber_delta)
    if images.device.type != "cuda":
        raise ValueError(f"mega_fused: unsupported device {images.device}")
    cam_states = cam_states._replace(pose=cam_states.pose.contiguous(),
                                     affine=cam_states.affine.contiguous())
    inv_depth = inv_depth.contiguous()
    _check_kernel_inputs(model, images, cam_states, inv_depth, consts)
    _, H, W = images.shape
    N = consts.cols.shape[1]
    bf16 = images.dtype == torch.bfloat16
    lib = _lib()
    out = torch.empty((OUT_ROWS, N), dtype=torch.float32,
                      device=images.device)
    stream = torch.cuda.current_stream(images.device).cuda_stream
    err = lib.pba_mega_fused(
        MODELS.index(model), int(bf16), images.data_ptr(),
        H, W, cam_states.pose.data_ptr(), cam_states.affine.data_ptr(),
        inv_depth.data_ptr(), consts.cols.data_ptr(), consts.d3.data_ptr(),
        consts.intr_t.data_ptr(), consts.refp.data_ptr(), N,
        float(huber_delta), out.data_ptr(), stream)
    if err != 0:
        msg = lib.pba_cuda_error_string(err).decode()
        raise RuntimeError(f"pba_mega_fused launch failed: {msg} ({err})")
    if bf16:
        KERNEL_LAUNCHES_BF16 += 1
    else:
        KERNEL_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# phase 1 on the card, then phase 2: assembly and the damped solve
# ---------------------------------------------------------------------------


def _payload(model: str, images, problem: ba.BAProblem, consts: MegaConsts,
             cfg: ba.BAConfig):
    """The megakernel's (184, N) payload of a build."""
    return mega_fused(model, images, problem.cam_states, problem.inv_depth,
                      consts, float(cfg.huber_delta))


def _pair_gram(J2, pg, cc_seg: SegmentTree, K: int, C: int = C):
    """H_cc (K, K, C, C) from the camera-pair Gram chunks over Jacobian
    rows ``J2`` (rows, R*(2C+1)) whose 2C+1 columns repeat per residual
    (the kernel's p-major rows: R = 8, C = 8), summed into the K*K blocks
    in the fixed order of ``cc_seg``."""
    rows = J2[pg]                                   # (NCp, Bp, R*(2C+1))
    rows2 = rows.reshape(rows.shape[0], -1, 2 * C + 1)[..., :2 * C]
    G2 = torch.bmm(rows2.transpose(1, 2), rows2)    # (NCp, 2C, 2C)
    blocks = torch.stack(
        [G2[:, :C, :C], G2[:, :C, C:], G2[:, C:, :C], G2[:, C:, C:]], dim=1
    ).reshape(-1, C * C)
    return tree_sum(blocks, cc_seg).reshape(K, K, C, C)


def build_mega_chunk(model: str, images, problem: ba.BAProblem,
                     consts: MegaConsts, cplan: SchurPlan, cfg: ba.BAConfig):
    """Megakernel + chunk-plan assembly.  Returns ``(cost, neq)`` with
    neq = (H_cc_mat, S_corr0, rhs_corr0, H_pp, g_c, g_p, M, inv0)."""
    K = problem.cam_states.pose.shape[0]
    L = problem.inv_depth.shape[0]
    out = _payload(model, images, problem, consts, cfg)

    cost = torch.sum(out[ROW_COST])
    # observation-major, so each gather below reads whole rows; the last
    # row is the zero row the plans' dummy gathers point at
    outT = out.T.contiguous()                                 # (N, 184)
    dtype = outT.dtype
    H_cc = _pair_gram(outT[:, :136], cplan.pg, cplan.cc_seg, K)

    A0 = outT[:, 145:162]                                     # (N, 17)
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
    M = tree_sum(part.reshape(part.shape[0], K * C), cplan.lm.seg)
    oh_a = _one_hot(cplan.anchor_cam_of_lm, K, dtype)         # (L, K)
    M = M + (oh_a[:, :, None] * anchor_v[:, None, :]).reshape(L, K * C)

    Mw = M * inv0[:, None]
    S_corr0 = Mw.T @ M                                        # (K*C, K*C)
    rhs_corr0 = Mw.T @ g_p

    H_cc_mat = H_cc.permute(0, 2, 1, 3).reshape(K * C, K * C)
    return cost, (H_cc_mat, S_corr0, rhs_corr0, H_pp, g_c, g_p, M, inv0)


def build_mega2(model: str, images, problem: ba.BAProblem,
                consts: MegaConsts, plan: MegaPlan, cfg: ba.BAConfig):
    """Megakernel + dense slot-major assembly.  Returns ``(cost, neq)`` with
    the contract of ``solve_lam2``: neq = (H_cc_mat, S_corr0, rhs_corr0,
    g_c, g_p, Ms, inv0, s).

    The reduced system is COMPONENT-major (row c*K + k), ``g_c`` is
    (C, K), ``Ms`` (L, C*K) is the camera coupling scaled by s = sqrt(inv0)
    (so S_corr0 = Ms^T Ms and (M dc) inv0 = s (Ms dc)).  The camera lifts
    are fixed-order sums with the anchor as one extra virtual slot
    (``plan.m_seg``, ``plan.gc_seg``): exact f32 sums, as the JAX
    package's compare-and-reduce lifts, never a one-hot product at reduced
    precision."""
    K = problem.cam_states.pose.shape[0]
    L = problem.inv_depth.shape[0]
    out = _payload(model, images, problem, consts, cfg)

    cost = torch.sum(out[ROW_COST])
    dtype = out.dtype
    # observation-major, so the pair gathers read whole rows
    outT = out.T.contiguous()                                 # (N, 184)
    H_cc = _pair_gram(outT[:, :136], plan.pg, plan.cc_seg, K)
    H_cc_mat = H_cc.permute(2, 0, 3, 1).reshape(K * C, K * C)

    # payload rows are the slot rows (empty slots are zero rows)
    S_ = plan.lm_cam.shape[0]
    AB = outT[:S_ * L, 145:179]                               # (Os, 34)
    A0r = AB[:, :17].reshape(S_, L, 17)
    A1r = AB[:, 17:].reshape(S_, L, 17)
    red0 = A0r.sum(0)                                         # (L, 17)
    anchor_v, H_pp = red0[:, :C], red0[:, 16]
    g_p = A1r[:, :, 16].sum(0)

    inv0 = problem.lm_valid.to(dtype) / torch.clamp(
        H_pp, min=cfg.min_inv_depth_hessian)
    s = torch.sqrt(inv0)

    # lifts over S+1 slots, the anchor the extra one; camera K is dropped
    vt_ext = torch.cat([A0r[:, :, C:2 * C], anchor_v[None]], 0) \
        * s[None, :, None]                                    # (S+1, L, C)
    Ms = (tree_sum(vt_ext.reshape(-1, C), plan.m_seg).reshape(L, K, C)
          .permute(0, 2, 1).reshape(L, C * K))                # c-major columns
    a1_ext = torch.cat([A1r[:, :, C:2 * C], A1r[:, :, :C].sum(0)[None]], 0)
    g_c = tree_sum(a1_ext.reshape(-1, C), plan.gc_seg).T     # (C, K)

    S_corr0 = Ms.T @ Ms                                       # (C*K, C*K)
    rhs_corr0 = (s * g_p) @ Ms
    return cost, (H_cc_mat, S_corr0, rhs_corr0, g_c, g_p, Ms, inv0, s)


def solve_lam2(neq, lam: float, free_cam_mask: torch.Tensor,
               cfg: ba.BAConfig):
    """Damped solve and back-substitution for the neq of ``build_mega2``
    (component-major reduced system).  Returns ``(delta_c (K, C),
    delta_p (L,))``; NaN deltas where the damped system is not positive
    definite (``fused.damped_camera_solve``)."""
    H_cc_mat, S_corr0, rhs_corr0, g_c, g_p, Ms, inv0, s = neq
    K = free_cam_mask.shape[0]
    C_ = H_cc_mat.shape[0] // K
    mask = free_cam_mask.to(g_c.dtype).repeat(C_)             # row c*K + k
    delta_c = damped_camera_solve(H_cc_mat, S_corr0, rhs_corr0, g_c, mask, lam)
    delta_p = -(g_p * inv0 + s * (Ms @ delta_c)) / (1.0 + lam)
    return delta_c.reshape(C_, K).T, delta_p


def make_mega_solver(model: str, images_flat: torch.Tensor, H: int, W: int,
                     problem_slot: ba.BAProblem, plan_slot=None, *,
                     device="cuda"):
    """Megakernel photometric LM solver.

    With ``plan_slot`` (the ``DenseLmSchurPlan`` of a problem reordered by
    ``fused.densify_problem``): the dense slot-major family,
    ``build_mega_plan`` + ``build_mega2`` + ``solve_lam2``.  Without it:
    the chunk-plan family over the valid observations sorted by target
    image, ``build_chunk_mega_plan`` + ``build_mega_chunk`` +
    ``solve_lam``.

    Returns ``solve(problem, cfg) -> (problem, BAResult)``, with
    ``.build(problem, cfg)``, ``.solve_lam(neq, lam, free, cfg)``, the f32
    ``.images`` stack, ``.stack(cfg)`` (the stack a build with ``cfg``
    samples), the kernel's ``.consts`` and the ``.plan`` exposed.
    ``problem_slot`` fixes the observation graph; ``solve`` takes a
    problem with the same observations and any state.  A build with
    ``cfg.sample_bf16`` samples a bf16 copy of the stack, made at the
    first ``stack`` with such a ``cfg`` (``refine_photometric`` calls it
    in the level's plan; otherwise the first such build) and kept.
    Everything runs on ``device``."""
    if plan_slot is not None and not isinstance(plan_slot, DenseLmSchurPlan):
        raise TypeError(f"plan_slot must be a DenseLmSchurPlan, got "
                        f"{type(plan_slot).__name__}")
    device = devices.resolve(device)
    problem_slot = ba.problem_to(problem_slot, device)
    images = images_flat.to(device=device, dtype=torch.float32)
    images = images.reshape(-1, H, W).contiguous()
    if plan_slot is not None:
        plan_np, rows = build_mega_plan(problem_slot, plan_slot)
        build_impl, solve_lam_impl = build_mega2, solve_lam2
    else:
        plan_np, rows = build_chunk_mega_plan(problem_slot)
        build_impl, solve_lam_impl = build_mega_chunk, solve_lam
    plan = plan_to(plan_np, device)
    consts = make_mega_consts(model, problem_slot, rows)
    stacks = {torch.float32: images}

    def stack(cfg: ba.BAConfig):
        global STACK_CASTS, STACK_CAST_BYTES
        dtype = torch.bfloat16 if cfg.sample_bf16 else torch.float32
        if dtype not in stacks:
            copy = stacks[dtype] = images.to(dtype)
            STACK_CASTS += 1
            STACK_CAST_BYTES += copy.numel() * copy.element_size()
        return stacks[dtype]

    def build(problem, cfg: ba.BAConfig):
        with full_f32():
            return build_impl(model, stack(cfg), problem, consts, plan, cfg)

    def _solve_lam(neq, lam, free, cfg: ba.BAConfig):
        with full_f32():
            return solve_lam_impl(neq, lam, free, cfg)

    def apply_step(prob, dc, dp):
        return prob._replace(cam_states=cam_retract(prob.cam_states, dc),
                             inv_depth=prob.inv_depth + dp)

    def solve(problem: ba.BAProblem, cfg: ba.BAConfig = ba.BAConfig()):
        """Fused-cost LM loop (``ba.lm_fused_cost``): the build at the
        trial point is both the accept check and, on acceptance, the next
        normal equations.  One host sync per try (the cost comparison)."""
        problem = ba.problem_to(problem, device)
        free = ~problem.fixed_cams
        return ba.lm_fused_cost(
            problem, lambda p: build(p, cfg),
            lambda neq, lam: _solve_lam(neq, lam, free, cfg), apply_step, cfg)

    solve.build = build
    solve.solve_lam = _solve_lam
    solve.images = images
    solve.stack = stack
    solve.consts = consts
    solve.plan = plan
    return solve
