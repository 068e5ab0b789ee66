"""Photometric-BA megakernel solve: warp, sample, Jacobian, Huber and Schur
payloads in one CUDA kernel, then the normal-equation assembly and the
damped Schur solve of ``optim/fused``.

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
    package's two steps: ``warp_slabs`` (the warp, the projection and the
    two 13-column coefficient slabs GA/GB of
    ``core/camera_slab.warp_slab``, with J_geo[p, k] = gx[p] GA[k*P+p] +
    gy[p] GB[k*P+p]), then ``mega_rj_reference``;

  phase 2 (``build_mega``): the payload's Jacobian rows and A0/A1 handed
    to ``fused.assemble``, with the plan of either family: the chunk
    family's ``SchurPlan`` (``optim/schur_plan.build_schur_plan`` on the
    kernel's columns) or the dense family's ``DenseLmSchurPlan``
    (``fused.densify_problem``, slot-major); then ``fused.solve_lam``, the
    damped reduced camera system by Cholesky and back-substitution for
    the inverse depths.

``BAConfig.sample_bf16`` picks the kernel's bf16 tier for a build: the
kernel samples a bf16 copy of the image stack (made once per solver, by
the solver's ``stack``; ``STACK_CASTS`` counts the copies) and computes
in f32 as the f32 tier does.

The kernel's columns are observation rows: the chunk family's are the
valid observations sorted by target image, the dense family's the slot
rows, empty slots zero columns; each family ends with one zero column,
which the plans' dummies gather.  Each column reads its own image; there
are no image groups and no padding rows.  Every sum of the assembly runs
in an order fixed on the host (``optim/fused.tree_sum``), so a build
repeats bit for bit.  A non-finite projection makes that observation's
residual and cost NaN, so the LM loop rejects the step.  Sampling clamps
to the image ([0, W-1.001]) with zero gradient outside it, as the gather
sampler of ``models/photometric_ba.py`` does; the TPU kernel's 24x128
window clamp is a TPU artefact and is not ported.
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
from photometric_bundle_adjustment_tpu_torch.optim import ba, fused
from photometric_bundle_adjustment_tpu_torch.optim.schur_plan import (
    DenseLmSchurPlan,
    build_schur_plan,
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
    ``fused.plan_to``."""
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


def warp_slabs(model: str, cam_states, inv_depth, consts: MegaConsts):
    """Plane-layout warp evaluation over the columns of ``consts``
    (``camera_slab.warp_slab``): the first half of the kernel's plain
    version.

    Returns (ux, uy, fin, GA, GB): pixel planes (P, N) with non-finite
    projections replaced by -1e6, the finite mask (P, N), and the two
    (104, N) Jacobian coefficient slabs (k-major rows k*P + p).
    """
    poses = cam_states.pose
    ux0, uy0, GA, GB = camera_slab.warp_slab(
        model, poses[consts.an], poses[consts.tn],
        inv_depth[consts.lm][None, :], consts.d3, consts.intr_t)
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


def build_mega(model: str, images, problem: ba.BAProblem,
               consts: MegaConsts, plan, cfg: ba.BAConfig):
    """Megakernel payload + ``fused.assemble`` over the columns of
    ``consts`` with ``plan`` (a ``SchurPlan`` or a ``DenseLmSchurPlan``).
    Returns ``(cost, neq)`` with the contract of ``fused.solve_lam``."""
    out = mega_fused(model, images, problem.cam_states, problem.inv_depth,
                     consts, float(cfg.huber_delta))
    # observation-major, so each gather of the assembly reads whole rows
    outT = out.T.contiguous()                                 # (N, 184)
    return fused.assemble(torch.sum(out[ROW_COST]), outT[:, :136],
                          outT[:, 145:162], outT[:, 162:179], problem, plan,
                          cfg)


def make_mega_solver(model: str, images_flat: torch.Tensor, H: int, W: int,
                     problem_slot: ba.BAProblem, plan_slot=None, *,
                     device="cuda"):
    """Megakernel photometric LM solver.

    With ``plan_slot`` (the ``DenseLmSchurPlan`` of a problem reordered by
    ``fused.densify_problem``): the dense slot-major family, the kernel
    on the slot rows and that plan.  Without it: the chunk-plan family
    over the valid observations sorted by target image,
    ``build_chunk_mega_plan``.  Both build with ``build_mega`` and solve
    with ``fused.solve_lam``.

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
        # the slot rows, then the zero column the plan's dummies name
        valid = _numpy(problem_slot.obs.valid) != 0
        plan = plan_slot
        rows = np.r_[np.where(valid, np.arange(valid.size), -1), -1]
    else:
        plan, rows = build_chunk_mega_plan(problem_slot)
    plan = fused.plan_to(plan, device)
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
        with fused.full_f32():
            return build_mega(model, stack(cfg), problem, consts, plan, cfg)

    def _solve_lam(neq, lam, free, cfg: ba.BAConfig):
        with fused.full_f32():
            return fused.solve_lam(neq, lam, free, cfg)

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
