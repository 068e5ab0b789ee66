"""Plain photometric refinement of a map: the reference of the
``euroc-room-pba`` configuration.

It works everything out again from the map a request hands the program
(poses, inverse depths, observations, anchor pixels, the 8-bit images and
the calibration): the problem, the image pyramid, each level's problem
and reference patches, and the coarse-to-fine Levenberg-Marquardt solve
of ``reference/lm.py``.  It imports nothing of the program.

The residual is DSO's (Engel et al., "Direct Sparse Odometry", TPAMI
2018): for landmark l anchored at pixel u in camera a with inverse depth
rho, seen by camera t, at each of the 8 points u + d_k of its pattern,

    r_k = (I_t(pi_t(R_t^T R_a b_k + rho R_t^T (t_a - t_t))) - b_t)
          - exp(a_t - a_a) (I_a(u + d_k) - b_a),

with b_k the unit bearing of u + d_k (the point b_k / rho seen from t,
scaled by rho, which every camera model's projection ignores), per-image
affine brightness (a, b), bilinear sampling clamped to [0, W - 1.001] x
[0, H - 1.001], and the Huber loss (threshold 9) on each observation's
8-vector.  A level l of the pyramid averages 2x2 blocks of the level
above; pixel coordinates scale as (u + 0.5) / 2^l - 0.5, focal lengths as
1 / 2^l.  Levels are solved coarsest first, each from the last level's
result, with 20 iterations each; frame 0's two cameras stay fixed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import lie
from benchmark.reference import lm as lmr

PATTERN = ((0, -2), (-1, -1), (1, -1), (-2, 0), (0, 0), (2, 0), (-1, 1),
           (0, 2))
HUBER = 9.0
ITERATIONS = 20
LEVELS = 3
FUNCTION_TOLERANCE = 1e-8


def bilinear(images: torch.Tensor, img: torch.Tensor, uv: torch.Tensor):
    """I[img](uv) from an (n, H, W) stack, clamped to the image; ``img``
    broadcasts against ``uv[..., 0]``."""
    _, H, W = images.shape
    x = torch.clamp(uv[..., 0], 0.0, W - 1.001)
    y = torch.clamp(uv[..., 1], 0.0, H - 1.001)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    flat = images.reshape(-1)
    base = img * (H * W) + y0.long() * W + x0.long()
    v00, v01 = flat[base], flat[base + 1]
    v10, v11 = flat[base + W], flat[base + W + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def pyramid(images: torch.Tensor, levels: int):
    out, cur = [], images
    for _ in range(levels):
        out.append(cur)
        n, H, W = cur.shape
        cur = cur[:, :H // 2 * 2, :W // 2 * 2].reshape(
            n, H // 2, 2, W // 2, 2).mean(dim=(2, 4))
    return out


def scale_intrinsics(intr: torch.Tensor, level: int) -> torch.Tensor:
    s = float(2 ** level)
    return torch.cat([intr[..., :2] / s, (intr[..., 2:4] + 0.5) / s - 0.5,
                      intr[..., 4:]], dim=-1)


class MapProblem:
    """The refinement problem of a map object (``cameras``,
    ``landmarks``, ``corners``, ``images``, ``calib``), on ``device`` in
    ``dtype``: cameras sorted by (frame, cam), landmarks by id, one row
    per non-anchor observation."""

    def __init__(self, pipe, device, dtype=torch.float64):
        self.cam_list = sorted(pipe.cameras)
        cam_index = {f: i for i, f in enumerate(self.cam_list)}
        self.lm_list = sorted(pipe.landmarks)
        self.model = pipe.calib.cam_types[0]
        self.device, self.dtype = device, dtype
        K, L = len(self.cam_list), len(self.lm_list)
        imgs = np.stack([pipe.images[f] for f in self.cam_list])
        self.images = torch.as_tensor(imgs, device=device).to(dtype)
        rho = np.zeros(L)
        uv_a = np.zeros((L, 2))
        cam_a = np.zeros(L, np.int64)
        an, tn, lmk, ia, it = [], [], [], [], []
        for j, t in enumerate(self.lm_list):
            lm = pipe.landmarks[t]
            a = min(lm.obs)
            rho[j] = lm.inv_depth
            uv_a[j] = pipe.corners[a]["uv"][lm.obs[a]]
            cam_a[j] = cam_index[a]
            for f in sorted(lm.obs)[1:]:
                an.append(cam_index[a])
                tn.append(cam_index[f])
                lmk.append(j)
                ia.append(a[1])
                it.append(f[1])
        intr = torch.as_tensor(np.asarray(pipe.calib.intrinsics),
                               dtype=dtype, device=device)

        def idx(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=device)

        self.anchor, self.target, self.landmark = idx(an), idx(tn), idx(lmk)
        self.uv_a = torch.as_tensor(uv_a, dtype=dtype, device=device)
        self.cam_of_lm = idx(cam_a)
        self.intr_a, self.intr_t = intr[idx(ia)], intr[idx(it)]
        poses = np.stack([pipe.cameras[f] for f in self.cam_list])
        self.cams0 = torch.cat([
            torch.as_tensor(poses, dtype=dtype, device=device),
            torch.zeros((K, 2), dtype=dtype, device=device)], dim=1)
        self.rho0 = torch.as_tensor(rho, dtype=dtype, device=device)
        self.fixed = torch.as_tensor(
            [f in ((0, 0), (0, 1)) for f in self.cam_list], device=device)
        self.pattern = torch.as_tensor(PATTERN, dtype=dtype, device=device)

    def level_rows(self, images_l: torch.Tensor, level: int) -> lmr.Rows:
        """The rows of pyramid ``level``: anchor pixels and intrinsics
        scaled, reference patches sampled from the level's images."""
        s = float(2 ** level)
        uv_a = (self.uv_a + 0.5) / s - 0.5
        patch = bilinear(images_l, self.cam_of_lm[:, None],
                         uv_a[:, None, :] + self.pattern)       # (L, 8)
        lm = self.landmark
        return lmr.Rows(self.anchor, self.target, lm, dict(
            images=images_l, uv=uv_a[lm], patch=patch[lm],
            intr_a=scale_intrinsics(self.intr_a, level),
            intr_t=scale_intrinsics(self.intr_t, level)))

    def warp(self, cams_a, cams_t, rho, c):
        """(O, 8, 2) pixels in the target image of the rows' patch points."""
        uvp = c["uv"][:, None, :] + self.pattern                 # (O, 8, 2)
        b = lie.unproject_unit(self.model, c["intr_a"][:, None, :], uvp)
        qa = lie.rotation(cams_a[:, :7])
        qt_inv = lie.quat_conj(lie.rotation(cams_t[:, :7]))
        t_rel = lie.translation(cams_a[:, :7]) - lie.translation(cams_t[:, :7])
        q = (lie.quat_rotate(qt_inv[:, None, :],
                             lie.quat_rotate(qa[:, None, :], b))
             + (rho[:, None] * lie.quat_rotate(qt_inv, t_rel))[:, None, :])
        return lie.project(self.model, c["intr_t"][:, None, :], q)

    def residual(self, cams_a, cams_t, rho, c):
        """(O, 8) residuals of the rows."""
        uv = self.warp(cams_a, cams_t, rho, c)
        ok = torch.isfinite(uv).all(-1)
        uv = torch.where(ok[..., None], uv, torch.zeros_like(uv))
        val = bilinear(c["images"], self.target[:, None], uv)
        val = torch.where(ok, val, torch.full_like(val, math.nan))
        aa, ba = cams_a[:, 7], cams_a[:, 8]
        at, bt = cams_t[:, 7], cams_t[:, 8]
        e = torch.exp(at - aa)
        return (val - bt[:, None]) - e[:, None] * (c["patch"] - ba[:, None])


def retract(cams: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Poses by right-plus of delta[:6], affine brightness plus
    delta[6:8]."""
    return torch.cat([lie.right_plus(cams[:, :7], delta[:, :6]),
                      cams[:, 7:9] + delta[:, 6:8]], dim=1)


def refine(pipe, device, dtype=torch.float64, tf32: bool = False,
           levels: int = LEVELS, iterations: int = ITERATIONS) -> dict:
    """Coarse-to-fine refinement of the map ``pipe`` (not modified).
    Returns the solution in ``MapProblem`` order: ``poses`` (K, 7),
    ``affine`` (K, 2), ``inv_depth`` (L,) (a depth whose refined inverse
    is not above 1e-6 keeps its input, as a refined map keeps sane
    depths), the final ``cost``, and ``levels`` (per level, coarsest
    first: initial and final cost, iterations, tries)."""
    prob = MapProblem(pipe, device, dtype)
    pyr = pyramid(prob.images, levels)
    solver = lmr.SchurLM(prob.residual, retract, 8, HUBER, prob.fixed)
    cams, rho = prob.cams0, prob.rho0
    stats, res = [], None
    with lmr.tf32(tf32):
        for level in range(levels - 1, -1, -1):
            rows = prob.level_rows(pyr[level], level)
            res = lmr.lm_fused(solver, cams, rho, rows, iterations,
                               FUNCTION_TOLERANCE)
            cams, rho = res.cams, res.rho
            stats.append(dict(level=level, initial_cost=res.initial_cost,
                              cost=res.cost, iterations=res.iterations,
                              tries=res.tries))
    rho = torch.where(rho > 1e-6, rho, prob.rho0)
    return dict(poses=cams[:, :7], affine=cams[:, 7:9], inv_depth=rho,
                cost=res.cost, levels=stats, problem=prob)


def _state(prob: MapProblem, poses, affine, rho):
    cams = torch.cat([torch.as_tensor(poses), torch.as_tensor(affine)],
                     dim=1).to(prob.device, prob.dtype)
    return cams, torch.as_tensor(rho).to(prob.device, prob.dtype)


def cost_at(prob: MapProblem, poses, affine, rho) -> float:
    """The full-resolution cost of a solution, in the problem's dtype."""
    rows = prob.level_rows(prob.images, 0)
    solver = lmr.SchurLM(prob.residual, retract, 8, HUBER, prob.fixed)
    return float(solver.cost(*_state(prob, poses, affine, rho), rows))


def newton_gap(prob: MapProblem, poses, affine, rho,
               lam: float = lmr.INIT_LAMBDA) -> dict:
    """How far a solution lies from a minimum of the full-resolution cost,
    by one damped Gauss-Newton step from it in the problem's dtype (the
    solve's own normal equations and damping at ``lam``): the decrease
    the step's quadratic model predicts, over the cost (``model_drop``),
    and the median and largest translation of a free camera in the step
    (``step_trans_med_m``, ``step_trans_max_m``)."""
    rows = prob.level_rows(prob.images, 0)
    solver = lmr.SchurLM(prob.residual, retract, 8, HUBER, prob.fixed)
    cost, neq = solver.normal_equations(*_state(prob, poses, affine, rho),
                                        rows)
    dc, dp = solver.damped_step(neq, lam)
    H_cc, W, H_pp, g_c, g_p = neq
    x = dc.reshape(-1)
    quad = x @ (H_cc @ x) + 2.0 * (x @ (W @ dp)) + (H_pp * dp * dp).sum()
    drop = -(g_c @ x + g_p @ dp + 0.5 * quad)
    t = torch.linalg.norm(dc[:, :3], dim=1)[~prob.fixed]
    return dict(model_drop=float(drop / cost),
                step_trans_med_m=float(t.median()),
                step_trans_max_m=float(t.max()))
