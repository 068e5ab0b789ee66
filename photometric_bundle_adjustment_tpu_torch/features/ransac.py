"""RANSAC for the relative pose (essential matrix) and the absolute pose
(PnP), batched over a leading axis of problems: image pairs for the
relative pose, cameras for PnP.

Port of ``photometric_bundle_adjustment_tpu/features/ransac.py``, the
batched replacement of the reference's sequential OpenGV
``sac::Ransac`` (matching_utils.h:81-176 with NISTER; map_utils.h:242-302
with EPnP).  Each problem draws a fixed number of minimal samples, solves
all of them at once, scores every hypothesis against every
correspondence, takes the best (the first on ties), refines it on its
inliers with the batched LM (``optim.lm.lm_solve_batched``, smooth
tangent-space bearing residuals f_obs x f_pred, OpenGV's
``optimize_nonlinear``) and selects the inliers again with the refined
model.  Shapes are fixed (padded correspondences and masks), and nothing
syncs the host but the LM's one check per outer iteration.

Samples come from a ``torch.Generator`` (``_sample_indices``), or, as a
test seam, are injected as indices ``idx`` (B, H, s): ``jax.random``
cannot be reproduced, so the parity tests feed both packages the JAX
package's draws.  The functions keep the dtype of the bearings; the JAX
package ran them in f32 on the TPU, the port's pipeline runs them in
f64.  Every product runs with TF32 off (``optim.ba.full_f32``): the
prescreen and the scoring are sign and threshold tests near zero.
"""

from __future__ import annotations

import math

import torch

from photometric_bundle_adjustment_tpu_torch.core import se3
from photometric_bundle_adjustment_tpu_torch.features import (
    geometry,
    nister,
    p3p,
)
from photometric_bundle_adjustment_tpu_torch.optim.ba import full_f32
from photometric_bundle_adjustment_tpu_torch.optim.lm import (
    LMConfig,
    lm_solve_batched,
)

# the Nister prescreen: the algebraic epipolar test of the reference's
# stereo check (matching_utils.h:62-79), and how many candidates of a
# problem go on to the angular scoring
PRESCREEN_THRESHOLD, PRESCREEN_TOP = 1e-3, 8
# the most (problems x hypotheses x correspondences) one scoring block
# holds
_SCORE_BLOCK = 1 << 24


def _sample_indices(generator: torch.Generator, num_hyp: int,
                    sample_size: int, valid: torch.Tensor) -> torch.Tensor:
    """(B, num_hyp, sample_size) random row indices of each problem, the
    rows of a sample distinct: every hypothesis gives each row a uniform
    score (invalid rows -1) and takes the top ``sample_size``, a batched
    Fisher-Yates equivalent.  ``valid`` (B, M)."""
    B, M = valid.shape
    u = torch.rand((B, num_hyp, M), generator=generator,
                   device=valid.device)
    u = torch.where(valid[:, None, :], u, -1.0)
    return torch.topk(u, sample_size, dim=-1).indices


def _draw(idx, generator, num_hyp, sample_size, valid):
    if idx is not None:
        idx = torch.as_tensor(idx, dtype=torch.int64, device=valid.device)
        if idx.shape[:1] + idx.shape[2:] != (valid.shape[0], sample_size):
            raise ValueError(f"injected samples {tuple(idx.shape)} are not "
                             f"({valid.shape[0]}, H, {sample_size})")
        return idx
    if generator is None:
        raise ValueError("give a generator or injected sample indices")
    return _sample_indices(generator, num_hyp, sample_size, valid)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, M, 3) at idx (B, H, s) -> (B, H, s, 3)."""
    B, H, s = idx.shape
    flat = torch.gather(x, 1, idx.reshape(B, H * s, 1).expand(-1, -1, 3))
    return flat.reshape(B, H, s, 3)


def _pose_from_Rt(R: torch.Tensor, t: torch.Tensor, dtype) -> torch.Tensor:
    return se3.make(t.to(dtype), se3.quat_from_matrix(R.to(dtype)))


def _take(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x (B, K, …) at k (B,) -> (B, …)."""
    return x[torch.arange(x.shape[0], device=x.device), k]


def _count_in_blocks(err_fn, T: torch.Tensor, M: int) -> torch.Tensor:
    """Inlier counts (B, K) of the poses T (B, K, 7), ``err_fn`` mapping
    poses (B, k, 1, 7) to inlier masks (B, k, M), over blocks of poses so
    that a block holds at most ``_SCORE_BLOCK`` (pose, row) pairs."""
    B, K = T.shape[:2]
    step = max(1, _SCORE_BLOCK // max(B * M, 1))
    return torch.cat([err_fn(T[:, s:s + step, None, :]).sum(-1)
                      for s in range(0, K, step)], dim=1)


def _refine(residual, T0: torch.Tensor, refine_iters: int) -> torch.Tensor:
    cfg = LMConfig(max_iterations=refine_iters, function_tolerance=1e-14)
    return lm_solve_batched(residual, T0, se3.right_plus, 6, cfg)[0]


# ---------------------------------------------------------------------------
# relative pose
# ---------------------------------------------------------------------------


def ransac_relative_pose(bearings0: torch.Tensor, bearings1: torch.Tensor,
                         valid: torch.Tensor,
                         generator: torch.Generator | None = None,
                         threshold: float = 5e-5, min_inliers: int = 16,
                         num_hypotheses: int = 128, refine_iters: int = 10,
                         solver: str = "nister",
                         idx: torch.Tensor | None = None):
    """Relative pose of B image pairs from their correspondences.

    bearings0, bearings1 (B, M, 3): unit bearings in images 0 and 1;
    valid (B, M) bool.  Samples come from ``generator``, or are ``idx``
    (B, H, s) (s = 5 for "nister", 8 for "eight_point").  Returns
    (T_0_1 (B, 7), inlier_mask (B, M), num_inliers (B,)), translation of
    unit length (matching_utils.h:128-131); a pair whose inlier count is
    not > min_inliers gets an empty mask and a count of 0
    (findInliersRansac, matching_utils.h:132).

    ``solver``: "nister" (the reference's five-point solver,
    matching_utils.h:111-124) draws 5-point samples, prescreens all up to
    10 candidates of each by the algebraic epipolar count
    |b0^T E b1| <= 1e-3, and decomposes the 8 best into 32 poses for the
    angular scoring; "eight_point" (the fallback) decomposes every
    sample's essential matrix into 4 poses."""
    with full_f32():
        return _relative_pose(bearings0, bearings1, valid, generator,
                              threshold, min_inliers, num_hypotheses,
                              refine_iters, solver, idx)


def _relative_pose(b0, b1, valid, generator, threshold, min_inliers,
                   num_hypotheses, refine_iters, solver, idx):
    if solver == "nister":
        idx = _draw(idx, generator, num_hypotheses, 5, valid)    # (B, H, 5)
        Es, evalid = nister.five_point_candidates(
            _gather_rows(b0, idx), _gather_rows(b1, idx))
        poses = _prescreen(b0, b1, valid, Es, evalid)
    elif solver == "eight_point":
        idx = _draw(idx, generator, num_hypotheses, 8, valid)    # (B, H, 8)
        Es = geometry.eight_point(_gather_rows(b0, idx), _gather_rows(b1, idx))
        poses = _pose_from_Rt(*geometry.decompose_essential(Es), b0.dtype)
    else:
        raise ValueError(f"unknown solver {solver!r}")
    T_best, inl = _best_relative(b0, b1, valid, poses.reshape(
        b0.shape[0], -1, 7), threshold)
    T_ref = _refine_relative(b0, b1, inl, T_best, refine_iters)
    inliers = _relative_inliers(b0, b1, valid, T_ref[:, None, None],
                                threshold)[:, 0]
    n_inl = inliers.sum(-1)
    ok = n_inl > min_inliers
    return T_ref, inliers & ok[:, None], torch.where(ok, n_inl, 0)


def _prescreen(b0, b1, valid, Es, evalid):
    """The Nister candidates Es (B, H, 10, 3, 3) (valid where ``evalid``)
    of each pair counted by the algebraic epipolar test |b0^T E b1| <=
    PRESCREEN_THRESHOLD over its valid rows; the PRESCREEN_TOP best (the
    lower index first on ties, as ``lax.top_k``) decomposed into poses
    (B, 4 PRESCREEN_TOP, 7)."""
    B, M, _ = b0.shape
    EsF = Es.reshape(B, -1, 9)
    # |b0^T E b1| of every candidate and row, as one product per pair
    outer = (b0[..., :, None] * b1[..., None, :]).reshape(B, M, 9)
    alg = torch.abs(EsF @ outer.transpose(1, 2))              # (B, 10H, M)
    cnt = ((alg <= PRESCREEN_THRESHOLD) & valid[:, None, :]).sum(-1)
    del alg
    cnt = torch.where(evalid.reshape(B, -1), cnt, -1)
    top = torch.sort(cnt, dim=-1, descending=True,
                     stable=True).indices[:, :PRESCREEN_TOP]
    Etop = torch.gather(EsF, 1, top[..., None].expand(-1, -1, 9))
    Rs, ts = geometry.decompose_essential(Etop.reshape(B, -1, 3, 3))
    return _pose_from_Rt(Rs, ts, b0.dtype).reshape(B, -1, 7)


def _relative_inliers(b0, b1, valid, T, threshold):
    """Inlier masks (B, K, M) of the poses T (B, K, 1, 7)."""
    err = geometry.reprojection_angle_error(b0[:, None], b1[:, None], T)
    return (err <= threshold) & valid[:, None]


def _best_relative(b0, b1, valid, poses, threshold):
    """The best-scoring of each pair's poses (B, K, 7) (the first on
    ties) and its inlier mask (B, M)."""
    def inliers_of(T):
        return _relative_inliers(b0, b1, valid, T, threshold)

    # torch.argmax takes the first maximum, as jnp.argmax does
    T_best = _take(poses, torch.argmax(_count_in_blocks(
        inliers_of, poses, b0.shape[1]), dim=-1))
    return T_best, inliers_of(T_best[:, None, None])[:, 0]


def relative_residual(b0, b1, inl):
    """The refinement's residual of B pairs: poses T (B, 7) -> (B, 6 M),
    the bearings' cross products with the directions to their midpoint
    triangulations in both cameras, rows outside ``inl`` (B, M) zero."""
    B = b0.shape[0]
    w = inl.to(b0.dtype)[..., None]

    def residual(T):
        Tb = T[:, None, :]
        p0 = geometry.triangulate_midpoint(b0, b1, Tb)
        p1 = se3.act(se3.inverse(Tb), p0)
        r0 = torch.linalg.cross(b0, geometry._normalized(p0), dim=-1)
        r1 = torch.linalg.cross(b1, geometry._normalized(p1), dim=-1)
        return torch.cat([r0 * w, r1 * w], dim=1).reshape(B, -1)

    return residual


def _refine_relative(b0, b1, inl, T0, refine_iters):
    """The poses T0 (B, 7) refined on their inliers (optimize_nonlinear),
    translation of unit length (the scale is not observable)."""
    T = _refine(relative_residual(b0, b1, inl), T0, refine_iters)
    t = se3.translation(T)
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)
    return se3.make(t, se3.rotation(T))


# ---------------------------------------------------------------------------
# absolute pose (PnP)
# ---------------------------------------------------------------------------


def _dlt_pnp(f: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """DLT absolute poses T_c_w (…, 7) from n >= 6 bearing-point pairs
    f, p (…, n, 3): [f]_x (R p + t) = 0 for the 12 entries of [R|t] up
    to scale, the points Hartley-normalised first; the sign fixed by
    cheirality, R projected onto SO(3), the scale fixed by R's singular
    values."""
    n = f.shape[-2]
    centroid = p.mean(dim=-2, keepdim=True)
    scale = torch.sqrt(torch.mean(torch.sum((p - centroid) ** 2, dim=-1),
                                  dim=-1)) + 1e-12
    pn = (p - centroid) / scale[..., None, None]
    # rows: skew(f) [p^T kron I, I], (3n, 12) of rank 2 per point; the
    # unknown groups the rows of [R|t]
    S = geometry.skew(f)                                   # (…, n, 3, 3)
    ph = torch.cat([pn, torch.ones_like(pn[..., :1])], dim=-1)  # (…, n, 4)
    A = (S[..., :, :, :, None] * ph[..., :, None, None, :]).reshape(
        f.shape[:-2] + (n * 3, 12))
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    Rt = Vt[..., -1, :].reshape(f.shape[:-2] + (3, 4))
    # the nullspace's sign: the one that puts the points in front
    pc_raw = (torch.sum(p[..., :, None, :] * Rt[..., None, :, :3], dim=-1)
              + Rt[..., None, :, 3])
    front = torch.sum(torch.sign(torch.sum(f * pc_raw, dim=-1)), dim=-1)
    Rt = Rt * torch.where(front < 0, -1.0, 1.0)[..., None, None]
    R_raw, t_raw = Rt[..., :3], Rt[..., 3]
    U, s, Vt2 = torch.linalg.svd(R_raw)
    d = torch.linalg.det(U @ Vt2)
    one = torch.ones_like(d)
    R = (U * torch.stack([one, one, d], dim=-1)[..., None, :]) @ Vt2
    # rescale t as R's singular values are normalised to 1
    t = t_raw * 3.0 / torch.clamp(torch.sum(s, dim=-1), min=1e-12)[..., None]
    # undo the normalisation: f ~ R (p - c)/s + t, so f ~ R p + (s t - R c)
    t = t * scale[..., None] - torch.sum(R * centroid, dim=-1)
    return _pose_from_Rt(R, t, f.dtype)


def pnp_angle_error(T_c_w: torch.Tensor, f: torch.Tensor,
                    p_w: torch.Tensor) -> torch.Tensor:
    """1 - cos of the angle between each observed bearing and the
    predicted direction (OpenGV's absolute-pose SAC error; threshold
    map_utils.h:276)."""
    return 1.0 - torch.sum(f * geometry._normalized(se3.act(T_c_w, p_w)),
                           dim=-1)


def ransac_pnp(bearings: torch.Tensor, points_w: torch.Tensor,
               valid: torch.Tensor, generator: torch.Generator | None = None,
               pixel_threshold: float = 3.0, num_hypotheses: int = 512,
               refine_iters: int = 10, lo_rounds: int = 2,
               solver: str = "p3p", idx: torch.Tensor | None = None):
    """Localise B cameras: bearings (B, M, 3) in each camera's frame,
    points_w (B, M, 3), valid (B, M) bool.  Samples come from
    ``generator``, or are ``idx`` (B, H, s) (s = 3 for "p3p", 6 for
    "dlt").  Returns (T_w_c (B, 7), inlier_mask (B, M)).

    The threshold is the reference's 1 - cos(atan(px / 500))
    (map_utils.h:276-277).  The best hypothesis is refined on its inliers
    and the inliers selected again (map_utils.h:282-301), for
    ``lo_rounds`` rounds, each kept only if it loses no inlier.
    ``solver``: "p3p" (Grunert's minimal solver, ``features.p3p``) or
    "dlt" (the 6-point Hartley-normalised DLT, the fallback)."""
    with full_f32():
        return _pnp(bearings, points_w, valid, generator, pixel_threshold,
                    num_hypotheses, refine_iters, lo_rounds, solver, idx)


def _pnp(bearings, points_w, valid, generator, pixel_threshold,
         num_hypotheses, refine_iters, lo_rounds, solver, idx):
    B, M, _ = bearings.shape
    dtype = bearings.dtype
    threshold = 1.0 - math.cos(math.atan(pixel_threshold / 500.0))
    if solver == "p3p":
        idx = _draw(idx, generator, num_hypotheses, 3, valid)
        Rs, ts, pvalid = p3p.p3p_candidates(_gather_rows(bearings, idx),
                                            _gather_rows(points_w, idx))
        T_cands = _pose_from_Rt(Rs, ts, dtype).reshape(B, -1, 7)
        cand_valid = pvalid.reshape(B, -1)
    elif solver == "dlt":
        idx = _draw(idx, generator, num_hypotheses, 6, valid)
        T_cands = _dlt_pnp(_gather_rows(bearings, idx),
                           _gather_rows(points_w, idx))          # (B, H, 7)
        cand_valid = torch.ones(T_cands.shape[:2], dtype=torch.bool,
                                device=bearings.device)
    else:
        raise ValueError(f"unknown solver {solver!r}")

    f, pw, vm = bearings[:, None], points_w[:, None], valid[:, None]

    def inliers_of(T):
        return (pnp_angle_error(T, f, pw) <= threshold) & vm

    scores = torch.where(cand_valid, _count_in_blocks(inliers_of, T_cands, M),
                         -1)
    T_ref = _take(T_cands, torch.argmax(scores, dim=-1))

    for _ in range(lo_rounds):
        inl = inliers_of(T_ref[:, None, None])[:, 0]
        w = inl.to(dtype)

        def residual(T, w=w):
            pc = se3.act(T[:, None, :], points_w)
            r = torch.linalg.cross(bearings, geometry._normalized(pc), dim=-1)
            return (r * w[..., None]).reshape(B, -1)

        T_try = _refine(residual, T_ref, refine_iters)
        # keep the refinement only if it does not lose inliers
        n_new = inliers_of(T_try[:, None, None])[:, 0].sum(-1)
        T_ref = torch.where((n_new >= inl.sum(-1))[:, None], T_try, T_ref)

    inliers = inliers_of(T_ref[:, None, None])[:, 0]
    return se3.inverse(T_ref), inliers
