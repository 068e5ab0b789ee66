"""Landmark-sharded fused-assembly bundle adjustment over a process group.

Port of ``photometric_bundle_adjustment_tpu/parallel/dist_fused.py``.  The
JAX package runs the LM loop as one ``shard_map`` program over a device
mesh; the port runs it on every rank of a ``torch.distributed`` group
(``parallel/mesh.py``), each rank holding one shard:

  * each rank assembles the camera-sized normal-equation pieces of its
    landmark shard with the fused build of ``optim/fused.py`` on its own
    host-built plan; the only collectives of the replicated solve are one
    ``psum`` per build of (cost, H_cc, S_corr0, rhs_corr0, g_c), all
    O(K^2 C^2) and independent of the landmark count, and one scalar
    ``psum`` per trial cost;
  * the damped Cholesky runs replicated (``fused.solve_lam``) and the
    inverse-depth back-substitution is shard-local;
  * with ``camera_partition=True`` the reduced camera system is solved by
    a camera-row-partitioned conjugate gradient instead: the Schur Gram
    is never formed (``BAConfig.skip_schur_gram``), each rank owns KC/D
    rows of H_cc (one ``psum_scatter``), the Schur correction is applied
    matrix-free against the landmark-sharded M, and the preconditioner is
    two-level additive Schwarz (a device-block Cholesky plus a coarse
    space of one tangent direction per rank and dimension).

Shards are landmark-aligned: a landmark's observations live on one rank,
assigned by balancing valid-observation counts over contiguous landmark
ranges (``prepare``, the JAX package's assignment exactly, its padding to
common (O_s, L_s) included, so ``lm_global_index`` is the JAX one).  This
replaces the reference's TBB/Ceres threads (map_utils.h:377-383).

Every rank takes the same decisions: each accept test reads an
all-reduced cost, which is the same bits on every rank, and the replicated
solve is deterministic on one device type, so the ranks end with
bit-equal camera states.  Matrix products run in full f32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch import interop
from photometric_bundle_adjustment_tpu_torch.models import geometric_ba
from photometric_bundle_adjustment_tpu_torch.models import photometric_ba as pba
from photometric_bundle_adjustment_tpu_torch.optim import ba, fused
from photometric_bundle_adjustment_tpu_torch.optim.ba import full_f32
from photometric_bundle_adjustment_tpu_torch.optim.schur_plan import (
    _round_up,
    build_dense_lm_plan,
    build_schur_plan,
)


class ShardedFusedProblem(NamedTuple):
    """A BAProblem split into landmark-aligned shards, numpy leaves, each
    padded to common (O_s, L_s), with one assembly plan per shard."""

    problems: tuple             # D BAProblems, obs (O_s,), landmarks (L_s,)
    plans: tuple                # D SchurPlans or DenseLmSchurPlans
    n_shards: int
    # original landmark id -> row of the padded (D * L_s,) landmark axis
    # (the shards' inverse depths concatenated in rank order)
    lm_global_index: np.ndarray
    lm_start: np.ndarray        # (D,) first landmark of each shard
    lm_count: np.ndarray        # (D,) landmarks of each shard

    def shard(self, rank: int, device):
        """``(problem, plan)`` of shard ``rank`` as tensors on ``device``."""
        return (ba.problem_to(self.problems[rank], device),
                fused.plan_to(self.plans[rank], device))

    def valid_obs(self) -> list:
        """Valid observations of each shard."""
        return [int((np.asarray(p.obs.valid) != 0).sum())
                for p in self.problems]


def _pad_leading(x: np.ndarray, n: int, fill) -> np.ndarray:
    if x.shape[0] == n:
        return x
    pad = np.full((n - x.shape[0],) + x.shape[1:], fill, x.dtype)
    return np.concatenate([x, pad])


def prepare(problem: ba.BAProblem, n_shards: int,
            layout: str = "chunk") -> ShardedFusedProblem:
    """Host-side: sort observations by landmark (stable), assign contiguous
    landmark ranges to shards balancing valid-observation counts, localise
    landmark indices, pad every shard to common (O_s, L_s), and build one
    plan per shard with its ``SegmentTree``s.

    ``layout="dense"`` reorders each shard's rows into the slot-major
    landmark-dense layout (``build_dense_lm_plan``) with a slot count S
    common to all shards; padding slots hold zeros.  The JAX package also
    pads the plans to common chunk counts, as ``shard_map`` needs; the port
    keeps each shard's plan as built."""
    D = n_shards
    p = interop.problem_to_numpy(problem)
    o = p.obs
    an, tn, ln = (np.asarray(x, np.int64) for x in (o.anchor_cam,
                                                      o.target_cam, o.landmark))
    valid = np.asarray(o.valid) != 0
    K = ba.num_cams(problem)
    L = p.inv_depth.shape[0]

    order = np.argsort(ln, kind="stable")
    # landmark -> shard by balancing valid-obs counts over contiguous ranges
    obs_per_lm = np.bincount(ln[valid], minlength=L)
    target = max(1.0, obs_per_lm.sum() / D)
    cum = np.cumsum(obs_per_lm)
    lm_shard = np.minimum((cum - 1e-9) // target, D - 1).astype(np.int64)
    lm_shard = np.maximum.accumulate(lm_shard)  # monotone over landmark id

    obs_shard = lm_shard[ln]
    L_s = int(np.bincount(lm_shard, minlength=D).max())
    O_s = int(np.bincount(obs_shard[order], minlength=D).max())
    if layout == "dense":
        # a slot count common to the shards, so padded shapes agree
        S_common = _round_up(
            max(1, int(np.bincount(ln[valid], minlength=L).max())), 2)
        O_s = L_s * S_common
    elif layout != "chunk":
        raise ValueError(f"layout {layout!r}: 'chunk' or 'dense'")

    lm_start = np.searchsorted(lm_shard, np.arange(D))
    lm_count = np.bincount(lm_shard, minlength=D)
    dtype = p.inv_depth.dtype
    problems, plans = [], []
    for d in range(D):
        sel = order[obs_shard[order] == d]
        cols = {"anchor_cam": _pad_leading(an[sel], O_s, 0),
                "target_cam": _pad_leading(tn[sel], O_s, 0),
                "valid": _pad_leading(np.asarray(o.valid)[sel], O_s, 0),
                "landmark": _pad_leading(ln[sel] - lm_start[d], O_s, 0)}
        aux = [_pad_leading(np.asarray(a)[sel], O_s, 0) for a in o.aux]
        lo, n_lm = lm_start[d], lm_count[d]
        valid_local = _pad_leading(valid[sel], O_s, False)
        if layout == "dense":
            perm, plan = build_dense_lm_plan(
                cols["anchor_cam"], cols["target_cam"], cols["landmark"], K,
                L_s, valid=valid_local, slots=S_common)
            take = np.where(perm >= 0, perm, 0)
            filled = perm >= 0
            for k in cols:
                cols[k] = np.where(filled, cols[k][take], 0)
            # slot-major: padded row s*L_s + l observes landmark l
            cols["landmark"] = np.tile(np.arange(L_s), S_common)
            aux = [np.where(filled.reshape((-1,) + (1,) * (a.ndim - 1)),
                            a[take], np.zeros_like(a[take])) for a in aux]
        else:
            plan = build_schur_plan(cols["anchor_cam"], cols["target_cam"],
                                    cols["landmark"], K, L_s,
                                    valid=valid_local)
        obs = ba.BAObservations(
            anchor_cam=cols["anchor_cam"], target_cam=cols["target_cam"],
            landmark=cols["landmark"].astype(np.int64),
            aux=type(o.aux)(*aux), valid=cols["valid"].astype(dtype))
        problems.append(ba.BAProblem(
            cam_states=p.cam_states,
            inv_depth=_pad_leading(p.inv_depth[lo:lo + n_lm], L_s, 1.0),
            obs=obs, fixed_cams=p.fixed_cams,
            lm_valid=_pad_leading(np.asarray(p.lm_valid)[lo:lo + n_lm], L_s,
                                  False)))
        plans.append(plan)
    lm_global_index = (lm_shard * L_s + np.arange(L, dtype=np.int64)
                       - lm_start[lm_shard])
    return ShardedFusedProblem(tuple(problems), tuple(plans), D,
                               lm_global_index, lm_start, lm_count)


def _cholesky_or_nan(A: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor of A, NaN where A is not positive definite
    (as the JAX package's ``cho_factor`` gives)."""
    chol, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, chol, torch.full_like(chol, math.nan))


def _cho_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.cholesky_solve(b[:, None], chol)[:, 0]


def make_distributed_fused_solver(residual_fn, cam_retract,
                                  cam_tangent_dim: int, comm, rj_fn=None,
                                  camera_partition: bool = False,
                                  n_cg: int = 200, cg_tol: float = 1e-12):
    """Returns ``solve(problem, plan, cfg) -> (problem, BAResult)`` for this
    rank's shard (``ShardedFusedProblem.shard(comm.rank, comm.device)``):
    camera states replicated, inverse depths shard-local.

    The LM loop is ``ba.lm_classic`` (the JAX loop's accept/reject and stop
    rules; ``iterations`` counts accepted steps) with collectives inside
    its build, trial cost and damped solve.  ``camera_partition=True``
    solves the reduced system by the camera-row-partitioned PCG (module
    docstring); ``n_cg`` bounds its iterations, and it stops early at
    relative residual ``cg_tol``.  ``BAResult.cg_iterations`` sums them.
    ``solve.step(problem, plan, cfg, lam)`` is one build and one damped
    solve at ``lam``: ``(delta_c, delta_p, cg_iterations)``."""
    C = cam_tangent_dim
    solver = fused.make_fused_ba_solver(residual_fn, cam_retract, C,
                                        rj_fn=rj_fn)
    res_cost_local = ba.make_residual_cost(residual_fn)
    D, rank = comm.world, comm.rank

    def build_psum(p, plan, cfg):
        cost, neq = solver.build(p, plan, cfg)
        H_cc, S0, rhs0, H_pp, g_c, g_p, M, inv0 = neq
        cost, H_cc, S0, rhs0, g_c = comm.psum(cost, H_cc, S0, rhs0, g_c,
                                              tag="build")
        return H_cc, S0, rhs0, H_pp, g_c, g_p, M, inv0

    def build_part(p, plan, cfg):
        """Partitioned build: the local Gram rows summed onto the owning
        rank, the Schur correction left as (M, inv0) for the matrix-free
        matvec, and the lambda-independent pieces of the preconditioner's
        device block and coarse space."""
        K = ba.num_cams(p)
        Kp = -(-K // D) * D           # camera-granular row padding
        KpD = Kp // D                 # cameras per rank's row slice
        KC, KCp, nloc, DC = K * C, Kp * C, Kp // D * C, D * C
        cost, neq = solver.build(p, plan, cfg._replace(skip_schur_gram=True))
        H_cc_mat, _, rhs_corr0, H_pp, g_c, g_p, M, inv0 = neq
        cost, g_c, rhs_corr0, d_cc = comm.psum(
            cost, g_c.reshape(-1), rhs_corr0, torch.diagonal(H_cc_mat),
            tag="build")
        dtype, dev = g_c.dtype, g_c.device
        # the device block of the Schur correction each rank owns, summed
        # over the landmark shards
        Mpad = M.new_zeros((M.shape[0], KCp))
        Mpad[:, :KC] = M
        Mblk = Mpad.reshape(-1, D, nloc)
        Sblk = torch.einsum("ldi,l,ldj->dij", Mblk, inv0, Mblk)
        Sblk_loc = comm.psum_scatter(Sblk, tag="build")[0]
        H_pad = H_cc_mat.new_zeros((KCp, KCp))
        H_pad[:KC, :KC] = H_cc_mat
        H_rows = comm.psum_scatter(H_pad, tag="build")       # (nloc, KCp)

        free = (~p.fixed_cams).to(dtype)
        maskK = torch.zeros(Kp, dtype=dtype, device=dev)
        maskK[:K] = free
        maskp = maskK.repeat_interleave(C)                    # (KCp,)
        row0 = rank * nloc
        mask_loc = maskp[row0:row0 + nloc]
        # the coarse space: one column per (rank, tangent dim); E = Z^T
        # S(lam) Z from a gathered block row of H and the MZ Gram
        Hm = H_rows * mask_loc[:, None] * maskp[None, :]
        blkrow = (Hm.reshape(KpD, C, KCp).sum(0)
                  .reshape(C, D, KpD, C).sum(2).reshape(C, DC))
        A_coarse = comm.all_gather(blkrow[None], tag="build").reshape(DC, DC)
        Mp = M.new_zeros((M.shape[0], KCp))
        Mp[:, :KC] = M * maskp[None, :KC]
        MZ = Mp.reshape(-1, D, KpD, C).sum(2).reshape(-1, DC)
        E_corr = comm.psum(MZ.T @ (inv0[:, None] * MZ), tag="build")
        cmask_loc = (mask_loc.reshape(KpD, C).sum(0) > 0).to(dtype)
        cmask = comm.all_gather(cmask_loc, tag="build")       # (DC,)
        return dict(K=K, KpD=KpD, KC=KC, KCp=KCp, nloc=nloc, row0=row0,
                    H_rows=H_rows, rhs_corr0=rhs_corr0, g_c=g_c, g_p=g_p,
                    M=M, inv0=inv0, Sblk_loc=Sblk_loc, d_cc=d_cc,
                    maskp=maskp, mask_loc=mask_loc, A_coarse=A_coarse,
                    E_corr=E_corr, cmask=cmask)

    def solve_lam_part(nq, lam: float):
        """The camera-row-partitioned PCG on S(lam) x = rhs; returns
        (delta_c (K, C) replicated, delta_p shard-local, CG iterations)."""
        K, KpD, KC, KCp = nq["K"], nq["KpD"], nq["KC"], nq["KCp"]
        nloc, row0 = nq["nloc"], nq["row0"]
        H_rows, M, inv0 = nq["H_rows"], nq["M"], nq["inv0"]
        maskp, mask_loc, cmask = nq["maskp"], nq["mask_loc"], nq["cmask"]
        g_c = nq["g_c"]
        d_pad = g_c.new_zeros(KCp)
        d_pad[:KC] = torch.clamp(nq["d_cc"], 1e-12, 1e32)
        d_loc = d_pad[row0:row0 + nloc]
        rhs_pad = g_c.new_zeros(KCp)
        rhs_pad[:KC] = -(g_c.reshape(-1) - nq["rhs_corr0"] / (1.0 + lam))
        rhs_loc = (rhs_pad * maskp)[row0:row0 + nloc]

        # device-block additive Schwarz: the rank's (nloc x nloc) diagonal
        # block of S(lam) = H + lam D - S_corr / (1 + lam), identity rows on
        # fixed and padding cameras
        B = (H_rows[:, row0:row0 + nloc] - nq["Sblk_loc"] / (1.0 + lam)
             + torch.diag(lam * d_loc))
        B = (B * mask_loc[:, None] * mask_loc[None, :]
             + torch.diag(1.0 - mask_loc))
        choB = _cholesky_or_nan(B)
        dcoarse = comm.all_gather(
            (lam * d_loc * mask_loc).reshape(KpD, C).sum(0), tag="solve")
        E = nq["A_coarse"] + torch.diag(dcoarse) - nq["E_corr"] / (1.0 + lam)
        E = E * cmask[:, None] * cmask[None, :] + torch.diag(1.0 - cmask)
        choE = _cholesky_or_nan(E)

        def precond(r):
            zb = _cho_solve(choB, r) * mask_loc
            rc = comm.all_gather((r * mask_loc).reshape(KpD, C).sum(0),
                                 tag="cg")
            y = _cho_solve(choE, rc * cmask) * cmask
            return zb + y[rank * C:(rank + 1) * C].repeat(KpD) * mask_loc

        def matvec(p_loc):
            p_full = comm.all_gather(p_loc, tag="cg") * maskp     # (KCp,)
            hv = H_rows @ p_full + lam * d_loc * p_full[row0:row0 + nloc]
            y = (M @ p_full[:KC]) * inv0                          # (L_s,)
            w_pad = g_c.new_zeros(KCp)
            w_pad[:KC] = (M.T @ y) / (1.0 + lam)
            return (hv - comm.psum_scatter(w_pad, tag="cg")) * mask_loc

        x = torch.zeros_like(rhs_loc)
        r = rhs_loc
        z = precond(r)
        p_dir = z
        rz, rr = comm.psum(torch.stack([torch.dot(r, z), torch.dot(r, r)]),
                           tag="cg")
        stop = cg_tol * cg_tol * rr               # rr = |rhs|^2 here
        it = 0
        while it < n_cg and bool(rr > stop):
            Sp = matvec(p_dir)
            den = comm.psum(torch.dot(p_dir, Sp), tag="cg")
            alpha = rz / torch.where(den != 0.0, den, torch.ones_like(den))
            alpha = torch.where(den > 0.0, alpha, torch.zeros_like(alpha))
            x = x + alpha * p_dir
            r = r - alpha * Sp
            z = precond(r)
            rz_new, rr = comm.psum(torch.stack([torch.dot(r, z),
                                                torch.dot(r, r)]), tag="cg")
            beta = rz_new / torch.where(rz != 0.0, rz, torch.ones_like(rz))
            p_dir = z + beta * p_dir
            rz = rz_new
            it += 1
        dc_full = comm.all_gather(x, tag="solve")
        delta_c = (dc_full * maskp)[:KC]
        delta_p = -(nq["g_p"] + M @ delta_c) * inv0 / (1.0 + lam)
        return delta_c.reshape(K, C), delta_p, it

    def apply_step(p, dc, dp):
        return p._replace(cam_states=cam_retract(p.cam_states, dc),
                          inv_depth=p.inv_depth + dp)

    def solve(problem: ba.BAProblem, plan, cfg: ba.BAConfig = ba.BAConfig()):
        free = ~problem.fixed_cams
        cg_total = [0]

        def cost_fn(p):
            return comm.psum(res_cost_local(p, cfg), tag="cost")

        if camera_partition:
            def build(p):
                return build_part(p, plan, cfg)

            def solve_lam(nq, lam):
                dc, dp, it = solve_lam_part(nq, lam)
                cg_total[0] += it
                return dc, dp
        else:
            def build(p):
                return build_psum(p, plan, cfg)

            def solve_lam(neq, lam):
                return fused.solve_lam(neq, lam, free, cfg)

        with full_f32():
            out, res = ba.lm_classic(problem, build, solve_lam, cost_fn,
                                     apply_step, cfg)
        return out, res._replace(cg_iterations=cg_total[0])

    def step(problem: ba.BAProblem, plan, cfg: ba.BAConfig, lam: float):
        with full_f32():
            if camera_partition:
                return solve_lam_part(build_part(problem, plan, cfg), lam)
            dc, dp = fused.solve_lam(build_psum(problem, plan, cfg), lam,
                                     ~problem.fixed_cams, cfg)
            return dc, dp, 0

    solve.step = step
    return solve


class Family(NamedTuple):
    """A picklable name of a BA problem family, from which each rank makes
    its residual functions: ``kind`` "geometric" (``model``) or
    "photometric" (``model`` and the flat image stack ``images`` with its
    ``H`` and ``W``, a CPU tensor shared with the ranks)."""

    kind: str
    model: str
    images: torch.Tensor | None = None
    H: int = 0
    W: int = 0


def family_fns(family: Family, device):
    """``(residual_fn, rj_fn, cam_retract, C)`` of ``family`` on
    ``device``: the closed-form rj of each model (the functions the
    single-device fused solvers use)."""
    if family.kind == "geometric":
        return (geometric_ba.make_residual_fn(family.model),
                geometric_ba.make_rj_fn(family.model),
                geometric_ba.cam_retract, 6)
    if family.kind == "photometric":
        imgs = family.images.to(device)
        return (pba.make_residual_fn(family.model, imgs, family.H, family.W),
                pba.make_rj_fn(family.model, imgs, family.H, family.W),
                pba.cam_retract, 8)
    raise ValueError(f"unknown problem family {family.kind!r}")


def _flat_bits(tree) -> torch.Tensor:
    """A tensor tree's values as one flat integer tensor of their bits."""
    leaves = [tree] if torch.is_tensor(tree) else list(tree)
    ints = {4: torch.int32, 8: torch.int64}
    return torch.cat([x.contiguous().reshape(-1)
                      .view(ints[x.element_size()]).to(torch.int64)
                      for x in leaves])


def ranks_bit_equal(comm, tree) -> bool:
    """Whether every rank holds the same bits in ``tree``: the integer
    views gathered (exact under either backend) and compared."""
    rows = comm.all_gather(_flat_bits(tree)[None], tag="check")
    return bool((rows == rows[:1]).all())


def solve_rank(comm, sharded: ShardedFusedProblem, family: Family,
               cfg: ba.BAConfig, camera_partition: bool = False,
               n_cg: int = 200, cg_tol: float = 1e-12) -> dict:
    """Rank function (``mesh.spawn``): solve this rank's shard of
    ``sharded`` and return, as numpy: the camera states, the inverse
    depths of every shard gathered into the padded (D * L_s,) layout, the
    BAResult's fields, whether every rank ended with bit-equal camera
    states, the collectives by tag and their bytes, every shard's valid
    observations, this rank's seconds, its peak device bytes over the
    solve (``torch.cuda.max_memory_allocated``, the counter reset just
    before it; 0 on the CPU) and the backend."""
    import time

    residual_fn, rj_fn, retract, C = family_fns(family, comm.device)
    problem, plan = sharded.shard(comm.rank, comm.device)
    solve = make_distributed_fused_solver(
        residual_fn, retract, C, comm, rj_fn=rj_fn,
        camera_partition=camera_partition, n_cg=n_cg, cg_tol=cg_tol)
    comm.reset_counts()
    cuda = comm.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(comm.device)
        torch.cuda.reset_peak_memory_stats(comm.device)
    t0 = time.perf_counter()
    out, res = solve(problem, plan, cfg)
    if cuda:
        torch.cuda.synchronize(comm.device)
    seconds = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated(comm.device) if cuda else 0
    calls, nbytes = dict(comm.calls), dict(comm.bytes)
    return dict(
        cam_states=interop.problem_to_numpy(out.cam_states),
        inv_depth=comm.all_gather(out.inv_depth).cpu().numpy(),
        cost=float(res.cost), initial_cost=float(res.initial_cost),
        iterations=res.iterations, lam=res.lam, tries=res.tries,
        builds=res.builds, cg_iterations=res.cg_iterations,
        ranks_bit_equal=ranks_bit_equal(comm, out.cam_states),
        calls=calls, bytes=nbytes, seconds=seconds, peak_bytes=peak_bytes,
        valid_obs=sharded.valid_obs(), backend=comm.backend)


def step_rank(comm, sharded: ShardedFusedProblem, family: Family,
              cfg: ba.BAConfig, lam: float, n_cg: int = 200,
              cg_tol: float = 1e-12) -> dict:
    """Rank function: one build and one damped solve at ``lam`` of this
    rank's shard, by the partitioned PCG and by the replicated Cholesky;
    returns both camera steps (numpy) and the CG iterations."""
    residual_fn, rj_fn, retract, C = family_fns(family, comm.device)
    problem, plan = sharded.shard(comm.rank, comm.device)
    out = {}
    for name, part in (("pcg", True), ("cholesky", False)):
        solve = make_distributed_fused_solver(
            residual_fn, retract, C, comm, rj_fn=rj_fn,
            camera_partition=part, n_cg=n_cg, cg_tol=cg_tol)
        dc, _, it = solve.step(problem, plan, cfg, lam)
        out[name] = dc.cpu().numpy()
        out[f"{name}_cg_iterations"] = it
    return out
