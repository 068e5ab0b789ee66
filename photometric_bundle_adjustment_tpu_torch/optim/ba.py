"""Bundle-adjustment problem and solver types, the robust cost, and the
scatter-add Schur-LM solver.

Port of ``photometric_bundle_adjustment_tpu/optim/ba.py``: the problem is
struct-of-arrays with static shapes (K cameras, L scalar inverse-depth
landmarks, O observation rows with a validity mask for padding), and the
solver is configured by a plain tuple of constants.  Camera states are a
tensor with leading dim K (the geometric problem's poses (K, 7)) or a
tuple of such tensors (the photometric problem's poses and affine
brightness).

``make_ba_step`` is the reference formulation: per-observation residuals
and Jacobians (a closed-form ``rj_fn`` or ``2C+1`` forward-mode passes
through the retraction, ``forward_mode_rj``), normal equations summed with
``index_add_``, and ``schur_solve`` eliminating the scalar landmark
blocks and solving the reduced camera system by Cholesky.  On the card
``index_add_`` accumulates with atomics, so its sums do not repeat bit for
bit; it is the oracle of the plan-based builds (``optim/fused.py``,
``ops/geo_mega.py``, ``ops/pba_mega.py``), whose sums run in a fixed
order, and is on no timed path.  The two LM loops shared by every solver
of the port (``lm_classic``, ``lm_fused_cost``) live here too: one host
sync per try.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, NamedTuple

import numpy as np
import torch


class BAObservations(NamedTuple):
    """Flat observation table (padding rows have ``valid == 0``)."""

    anchor_cam: torch.Tensor  # (O,) int64 camera index of the landmark's anchor
    target_cam: torch.Tensor  # (O,) int64 camera index of this observation
    landmark: torch.Tensor    # (O,) int64 landmark index
    aux: tuple                # per-observation constants, leaves (O, ...)
    valid: torch.Tensor       # (O,) float, 1 for a real observation


class BAProblem(NamedTuple):
    cam_states: tuple         # a tensor or a tuple of tensors, leading dim K
    inv_depth: torch.Tensor   # (L,)
    obs: BAObservations
    fixed_cams: torch.Tensor  # (K,) bool, gauge fixing
    lm_valid: torch.Tensor    # (L,) bool, padding landmarks are False


class BAConfig(NamedTuple):
    max_iterations: int = 20
    huber_delta: float = 1.0          # <= 0 means squared loss
    init_lambda: float = 1e-4
    min_lambda: float = 1e-12
    max_lambda: float = 1e8
    function_tolerance: float = 1e-10
    max_retries: int = 6              # consecutive rejected tries
    min_inv_depth_hessian: float = 1e-12
    # fused-cost LM loop (optim.fused only): the build at each trial point
    # is the accept check, and on acceptance its normal equations seed the
    # next iteration; no separate residual pass runs
    cost_from_build: bool = False
    # the megakernel's bf16 tier (ops/pba_mega.py): sample a bf16 copy of
    # the image stack, taps and arithmetic in f32
    sample_bf16: bool = False
    # the fused builds (optim/fused.py) leave out the Schur Gram
    # S_corr0 = Mw^T M (returned as None): the camera-partitioned solve of
    # parallel/dist_fused applies the correction matrix-free inside CG
    skip_schur_gram: bool = False


class BAResult(NamedTuple):
    cost: torch.Tensor          # final robust cost (0-d)
    initial_cost: torch.Tensor  # robust cost at the start (0-d)
    iterations: int             # accepted LM steps
    lam: float                  # final damping
    tries: int = 0              # trial points evaluated
    builds: int = 0             # normal-equation builds
    residual_passes: int = 0    # residual-only cost passes
    cg_iterations: int = 0      # CG iterations (parallel/dist_fused's PCG)


def _robust_weights(r2: torch.Tensor, delta: float) -> torch.Tensor:
    """Huber rho'(s) on squared block norms (Ceres HuberLoss semantics)."""
    if delta <= 0:
        return torch.ones_like(r2)
    sqrt_s = torch.sqrt(torch.clamp(r2, min=1e-300))
    return torch.where(r2 <= delta * delta, torch.ones_like(r2), delta / sqrt_s)


def _robust_cost(r2: torch.Tensor, delta: float) -> torch.Tensor:
    """0.5 sum rho(r2): the Huber cost of squared block norms (0-d)."""
    if delta <= 0:
        return 0.5 * torch.sum(r2)
    sqrt_s = torch.sqrt(torch.clamp(r2, min=1e-300))
    rho = torch.where(r2 <= delta * delta, r2,
                      2.0 * delta * sqrt_s - delta * delta)
    return 0.5 * torch.sum(rho)


def take_rows(tree, idx: torch.Tensor):
    """A tensor, or every leaf of a tuple tree of tensors, indexed by
    ``idx`` along its leading axis (the cameras or landmarks of each
    observation)."""
    if torch.is_tensor(tree):
        return tree[idx]
    return type(tree)(*(x[idx] for x in tree))


def num_cams(problem: BAProblem) -> int:
    """K: the leading dim of the camera states."""
    cams = problem.cam_states
    return (cams if torch.is_tensor(cams) else cams[0]).shape[0]


def problem_to(tree, device):
    """Copy of a problem (or any tuple tree of tensors or numpy arrays) as
    tensors on ``device``."""
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree, device=device)
    if isinstance(tree, tuple):
        return type(tree)(*(problem_to(x, device) for x in tree))
    return tree


@contextlib.contextmanager
def full_f32():
    """Full-f32 matrix products: the Schur Gram and the Cholesky must not
    run in TF32 (reduced precision perturbs the solve through the
    ill-conditioned reduced system)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def cholesky_solve_or_nan(S: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """S^-1 rhs by Cholesky; NaN where S is not positive definite
    (``cholesky_ex`` reports it), as the reference's NaN Cholesky gives,
    so the trial cost is NaN and the LM loop rejects the try."""
    chol, info = torch.linalg.cholesky_ex(S)
    x = torch.cholesky_solve(rhs[:, None], chol)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, math.nan))


def make_residual_cost(residual_fn: Callable):
    """The residual-cost pass of ``make_ba_step``.

    ``residual_fn(cam_a, cam_c, rho, aux) -> (O, R)`` is batched over the
    observation axis: ``cam_a``/``cam_c`` hold the anchor and target
    camera of every observation, ``rho`` (O,) its inverse depth, ``aux``
    the per-observation constants.  Returns ``residual_cost(problem,
    cfg)``, the robust cost (0-d) over the valid observations."""

    def residual_cost(problem: BAProblem, cfg: BAConfig) -> torch.Tensor:
        o = problem.obs
        r = residual_fn(take_rows(problem.cam_states, o.anchor_cam),
                        take_rows(problem.cam_states, o.target_cam),
                        problem.inv_depth[o.landmark], o.aux)
        # mask by selection, not product: a padding row's NaN must not
        # poison the cost
        r = torch.where(o.valid[:, None] != 0, r, torch.zeros_like(r))
        return _robust_cost(torch.sum(r * r, dim=-1), cfg.huber_delta)

    return residual_cost


def forward_mode_rj(residual_fn: Callable, cam_retract: Callable, C: int):
    """The JAX package's ``jacfwd`` default for ``rj_fn``: residuals and
    Jacobians through the retraction at delta = 0, batched over the
    observation axis.

    J is built by ``2C+1`` passes of ``torch.func.jvp`` over the batched
    residual ``f(d) = residual_fn(cam_retract(cam_a, d[:, :C]),
    cam_retract(cam_c, d[:, C:2C]), rho + d[:, 2C], aux)``, pass k with the
    tangent e_k on every observation.  Returns ``rj(cam_a, cam_c, rho,
    aux) -> (r (O, R), J (O, R, 2C+1))``."""
    W = 2 * C + 1

    def rj(cam_a, cam_c, rho, aux):
        zero = rho.new_zeros((rho.shape[0], W))

        def f(d):
            return residual_fn(cam_retract(cam_a, d[:, :C]),
                               cam_retract(cam_c, d[:, C:2 * C]),
                               rho + d[:, 2 * C], aux)

        cols = []
        for k in range(W):
            tangent = torch.zeros_like(zero)
            tangent[:, k] = 1.0
            r, dr = torch.func.jvp(f, (zero,), (tangent,))
            cols.append(dr)
        return r, torch.stack(cols, dim=-1)

    return rj


def make_ba_step(residual_fn: Callable, cam_retract: Callable,
                 cam_tangent_dim: int, rj_fn: Callable | None = None):
    """The residual/Jacobian/assembly machinery of a BA problem family.

    ``residual_fn`` as in ``make_residual_cost``; ``cam_retract(cams,
    delta (n, C))`` is batched over cameras; ``rj_fn(cam_a, cam_c, rho,
    aux) -> (r (O, R), J (O, R, 2C+1) or (O, R*(2C+1)))`` is the closed
    form, ``None`` for ``forward_mode_rj``.  J's columns are [anchor
    tangent (C), target tangent (C), inverse depth].

    Returns ``(residual_cost, build_normal_eqs)``; ``build_normal_eqs(
    problem, cfg)`` gives ``(cost, H_cc (K, K, C, C), H_cp (K, L, C), H_pp
    (L,), g_c (K, C), g_p (L,))``, every contribution weighted by the Huber
    IRLS weight and the validity, summed with ``index_add_`` (not
    bit-repeatable on the card; see the module docstring)."""
    C = cam_tangent_dim
    if rj_fn is None:
        rj_fn = forward_mode_rj(residual_fn, cam_retract, C)
    residual_cost = make_residual_cost(residual_fn)

    def build_normal_eqs(problem: BAProblem, cfg: BAConfig):
        o = problem.obs
        an, tn, lm = o.anchor_cam, o.target_cam, o.landmark
        K = num_cams(problem)
        L = problem.inv_depth.shape[0]
        r, J = rj_fn(take_rows(problem.cam_states, an),
                     take_rows(problem.cam_states, tn),
                     problem.inv_depth[lm], o.aux)
        J = J.reshape(r.shape[0], r.shape[1], 2 * C + 1)
        vmask = o.valid[:, None] != 0
        r = torch.where(vmask, r, torch.zeros_like(r))
        J = torch.where(vmask[:, :, None], J, torch.zeros_like(J))
        r2 = torch.sum(r * r, dim=-1)
        w = _robust_weights(r2, cfg.huber_delta) * o.valid
        cost = _robust_cost(r2, cfg.huber_delta)
        dtype = r.dtype

        Ja, Jc, Jp = J[:, :, :C], J[:, :, C:2 * C], J[:, :, 2 * C]
        wJa = Ja * w[:, None, None]
        wJc = Jc * w[:, None, None]
        wJp = Jp * w[:, None]

        # the four camera-camera blocks of every observation in one scatter
        Haa = torch.einsum("ori,orj->oij", wJa, Ja)
        Hac = torch.einsum("ori,orj->oij", wJa, Jc)
        Hcc = torch.einsum("ori,orj->oij", wJc, Jc)
        cc_idx = torch.cat([an * K + an, an * K + tn, tn * K + an,
                            tn * K + tn])
        cc_payload = torch.cat([Haa, Hac, Hac.transpose(-1, -2), Hcc])
        H_cc = (torch.zeros((K * K, C * C), dtype=dtype, device=r.device)
                .index_add_(0, cc_idx, cc_payload.reshape(-1, C * C))
                .reshape(K, K, C, C))

        Hap = torch.einsum("ori,or->oi", wJa, Jp)
        Hcp = torch.einsum("ori,or->oi", wJc, Jp)
        H_cp = (torch.zeros((K * L, C), dtype=dtype, device=r.device)
                .index_add_(0, torch.cat([an * L + lm, tn * L + lm]),
                            torch.cat([Hap, Hcp]))
                .reshape(K, L, C))
        H_pp = torch.zeros(L, dtype=dtype, device=r.device).index_add_(
            0, lm, torch.einsum("or,or->o", wJp, Jp))

        ga = torch.einsum("ori,or->oi", wJa, r)
        gc = torch.einsum("ori,or->oi", wJc, r)
        g_c = torch.zeros((K, C), dtype=dtype, device=r.device).index_add_(
            0, torch.cat([an, tn]), torch.cat([ga, gc]))
        g_p = torch.zeros(L, dtype=dtype, device=r.device).index_add_(
            0, lm, torch.einsum("or,or->o", wJp, r))
        return cost, H_cc, H_cp, H_pp, g_c, g_p

    return residual_cost, build_normal_eqs


def schur_solve(H_cc, H_cp, H_pp, g_c, g_p, lam: float,
                free_cam_mask: torch.Tensor, lm_mask: torch.Tensor,
                cfg: BAConfig):
    """Eliminate the scalar landmark blocks, solve the damped reduced
    camera system by dense Cholesky, back-substitute.  Returns
    ``(delta_c (K, C), delta_p (L,))``; NaN deltas where the damped system
    is not positive definite (``cholesky_solve_or_nan``)."""
    K, L, C = H_cp.shape
    dtype = H_cp.dtype
    H_cc_mat = H_cc.permute(0, 2, 1, 3).reshape(K * C, K * C)
    H_cp_mat = H_cp.permute(0, 2, 1).reshape(K * C, L)

    # LM damping on the diagonals (Ceres-style scaled damping)
    d_cc = torch.clamp(torch.diagonal(H_cc_mat), 1e-12, 1e32)
    H_cc_d = H_cc_mat + torch.diag(lam * d_cc)
    H_pp_d = torch.clamp(H_pp, min=cfg.min_inv_depth_hessian) * (1.0 + lam)

    # gauge fixing: zero rows/cols of fixed camera blocks, unit diagonal
    mask_c = free_cam_mask.to(dtype).repeat_interleave(C)
    inv_Hpp = lm_mask.to(dtype) / H_pp_d
    Wcp = H_cp_mat * inv_Hpp[None, :]
    S = H_cc_d - Wcp @ H_cp_mat.T
    rhs = -(g_c.reshape(K * C) - Wcp @ g_p)
    S = S * mask_c[:, None] * mask_c[None, :] + torch.diag(1.0 - mask_c)
    delta_c = cholesky_solve_or_nan(S, rhs * mask_c) * mask_c
    delta_p = -(g_p + H_cp_mat.T @ delta_c) * inv_Hpp
    return delta_c.reshape(K, C), delta_p


def lm_classic(problem: BAProblem, build: Callable, solve_lam: Callable,
               cost_fn: Callable, apply_step: Callable, cfg: BAConfig):
    """Classic LM loop: one build per iteration, then tries at growing
    lambda (x10 per reject), each a damped solve and a residual pass (one
    host sync), until one lowers the cost; lambda / 3 on acceptance.
    Stops when no try is accepted, the cost change is within
    ``function_tolerance``, or after ``max_iterations`` iterations.

    ``build(problem) -> neq``, ``solve_lam(neq, lam) -> (dc, dp)``,
    ``cost_fn(problem) -> 0-d``, ``apply_step(problem, dc, dp)``."""
    with full_f32():
        init_cost = cost_fn(problem)
        cost, cost_f = init_cost, float(init_cost)
        lam = float(cfg.init_lambda)
        iters = tries = builds = 0
        for _ in range(cfg.max_iterations):
            neq = build(problem)
            builds += 1
            accepted, n_tries = False, 0
            while (not accepted and n_tries < cfg.max_retries
                   and lam <= cfg.max_lambda):
                dc, dp = solve_lam(neq, lam)
                p_try = apply_step(problem, dc, dp)
                new_cost = cost_fn(p_try)
                c_new = float(new_cost)
                n_tries += 1
                accepted = c_new < cost_f and math.isfinite(c_new)
                if not accepted:
                    lam *= 10.0
            tries += n_tries
            if not accepted:
                break
            small = abs(cost_f - c_new) <= (
                cfg.function_tolerance * max(cost_f, 1e-300))
            problem, cost, cost_f = p_try, new_cost, c_new
            lam = max(lam / 3.0, cfg.min_lambda)
            iters += 1
            if small:
                break
    return problem, BAResult(
        cost=cost, initial_cost=init_cost, iterations=iters, lam=lam,
        tries=tries, builds=builds, residual_passes=tries + 1)


def lm_fused_cost(problem: BAProblem, build: Callable, solve_lam: Callable,
                  apply_step: Callable, cfg: BAConfig):
    """Fused-cost LM loop, one host sync per try: each try solves the
    damped system from the carried normal equations and builds at the
    trial point; the build's cost is the accept check and, on acceptance,
    its normal equations seed the next iteration.  Same accept criterion,
    lambda schedule and termination as ``lm_classic``, with at most
    ``max_retries`` consecutive rejects.

    ``build(problem) -> (cost, neq)``; the rest as in ``lm_classic``."""
    with full_f32():
        init_cost, neq = build(problem)
        cost, cost_f = init_cost, float(init_cost)
        lam = float(cfg.init_lambda)
        rejects = iters = tries = 0
        while (iters < cfg.max_iterations
               and tries < cfg.max_iterations * cfg.max_retries):
            dc, dp = solve_lam(neq, lam)
            p_try = apply_step(problem, dc, dp)
            cost_try, neq_try = build(p_try)
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
    return problem, BAResult(
        cost=cost, initial_cost=init_cost, iterations=iters, lam=lam,
        tries=tries, builds=tries + 1)


def make_ba_solver(residual_fn: Callable, cam_retract: Callable,
                   cam_tangent_dim: int, rj_fn: Callable | None = None):
    """The LM solver over ``make_ba_step``.  Returns ``solve(problem, cfg)
    -> (problem, BAResult)``: ``lm_classic`` with ``schur_solve``, on the
    problem's device.  (The JAX package's ``normal_eq_fn``/``cost_fn``
    overrides serve its GSPMD ``parallel.dist_ba``, which is not
    ported.)"""
    cost_fn, build_neq = make_ba_step(residual_fn, cam_retract,
                                      cam_tangent_dim, rj_fn=rj_fn)

    def apply_step(problem: BAProblem, delta_c, delta_p):
        return problem._replace(
            cam_states=cam_retract(problem.cam_states, delta_c),
            inv_depth=problem.inv_depth + delta_p)

    def solve(problem: BAProblem, cfg: BAConfig = BAConfig()):
        free = ~problem.fixed_cams

        def build(p):
            return build_neq(p, cfg)[1:]

        def solve_lam(neq, lam):
            return schur_solve(*neq, lam, free, problem.lm_valid, cfg)

        return lm_classic(problem, build, solve_lam,
                          lambda p: cost_fn(p, cfg), apply_step, cfg)

    return solve
