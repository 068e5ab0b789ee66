"""Plain geometric (reprojection) bundle adjustment: the reference of the
``sfm-geo-ba`` configuration.

The residual of an observation of landmark l (anchored at pixel u of
camera a, inverse depth rho) in camera t at measured pixel m is the
reference SfM's reprojection error (the TUM visnav ``sfm`` binary's
``BundleAdjustmentReprojectionCostFunctor``):

    r = m - pi_t(T_t^-1 T_a (b / rho)),   b = pi_a^-1(u) (unit bearing),

evaluated as pi_t(R_t^T R_a b + rho R_t^T (t_a - t_t)), which is the same
point scaled by rho and so projects to the same pixel, and stays finite
for landmarks near infinity.  Huber loss with a 1 px threshold on the
2-vector, poses by right-plus, frame 0's cameras fixed, 20 iterations of
``reference/lm.lm_classic``.  It imports nothing of the program.
"""

from __future__ import annotations

import torch

from benchmark import lie
from benchmark.reference import lm as lmr

HUBER = 1.0
ITERATIONS = 20
FUNCTION_TOLERANCE = 1e-10


class GeoProblem:
    """A ``scenes.GeoRequest`` on ``device`` in ``dtype``."""

    def __init__(self, req, device, dtype=torch.float64):
        self.model = req.model
        self.device, self.dtype = device, dtype

        def f(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        def i(x):
            return torch.as_tensor(x, device=device).long()

        self.rows = lmr.Rows(i(req.anchor_cam), i(req.target_cam),
                             i(req.landmark),
                             dict(uv_t=f(req.uv_target), uv_r=f(req.uv_ref),
                                  intr_a=f(req.intr_ref),
                                  intr_t=f(req.intr_target)))
        self.poses0, self.rho0 = f(req.poses), f(req.inv_depth)
        self.fixed = torch.as_tensor(req.fixed, device=device)

    def residual(self, pose_a, pose_t, rho, c):
        b = lie.unproject_unit(self.model, c["intr_a"], c["uv_r"])
        qt_inv = lie.quat_conj(lie.rotation(pose_t))
        q = (lie.quat_rotate(qt_inv, lie.quat_rotate(lie.rotation(pose_a), b))
             + rho[:, None] * lie.quat_rotate(
                 qt_inv, lie.translation(pose_a) - lie.translation(pose_t)))
        return c["uv_t"] - lie.project(self.model, c["intr_t"], q)

    def solver(self) -> lmr.SchurLM:
        return lmr.SchurLM(self.residual, lie.right_plus, 6, HUBER,
                           self.fixed)


def solve(req, device, dtype=torch.float64, tf32: bool = False,
          iterations: int = ITERATIONS) -> dict:
    """The solve of request ``req``: ``poses`` (K, 7), ``inv_depth``
    (L,), ``initial_cost`` and final ``cost``, ``iterations``,
    ``tries``."""
    prob = GeoProblem(req, device, dtype)
    with lmr.tf32(tf32):
        res = lmr.lm_classic(prob.solver(), prob.poses0, prob.rho0,
                             prob.rows, iterations, FUNCTION_TOLERANCE)
    return dict(poses=res.cams, inv_depth=res.rho, cost=res.cost,
                initial_cost=res.initial_cost, iterations=res.iterations, tries=res.tries, problem=prob)


def cost_at(prob: GeoProblem, poses, rho) -> float:
    return float(prob.solver().cost(
        torch.as_tensor(poses).to(prob.device, prob.dtype),
        torch.as_tensor(rho).to(prob.device, prob.dtype), prob.rows))
