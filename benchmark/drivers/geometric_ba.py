"""Driver of the geometric BA configurations: each request is a
``scenes.GeoRequest`` that ``models.geometric_ba.bundle_adjustment``
solves, as SfM's optimise stage calls it.

``call`` is the timed path: the problem built on the card in the
configuration's precision (``geometric_ba.build_problem``), the solve,
and the solved state fetched to the host, as SfM reads it back.  After
the window ``reference`` solves a request again with
``reference/geometric.solve`` (float64) and ``compare`` gives the numbers
the run judges; ``control`` is the program's answer in the precision
below the configuration's."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import lie
from benchmark.reference import geometric as ref

SPAN = "bundle_adjustment"


def compare(sol: dict, cost: float, ref_out: dict) -> dict:
    """The numbers judged for one request: ``sol`` the answer under test
    (``poses``, ``inv_depth``), ``cost`` the final cost it reports,
    ``ref_out`` the float64 reference's ``solve``."""
    prob = ref_out["problem"]
    c_sol = ref.cost_at(prob, sol["poses"], sol["inv_depth"])
    c_ref = ref_out["cost"]
    dt, dr = lie.pose_gap(torch.as_tensor(sol["poses"]),
                          ref_out["poses"].cpu())
    rr = ref_out["inv_depth"].cpu().numpy()
    drho = np.abs(sol["inv_depth"] - rr) / np.abs(rr)
    return dict(cost_rel=abs(c_sol - c_ref) / c_ref,
                claim_rel=abs(cost - c_sol) / c_sol,
                start_cost_rel=abs(sol["initial_cost"] - ref_out["initial_cost"])
                / ref_out["initial_cost"],
                trans_gap_m=float(dt.max()), rot_gap_rad=float(dr.max()),
                trans_med_m=float(dt.median()),
                rot_med_rad=float(dr.median()),
                rho_rel_median=float(np.median(drho)),
                rho_rel_max=float(drho.max()))


class Driver:
    span = SPAN

    def __init__(self, config: dict, device):
        from photometric_bundle_adjustment_tpu_torch.models import (
            geometric_ba,
        )
        from photometric_bundle_adjustment_tpu_torch.optim import ba

        self.dtype = {"float32": torch.float32,
                      "float64": torch.float64}[config["precision"]]
        if config["tf32"]:
            raise ValueError("bundle_adjustment runs its products without "
                             "TF32")
        self.ba = geometric_ba
        self.bacfg = ba.BAConfig(max_iterations=config["iterations"],
                                 huber_delta=config["huber"])
        self.device = device

    def call(self, req, dtype=None) -> dict:
        gb = self.ba
        problem = gb.build_problem(
            poses=req.poses, inv_depth=req.inv_depth,
            anchor_cam=req.anchor_cam, target_cam=req.target_cam,
            landmark=req.landmark, uv_target=req.uv_target,
            uv_ref=req.uv_ref, intr_ref=req.intr_ref,
            intr_target=req.intr_target,
            valid=np.ones(req.landmark.shape[0], bool), fixed_cams=req.fixed,
            dtype=dtype or self.dtype, device=self.device)
        solved, res = gb.bundle_adjustment(problem, req.model, self.bacfg)
        return dict(poses=solved.cam_states.double().cpu().numpy(),
                    inv_depth=solved.inv_depth.double().cpu().numpy(),
                    cost=float(res.cost), initial_cost=float(res.initial_cost),
                    iterations=int(res.iterations), tries=int(res.tries))

    def reference(self, req, dtype=torch.float64, tf32: bool = False):
        return ref.solve(req, self.device, dtype, tf32=tf32)

    @staticmethod
    def answer(r: dict) -> dict:
        """A reference's solution in the form ``call`` returns."""
        return dict(poses=r["poses"].double().cpu().numpy(),
                    inv_depth=r["inv_depth"].double().cpu().numpy(),
                    cost=r["cost"], initial_cost=r["initial_cost"])

    def control(self, req) -> dict:
        """The control's answer: the program on the request in the
        precision below the configuration's (its float32 path where the
        configuration states float64), else the reference with TF32
        matrix products in the program's place."""
        if self.dtype == torch.float64:
            return self.call(req, torch.float32)
        return self.answer(self.reference(req, torch.float32, tf32=True))

    compare = staticmethod(compare)
