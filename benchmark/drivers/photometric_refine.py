"""Driver of the photometric refinement configurations: each request is a
map that ``apps.pba.refine_map`` refines in place.

``call`` is the timed path: the program's entry on the request's map
object, then the refined state read back from it (the program writes
poses, affine brightness and inverse depths into the map and returns the
per-level stats).  After the window ``reference`` solves a request again
with ``reference/photometric.refine`` and ``compare`` gives the numbers
the run judges; ``control`` is the answer of the reference computed with
TF32 matrix products, put in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import lie, roofline
from benchmark.reference import photometric as ref

SPAN = "refine_map"


def _solution(pipe, cam_list, lm_list) -> dict:
    return dict(
        poses=np.stack([np.asarray(pipe.cameras[f], np.float64)
                        for f in cam_list]),
        affine=np.stack([np.asarray(pipe.photometric_affine[f], np.float64)
                         for f in cam_list]),
        inv_depth=np.array([pipe.landmarks[t].inv_depth for t in lm_list]))


def _level_costs(levels) -> tuple:
    return (float(levels[0]["initial_cost"]),
            [float(lv["cost"]) for lv in levels])


def compare(sol: dict, cost: float, ref_out: dict) -> dict:
    """The numbers judged for one request: ``sol`` the answer under test
    (``poses``, ``affine``, ``inv_depth`` in the reference's order),
    ``ref_out`` the float64 reference's ``refine``.  ``cost_rel`` compares
    the reference's costs at the two returned maps (whose inverse depths at
    or below 1e-6 keep their input value, so the cost a solver reports for
    its own state is not that of the map it returns: ``cost`` is unused);
    ``start_cost_rel`` the coarsest level's starting cost and
    ``level_cost_rel`` the worst of the levels' final costs, as reported
    in ``levels`` against the reference's; ``model_drop`` and
    ``step_trans_*_m`` how far the returned map lies from a minimum of
    the float64 cost (``reference.photometric.newton_gap``)."""
    prob = ref_out["problem"]
    c_sol = ref.cost_at(prob, sol["poses"], sol["affine"], sol["inv_depth"])
    c_ref = ref.cost_at(prob, ref_out["poses"], ref_out["affine"],
                        ref_out["inv_depth"])
    dt, dr = lie.pose_gap(torch.as_tensor(sol["poses"]),
                          ref_out["poses"].cpu())
    aff = np.abs(sol["affine"] - ref_out["affine"].cpu().numpy())
    rr = ref_out["inv_depth"].cpu().numpy()
    drho = np.abs(sol["inv_depth"] - rr) / np.abs(rr)
    start, finals = _level_costs(sol["levels"])
    r_start, r_finals = _level_costs(ref_out["levels"])
    gap = ref.newton_gap(prob, sol["poses"], sol["affine"], sol["inv_depth"])
    return dict(cost_rel=abs(c_sol - c_ref) / c_ref, **gap,
                start_cost_rel=abs(start - r_start) / r_start,
                level_cost_rel=max(abs(a - b) / b
                                   for a, b in zip(finals, r_finals)),
                trans_gap_m=float(dt.max()), rot_gap_rad=float(dr.max()),
                trans_med_m=float(dt.median()),
                rot_med_rad=float(dr.median()),
                affine_a_gap=float(aff[:, 0].max()),
                affine_b_gap=float(aff[:, 1].max()),
                rho_rel_median=float(np.median(drho)),
                rho_rel_max=float(drho.max()))


class Driver:
    span = SPAN

    def __init__(self, config: dict, device):
        from photometric_bundle_adjustment_tpu_torch.apps import pba
        from photometric_bundle_adjustment_tpu_torch.ops import _build

        if config["precision"] != "float32" or config["tf32"]:
            raise ValueError("the photometric driver runs float32 with TF32 "
                             "off, as refine_map does")
        if torch.device(device).type == "cuda":
            _build.load("pba_mega")
        self.refine_map = pba.refine_map
        self.cfg = config
        self.device = device

    def call(self, pipe) -> dict:
        c = self.cfg
        levels = self.refine_map(
            pipe, iterations=c["iterations"], huber=c["huber"],
            levels=c["levels"], sample_bf16=c["sample_bf16"],
            log=lambda *a: None, device=self.device)
        out = _solution(pipe, sorted(pipe.cameras), sorted(pipe.landmarks))
        out.update(cost=float(levels[-1]["cost"]),
                   levels=[dict(x) for x in levels],
                   tries=sum(int(x["tries"]) for x in levels))
        return out

    def reference(self, req, dtype=torch.float64, tf32: bool = False):
        return ref.refine(req, self.device, dtype, tf32=tf32,
                          levels=self.cfg["levels"],
                          iterations=self.cfg["iterations"])

    @staticmethod
    def answer(r: dict) -> dict:
        """A reference's solution in the form ``call`` returns."""
        out = {k: r[k].double().cpu().numpy()
               for k in ("poses", "affine", "inv_depth")}
        out.update(cost=r["cost"], levels=r["levels"])
        return out

    def control(self, req) -> dict:
        """The control's answer: the reference with TF32 matrix products
        (the precision below float32 with TF32 off) in the program's
        place."""
        return self.answer(self.reference(req, torch.float32, tf32=True))

    compare = staticmethod(compare)

    def launch_bytes(self, req) -> list:
        """Per pyramid level, coarsest first, the least bytes one launch
        of kernel #1 reads (``roofline.mega_bytes``), at the request's
        initial state."""
        prob = ref.MapProblem(req, self.device, torch.float32)
        pyr = ref.pyramid(prob.images, self.cfg["levels"])
        return [roofline.mega_bytes(prob, pyr[lv], lv, prob.cams0, prob.rho0)
                for lv in range(self.cfg["levels"] - 1, -1, -1)]
