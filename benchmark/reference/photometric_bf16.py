"""Plain photometric refinement of a map that samples bf16 images: the
reference of the ``euroc-room-pba-bf16`` configuration.

The configuration runs the program's bf16 tier (``apps/pba
--sample-bf16``).  Its semantics, which this file computes in the dtype it
is given (float64 for the checks):

* each pyramid level is computed from the 8-bit images at full precision
  (``photometric.pyramid``);
* a level's reference patches are sampled from that unrounded level;
* the target images the residuals sample, their values and their
  gradients alike, are the level rounded to bf16 (round to nearest even)
  and widened back;
* everything after those taps, the bilinear weights included, is at full
  precision.

Level 0 holds 8-bit intensities, integers up to 255, which bf16's 8
significant bits hold exactly, so its rounding changes nothing: the
full-resolution cost (``cost_at``) and ``newton_gap`` are those of
``photometric``.  Level 1 holds multiples of 1/4 and level 2 multiples of
1/16, which bf16 rounds (to steps of 0.5 from 64 to 128 and of 1 above
128), so the tier differs from the float32 one only in where the coarse
levels leave level 0's start.

It imports nothing of the program; the rest is ``photometric``'s.
"""

from __future__ import annotations

import torch

from benchmark.reference import lm as lmr
from benchmark.reference import photometric as ref
from benchmark.reference.photometric import cost_at, newton_gap  # noqa: F401


class MapProblem(ref.MapProblem):
    """``photometric.MapProblem`` whose rows sample the level rounded to
    bf16; the reference patches stay sampled from the unrounded level."""

    def level_rows(self, images_l: torch.Tensor, level: int) -> lmr.Rows:
        rows = super().level_rows(images_l, level)
        rows.const["images"] = images_l.to(torch.bfloat16).to(images_l.dtype)
        return rows


def refine(pipe, device, dtype=torch.float64, tf32: bool = False,
           levels: int = ref.LEVELS,
           iterations: int = ref.ITERATIONS) -> dict:
    """``photometric.refine`` on the bf16-sampling ``MapProblem``: the
    coarse-to-fine refinement of the map ``pipe`` (not modified), with the
    same returns."""
    prob = MapProblem(pipe, device, dtype)
    pyr = ref.pyramid(prob.images, levels)
    solver = lmr.SchurLM(prob.residual, ref.retract, 8, ref.HUBER,
                         prob.fixed)
    cams, rho = prob.cams0, prob.rho0
    stats, res = [], None
    with lmr.tf32(tf32):
        for level in range(levels - 1, -1, -1):
            rows = prob.level_rows(pyr[level], level)
            res = lmr.lm_fused(solver, cams, rho, rows, iterations,
                               ref.FUNCTION_TOLERANCE)
            cams, rho = res.cams, res.rho
            stats.append(dict(level=level, initial_cost=res.initial_cost,
                              cost=res.cost, iterations=res.iterations,
                              tries=res.tries))
    rho = torch.where(rho > 1e-6, rho, prob.rho0)
    return dict(poses=cams[:, :7], affine=cams[:, 7:9], inv_depth=rho,
                cost=res.cost, levels=stats, problem=prob)
