"""Driver of the bf16-sampling photometric refinement configurations: the
program's bf16 tier (``apps.pba.refine_map(..., sample_bf16=True)``),
judged against ``reference/photometric_bf16``.

``call``, ``compare`` and the solution's form are the float32 driver's
(``photometric_refine``).  ``reference`` solves a request with the
float64 reference whose residuals sample the levels rounded to bf16;
``control`` is that reference computed with TF32 matrix products, put in
the program's place; ``f32_tier`` is the program's float32 tier on the
same request (the answer of the tier this configuration is not), for the
limits' calibration.  ``launch_bytes`` charges 2 bytes a texel.
"""

from __future__ import annotations

import torch

from benchmark import roofline
from benchmark.drivers import photometric_refine as f32
from benchmark.reference import photometric, photometric_bf16 as ref

TEXEL_BYTES = 2


def mega_bytes(prob, images_l: torch.Tensor, level: int, cams, rho) -> int:
    """``roofline.mega_bytes`` of a launch of the bf16 tier: the same rows,
    cameras and landmarks, and each distinct texel a tap touches read as
    one bf16."""
    texels = torch.unique(roofline.touched_texels(prob, images_l, level,
                                                  cams, rho))
    n_rows = prob.anchor.shape[0]
    n_cams = torch.unique(torch.cat([prob.anchor, prob.target])).numel()
    n_lms = torch.unique(prob.landmark).numel()
    return (roofline.ROW_BYTES * n_rows + roofline.CAMERA_BYTES * n_cams
            + roofline.LANDMARK_BYTES * n_lms + TEXEL_BYTES * texels.numel())


class Driver(f32.Driver):
    def __init__(self, config: dict, device):
        if not config.get("sample_bf16"):
            raise ValueError("the bf16 driver runs the bf16 tier: the "
                             "configuration must set sample_bf16")
        super().__init__(config, device)

    def reference(self, req, dtype=torch.float64, tf32: bool = False):
        return ref.refine(req, self.device, dtype, tf32=tf32,
                          levels=self.cfg["levels"],
                          iterations=self.cfg["iterations"])

    def f32_tier(self, req) -> dict:
        """The program's float32 tier's answer to ``req``, in the form
        ``call`` returns."""
        return f32.Driver(dict(self.cfg, sample_bf16=False),
                          self.device).call(req)

    def launch_bytes(self, req) -> list:
        """Per pyramid level, coarsest first, the least bytes one launch
        of kernel #1's bf16 tier reads (``mega_bytes``), at the request's
        initial state."""
        prob = ref.MapProblem(req, self.device, torch.float32)
        pyr = photometric.pyramid(prob.images, self.cfg["levels"])
        return [mega_bytes(prob, pyr[lv], lv, prob.cams0, prob.rho0)
                for lv in range(self.cfg["levels"] - 1, -1, -1)]
