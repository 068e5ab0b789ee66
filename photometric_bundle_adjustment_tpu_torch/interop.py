"""Carry the JAX package's problems into the port, through numpy.

The two packages never import each other.  A caller that holds both (the
parity tests) turns the JAX arrays into numpy with ``np.asarray`` and
hands them here, so both packages compute on identical state.  The
functions read the problem by field name only.
"""

from __future__ import annotations

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch.models import photometric_ba as pba
from photometric_bundle_adjustment_tpu_torch.optim import ba


def array_from_numpy(x, device, dtype=None) -> torch.Tensor:
    """A copy of any array-like (a JAX array included) as a tensor on
    ``device``."""
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def problem_from_numpy(tree, device) -> ba.BAProblem:
    """The port's photometric BAProblem from a BAProblem-shaped tree (the
    JAX package's NamedTuples) whose leaves ``np.asarray`` can read."""
    def f(x):
        return array_from_numpy(x, device)

    cams, obs = tree.cam_states, tree.obs
    aux = obs.aux
    return pba.build_problem(
        poses=f(cams.pose), affine=f(cams.affine), inv_depth=f(tree.inv_depth),
        anchor_cam=f(obs.anchor_cam), target_cam=f(obs.target_cam),
        landmark=f(obs.landmark), uv_ref=f(aux.uv_ref),
        ref_patch=f(aux.ref_patch), target_img=f(aux.target_img),
        intr_ref=f(aux.intr_ref), intr_target=f(aux.intr_target),
        valid=np.asarray(obs.valid) != 0, fixed_cams=f(tree.fixed_cams),
        lm_valid=f(tree.lm_valid),
    )
