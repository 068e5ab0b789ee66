"""Carry the JAX package's problems and features into the port, through
numpy.

The two packages never import each other.  A caller that holds both (the
parity tests) turns the JAX arrays into numpy with ``np.asarray`` and
hands them here, so both packages compute on identical state.  The
functions read the problem by field name only, and a running SfM
pipeline's map state attribute by attribute (``map_state_to_numpy``,
``set_map_state``): a test can copy the JAX pipeline's state into the
port at any stage boundary.

Descriptor stacks: the JAX package holds 256-bit descriptors as (…, 8)
uint32 words.  torch's uint32 supports few operations, so the port holds
the same bits as int32 (a numpy ``view``, no copy of the values); the
CUDA kernel reads them as ``uint32_t``.
"""

from __future__ import annotations

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch import device as devices
from photometric_bundle_adjustment_tpu_torch.models import geometric_ba
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


def geometric_problem_from_numpy(tree, device) -> ba.BAProblem:
    """The port's geometric BAProblem from a BAProblem-shaped tree (the JAX
    package's, or ``problem_to_numpy``'s) whose leaves ``np.asarray`` can
    read; floats keep the inverse depths' dtype."""
    obs, aux = tree.obs, tree.obs.aux
    return geometric_ba.build_problem(
        poses=np.asarray(tree.cam_states),
        inv_depth=torch.as_tensor(np.asarray(tree.inv_depth)),
        anchor_cam=np.asarray(obs.anchor_cam),
        target_cam=np.asarray(obs.target_cam),
        landmark=np.asarray(obs.landmark),
        uv_target=np.asarray(aux.uv_target), uv_ref=np.asarray(aux.uv_ref),
        intr_ref=np.asarray(aux.intr_ref),
        intr_target=np.asarray(aux.intr_target),
        valid=np.asarray(obs.valid) != 0,
        fixed_cams=np.asarray(tree.fixed_cams),
        lm_valid=np.asarray(tree.lm_valid), device=device)


def problem_to_numpy(problem):
    """A copy of a problem (any tuple tree of tensors, the port's
    NamedTuples kept) with numpy leaves, on the host."""
    if torch.is_tensor(problem):
        return problem.detach().cpu().numpy()
    if isinstance(problem, tuple):
        return type(problem)(*(problem_to_numpy(x) for x in problem))
    return problem


def descriptors_from_numpy(desc, device="cuda") -> torch.Tensor:
    """(…, 8) uint32 descriptor words as an int32 tensor with the same
    bits, on ``device``."""
    desc = np.ascontiguousarray(np.asarray(desc, np.uint32))
    return torch.as_tensor(desc.view(np.int32),
                           device=devices.resolve(device))


def descriptors_to_numpy(desc: torch.Tensor) -> np.ndarray:
    """The port's int32 descriptor words as the JAX package's uint32."""
    return desc.detach().cpu().numpy().view(np.uint32)


def features_to_numpy(feats: dict) -> dict:
    """Tensors of a feature dict as numpy, desc as uint32: the layout of
    the JAX package's ``SfmPipeline.corners`` entries."""
    return {k: (descriptors_to_numpy(v) if k == "desc"
                else v.detach().cpu().numpy())
            for k, v in feats.items()}


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    return torch.empty((), dtype=dtype).numpy().dtype


def matches_to_numpy(matches: dict) -> dict:
    """A copy of a pipeline's ``matches`` ({(fcid_a, fcid_b): {"T_i_j",
    "matches", "inliers"}}, either package's) with numpy values."""
    return {k: {name: np.asarray(v) for name, v in md.items()}
            for k, md in matches.items()}


def map_state_to_numpy(pipe) -> dict:
    """The map state of a running SfM pipeline (either package's), read
    attribute by attribute into plain dicts, lists and numpy arrays: the
    map pickle's ``cameras``, ``landmarks`` (``inv_depth``, ``obs``,
    ``outlier_obs``), ``tracks`` and ``outlier_tracks``, plus
    ``candidates`` (dicts of the Candidate fields), ``stage`` (the Stage's
    name), ``min_localization_inliers`` and ``max_cameras_to_add``.  Every
    dict keeps its insertion order."""
    return {
        "cameras": {f: np.array(T, np.float64)
                    for f, T in pipe.cameras.items()},
        "landmarks": {
            int(t): {"inv_depth": float(lm.inv_depth), "obs": dict(lm.obs),
                     "outlier_obs": dict(lm.outlier_obs)}
            for t, lm in pipe.landmarks.items()},
        "tracks": {int(t): dict(tr) for t, tr in pipe.tracks.items()},
        "outlier_tracks": {int(t): dict(tr)
                           for t, tr in pipe.outlier_tracks.items()},
        "candidates": [
            {"fcid": c.fcid, "shared_tracks": [int(t) for t in
                                               c.shared_tracks],
             "tried": bool(c.tried), "camera_added": bool(c.camera_added),
             "landmarks_added": bool(c.landmarks_added)}
            for c in pipe.candidates],
        "stage": pipe.stage.name,
        "min_localization_inliers": int(pipe.min_localization_inliers),
        "max_cameras_to_add": int(pipe.max_cameras_to_add),
    }


def set_map_state(pipe, state: dict) -> None:
    """Set the map state of the port's SfM pipeline ``pipe`` from
    ``state`` (``map_state_to_numpy``'s form), copying every container;
    the localisation cache starts empty."""
    from photometric_bundle_adjustment_tpu_torch.pipeline import (
        sfm_pipeline as sfm,
    )

    pipe.cameras = {f: np.array(T, np.float64)
                    for f, T in state["cameras"].items()}
    pipe.landmarks = {
        t: sfm.Landmark(float(d["inv_depth"]), dict(d["obs"]),
                        dict(d["outlier_obs"]))
        for t, d in state["landmarks"].items()}
    pipe.tracks = {t: dict(tr) for t, tr in state["tracks"].items()}
    pipe.outlier_tracks = {t: dict(tr)
                           for t, tr in state["outlier_tracks"].items()}
    pipe.candidates = [
        sfm.Candidate(c["fcid"], list(c["shared_tracks"]), c["tried"],
                      c["camera_added"], c["landmarks_added"])
        for c in state["candidates"]]
    pipe.stage = sfm.Stage[state["stage"]]
    pipe.min_localization_inliers = state["min_localization_inliers"]
    pipe.max_cameras_to_add = state["max_cameras_to_add"]
    pipe._loc_cache = {}
