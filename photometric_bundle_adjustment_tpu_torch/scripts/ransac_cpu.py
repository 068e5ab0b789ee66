"""The operator count of a RANSAC chunk and the accuracy of
``match_all``'s relative poses: the figures a chip run's prediction
starts from, reckoned on the CPU with ``--device cpu``.

    python3 -m photometric_bundle_adjustment_tpu_torch.scripts.ransac_cpu --device cpu

  * ops: the top-level, non-view torch operators one
    ``ransac_relative_pose`` call runs on ``--ops-pairs`` two-view
    problems of 512 correspondences (30% outliers, 112 rows invalid,
    128 five-point hypotheses, f64), counted by ``torch.profiler``: about
    the kernels one RANSAC chunk launches on the card, whatever its size;
  * accuracy: the ``synth_stereo_sequence`` of ``--frames`` stereo frames
    at ``--H`` x ``--W`` (seed 0), detection, then
    ``SfmPipeline._run_pair_matching`` on ``--pairs`` pairs of the
    worklist drawn with numpy seed 0: over the successful pairs, the
    median and 95th percentile of the rotation error and of the angle
    between the translation directions against ground truth, and the
    share of inliers within 2 px of the true correspondence.

Runs on ``--device`` (the card by default); prints one JSON object as
its last line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch import device as devices
from photometric_bundle_adjustment_tpu_torch.core import se3
from photometric_bundle_adjustment_tpu_torch.features import ransac
from photometric_bundle_adjustment_tpu_torch.models import synthetic
from photometric_bundle_adjustment_tpu_torch.pipeline.sfm_pipeline import (
    SfmPipeline,
)

# operators that launch no kernel of their own (views, shape queries)
_VIEWS = {"aten::" + n for n in (
    "as_strided", "view", "slice", "select", "expand", "reshape",
    "unsqueeze", "permute", "transpose", "t", "alias", "squeeze", "unbind",
    "split", "narrow", "detach", "_reshape_alias", "lift_fresh", "empty",
    "empty_like", "empty_strided", "_unsafe_view", "expand_as", "view_as",
    "result_type", "diagonal", "movedim", "flatten", "contiguous",
    "broadcast_tensors")}


def chunk_ops(pairs: int, device, M: int = 512, seed: int = 0) -> int:
    """Top-level non-view operators of one ``ransac_relative_pose`` call."""
    from torch.profiler import profile

    rng = np.random.default_rng(seed)

    def t(x):
        return torch.as_tensor(x, device=device)

    T = se3.exp(t(rng.normal(0, 0.2, (pairs, 6))))
    p1 = t(rng.uniform(-2, 2, (pairs, M, 3)) + [0, 0, 6.0])
    f0 = torch.nn.functional.normalize(se3.act(T[:, None], p1), dim=-1)
    f1 = torch.nn.functional.normalize(p1, dim=-1)
    n_out = int(0.3 * M)
    f1[:, :n_out] = torch.nn.functional.normalize(
        t(rng.normal(size=(pairs, n_out, 3))), dim=-1)
    valid = torch.ones(pairs, M, dtype=torch.bool, device=device)
    valid[:, 400:] = False
    gen = torch.Generator(device=device).manual_seed(seed)
    ransac.ransac_relative_pose(f0, f1, valid, gen)        # warm-up
    with profile() as prof:
        ransac.ransac_relative_pose(f0, f1, valid, gen)
    return sum(1 for e in prof.events() if e.name.startswith("aten::")
               and e.name not in _VIEWS
               and (e.cpu_parent is None
                    or not e.cpu_parent.name.startswith("aten::")))


def accuracy(frames: int, H: int, W: int, pairs: int, device) -> dict:
    seq = synthetic.synth_stereo_sequence(n_frames=frames, H=H, W=W,
                                          device=device)
    pipe = SfmPipeline(seq.images, seq.calib, log=lambda s: None,
                       device=device)
    pipe.detect_keypoints()
    ids = pipe._pair_worklist()
    pick = np.random.default_rng(0).choice(len(ids), min(pairs, len(ids)),
                                           replace=False)
    sub = [ids[i] for i in sorted(pick)]
    pipe._run_pair_matching(sub)
    keys = [(pipe.fcids[a], pipe.fcids[b]) for a, b in sub]
    ok = [k for k in keys if len(pipe.matches[k]["inliers"])]
    if not ok:
        raise RuntimeError(f"no pair of {len(sub)} passed RANSAC")
    f64 = torch.float64
    T = torch.as_tensor(np.stack([pipe.matches[k]["T_i_j"] for k in ok]))
    T_gt = se3.compose(
        se3.inverse(torch.as_tensor(np.stack([seq.poses_gt[a] for a, _ in ok]),
                                    dtype=f64)),
        torch.as_tensor(np.stack([seq.poses_gt[b] for _, b in ok]), dtype=f64))
    rot = torch.linalg.norm(se3.so3_log(se3.quat_mul(
        se3.quat_conj(se3.rotation(T)), se3.rotation(T_gt))), dim=-1).numpy()
    t, tg = se3.translation(T), se3.translation(T_gt)
    cos = torch.sum(t * tg, -1) / (torch.linalg.norm(t, dim=-1)
                                   * torch.linalg.norm(tg, dim=-1))
    ang = torch.arccos(torch.clamp(cos, -1.0, 1.0)).numpy()
    close = total = 0
    for a, b in ok:
        inl = pipe.matches[(a, b)]["inliers"]
        uv_t, front = seq.correspondence(a, b, pipe.corners[a]["uv"][inl[:, 0]])
        err = np.linalg.norm(uv_t - pipe.corners[b]["uv"][inl[:, 1]], axis=1)
        close += int(((err <= 2.0) & front).sum())
        total += len(inl)
    return dict(pairs=len(sub), succeeded=len(ok),
                rotation_median=float(np.median(rot)),
                rotation_p95=float(np.percentile(rot, 95)),
                direction_median=float(np.median(ang)),
                direction_p95=float(np.percentile(ang, 95)),
                inliers_on_truth=close / max(total, 1))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ops-pairs", type=int, default=24)
    ap.add_argument("--frames", type=int, default=82)
    ap.add_argument("--H", type=int, default=480)
    ap.add_argument("--W", type=int, default=752)
    ap.add_argument("--pairs", type=int, default=200)
    args = ap.parse_args(argv)
    device = devices.resolve(args.device)
    res = dict(device=str(device), chunk_ops=chunk_ops(args.ops_pairs, device),
               **accuracy(args.frames, args.H, args.W, args.pairs, device))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
