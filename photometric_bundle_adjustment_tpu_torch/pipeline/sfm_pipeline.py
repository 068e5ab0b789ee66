"""Incremental stereo SfM pipeline: the front-end stages.

Port of the first stages of ``photometric_bundle_adjustment_tpu/pipeline/
sfm_pipeline.py`` (the reference's main program, src/sfm.cpp:1117-2131):
detection and description of every image, then stereo matching with the
epipolar check, and the worklist of all other image pairs.  Matching that
worklist is ``features.pair_matching.match_pairs`` followed by
``features.match.matches_to_pairs``, both on the device; the
relative-pose RANSAC, tracks and the map stages come with later slices.

The stages run on ``device`` (the card unless the caller asks for the
CPU).  Descriptor matching goes through the Hamming kernel there: one
launch per direction for all stereo pairs.  Feature dicts and match lists
have the JAX package's layout; descriptors in ``corners`` are uint32, as
there.  The counters keep the JAX package's names but count what runs
here: ``stereo_chunks`` is 1 per ``match_stereo``, since every stereo
pair goes through one batch (the JAX package counts one per
``match_chunk_pairs`` chunk).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from photometric_bundle_adjustment_tpu_torch import device as devices
from photometric_bundle_adjustment_tpu_torch import interop
from photometric_bundle_adjustment_tpu_torch.core import cameras as cam_models
from photometric_bundle_adjustment_tpu_torch.core import se3
from photometric_bundle_adjustment_tpu_torch.features import (
    describe,
    geometry,
    match,
)
from photometric_bundle_adjustment_tpu_torch.pipeline.config import SfmConfig


def _stereo_geometry(T_c0: torch.Tensor, T_c1: torch.Tensor):
    """Stereo extrinsics T_0_1 and the essential matrix of the pair."""
    T_0_1 = se3.compose(se3.inverse(T_c0), T_c1)
    return T_0_1, geometry.essential_from_pose(T_0_1)


class SfmPipeline:
    def __init__(self, images: dict, calib, cfg: SfmConfig = SfmConfig(),
                 log=print, *, device="cuda"):
        self.device = devices.resolve(device)
        self.images = images          # {(frame, cam): (H, W) uint8}
        self.calib = calib            # .intrinsics, .cam_types, .T_i_c
        self.cfg = cfg
        self.model = calib.cam_types[0] if calib.cam_types else "ds"
        self.log = log
        self.fcids = sorted(images)
        self.num_frames = len({f for (f, _) in self.fcids})

        # map state of the front-end stages; tracks, cameras and
        # landmarks come with the later stages
        self.corners: dict = {}
        self.matches: dict = {}
        # per-stage wall seconds
        self.timings: dict = {}
        # device-stage invocation counts, under the JAX package's names
        self.counters: dict = {}

        self._stacked = None  # device-side stacked features

    # ---------------------------------------------------------------- utils

    def _count(self, name, n=1):
        self.counters[name] = self.counters.get(name, 0) + n

    # ------------------------------------------------------------ stage 1-2

    def detect_keypoints(self, batch: int = 8):
        """Detection and description of every image, in sub-batches of
        ``batch`` images on the device (one upload of the image stack, one
        fetch of all features)."""
        t0 = time.time()
        self.clear_keypoints()
        N = len(self.fcids)
        if N == 0:
            self.timings["detect"] = time.time() - t0
            return
        stack = np.stack([np.asarray(self.images[f]) for f in self.fcids])
        self._count("detect_batches", -(-N // batch))
        feats = describe.detect_and_describe_all(
            torch.as_tensor(stack, device=self.device), batch=batch,
            num_features=self.cfg.num_features_per_image,
            rotate_features=self.cfg.rotate_features,
        )
        feats = interop.features_to_numpy(
            dict(zip(("uv", "valid", "angles", "desc"), feats)))
        for i, fcid in enumerate(self.fcids):
            self.corners[fcid] = {k: v[i] for k, v in feats.items()}
        self.timings["detect"] = time.time() - t0
        self.log(f"Detected keypoints in {N} images "
                 f"({self.timings['detect']:.1f}s)")

    def _stack_features(self):
        """(uv, valid, desc, bearings) of every image on the device, the
        feature axis compacted to the largest detection count rounded up
        to 128: detection fills slots score-descending, valid first, and
        matching at the padded slots would be redundant work.  Bearings
        are float64."""
        if self._stacked is not None:
            return self._stacked
        uv_np = np.stack([self.corners[f]["uv"] for f in self.fcids])
        valid_np = np.stack([self.corners[f]["valid"] for f in self.fcids])
        desc_np = np.stack([self.corners[f]["desc"] for f in self.fcids])
        n_valid = int(valid_np.sum(1).max()) if valid_np.size else 0
        Fc = max(128, -(-n_valid // 128) * 128)
        if Fc < uv_np.shape[1]:
            uv_np = uv_np[:, :Fc]
            valid_np = valid_np[:, :Fc]
            desc_np = desc_np[:, :Fc]
        cam_ids = np.array([c for (_, c) in self.fcids])
        dev = self.device
        uv = torch.as_tensor(uv_np, device=dev)
        valid = torch.as_tensor(valid_np, device=dev)
        desc = interop.descriptors_from_numpy(desc_np, dev)
        intr = torch.as_tensor(np.asarray(self.calib.intrinsics)[cam_ids],
                               dtype=torch.float64, device=dev)
        bear = cam_models.unproject_unit(self.model, intr[:, None, :],
                                         uv.double())
        self._stacked = (uv, valid, desc, bear)
        return self._stacked

    def match_stereo(self):
        """Stereo pairs with known extrinsics plus the epipolar check
        (sfm.cpp:1217-1272).  Every stereo pair is matched in one batch:
        one Hamming kernel launch on the card for both directions."""
        t0 = time.time()
        cfg = self.cfg
        dev = self.device
        T_i_c = torch.as_tensor(np.asarray(self.calib.T_i_c),
                                dtype=torch.float64, device=dev)
        T_0_1, E = _stereo_geometry(T_i_c[0], T_i_c[1])
        T_0_1_np = T_0_1.cpu().numpy()
        self.log(f"Matching {self.num_frames} stereo pairs...")
        idx = {f: i for i, f in enumerate(self.fcids)}
        stereo = [
            (idx[(fid, 0)], idx[(fid, 1)], fid)
            for fid in range(self.num_frames)
            if (fid, 0) in idx and (fid, 1) in idx
        ]
        self._count("stereo_pairs", len(stereo))
        uv, valid, desc, bear = self._stack_features()
        # stereo keeps ALL matches (the reference stores the full match
        # list of the rectified pair): cap at F, not at the all-pairs budget
        MM = cfg.num_features_per_image
        num_matches = num_inliers = 0
        if stereo:
            self._count("stereo_chunks")
            a = torch.as_tensor([s[0] for s in stereo], device=dev)
            b = torch.as_tensor([s[1] for s in stereo], device=dev)
            m12 = match.match_batch(
                desc, valid, desc, valid, a, b,
                cfg.feature_match_max_dist,
                cfg.feature_match_test_next_best,
            )
            pairs, pvalid, count = match.matches_to_pairs(m12, MM)
            b0 = bear[a[:, None], pairs[..., 0].long()]
            b1 = bear[b[:, None], pairs[..., 1].long()]
            inl = geometry.epipolar_inliers(
                b0, b1, E, cfg.epipolar_error_threshold) & pvalid
            pairs, count, inl = (pairs.cpu().numpy(), count.cpu().numpy(),
                                 inl.cpu().numpy())
            for ci, (_, _, fid) in enumerate(stereo):
                n = int(count[ci])
                inliers = pairs[ci][inl[ci]]
                self.matches[((fid, 0), (fid, 1))] = {
                    "T_i_j": T_0_1_np, "matches": pairs[ci][:n],
                    "inliers": inliers,
                }
                num_matches += n
                num_inliers += len(inliers)
        self.timings["match_stereo"] = time.time() - t0
        self.log(
            f"Matched {self.num_frames} stereo pairs with {num_inliers} "
            f"inlier feature matches ({num_matches} total). New total of "
            f"matched image pairs is {len(self.matches)}."
        )

    def _pair_worklist(self):
        """All non-stereo pairs, (later, earlier) ordering
        (sfm.cpp:1284-1289)."""
        keys = self.fcids
        return [(i, j) for i in range(len(keys)) for j in range(i)
                if keys[i][0] != keys[j][0]]

    # ------------------------------------------------------------------ clears

    def clear_keypoints(self):
        self.corners = {}
        self._stacked = None
        self.matches = {}
