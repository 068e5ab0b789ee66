"""Incremental stereo SfM pipeline: the host-side state machine.

Port of ``photometric_bundle_adjustment_tpu/pipeline/sfm_pipeline.py``
(the reference's main program, src/sfm.cpp:1117-2131): the same staged
pipeline, detect -> match (stereo, then all pairs or BoW) -> tracks ->
init scene -> {candidates -> add cameras -> add landmarks -> optimize ->
remove outliers}* -> done, with the same two-tier candidate policy,
outlier taxonomy, thresholds, counters and log lines.  ``run`` goes from
images to a finished map; ``next_step`` takes one stage.

The per-row geometry runs in batches on ``device`` (the card unless the
caller asks for the CPU), in float64: detection and description, one
Hamming kernel launch for both directions of all stereo pairs and one for
the whole all-pairs worklist, RANSAC in chunks of pairs of similar match
counts, then the map stages' plain torch functions (``lm_positions``,
``project_obs``, ``triangulate_rows``, ``localize_batch``: the JAX
package's ``jax.jit`` helpers; its ``_bearings_kernel`` is
``cameras.unproject_unit``) and geometric BA
(``models/geometric_ba.bundle_adjustment``).  Each batch's inputs go up in
one copy and its results come back in one (``_upload``, ``_fetch``).
Bookkeeping (tracks, candidates, stage logic) stays on the host in plain
dicts, filled in the JAX package's order: the outcomes depend on it
(first-passing-row insertion, candidate ranks, track order).

What differs from the JAX package, and why:

- Nothing is padded to power-of-two buckets: PyTorch compiles nothing per
  shape.  A localisation wave is padded to its longest member only
  (``valid=False`` rows); the counters ``triangulate_rows``,
  ``project_rows`` and ``localize_rows`` count the rows computed, where
  the JAX package keeps one counter per bucket size.
- RANSAC draws its samples from the pipeline's ``torch.Generator``
  (``seed``), the stand-in for the JAX key stream.  ``pnp_draws``, when
  set, injects the samples of each localisation wave instead (a test
  seam: the parity tests feed the JAX package's own draws).
- BA takes the JAX package's CPU branch on every device; the outlier
  pass's projection chained onto the BA dispatch and the packed request
  fronts are tunnel forms and not ported.
- ``optimize`` of a map with no landmark skips the solve and says so; the
  JAX package raises there.
- Tracks are built by ``native_tracks`` (g++ at first use), which raises
  if it cannot build; the JAX package falls back to pure Python.
- The JAX package's CPU matching through its native C++ matcher is not
  ported: on the CPU the port takes the Hamming kernel's plain version.

A saved geometric map enters through ``SfmPipeline.from_map`` (cameras,
tracks, landmarks and the cached corners, no images); ``interop``'s
``map_state_to_numpy`` / ``set_map_state`` carry a running pipeline's map
state between the packages at any stage boundary.  The counters keep the
JAX package's names but count what runs here: ``stereo_chunks`` is 1 per
``match_stereo``, since every stereo pair goes through one batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pickle
import time
from dataclasses import dataclass, field
from enum import Enum

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
    pair_matching,
    ransac,
)
from photometric_bundle_adjustment_tpu_torch.models import geometric_ba
from photometric_bundle_adjustment_tpu_torch.optim import ba
from photometric_bundle_adjustment_tpu_torch.pipeline import native_tracks
from photometric_bundle_adjustment_tpu_torch.pipeline.config import SfmConfig


class Stage(Enum):
    """CameraCandidates::Stage (common_types.h:240-247)."""

    COMPUTE_CANDIDATES = 0
    ADD_CAMERAS = 1
    ADD_LANDMARKS = 2
    OPTIMIZE = 3
    REMOVE_OUTLIERS = 4
    DONE = 5


# outlier flags (common_types.h:276-286)
OUTLIER_NONE = 0
OUTLIER_REPROJECTION_HUGE = 1 << 0
OUTLIER_REPROJECTION_NORMAL = 1 << 1
OUTLIER_CAMERA_DISTANCE = 1 << 2
OUTLIER_Z_COORDINATE = 1 << 3

# cameras localised together in one wave (JAX _localize_wave's W)
WAVE = 16


@dataclass
class Landmark:
    inv_depth: float
    obs: dict                      # {fcid: feature_id}
    outlier_obs: dict = field(default_factory=dict)

    def anchor(self):
        """First observation in FrameCamId order, the reference frame
        (obs.begin() on the ordered map, map_utils.h:351-352)."""
        return min(self.obs)

    def add_obs(self, fcid, feat):
        """Record an observation: the one mutation path for ``obs``."""
        self.obs[fcid] = feat

    def sorted_obs_arrays(self):
        """(fcid keys, feature ids) of ``obs`` in FrameCamId order, as int64
        arrays with fcid encoded frame*16+cam."""
        items = sorted(self.obs.items())
        n = len(items)
        keys = np.fromiter((f * 16 + cam for (f, cam), _ in items), np.int64,
                           n)
        feats = np.fromiter((ft for _, ft in items), np.int64, n)
        return keys, feats


@dataclass
class Candidate:
    fcid: tuple
    shared_tracks: list
    tried: bool = False
    camera_added: bool = False
    landmarks_added: bool = False


# the share of the card's memory that one RANSAC chunk's prescreen (10
# candidates x hypotheses x matches per pair, in the bearings' dtype) may
# take, and the bytes it may take on the CPU
RANSAC_MEMORY_SHARE = 1 / 8
RANSAC_CPU_BYTES = 1 << 28


def _fetch(*tensors):
    """Tensors with a common leading axis, copied to the host in one copy
    (their bytes side by side); numpy arrays of their shapes and
    dtypes."""
    rows = tensors[0].shape[0]
    parts = [t.contiguous().view(torch.uint8).reshape(rows, -1)
             for t in tensors]
    blob = torch.cat(parts, dim=1).cpu().numpy()
    out, at = [], 0
    for t, part in zip(tensors, parts):
        w = part.shape[1]
        dt = interop.numpy_dtype(t.dtype)
        out.append(np.ascontiguousarray(blob[:, at:at + w]).view(dt)
                   .reshape(tuple(t.shape)))
        at += w
    return out


def _upload(device, *arrays):
    """Host arrays with a common leading axis N, as float64 tensors on
    ``device`` from one copy: (N, …) each, shapes kept."""
    n = arrays[0].shape[0]
    cols = [np.asarray(a, np.float64).reshape(n, -1) for a in arrays]
    blob = torch.as_tensor(np.concatenate(cols, axis=1), device=device)
    out, at = [], 0
    for a, c in zip(arrays, cols):
        out.append(blob[:, at:at + c.shape[1]].reshape(a.shape))
        at += c.shape[1]
    return out


def _stereo_geometry(T_c0: torch.Tensor, T_c1: torch.Tensor):
    """Stereo extrinsics T_0_1 and the essential matrix of the pair."""
    T_0_1 = se3.compose(se3.inverse(T_c0), T_c1)
    return T_0_1, geometry.essential_from_pose(T_0_1)


# ------------------------------------------------------------------------
# Batched per-row geometry of the map stages: the JAX package's jax.jit
# helpers as plain torch functions on the pipeline's device.


def lm_positions(model, uv, intr, T, rho):
    """Batched Landmark::get_p (common_types.h:205-217): the world points
    of anchor pixels ``uv`` (N, 2) at inverse depths ``rho`` (N,)."""
    d = cam_models.unproject_unit(model, intr, uv)
    return se3.act(T, d / rho[:, None])


def project_obs(model, uv_a, intr_a, T_a, rho, uv_meas, intr_t, T_t):
    """Landmark::get_p plus the reprojection into each target camera
    (compute_projections, sfm.cpp:1957-2008): one (N, 5) result [uv_proj,
    err, dist, z], fetched in one copy."""
    p_w = lm_positions(model, uv_a, intr_a, T_a, rho)
    p_c = se3.act(se3.inverse(T_t), p_w)
    uv_proj = cam_models.project(model, intr_t, p_c)
    err = torch.linalg.norm(uv_meas - uv_proj, dim=-1)
    dist = torch.linalg.norm(p_c, dim=-1)
    return torch.cat([uv_proj, err[:, None], dist[:, None], p_c[:, 2:3]],
                     dim=1)


def triangulate_rows(model, uv0, uv1, intr0, intr1, T0, T1, min_cos: float):
    """Batched two-view midpoint triangulation plus the parallax gate
    (add_new_landmarks_between_cams, map_utils.h:121-195): (inv_depth (N,)
    in camera 0, ok (N,) bool)."""
    f0 = cam_models.unproject_unit(model, intr0, uv0)
    f1 = cam_models.unproject_unit(model, intr1, uv1)
    T_0_1 = se3.compose(se3.inverse(T0), T1)
    p0 = geometry.triangulate_midpoint(f0, f1, T_0_1)
    inv_depth = 1.0 / torch.linalg.norm(p0, dim=-1)
    Rf1 = se3.quat_rotate(se3.rotation(T_0_1), f1)
    cos_ang = torch.sum(f0 * Rf1, dim=-1)
    ok = (cos_ang < min_cos) & torch.isfinite(inv_depth) & (inv_depth > 0)
    return inv_depth, ok


def localize_batch(model, uv, intr, uv_a, intr_a, T_a, rho, valid,
                   generator, pixel_threshold: float, num_hypotheses: int,
                   idx=None):
    """PnP of a wave of B cameras at once (localize_camera,
    map_utils.h:242-302), Landmark::get_p inside: ``uv`` (B, M, 2) the
    candidates' pixels, ``intr`` (B, 8) their intrinsics, ``uv_a``,
    ``intr_a``, ``T_a``, ``rho`` (B, M, …) the anchors of the shared
    landmarks, ``valid`` (B, M).  Samples from ``generator``, or ``idx``
    (B, H, 3).  Returns (T_w_c (B, 7), inliers (B, M))."""
    B, M = valid.shape
    pts = lm_positions(model, uv_a.reshape(B * M, 2),
                       intr_a.reshape(B * M, -1), T_a.reshape(B * M, 7),
                       rho.reshape(B * M)).reshape(B, M, 3)
    f = cam_models.unproject_unit(
        model, intr[:, None, :].expand(B, M, intr.shape[-1]), uv)
    return ransac.ransac_pnp(f, pts, valid, generator,
                             pixel_threshold=pixel_threshold,
                             num_hypotheses=num_hypotheses, idx=idx)


def outlier_policy(tid_k: np.ndarray, fl: np.ndarray):
    """Vectorised outlier-removal policy over the contiguous per-track
    observation rows (sfm.cpp:2028-2131 scan loop): scan each track's
    records in insertion order; the first record that triggers removal
    decides the counter (per-record priority huge > normal > distance >
    z; normal triggers removal only when no severe flag exists anywhere).
    Returns (removed_tids, n_huge, n_normal, n_dist, n_z, any_severe),
    identical to the scalar loop (a copy of the JAX package's)."""
    n_normal = n_huge = n_dist = n_z = 0
    removed: list = []
    any_severe = bool(np.any(fl & ~OUTLIER_REPROJECTION_NORMAL))
    m = len(fl)
    if m:
        HUGE = OUTLIER_REPROJECTION_HUGE
        NORM = OUTLIER_REPROJECTION_NORMAL
        DIST = OUTLIER_CAMERA_DISTANCE
        ZC = OUTLIER_Z_COORDINATE
        starts = np.flatnonzero(np.r_[True, tid_k[1:] != tid_k[:-1]])
        seg_len = np.diff(np.r_[starts, m])
        seg_tids = tid_k[starts]
        stop_bits = (HUGE | DIST | ZC) if any_severe else (
            HUGE | NORM | DIST | ZC
        )
        pos = np.arange(m)
        stop_pos = np.where((fl & stop_bits) != 0, pos, m)
        first_stop = np.minimum.reduceat(stop_pos, starts)
        has_stop = first_stop < m
        cfl = fl[np.minimum(first_stop, m - 1)]
        cause_huge = has_stop & ((cfl & HUGE) != 0)
        rest = has_stop & ~cause_huge
        if any_severe:
            cause_dist = rest & ((cfl & DIST) != 0)
            cause_z = rest & ~cause_dist & ((cfl & ZC) != 0)
            # normal_counted: a NORMAL record seen strictly before the
            # stop, or on the stop record itself unless the scan broke at
            # its huge check first
            fs_exp = np.repeat(first_stop, seg_len)
            ch_exp = np.repeat(cause_huge, seg_len)
            elig = ((fl & NORM) != 0) & (
                (pos < fs_exp) | ((pos == fs_exp) & ~ch_exp)
            )
            n_normal = int(np.logical_or.reduceat(elig, starts).sum())
        else:
            cause_norm = rest & ((cfl & NORM) != 0)
            cause_dist = rest & ~cause_norm & ((cfl & DIST) != 0)
            cause_z = (rest & ~cause_norm & ~cause_dist
                       & ((cfl & ZC) != 0))
            n_normal = int(cause_norm.sum())
        n_huge = int(cause_huge.sum())
        n_dist = int(cause_dist.sum())
        n_z = int(cause_z.sum())
        removed = [int(t) for t in seg_tids[has_stop]]
    return removed, n_huge, n_normal, n_dist, n_z, any_severe


class SfmPipeline:
    def __init__(self, images: dict, calib, cfg: SfmConfig | None = None,
                 log=print, *, seed: int = 0, device="cuda",
                 cache_dir: str | None = None,
                 params_file: str | None = None):
        self.device = devices.resolve(device)
        # RANSAC's samples: the stand-in for the JAX package's key stream
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # None, or an iterator of (B, H, 3) sample indices, one per
        # localisation wave (the test seam of the module docstring)
        self.pnp_draws = None
        self.images = images          # {(frame, cam): (H, W) uint8}
        self.calib = calib            # .intrinsics, .cam_types, .T_i_c
        # a copy: params-file reloads change it in place
        self.cfg = dataclasses.replace(cfg if cfg is not None
                                       else SfmConfig())
        self.model = calib.cam_types[0] if calib.cam_types else "ds"
        self.log = log
        self.cache_dir = cache_dir
        self.params_file = params_file
        self._params_mtime = None
        self.fcids = sorted(images)
        self.num_frames = len({f for (f, _) in self.fcids})

        # map state
        self.corners: dict = {}
        self.matches: dict = {}
        self.tracks: dict = {}
        self.outlier_tracks: dict = {}
        self.cameras: dict = {}       # {fcid: (7,) pose T_w_c}
        self.landmarks: dict = {}     # {track id: Landmark}
        self.candidates: list[Candidate] = []
        self.stage = Stage.COMPUTE_CANDIDATES
        self.min_localization_inliers = 0
        self.max_cameras_to_add = 0
        self.image_projections = {}
        self._loc_cache: dict = {}
        # bumped by every in-place change of ``tracks`` (the outlier pass)
        self._tracks_version = 0
        # per-stage wall seconds, and of them the seconds spent in blocks
        # that compute on the device and end in a host fetch (same keys):
        # stage host bookkeeping = timings[k] - timings_dev[k]
        self.timings: dict = {}
        self.timings_dev: dict = {}
        self.device_seconds = 0.0
        # device-stage invocation counts, under the JAX package's names
        self.counters: dict = {}

        self._stacked = None  # device-side stacked features
        self.bow_voc = None   # a features.bow.BowVocabulary, for match_bow

    @classmethod
    def from_map(cls, map_dict: dict, corners: dict, calib,
                 cfg: SfmConfig | None = None, log=print, *, device="cuda"):
        """A pipeline holding a saved geometric map, as the JAX package's
        ``apps/pba.py --map-in`` loads one, without images or detection:
        ``map_dict`` the map pickle (``cameras``, ``tracks``,
        ``landmarks`` as dicts of ``inv_depth``, ``obs``,
        ``outlier_obs``), ``corners`` the cached detection ({fcid: feature
        dict}, the ``data`` of a corners cache), whose feature ids the
        observations name."""
        pipe = cls({}, calib, cfg, log, device=device)
        pipe.corners = dict(corners)
        pipe.fcids = sorted(pipe.corners)
        pipe.num_frames = len({f for (f, _) in pipe.fcids})
        pipe.cameras = dict(map_dict["cameras"])
        pipe.tracks = dict(map_dict.get("tracks", {}))
        pipe.outlier_tracks = dict(map_dict.get("outlier_tracks", {}))
        pipe.landmarks = {
            t: Landmark(d["inv_depth"], dict(d["obs"]),
                        dict(d.get("outlier_obs", {})))
            for t, d in map_dict["landmarks"].items()
        }
        return pipe

    # ---------------------------------------------------------------- utils

    def _count(self, name, n=1):
        self.counters[name] = self.counters.get(name, 0) + n

    @contextlib.contextmanager
    def _dev(self):
        """Add the wall time of a block that computes on the device and
        ends in a host fetch to ``device_seconds``."""
        t0 = time.time()
        try:
            yield
        finally:
            self.device_seconds += time.time() - t0

    def _uv_table(self):
        """Every detected keypoint's uv rows concatenated, with each image's
        base offset: a row lookup is one fancy index.  Rebuilt when
        ``corners`` is replaced or grows (corners are static after
        detection)."""
        c = getattr(self, "_uvt", None)
        if c is None or c[0] is not self.corners or c[1] != len(self.corners):
            offs, parts, base = {}, [], 0
            for fcid, kp in self.corners.items():
                offs[fcid] = base
                parts.append(kp["uv"])
                base += kp["uv"].shape[0]
            uv = np.concatenate(parts, axis=0) if parts else np.zeros((0, 2))
            self._uvt = c = (self.corners, len(self.corners), uv, offs)
        return c[2], c[3]

    def _pose_table(self):
        """Current camera poses stacked (K, 7) and fcid -> row map."""
        pose_of = {}
        rows = []
        for i, (f, T) in enumerate(self.cameras.items()):
            pose_of[f] = i
            rows.append(np.asarray(T))
        tab = np.stack(rows) if rows else np.zeros((0, 7))
        return tab, pose_of

    def _anchor_arrays(self, tids: list):
        """Per-row anchor data (uv, intr, T, rho) of Landmark::get_p for
        the track ids ``tids`` (repeats allowed)."""
        uvf, off = self._uv_table()
        pose_tab, pose_of = self._pose_table()
        cache: dict = {}
        uvidx, cam_l, pose_l, rho_l = [], [], [], []
        for t in tids:
            e = cache.get(t)
            if e is None:
                lm = self.landmarks[t]
                a = min(lm.obs)
                e = (off[a] + lm.obs[a], a[1], pose_of[a], lm.inv_depth)
                cache[t] = e
            uvidx.append(e[0])
            cam_l.append(e[1])
            pose_l.append(e[2])
            rho_l.append(e[3])
        uv = uvf[np.asarray(uvidx, np.int64)]
        rho = np.asarray(rho_l, np.float64)
        T = pose_tab[np.asarray(pose_l, np.int64)]
        intr = np.asarray(self.calib.intrinsics)[np.asarray(cam_l, np.int64)]
        return uv, intr, T, rho

    def landmark_positions(self, tids: list) -> np.ndarray:
        """World points (N, 3) of the landmarks ``tids`` (batched
        Landmark::get_p, common_types.h:205-217)."""
        if not tids:
            return np.zeros((0, 3))
        uv, intr, T, rho = self._anchor_arrays(tids)
        self._count("lmpos_calls")
        self._count("lmpos_rows", len(tids))
        with self._dev():
            args = _upload(self.device, uv, intr, T, rho)
            (p_w,) = _fetch(lm_positions(self.model, *args))
        return p_w

    # ------------------------------------------------------------ stage 1-2

    def detect_keypoints(self, batch: int = 8):
        """Detection and description of every image, in sub-batches of
        ``batch`` images on the device (one upload of the image stack, one
        fetch of all features)."""
        t0, d0 = time.time(), self.device_seconds
        self.clear_keypoints()
        N = len(self.fcids)
        if N == 0:
            self._stage_mark("detect", t0, d0)
            return
        stack = np.stack([np.asarray(self.images[f]) for f in self.fcids])
        self._count("detect_batches", -(-N // batch))
        with self._dev():
            feats = describe.detect_and_describe_all(
                torch.as_tensor(stack, device=self.device), batch=batch,
                num_features=self.cfg.num_features_per_image,
                rotate_features=self.cfg.rotate_features,
            )
            feats = interop.features_to_numpy(
                dict(zip(("uv", "valid", "angles", "desc"), feats)))
        for i, fcid in enumerate(self.fcids):
            self.corners[fcid] = {k: v[i] for k, v in feats.items()}
        self._stage_mark("detect", t0, d0)
        self._save_cache("corners")
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
        t0, d0 = time.time(), self.device_seconds
        self.clear_tracks()
        cfg = self.cfg
        dev = self.device
        self.log(f"Matching {self.num_frames} stereo pairs...")
        idx = {f: i for i, f in enumerate(self.fcids)}
        stereo = [
            (idx[(fid, 0)], idx[(fid, 1)], fid)
            for fid in range(self.num_frames)
            if (fid, 0) in idx and (fid, 1) in idx
        ]
        self._count("stereo_pairs", len(stereo))
        # stereo keeps ALL matches (the reference stores the full match
        # list of the rectified pair): cap at F, not at the all-pairs budget
        MM = cfg.num_features_per_image
        num_matches = num_inliers = 0
        with self._dev():
            T_i_c = torch.as_tensor(np.asarray(self.calib.T_i_c),
                                    dtype=torch.float64, device=dev)
            T_0_1, E = _stereo_geometry(T_i_c[0], T_i_c[1])
            T_0_1_np = T_0_1.cpu().numpy()
            uv, valid, desc, bear = self._stack_features()
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
                pairs, count, inl = _fetch(pairs, count, inl)
        for ci, (_, _, fid) in enumerate(stereo):
            n = int(count[ci])
            inliers = pairs[ci][inl[ci]]
            self.matches[((fid, 0), (fid, 1))] = {
                "T_i_j": T_0_1_np, "matches": pairs[ci][:n],
                "inliers": inliers,
            }
            num_matches += n
            num_inliers += len(inliers)
        self._stage_mark("match_stereo", t0, d0)
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

    def match_all(self):
        """Matching and relative-pose RANSAC of all non-stereo pairs
        (sfm.cpp:1275-1351)."""
        t0, d0 = time.time(), self.device_seconds
        self.clear_tracks()
        ids = self._pair_worklist()
        self.log(f"Brute-force matching {len(ids)} image pairs...")
        self._run_pair_matching(ids)
        self._stage_mark("match_all", t0, d0)
        self._report_pair_matching(ids)
        self._save_cache("matches")

    def _ransac_chunks(self, counts: np.ndarray, MM: int, itemsize: int):
        """The RANSAC chunks of a worklist with match ``counts``: a list of
        (positions in the worklist, columns).  The pairs go in order of
        their counts, largest first; a chunk is cut to the columns its
        largest count needs (a multiple of 32, at most MM) and holds as
        many pairs as the prescreen of ``RANSAC_MEMORY_SHARE`` of the
        card's memory (``RANSAC_CPU_BYTES`` on the CPU) allows, at 10
        candidates x hypotheses x columns of ``itemsize`` bytes a pair."""
        if self.device.type == "cuda":
            total = torch.cuda.get_device_properties(self.device).total_memory
            budget = int(total * RANSAC_MEMORY_SHARE)
        else:
            budget = RANSAC_CPU_BYTES
        order = np.argsort(-counts, kind="stable")
        out, s = [], 0
        while s < len(order):
            Mc = min(MM, max(32, -(-int(counts[order[s]]) // 32) * 32))
            C = max(1, budget // (10 * self.cfg.ransac_hypotheses * Mc
                                  * itemsize))
            out.append((order[s:s + C], Mc))
            s += C
        return out

    def _run_pair_matching(self, ids):
        """Match the worklist ``ids`` [(i, j)] of image indices and verify
        each pair; fills ``matches`` with the JAX package's layout, in
        worklist order.

        The pairs go to RANSAC in order of their match counts, largest
        first, in chunks cut to the columns their largest count needs (a
        multiple of 32; the rest are padding), each as large as the memory
        budget allows at that width: the work follows the matches, not
        the budget of ``max_matches_per_pair``."""
        cfg = self.cfg
        if not ids:
            return
        with self._dev():
            _, valid, desc, bear = self._stack_features()
            ids_np = np.asarray(ids, np.int64)
            m12 = pair_matching.match_pairs(
                desc, valid, ids_np[:, 0], ids_np[:, 1],
                cfg.feature_match_max_dist, cfg.feature_match_test_next_best)
            pairs, pvalid, count = match.matches_to_pairs(
                m12, cfg.max_matches_per_pair)
            del m12
            counts = count.cpu().numpy()
        verify = pair_matching.make_ransac_chunk(
            bear, ransac_thresh=cfg.relative_pose_ransac_thresh,
            ransac_min_inliers=cfg.relative_pose_ransac_min_inliers,
            ransac_hypotheses=cfg.ransac_hypotheses)
        i1 = torch.as_tensor(ids_np[:, 0], device=self.device)
        i2 = torch.as_tensor(ids_np[:, 1], device=self.device)
        fetched = []
        for sel, Mc in self._ransac_chunks(counts, pairs.shape[1],
                                           bear.element_size()):
            self._count("match_chunks")
            self._count("match_pairs", len(sel))
            with self._dev():
                sd = torch.as_tensor(sel, device=self.device)
                T, inl, _ = verify(i1[sd], i2[sd], pairs[sd, :Mc],
                                   pvalid[sd, :Mc], count[sd],
                                   self.generator)
                fetched.append(
                    (sel, _fetch(pairs[sd, :Mc], count[sd], T, inl)))
        rows = [None] * len(ids)
        for sel, out in fetched:
            for j, pos in enumerate(sel):
                rows[pos] = tuple(x[j] for x in out)
        self._consume(ids, rows)

    def _consume(self, ids, rows):
        """``matches`` entries of the pairs ``ids`` from their fetched
        (pairs, count, T, inlier mask) ``rows``."""
        fc = self.fcids
        for (a, b), (p, n, T, inl) in zip(ids, rows):
            self.matches[(fc[a], fc[b])] = {
                "T_i_j": T, "matches": p[:n], "inliers": p[inl]}

    def _report_pair_matching(self, ids):
        num_matches = num_inliers = num_success = 0
        for a, b in ids:
            md = self.matches[(self.fcids[a], self.fcids[b])]
            num_matches += len(md["matches"])
            num_inliers += len(md["inliers"])
            num_success += int(len(md["inliers"]) > 0)
        self.log(
            f"Successfully matched {num_success} out of {len(ids)} image "
            f"pairs with a total of {num_inliers} inlier feature matches "
            f"({num_matches} total). New total of matched image pairs is "
            f"{len(self.matches)}."
        )

    def _bow_worklist(self):
        """The pairs each image's bag-of-words query proposes among the
        images inserted before it, other frames only (sfm.cpp:1355-1452)."""
        from photometric_bundle_adjustment_tpu_torch.features import bow

        db = bow.BowDatabase(self.bow_voc.num_words)
        idx_of = {f: i for i, f in enumerate(self.fcids)}
        ids = []
        for fcid in self.fcids:
            c = self.corners[fcid]
            v = self.bow_voc.transform(c["desc"][c["valid"]])
            for other, _score in db.query(v, self.cfg.num_bow_candidates):
                if other[0] != fcid[0]:
                    ids.append((idx_of[fcid], idx_of[other]))
            db.insert(fcid, v)
        return ids

    def match_bow(self):
        """Matching and RANSAC of the bag-of-words candidate pairs
        (sfm.cpp:1355-1452); needs ``bow_voc``."""
        if self.bow_voc is None:
            self.log("Vocabulary not specified. Provide pipeline.bow_voc, "
                     "or use match_all.")
            return
        t0, d0 = time.time(), self.device_seconds
        self.clear_tracks()
        ids = self._bow_worklist()
        self.log(f"Matching {len(ids)} image pairs using BoW...")
        self._run_pair_matching(ids)
        self._stage_mark("match_bow", t0, d0)
        self._report_pair_matching(ids)
        self._save_cache("matches")

    # ------------------------------------------------------------- stage 3-4

    def build_tracks(self):
        """Feature tracks from the inlier matches (native union-find)."""
        self.clear_tracks()
        inlier_matches = {
            k: v["inliers"] for k, v in self.matches.items()
            if len(v["inliers"])
        }
        self.tracks = native_tracks.build_tracks(
            inlier_matches, self.cfg.min_track_length)
        n_inl = sum(len(v) for v in inlier_matches.values())
        total_obs = sum(len(t) for t in self.tracks.values())
        avg = total_obs / max(len(self.tracks), 1)
        self.log(
            f"Built {len(self.tracks)} feature tracks from {n_inl} matches. "
            f"Average track length is {avg:.5g}."
        )

    def initialize_scene(self):
        """First stereo pair plus triangulation (sfm.cpp:1543-1571,
        map_utils.h:204-227)."""
        self.clear_map()
        fcid0, fcid1 = (0, 0), (0, 1)
        self.cameras[fcid0] = np.array([0, 0, 0, 0, 0, 0, 1.0])
        self.cameras[fcid1] = np.asarray(self.calib.T_i_c[1], np.float64)
        self.add_landmarks_between(fcid0, fcid1)
        self.log(
            f"Initialized scene with {len(self.cameras)} cameras and "
            f"{len(self.landmarks)} landmarks."
        )
        self.stage = Stage.OPTIMIZE

    def _batch_triangulate(self, rows: list):
        """Triangulate (fcid0, fcid1, tid) rows in one batch with the
        parallax gate; returns (inv_depth (N,), ok (N,))."""
        uvf, off = self._uv_table()
        pose_tab, pose_of = self._pose_table()
        n = len(rows)
        uv0 = uvf[np.fromiter(
            (off[f0] + self.tracks[t][f0] for f0, _, t in rows), np.int64, n)]
        uv1 = uvf[np.fromiter(
            (off[f1] + self.tracks[t][f1] for _, f1, t in rows), np.int64, n)]
        intr = np.asarray(self.calib.intrinsics)
        i0 = np.fromiter((f0[1] for f0, _, _ in rows), np.int64, n)
        i1 = np.fromiter((f1[1] for _, f1, _ in rows), np.int64, n)
        T0 = pose_tab[np.fromiter((pose_of[f0] for f0, _, _ in rows),
                                  np.int64, n)]
        T1 = pose_tab[np.fromiter((pose_of[f1] for _, f1, _ in rows),
                                  np.int64, n)]
        self._count("triangulate_calls")
        self._count("triangulate_rows", n)
        # parallax gate: rays must subtend a minimum angle at the point,
        # else the midpoint depth is unconstrained (see config note)
        min_cos = float(np.cos(np.deg2rad(
            self.cfg.min_triangulation_angle_deg)))
        with self._dev():
            args = _upload(self.device, uv0, uv1, intr[i0], intr[i1], T0, T1)
            inv_depth, ok = _fetch(*triangulate_rows(self.model, *args,
                                                     min_cos))
        return inv_depth, ok

    def _add_triangulated(self, rows, inv_depth, ok) -> int:
        """First-passing-row-wins landmark insertion (pair order = the
        reference's sequential pair processing, sfm.cpp:1826-1880)."""
        n_new = 0
        for (f0, f1, t), rho, good in zip(rows, inv_depth, ok):
            if not good or t in self.landmarks:
                continue
            obs = {
                fcid: feat
                for fcid, feat in self.tracks[t].items()
                if fcid in self.cameras
            }
            self.landmarks[t] = Landmark(float(rho), obs)
            n_new += 1
        return n_new

    def _image_track_index(self):
        """Per-image track-id sets and track insertion ranks, rebuilt when
        the track dict changes: replaced (the key holds the dict itself, so
        an id cannot be reused), resized, or changed in place
        (``_tracks_version``, bumped by the outlier pass)."""
        key = (self.tracks, len(self.tracks), self._tracks_version)
        c = getattr(self, "_tix", None)
        if c is None or c[0][0] is not key[0] or c[0][1:] != key[1:]:
            idx: dict = {}
            order: dict = {}
            for i, (tid, tr) in enumerate(self.tracks.items()):
                order[tid] = i
                for fcid in tr:
                    idx.setdefault(fcid, set()).add(tid)
            self._tix = c = (key, idx, order)
        return c[1], c[2]

    def _shared_track_ids(self, fcid_a, fcid_b) -> list:
        """Track ids observed in both images, in track insertion order
        (tracks_in_images({a, b}, tracks), through the index)."""
        idx, order = self._image_track_index()
        s = idx.get(fcid_a, set()) & idx.get(fcid_b, set())
        return sorted(s, key=order.__getitem__)

    def add_landmarks_between(self, fcid0, fcid1) -> int:
        """Triangulate shared, not-yet-landmark tracks between two mapped
        cameras (add_new_landmarks_between_cams, map_utils.h:121-195)."""
        shared = self._shared_track_ids(fcid0, fcid1)
        new_tids = [t for t in shared if t not in self.landmarks]
        if not new_tids:
            return 0
        rows = [(fcid0, fcid1, t) for t in new_tids]
        inv_depth, ok = self._batch_triangulate(rows)
        return self._add_triangulated(rows, inv_depth, ok)

    # -------------------------------------------------------- incremental map

    def compute_camera_candidate_set(self):
        """Two-tier candidate selection (sfm.cpp:1608-1704)."""
        num_tried = sum(c.tried for c in self.candidates)
        num_added = sum(c.camera_added for c in self.candidates)
        num_remaining = len(self.images) - len(self.cameras)
        previous_attempt_failed = (
            self.min_localization_inliers > 0 and num_tried > 0
            and num_added == 0
        )
        self.candidates = []
        # the wave cache holds for one candidate round only (BA, outlier
        # removal and new landmarks change the geometry)
        self._loc_cache = {}
        self.stage = Stage.DONE
        if num_remaining <= 0:
            self.log(
                f"Cannot select candidate set. All {len(self.cameras)} have "
                "already been added. That's it..."
            )
            return
        if not previous_attempt_failed:
            self.min_localization_inliers = (
                self.cfg.desired_localization_inlier_count)
            self.max_cameras_to_add = self.cfg.desired_inlier_max_cameras_to_add
            self._next_candidate_set()
        if not self.candidates:
            if (previous_attempt_failed
                    and self.min_localization_inliers
                    <= self.cfg.minimal_localization_inlier_count):
                self.log(
                    "Previous candidate set with minimal shared track "
                    f"threshold {self.min_localization_inliers} didn't "
                    "result in any added camera, so don't try again. There "
                    f"are {num_remaining} cameras left. That's it..."
                )
                return
            self.min_localization_inliers = (
                self.cfg.minimal_localization_inlier_count)
            self.max_cameras_to_add = self.cfg.minimal_inlier_max_cameras_to_add
            self._next_candidate_set()
            if not self.candidates:
                self.log(
                    "Did not find any camera candidates (shared track "
                    f"thresh: {self.min_localization_inliers}). There are "
                    f"{num_remaining} cameras left. That's it..."
                )
                return
        self.log(
            f"Selected {len(self.candidates)} camera candidates from "
            f"{num_remaining} remaining cameras (shared track thresh: "
            f"{self.min_localization_inliers})."
        )
        self.stage = Stage.ADD_CAMERAS

    def _next_candidate_set(self):
        idx, _ = self._image_track_index()
        # landmark insertion rank reproduces shared_tracks' iteration
        # order (GetSharedTracks, tracks.h:209-221) from the index
        lm_rank = {tid: i for i, tid in enumerate(self.landmarks)}
        lm_keys = self.landmarks.keys()
        cands = []
        for fcid in self.fcids:
            if fcid in self.cameras:
                continue
            shared = sorted(idx.get(fcid, set()) & lm_keys,
                            key=lm_rank.__getitem__)
            if len(shared) >= self.min_localization_inliers:
                cands.append(Candidate(fcid, shared))
        cands.sort(key=lambda c: -len(c.shared_tracks))   # stable
        self.candidates = cands

    def localize_camera(self, fcid, shared_track_ids):
        """PnP RANSAC plus refinement (localize_camera,
        map_utils.h:242-302).

        Candidates are localised in batched waves (this candidate and the
        next untried ones, ``_localize_wave``) and served from a per-round
        cache: within an ADD_CAMERAS round the landmark geometry the PnP
        consumes is fixed, as the reference's ``Landmark.p``
        (common_types.h:188-219) does not move when observations are
        added mid-round, whereas the anchored representation could shift
        a landmark's anchor when a newly added camera sorts before it.
        Localising one camera at a time would give another map."""
        if fcid not in self._loc_cache:
            self._localize_wave(fcid, shared_track_ids)
        T_w_c, inl = self._loc_cache.pop(fcid)
        inlier_tids = [t for t, ok in zip(shared_track_ids, inl) if ok]
        return T_w_c, inlier_tids

    def _localize_wave(self, fcid, shared_track_ids):
        """One batched localisation of ``fcid`` and up to WAVE - 1 of the
        next untried candidates; results land in ``_loc_cache``.  The wave is
        padded to its longest member (``valid=False`` rows, the JAX
        package's padding values)."""
        wave = [(fcid, list(shared_track_ids))]
        for c in self.candidates:
            if len(wave) >= WAVE:
                break
            if c.fcid == fcid or c.tried or c.camera_added:
                continue
            wave.append((c.fcid, list(c.shared_tracks)))

        all_tids: list = []
        spans = []
        for _, tids in wave:
            spans.append((len(all_tids), len(tids)))
            all_tids.extend(tids)
        uv_a, intr_a, T_a, rho_a = self._anchor_arrays(all_tids)

        intr_tab = np.asarray(self.calib.intrinsics, np.float64)
        B = len(wave)
        M = max(1, max(n for _, n in spans))
        uv_b = np.zeros((B, M, 2))
        uva_b = np.zeros((B, M, 2))
        intra_b = np.zeros((B, M, intr_tab.shape[1]))
        Ta_b = np.zeros((B, M, 7))
        Ta_b[..., 6] = 1.0  # identity quaternion for padding rows
        rho_b = np.ones((B, M))
        val_b = np.zeros((B, M), bool)
        intr_b = np.zeros((B, intr_tab.shape[1]))
        for wi, ((f, tids), (s0, n)) in enumerate(zip(wave, spans)):
            uv = self.corners[f]["uv"][np.fromiter(
                (self.tracks[t][f] for t in tids), np.int64, n)]
            uv_b[wi, :n] = uv
            uv_b[wi, n:] = uv[-1] if n else 0.0
            uva_b[wi, :n] = uv_a[s0: s0 + n]
            intra_b[wi, :n] = intr_a[s0: s0 + n]
            intra_b[wi, n:] = intr_a[s0] if n else 1.0
            Ta_b[wi, :n] = T_a[s0: s0 + n]
            rho_b[wi, :n] = rho_a[s0: s0 + n]
            val_b[wi, :n] = True
            intr_b[wi] = intr_tab[f[1]]
            self._count("localize_calls")
            self._count("localize_rows", M)
        self._count("localize_waves")
        idx = None
        if self.pnp_draws is not None:
            idx = torch.as_tensor(np.asarray(next(self.pnp_draws))[:B],
                                  device=self.device)

        with self._dev():
            uv, uva, intra, Ta, rho = _upload(
                self.device, uv_b.reshape(B * M, 2), uva_b.reshape(B * M, 2),
                intra_b.reshape(B * M, -1), Ta_b.reshape(B * M, 7),
                rho_b.reshape(B * M))
            T, inl = localize_batch(
                self.model, uv.reshape(B, M, 2),
                torch.as_tensor(intr_b, device=self.device), uva, intra, Ta,
                rho, torch.as_tensor(val_b, device=self.device),
                self.generator,
                float(self.cfg.reprojection_error_pnp_inlier_threshold_pixel),
                int(self.cfg.pnp_hypotheses), idx=idx)
            T_b, inl_b = _fetch(T, inl)
        for wi, ((f, tids), (s0, n)) in enumerate(zip(wave, spans)):
            self._loc_cache[f] = (T_b[wi], inl_b[wi, :n])

    def add_next_camera(self):
        """Try the next untried candidate (add_next_camera,
        sfm.cpp:1708-1822)."""
        candidate = None
        i = 0
        num_added = sum(c.camera_added for c in self.candidates)
        for idx, c in enumerate(self.candidates):
            if not c.camera_added and not c.tried:
                c.tried = True
                candidate = c
                i = idx
                break
        else:
            i = len(self.candidates)

        if candidate is None:
            self.log(
                f"No more candidates (out of {len(self.candidates)}) to try. "
                f"Total added {num_added}."
            )
        elif num_added < self.max_cameras_to_add:
            fcid = candidate.fcid
            T_w_c, inlier_tids = self.localize_camera(
                fcid, candidate.shared_tracks)
            if self.cfg.always_add_all_observations:
                inlier_tids = candidate.shared_tracks
            if len(inlier_tids) < self.min_localization_inliers:
                self.log(
                    f"Cannot add camera {fcid} ({i + 1} of "
                    f"{len(self.candidates)}) with {len(inlier_tids)} "
                    "localization inlier "
                    f"({len(candidate.shared_tracks) - len(inlier_tids)} "
                    "outlier ignored)."
                )
            else:
                self.cameras[fcid] = T_w_c
                candidate.camera_added = True
                num_added += 1
                inlier_set = set(inlier_tids)
                for tid in candidate.shared_tracks:
                    if tid in inlier_set:
                        self.landmarks[tid].add_obs(
                            fcid, self.tracks[tid][fcid])
                    else:
                        self.landmarks[tid].outlier_obs[fcid] = (
                            self.tracks[tid][fcid])
                self.log(
                    f"Camera {fcid} ({i + 1} of {len(self.candidates)}) "
                    f"added to map observing {len(inlier_tids)} landmarks "
                    f"({len(candidate.shared_tracks) - len(inlier_tids)} "
                    "outlier ignored)."
                )

        more_to_add = True
        if i + 1 >= len(self.candidates):
            more_to_add = False
        elif num_added >= self.max_cameras_to_add:
            self.log(
                f"Reached maximum number of {num_added} (out of "
                f"{len(self.candidates)}) cameras to add in one go."
            )
            more_to_add = False
        if not more_to_add:
            if any(c.camera_added for c in self.candidates):
                self.stage = Stage.ADD_LANDMARKS
            else:
                self.stage = Stage.COMPUTE_CANDIDATES

    def add_new_landmarks(self):
        """Triangulate new landmarks for all cameras added this round in
        one batch (sfm.cpp:1826-1880).

        Row lists are collected per added camera in order and
        concatenated; ``_add_triangulated``'s first-passing-row-wins
        insertion then reproduces the reference's sequential per-camera
        processing (a track that an earlier camera's row triangulates is
        skipped for later cameras; one that fails stays available)."""
        pend = [c for c in self.candidates
                if c.camera_added and not c.landmarks_added]
        if not pend:
            self.log("No more cameras for which to add landmarks.")
            self.stage = Stage.OPTIMIZE
            return
        per_cam = []
        for candidate in pend:
            candidate.landmarks_added = True
            fcid = candidate.fcid
            rows = []
            for fcid_existing in list(self.cameras):
                if fcid_existing == fcid:
                    continue
                shared = self._shared_track_ids(fcid_existing, fcid)
                rows.extend((fcid_existing, fcid, t) for t in shared
                            if t not in self.landmarks)
            per_cam.append((fcid, rows))
        flat = [r for _, rows in per_cam for r in rows]
        if flat:
            inv_depth, ok = self._batch_triangulate(flat)
        base = 0
        for fcid, rows in per_cam:
            n_new = 0
            if rows:
                n_new = self._add_triangulated(
                    rows, inv_depth[base: base + len(rows)],
                    ok[base: base + len(rows)])
                base += len(rows)
            self.log(f"Added {n_new} new landmarks for image {fcid}.")
        self.stage = Stage.OPTIMIZE

    # ------------------------------------------------------------------- BA

    def _build_ba_problem(self, dtype=torch.float64):
        """The geometric BA problem of the map, on the pipeline's device:
        every camera (sorted by fcid; (0, 0) and (0, 1) fixed, the gauge
        of sfm.cpp:1903), every landmark (sorted by track id) anchored at
        its first observation, and one row per other observation, in
        landmark order then fcid order.  No padding: the JAX package
        buckets K, L and O to powers of two to bound recompiles.  Returns
        ``(problem, cam_list, lm_list)``."""
        cam_list = sorted(self.cameras)
        cam_index = {f: i for i, f in enumerate(cam_list)}
        lm_list = sorted(self.landmarks)
        K, L = len(cam_list), len(lm_list)
        poses = np.zeros((K, 7))
        for f, i in cam_index.items():
            poses[i] = self.cameras[f]
        rho = np.zeros(L)
        anchor_uv = np.zeros((L, 2))
        anchor_cam_idx = np.zeros(L, np.int64)
        anchor_intr = np.zeros(L, np.int64)
        for i, t in enumerate(lm_list):
            lm = self.landmarks[t]
            a = lm.anchor()
            rho[i] = lm.inv_depth
            anchor_uv[i] = self.corners[a]["uv"][lm.obs[a]]
            anchor_cam_idx[i] = cam_index[a]
            anchor_intr[i] = a[1]

        uvf, off = self._uv_table()
        keys_l, feats_l = [], []
        for t in lm_list:
            k_arr, f_arr = self.landmarks[t].sorted_obs_arrays()
            keys_l.append(k_arr[1:])   # skip the anchor (first in order)
            feats_l.append(f_arr[1:])
        nobs = np.fromiter((len(k) for k in keys_l), np.int64, L)
        keys = np.concatenate(keys_l) if L else np.zeros(0, np.int64)
        feats = np.concatenate(feats_l) if L else np.zeros(0, np.int64)
        ol = np.repeat(np.arange(L), nobs)
        if any(c >= 16 for _, c in self.fcids):
            raise ValueError("fcid encoding frame*16+cam needs cam ids < 16")
        cam_keys = np.fromiter((f * 16 + c for (f, c) in cam_list), np.int64,
                               K)
        oc = np.searchsorted(cam_keys, keys)
        if oc.size and not np.array_equal(
                cam_keys[np.minimum(oc, K - 1)], keys):
            raise ValueError("a BA observation names a camera not in the map")
        img_keys = np.fromiter((f * 16 + c for (f, c) in self.fcids),
                               np.int64, len(self.fcids))
        img_off = np.fromiter((off[f] for f in self.fcids), np.int64,
                              len(self.fcids))
        oi = np.searchsorted(img_keys, keys)
        if oi.size and not np.array_equal(
                img_keys[np.minimum(oi, len(img_keys) - 1)], keys):
            raise ValueError("a BA observation names an image without "
                             "corners")
        intr_tab = np.asarray(self.calib.intrinsics)
        fixed = np.zeros(K, bool)
        for f in [(0, 0), (0, 1)]:
            if f in cam_index:
                fixed[cam_index[f]] = True
        problem = geometric_ba.build_problem(
            poses=poses, inv_depth=rho, anchor_cam=anchor_cam_idx[ol],
            target_cam=oc, landmark=ol,
            uv_target=uvf[img_off[oi] + feats].reshape(-1, 2),
            uv_ref=anchor_uv[ol], intr_ref=intr_tab[anchor_intr[ol]],
            intr_target=intr_tab[keys % 16], valid=np.ones(len(ol), bool),
            fixed_cams=fixed, dtype=dtype, device=self.device)
        return problem, cam_list, lm_list

    def _run_ba_solve(self, problem, cam_list, lm_list, cfg):
        """One BA solve; updates cameras and landmarks from one fetch of
        the solved state and the costs; returns a host-side BAResult."""
        with self._dev():
            solved, res = geometric_ba.bundle_adjustment(
                problem, self.model, cfg)
            dt = solved.cam_states.dtype
            packed = torch.cat([
                solved.cam_states.reshape(-1), solved.inv_depth.to(dt),
                torch.stack([torch.as_tensor(res.cost, dtype=dt),
                             torch.as_tensor(res.initial_cost, dtype=dt)])
                .to(solved.cam_states.device)])
            packed = packed.cpu().numpy()
        nK7 = solved.cam_states.shape[0] * 7
        nL = solved.inv_depth.shape[0]
        poses = packed[:nK7].reshape(-1, 7)
        rho = packed[nK7: nK7 + nL]
        res = res._replace(cost=float(packed[nK7 + nL]),
                           initial_cost=float(packed[nK7 + nL + 1]))
        for i, f in enumerate(cam_list):
            self.cameras[f] = poses[i]
        for i, t in enumerate(lm_list):
            self.landmarks[t].inv_depth = float(rho[i])
        return res

    def optimize(self):
        """Bundle adjustment stage (sfm.cpp:1883-1925).  A map with no
        landmark has nothing to solve: the stage logs that and goes on."""
        t0, d0 = time.time(), self.device_seconds
        num_obs = sum(len(lm.obs) for lm in self.landmarks.values())
        num_new = (
            len(self.cameras)
            if self.min_localization_inliers == 0
            else sum(c.camera_added for c in self.candidates)
        )
        self.log(
            f"Optimizing map with {len(self.cameras)} cameras ({num_new} "
            f"new), {len(self.landmarks)} points and {num_obs} observations."
        )
        if not self.landmarks:
            self.log("Skipping bundle adjustment: the map has no landmarks.")
        else:
            self._count("ba_solves")
            problem, cam_list, lm_list = self._build_ba_problem()
            cfg = ba.BAConfig(
                max_iterations=20,
                huber_delta=self.cfg.reprojection_error_huber_pixel,
            )
            res = self._run_ba_solve(problem, cam_list, lm_list, cfg)
            if self.cfg.ba_optimize_intrinsics:
                # block-coordinate step on the shared per-physical-camera
                # intrinsics (the reference's optimize_intrinsics option,
                # map_utils.h:339-345), then re-polish poses
                self._refine_intrinsics()
                problem, cam_list, lm_list = self._build_ba_problem()
                res2 = self._run_ba_solve(problem, cam_list, lm_list, cfg)
                res = res2._replace(
                    iterations=res.iterations + res2.iterations,
                    initial_cost=res.initial_cost,
                )
            self.timings["ba_iters"] = self.timings.get("ba_iters", 0) + int(
                res.iterations)
            if self.cfg.ba_verbose >= 1:
                self.log(
                    f"BA: cost {float(res.initial_cost):.6e} -> "
                    f"{float(res.cost):.6e} in {int(res.iterations)} "
                    f"iterations ({time.time() - t0:.2f}s)"
                )
        self._stage_mark("ba", t0, d0, accumulate=True)
        if self.stage == Stage.OPTIMIZE:
            self.stage = Stage.REMOVE_OUTLIERS

    def _refine_intrinsics(self):
        """Refine the shared (num_cams, 8) intrinsics with poses and depths
        held fixed (the reference's optimize_intrinsics BA option,
        map_utils.h:339-345: the anchor-frame unprojection uses the
        pre-solve intrinsics as constants, the target-frame projection is
        differentiated).  Updates ``calib.intrinsics`` in place and drops
        the cached bearings."""
        from photometric_bundle_adjustment_tpu_torch.optim import lm as lm_mod

        rows = [
            (tid, fcid, feat)
            for tid, lm in self.landmarks.items()
            for fcid, feat in lm.obs.items()
        ]
        if not rows:
            return
        p_w = self.landmark_positions([r[0] for r in rows])
        T = np.stack([np.asarray(self.cameras[r[1]]) for r in rows])
        uv_meas = np.stack([self.corners[r[1]]["uv"][r[2]] for r in rows])
        cam_ids = np.array([r[1][1] for r in rows])
        model = self.model
        dev = self.device
        with self._dev():
            p_w_t, T_t, uv_t = _upload(dev, p_w, T, uv_meas)
            cam_t = torch.as_tensor(cam_ids, device=dev)
            p_c = se3.act(se3.inverse(T_t), p_w_t)  # fixed camera points

            def residuals(intr):
                uv_proj = cam_models.project(model, intr[cam_t], p_c)
                return (uv_t - uv_proj).reshape(-1)

            intr0 = torch.as_tensor(
                np.asarray(self.calib.intrinsics, np.float64), device=dev)
            n_cams, F = intr0.shape
            cfg = lm_mod.LMConfig(
                max_iterations=10,
                huber_delta=self.cfg.reprojection_error_huber_pixel,
                block_size=2)
            intr_opt, res = lm_mod.lm_solve(
                residuals, intr0, lambda x, d: x + d.reshape(n_cams, F),
                n_cams * F, cfg)
            self.calib.intrinsics = intr_opt.cpu().numpy()
        self._stacked = None  # bearings depend on intrinsics
        if self.cfg.ba_verbose >= 1:
            self.log(
                f"Intrinsics refinement: cost {float(res.initial_cost):.6e} "
                f"-> {float(res.cost):.6e} in {int(res.iterations)} "
                "iterations"
            )

    # ------------------------------------------------------------- outliers

    @property
    def image_projections(self) -> dict:
        """Per-image projection records {fcid: {"obs": [...],
        "outlier_obs": [...]}}, built lazily from the arrays of the last
        ``compute_projections`` call."""
        if self._image_projections is None:
            d: dict = {}
            if self._proj_data is not None:
                rows, uv_proj, err, flags = self._proj_data
                for i, (tid, fcid, feat, is_outlier) in enumerate(rows):
                    rec = {
                        "fcid": fcid, "err": float(err[i]),
                        "flags": int(flags[i]), "uv_proj": uv_proj[i],
                    }
                    d.setdefault(fcid, {"obs": [], "outlier_obs": []})
                    key = "outlier_obs" if is_outlier else "obs"
                    d[fcid][key].append(rec)
            self._image_projections = d
        return self._image_projections

    @image_projections.setter
    def image_projections(self, v):
        self._image_projections = v
        self._proj_data = None

    def compute_projections(self):
        """Batched reprojection of every observation, with outlier flags
        (compute_projections + set_outlier_flags, sfm.cpp:1928-2008).

        Returns ``(rows, err, flags)`` for the vectorised outlier policy,
        or None for an empty map; the per-image record dicts are built
        lazily (see ``image_projections``)."""
        self.image_projections = {}
        rows = []  # (tid, fcid, feat, is_outlier_obs)
        for tid, lm in self.landmarks.items():
            for fcid, feat in lm.obs.items():
                rows.append((tid, fcid, feat, False))
            for fcid, feat in lm.outlier_obs.items():
                rows.append((tid, fcid, feat, True))
        if not rows:
            return None
        n = len(rows)
        uv_a, intr_a, T_a, rho = self._anchor_arrays([r[0] for r in rows])
        uvf, off = self._uv_table()
        pose_tab, pose_of = self._pose_table()
        T = pose_tab[np.fromiter((pose_of[r[1]] for r in rows), np.int64, n)]
        uv_meas = uvf[np.fromiter((off[r[1]] + r[2] for r in rows),
                                  np.int64, n)]
        cam_ids = np.fromiter((r[1][1] for r in rows), np.int64, n)
        intr_t = np.asarray(self.calib.intrinsics)[cam_ids]
        self._count("project_calls")
        self._count("project_rows", n)
        with self._dev():
            args = _upload(self.device, uv_a, intr_a, T_a, rho, uv_meas,
                           intr_t, T)
            (packed,) = _fetch(project_obs(self.model, *args))
        return self._finish_projections(rows, packed[:, :2], packed[:, 2],
                                        packed[:, 3], packed[:, 4])

    def _finish_projections(self, rows, uv_proj, err, dist, zc):
        """Outlier flag assignment (set_outlier_flags, sfm.cpp:1974-2008)
        from the projected arrays."""
        cfg = self.cfg
        flags = np.zeros(len(rows), np.int32)
        flags |= np.where(
            err > cfg.reprojection_error_outlier_threshold_huge_pixel,
            OUTLIER_REPROJECTION_HUGE, 0)
        flags |= np.where(
            err > cfg.reprojection_error_outlier_threshold_normal_pixel,
            OUTLIER_REPROJECTION_NORMAL, 0)
        flags |= np.where(
            dist < cfg.camera_center_distance_outlier_threshold_meter,
            OUTLIER_CAMERA_DISTANCE, 0)
        flags |= np.where(
            zc < cfg.z_coordinate_outlier_threshold_meter,
            OUTLIER_Z_COORDINATE, 0)
        self._proj_data = (rows, uv_proj, err, flags)
        self._image_projections = None
        return rows, err, flags

    def remove_outlier_landmarks(self):
        """Outlier taxonomy and removal policy (sfm.cpp:2028-2131), as
        numpy segment reductions over the contiguous per-landmark rows of
        ``compute_projections`` (``outlier_policy``); counters and log
        strings are the JAX package's."""
        res = self.compute_projections()
        if res is None:
            removed, n_huge, n_normal, n_dist, n_z, any_severe = (
                [], 0, 0, 0, 0, False)
        else:
            rows, err, flags = res
            n = len(rows)
            keep = ~np.fromiter((r[3] for r in rows), bool, n)
            (removed, n_huge, n_normal, n_dist, n_z, any_severe) = (
                outlier_policy(
                    np.fromiter((r[0] for r in rows), np.int64, n)[keep],
                    flags[keep]))
        for tid in removed:
            if tid in self.tracks:
                self.outlier_tracks[tid] = self.tracks.pop(tid)
                self._tracks_version += 1
            self.landmarks.pop(tid, None)

        num_total = (n_huge + n_dist + n_z) if any_severe else n_normal
        if num_total > 0:
            if any_severe:
                self.log(
                    f"{num_total} outliers removed ({n_huge} for huge repr. "
                    f"error ({n_normal} not removed), {n_dist} too close to "
                    f"camera center, {n_z} too small z)."
                )
            else:
                self.log(
                    f"{num_total} outliers removed for too large repr. "
                    "error."
                )
        if self.stage == Stage.REMOVE_OUTLIERS:
            self.stage = (
                Stage.OPTIMIZE if num_total > 0 else Stage.COMPUTE_CANDIDATES)

    # ----------------------------------------------------------- state machine

    def _timed(self, name, fn, *args, **kwargs):
        t0, d0 = time.time(), self.device_seconds
        out = fn(*args, **kwargs)
        self._stage_mark(name, t0, d0, accumulate=True)
        return out

    def _stage_mark(self, name, t0, d0, accumulate=False):
        """Record a stage's wall and device-block seconds (host = wall -
        device); ``accumulate`` adds to any prior total for the stage."""
        dt = time.time() - t0
        dd = self.device_seconds - d0
        if accumulate:
            self.timings[name] = self.timings.get(name, 0.0) + dt
            self.timings_dev[name] = self.timings_dev.get(name, 0.0) + dd
        else:
            self.timings[name] = dt
            self.timings_dev[name] = dd

    def _maybe_reload_params(self):
        """Headless analog of the reference's live-tunable parameter panel
        (~30 GUI vars, sfm.cpp:197-261): if the watched JSON file changed
        since the last step, matching SfmConfig fields are updated in
        place and take effect from the next stage on."""
        path = self.params_file
        if not path or not os.path.exists(path):
            return
        # (mtime, size) stamp: a rewrite within the filesystem's timestamp
        # granularity is still picked up when the length changes; a torn
        # read is caught by the JSON-error retry path below
        st = os.stat(path)
        stamp = (st.st_mtime, st.st_size)
        if stamp == self._params_mtime:
            return
        self._params_mtime = stamp
        try:
            with open(path) as f:
                new = json.load(f)
        except (OSError, ValueError) as e:  # half-written file: retry later
            self.log(f"params-file {path}: not reloaded ({e})")
            self._params_mtime = None
            return
        known = {f.name for f in dataclasses.fields(self.cfg)}
        changed = []
        for k, v in new.items():
            if k not in known:
                self.log(f"params-file: unknown parameter {k!r} ignored")
                continue
            old = getattr(self.cfg, k)
            if isinstance(old, bool):
                # type(old)(v) would coerce the string "false" to True;
                # bool fields accept only JSON true/false
                if not isinstance(v, bool):
                    self.log(f"params-file: non-boolean value for {k!r} "
                             f"ignored: {v!r}")
                    continue
            else:
                try:
                    v = type(old)(v)
                except (TypeError, ValueError):
                    self.log(f"params-file: bad value for {k!r} ignored: "
                             f"{v!r}")
                    continue
            if v != old:
                setattr(self.cfg, k, v)
                changed.append(f"{k}: {old} -> {v}")
        if changed:
            self.log("Parameters updated: " + "; ".join(changed))

    def next_step(self) -> bool:
        """One pipeline step; returns False when done (next_step,
        sfm.cpp:1117-1167)."""
        self._maybe_reload_params()
        if not self.corners:
            if not self._load_cache("corners"):
                self.detect_keypoints()
            return True
        if not self.matches:
            if not self._load_cache("matches"):
                self.match_stereo()
                if self.cfg.use_match_bow:
                    self.match_bow()
                else:
                    self.match_all()
            return True
        if not self.tracks:
            self._timed("build_tracks", self.build_tracks)
            return True
        if not self.cameras:
            self._timed("init_scene", self.initialize_scene)
            return True
        if self.stage == Stage.COMPUTE_CANDIDATES:
            self._timed("candidates", self.compute_camera_candidate_set)
            return True
        if self.stage == Stage.ADD_CAMERAS:
            self._timed("add_cameras", self.add_next_camera)
            return True
        if self.stage == Stage.ADD_LANDMARKS:
            self._timed("add_landmarks", self.add_new_landmarks)
            return True
        if self.stage == Stage.OPTIMIZE:
            self.optimize()
            return True
        if self.stage == Stage.REMOVE_OUTLIERS:
            self._timed("remove_outliers", self.remove_outlier_landmarks)
            return True
        if self.counters:
            self.log(
                "Kernel invocations: "
                + " ".join(f"{k}={v}" for k, v in sorted(self.counters.items()))
            )
        self.log(self.summary())
        return False

    def run(self) -> None:
        while self.next_step():
            pass

    def summary(self) -> str:
        num_obs = sum(len(lm.obs) for lm in self.landmarks.values())
        num_outlier_obs = sum(
            len(lm.outlier_obs) for lm in self.landmarks.values())
        return (
            f"The map has {len(self.cameras)} cameras and "
            f"{len(self.landmarks)} landmarks with {num_obs} observations. "
            f"{len(self.outlier_tracks)} landmarks were removed as outliers "
            f"and {num_outlier_obs} observations were marked as outliers."
        )

    # ----------------------------------------------------------------- caches

    def _cache_path(self, name):
        if self.cache_dir is None:
            return None
        return os.path.join(self.cache_dir, f"{name}.pkl")

    def _save_cache(self, name):
        path = self._cache_path(name)
        if path is None:
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        data = self.corners if name == "corners" else self.matches
        with open(path, "wb") as f:
            pickle.dump({"n_images": len(self.images), "data": data}, f)
        self.log(f"Saved {name} as {path}")

    def _load_cache(self, name) -> bool:
        path = self._cache_path(name)
        if path is None or not os.path.exists(path):
            return False
        with open(path, "rb") as f:
            blob = pickle.load(f)
        if blob["n_images"] != len(self.images):
            self.log(
                f"Ignoring cached {name} from {path} (contains {name} for "
                f"{blob['n_images']} images, but we have now loaded "
                f"{len(self.images)} images)."
            )
            return False
        if name == "corners":
            self.corners = blob["data"]
        else:
            self.matches = blob["data"]
        self.log(f"Loaded cached {name} from {path}")
        return True

    # ------------------------------------------------------------------ clears

    def clear_keypoints(self):
        self.corners = {}
        self._stacked = None
        self.clear_matches()

    def clear_matches(self):
        self.matches = {}
        self.clear_tracks()

    def clear_tracks(self):
        self.tracks = {}
        self.outlier_tracks = {}
        self.clear_map()

    def clear_map(self):
        self.cameras = {}
        self.landmarks = {}
        self.candidates = []
        self.stage = Stage.COMPUTE_CANDIDATES
        self.min_localization_inliers = 0
        self.max_cameras_to_add = 0
        self.image_projections = {}
        self._loc_cache = {}
