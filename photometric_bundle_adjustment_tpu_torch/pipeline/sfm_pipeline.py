"""Incremental stereo SfM pipeline: the front-end stages.

Port of the first stages of ``photometric_bundle_adjustment_tpu/pipeline/
sfm_pipeline.py`` (the reference's main program, src/sfm.cpp:1117-2131):
detection and description of every image, then stereo matching with the
epipolar check, then matching of every other image pair (``match_all``)
or of the pairs a bag-of-words query proposes (``match_bow``), each pair
verified by a relative-pose RANSAC.  Tracks and the map stages come with
a later slice.

``_run_pair_matching`` matches a whole worklist with one
``pair_matching.match_pairs`` call (one Hamming kernel launch on the
card) and one compaction (``match.matches_to_pairs``), then runs the
RANSAC in chunks of pairs of similar match counts, each cut to the
columns its largest count needs and sized by the device's memory,
fetching each chunk's results in one copy.  RANSAC draws its samples from the
pipeline's ``torch.Generator`` (``seed``), which stands in for the JAX
package's key stream; the JAX package's CPU branch through its native
C++ matcher is a CPU speed path and is not ported: on the CPU the port
takes the Hamming kernel's plain version.

A saved geometric map enters through ``SfmPipeline.from_map`` (cameras,
tracks, landmarks and the cached corners, no images), and
``_build_ba_problem`` turns it into the geometric BA problem that
``models/geometric_ba.bundle_adjustment`` solves.  It pads nothing: the
JAX package buckets K, L and O to powers of two, and on accelerators
pre-pads K to the dataset's size, to bound recompiles; PyTorch compiles
nothing per shape.

The stages run on ``device`` (the card unless the caller asks for the
CPU).  Descriptor matching goes through the Hamming kernel there: one
launch gives both directions of all stereo pairs.  Feature dicts and match lists
have the JAX package's layout; descriptors in ``corners`` are uint32, as
there.  The counters keep the JAX package's names but count what runs
here: ``stereo_chunks`` is 1 per ``match_stereo``, since every stereo
pair goes through one batch (the JAX package counts one per
``match_chunk_pairs`` chunk).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

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
)
from photometric_bundle_adjustment_tpu_torch.models import geometric_ba
from photometric_bundle_adjustment_tpu_torch.pipeline.config import SfmConfig


@dataclass
class Landmark:
    inv_depth: float
    obs: dict                      # {fcid: feature_id}
    outlier_obs: dict = field(default_factory=dict)

    def anchor(self):
        """First observation in FrameCamId order, the reference frame
        (obs.begin() on the ordered map, map_utils.h:351-352)."""
        return min(self.obs)

    def sorted_obs_arrays(self):
        """(fcid keys, feature ids) of ``obs`` in FrameCamId order, as int64
        arrays with fcid encoded frame*16+cam.  (The JAX package caches
        them for its ~40 BA builds a run; one build here needs no
        cache.)"""
        items = sorted(self.obs.items())
        n = len(items)
        keys = np.fromiter((f * 16 + cam for (f, cam), _ in items), np.int64,
                           n)
        feats = np.fromiter((ft for _, ft in items), np.int64, n)
        return keys, feats


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


def _stereo_geometry(T_c0: torch.Tensor, T_c1: torch.Tensor):
    """Stereo extrinsics T_0_1 and the essential matrix of the pair."""
    T_0_1 = se3.compose(se3.inverse(T_c0), T_c1)
    return T_0_1, geometry.essential_from_pose(T_0_1)


class SfmPipeline:
    def __init__(self, images: dict, calib, cfg: SfmConfig = SfmConfig(),
                 log=print, *, seed: int = 0, device="cuda"):
        self.device = devices.resolve(device)
        # RANSAC's samples: the stand-in for the JAX package's key stream
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.images = images          # {(frame, cam): (H, W) uint8}
        self.calib = calib            # .intrinsics, .cam_types, .T_i_c
        self.cfg = cfg
        self.model = calib.cam_types[0] if calib.cam_types else "ds"
        self.log = log
        self.fcids = sorted(images)
        self.num_frames = len({f for (f, _) in self.fcids})

        # map state: the front-end stages fill corners and matches; the
        # map stages (a later slice) or ``from_map`` the rest
        self.corners: dict = {}
        self.matches: dict = {}
        self.tracks: dict = {}
        self.outlier_tracks: dict = {}
        self.cameras: dict = {}       # {fcid: (7,) pose}
        self.landmarks: dict = {}     # {track id: Landmark}
        # per-stage wall seconds
        self.timings: dict = {}
        # device-stage invocation counts, under the JAX package's names
        self.counters: dict = {}

        self._stacked = None  # device-side stacked features
        self.bow_voc = None   # a features.bow.BowVocabulary, for match_bow

    @classmethod
    def from_map(cls, map_dict: dict, corners: dict, calib,
                 cfg: SfmConfig = SfmConfig(), log=print, *, device="cuda"):
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
        pipe.landmarks = {
            t: Landmark(d["inv_depth"], dict(d["obs"]),
                        dict(d.get("outlier_obs", {})))
            for t, d in map_dict["landmarks"].items()
        }
        return pipe

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

    def match_all(self):
        """Matching and relative-pose RANSAC of all non-stereo pairs
        (sfm.cpp:1275-1351)."""
        t0 = time.time()
        self.clear_tracks()
        ids = self._pair_worklist()
        self.log(f"Brute-force matching {len(ids)} image pairs...")
        self._run_pair_matching(ids)
        self.timings["match_all"] = time.time() - t0
        self._report_pair_matching(ids)

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
        _, valid, desc, bear = self._stack_features()
        if not ids:
            return
        ids_np = np.asarray(ids, np.int64)
        m12 = pair_matching.match_pairs(
            desc, valid, ids_np[:, 0], ids_np[:, 1],
            cfg.feature_match_max_dist, cfg.feature_match_test_next_best)
        pairs, pvalid, count = match.matches_to_pairs(
            m12, cfg.max_matches_per_pair)
        del m12
        verify = pair_matching.make_ransac_chunk(
            bear, ransac_thresh=cfg.relative_pose_ransac_thresh,
            ransac_min_inliers=cfg.relative_pose_ransac_min_inliers,
            ransac_hypotheses=cfg.ransac_hypotheses)
        i1 = torch.as_tensor(ids_np[:, 0], device=self.device)
        i2 = torch.as_tensor(ids_np[:, 1], device=self.device)
        fetched = []
        for sel, Mc in self._ransac_chunks(count.cpu().numpy(), pairs.shape[1],
                                           bear.element_size()):
            sd = torch.as_tensor(sel, device=self.device)
            self._count("match_chunks")
            self._count("match_pairs", len(sel))
            T, inl, _ = verify(i1[sd], i2[sd], pairs[sd, :Mc],
                               pvalid[sd, :Mc], count[sd], self.generator)
            fetched.append((sel, _fetch(pairs[sd, :Mc], count[sd], T, inl)))
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
        t0 = time.time()
        self.clear_tracks()
        ids = self._bow_worklist()
        self.log(f"Matching {len(ids)} image pairs using BoW...")
        self._run_pair_matching(ids)
        self.timings["match_bow"] = time.time() - t0
        self._report_pair_matching(ids)

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

    # ------------------------------------------------------------------- BA

    def _uv_table(self):
        """Every detected keypoint's uv rows concatenated, with each image's
        base offset: a row lookup is one fancy index."""
        offs, parts, base = {}, [], 0
        for fcid, c in self.corners.items():
            offs[fcid] = base
            parts.append(c["uv"])
            base += c["uv"].shape[0]
        uv = np.concatenate(parts, axis=0) if parts else np.zeros((0, 2))
        return uv, offs

    def _build_ba_problem(self, dtype=torch.float64):
        """The geometric BA problem of the map, on the pipeline's device:
        every camera (sorted by fcid; (0, 0) and (0, 1) fixed, the gauge
        of sfm.cpp:1903), every landmark (sorted by track id) anchored at
        its first observation, and one row per other observation, in
        landmark order then fcid order.  No padding (module docstring).
        Returns ``(problem, cam_list, lm_list)``."""
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
