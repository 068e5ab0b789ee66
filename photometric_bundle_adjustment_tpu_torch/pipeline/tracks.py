"""Feature-track building: transitive closure of pairwise inlier matches.

A copy of ``photometric_bundle_adjustment_tpu/pipeline/tracks.py`` (numpy
only), the plain version of ``native_tracks.build_tracks``.  Host-side
bookkeeping (O(matches), no flops: SURVEY §7 keeps this off the device on
purpose).  Replaces TrackBuilder + UnionFind
(include/visnav/tracks.h:53-172, union_find.h): path-compressed union-find
over (image, feature) nodes, then filtering of tracks that are too short or
observe the same image twice, then export as {track_id: {fcid: feature}}.
"""

from __future__ import annotations

import numpy as np


class UnionFind:
    """Array-based disjoint sets with path compression + union by rank."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.rank = np.zeros(n, dtype=np.int32)

    def find(self, i: int) -> int:
        root = i
        p = self.parent
        while p[root] != root:
            root = p[root]
        while p[i] != root:  # path compression
            p[i], i = root, p[i]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1


def build_tracks(matches: dict, min_track_length: int = 3) -> dict:
    """Build feature tracks from pairwise inlier matches.

    Args:
      matches: {(fcid_i, fcid_j): inlier index pairs (n, 2) array-like}
        where fcid = (frame_id, cam_id).
      min_track_length: minimum number of distinct images (sfm.cpp:214).

    Returns:
      {track_id: {fcid: feature_id}} with conflict-free tracks only
      (TrackBuilder::{Build,Filter,Export} semantics, tracks.h:58-171).
    """
    # 1-2. enumerate nodes
    node_index: dict = {}
    for (fi, fj), inliers in matches.items():
        for a, b in np.asarray(inliers).reshape(-1, 2):
            node_index.setdefault((fi, int(a)), len(node_index))
            node_index.setdefault((fj, int(b)), len(node_index))

    uf = UnionFind(len(node_index))

    # 3-4. union matched features
    for (fi, fj), inliers in matches.items():
        for a, b in np.asarray(inliers).reshape(-1, 2):
            uf.union(node_index[(fi, int(a))], node_index[(fj, int(b))])

    # group nodes by root
    groups: dict = {}
    for node, idx in node_index.items():
        groups.setdefault(uf.find(idx), []).append(node)

    # filter: image-id conflicts and short tracks (tracks.h:103-146)
    tracks = {}
    for root, nodes in groups.items():
        images = {fcid for fcid, _ in nodes}
        if len(images) != len(nodes):  # same image observed twice
            continue
        if len(images) < min_track_length:
            continue
        tracks[int(root)] = {fcid: feat for fcid, feat in nodes}
    return tracks


def tracks_in_images(image_ids: set, tracks: dict) -> list:
    """Track ids observed in ALL of image_ids (GetTracksInImages,
    tracks.h:175-197)."""
    out = []
    for tid, tr in tracks.items():
        if all(fcid in tr for fcid in image_ids):
            out.append(tid)
    return out


def shared_tracks(fcid, tracks: dict, landmarks: dict) -> list:
    """Tracks that are both landmarks and observed in fcid (GetSharedTracks,
    tracks.h:209-221)."""
    return [tid for tid in landmarks if fcid in tracks.get(tid, {})]
