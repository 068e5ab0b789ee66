"""Vectorised + native track building.

Port of ``photometric_bundle_adjustment_tpu/pipeline/native_tracks.py``:
node enumeration and track filtering are vectorised numpy; the union-find
core runs in the C++ shared library ``native/trackbuilder.cpp`` (the
port's own copy), compiled with g++ at first use into ``build/native/``
at the root of the checkout and loaded via ctypes.  The library's name
holds a hash of the source and the flags, so an edited source is rebuilt.
A missing compiler or a failed build raises: there is no pure-Python
fallback here (``tracks.build_tracks`` is the plain version the tests hold
it against).

Track ids are the union-find roots and the dict's insertion order is node
order, both as the JAX package's: every later stage of the pipeline
orders by them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "trackbuilder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC")

_LIB = None


def _get_lib() -> ctypes.CDLL:
    """The compiled union-find, built if needed; raises on failure."""
    global _LIB
    if _LIB is not None:
        return _LIB
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"libtrackbuilder-{digest}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    lib.uf_build.argtypes = [
        ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
    ]
    lib.uf_build.restype = None
    _LIB = lib
    return lib


def build_tracks(matches: dict, min_track_length: int = 3) -> dict:
    """The tracks of ``tracks.build_tracks`` (the same tracks and filter
    rules, tracks.h:103-146), keyed by union-find root."""
    lib = _get_lib()

    # nodes encoded as fcid_code * BIG + feature, fcid_code the rank of the
    # fcid among every fcid of the matches
    fcids = sorted({f for pair in matches for f in pair})
    fcid_code = {f: i for i, f in enumerate(fcids)}
    BIG = 1 << 22  # > max features per image

    a_list, b_list = [], []
    for (fi, fj), inliers in matches.items():
        arr = np.asarray(inliers, np.int64).reshape(-1, 2)
        if len(arr) == 0:
            continue
        a_list.append(fcid_code[fi] * BIG + arr[:, 0])
        b_list.append(fcid_code[fj] * BIG + arr[:, 1])
    if not a_list:
        return {}
    a = np.concatenate(a_list)
    b = np.concatenate(b_list)

    nodes = np.unique(np.concatenate([a, b]))
    ai = np.searchsorted(nodes, a)
    bi = np.searchsorted(nodes, b)

    roots = np.empty(len(nodes), np.int64)
    lib.uf_build(len(nodes), len(a), np.ascontiguousarray(ai),
                 np.ascontiguousarray(bi), roots)

    # vectorised filtering: group sizes, distinct-image counts
    img_of_node = nodes // BIG
    feat_of_node = nodes % BIG
    order = np.argsort(roots, kind="stable")
    r_sorted = roots[order]
    group_start = np.flatnonzero(
        np.concatenate([[True], r_sorted[1:] != r_sorted[:-1]]))
    group_sizes = np.diff(np.concatenate([group_start, [len(r_sorted)]]))

    # distinct images per group: unique (root, image) pairs
    pair_codes = np.unique(roots.astype(np.uint64) * np.uint64(1 << 20)
                           + img_of_node.astype(np.uint64))
    uniq_roots_of_pairs = (pair_codes >> np.uint64(20)).astype(np.int64)
    distinct_imgs = np.bincount(
        np.searchsorted(r_sorted[group_start], uniq_roots_of_pairs),
        minlength=len(group_start))

    keep = (group_sizes >= min_track_length) & (distinct_imgs == group_sizes)

    tracks_out: dict = {}
    keep_group_of_node = keep[np.searchsorted(r_sorted[group_start], roots)]
    for idx in np.flatnonzero(keep_group_of_node):
        tid = int(roots[idx])
        tracks_out.setdefault(tid, {})[fcids[int(img_of_node[idx])]] = int(
            feat_of_node[idx])
    return tracks_out
