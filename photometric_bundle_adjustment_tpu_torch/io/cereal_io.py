"""Binary-cereal interop: read/write the reference's native artifacts.

A copy of ``photometric_bundle_adjustment_tpu/io/cereal_io.py`` (numpy
only), which ``features.bow`` reads vocabularies and databases through.

The reference exchanges stage caches and maps as cereal ``BinaryArchive``
streams (map_utils.h:58-116 ``save_map_file``/``load_map_file``,
sfm.cpp:1203-1211/:1261-1269 corners/matches caches) and loads its BoW
vocabulary the same way (bow_voc.h:138-153).  This module implements that
byte format in pure Python so the pipeline can consume and produce
the reference binary's own files with no C++ bridge.

Schema, derived from the vendored cereal 1.x binary archive rules plus the
reference's adapters (serialization.h:52-207):

  * arithmetic values: raw little-endian bytes, no tags (NVPs vanish);
  * containers (vector / map / unordered_map / tbb concurrent maps via the
    generic pair-associative concept): u64 size tag, then elements
    (map items as key then value);
  * std::string: u64 size tag + bytes;
  * fixed-size Eigen matrices: elements in row-major loop order, no dims
    (serialization.h:57-90; dynamic dims would add i32 rows/cols);
  * Sophus::SE3d: px py pz qx qy qz qw as 7 f64 (serialization.h:156-164);
  * std::bitset<256>: u8 type tag 3 ("bits") + 32 bytes, bit i of the
    bitset at bit (7 - i%8) of byte i//8 (cereal/types/bitset.hpp, the
    BinaryData-capable overload);
  * FrameCamId: i64 frame_id + u64 cam_id (common_types.h:58-77,
    serialization.h:203-206);
  * KeypointsData: corners (vector of Vector2d), corner_angles
    (vector<f64>), corner_descriptors (vector<bitset<256>>)
    (serialization.h:186-190);
  * MatchData: T_i_j, INLIERS, matches — note inliers precede matches
    (serialization.h:177-179); pairs of i32 FeatureIds;
  * FeatureTrack: std::map<FrameCamId, i32>;
  * Camera: T_w_c only (serialization.h:193-195);
  * Landmark: f64 inv_depth + obs + outlier_obs FeatureTracks
    (serialization.h:198-200);
  * map file payload order: corners, matches, tracks, outlier_tracks,
    cameras, landmarks (map_utils.h:64-73);
  * BoW vocabulary: i32 m_k, i32 m_L, vector<Node> with Node =
    (u32 id, f64 weight, vector<u32> children, u32 parent,
    bitset<256> descriptor, u32 word_id) (bow_voc.h:189-207).

Descriptors convert between the reference's bitset order and this
framework's packed (8,) uint32 words (bit d of word w = bitset bit
32*w + d, features/describe.py).
"""

from __future__ import annotations

import struct

import numpy as np

_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")
_I32 = struct.Struct("<i")
_U32 = struct.Struct("<I")
_F64 = struct.Struct("<d")
_U8 = struct.Struct("<B")


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, st):
        v = st.unpack_from(self.data, self.pos)[0]
        self.pos += st.size
        return v

    def u64(self):
        return self._take(_U64)

    def i64(self):
        return self._take(_I64)

    def i32(self):
        return self._take(_I32)

    def u32(self):
        return self._take(_U32)

    def f64(self):
        return self._take(_F64)

    def u8(self):
        return self._take(_U8)

    def raw(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def f64s(self, n: int) -> np.ndarray:
        a = np.frombuffer(self.data, "<f8", n, self.pos)
        self.pos += 8 * n
        return a

    def done(self) -> bool:
        return self.pos == len(self.data)


class _Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def u64(self, v):
        self.parts.append(_U64.pack(v))

    def i64(self, v):
        self.parts.append(_I64.pack(v))

    def i32(self, v):
        self.parts.append(_I32.pack(v))

    def u32(self, v):
        self.parts.append(_U32.pack(v))

    def f64(self, v):
        self.parts.append(_F64.pack(v))

    def u8(self, v):
        self.parts.append(_U8.pack(v))

    def raw(self, b: bytes):
        self.parts.append(bytes(b))

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


# --------------------------------------------------------------------------
# bitset<256> <-> packed (8,) uint32 descriptor words
# --------------------------------------------------------------------------

# cereal stores bitset bit i at bit (7 - i % 8) of byte i // 8; our packed
# words store bit i = 32*w + d as (word[w] >> d) & 1.  Both are fixed
# permutations of 256 bits -> precompute byte-level lookup-free reshapes.

def _bitset_bytes_to_words(b: bytes) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(b, np.uint8))          # MSB-first: bit i
    w = bits.reshape(8, 32)                                    # [word, d]
    return np.packbits(w[:, ::-1], axis=1, bitorder="big").view(">u4").astype(
        np.uint32).reshape(8)


def _words_to_bitset_bytes(words: np.ndarray) -> bytes:
    w = np.unpackbits(
        words.astype(">u4").view(np.uint8).reshape(8, 4), axis=1,
        bitorder="big",
    )[:, ::-1]                                                 # [word, d]
    return np.packbits(w.reshape(256)).tobytes()


def _read_bitset256(r: _Reader) -> np.ndarray:
    t = r.u8()
    if t != 3:  # bitset_detail::type::bits
        raise ValueError(f"unsupported cereal bitset encoding {t}")
    return _bitset_bytes_to_words(r.raw(32))


def _write_bitset256(w: _Writer, words: np.ndarray) -> None:
    w.u8(3)
    w.raw(_words_to_bitset_bytes(np.asarray(words, np.uint32)))


# --------------------------------------------------------------------------
# core composite types
# --------------------------------------------------------------------------


def _read_fcid(r: _Reader):
    return (r.i64(), r.u64())


def _write_fcid(w: _Writer, fcid) -> None:
    w.i64(int(fcid[0]))
    w.u64(int(fcid[1]))


def _read_se3(r: _Reader) -> np.ndarray:
    """(7,) [px py pz qx qy qz qw] — this framework's pose layout."""
    return r.f64s(7).copy()


def _write_se3(w: _Writer, T) -> None:
    T = np.asarray(T, np.float64)
    for v in T:
        w.f64(float(v))


def _read_keypoints(r: _Reader):
    n = r.u64()
    uv = r.f64s(2 * n).reshape(n, 2).copy()
    na = r.u64()
    angles = r.f64s(na).copy()
    nd = r.u64()
    desc = np.stack([_read_bitset256(r) for _ in range(nd)]) if nd else (
        np.zeros((0, 8), np.uint32))
    return {"uv": uv, "angles": angles, "descriptors": desc}


def _write_keypoints(w: _Writer, kp) -> None:
    uv = np.asarray(kp["uv"], np.float64)
    w.u64(uv.shape[0])
    w.raw(uv.astype("<f8").tobytes())
    angles = np.asarray(kp["angles"], np.float64)
    w.u64(angles.shape[0])
    w.raw(angles.astype("<f8").tobytes())
    desc = np.asarray(kp["descriptors"], np.uint32)
    w.u64(desc.shape[0])
    for row in desc:
        _write_bitset256(w, row)


def _read_pairs_i32(r: _Reader) -> np.ndarray:
    n = r.u64()
    a = np.frombuffer(r.data, "<i4", 2 * n, r.pos).reshape(n, 2).copy()
    r.pos += 8 * n
    return a


def _write_pairs_i32(w: _Writer, pairs) -> None:
    p = np.asarray(pairs, np.int32).reshape(-1, 2)
    w.u64(p.shape[0])
    w.raw(p.astype("<i4").tobytes())


def _read_track(r: _Reader) -> dict:
    n = r.u64()
    return {_read_fcid(r): r.i32() for _ in range(n)}


def _write_track(w: _Writer, track: dict) -> None:
    w.u64(len(track))
    # std::map<FrameCamId, .> iterates in key order (operator<:
    # frame_id then cam_id, common_types.h:87-92)
    for fcid in sorted(track):
        _write_fcid(w, fcid)
        w.i32(int(track[fcid]))


def _read_tracks(r: _Reader) -> dict:
    n = r.u64()
    return {r.i64(): _read_track(r) for _ in range(n)}


def _write_tracks(w: _Writer, tracks: dict, sort: bool) -> None:
    w.u64(len(tracks))
    for tid in (sorted(tracks) if sort else tracks):
        w.i64(int(tid))
        _write_track(w, tracks[tid])


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------


def load_map_cereal(path: str) -> dict:
    """Read a reference ``map.cereal`` (save_map_file payload).

    Returns dict with keys:
      corners:        {fcid: {uv (N,2) f64, angles (N,), descriptors
                       (N,8) uint32 — this framework's packed layout}}
      matches:        {(fcid_i, fcid_j): {T_i_j (7,), inliers (Ni,2) i32,
                       matches (Nm,2) i32}}
      feature_tracks: {track_id: {fcid: feature_id}}
      outlier_tracks: same
      cameras:        {fcid: T_w_c (7,) f64}
      landmarks:      {track_id: {inv_depth, obs, outlier_obs}}
    fcid keys are (frame_id, cam_id) int tuples.
    """
    with open(path, "rb") as f:
        r = _Reader(f.read())
    corners = {_read_fcid(r): _read_keypoints(r) for _ in range(r.u64())}
    matches = {}
    for _ in range(r.u64()):
        key = (_read_fcid(r), _read_fcid(r))
        T = _read_se3(r)
        inliers = _read_pairs_i32(r)   # inliers precede matches
        mm = _read_pairs_i32(r)
        matches[key] = {"T_i_j": T, "inliers": inliers, "matches": mm}
    feature_tracks = _read_tracks(r)
    outlier_tracks = _read_tracks(r)
    cameras = {_read_fcid(r): _read_se3(r) for _ in range(r.u64())}
    landmarks = {}
    for _ in range(r.u64()):
        tid = r.i64()
        landmarks[tid] = {
            "inv_depth": r.f64(),
            "obs": _read_track(r),
            "outlier_obs": _read_track(r),
        }
    if not r.done():
        raise ValueError(
            f"trailing bytes in {path}: read {r.pos} of {len(r.data)}"
        )
    return {
        "corners": corners, "matches": matches,
        "feature_tracks": feature_tracks, "outlier_tracks": outlier_tracks,
        "cameras": cameras, "landmarks": landmarks,
    }


def save_map_cereal(path: str, corners: dict, matches: dict,
                    feature_tracks: dict, outlier_tracks: dict,
                    cameras: dict, landmarks: dict) -> None:
    """Write a ``map.cereal`` the reference binary can load.

    Unordered containers are written in sorted-key order (any order is
    legal for the reader; sorting makes output deterministic)."""
    w = _Writer()
    w.u64(len(corners))
    for fcid in sorted(corners):
        _write_fcid(w, fcid)
        _write_keypoints(w, corners[fcid])
    w.u64(len(matches))
    for key in sorted(matches):
        _write_fcid(w, key[0])
        _write_fcid(w, key[1])
        m = matches[key]
        _write_se3(w, m["T_i_j"])
        _write_pairs_i32(w, m["inliers"])
        _write_pairs_i32(w, m["matches"])
    _write_tracks(w, feature_tracks, sort=True)
    _write_tracks(w, outlier_tracks, sort=True)
    w.u64(len(cameras))
    for fcid in sorted(cameras):
        _write_fcid(w, fcid)
        _write_se3(w, cameras[fcid])
    w.u64(len(landmarks))
    for tid in sorted(landmarks):
        w.i64(int(tid))
        lm = landmarks[tid]
        w.f64(float(lm["inv_depth"]))
        _write_track(w, lm["obs"])
        _write_track(w, lm["outlier_obs"])
    with open(path, "wb") as f:
        f.write(w.getvalue())


def load_corners_cereal(path: str) -> dict:
    """Read a reference ``corners.cereal`` stage cache (sfm.cpp:961-976
    loads a bare Corners archive)."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    out = {_read_fcid(r): _read_keypoints(r) for _ in range(r.u64())}
    if not r.done():
        raise ValueError("trailing bytes in corners cache")
    return out


def save_corners_cereal(path: str, corners: dict) -> None:
    w = _Writer()
    w.u64(len(corners))
    for fcid in sorted(corners):
        _write_fcid(w, fcid)
        _write_keypoints(w, corners[fcid])
    with open(path, "wb") as f:
        f.write(w.getvalue())


def load_matches_cereal(path: str) -> dict:
    """Read a reference ``matches.cereal`` stage cache (sfm.cpp:981-1004)."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    out = {}
    for _ in range(r.u64()):
        key = (_read_fcid(r), _read_fcid(r))
        T = _read_se3(r)
        inliers = _read_pairs_i32(r)
        mm = _read_pairs_i32(r)
        out[key] = {"T_i_j": T, "inliers": inliers, "matches": mm}
    if not r.done():
        raise ValueError("trailing bytes in matches cache")
    return out


def save_matches_cereal(path: str, matches: dict) -> None:
    w = _Writer()
    w.u64(len(matches))
    for key in sorted(matches):
        _write_fcid(w, key[0])
        _write_fcid(w, key[1])
        m = matches[key]
        _write_se3(w, m["T_i_j"])
        _write_pairs_i32(w, m["inliers"])
        _write_pairs_i32(w, m["matches"])
    with open(path, "wb") as f:
        f.write(w.getvalue())


def export_pipeline_map(pipe, path: str) -> None:
    """Write an SfmPipeline's state as a reference-loadable ``map.cereal``.

    Padded corner slots (validity mask) are trimmed; valid rows are a
    prefix (detection fills top-k by score), so FeatureIds referenced by
    matches/tracks/landmarks stay aligned.
    """
    corners = {}
    for fcid, kp in pipe.corners.items():
        n = int(np.asarray(kp["valid"]).sum())
        corners[fcid] = {
            "uv": np.asarray(kp["uv"])[:n],
            "angles": np.asarray(kp["angles"])[:n],
            "descriptors": np.asarray(kp["desc"])[:n],
        }
    matches = {
        key: {"T_i_j": np.asarray(md["T_i_j"]),
              "inliers": np.asarray(md["inliers"], np.int32).reshape(-1, 2),
              "matches": np.asarray(md["matches"], np.int32).reshape(-1, 2)}
        for key, md in pipe.matches.items()
    }
    tracks = {int(t): {k: int(v) for k, v in tr.items()}
              for t, tr in pipe.tracks.items()}
    outliers = {int(t): {k: int(v) for k, v in tr.items()}
                for t, tr in pipe.outlier_tracks.items()}
    cameras = {fcid: np.asarray(T) for fcid, T in pipe.cameras.items()}
    landmarks = {
        int(t): {"inv_depth": float(lm.inv_depth),
                 "obs": {k: int(v) for k, v in lm.obs.items()},
                 "outlier_obs": {k: int(v) for k, v in lm.outlier_obs.items()}}
        for t, lm in pipe.landmarks.items()
    }
    save_map_cereal(path, corners, matches, tracks, outliers, cameras,
                    landmarks)


def load_bow_vocabulary_cereal(path: str):
    """Read a reference BoW vocabulary (bow_voc.h:189-207 schema).

    Returns (k, L, nodes) with nodes a list of dicts
    {id, weight, children (list), parent, descriptor (8,) uint32,
    word_id} — the inputs features/bow.BowVocabulary needs.
    """
    with open(path, "rb") as f:
        r = _Reader(f.read())
    k = r.i32()
    L = r.i32()
    n = r.u64()
    nodes = []
    for _ in range(n):
        nid = r.u32()
        weight = r.f64()
        nc = r.u64()
        children = [r.u32() for _ in range(nc)]
        parent = r.u32()
        desc = _read_bitset256(r)
        word_id = r.u32()
        nodes.append({"id": nid, "weight": weight, "children": children,
                      "parent": parent, "descriptor": desc,
                      "word_id": word_id})
    if not r.done():
        raise ValueError("trailing bytes in vocabulary file")
    return k, L, nodes


def save_bow_vocabulary_cereal(path: str, k: int, L: int, nodes) -> None:
    w = _Writer()
    w.i32(int(k))
    w.i32(int(L))
    w.u64(len(nodes))
    for nd in nodes:
        w.u32(int(nd["id"]))
        w.f64(float(nd["weight"]))
        w.u64(len(nd["children"]))
        for c in nd["children"]:
            w.u32(int(c))
        w.u32(int(nd["parent"]))
        _write_bitset256(w, nd["descriptor"])
        w.u32(int(nd["word_id"]))
    with open(path, "wb") as f:
        f.write(w.getvalue())


# ---------------------------------------------------------------------------
# BoW database inverted index — cereal JSON archive (bow_db.h:99-124).
# Unlike every other artifact, BowDatabase::save/load uses a
# JSONOutputArchive: the payload is one root value ("value0") holding the
# unordered_map as an array of {"key": word, "value": [...]} items, each
# posting a {"first": {"value0": frame_id, "value1": cam_id},
# "second": weight} pair (cereal's generic map / pair / FrameCamId JSON
# forms).  Golden bytes generated with the reference's own archive:
# refbaseline/bow_db_golden.cpp -> refbaseline/artifacts/bow_db_golden.json.


def load_bow_db_json(path: str) -> dict:
    """Read a reference BowDatabase inverted index -> {word: [((frame,
    cam), weight), ...]} (bow_db.h:112-124)."""
    import json

    with open(path) as f:
        doc = json.load(f)
    out: dict = {}
    for item in doc["value0"]:
        word = int(item["key"])
        posts = [
            ((int(p["first"]["value0"]), int(p["first"]["value1"])),
             float(p["second"]))
            for p in item["value"]
        ]
        out.setdefault(word, []).extend(posts)
    return out


def save_bow_db_json(path: str, index: dict) -> None:
    """Write {word: [((frame, cam), weight), ...]} in the reference's
    BowDatabase::save JSON layout (bow_db.h:99-111); 4-space indentation
    matches cereal's rapidjson PrettyWriter output."""
    import json

    doc = {
        "value0": [
            {
                "key": int(word),
                "value": [
                    {
                        "first": {"value0": int(f), "value1": int(c)},
                        "second": float(v),
                    }
                    for (f, c), v in posts
                ],
            }
            for word, posts in index.items()
        ]
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=4)
