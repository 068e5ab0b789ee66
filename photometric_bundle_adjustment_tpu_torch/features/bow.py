"""Bag-of-words place recognition: vocabulary tree + inverted-index database.

A copy of ``photometric_bundle_adjustment_tpu/features/bow.py`` (numpy
only); ``SfmPipeline.match_bow`` draws its pair worklist from it.

Re-design of BowVocabulary / BowDatabase (include/visnav/bow_voc.h:57-123,
bow_db.h:49-124): a k-ary tree of 256-bit binary centroids; descriptors
descend the tree by greedy nearest-child (Hamming) to a leaf word; an image
becomes an L1-normalised sparse word vector; queries use the sparse L1
trick  ``score = 2 + sum_shared(|a-b| - |a| - |b|)``  (lower = more
similar) with a top-k partial sort.

The reference only *loads* a prebuilt vocabulary; we also provide
``build_vocabulary`` (hierarchical binary k-means with majority-vote
centroids) so the pipeline is self-contained.  Tree descent is a batched
*vectorised host* computation — all N descriptors step down one tree level
at a time via a padded (nodes, k) children table, one (N, k, 8) XOR-popcount
per level, no per-descriptor or per-node Python loop.  BoW sits on the
host side of the pipeline (it gates which pairs are matched); the per-image
descriptor counts (~1.5k) are far below the size where a device round-trip
pays for itself, so this deliberately stays NumPy.  The inverted index is
host-side bookkeeping.
"""

from __future__ import annotations

import pickle

import numpy as np


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 8) x (M, 8) uint32 -> (N, M) int popcount distances."""
    x = a[:, None, :] ^ b[None, :, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _majority_centroid(desc: np.ndarray) -> np.ndarray:
    """Bitwise majority vote over (N, 8) uint32 descriptors."""
    bits = np.unpackbits(desc.view(np.uint8), axis=-1)  # (N, 256)
    maj = (bits.sum(0) * 2 >= bits.shape[0]).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


class BowVocabulary:
    """k-ary vocabulary tree over 256-bit descriptors."""

    def __init__(self, centroids, children, leaf_word):
        self.centroids = np.asarray(centroids, np.uint32)   # (nodes, 8)
        self.children = children                             # list[list[int]]
        self.leaf_word = np.asarray(leaf_word, np.int32)     # (nodes,) or -1
        self.num_words = int(self.leaf_word.max()) + 1
        # padded (nodes, k) children table for the vectorised descent
        k = max((len(c) for c in children), default=1) or 1
        pad = np.full((len(children), k), -1, np.int64)
        for n, kids in enumerate(children):
            pad[n, : len(kids)] = kids
        self._children_pad = pad
        # tree depth bound: longest root->leaf chain
        depth, frontier = 0, [0]
        while frontier:
            depth += 1
            frontier = [c for n in frontier for c in children[n]]
        self._max_depth = depth

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump(
                {"centroids": self.centroids, "children": self.children,
                 "leaf_word": self.leaf_word}, f,
            )

    @classmethod
    def load(cls, path):
        if path.endswith(".cereal"):
            return cls.load_cereal(path)
        with open(path, "rb") as f:
            d = pickle.load(f)
        return cls(d["centroids"], d["children"], d["leaf_word"])

    @classmethod
    def load_cereal(cls, path):
        """Load the reference's binary-cereal vocabulary
        (bow_voc.h:138-153 / :189-207).  Word ids are recomputed exactly
        as the reference's createWords(): leaves in node order get
        sequential ids (bow_voc.h:211-222) — the persisted word_id field
        is ignored there too."""
        from photometric_bundle_adjustment_tpu_torch.io import cereal_io

        _, _, nodes = cereal_io.load_bow_vocabulary_cereal(path)
        centroids = np.stack([n["descriptor"] for n in nodes])
        children = [[int(c) for c in n["children"]] for n in nodes]
        leaf_word = np.full(len(nodes), -1, np.int32)
        wid = 0
        for i, n in enumerate(nodes):
            if not children[i]:
                leaf_word[i] = wid
                wid += 1
        return cls(centroids, children, leaf_word)

    def word_ids(self, desc: np.ndarray) -> np.ndarray:
        """Map (N, 8)-uint32 descriptors to leaf word ids
        (transformFeatureToWord, bow_voc.h:57-88).

        Vectorised level-synchronous descent: every descriptor advances one
        level per step through the padded children table; descriptors that
        reached a leaf stop (their children row is all -1).
        """
        desc = np.asarray(desc, np.uint32).reshape(-1, 8)
        n = len(desc)
        if n == 0:
            return np.zeros(0, np.int32)
        node = np.zeros(n, np.int64)
        rows = np.arange(n)
        for _ in range(self._max_depth):
            kids = self._children_pad[node]                  # (N, k)
            has_kids = kids[:, 0] >= 0
            cent = self.centroids[np.maximum(kids, 0)]        # (N, k, 8)
            x = cent ^ desc[:, None, :]
            d = np.unpackbits(
                x.view(np.uint8).reshape(n, kids.shape[1], 32), axis=-1
            ).sum(-1)
            d = np.where(kids >= 0, d, 1 << 30)
            nxt = kids[rows, d.argmin(1)]
            node = np.where(has_kids, nxt, node)
        return self.leaf_word[node].astype(np.int32)

    def transform(self, desc: np.ndarray) -> dict:
        """Image -> L1-normalised sparse word vector {word: weight}
        (BowVocabulary::transform, bow_voc.h:90-123)."""
        if len(desc) == 0:
            return {}
        words, counts = np.unique(self.word_ids(desc), return_counts=True)
        total = counts.sum()
        return {int(w): float(c) / total for w, c in zip(words, counts)}


def build_vocabulary(
    descriptors: np.ndarray, k: int = 10, levels: int = 3, seed: int = 0
) -> BowVocabulary:
    """Hierarchical binary k-means on (N, 8)-uint32 descriptors."""
    rng = np.random.default_rng(seed)
    desc = np.asarray(descriptors, np.uint32).reshape(-1, 8)

    centroids = [np.zeros(8, np.uint32)]  # root placeholder
    children: list[list[int]] = [[]]
    leaf_word = [-1]
    next_word = [0]

    def split(node: int, subset: np.ndarray, depth: int):
        if depth >= levels or len(subset) <= k:
            leaf_word[node] = next_word[0]
            next_word[0] += 1
            return
        kk = min(k, len(subset))
        centers = subset[rng.choice(len(subset), kk, replace=False)]
        for _ in range(8):  # k-means iterations
            assign = _hamming_np(subset, centers).argmin(1)
            new_centers = []
            for c in range(kk):
                grp = subset[assign == c]
                new_centers.append(
                    _majority_centroid(grp) if len(grp) else centers[c]
                )
            centers = np.stack(new_centers)
        assign = _hamming_np(subset, centers).argmin(1)
        for c in range(kk):
            child = len(centroids)
            centroids.append(centers[c])
            children.append([])
            leaf_word.append(-1)
            children[node].append(child)
            grp = subset[assign == c]
            if len(grp):
                split(child, grp, depth + 1)
            else:
                leaf_word[child] = next_word[0]
                next_word[0] += 1

    split(0, desc, 0)
    return BowVocabulary(np.stack(centroids), children, leaf_word)


class BowDatabase:
    """Inverted index word -> [(image, weight)] with the sparse-L1 scoring
    trick (BowDatabase::{insert, query}, bow_db.h:49-124)."""

    def __init__(self, num_words: int):
        self.num_words = int(num_words)
        self.index: dict = {}

    def clear(self):
        self.index = {}

    def insert(self, fcid, bow_vector: dict):
        for w, v in bow_vector.items():
            if not 0 <= w < self.num_words:
                raise ValueError(
                    f"word id {w} outside vocabulary of {self.num_words} words"
                )
            self.index.setdefault(w, []).append((fcid, v))

    def query(self, bow_vector: dict, num_results: int):
        """Returns [(fcid, score)] sorted ascending (smaller L1 distance is
        more similar), top num_results."""
        scores: dict = {}
        for w, a in bow_vector.items():
            for fcid, b in self.index.get(w, []):
                scores[fcid] = scores.get(fcid, 0.0) + abs(a - b) - abs(a) - abs(b)
        ranked = sorted(scores.items(), key=lambda kv: kv[1])[:num_results]
        return [(fcid, 2.0 + s) for fcid, s in ranked]

    def save(self, path: str):
        """Persist the inverted index in the reference's cereal-JSON
        layout (BowDatabase::save, bow_db.h:99-111)."""
        from photometric_bundle_adjustment_tpu_torch.io import cereal_io

        cereal_io.save_bow_db_json(path, self.index)

    def load(self, path: str):
        """Merge a saved inverted index into this database
        (BowDatabase::load, bow_db.h:112-124 — entries append to any
        already-inserted postings, as in the reference)."""
        from photometric_bundle_adjustment_tpu_torch.io import cereal_io

        for w, posts in cereal_io.load_bow_db_json(path).items():
            self.index.setdefault(w, []).extend(posts)
