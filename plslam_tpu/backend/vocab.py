"""Binary bag-of-words place recognition (DBoW2 equivalent, on-device).

Behavioral spec: reference ``3rdparty/DBoW2`` — TemplatedVocabulary
transform/score over 256-bit ORB descriptors (hierarchical k-means tree,
L1 scoring, ScoringObject.cpp) and the conf_matrix rows built per keyframe
(mapHandler.cpp insertKFBowVector* :4118-4239).

Design: the vocabulary is a fixed (branching k, depth d) tree
stored as one packed descriptor array per level; transform() descends the
tree for all N descriptors at once (each step is a batched Hamming argmin
over k children = popcount matmul); BoW vectors are dense (k^d,) L1-
normalized tf vectors; scores against the whole keyframe database are one
batched reduction.

Training uses binary k-means (majority-bit centroids) — the reference ships
a pre-trained vocabulary file; here the vocabulary is trained online from
accumulated keyframe descriptors (or offline from any descriptor corpus).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.descriptors import hamming_distance_matrix, pack_bits, unpack_bits


class Vocabulary(NamedTuple):
    """Hierarchical binary vocabulary; level l holds k^(l+1) node descriptors
    (children of level l-1 nodes, contiguous blocks of k)."""

    levels: tuple[jax.Array, ...]  # each (k^(l+1), 8) uint32
    k: int
    depth: int
    word_weight: jax.Array | None = None  # (k^depth,) idf weights (DBoW2
    #                                       TF_IDF); None = uniform tf

    @property
    def num_words(self) -> int:
        return self.k ** self.depth


def _majority_centroid(bits: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """Binary k-means centroid: per-bit weighted majority."""
    w = weights[:, None]
    frac = (bits * w).sum(0) / max(w.sum(), 1e-9)
    return (frac >= 0.5).astype(np.int8)


def train_vocabulary(descriptors: np.ndarray, k: int = 10, depth: int = 3,
                     iters: int = 8, seed: int = 0) -> Vocabulary:
    """Host-side hierarchical binary k-means (training is offline; transform
    and scoring are the on-device hot path)."""
    rng = np.random.default_rng(seed)
    desc = np.asarray(descriptors, dtype=np.uint32)
    bits = np.unpackbits(desc.view(np.uint8), axis=-1, bitorder="little")

    def kmeans(sub: np.ndarray) -> np.ndarray:
        n = len(sub)
        if n == 0:
            return np.zeros((k, 256), np.int8)
        init = sub[rng.choice(n, size=min(k, n), replace=False)]
        cents = np.zeros((k, 256), np.int8)
        cents[: len(init)] = init
        if len(init) < k:  # duplicate-pad
            cents[len(init):] = init[rng.integers(0, len(init), k - len(init))]
        for _ in range(iters):
            d = (sub[:, None, :] != cents[None, :, :]).sum(-1)
            assign = d.argmin(1)
            for c in range(k):
                sel = sub[assign == c]
                if len(sel):
                    cents[c] = _majority_centroid(sel, np.ones(len(sel)))
        return cents

    levels = []
    # level 0: k clusters of everything; level l: k children per parent
    parents = [bits]
    for l in range(depth):
        cents_l = []
        next_parents = []
        for sub in parents:
            cents = kmeans(sub)
            cents_l.append(cents)
            if l + 1 < depth:
                if len(sub):
                    d = (sub[:, None, :] != cents[None, :, :]).sum(-1)
                    assign = d.argmin(1)
                else:
                    assign = np.zeros(0, np.int64)
                for c in range(k):
                    next_parents.append(sub[assign == c] if len(sub) else sub)
        cents_l = np.concatenate(cents_l, axis=0)  # (k^(l+1), 256)
        packed = np.asarray(
            jax.device_get(pack_bits(jnp.asarray(cents_l, jnp.uint8))))
        levels.append(jnp.asarray(packed, jnp.uint32))
        parents = next_parents
    return Vocabulary(levels=tuple(levels), k=k, depth=depth)


def transform(voc: Vocabulary, desc: jax.Array, valid: jax.Array) -> jax.Array:
    """Descriptors (N, 8) -> dense L1-normalized BoW vector (k^depth,).

    Tree descent, all descriptors in parallel: at each level, gather each
    descriptor's k candidate children and take the Hamming argmin.
    """
    n = desc.shape[0]
    k = voc.k
    node = jnp.zeros((n,), jnp.int32)  # current node id within its level
    for l in range(voc.depth):
        level_desc = voc.levels[l]  # (k^(l+1), 8)
        cand_idx = node[:, None] * k + jnp.arange(k, dtype=jnp.int32)[None, :]
        cand = level_desc[cand_idx]  # (N, k, 8)
        x = jax.lax.population_count(desc[:, None, :] ^ cand)
        d = jnp.sum(x.astype(jnp.int32), axis=-1)  # (N, k)
        node = (node * k + jnp.argmin(d, axis=-1).astype(jnp.int32))
    w = voc.num_words
    counts = jnp.zeros((w,), desc.dtype if desc.dtype.kind == "f" else jnp.float32)
    counts = counts.at[node].add(jnp.where(valid, 1.0, 0.0))
    if voc.word_weight is not None:
        counts = counts * voc.word_weight  # tf-idf (TemplatedVocabulary
        #                                    transform, TF_IDF weighting)
    total = jnp.sum(counts)
    return counts / jnp.maximum(total, 1e-9)


def l1_score(v1: jax.Array, v2: jax.Array) -> jax.Array:
    """DBoW2 L1 score in [0, 1]: 1 - 0.5 * || v1 - v2 ||_1 for L1-normalized
    vectors (ScoringObject.cpp L1Scoring).  Broadcasts: (..., W) x (..., W).
    """
    return 1.0 - 0.5 * jnp.sum(jnp.abs(v1 - v2), axis=-1)


def score_against_database(v: jax.Array, db: jax.Array, db_valid: jax.Array) -> jax.Array:
    """One BoW vector against (D, W) database -> (D,) scores; invalid rows
    get -1 (the conf_matrix row of insertKFBowVector)."""
    s = l1_score(v[None, :], db)
    return jnp.where(db_valid, s, -1.0)


# ---------------------------------------------------------------------------
# DBoW2 vocabulary file interchange
# ---------------------------------------------------------------------------
#
# The reference loads pre-trained DBoW2 vocabularies (SlamConfig
# vocabulary_p / vocabulary_l; TemplatedVocabulary::save writes an OpenCV
# YAML with k, L, scoringType, weightingType, a nodes list of
# {nodeId, parentId, weight, descriptor-as-32-bytes} and a words list,
# TemplatedVocabulary.h:1341-1431).  These functions read/write that
# format so a user's existing vocabulary files work unchanged.  DBoW2
# trees may be non-uniform (clusters with < k children end early); shallow
# leaves are lowered to full depth by chaining duplicate descriptors, and
# missing child slots are padded with a duplicate sibling placed after the
# real ones (argmin ties resolve to the real child).

import gzip as _gzip
import re as _re


def _open_vocab(path: str, mode: str):
    if path.endswith(".gz"):
        return _gzip.open(path, mode + "t")
    return open(path, mode)


_NODE_RE = _re.compile(
    r"nodeId:\s*(\d+),\s*parentId:\s*(\d+),\s*weight:"
    r"\s*([0-9.eE+-]+),\s*descriptor:\s*\"?([0-9 ]+)")


def load_dbow2_vocabulary(path: str) -> Vocabulary:
    """Parse a DBoW2 OpenCV-YAML vocabulary (.yml / .yml.gz) into the
    fixed-shape level representation used by transform()."""
    k = depth = None
    nodes = {}        # id -> (parent, weight, desc_bytes)
    children = {0: []}
    with _open_vocab(path, "r") as f:
        for line in f:
            mk = _re.match(r"^\s*k:\s*(\d+)\s*$", line)
            if k is None and mk:
                k = int(mk.group(1))
                continue
            ml = _re.match(r"^\s*L:\s*(\d+)\s*$", line)
            if depth is None and ml:
                depth = int(ml.group(1))
                continue
            m = _NODE_RE.search(line)
            if m:
                nid, pid = int(m.group(1)), int(m.group(2))
                w = float(m.group(3))
                dbytes = np.asarray([int(x) for x in m.group(4).split()],
                                    np.uint8)
                nodes[nid] = (pid, w, dbytes)
                children.setdefault(pid, []).append(nid)
                children.setdefault(nid, [])
    if k is None or depth is None or not nodes:
        raise ValueError(f"not a DBoW2 vocabulary file: {path}")

    def packed(dbytes: np.ndarray) -> np.ndarray:
        bits = np.unpackbits(dbytes, bitorder="little")[:256]
        return np.asarray(jax.device_get(
            pack_bits(jnp.asarray(bits[None], jnp.uint8))))[0]

    levels = [np.zeros((k ** (l + 1), 8), np.uint32) for l in range(depth)]
    weights = np.zeros(k ** depth, np.float32)

    # BFS with explicit position assignment; shallow leaves are chained
    # down ((node, level-position, carried) entries)
    frontier = [(0, 0)]
    for l in range(depth):
        nxt = []
        for nid, pos in frontier:
            ch = children.get(nid, [])
            if not ch and nid != 0:
                ch = [nid]  # lower a shallow leaf by self-chaining
            ch = ch[:k]
            pad = ch + [ch[-1]] * (k - len(ch)) if ch else [nid] * k
            for j, cid in enumerate(pad):
                _, w, dbytes = nodes.get(cid, nodes.get(nid))
                levels[l][pos * k + j] = packed(dbytes)
                if l == depth - 1 and j < max(len(ch), 1):
                    weights[pos * k + j] = w
                nxt.append((cid, pos * k + j)) if j < max(len(ch), 1) else None
        frontier = nxt

    wmax = weights.max()
    if wmax <= 0:
        word_weight = None
    else:
        word_weight = jnp.asarray(weights, jnp.float32)
    return Vocabulary(levels=tuple(jnp.asarray(lv) for lv in levels),
                      k=k, depth=depth, word_weight=word_weight)


def save_dbow2_vocabulary(path: str, voc: Vocabulary,
                          name: str = "vocabulary") -> None:
    """Write the vocabulary in DBoW2's OpenCV-YAML text layout (loadable
    by the reference's TemplatedVocabulary::load)."""
    k, depth = voc.k, voc.depth
    ww = (np.asarray(voc.word_weight) if voc.word_weight is not None
          else np.ones(voc.num_words, np.float32))
    lines = ["%YAML:1.0", "---", f"{name}:", f"   k: {k}", f"   L: {depth}",
             "   scoringType: 0", "   weightingType: 0", "   nodes:"]
    next_id = 1
    ids = []  # per level: position -> nodeId
    for l in range(depth):
        lv = np.asarray(jax.device_get(voc.levels[l]))
        n = lv.shape[0]
        lvl_ids = np.arange(next_id, next_id + n)
        next_id += n
        ids.append(lvl_ids)
        bits = np.asarray(jax.device_get(unpack_bits(jnp.asarray(lv))))
        dbytes = np.packbits(bits.astype(np.uint8), axis=-1,
                             bitorder="little")
        for p in range(n):
            pid = 0 if l == 0 else int(ids[l - 1][p // k])
            w = float(ww[p]) if l == depth - 1 else 0.0
            dstr = " ".join(str(int(b)) for b in dbytes[p])
            lines.append(
                f"      - {{ nodeId:{int(lvl_ids[p])}, parentId:{pid}, "
                f"weight:{w:.6g}, descriptor:\"{dstr}\" }}")
    lines.append("   words:")
    for wpos in range(voc.num_words):
        lines.append(f"      - {{ wordId:{wpos}, "
                     f"nodeId:{int(ids[-1][wpos])} }}")
    with _open_vocab(path, "w") as f:
        f.write("\n".join(lines) + "\n")
