"""Binary BoW vocabulary: k-medians Hamming tree, batched descent, dense
tf-idf scoring (port of `orbslam3lib_tpu/models/vocabulary.py`).

Training is the reference's NumPy k-medians, copied (it is the tracker's
fallback when no vocabulary file exists). The descent gathers the k child
centroids of every descriptor at each level and takes the Hamming argmin.
Distances are exact integers, and `argmin` keeps the lowest child on ties
(ties are common at k=10), as `jnp.argmin` does.

L1 score as in DBoW2: s(v, w) = 1 - 0.5 * |v/|v| - w/|w||_1.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

# the vocabulary shipped with the JAX package, named by its place in the
# repository so that the port can load it without importing that package
DEFAULT_VOCAB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "orbslam3lib_tpu", "data", "orb_vocab.npz")


class Vocabulary(NamedTuple):
    """Flat tree: level l has k^(l+1) nodes, indexed parent * k + child.

    centroids: tuple of (k^(l+1), 256) int8 tensors, one per level.
    idf:       (W,) f32 inverse document frequency, W = k**depth.
    """
    centroids: tuple
    idf: torch.Tensor
    k: int
    depth: int

    @property
    def n_words(self) -> int:
        return self.k ** self.depth

    def to(self, device) -> "Vocabulary":
        return self._replace(centroids=tuple(c.to(device) for c in self.centroids),
                             idf=self.idf.to(device))


def train_vocabulary(descriptors: np.ndarray, k: int = 8, depth: int = 4,
                     n_iter: int = 8, seed: int = 0,
                     doc_ids: np.ndarray | None = None) -> Vocabulary:
    """Hierarchical k-medians on (N, 256) 0/1 descriptor bits (host NumPy).

    With `doc_ids` (N,), idf = log(n_docs / (1 + df)) from the training
    corpus (DBoW2's TF_IDF weighting), else 1. Empty or tiny clusters
    replicate the group's first real centroid, so an unused child never
    strictly wins a descent argmin over a populated sibling.
    """
    rng = np.random.default_rng(seed)
    desc = descriptors.astype(np.int8)

    def kmedians(data, k):
        if len(data) == 0:
            return np.zeros((k, data.shape[1] if data.ndim > 1 else 256), np.int8)
        init = data[rng.choice(len(data), min(k, len(data)), replace=False)]
        cents = np.zeros((k, data.shape[1]), np.int8)
        cents[:len(init)] = init
        cents[len(init):] = init[0]          # pad with a real centroid
        for _ in range(n_iter):
            d = (data[:, None, :] != cents[None, :, :]).sum(-1)
            assign = d.argmin(1)
            for c in range(k):
                sel = data[assign == c]
                if len(sel):
                    cents[c] = (sel.mean(0) > 0.5).astype(np.int8)
                else:
                    cents[c] = cents[0]      # dead cluster: mirror a live one
        return cents

    levels = []
    groups = [desc]
    for _ in range(depth):
        cents = np.zeros((len(groups) * k, desc.shape[1]), np.int8)
        next_groups = []
        for gi, g in enumerate(groups):
            c = kmedians(g, k)
            cents[gi * k:(gi + 1) * k] = c
            if len(g):
                assign = (g[:, None, :] != c[None, :, :]).sum(-1).argmin(1)
            else:
                assign = np.zeros(0, np.int64)
            for ci in range(k):
                next_groups.append(g[assign == ci] if len(g) else g)
        levels.append(torch.from_numpy(cents))
        groups = next_groups

    W = k ** depth
    voc = Vocabulary(centroids=tuple(levels),
                     idf=torch.ones(W, dtype=torch.float32), k=k, depth=depth)
    if doc_ids is not None:
        words = word_ids(voc, torch.from_numpy(desc)).numpy()
        n_docs = len(np.unique(doc_ids))
        df = np.zeros(W, np.float64)
        for w in {(int(w), int(d)) for w, d in zip(words, doc_ids)}:
            df[w[0]] += 1.0
        idf = np.log(n_docs / (1.0 + df)).clip(min=0.0) + 1e-3
        voc = voc._replace(idf=torch.from_numpy(idf.astype(np.float32)))
    return voc


def save_vocabulary(voc: Vocabulary, path: str):
    np.savez_compressed(
        path, k=voc.k, depth=voc.depth, idf=voc.idf.cpu().numpy(),
        **{f"level_{i}": c.cpu().numpy() for i, c in enumerate(voc.centroids)})


def load_vocabulary(path: str, device: torch.device | str = "cpu") -> Vocabulary:
    z = np.load(path)
    k, depth = int(z["k"]), int(z["depth"])
    cents = tuple(torch.from_numpy(z[f"level_{i}"]).to(device) for i in range(depth))
    return Vocabulary(centroids=cents, idf=torch.from_numpy(z["idf"]).to(device),
                      k=k, depth=depth)


def _descend(centroid_levels, desc_bits: torch.Tensor, k: int, depth: int):
    """(N, 256) 0/1 -> (N,) int32 word ids in [0, k^depth)."""
    N = desc_bits.shape[0]
    dev = desc_bits.device
    node = torch.zeros(N, dtype=torch.int64, device=dev)
    d = desc_bits.to(torch.float32)
    s_d = d.sum(dim=1)
    children = torch.arange(k, device=dev)
    for lvl in range(depth):
        cand = centroid_levels[lvl][node[:, None] * k + children[None, :]]
        cand = cand.to(torch.float32)                      # (N, k, 256)
        # 0/1 products and sums <= 256 are exact in f32 (TF32 is off)
        ham = cand.sum(dim=2) + s_d[:, None] - 2.0 * torch.einsum("nkc,nc->nk", cand, d)
        node = node * k + torch.argmin(ham, dim=1)
    return node.to(torch.int32)


def word_ids(voc: Vocabulary, desc_bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) 0/1 -> (N,) word ids via batched tree descent."""
    return _descend(voc.centroids, desc_bits, voc.k, voc.depth)


def bow_vector(words: torch.Tensor, valid: torch.Tensor, idf: torch.Tensor,
               n_words: int) -> torch.Tensor:
    """Word ids (N,) + validity -> L1-normalised tf-idf vector (W,)."""
    w = torch.where(valid, words.long(), n_words)
    hist = torch.zeros(n_words + 1, device=words.device).index_add_(
        0, w, torch.ones(w.shape, device=words.device))[:n_words]
    v = hist * idf
    return v / torch.clamp(v.sum(), min=1e-9)


def bow_from_descriptors(voc: Vocabulary, desc_bits, valid):
    return bow_vector(word_ids(voc, desc_bits), valid, voc.idf, voc.n_words)


def l1_scores(bow_db: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score of query q (W,) against a database (K, W) of
    L1-normalised vectors: s = 1 - 0.5 |v - w|_1."""
    return 1.0 - 0.5 * torch.abs(bow_db - q[None, :]).sum(dim=1)
