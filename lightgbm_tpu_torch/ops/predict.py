"""Batch prediction over a forest on the device.

Counterpart of ``lightgbm_tpu/ops/predict.py``: the forest is flattened
into padded per-tree node tables, every row walks all trees of a chunk
at once (one gather per level, a fixed number of levels: the deepest
leaf's depth, known on the host), and leaf values are summed in float64,
per class for a multiclass forest (tree t is class t mod K).  Decisions
follow the JAX package's ``Tree._decide`` (``lightgbm_tpu/models/
tree.py:152-196``): at a numerical node missing type None or Zero treats
NaN as 0, a missing value takes the node's default direction, else
``value <= threshold`` goes left; at a categorical node a value goes left
when it is a non-negative integer whose bit is set in the node's category
bitset (32-bit words, a table of them a forest), so NaN, infinite,
negative and non-integer values, and codes past the bitset, go right.
No kernel: plain tensor ops in float64, as the JAX engine is XLA.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..models.tree import Tree

__all__ = ["FlatForest", "flatten_forest", "predict_raw", "is_sparse"]

_KZERO = 1e-35
_TREES_PER_CHUNK = 64
# the most bytes of float64 rows a sparse input is densified into at once
DENSE_CHUNK_BYTES = 1 << 26


class FlatForest:
    """Padded node tables of T trees (M = max internal nodes, Lm = max
    leaves); a tree with one leaf has its root encoded as leaf 0."""

    def __init__(self, trees: Sequence[Tree], device: torch.device):
        T = len(trees)
        M = max([max(t.num_leaves - 1, 1) for t in trees] + [1])
        Lm = max([max(t.num_leaves, 1) for t in trees] + [1])
        feat = np.zeros((T, M), np.int64)
        thr = np.zeros((T, M), np.float64)
        dtype = np.zeros((T, M), np.int64)
        left = np.full((T, M), -1, np.int64)
        right = np.full((T, M), -1, np.int64)
        value = np.zeros((T, Lm), np.float64)
        root = np.zeros(T, np.int64)
        # categorical nodes: their bitset's first word in ``words`` and its
        # word count (0 at numerical nodes)
        cat_lo = np.zeros((T, M), np.int64)
        cat_nw = np.zeros((T, M), np.int64)
        words: List[int] = []
        depth = 0
        for i, t in enumerate(trees):
            n_in = t.num_leaves - 1
            value[i, :t.num_leaves] = t.leaf_value[:t.num_leaves]
            if n_in <= 0:
                root[i] = -1          # ~0: leaf 0
                continue
            for nd in np.nonzero(t.decision_type[:n_in] & 1)[0]:
                k = int(t.threshold_bin[nd])
                lo, hi = t.cat_boundaries[k], t.cat_boundaries[k + 1]
                cat_lo[i, nd], cat_nw[i, nd] = len(words), hi - lo
                words.extend(int(w) for w in t.cat_threshold[lo:hi])
            feat[i, :n_in] = t.split_feature[:n_in]
            thr[i, :n_in] = t.threshold[:n_in]
            dtype[i, :n_in] = t.decision_type[:n_in]
            left[i, :n_in] = t.left_child[:n_in]
            right[i, :n_in] = t.right_child[:n_in]
            depth = max(depth, int(t.leaf_depth[:t.num_leaves].max()))
        as_t = lambda a: torch.as_tensor(a, device=device)
        self.num_trees = T
        self.depth = depth
        self.feature, self.threshold = as_t(feat), as_t(thr)
        self.decision_type, self.left, self.right = (as_t(dtype), as_t(left),
                                                     as_t(right))
        self.leaf_value, self.root = as_t(value), as_t(root)
        self.cat_lo, self.cat_nw = as_t(cat_lo), as_t(cat_nw)
        self.cat_words = as_t(np.asarray(words or [0], np.int64))


def flatten_forest(trees: List[Tree], device: torch.device) -> FlatForest:
    return FlatForest(trees, device)


def _leaves(ff: FlatForest, lo: int, hi: int, Xt: torch.Tensor
            ) -> torch.Tensor:
    """(hi-lo, N) leaf index of every row in trees [lo, hi)."""
    N = Xt.shape[1]
    node = ff.root[lo:hi, None].expand(hi - lo, N).contiguous()
    feat, thr = ff.feature[lo:hi], ff.threshold[lo:hi]
    dt, lc, rc = ff.decision_type[lo:hi], ff.left[lo:hi], ff.right[lo:hi]
    for _ in range(ff.depth):
        active = node >= 0
        nd = node.clamp(min=0)
        v = torch.gather(Xt, 0, torch.gather(feat, 1, nd))
        t_node = torch.gather(thr, 1, nd)
        d = torch.gather(dt, 1, nd)
        go_cat = _category_left(ff, lo, hi, nd, v)
        mt = (d >> 2) & 3
        default_left = (d & 2) != 0
        nan = torch.isnan(v)
        v = torch.where(nan & (mt != 2), torch.zeros_like(v), v)
        miss = torch.where(mt == 2, nan,
                           (mt == 1) & ((torch.abs(v) <= _KZERO) | nan))
        go_left = torch.where(miss, default_left,
                              ~torch.isnan(v) & (v <= t_node))
        go_left = torch.where((d & 1) != 0, go_cat, go_left)
        nxt = torch.where(go_left, torch.gather(lc, 1, nd),
                          torch.gather(rc, 1, nd))
        node = torch.where(active, nxt, node)
    return ~node


def _category_left(ff: FlatForest, lo: int, hi: int, nd: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Whether each raw value ``v`` goes left at its categorical node ``nd``
    of trees [lo, hi): a finite, non-negative integer code below the
    bitset's ``32 * words``, whose bit is set (false at numerical nodes,
    whose word count is 0)."""
    nw = torch.gather(ff.cat_nw[lo:hi], 1, nd)
    ok = torch.isfinite(v) & (v >= 0) & (v == torch.floor(v)) & \
        (v < (nw * 32).to(v.dtype))
    c = torch.where(ok, v, torch.zeros_like(v)).to(torch.int64)
    at = torch.where(ok, torch.gather(ff.cat_lo[lo:hi], 1, nd) + (c >> 5),
                     torch.zeros_like(c))
    word = ff.cat_words.index_select(0, at.reshape(-1)).reshape(at.shape)
    return ok & (((word >> (c & 31)) & 1) != 0)


def is_sparse(X) -> bool:
    """Whether ``X`` is a scipy sparse matrix (CSR, CSC, COO, ...)."""
    return hasattr(X, "tocsr") and hasattr(X, "nnz")


def predict_raw(ff: FlatForest, X, device: torch.device,
                num_class: int = 1) -> torch.Tensor:
    """(N,) float64 raw scores: the sum of every tree's leaf value; with
    ``num_class`` K > 1, (K, N): class k sums trees k, k + K, ...  ``X``
    is an array or a scipy sparse matrix, densified in chunks of rows of
    at most :data:`DENSE_CHUNK_BYTES` as float64."""
    if is_sparse(X) and X.shape[0]:
        X = X.tocsr()
        step = max(1, DENSE_CHUNK_BYTES // (8 * max(X.shape[1], 1)))
        return torch.cat([predict_raw(ff, X[lo:lo + step].toarray(), device,
                                      num_class)
                          for lo in range(0, X.shape[0], step)], dim=-1)
    Xt = torch.as_tensor(np.asarray(X), device=device).to(
        torch.float64).T.contiguous()
    N = Xt.shape[1]
    out = torch.zeros((num_class, N), dtype=torch.float64, device=device)
    for lo in range(0, ff.num_trees, _TREES_PER_CHUNK):
        hi = min(lo + _TREES_PER_CHUNK, ff.num_trees)
        leaf = _leaves(ff, lo, hi, Xt)
        vals = torch.gather(ff.leaf_value[lo:hi], 1, leaf)
        if num_class == 1:
            out[0] += vals.sum(dim=0)
            continue
        cls = torch.arange(lo, hi, device=device) % num_class
        for k in range(num_class):
            out[k] += vals[cls == k].sum(dim=0)
    return out[0] if num_class == 1 else out
