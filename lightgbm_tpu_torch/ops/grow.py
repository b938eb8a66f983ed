"""Leaf-wise (best-first) tree growth on the device.

Counterpart of ``lightgbm_tpu/ops/grow.py``: the serial learner's
``build_tree_impl`` (:326) with the histogram pool and the
non-speculative loop (:1056-1211), and ``route_rows`` (:1833).  Each of
the ``num_leaves - 1`` steps splits the leaf with the best stored gain:
the rows of the leaf move by the split's goes-left mask (``left_mask[col]``,
the gather ``mask_lookup`` (:289) computes), the smaller child's
histogram comes from one masked pass (kernel H), the larger child's by
parent minus smaller (:1120-1132), and both children's best splits from
one batched scan (kernel S).

The loop is a Python loop of fixed trip count whose every step stays on
the device: the chosen leaf is a device tensor (``argmax`` of the
stored gains), reads go through ``index_select`` with one-element index
tensors and writes through ``index_put_``/``masked_fill`` guarded by the
step's ``valid`` flag, where the JAX loop used ``lax.cond``.  Nothing is
fetched until the tree ends; the records then come back in one copy
(``models/gbdt.py``).  A step after the tree stopped splitting still runs
its passes and writes nothing.
"""
from __future__ import annotations

import dataclasses

import torch

from .histogram import masked_histogram
from .split import NEG_INF, SplitParams, find_best_split, leaf_output

__all__ = ["GrowParams", "build_tree", "route_rows"]


@dataclasses.dataclass(frozen=True)
class GrowParams:
    split: SplitParams
    num_leaves: int
    max_depth: int = -1


def _pick(t: torch.Tensor, i1: torch.Tensor) -> torch.Tensor:
    """``t[i]`` for a one-element index tensor, without a host sync."""
    return t.index_select(0, i1).squeeze(0)


def _put(t: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
         valid: torch.Tensor) -> None:
    """``t[idx] = vals`` where ``valid``; unchanged otherwise."""
    old = t.index_select(0, idx)
    keep = valid.reshape((1,) * old.dim())
    t.index_put_((idx,), torch.where(keep, vals.to(t.dtype), old))


def build_tree(xt: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
               sample_mask: torch.Tensor, feature_mask: torch.Tensor,
               num_bins: torch.Tensor, missing_type: torch.Tensor,
               params: GrowParams) -> dict:
    """Grow one tree.

    xt: (F, N) binned features (uint8/int16); grad/hess/sample_mask:
    (N,) float32; feature_mask: (F,) bool; num_bins/missing_type: (F,)
    int32.  All on one device.  Returns the per-split records (length
    num_leaves-1), the final leaf assignment, per-leaf values and the
    realized leaf count, as device tensors."""
    p = params
    sp = p.split
    L = p.num_leaves
    B = sp.max_bin
    F, N = xt.shape
    dev = xt.device
    f32 = torch.float32
    li_dtype = torch.uint8 if L <= 256 else torch.int32
    ids32 = torch.arange(L, dtype=torch.int32, device=dev)
    ids64 = ids32.to(torch.int64)

    def best_of(hists, stats, depth):
        b = find_best_split(hists.contiguous(), stats.contiguous(), num_bins,
                            missing_type, feature_mask, sp)
        if p.max_depth > 0:
            b["gain"] = torch.where(depth < p.max_depth, b["gain"],
                                    torch.full_like(b["gain"], NEG_INF))
        return b

    leaf_idx = torch.zeros(N, dtype=li_dtype, device=dev)
    root_stats = torch.stack([
        (grad * sample_mask).to(torch.float64).sum(),
        (hess * sample_mask).to(torch.float64).sum(),
        sample_mask.to(torch.float64).sum()]).to(f32)
    root_hist = masked_histogram(xt, grad, hess, sample_mask, leaf_idx,
                                 ids32[0], B)
    root_best = best_of(root_hist[None], root_stats[None],
                        torch.zeros(1, dtype=torch.int32, device=dev))

    def per_leaf(shape, dtype, fill=0):
        return torch.full((L,) + shape, fill, dtype=dtype, device=dev)

    pool = per_leaf((F, B, 3), f32)
    pool[0] = root_hist
    leaf_stats = per_leaf((3,), f32)
    leaf_stats[0] = root_stats
    leaf_depth = per_leaf((), torch.int32)
    best = {
        "gain": per_leaf((), f32, NEG_INF),
        "feature": per_leaf((), torch.int32),
        "threshold": per_leaf((), torch.int32),
        "default_left": per_leaf((), torch.bool, False),
        "left_stats": per_leaf((3,), f32),
        "left_mask": per_leaf((B,), torch.bool, False),
    }
    for k, arr in best.items():
        arr[0] = root_best[k][0]

    S = L - 1

    def per_split(shape, dtype):
        return torch.zeros((S,) + shape, dtype=dtype, device=dev)

    rec = {
        "leaf": per_split((), torch.int32),
        "feature": per_split((), torch.int32),
        "threshold": per_split((), torch.int32),
        "default_left": per_split((), torch.bool),
        "gain": per_split((), f32),
        "left_stats": per_split((3,), f32),
        "right_stats": per_split((3,), f32),
        "left_mask": per_split((B,), torch.bool),
        "valid": per_split((), torch.bool),
    }
    n_leaves = torch.ones((), dtype=torch.int32, device=dev)
    zero3 = torch.zeros(3, dtype=f32, device=dev)

    for t in range(S):
        new = t + 1
        l1 = torch.argmax(best["gain"]).reshape(1)          # (1,) int64
        cand = {k: _pick(v, l1) for k, v in best.items()}
        valid = cand["gain"] > 0

        # row routing: rows of leaf l that go right move to leaf `new`
        col = _pick(xt, cand["feature"].to(torch.int64).reshape(1))
        goes_left = cand["left_mask"][col.to(torch.int32)]
        mine = leaf_idx == _pick(ids32, l1).to(li_dtype)
        leaf_idx = leaf_idx.masked_fill(mine & ~goes_left & valid, new)

        left_stats = cand["left_stats"]
        parent_stats = _pick(leaf_stats, l1)
        right_stats = parent_stats - left_stats
        # subtraction trick: smaller child from one pass, larger = parent
        # minus smaller
        small_is_left = left_stats[2] <= right_stats[2]
        small_id = torch.where(small_is_left, _pick(ids32, l1), ids32[new])
        hist_small = masked_histogram(xt, grad, hess, sample_mask, leaf_idx,
                                      small_id, B)
        hist_large = _pick(pool, l1) - hist_small
        hist_l = torch.where(small_is_left, hist_small, hist_large)
        hist_r = torch.where(small_is_left, hist_large, hist_small)
        depth = _pick(leaf_depth, l1) + 1
        children = best_of(torch.stack([hist_l, hist_r]),
                           torch.stack([left_stats, right_stats]),
                           depth.reshape(1))

        pair = torch.cat([l1, ids64[new].reshape(1)])
        _put(pool, pair, torch.stack([hist_l, hist_r]), valid)
        _put(leaf_stats, pair, torch.stack([left_stats, right_stats]), valid)
        _put(leaf_depth, pair, depth.expand(2), valid)
        for k, arr in best.items():
            _put(arr, pair, children[k], valid)

        rec["leaf"][t] = torch.where(valid, _pick(ids32, l1),
                                     torch.full_like(ids32[0], -1))
        for k in ("feature", "threshold", "default_left", "left_mask"):
            rec[k][t] = cand[k]
        rec["gain"][t] = torch.where(valid, cand["gain"],
                                     torch.zeros_like(cand["gain"]))
        rec["left_stats"][t] = torch.where(valid, left_stats, zero3)
        rec["right_stats"][t] = torch.where(valid, right_stats, zero3)
        rec["valid"][t] = valid
        n_leaves = n_leaves + valid.to(torch.int32)

    leaf_values = leaf_output(leaf_stats[:, 0], leaf_stats[:, 1],
                              sp.lambda_l1, sp.lambda_l2, sp.max_delta_step)
    return {
        **rec,
        "leaf_idx": leaf_idx,
        "leaf_values": leaf_values,
        "leaf_values_final": torch.where(n_leaves > 1, leaf_values,
                                         torch.zeros_like(leaf_values)),
        "leaf_stats": leaf_stats,
        "n_leaves": n_leaves,
    }


def route_rows(xt: torch.Tensor, rec_leaf: torch.Tensor,
               rec_feature: torch.Tensor, rec_left_mask: torch.Tensor,
               rec_valid: torch.Tensor, num_leaves: int) -> torch.Tensor:
    """Replay a tree's split records over a binned matrix -> (N,) int32
    leaf assignment (the device scorer for binned validation sets)."""
    N = xt.shape[1]
    li = torch.zeros(N, dtype=torch.int32, device=xt.device)
    for t in range(num_leaves - 1):
        col = _pick(xt, rec_feature[t].to(torch.int64).reshape(1))
        goes_left = rec_left_mask[t][col.to(torch.int32)]
        move = rec_valid[t] & (li == rec_leaf[t]) & ~goes_left
        li = li.masked_fill(move, t + 1)
    return li
