"""Leaf-wise (best-first) tree growth on the device.

Counterpart of ``lightgbm_tpu/ops/grow.py``: the serial learner's
``build_tree_impl`` (:326) and ``route_rows`` (:1833).  Two loops share
the histogram pool (per-leaf histograms for the subtraction trick, where
the larger child is parent minus smaller, :1120-1132):

- the non-speculative loop (:1056-1211): each of the ``num_leaves - 1``
  steps splits the leaf with the best stored gain, moves its rows by the
  split's goes-left mask, builds the smaller child's histogram in one
  masked pass (kernel H) and scans both children in one batched pass
  (kernel S);
- wave growth (``GrowParams.wave``, :1213-1584): each step applies the
  top-W splittable leaves at once.  One routed pass (kernel R) moves the
  rows of all W leaves and builds the W smaller children's histograms,
  and one kernel-S launch scans all 2W children.  The split chosen for a
  leaf is the same greedy best; only the order is bulk-synchronous.  The
  root comes from the batched pass with one live lane (kernel M, :920).
- coarse-to-fine wave growth (``GrowParams.refine_shift``, ``wave_body_c2f``
  :1596-1724): the pool and the routed pass are coarse (fine bins
  collapsed ``2^shift``-to-1, the missing bin in a reserved last slot);
  each child then gets a window of ``2 << shift`` fine bins around its
  best coarse boundary, filled by one or two leaf-vector-routed windowed
  passes (kernel V-lanes), and the split search scans the coarse
  boundaries and the window's thresholds (``ops/split.py``
  ``find_best_split_c2f``, plain tensor code as in the JAX package).  The
  root is a coarse pass and one windowed pass (kernels M and V); no pass
  runs at full resolution.

With ``GrowParams.quantize`` the gradients are stochastically rounded to
integers in ``[-quantize, quantize]`` first (:409-459); histograms sum the
integers exactly and are dequantized by ``hist_scale``, and the leaf
values are renewed at the end from full-precision per-leaf sums
(kernel Q, :1771-1798).

Each loop stays on the device: reads go through ``index_select``, writes
through ``index_put_``/``index_copy_``, and invalid steps or lanes write
nothing that is read (the non-speculative loop masks by ``valid`` where
the JAX loop used ``lax.cond``; the wave loop sends an invalid lane's
writes to a dummy row, where JAX scatters drop them with
``mode="drop"``).  The wave loop reads one flag per wave to stop, as the
JAX ``while_loop`` tests ``wave_cond``; nothing else is fetched until
the tree ends.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils import prng
from .histogram import (lanes_window_histogram, leaf_stats,
                        masked_histogram, multi_histogram, routed_histogram,
                        window_histogram)
from .split import (NEG_INF, SplitParams, choose_window, depth_limit,
                    find_best_split, find_best_split_c2f, fma32, leaf_output)

__all__ = ["GrowParams", "build_tree", "quantize_gradients", "row_uniform",
           "route_rows"]

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class GrowParams:
    """Growth parameters (the serial subset of the JAX package's
    ``GrowParams``, ``lightgbm_tpu/ops/grow.py:99-191``).

    ``quantize`` > 0: gradients become integers in ``[-quantize,
    quantize]``.  ``wave`` with ``speculate`` = W > 1: wave growth with W
    lanes.  ``two_col``: quantized wave passes sum grad and hess only and
    the count channel is a hess copy (``split.counts_proxy`` must be
    set); legal only under the driver's gate (min_data_in_leaf <= 1,
    min_sum_hessian_in_leaf > 0).  ``refine_shift`` > 0 (wave growth
    only): coarse-to-fine refinement at that shift."""
    split: SplitParams
    num_leaves: int
    max_depth: int = -1
    quantize: int = 0
    two_col: bool = False
    wave: bool = False
    speculate: int = 0
    refine_shift: int = 0


def _pick(t: torch.Tensor, i1: torch.Tensor) -> torch.Tensor:
    """``t[i]`` for a one-element index tensor, without a host sync."""
    return t.index_select(0, i1).squeeze(0)


def _put(t: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
         valid: torch.Tensor) -> None:
    """``t[idx] = vals`` where ``valid``; unchanged otherwise."""
    old = t.index_select(0, idx)
    keep = valid.reshape((1,) * old.dim())
    t.index_put_((idx,), torch.where(keep, vals.to(t.dtype), old))


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2^32`` for int64 ``h < 2^32`` without overflowing
    int64: the 32-bit constant is split into 16-bit halves."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def row_uniform(n: int, word: int, device) -> torch.Tensor:
    """Per-row rounding noise in [0, 1): the JAX package's
    ``_row_uniform`` (:441-452), a Wang-style mix of (row index, key word)
    in uint32 arithmetic, done here in int64 and masked, since PyTorch
    has no uint32 multiply on every backend."""
    h = torch.arange(n, dtype=torch.int64, device=device) ^ (word & _M32)
    h = _mul32(h ^ (h >> 16), 0x7feb352d)
    h = _mul32(h ^ (h >> 15), 0x846ca68b)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


def quantize_gradients(grad: torch.Tensor, hess: torch.Tensor,
                       mask: torch.Tensor, quantize: int, two_col: bool,
                       key) -> tuple:
    """Stochastic rounding of the masked gradients (:409-459) ->
    (grad_q, hess_q, hist_scale).  ``key`` is the tree's (2,) uint32
    Threefry key; ``hist_scale`` (3,) dequantizes a histogram (the count
    channel takes the hess scale under ``two_col``, where it is a hess
    copy).  The scales are ``max|v| * f32(1 / quantize)``: the reference's
    compile turns its division by the constant into that product.  The
    divisions by a scale are IEEE float32, so the card, the CPU and the
    JAX package round to the same integers."""
    kg, kh = prng.split(key)
    inv_q = (torch.ones((), dtype=torch.float32) / quantize).item()
    g_w = grad * mask
    h_w = hess * mask
    sg = torch.clamp(g_w.abs().max(), min=1e-30) * inv_q
    sh = torch.clamp(h_w.abs().max(), min=1e-30) * inv_q
    n, dev = grad.shape[0], grad.device
    gq = torch.floor(g_w / sg + row_uniform(n, prng.key_word(kg), dev))
    hq = torch.floor(h_w / sh + row_uniform(n, prng.key_word(kh), dev))
    scale = torch.stack([sg, sh, sh if two_col else torch.ones_like(sh)])
    return gq, hq, scale


def build_tree(xt: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
               sample_mask: torch.Tensor, feature_mask: torch.Tensor,
               num_bins: torch.Tensor, missing_type: torch.Tensor,
               params: GrowParams, quant_key=None) -> dict:
    """Grow one tree.

    xt: (F, N) binned features (uint8/int16); grad/hess/sample_mask:
    (N,) float32 (the mask 0/1 under quantization); feature_mask: (F,)
    bool; num_bins/missing_type: (F,) int32.  All on one device.
    ``quant_key``: the tree's (2,) uint32 key for quantization
    (``PRNGKey(0)`` when None, as in the JAX package).  Returns the
    per-split records (length num_leaves-1), the final leaf assignment,
    per-leaf values and the realized leaf count, as device tensors; with
    quantization also ``leaf_stats_exact``, the full-precision per-leaf
    sums the values were renewed from."""
    p = params
    sp = p.split
    L = p.num_leaves
    grad_raw, hess_raw = grad, hess
    hist_scale = None
    if p.quantize:
        key = prng.prng_key(0) if quant_key is None else quant_key
        grad, hess, hist_scale = quantize_gradients(
            grad, hess, sample_mask, p.quantize, p.two_col, key)
    li_dtype = torch.uint8 if L <= 256 else torch.int32
    if p.wave and p.speculate > 1:
        st = _grow_wave(xt, grad, hess, sample_mask, feature_mask, num_bins,
                        missing_type, p, hist_scale, li_dtype)
    else:
        st = _grow_serial(xt, grad, hess, sample_mask, feature_mask,
                          num_bins, missing_type, p, hist_scale, li_dtype)
    leaf_stats_ = st.pop("leaf_stats")[:L]
    leaf_values = leaf_output(leaf_stats_[:, 0], leaf_stats_[:, 1],
                              sp.lambda_l1, sp.lambda_l2, sp.max_delta_step)
    final = leaf_values
    if p.quantize:
        # leaf-output renewal from full-precision sums
        # (RenewIntGradTreeOutput) keyed by the final leaf assignment
        ex = leaf_stats(st["leaf_idx"], grad_raw, hess_raw, sample_mask, L)
        st["leaf_stats_exact"] = ex
        final = torch.where(ex[:, 2] > 0,
                            leaf_output(ex[:, 0], ex[:, 1], sp.lambda_l1,
                                        sp.lambda_l2, sp.max_delta_step),
                            leaf_values)
    n_leaves = st["n_leaves"]
    return {
        **st,
        "leaf_values": leaf_values,
        "leaf_values_final": torch.where(n_leaves > 1, final,
                                         torch.zeros_like(final)),
        "leaf_stats": leaf_stats_,
    }


def _best_splits(hists, stats, depth, num_bins, missing_type, feature_mask,
                 p: GrowParams) -> dict:
    """Best split of each of a batch of leaves, no split where the children
    would pass ``max_depth``: one kernel-S launch on the card, which
    applies the depth limit itself."""
    return find_best_split(hists.contiguous(), stats.contiguous(), num_bins,
                           missing_type, feature_mask, p.split, depth,
                           p.max_depth)


def larger_child(parent: torch.Tensor, raw_small: torch.Tensor,
                 hist_scale) -> torch.Tensor:
    """The subtraction trick: parent minus the smaller child.  A quantized
    child is dequantized inside the subtraction, ``parent - raw * scale``
    with one rounding (a fused multiply-add), as the reference's compiled
    loop computes it; the pool then holds the reference's values bit for
    bit."""
    if hist_scale is None:
        return parent - raw_small
    return fma32(-raw_small, hist_scale.expand_as(raw_small), parent)


def _root_stats(grad, hess, mask, two_col, hist_scale):
    """[sum g*m, sum h*m, count] in float64, rounded once; the count is
    the hess sum under ``two_col``; dequantized by ``hist_scale``."""
    gm = (grad * mask).to(torch.float64).sum()
    hm = (hess * mask).to(torch.float64).sum()
    cnt = hm if two_col else mask.to(torch.float64).sum()
    stats = torch.stack([gm, hm, cnt]).to(torch.float32)
    return stats if hist_scale is None else stats * hist_scale


def _grow_serial(xt, grad, hess, sample_mask, feature_mask, num_bins,
                 missing_type, p, hist_scale, li_dtype) -> dict:
    """The non-speculative best-first loop (:1056-1211)."""
    sp = p.split
    L = p.num_leaves
    B = sp.max_bin
    F, N = xt.shape
    dev = xt.device
    f32 = torch.float32
    ids32 = torch.arange(L, dtype=torch.int32, device=dev)
    ids64 = ids32.to(torch.int64)

    def best_of(hists, stats, depth):
        return _best_splits(hists, stats, depth, num_bins, missing_type,
                            feature_mask, p)

    def masked_hist(leaf_idx, leaf_id):
        """(raw, dequantized) histogram of one leaf."""
        h = masked_histogram(xt, grad, hess, sample_mask, leaf_idx, leaf_id,
                             B)
        return h, (h if hist_scale is None else h * hist_scale)

    leaf_idx = torch.zeros(N, dtype=li_dtype, device=dev)
    root_stats = _root_stats(grad, hess, sample_mask, False, hist_scale)
    root_hist = masked_hist(leaf_idx, ids32[0])[1]
    root_best = best_of(root_hist[None], root_stats[None],
                        torch.zeros(1, dtype=torch.int32, device=dev))

    def per_leaf(shape, dtype, fill=0):
        return torch.full((L,) + shape, fill, dtype=dtype, device=dev)

    pool = per_leaf((F, B, 3), f32)
    pool[0] = root_hist
    leaf_stats_ = per_leaf((3,), f32)
    leaf_stats_[0] = root_stats
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
    rec = _records(S, B, dev)
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
        parent_stats = _pick(leaf_stats_, l1)
        right_stats = parent_stats - left_stats
        # subtraction trick: smaller child from one pass, larger = parent
        # minus smaller
        small_is_left = left_stats[2] <= right_stats[2]
        small_id = torch.where(small_is_left, _pick(ids32, l1), ids32[new])
        raw_small, hist_small = masked_hist(leaf_idx, small_id)
        hist_large = larger_child(_pick(pool, l1), raw_small, hist_scale)
        hist_l = torch.where(small_is_left, hist_small, hist_large)
        hist_r = torch.where(small_is_left, hist_large, hist_small)
        depth = _pick(leaf_depth, l1) + 1
        children = best_of(torch.stack([hist_l, hist_r]),
                           torch.stack([left_stats, right_stats]),
                           depth.reshape(1))

        pair = torch.cat([l1, ids64[new].reshape(1)])
        _put(pool, pair, torch.stack([hist_l, hist_r]), valid)
        _put(leaf_stats_, pair, torch.stack([left_stats, right_stats]), valid)
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

    return {**rec, "leaf_idx": leaf_idx, "leaf_stats": leaf_stats_,
            "n_leaves": n_leaves}


def _records(S: int, B: int, dev) -> dict:
    def per_split(shape, dtype):
        return torch.zeros((S,) + shape, dtype=dtype, device=dev)

    return {
        "leaf": per_split((), torch.int32),
        "feature": per_split((), torch.int32),
        "threshold": per_split((), torch.int32),
        "default_left": per_split((), torch.bool),
        "gain": per_split((), torch.float32),
        "left_stats": per_split((3,), torch.float32),
        "right_stats": per_split((3,), torch.float32),
        "left_mask": per_split((B,), torch.bool),
        "valid": per_split((), torch.bool),
    }


def _value_operand(grad, hess, mask, p: GrowParams) -> torch.Tensor:
    """(N, 2|3) value operand of the batched passes: int8 for quantized
    values within int8 (1 byte an entry, exact), float32 otherwise."""
    cols = [grad * mask, hess * mask] + ([] if p.two_col else [mask])
    vals = torch.stack(cols, dim=-1)
    if 0 < p.quantize <= 127:
        vals = vals.to(torch.int8)
    return vals.contiguous()


def _grow_wave(xt, grad, hess, sample_mask, feature_mask, num_bins,
               missing_type, p, hist_scale, li_dtype) -> dict:
    """Wave growth: ``wave_body`` / ``wave_body_c2f`` and ``commit_wave``
    (:1293-1339, :1432-1724) under ``wave_cond`` (:1221-1223)."""
    sp = p.split
    L = p.num_leaves
    B = sp.max_bin
    W = min(p.speculate, L)
    F, N = xt.shape
    dev = xt.device
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    kvals = _value_operand(grad, hess, sample_mask, p)
    miss_bin = torch.where(missing_type != 0, num_bins - 1,
                           torch.full_like(num_bins, -1)).to(i32) \
        if sp.any_missing else None
    leaf_bound = 256 if li_dtype == torch.uint8 else L + 1
    shift = p.refine_shift
    if shift:
        # the last coarse slot is reserved for the missing bin, which
        # value bins (at most B - 2) never reach (:696-706)
        Bp = ((B - 1) >> shift) + 1 + int(sp.any_missing)
        R = 2 << shift               # two coarse bins at fine resolution
    else:
        Bp = B

    def dequant(h):
        return h if hist_scale is None else h * hist_scale

    def scan(hists, stats, depth):
        return _best_splits(hists, stats, depth, num_bins, missing_type,
                            feature_mask, p)

    def scan_c2f(coarse, win, lo, stats, depth):
        b = find_best_split_c2f(coarse, win, lo, stats, num_bins,
                                missing_type, feature_mask, sp, shift)
        return depth_limit(b, depth, p.max_depth)

    def window(coarse, stats):
        return choose_window(coarse, stats, num_bins, missing_type, sp, shift)

    leaf_idx = torch.zeros(N, dtype=li_dtype, device=dev)
    root_stats = _root_stats(grad, hess, sample_mask, p.two_col, hist_scale)
    zero1 = torch.zeros(1, dtype=i32, device=dev)
    sel0 = torch.zeros(N, dtype=torch.int8, device=dev)
    # the batched pass with one live lane: coarse then windowed under
    # c2f (:908-919), where no pass runs at full resolution
    root_hist = dequant(multi_histogram(xt, kvals, sel0, Bp, 1, p.two_col,
                                        shift, miss_bin))
    if shift:
        lo0 = window(root_hist, root_stats[None])
        root_win = dequant(window_histogram(xt, kvals, sel0, lo0, R, 1,
                                            p.two_col, miss_bin))
        root_best = scan_c2f(root_hist, root_win, lo0, root_stats[None],
                             zero1)
    else:
        root_best = scan(root_hist, root_stats[None], zero1)

    # per-leaf state with a dummy row L: the target of invalid lanes
    def per_leaf(shape, dtype, fill=0):
        return torch.full((L + 1,) + shape, fill, dtype=dtype, device=dev)

    pool = per_leaf((F, Bp, 3), f32)     # coarse under c2f (:973-985)
    pool[0] = root_hist[0]
    leaf_stats_ = per_leaf((3,), f32)
    leaf_stats_[0] = root_stats
    leaf_depth = per_leaf((), i32)
    best = {
        "gain": per_leaf((), f32, NEG_INF),
        "feature": per_leaf((), i32),
        "threshold": per_leaf((), i32),
        "default_left": per_leaf((), torch.bool, False),
        "left_stats": per_leaf((3,), f32),
        "left_mask": per_leaf((B,), torch.bool, False),
    }
    for k, arr in best.items():
        arr[0] = root_best[k][0]
    rec = _records(L, B, dev)          # slot L-1 is the dummy record
    n_leaves = torch.ones((), dtype=i32, device=dev)
    w_ar = torch.arange(W, dtype=i64, device=dev)
    n_waves = 0

    while True:
        t0 = n_leaves.to(i64) - 1          # next free split-record slot
        remaining = (L - 1) - t0
        # top_k order: descending, ties to the lower leaf id
        srt = torch.sort(best["gain"][:L], descending=True, stable=True)
        topg, ids = srt.values[:W], srt.indices[:W]
        # valid lanes form a prefix, so record slots stay contiguous
        valid_w = (topg > 0) & (w_ar < remaining)
        # the one read of the wave: wave_cond and the live lane count
        flags = torch.stack([n_leaves.to(f32), best["gain"][:L].max(),
                             valid_w.sum().to(f32)]).tolist()
        if not (flags[0] < L and flags[1] > 0):
            break
        live = int(flags[2])
        n_waves += 1
        dummy = torch.full_like(ids, L)
        ids_leaf = torch.where(valid_w, ids, dummy)
        t_j = t0 + w_ar
        ids_rec = torch.where(valid_w, t_j, torch.full_like(t_j, L - 1))
        new_ids = t_j + 1
        new_leaf = torch.where(valid_w, new_ids, dummy)

        cw = {k: v.index_select(0, ids) for k, v in best.items()}
        lstat_w = cw["left_stats"]
        rstat_w = leaf_stats_.index_select(0, ids) - lstat_w
        small_left_w = lstat_w[:, 2] <= rstat_w[:, 2]
        depth_w = leaf_depth.index_select(0, ids) + 1

        rows = [ids_leaf, cw["feature"], cw["threshold"], new_ids,
                small_left_w]
        if sp.any_missing:
            rows.append(cw["default_left"])
        tbl = torch.stack([r.to(i32) for r in rows])
        hist_small, leaf_idx, _ = routed_histogram(
            xt, kvals, leaf_idx, tbl, Bp, W, p.two_col, miss_bin,
            leaf_bound=leaf_bound, shift=shift)
        hist_large = larger_child(pool.index_select(0, ids), hist_small,
                                  hist_scale)
        hist_small = dequant(hist_small)
        sl4 = small_left_w[:, None, None, None]
        hist_l = torch.where(sl4, hist_small, hist_large)
        hist_r = torch.where(sl4, hist_large, hist_small)
        if shift:
            # children interleaved [l0, r0, l1, r1, ...]: live children
            # form a prefix, so the children past W hold rows only when
            # more than W/2 lanes are live (:1648-1688).  Then one pass
            # takes all 2W lanes (the reference's two passes of W come from
            # its lane width; live child ids are distinct and dummy ids
            # match no row, so the sums are the same), else W lanes and
            # zeros for the rest.
            def pair(a, b):
                return torch.stack([a, b], 1).reshape((2 * W,) + a.shape[1:])

            ch_ids = pair(ids_leaf, new_leaf)
            ch_hist = pair(hist_l, hist_r)
            ch_stats = pair(lstat_w, rstat_w)
            ch_depth = pair(depth_w, depth_w)
            win_lo = window(ch_hist, ch_stats)                 # (2W, F)
            lane_ids = ch_ids.to(i32)
            if 2 * live > W:
                win = lanes_window_histogram(
                    xt, kvals, leaf_idx, lane_ids, win_lo, R, 2 * W,
                    p.two_col, miss_bin, leaf_bound)
            else:
                win = lanes_window_histogram(
                    xt, kvals, leaf_idx, lane_ids[:W], win_lo[:W], R, W,
                    p.two_col, miss_bin, leaf_bound)
                win = torch.cat([win, torch.zeros_like(win)])
            win = dequant(win)
            bests = scan_c2f(ch_hist, win, win_lo, ch_stats, ch_depth)
        else:
            ch_ids = torch.cat([ids_leaf, new_leaf])
            ch_hist = torch.cat([hist_l, hist_r])
            ch_stats = torch.cat([lstat_w, rstat_w])
            ch_depth = torch.cat([depth_w, depth_w])
            # all 2W children's best splits in one batched scan
            bests = scan(ch_hist, ch_stats, ch_depth)

        pool.index_copy_(0, ch_ids, ch_hist)
        leaf_stats_.index_copy_(0, ch_ids, ch_stats)
        leaf_depth.index_copy_(0, ch_ids, ch_depth)
        for k, arr in best.items():
            arr.index_copy_(0, ch_ids, bests[k].to(arr.dtype))
        for k, val in (("leaf", ids), ("feature", cw["feature"]),
                       ("threshold", cw["threshold"]),
                       ("default_left", cw["default_left"]),
                       ("gain", topg), ("left_stats", lstat_w),
                       ("right_stats", rstat_w),
                       ("left_mask", cw["left_mask"]), ("valid", valid_w)):
            rec[k].index_copy_(0, ids_rec, val.to(rec[k].dtype))
        n_leaves = n_leaves + valid_w.sum().to(i32)

    return {**{k: v[:L - 1] for k, v in rec.items()}, "leaf_idx": leaf_idx,
            "leaf_stats": leaf_stats_, "n_leaves": n_leaves,
            "n_waves": torch.tensor(n_waves, dtype=i32, device=dev)}


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
