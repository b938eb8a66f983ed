"""Rows routed through one tree's split records: the validation scorer.

Counterpart of ``lightgbm_tpu/ops/grow.py`` ``route_rows`` (:1833), which
the JAX package computes in XLA: split ``t`` moves the rows of leaf
``rec_leaf[t]`` whose bin goes right (``~rec_left_mask[t][bin] &
rec_valid[t]``) to leaf ``t + 1``.  :func:`route_rows_plain` is that loop
in PyTorch, one masked pass over the rows a split.  Kernel T
(``csrc/route.cu``), called through :func:`route_rows`, is one launch a
call: its first block packs the records once into a table (a node a
record: where a row goes next when its bin goes right or left, and that
record's feature; the right-going bins as bitsets), and every block then
walks its rows down the tree the table describes, one thread a row.
:func:`route_pack_plain` and :func:`route_walk_plain` are the plain
versions of the pack and of the walk.
"""
from __future__ import annotations

import torch

from . import kernels

__all__ = ["route_rows", "route_rows_plain", "route_pack_plain",
           "route_walk_plain", "route_plan", "route_table_words",
           "sync_words", "LAUNCHES"]

# kernel T's launch constants (csrc/route.cu): the walk's blocks
ROUTE_THREADS = 1024
ROUTE_BLOCKS_PER_SM = 2

# launches of kernel T through :func:`route_rows`, one a call
LAUNCHES = {"route": 0}
# int32 sync words a launch takes (kSyncWords in csrc/route.cu)
SYNC_WORDS = 4


def route_rows_plain(xt: torch.Tensor, rec_leaf: torch.Tensor,
                     rec_feature: torch.Tensor, rec_left_mask: torch.Tensor,
                     rec_valid: torch.Tensor, num_leaves: int,
                     out: torch.Tensor = None) -> torch.Tensor:
    """The (N,) leaf id of every row of ``xt`` (F, N) after the first
    ``num_leaves - 1`` split records, in ``out`` ((N,) uint8 or int32)
    or a new int32 tensor — plain PyTorch."""
    N = xt.shape[1]
    S = num_leaves - 1
    li = torch.zeros(N, dtype=torch.int32, device=xt.device) \
        if out is None else out.zero_()
    feats = rec_feature[:S].to(torch.int64)
    # (S, B): the bins a valid split sends right
    right = ~rec_left_mask[:S] & rec_valid[:S, None]
    for t in range(S):
        col = xt.index_select(0, feats[t:t + 1]).squeeze(0)
        moves = right[t].index_select(0, col.to(torch.int32))
        li.masked_fill_(moves & (li == rec_leaf[t]), t + 1)
    return li


def route_table_words(S: int, B: int) -> int:
    """int32 words of the packed table of ``S`` records over ``B`` bins:
    a node of 4 words a record, the root's 4, and ``ceil(B / 32)`` bitset
    words a record, padded to a multiple of 4 (the walk stages it in
    16-byte loads)."""
    return 4 * S + 4 + -(-(S * (-(-B // 32))) // 4) * 4


def _table_parts(table: torch.Tensor, S: int, B: int) -> tuple:
    """(nodes (S + 1, 4): the root last, bitsets (S, nw))."""
    nw = -(-B // 32)
    o = 4 * S + 4
    return table[:o].view(S + 1, 4), table[o:o + S * nw].view(S, nw)


def route_pack_plain(rec_leaf: torch.Tensor, rec_feature: torch.Tensor,
                     rec_left_mask: torch.Tensor, rec_valid: torch.Tensor,
                     num_leaves: int) -> torch.Tensor:
    """The packed table of the first ``num_leaves - 1`` records (int32,
    :func:`route_table_words` words, the padding zero).  Node ``t``:
    ``first[t + 1]`` (the first valid record ``t' >= t + 1`` on leaf ``t +
    1``: where a row whose bin goes right goes next) and its feature, then
    ``next[t]`` (the next valid record on ``t``'s leaf: where a row whose
    bin goes left goes next) and its feature; -1 (feature 0) where the
    walk ends.  The root, node ``S``: ``first[0]`` and its feature.  Then
    record ``t``'s right-going bins as bits (bin ``b`` is bit ``b % 32``
    of word ``b // 32``, none for an invalid record).  A valid record
    splits a leaf that exists before it (``0 <= leaf <= t``); others are
    in no chain, as they move no row in :func:`route_rows_plain`."""
    dev = rec_leaf.device
    S = num_leaves - 1
    B = rec_left_mask.shape[1]
    nw = -(-B // 32)
    table = torch.zeros(route_table_words(S, B), dtype=torch.int32,
                        device=dev)
    nodes, right = _table_parts(table, S, B)
    valid = rec_valid[:S]
    t = torch.arange(S, dtype=torch.int64, device=dev)
    leaf = rec_leaf[:S].to(torch.int64)
    on = valid & (leaf >= 0) & (leaf <= t)
    bits = torch.zeros((S, nw * 32), dtype=torch.int64, device=dev)
    bits[:, :B] = (~rec_left_mask[:S] & valid[:, None]).to(torch.int64)
    words = (bits.view(S, nw, 32) <<
             torch.arange(32, dtype=torch.int64, device=dev)).sum(2)
    right.copy_(torch.where(words >= 2 ** 31, words - 2 ** 32, words))
    first = torch.full((S + 1,), -1, dtype=torch.int64, device=dev)
    nxt = torch.full((S,), -1, dtype=torch.int64, device=dev)
    ids = t[on]
    if ids.numel():
        # the chains: the valid records in (leaf, t) order
        order = torch.argsort(leaf[on] * (S + 1) + ids)
        lv, tv = leaf[on][order], ids[order]
        same = lv[1:] == lv[:-1]
        nxt[tv[:-1][same]] = tv[1:][same]
        head = torch.ones_like(lv, dtype=torch.bool)
        head[1:] = ~same
        first[lv[head]] = tv[head]
    feat = torch.cat([rec_feature[:S].to(torch.int64),
                      torch.zeros(1, dtype=torch.int64, device=dev)])
    go = torch.cat([first[1:], first[:1]])        # node S: the root
    stay = torch.cat([nxt, torch.full((1,), -1, dtype=torch.int64,
                                      device=dev)])
    nodes.copy_(torch.stack([go, feat[go], stay, feat[stay]], 1))
    return table


def route_walk_plain(xt: torch.Tensor, table: torch.Tensor, S: int, B: int,
                     out: torch.Tensor = None) -> torch.Tensor:
    """The rows of ``xt`` (F, N) walked down a packed table (the walk's
    plain version): from the root's record, a row whose bin at record
    ``t`` goes right moves to leaf ``t + 1`` and to the node's right
    record, else to its left record, until the walk ends.  Returns the
    (N,) leaf ids in ``out`` or a new int32 tensor."""
    nodes, right = _table_parts(table, S, B)
    nodes = nodes.to(torch.int64)
    N = xt.shape[1]
    dev = xt.device
    leaf = torch.zeros(N, dtype=torch.int64, device=dev)
    node = nodes[S, 0].expand(N).clone()
    feat = nodes[S, 1].expand(N).clone()
    rows = torch.arange(N, dtype=torch.int64, device=dev)
    while True:
        on = node >= 0
        if not bool(on.any()):
            break
        r, nd, f = rows[on], node[on], feat[on]
        b = xt[f, r].to(torch.int64)
        go = ((right[nd, b >> 5].to(torch.int64) >> (b & 31)) & 1) != 0
        leaf[r[go]] = nd[go] + 1
        rec = nodes[nd]
        node[r] = torch.where(go, rec[:, 0], rec[:, 2])
        feat[r] = torch.where(go, rec[:, 1], rec[:, 3])
    if out is None:
        return leaf.to(torch.int32)
    return out.copy_(leaf)


def sync_words(device, stream: int) -> torch.Tensor:
    """Kernel T's sync words for launches on ``stream`` of ``device`` (the
    packing block's ticket and flag; ``kernels.sync_words``)."""
    return kernels.sync_words("kernel T", SYNC_WORDS, device, stream)


def route_plan(n: int, sms: int) -> dict:
    """Kernel T's grid: a block a 1024 rows, at most two blocks an SM, two
    rows a thread at a time in a grid-stride loop (each block copies the
    packed table once)."""
    blocks = max(1, min(ROUTE_BLOCKS_PER_SM * sms, -(-n // ROUTE_THREADS)))
    return {"blocks": blocks}


def route_rows(xt: torch.Tensor, rec_leaf: torch.Tensor,
               rec_feature: torch.Tensor, rec_left_mask: torch.Tensor,
               rec_valid: torch.Tensor, num_leaves: int,
               out: torch.Tensor = None,
               table: torch.Tensor = None) -> torch.Tensor:
    """Replay a tree's split records over a binned matrix -> (N,) leaf ids
    (``out``: an (N,) uint8 or int32 buffer to write into, else a new
    int32 tensor).  CUDA tensors go to kernel T, which packs the records
    into ``table`` (:func:`route_table_words` int32 words, else a new
    buffer) and walks the rows in one launch; CPU tensors go to
    :func:`route_rows_plain` (``table`` unused).  Reads nothing back to
    the host, so a CUDA graph can hold it."""
    if xt.device.type == "cpu":
        return route_rows_plain(xt, rec_leaf, rec_feature, rec_left_mask,
                                rec_valid, num_leaves, out)
    N = xt.shape[1]
    S = num_leaves - 1
    if xt.dtype not in (torch.uint8, torch.int16) or xt.dim() != 2 or \
            not xt.is_contiguous():
        raise ValueError("xt must be contiguous uint8/int16 (F, N)")
    leaf, feature = rec_leaf[:S], rec_feature[:S]
    left_mask, valid = rec_left_mask[:S], rec_valid[:S]
    if leaf.dtype != torch.int32 or feature.dtype != torch.int32 or \
            leaf.shape != (S,) or feature.shape != (S,):
        raise ValueError(f"rec_leaf and rec_feature must be int32 ({S},)")
    if left_mask.dtype != torch.bool or left_mask.dim() != 2 or \
            left_mask.shape[0] != S or valid.dtype != torch.bool or \
            valid.shape != (S,):
        raise ValueError(f"rec_left_mask must be bool ({S}, B) and "
                         f"rec_valid bool ({S},)")
    if not all(t.is_contiguous() for t in (leaf, feature, left_mask, valid)):
        raise ValueError("the records must be contiguous")
    # kernel T writes every row
    li = torch.empty(N, dtype=torch.int32, device=xt.device) \
        if out is None else out
    if li.dtype not in (torch.uint8, torch.int32) or li.shape != (N,) or \
            not li.is_contiguous():
        raise ValueError("out must be contiguous uint8/int32 (N,)")
    if li.dtype == torch.uint8 and num_leaves > 256:
        raise ValueError("uint8 ids hold at most 256 leaves")
    B = left_mask.shape[1]
    words = route_table_words(S, B)
    if table is None:
        table = torch.empty(words, dtype=torch.int32, device=xt.device)
    if table.dtype != torch.int32 or table.shape != (words,) or \
            not table.is_contiguous():
        raise ValueError(f"table must be contiguous int32 ({words},)")
    if any(t.device != xt.device for t in (leaf, feature, left_mask, valid,
                                          li, table)):
        raise ValueError("all inputs must be on one device")
    lib = kernels.load()
    stream = torch.cuda.current_stream(xt.device).cuda_stream
    sync = sync_words(xt.device, stream)
    plan = route_plan(N, kernels.sm_count(xt.device))
    rc = lib.ltt_route(xt.data_ptr(), xt.element_size(), N, leaf.data_ptr(),
                       feature.data_ptr(), left_mask.data_ptr(),
                       valid.data_ptr(), S, B, table.data_ptr(), words,
                       sync.data_ptr(), li.data_ptr(), li.element_size(),
                       plan["blocks"], stream)
    kernels.check(rc, "kernel T (ltt_route)")
    LAUNCHES["route"] += 1
    return li
