"""Rows routed through one tree's split records: the validation scorer.

Counterpart of ``lightgbm_tpu/ops/grow.py`` ``route_rows`` (:1833), which
the JAX package computes in XLA: split ``t`` moves the rows of leaf
``rec_leaf[t]`` whose bin goes right (``~rec_left_mask[t][bin] &
rec_valid[t]``) to leaf ``t + 1``.  :func:`route_rows_plain` is that loop
in PyTorch, one masked pass over the rows a split; kernel T
(``csrc/route.cu``), called through :func:`route_rows`, walks each row
down the tree the records describe, one thread a row, in one launch.
"""
from __future__ import annotations

import torch

from . import kernels

__all__ = ["route_rows", "route_rows_plain", "route_plan", "LAUNCHES"]

# kernel T's launch constants (csrc/route.cu)
ROUTE_THREADS = 1024
ROUTE_BLOCKS_PER_SM = 2

# launches of kernel T through :func:`route_rows`, one per call
LAUNCHES = {"route": 0}


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


def route_plan(n: int, sms: int) -> dict:
    """Kernel T's grid: a block a 1024 rows, at most two blocks an SM (each
    block stages the tree once, then walks its rows in a grid-stride
    loop)."""
    blocks = max(1, min(ROUTE_BLOCKS_PER_SM * sms, -(-n // ROUTE_THREADS)))
    return {"blocks": blocks}


def route_rows(xt: torch.Tensor, rec_leaf: torch.Tensor,
               rec_feature: torch.Tensor, rec_left_mask: torch.Tensor,
               rec_valid: torch.Tensor, num_leaves: int,
               out: torch.Tensor = None) -> torch.Tensor:
    """Replay a tree's split records over a binned matrix -> (N,) leaf ids
    (``out``: an (N,) uint8 or int32 buffer to write into, else a new
    int32 tensor).  CUDA tensors go to kernel T; CPU tensors to
    :func:`route_rows_plain`.  Reads nothing back to the host, so a CUDA
    graph can hold it."""
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
    if any(t.device != xt.device for t in (leaf, feature, left_mask, valid,
                                          li)):
        raise ValueError("all inputs must be on one device")
    lib = kernels.load()
    B = left_mask.shape[1]
    plan = route_plan(N, kernels.sm_count(xt.device))
    stream = torch.cuda.current_stream(xt.device).cuda_stream
    rc = lib.ltt_route(xt.data_ptr(), xt.element_size(), N, leaf.data_ptr(),
                       feature.data_ptr(), left_mask.data_ptr(),
                       valid.data_ptr(), S, B, li.data_ptr(),
                       li.element_size(), plan["blocks"], stream)
    kernels.check(rc, "kernel T (ltt_route)")
    LAUNCHES["route"] += 1
    return li
