"""Small-table row lookup fused with the score update.

Counterpart of ``lightgbm_tpu/ops/lookup.py`` (``take_small`` :64 and
the TPU kernel ``_take_small_pallas`` :35): :func:`take_small_plain` is
the lookup ``vals[idx]``; kernel L (``csrc/lookup.cu``), called through
:func:`take_small_add`, fuses it with the score add the JAX boosting
loop performs right after it (``lightgbm_tpu/models/gbdt.py:2286-2290``):
``score += vals[leaf_idx]`` in one pass over the rows.  The score is the
float32 training score or a validation set's float64 score, to which the
float32 values are widened before the add, as the JAX package widens
``take_small``'s result to add it to a valid score
(``lightgbm_tpu/models/gbdt.py:2629``).
"""
from __future__ import annotations

import torch

from . import kernels

__all__ = ["MAX_LOOKUP_TABLE", "take_small_plain", "take_small_add_plain",
           "take_small_add", "lookup_plan", "LAUNCHES"]

MAX_LOOKUP_TABLE = 512
# kernel L's launch constants (csrc/lookup.cu)
LOOKUP_TILE = 128            # rows a warp adds per tile, 4 a lane
LOOKUP_WARPS_PER_BLOCK = 8   # 256 threads
LOOKUP_BLOCKS_PER_SM = 4     # one sweep of the card

# launches of kernel L through :func:`take_small_add`, one per call, by the
# score's type: float32 (the training score) and float64 (valid scores)
LAUNCHES = {"leaf_lookup": 0, "leaf_lookup_f64": 0}


def take_small_plain(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``vals[idx]`` for a (L,) table and (N,) integer ids."""
    return vals[idx.to(torch.int64)]


def take_small_add_plain(score: torch.Tensor, vals: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """``score += vals[idx]`` in place — plain PyTorch; a float64 score
    adds the float32 values widened."""
    score += take_small_plain(vals, idx).to(score.dtype)
    return score


def lookup_plan(n: int, sms: int) -> dict:
    """Kernel L's launch plan on a card with ``sms`` multiprocessors.

    ``tiles`` whole 128-row tiles are split among ``warps`` warps in
    contiguous ranges: warp ``w`` adds tiles ``[w * tiles // warps,
    (w + 1) * tiles // warps)``, and the last warp also the ``n - 128 *
    tiles`` rows after them.  The grid is one sweep of the card, fewer
    blocks when there are fewer than 32 tiles a block."""
    tiles = n // LOOKUP_TILE
    per_block = 4 * LOOKUP_WARPS_PER_BLOCK   # four tiles in flight a warp
    blocks = max(1, min(LOOKUP_BLOCKS_PER_SM * sms, -(-tiles // per_block)))
    return {"blocks": blocks, "warps": blocks * LOOKUP_WARPS_PER_BLOCK,
            "tiles": tiles}


def take_small_add(score: torch.Tensor, vals: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """``score += vals[idx]`` in place: score (N,) float32 or float64,
    vals (L,) float32 with L <= 512, idx (N,) uint8/int32.  CUDA tensors
    go to kernel L; CPU tensors to :func:`take_small_add_plain`."""
    if score.device.type == "cpu":
        return take_small_add_plain(score, vals, idx)
    n = score.shape[0]
    if score.dtype not in (torch.float32, torch.float64) or \
            score.dim() != 1 or not score.is_contiguous():
        raise ValueError("score must be contiguous float32/float64 (N,)")
    if vals.dtype != torch.float32 or vals.dim() != 1 or \
            not 0 < vals.shape[0] <= MAX_LOOKUP_TABLE:
        raise ValueError(f"vals must be float32 (L,), L <= {MAX_LOOKUP_TABLE}")
    if idx.dtype not in (torch.uint8, torch.int32) or idx.shape != (n,) or \
            not idx.is_contiguous():
        raise ValueError("idx must be contiguous uint8/int32 (N,)")
    if idx.device != score.device or vals.device != score.device:
        raise ValueError("all inputs must be on one device")
    if score.data_ptr() % 16 or idx.data_ptr() % 16:
        raise ValueError("score and idx must be 16-byte aligned")
    lib = kernels.load()
    vals = vals.contiguous()
    plan = lookup_plan(n, kernels.sm_count(score.device))
    stream = torch.cuda.current_stream(score.device).cuda_stream
    rc = lib.ltt_leaf_add(idx.data_ptr(), idx.element_size(), vals.data_ptr(),
                          vals.shape[0], score.data_ptr(),
                          score.element_size(), n, plan["blocks"],
                          plan["tiles"], stream)
    kernels.check(rc, "kernel L (ltt_leaf_add)")
    LAUNCHES["leaf_lookup" if score.dtype == torch.float32
             else "leaf_lookup_f64"] += 1
    return score
