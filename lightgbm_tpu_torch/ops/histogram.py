"""Per-leaf histograms: ``[sum_grad, sum_hess, count]`` per (feature, bin).

Counterpart of ``lightgbm_tpu/ops/histogram.py``: ``histogram_segsum``
(:64) becomes :func:`histogram_plain`, and the TPU kernel
``histogram_pallas`` (:238) becomes kernel H
(``csrc/histogram.cu``), called through :func:`masked_histogram` with
the leaf mask fused in — the function ``masked_hist`` computes in the
JAX growth loop (``lightgbm_tpu/ops/grow.py:529-533``).

Both versions sum in float64 and round once to float32, so the kernel,
the plain version on the card and the plain version on the CPU agree
whatever the order of the additions (the JAX reference sums in float32;
the parity tests state the tolerance that follows).
"""
from __future__ import annotations

import torch

from . import kernels

__all__ = ["histogram_plain", "masked_histogram_plain", "masked_histogram",
           "LAUNCHES"]

# launches of kernel H through :func:`masked_histogram`, one per call
LAUNCHES = {"histogram": 0}

_THREADS = 512
_SMEM_BUDGET = 99 * 1024   # two blocks of the float64 tile per SM
_SMEM_MAX = 232_448        # the most dynamic shared memory a block can have


def histogram_plain(bins: torch.Tensor, vals: torch.Tensor,
                    max_bin: int) -> torch.Tensor:
    """(F, N) integer bins x (N, 3) values -> (F, B, 3) float32.

    ``index_add_`` over the flat ``f * B + bin`` ids, one feature at a
    time, accumulated in float64."""
    F = bins.shape[0]
    v = vals.to(torch.float64)
    out = torch.zeros(F * max_bin, 3, dtype=torch.float64,
                      device=bins.device)
    for f in range(F):
        ids = bins[f].to(torch.int64) + f * max_bin
        out.index_add_(0, ids, v)
    return out.to(torch.float32).reshape(F, max_bin, 3)


def masked_histogram_plain(bins, grad, hess, mask, leaf_idx, leaf_id,
                           max_bin: int) -> torch.Tensor:
    """Histogram of the rows with ``leaf_idx == leaf_id`` (``leaf_id`` a
    0-dim tensor), weighted by ``mask`` — plain PyTorch."""
    m = mask * (leaf_idx == leaf_id).to(mask.dtype)
    vals = torch.stack([grad * m, hess * m, m], dim=-1)
    return histogram_plain(bins, vals, max_bin)


def _plan(F: int, B: int, n: int, device) -> tuple:
    """(features per block, row blocks) for kernel H."""
    if B * 3 * 8 > _SMEM_MAX:
        raise ValueError(f"kernel H holds one feature's {B} bins in shared "
                         f"memory: at most {_SMEM_MAX // 24} bins")
    fc = max(1, min(F, _SMEM_BUDGET // (B * 3 * 8)))
    chunks = (F + fc - 1) // fc
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    row_blocks = max(1, min((2 * sms) // chunks, (n + _THREADS - 1)
                            // _THREADS))
    return fc, row_blocks


def masked_histogram(bins: torch.Tensor, grad: torch.Tensor,
                     hess: torch.Tensor, mask: torch.Tensor,
                     leaf_idx: torch.Tensor, leaf_id: torch.Tensor,
                     max_bin: int) -> torch.Tensor:
    """Masked leaf histogram, (F, B, 3) float32.

    bins (F, N) uint8/int16; grad/hess/mask (N,) float32; leaf_idx (N,)
    uint8/int32; leaf_id a 0-dim int32 tensor on the same device (read by
    the kernel, so choosing the leaf needs no host sync).  CUDA tensors
    go to kernel H; CPU tensors to :func:`masked_histogram_plain`."""
    if bins.device.type == "cpu":
        return masked_histogram_plain(bins, grad, hess, mask, leaf_idx,
                                      leaf_id, max_bin)
    F, n = bins.shape
    if bins.dtype not in (torch.uint8, torch.int16):
        raise TypeError(f"bins must be uint8/int16, got {bins.dtype}")
    if leaf_idx.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"leaf_idx must be uint8/int32, got {leaf_idx.dtype}")
    for name, t in (("grad", grad), ("hess", hess), ("mask", mask)):
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError(f"{name} must be float32 of shape ({n},)")
    if leaf_idx.shape != (n,) or leaf_id.numel() != 1 or \
            leaf_id.dtype != torch.int32:
        raise ValueError("leaf_idx must be (N,), leaf_id one int32 value")
    tensors = (bins, grad, hess, mask, leaf_idx, leaf_id)
    if any(t.device != bins.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    lib = kernels.load()
    fc, row_blocks = _plan(F, max_bin, n, bins.device)
    partial = torch.empty(row_blocks * F * max_bin * 3, dtype=torch.float64,
                          device=bins.device)
    out = torch.empty(F, max_bin, 3, dtype=torch.float32, device=bins.device)
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    rc = lib.ltt_hist_masked(
        bins.data_ptr(), bins.element_size(), grad.data_ptr(),
        hess.data_ptr(), mask.data_ptr(), leaf_idx.data_ptr(),
        leaf_idx.element_size(), leaf_id.data_ptr(), n, F, max_bin, fc,
        row_blocks, _THREADS, partial.data_ptr(), out.data_ptr(), stream)
    kernels.check(rc, "kernel H (ltt_hist_masked)")
    LAUNCHES["histogram"] += 1
    return out
