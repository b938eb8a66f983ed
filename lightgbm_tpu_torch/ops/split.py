"""Best numerical split over per-leaf histograms.

Counterpart of ``lightgbm_tpu/ops/split.py``: ``SplitParams`` and the
gain helpers (:28-131) are copied; the numerical section of
``find_best_split`` (:135) and the scan of the TPU kernel
``find_best_split_pallas`` (:899, with ``_scan_tile`` :599,
``_tile_best`` :676 and ``finish_split_partials`` :806) become
:func:`find_best_split_plain`, a tensor transcription, and kernel S
(``csrc/split.cu``), called through :func:`find_best_split`.

Numerical features only, with missing values (both default
directions), min_data_in_leaf, min_sum_hessian_in_leaf, lambda_l1/l2,
max_delta_step and min_gain_to_split.  Ties resolve first-max: lowest
bin within a feature, then lowest feature.  The prefix sums are float32
in the order of the reference's ``jnp.cumsum`` on the CPU
(:func:`prefix_sum`) in both versions; every gain is then the same
float32 expression as ``_split_gain`` compiled for the reference's CPU
backend, which fuses one multiply-add (:func:`fma32`).  So a histogram
the reference also holds bit for bit (quantized sums: integers times a
scale) gives the same gains and the same choice, even where candidates
tie in exact arithmetic.
"""
from __future__ import annotations

import dataclasses

import torch

from . import kernels

__all__ = ["EPS", "NEG_INF", "SplitParams", "leaf_output", "leaf_gain",
           "lane_scalars", "prefix_sum", "find_best_split_plain",
           "find_best_split", "LAUNCHES"]

EPS = 1e-15
NEG_INF = -1e30

# launches of kernel S through :func:`find_best_split`, one per call
LAUNCHES = {"best_split": 0}


@dataclasses.dataclass(frozen=True)
class SplitParams:
    """Split-finding parameters (the numerical subset of the JAX
    package's ``SplitParams``).  ``any_missing`` is a dataset fact: with
    no missing bin anywhere only the default-right scan runs.
    ``counts_proxy`` (``lightgbm_tpu/ops/split.py:57-62``): legal only
    when min_data_in_leaf <= 1 and min_sum_hessian_in_leaf > 0, where a
    side with hess >= msh > 0 holds a row, so no count is read; the
    missing-direction test then reads the hess copy too."""
    max_bin: int
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    max_delta_step: float = 0.0
    any_missing: bool = True
    # the count channel holds a hess copy (two-column quantized passes):
    # feasibility is then the hessian test alone, with
    # msh = max(min_sum_hessian_in_leaf, EPS)
    counts_proxy: bool = False


def threshold_l1(s, l1):
    """ThresholdL1 (feature_histogram.hpp:440)."""
    if l1 == 0.0:
        return s
    return torch.sign(s) * torch.clamp(torch.abs(s) - l1, min=0.0)


def leaf_output(g, h, l1, l2, max_delta_step):
    """CalculateSplittedLeafOutput (feature_histogram.hpp:445)."""
    out = -threshold_l1(g, l1) / (h + l2 + EPS)
    if max_delta_step > 0.0:
        out = torch.clamp(out, -max_delta_step, max_delta_step)
    return out


def fma32(a, b, c):
    """float32 ``a * b + c`` with one rounding of the product-sum, as a
    fused multiply-add: the float32 product is exact in float64, the sum
    rounds there and once more to float32 (which a true fused add would
    differ from only where that second rounding meets a tie).  Kernel S
    computes the same expression."""
    return (a.to(torch.float64) * b.to(torch.float64) +
            c.to(torch.float64)).to(torch.float32)


def _gain_given_output(g, h, out, l1, l2, fuse_first=True):
    """GetLeafSplitGainGivenOutput (feature_histogram.hpp:498):
    ``-(2 * sg * out + (h + l2) * out * out)`` with one of the two
    products fused into the sum, as the reference's CPU compile contracts
    it: the first (``fuse_first``), or the second, which it fuses in the
    default-left scan."""
    sg = threshold_l1(g, l1)
    if fuse_first:
        return -fma32(2.0 * sg, out, (h + l2) * out * out)
    return -fma32((h + l2) * out, out, 2.0 * sg * out)


def leaf_gain(g, h, l1, l2, max_delta_step):
    """GetLeafSplitGain (feature_histogram.hpp:493)."""
    return _gain_given_output(g, h, leaf_output(g, h, l1, l2, max_delta_step),
                              l1, l2)


def _split_gain(gl, hl, gr, hr, l1, l2, mds, fuse_first=True):
    """GetSplitGains (feature_histogram.hpp:456-465), unconstrained."""
    lo = leaf_output(gl, hl, l1, l2, mds)
    ro = leaf_output(gr, hr, l1, l2, mds)
    return (_gain_given_output(gl, hl, lo, l1, l2, fuse_first) +
            _gain_given_output(gr, hr, ro, l1, l2, fuse_first))


def lane_scalars(parent: torch.Tensor, p: SplitParams) -> torch.Tensor:
    """(W, 4) float32 per-lane operand: [parent_g, parent_h, parent_c,
    gain_shift], gain_shift = parent leaf gain + min_gain_to_split."""
    pgain = leaf_gain(parent[:, 0], parent[:, 1], p.lambda_l1, p.lambda_l2,
                      p.max_delta_step)
    gshift = pgain + p.min_gain_to_split
    return torch.cat([parent[:, :3], gshift[:, None]], dim=1).contiguous()


_CHUNK = 16


def prefix_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive float32 prefix sums along ``dim`` in the order of XLA's
    cumsum on the CPU: sequential within chunks of 16, the chunk totals
    summed the same way, and every chunk after the first offset by the
    total of the chunks before it.  Each step is an elementwise float32
    add, so the result is the same on every device."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= _CHUNK:
        outs = [x[..., 0]]
        for i in range(1, n):
            outs.append(outs[-1] + x[..., i])
        return torch.stack(outs, dim=-1).movedim(-1, dim)
    nc = -(-n // _CHUNK)
    pad = nc * _CHUNK - n
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    inner = prefix_sum(x.reshape(x.shape[:-1] + (nc, _CHUNK)), -1)
    pre = prefix_sum(inner[..., -1], -1)
    out = torch.cat([inner[..., :1, :],
                     inner[..., 1:, :] + pre[..., :-1, None]], dim=-2)
    return out.reshape(x.shape)[..., :n].movedim(-1, dim)


def _empty_record(W, B, device):
    return {
        "gain": torch.empty(W, dtype=torch.float32, device=device),
        "feature": torch.empty(W, dtype=torch.int32, device=device),
        "threshold": torch.empty(W, dtype=torch.int32, device=device),
        "default_left": torch.empty(W, dtype=torch.bool, device=device),
        "left_stats": torch.empty(W, 3, dtype=torch.float32, device=device),
        "left_mask": torch.empty(W, B, dtype=torch.bool, device=device),
    }


def find_best_split_plain(hist: torch.Tensor, parent: torch.Tensor,
                          num_bins: torch.Tensor, missing_type: torch.Tensor,
                          feature_mask: torch.Tensor,
                          p: SplitParams) -> dict:
    """Best split for a batch of W leaves — plain PyTorch.

    hist (W, F, B, 3) float32; parent (W, 3) float32; num_bins /
    missing_type (F,) int32; feature_mask (F,) bool.  Returns the record
    dict (gain, feature, threshold, default_left, left_stats (W, 3),
    left_mask (W, B)); gain is net of the parent's gain and
    min_gain_to_split, <= 0 meaning "do not split"."""
    W, F, B, _ = hist.shape
    dev = hist.device
    l1, l2, mds = p.lambda_l1, p.lambda_l2, p.max_delta_step
    lane = lane_scalars(parent, p)
    pst = lane[:, None, None, :3]                          # (W,1,1,3)
    gshift = lane[:, 3][:, None, None]                     # (W,1,1)
    nb = num_bins.to(torch.int64)
    jidx = torch.arange(B, device=dev)
    if p.any_missing:
        has_missing = missing_type != 0
        nv = nb - has_missing.to(torch.int64)
    else:
        has_missing = torch.zeros(F, dtype=torch.bool, device=dev)
        nv = nb
    in_value = jidx[None, :] < nv[:, None]                 # (F, B)
    hv = hist * in_value[None, :, :, None].to(hist.dtype)
    cum = prefix_sum(hv, dim=2)
    cand_ok = jidx[None, :] <= nv[:, None] - 2             # (F, B)
    md = max(p.min_data_in_leaf, 1)
    msh = p.min_sum_hessian_in_leaf

    def scan_dir(L, left=False):
        R = pst - L
        g = _split_gain(L[..., 0], L[..., 1] + EPS, R[..., 0],
                        R[..., 1] + EPS, l1, l2, mds,
                        fuse_first=not left) - gshift
        if p.counts_proxy:
            hmin = max(msh, EPS)
            ok = cand_ok[None] & (L[..., 1] >= hmin) & (R[..., 1] >= hmin)
        else:
            ok = cand_ok[None] & (L[..., 2] >= md) & (R[..., 2] >= md) & \
                (L[..., 1] >= msh) & (R[..., 1] >= msh)
        return torch.where(ok, g, torch.full_like(g, NEG_INF))

    g_r = scan_dir(cum)
    if p.any_missing:
        miss = hist[:, torch.arange(F, device=dev), nb - 1, :] * \
            has_missing[None, :, None].to(hist.dtype)        # (W, F, 3)
        L_l = cum + miss[:, :, None, :]
        g_l = scan_dir(L_l, left=True)
        no_miss = miss[..., 2] <= 0                          # (W, F)
        g_l = torch.where(no_miss[..., None], torch.full_like(g_l, NEG_INF),
                          g_l)
        dirl = g_l > g_r
        gain = torch.where(dirl, g_l, g_r)
        L_win = torch.where(dirl[..., None], L_l, cum)
    else:
        dirl = torch.zeros_like(g_r, dtype=torch.bool)
        gain = g_r
        L_win = cum
    gain = torch.where(feature_mask[None, :, None], gain,
                       torch.full_like(gain, NEG_INF))
    best_pf, best_j = torch.max(gain, dim=2)               # first max
    f_star = torch.argmax(best_pf, dim=1)                  # (W,) first max
    w_idx = torch.arange(W, device=dev)
    j_star = best_j[w_idx, f_star]
    dl = dirl[w_idx, f_star, j_star]
    nb_f = nb[f_star]
    nv_f = nv[f_star]
    left_mask = (jidx[None, :] <= j_star[:, None]) & \
        (jidx[None, :] < nv_f[:, None])
    if p.any_missing:
        left_mask = left_mask | (dl[:, None] & has_missing[f_star][:, None] &
                                 (jidx[None, :] == nb_f[:, None] - 1))
    return {
        "gain": best_pf[w_idx, f_star],
        "feature": f_star.to(torch.int32),
        "threshold": j_star.to(torch.int32),
        "default_left": dl,
        "left_stats": L_win[w_idx, f_star, j_star],
        "left_mask": left_mask,
    }


def find_best_split(hist: torch.Tensor, parent: torch.Tensor,
                    num_bins: torch.Tensor, missing_type: torch.Tensor,
                    feature_mask: torch.Tensor, p: SplitParams) -> dict:
    """Best split for a batch of W leaves, as :func:`find_best_split_plain`.
    CUDA tensors go to kernel S (one launch for the batch); CPU tensors
    to the plain version."""
    if hist.device.type == "cpu":
        return find_best_split_plain(hist, parent, num_bins, missing_type,
                                     feature_mask, p)
    W, F, B, C = hist.shape
    if C != 3 or hist.dtype != torch.float32 or not hist.is_contiguous():
        raise ValueError("hist must be contiguous float32 (W, F, B, 3)")
    if parent.shape != (W, 3) or parent.dtype != torch.float32:
        raise ValueError("parent must be float32 (W, 3)")
    for name, t in (("num_bins", num_bins), ("missing_type", missing_type)):
        if t.shape != (F,) or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 ({F},)")
    if feature_mask.shape != (F,) or feature_mask.dtype != torch.bool:
        raise ValueError(f"feature_mask must be bool ({F},)")
    if any(t.device != hist.device for t in
           (parent, num_bins, missing_type, feature_mask)):
        raise ValueError("all inputs must be on one device")
    lib = kernels.load()
    lane = lane_scalars(parent, p)
    fmask = feature_mask.contiguous()
    part = torch.empty(W, F, 8, dtype=torch.float32, device=hist.device)
    rec = _empty_record(W, B, hist.device)
    stream = torch.cuda.current_stream(hist.device).cuda_stream
    rc = lib.ltt_best_split(
        hist.data_ptr(), num_bins.data_ptr(), missing_type.data_ptr(),
        fmask.data_ptr(), lane.data_ptr(), W, F, B, p.lambda_l1,
        p.lambda_l2, p.max_delta_step, float(max(p.min_data_in_leaf, 1)),
        max(p.min_sum_hessian_in_leaf, EPS) if p.counts_proxy
        else p.min_sum_hessian_in_leaf, int(p.any_missing),
        int(p.counts_proxy), part.data_ptr(),
        rec["gain"].data_ptr(), rec["feature"].data_ptr(),
        rec["threshold"].data_ptr(), rec["default_left"].data_ptr(),
        rec["left_stats"].data_ptr(), rec["left_mask"].data_ptr(), stream)
    kernels.check(rc, "kernel S (ltt_best_split)")
    LAUNCHES["best_split"] += 1
    return rec
