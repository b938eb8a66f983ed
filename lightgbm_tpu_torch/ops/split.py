"""Best split over per-leaf histograms.

Counterpart of ``lightgbm_tpu/ops/split.py``: ``SplitParams`` and the
gain helpers (:28-131) are copied; the numerical section of
``find_best_split`` (:135) and the scan of the TPU kernel
``find_best_split_pallas`` (:899, with ``_scan_tile`` :599,
``_tile_best`` :676 and ``finish_split_partials`` :806) become
:func:`find_best_split_plain`, a tensor transcription, and kernel S
(``csrc/split.cu``), called through :func:`find_best_split`.  The
categorical scans of ``find_best_split`` (:206-302: one-vs-other, and
sorted many-vs-many from both ends) are XLA in the JAX package, and
plain tensor code here (:func:`categorical_split`) on every device.

Numerical features with missing values (both default directions),
min_data_in_leaf, min_sum_hessian_in_leaf, lambda_l1/l2, max_delta_step
and min_gain_to_split; categorical features with ``cat_l2``,
``cat_smooth``, ``max_cat_to_onehot``, ``max_cat_threshold`` and
``min_data_per_group``; monotone constraints (each lane's output bounds
and each feature's direction, ``_split_gain`` :100-116) and the feature
penalty (``feature_contri``), in the plain versions and in kernel S's
constrained mode.  Ties resolve first-max: lowest bin within a
feature, then lowest feature.  With categorical features the numerical
scan (kernel S on the card) skips them and the categorical scan takes
them; one merge keeps the first-max order (:func:`merge_records`).  The
prefix sums are float32 in the order of the reference's ``jnp.cumsum``
on the CPU (:func:`prefix_sum`) in both versions; every gain is then the
same float32 expression as ``_split_gain`` compiled for the reference's
CPU backend, which fuses one multiply-add (:func:`fma32`).  So a histogram
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
           "depth_limit", "categorical_split", "merge_records",
           "find_best_split", "choose_window", "find_best_split_c2f",
           "done_counters", "LAUNCHES"]

EPS = 1e-15
NEG_INF = -1e30

# where a scan runs in the growth loop: the root, the exact loop's step, a
# wave's children (the scans' ``site``, :data:`_CLIP_FUSION`)
ROOT, LOOP, WAVE = "root", "loop", "wave"
# kernel S's fusion operand under the clip: 0 as the root (default right
# fuses its first product, default left its second), 1 as the exact loop
# (both their first), 2 as a wave's children (both their second)
_KERNEL_FUSION = {ROOT: 0, LOOP: 1, WAVE: 2}

# launches of kernel S through :func:`find_best_split`, one per call: in
# its constrained mode (any of monotone, penalty, bounds), or not
LAUNCHES = {"best_split": 0, "best_split_constrained": 0}


@dataclasses.dataclass(frozen=True)
class SplitParams:
    """Split-finding parameters (the JAX package's ``SplitParams``).
    ``monotone`` and ``penalty`` are per-feature tuples padded to the
    feature count (empty: no constraint, every multiplier 1), static as
    there, so the unconstrained scans keep their code.  ``any_missing``
    and ``any_cat`` are dataset facts: with no missing bin anywhere only
    the default-right scan runs, and with no categorical feature no
    categorical scan.
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
    max_cat_to_onehot: int = 4
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    min_data_per_group: int = 100
    any_missing: bool = True
    any_cat: bool = False
    # the count channel holds a hess copy (two-column quantized passes):
    # feasibility is then the hessian test alone, with
    # msh = max(min_sum_hessian_in_leaf, EPS)
    counts_proxy: bool = False
    # -1/0/+1 per feature (monotone_constraints)
    monotone: tuple = ()
    # gain multipliers per feature (feature_contri)
    penalty: tuple = ()

    @property
    def has_monotone(self) -> bool:
        return bool(self.monotone) and any(self.monotone)

    @property
    def has_penalty(self) -> bool:
        return bool(self.penalty) and any(x != 1.0 for x in self.penalty)


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


def _split_gain(gl, hl, gr, hr, l1, l2, mds, fuse_first=True, mn=None,
                mx=None, mono=None):
    """GetSplitGains (feature_histogram.hpp:456-465): with bounds, both
    child outputs clipped to the leaf's ``[mn, mx]``; with ``mono``, a
    candidate whose outputs break the feature's direction (left above
    right for +1, below for -1) gets NEG_INF (the JAX package's
    ``_split_gain``, :100-116)."""
    lo = leaf_output(gl, hl, l1, l2, mds)
    ro = leaf_output(gr, hr, l1, l2, mds)
    if mn is not None:
        lo = torch.minimum(torch.maximum(lo, mn), mx)
        ro = torch.minimum(torch.maximum(ro, mn), mx)
    g = (_gain_given_output(gl, hl, lo, l1, l2, fuse_first) +
         _gain_given_output(gr, hr, ro, l1, l2, fuse_first))
    if mono is not None:
        viol = ((mono > 0) & (lo > ro)) | ((mono < 0) & (lo < ro))
        g = torch.where(viol, torch.full_like(g, NEG_INF), g)
    return g


def lane_scalars(parent: torch.Tensor, p: SplitParams) -> torch.Tensor:
    """(W, 4) float32 per-lane operand: [parent_g, parent_h, parent_c,
    gain_shift], gain_shift = parent leaf gain + min_gain_to_split.  The
    plain version of what kernel S computes for itself, bit for bit."""
    pgain = leaf_gain(parent[:, 0], parent[:, 1], p.lambda_l1, p.lambda_l2,
                      p.max_delta_step)
    gshift = pgain + p.min_gain_to_split
    return torch.cat([parent[:, :3], gshift[:, None]], dim=1).contiguous()


# Under the monotone clip the reference's CPU compile contracts other
# products of a gain into the multiply-add (:func:`_gain_given_output`),
# and which depends on the unit it compiles the scan in: the root's, the
# exact loop's step, or the vmapped scan of a wave's children.  Probed
# against the JAX package's trees on bit-identical quantized histograms
# (``tests/test_torch_monotone_train.py``), each site's (numerical default
# right, default left; categorical one-vs-other, sorted from the low end,
# from the high end), True where the first product is fused.  Without the
# clip every site fuses as :func:`_scan_both`, :func:`categorical_split`
# and the c2f scans say.
_CLIP_FUSION = {ROOT: (True, False, True, True, True),
                LOOP: (True, True, False, True, True),
                WAVE: (False, False, False, False, False)}


def _lane_bounds(bounds):
    """(mn, mx) of the lanes' output bounds (W, 2), each (W, 1, 1) beside
    the candidates (the JAX package's lane slots 4-5, :713-735), or (None,
    None) without bounds."""
    if bounds is None:
        return None, None
    return bounds[:, 0, None, None], bounds[:, 1, None, None]


def _penalize(gain: torch.Tensor, penalty) -> torch.Tensor:
    """feature_contri: a real candidate's gain times its feature's
    multiplier, after the default directions' max and before the feature
    mask (``find_best_split``, :214-218, :303-309).  ``gain`` (W, F, K),
    ``penalty`` (F,) or None."""
    if penalty is None:
        return gain
    return torch.where(gain > 0.5 * NEG_INF, gain * penalty[None, :, None],
                       gain)


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


def _scan_gains(L, pst, gshift, ok, p: SplitParams, fuse_first: bool,
                mn=None, mx=None, mono=None):
    """Net gains of the candidates whose left side is ``L`` (..., 3):
    ``parent - L`` on the right, NEG_INF where ``ok`` is false or a side
    fails min_data / min_sum_hessian.  ``fuse_first``: which product of
    the gain the multiply-add takes (:func:`_gain_given_output`);
    ``mn``/``mx``/``mono``: :func:`_split_gain`'s constraints."""
    R = pst - L
    g = _split_gain(L[..., 0], L[..., 1] + EPS, R[..., 0], R[..., 1] + EPS,
                    p.lambda_l1, p.lambda_l2, p.max_delta_step,
                    fuse_first=fuse_first, mn=mn, mx=mx,
                    mono=mono) - gshift
    msh = p.min_sum_hessian_in_leaf
    if p.counts_proxy:
        hmin = max(msh, EPS)
        ok = ok & (L[..., 1] >= hmin) & (R[..., 1] >= hmin)
    else:
        md = max(p.min_data_in_leaf, 1)
        ok = ok & (L[..., 2] >= md) & (R[..., 2] >= md) & \
            (L[..., 1] >= msh) & (R[..., 1] >= msh)
    return torch.where(ok, g, torch.full_like(g, NEG_INF))


def _scan_both(cum, miss, no_miss, pst, gshift, ok, p: SplitParams,
               left_fuse_first: bool = False, mn=None, mx=None, mono=None,
               right_fuse_first: bool = True):
    """Both default directions over prefix stats ``cum`` (W, F, K, 3)
    -> (gain, left stats, default left), each per candidate.  ``miss``
    (W, F, 3) holds the missing bin's stats (None without missing
    values); default left is scanned only where the leaf has missing
    rows (``~no_miss``) and wins only when strictly better.  The
    default-right gains fuse their first product (the second with
    ``right_fuse_first`` false); the default-left ones the first with
    ``left_fuse_first``, else the second — the contractions of the
    reference's CPU compile of each scan.
    ``mn``/``mx`` (W, 1, 1) and ``mono`` (1, F, 1): the constraints of
    :func:`_split_gain`, or None."""
    cons = dict(mn=mn, mx=mx, mono=mono)
    g_r = _scan_gains(cum, pst, gshift, ok, p, fuse_first=right_fuse_first,
                      **cons)
    if miss is None:
        return g_r, cum, torch.zeros_like(g_r, dtype=torch.bool)
    L_l = cum + miss[:, :, None, :]
    g_l = _scan_gains(L_l, pst, gshift, ok, p, fuse_first=left_fuse_first,
                      **cons)
    g_l = torch.where(no_miss[..., None], torch.full_like(g_l, NEG_INF), g_l)
    dirl = g_l > g_r
    return (torch.where(dirl, g_l, g_r),
            torch.where(dirl[..., None], L_l, cum), dirl)


def _record_views(W, F, B, device):
    """The record's six outputs and kernel S's (W, F, 8) float32 scratch
    as views into one buffer, the 4-byte fields first so every view is
    aligned to its element -> (record dict, scratch)."""
    buf = torch.empty(W * (25 + 32 * F + B), dtype=torch.uint8,
                      device=device)
    gain, ls, feat, thr, part, dl, lm = buf.split(
        [4 * W, 12 * W, 4 * W, 4 * W, 32 * W * F, W, W * B])
    return {
        "gain": gain.view(torch.float32),
        "left_stats": ls.view(torch.float32).view(W, 3),
        "feature": feat.view(torch.int32),
        "threshold": thr.view(torch.int32),
        "default_left": dl.view(torch.bool),
        "left_mask": lm.view(torch.bool).view(W, B),
    }, part


_DONE: dict = {}


def done_counters(W: int, device, stream: int) -> torch.Tensor:
    """Kernel S's per-lane completion counters for launches on ``stream``
    of ``device``: zeroed once; each launch leaves them zero again.  Each
    stream has its own, so launches on two streams cannot mix counts.  A
    graph capture makes its stream's counters first (``ops/graphs.py``):
    made inside a capture, their zeroing would be captured, not run."""
    key = (torch.device(device).index, stream)
    done = _DONE.get(key)
    if done is None or done.numel() < W:
        done = torch.zeros(max(W, 4096), dtype=torch.int32, device=device)
        _DONE[key] = done
    return done


def find_best_split_plain(hist: torch.Tensor, parent: torch.Tensor,
                          num_bins: torch.Tensor, missing_type: torch.Tensor,
                          feature_mask: torch.Tensor, p: SplitParams,
                          depth=None, max_depth: int = 0,
                          is_cat=None, monotone=None, penalty=None,
                          bounds=None, site: str = ROOT) -> dict:
    """Best split for a batch of W leaves — plain PyTorch.

    hist (W, F, B, 3) float32; parent (W, 3) float32; num_bins /
    missing_type (F,) int32; feature_mask (F,) bool.  Returns the record
    dict (gain, feature, threshold, default_left, left_stats (W, 3),
    left_mask (W, B)); gain is net of the parent's gain and
    min_gain_to_split, <= 0 meaning "do not split".  With ``depth`` (W,)
    int32 (or (1,), one depth for all) and ``max_depth`` > 0, a lane whose
    depth has reached ``max_depth`` gets gain NEG_INF (the growth loop's
    depth limit).  With ``p.any_cat``, ``is_cat`` (F,) bool names the
    categorical features: the record also holds ``is_cat`` (W,) bool, and
    a categorical split's left mask is its category set.

    The constraints (``find_best_split``'s, :135-139): ``monotone`` (F,)
    int32 directions, ``penalty`` (F,) float32 gain multipliers and
    ``bounds`` (W, 2) float32, each lane's output bounds ``[mn, mx]``,
    present exactly when ``monotone`` is (``p.has_monotone``); each None
    where the parameters carry none.  Categorical splits clip to the
    bounds and carry no direction.  ``site`` (:data:`ROOT`, :data:`LOOP` or
    :data:`WAVE`): where the growth loop scans, which decides the fused
    products under the clip."""
    cons = dict(monotone=monotone, penalty=penalty, bounds=bounds, site=site)
    if p.any_cat:
        num = _numerical_split(hist, parent, num_bins, missing_type,
                               feature_mask & ~is_cat, p, **cons)
        rec = merge_records(num, categorical_split(
            hist, parent, num_bins, missing_type, is_cat, feature_mask, p,
            penalty, bounds, site))
    else:
        rec = _numerical_split(hist, parent, num_bins, missing_type,
                               feature_mask, p, **cons)
    return depth_limit(rec, depth, max_depth)


def _mono_col(monotone):
    """(F,) directions as (1, F, 1) beside the candidates, or None."""
    return None if monotone is None else monotone[None, :, None]


def _numerical_split(hist, parent, num_bins, missing_type, feature_mask,
                     p: SplitParams, monotone=None, penalty=None,
                     bounds=None, site: str = ROOT) -> dict:
    """The plain numerical scan: :func:`find_best_split_plain` over the
    features of ``feature_mask``, no depth limit."""
    W, F, B, _ = hist.shape
    dev = hist.device
    lane = lane_scalars(parent, p)
    pst = lane[:, None, None, :3]                          # (W,1,1,3)
    gshift = lane[:, 3][:, None, None]                     # (W,1,1)
    mn, mx = _lane_bounds(bounds)
    nb = num_bins.to(torch.int64)
    jidx = torch.arange(B, device=dev)
    nv, has_missing = _nv_missing(num_bins, missing_type, p)
    in_value = jidx[None, :] < nv[:, None]                 # (F, B)
    hv = hist * in_value[None, :, :, None].to(hist.dtype)
    cum = prefix_sum(hv, dim=2)
    cand_ok = (jidx[None, :] <= nv[:, None] - 2)[None]     # (1, F, B)
    miss = no_miss = None
    if p.any_missing:
        miss = hist[:, torch.arange(F, device=dev), nb - 1, :] * \
            has_missing[None, :, None].to(hist.dtype)        # (W, F, 3)
        no_miss = miss[..., 2] <= 0                          # (W, F)
    right, left = _CLIP_FUSION[site][:2] if mn is not None else (True, False)
    gain, L_win, dirl = _scan_both(cum, miss, no_miss, pst, gshift, cand_ok,
                                   p, left_fuse_first=left, mn=mn, mx=mx,
                                   mono=_mono_col(monotone),
                                   right_fuse_first=right)
    return _record(_penalize(gain, penalty), L_win, dirl,
                   jidx.expand(W, F, B), num_bins, has_missing, feature_mask,
                   B)


def categorical_split(hist: torch.Tensor, parent: torch.Tensor,
                      num_bins: torch.Tensor, missing_type: torch.Tensor,
                      is_cat: torch.Tensor, feature_mask: torch.Tensor,
                      p: SplitParams, penalty=None, bounds=None,
                      site: str = ROOT) -> dict:
    """The best categorical split of each of W leaves over the features of
    ``is_cat & feature_mask`` (``find_best_split``, :206-302) -> the
    record of :func:`find_best_split_plain` with ``is_cat`` true.

    A feature with at most ``max_cat_to_onehot`` value bins splits one
    category from the rest (``l2 + cat_l2``); a wider one sorts the bins
    that hold rows by ``g / (h + cat_smooth)`` in float32, stably (equal
    ratios keep bin order, as ``jnp.argsort`` does), and scans the
    sorted prefixes from both ends, at most ``max_cat_threshold``
    categories on the left and ``min_data_per_group`` rows on each side.
    Bin 0, the "other" bin, never goes left; the missing bin is no
    category.  The prefix sums are :func:`prefix_sum`'s, as every scan's
    here.  The candidate index of a sorted split is its position in the
    sort, as in the JAX package; the left mask holds its categories.
    With ``bounds`` (W, 2) both child outputs are clipped to the lane's
    bounds, with no monotone direction (:249-254), and each scan fuses as
    ``site`` says (:data:`_CLIP_FUSION`); ``penalty`` (F,) scales the
    merged gains as :func:`_penalize` (:303-309)."""
    W, F, B, _ = hist.shape
    dev = hist.device
    lane = lane_scalars(parent, p)
    pst = lane[:, None, None, :3]
    gshift = lane[:, 3][:, None, None]
    mn, mx = _lane_bounds(bounds)
    l1, l2c, mds = p.lambda_l1, p.lambda_l2 + p.cat_l2, p.max_delta_step
    nv, _ = _nv_missing(num_bins, missing_type, p)
    jidx = torch.arange(B, device=dev)
    in_value = jidx[None, :] < nv[:, None]                 # (F, B)
    hv = hist * in_value[None, :, :, None].to(hist.dtype)
    not_other = jidx > 0

    # one-vs-other: the singleton {bin j}
    onehot_ok = (is_cat & (nv <= p.max_cat_to_onehot))[:, None] & \
        in_value & not_other
    # many-vs-many: bins with rows, sorted by their ratio
    valid = (hv[..., 2] > 0) & not_other & in_value        # (W, F, B)
    ratio = torch.where(valid, hv[..., 0] / (hv[..., 1] + p.cat_smooth),
                        torch.full_like(hv[..., 0], float("inf")))
    order = torch.sort(ratio, dim=2, stable=True).indices
    sorted_h = torch.gather(hv * valid[..., None].to(hv.dtype), 2,
                            order[..., None].expand(W, F, B, 3))
    n_valid = valid.sum(dim=2)                             # (W, F)
    cum = prefix_sum(sorted_h, dim=2)
    many_ok = (is_cat & (nv > p.max_cat_to_onehot))[None, :, None]
    pos1 = jidx[None, None, :] + 1                         # left size
    ok_lo = pos1 <= torch.clamp(n_valid - 1,
                                max=p.max_cat_threshold)[..., None]
    size = n_valid[..., None] - pos1
    ok_hi = (size >= 1) & (size <= p.max_cat_threshold) & \
        (pos1 < n_valid[..., None])
    L_lo = cum
    L_hi = cum[:, :, -1:, :] - cum
    # the three scans' candidates in one batch (fewer, larger launches): a
    # singleton, a sorted prefix on the left, a sorted suffix on the left;
    # min_data_per_group binds the sorted ones (a count is never below 0)
    L = torch.stack([hv, L_lo, L_hi])                       # (3, W, F, B, 3)
    ok = torch.stack([onehot_ok[None].expand(W, F, B), ok_lo & many_ok,
                      ok_hi & many_ok])
    R = pst - L
    if mn is None:
        g = _split_gain(L[..., 0], L[..., 1] + EPS, R[..., 0],
                        R[..., 1] + EPS, l1, l2c, mds)
    else:
        g = torch.stack([
            _split_gain(L[i, ..., 0], L[i, ..., 1] + EPS, R[i, ..., 0],
                        R[i, ..., 1] + EPS, l1, l2c, mds, first, mn, mx)
            for i, first in enumerate(_CLIP_FUSION[site][2:])])
    g = g - gshift
    md = max(p.min_data_in_leaf, 1)
    msh = p.min_sum_hessian_in_leaf
    # (made on the device: a captured graph holds no host copy)
    group = (torch.arange(3, device=dev) > 0).to(hist.dtype).view(
        3, 1, 1, 1) * p.min_data_per_group
    ok = ok & (torch.minimum(L[..., 2], R[..., 2]) >=
               torch.clamp(group, min=md)) & \
        (L[..., 1] >= msh) & (R[..., 1] >= msh)
    cat1, g_lo, g_hi = torch.where(ok, g, torch.full_like(g, NEG_INF))
    many = torch.maximum(g_lo, g_hi)
    from_low = g_lo >= g_hi
    gain = _penalize(torch.maximum(cat1, many), penalty)
    onehot = cat1 >= many
    gain = torch.where((is_cat & feature_mask)[None, :, None], gain,
                       torch.full_like(gain, NEG_INF))
    best_pf, best_j = torch.max(gain, dim=2)               # first max
    f_star = torch.argmax(best_pf, dim=1)                  # (W,)
    w_idx = torch.arange(W, device=dev)
    j_star = best_j[w_idx, f_star]
    oh = onehot[w_idx, f_star, j_star]
    lo = from_low[w_idx, f_star, j_star]
    left_stats = torch.where(
        oh[:, None], hv[w_idx, f_star, j_star],
        torch.where(lo[:, None], L_lo[w_idx, f_star, j_star],
                    L_hi[w_idx, f_star, j_star]))
    # each bin's position in its leaf's sort
    rank = torch.empty_like(order).scatter_(
        2, order, jidx.expand(W, F, B).contiguous())
    rank_f = rank[w_idx, f_star]                           # (W, B)
    many_mask = torch.where(lo[:, None], rank_f <= j_star[:, None],
                            rank_f > j_star[:, None]) & valid[w_idx, f_star]
    left_mask = torch.where(oh[:, None], jidx[None, :] == j_star[:, None],
                            many_mask)
    return {
        "gain": best_pf[w_idx, f_star],
        "feature": f_star.to(torch.int32),
        "threshold": j_star.to(torch.int32),
        "default_left": torch.zeros(W, dtype=torch.bool, device=dev),
        "left_stats": left_stats,
        "left_mask": left_mask,
    }


def merge_records(num: dict, cat: dict) -> dict:
    """One record from the numerical scan's and the categorical scan's,
    in the JAX package's first-max order over all features: the larger
    gain wins, an equal gain goes to the lower feature.  Adds ``is_cat``
    (W,) bool."""
    take = (cat["gain"] > num["gain"]) | \
        ((cat["gain"] == num["gain"]) & (cat["feature"] < num["feature"]))
    out = {}
    for k, v in num.items():
        t = take.reshape((-1,) + (1,) * (v.dim() - 1))
        out[k] = torch.where(t, cat[k], v)
    out["is_cat"] = take
    return out


def depth_limit(rec: dict, depth, max_depth: int) -> dict:
    """Gain NEG_INF where ``depth >= max_depth > 0``: no split where the
    children would pass ``max_depth``."""
    if max_depth > 0 and depth is not None:
        rec["gain"] = torch.where(depth < max_depth, rec["gain"],
                                  torch.full_like(rec["gain"], NEG_INF))
    return rec


def _record(gain, L, dirl, thr, num_bins, has_missing, feature_mask,
            B: int) -> dict:
    """The split record of the best candidate of each leaf: candidates
    (W, F, K) with their gains, left stats, default directions and
    threshold bins; the first maximum over candidates, then over
    features.  The left mask holds the value bins up to the threshold
    and, for a default-left split, the feature's missing bin."""
    W, F, _ = gain.shape
    dev = gain.device
    gain = torch.where(feature_mask[None, :, None], gain,
                       torch.full_like(gain, NEG_INF))
    best_pf, best_k = torch.max(gain, dim=2)               # first max
    f_star = torch.argmax(best_pf, dim=1)                  # (W,) first max
    w_idx = torch.arange(W, device=dev)
    k_star = best_k[w_idx, f_star]
    j_star = thr[w_idx, f_star, k_star].to(torch.int64)
    dl = dirl[w_idx, f_star, k_star]
    nb_f = num_bins.to(torch.int64)[f_star]
    hm_f = has_missing[f_star]
    jidx = torch.arange(B, device=dev)
    left_mask = (jidx[None, :] <= j_star[:, None]) & \
        (jidx[None, :] < (nb_f - hm_f.to(torch.int64))[:, None])
    left_mask = left_mask | (dl[:, None] & hm_f[:, None] &
                             (jidx[None, :] == nb_f[:, None] - 1))
    return {
        "gain": best_pf[w_idx, f_star],
        "feature": f_star.to(torch.int32),
        "threshold": j_star.to(torch.int32),
        "default_left": dl,
        "left_stats": L[w_idx, f_star, k_star],
        "left_mask": left_mask,
    }


# ---- coarse-to-fine split search --------------------------------------
#
# The c2f scans of ``lightgbm_tpu/ops/split.py:355-550``, batched over a
# leading dimension of leaves where the JAX package vmaps one leaf.  They
# are XLA there, not Pallas, so plain tensor code is their port.  A leaf's
# coarse histogram (F, Bc, 3) holds the fine bins collapsed 2^shift-to-1,
# with the LAST slot reserved for the feature's missing bin when the
# dataset has missing values; its window (F, R, 3) holds the R = 2 << shift
# fine bins from ``win_lo[f]`` on.  Candidates are the coarse boundaries
# and the fine thresholds inside the window.


def _c2f_miss(coarse, missing_type, p: SplitParams):
    """(value slots (W, F, Bcv, 3), missing-bin stats (W, F, 3) or None,
    no missing rows (W, F) or None) of coarse histograms (W, F, Bc, 3)
    (``_c2f_miss``, :373-388); under the counts proxy ``no_miss`` reads
    the hess copy, as every count test does."""
    if not p.any_missing:
        return coarse, None, None
    has = (missing_type != 0).to(coarse.dtype)
    miss = coarse[:, :, -1, :] * has[None, :, None]
    return coarse[:, :, :-1, :], miss, miss[..., 2] <= 0


def _nv_missing(num_bins, missing_type, p: SplitParams):
    """(value bins, has a missing bin) per feature."""
    if p.any_missing:
        has = missing_type != 0
        return num_bins.to(torch.int64) - has.to(torch.int64), has
    return num_bins.to(torch.int64), torch.zeros_like(num_bins,
                                                      dtype=torch.bool)


def _c2f_coarse_scan(coarse, parent, num_bins, missing_type,
                     p: SplitParams, shift: int, monotone=None, bounds=None,
                     site=None):
    """Gains at the coarse boundaries (``_c2f_coarse_scan``, :391-432) ->
    (gains (W, F, Bcv), left stats (W, F, Bcv, 3), fine thresholds
    (Bcv,), default left (W, F, Bcv)); boundary ``c`` is the fine
    threshold ``((c + 1) << shift) - 1``.  ``monotone``/``bounds``/``site``:
    as :func:`find_best_split_plain`'s.  The first products are fused, as
    in :func:`choose_window`'s scan (``site`` None) at every site; under
    the clip the split search's own coarse scan fuses the second products
    at a wave's children, the default-left one's at the root."""
    lane = lane_scalars(parent, p)
    pst = lane[:, None, None, :3]
    gshift = lane[:, 3][:, None, None]
    mn, mx = _lane_bounds(bounds)
    vals, miss, no_miss = _c2f_miss(coarse, missing_type, p)
    Bcv = vals.shape[2]
    nv, _ = _nv_missing(num_bins, missing_type, p)
    thr = ((torch.arange(Bcv, device=coarse.device) + 1) << shift) - 1
    ok = (thr[None, :] <= nv[:, None] - 2)[None]
    right, left = True, True
    if mn is not None and site is not None:
        right, left = _CLIP_FUSION[site][:2]
    g, L, dirl = _scan_both(prefix_sum(vals, dim=2), miss, no_miss, pst,
                            gshift, ok, p, left_fuse_first=left, mn=mn,
                            mx=mx, mono=_mono_col(monotone),
                            right_fuse_first=right)
    return g, L, thr, dirl


def choose_window(coarse: torch.Tensor, parent: torch.Tensor,
                  num_bins: torch.Tensor, missing_type: torch.Tensor,
                  p: SplitParams, shift: int, monotone=None,
                  bounds=None) -> torch.Tensor:
    """Refine-window starts (W, F) int32, fine-bin ids aligned to coarse
    bins: the two coarse bins straddling each feature's best coarse
    boundary (``choose_window``, :435-447), under the monotone
    constraints and bounds when given (no penalty)."""
    g, _, _, _ = _c2f_coarse_scan(coarse, parent, num_bins, missing_type, p,
                                  shift, monotone, bounds)
    c_star = torch.argmax(g, dim=2)                        # first max
    win_c = c_star.clamp(0, max(g.shape[2] - 2, 0))
    return (win_c << shift).to(torch.int32)


def find_best_split_c2f(coarse: torch.Tensor, win: torch.Tensor,
                        win_lo: torch.Tensor, parent: torch.Tensor,
                        num_bins: torch.Tensor, missing_type: torch.Tensor,
                        feature_mask: torch.Tensor, p: SplitParams,
                        shift: int, monotone=None, penalty=None,
                        bounds=None, site: str = ROOT) -> dict:
    """Best split of each of a batch of W leaves from its coarse
    histogram and refine window (``find_best_split_c2f``, :450-550).

    coarse (W, F, Bc, 3), win (W, F, R, 3) dequantized; win_lo (W, F)
    int32; parent (W, 3).  The record is :func:`find_best_split_plain`'s.
    A fine threshold's left side is the coarse prefix before the window
    plus the window's own prefix; the candidates are the coarse
    boundaries, then the window's thresholds, and the first maximum wins,
    so a threshold in both halves is taken from the coarse one on a tie.
    The constraints are :func:`find_best_split_plain`'s; the penalty
    scales the coarse and the fine gains alike.
    """
    W, F, R, _ = win.shape
    g_c, L_c, thr_c, dirl_c = _c2f_coarse_scan(coarse, parent, num_bins,
                                               missing_type, p, shift,
                                               monotone, bounds, site)
    lane = lane_scalars(parent, p)
    pst = lane[:, None, None, :3]
    gshift = lane[:, 3][:, None, None]
    mn, mx = _lane_bounds(bounds)
    vals_c, miss, no_miss = _c2f_miss(coarse, missing_type, p)
    nv, has_missing = _nv_missing(num_bins, missing_type, p)
    cum_c = prefix_sum(vals_c, dim=2)
    cpad = torch.cat([cum_c.new_zeros(W, F, 1, 3), cum_c], dim=2)
    win_c0 = (win_lo.to(torch.int64) >> shift)[..., None, None]
    base = cpad.gather(2, win_c0.expand(W, F, 1, 3))       # (W, F, 1, 3)
    Lf_base = base + prefix_sum(win, dim=2)
    thr_f = win_lo.to(torch.int64)[..., None] + \
        torch.arange(R, device=win.device)                  # (W, F, R)
    ok_f = thr_f <= nv[None, :, None] - 2
    right, left = (True, not (p.counts_proxy and R > _CHUNK)) if mn is None \
        else _CLIP_FUSION[site][:2]
    g_f, L_f, dirl_f = _scan_both(
        Lf_base, miss, no_miss, pst, gshift, ok_f, p, left_fuse_first=left,
        mn=mn, mx=mx, mono=_mono_col(monotone), right_fuse_first=right)
    Bcv = g_c.shape[2]
    return _record(_penalize(torch.cat([g_c, g_f], dim=2), penalty),
                   torch.cat([L_c, L_f], dim=2),
                   torch.cat([dirl_c, dirl_f], dim=2),
                   torch.cat([thr_c.expand(W, F, Bcv), thr_f], dim=2),
                   num_bins, has_missing, feature_mask, p.max_bin)


def find_best_split(hist: torch.Tensor, parent: torch.Tensor,
                    num_bins: torch.Tensor, missing_type: torch.Tensor,
                    feature_mask: torch.Tensor, p: SplitParams,
                    depth=None, max_depth: int = 0, is_cat=None,
                    monotone=None, penalty=None, bounds=None,
                    site: str = ROOT) -> dict:
    """Best split for a batch of W leaves, as :func:`find_best_split_plain`.
    CUDA tensors go to kernel S: one launch for the batch, which computes
    the lane scalars and the depth limit itself, into one buffer (calls on
    one stream share its completion counters, and so run in stream
    order); CPU tensors to the plain version.  With ``p.any_cat`` kernel S
    scans the numerical features, :func:`categorical_split` the
    categorical ones, and :func:`merge_records` joins them, then the
    depth limit.  ``monotone``, ``penalty``, ``bounds`` and ``site`` (the
    constraints of :func:`find_best_split_plain`) reach kernel S's
    constrained mode."""
    cons = dict(monotone=monotone, penalty=penalty, bounds=bounds, site=site)
    if hist.device.type == "cpu":
        return find_best_split_plain(hist, parent, num_bins, missing_type,
                                     feature_mask, p, depth, max_depth,
                                     is_cat, **cons)
    if p.any_cat:
        if is_cat is None or is_cat.shape != feature_mask.shape or \
                is_cat.dtype != torch.bool:
            raise ValueError("any_cat needs is_cat, bool like feature_mask")
        num = _best_split_kernel(hist, parent, num_bins, missing_type,
                                 feature_mask & ~is_cat, p, None, 0, **cons)
        rec = merge_records(num, categorical_split(
            hist, parent, num_bins, missing_type, is_cat, feature_mask, p,
            penalty, bounds, site))
        return depth_limit(rec, depth, max_depth)
    return _best_split_kernel(hist, parent, num_bins, missing_type,
                              feature_mask, p, depth, max_depth, **cons)


def _best_split_kernel(hist, parent, num_bins, missing_type, feature_mask,
                       p: SplitParams, depth, max_depth: int, monotone=None,
                       penalty=None, bounds=None, site: str = ROOT) -> dict:
    """Kernel S's launch for :func:`find_best_split`; each constraint given
    turns on its part of the kernel's constrained mode."""
    W, F, B, C = hist.shape
    if C != 3 or hist.dtype != torch.float32 or not hist.is_contiguous():
        raise ValueError("hist must be contiguous float32 (W, F, B, 3)")
    if parent.shape != (W, 3) or parent.dtype != torch.float32 or \
            not parent.is_contiguous():
        raise ValueError("parent must be contiguous float32 (W, 3)")
    for name, t, shape, dtype in (
            ("num_bins", num_bins, (F,), torch.int32),
            ("missing_type", missing_type, (F,), torch.int32),
            ("monotone", monotone, (F,), torch.int32),
            ("penalty", penalty, (F,), torch.float32),
            ("bounds", bounds, (W, 2), torch.float32)):
        if t is not None and (t.shape != shape or t.dtype != dtype or
                              not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dtype} {shape}")
    if (monotone is None) != (bounds is None):
        raise ValueError("monotone and bounds come together")
    if feature_mask.shape != (F,) or feature_mask.dtype != torch.bool:
        raise ValueError(f"feature_mask must be bool ({F},)")
    if depth is not None and (depth.dim() != 1 or
                              depth.shape[0] not in (1, W) or
                              depth.dtype != torch.int32):
        raise ValueError(f"depth must be int32 ({W},) or (1,)")
    dev = hist.device
    if any(t is not None and t.device != dev for t in
           (parent, num_bins, missing_type, feature_mask, depth, monotone,
            penalty, bounds)):
        raise ValueError("all inputs must be on one device")
    lib = kernels.load()
    fmask = feature_mask.contiguous()
    rec, part = _record_views(W, F, B, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.ltt_best_split(
        hist.data_ptr(), parent.data_ptr(), num_bins.data_ptr(),
        missing_type.data_ptr(), fmask.data_ptr(), ptr(depth),
        0 if depth is None or depth.shape[0] == 1 else depth.stride(0),
        max_depth, ptr(monotone), ptr(penalty), ptr(bounds),
        _KERNEL_FUSION[site], W, F, B,
        p.lambda_l1, p.lambda_l2, p.max_delta_step,
        float(max(p.min_data_in_leaf, 1)),
        max(p.min_sum_hessian_in_leaf, EPS) if p.counts_proxy
        else p.min_sum_hessian_in_leaf, p.min_gain_to_split,
        int(p.any_missing), int(p.counts_proxy), part.data_ptr(),
        done_counters(W, dev, stream).data_ptr(), rec["gain"].data_ptr(),
        rec["left_stats"].data_ptr(), rec["feature"].data_ptr(),
        rec["threshold"].data_ptr(), rec["default_left"].data_ptr(),
        rec["left_mask"].data_ptr(), stream)
    kernels.check(rc, "kernel S (ltt_best_split)")
    constrained = monotone is not None or penalty is not None
    LAUNCHES["best_split_constrained" if constrained else "best_split"] += 1
    return rec
