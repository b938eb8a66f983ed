"""Per-leaf histograms: ``[sum_grad, sum_hess, count]`` per (feature, bin).

Counterpart of ``lightgbm_tpu/ops/histogram.py``.  Each TPU kernel
becomes a hand-written CUDA kernel behind a wrapper, with a plain
PyTorch version beside it:

- ``histogram_pallas`` (:238) -> kernel H (``csrc/histogram.cu``) through
  :func:`masked_histogram`, the leaf mask fused in (the JAX growth loop's
  ``masked_hist``, ``lightgbm_tpu/ops/grow.py:529-533``); plain version
  :func:`masked_histogram_plain` over :func:`histogram_plain`
  (``histogram_segsum``, :64);
- ``histogram_pallas_multi`` (:396) -> kernel M (``csrc/multi_hist.cu``)
  through :func:`multi_histogram`, at full resolution or coarse
  (``shift``, ``miss_bin``); plain version
  :func:`multi_histogram_plain` (``histogram_segsum_multi``, :528);
- ``histogram_pallas_multi_routed`` (:872, mode "small") -> kernel R
  (``csrc/routed_hist.cu``) through
  :func:`routed_histogram`, full or coarse; plain version
  :func:`routed_histogram_plain` (``histogram_segsum_multi_routed``,
  :1013);
- ``histogram_pallas_multi_win`` (:628) -> kernel V
  (``csrc/window_hist.cu``) through :func:`window_histogram`, up to 128
  subsets; plain
  version :func:`window_histogram_plain` (``histogram_segsum_multi_win``,
  :1269);
- ``histogram_pallas_multi_win_lanes`` (:1113) -> kernel V-lanes
  (``csrc/window_hist.cu``) through :func:`lanes_window_histogram`, up to
  128 lanes; plain version :func:`lanes_window_histogram_plain`
  (``histogram_segsum_multi_win_lanes``, :1186);
- ``leaf_stats_pallas`` (:1239) -> kernel Q (``csrc/leaf_stats.cu``)
  through :func:`leaf_stats`; plain version :func:`leaf_stats_plain`
  (the ``histogram(leaf_idx ...)`` fallback,
  ``lightgbm_tpu/ops/grow.py:1787-1790``).

Kernels R, M, V and V-lanes share one accumulation body over 16-row
groups (``csrc/group_hist.cuh``, launch plan :func:`group_plan`); kernel Q
sums in its fixed point (launch plan :func:`leaf_plan`).

Float values are summed in float64 (H and the plain versions) or in a
column fixed point about as fine (R, M, V, V-lanes, Q) and rounded once to
float32, so a kernel, the plain version on the card and the plain version
on the CPU agree while the sums are exact, and within one float32
rounding otherwise (the JAX reference sums in float32; the parity tests
state the tolerance that follows).  Quantized (integer) values are summed
exactly everywhere.  CPU tensors take the plain version; CUDA tensors
launch the kernel or raise.
"""
from __future__ import annotations

import torch

from . import kernels

__all__ = ["histogram_plain", "masked_histogram_plain", "masked_histogram",
           "masked_histogram_plan", "hist_plan", "multi_width",
           "multi_histogram_plain", "multi_histogram",
           "routed_histogram_plain", "routed_histogram",
           "group_smem", "group_plan",
           "window_histogram_plain", "window_histogram",
           "lanes_window_histogram_plain", "lanes_window_histogram",
           "lanes_window_plan",
           "leaf_smem", "leaf_plan", "LEAF_MAX", "leaf_stats_plain",
           "leaf_stats", "LAUNCHES"]

# kernel launches through the wrappers below, one per call: H
# (masked_histogram), M (multi_histogram), R (routed_histogram), V
# (window_histogram), V-lanes (lanes_window_histogram) and Q (leaf_stats)
LAUNCHES = {"histogram": 0, "multi_histogram": 0, "routed_histogram": 0,
            "window_histogram": 0, "lanes_window_histogram": 0,
            "leaf_stats": 0}

_SMEM_MAX = 232_448        # the most dynamic shared memory a block can have

# kernel H's launch constants (csrc/histogram.cu)
HIST_CHUNK = 8_192         # rows a block compacts at once (8 a thread)
HIST_BATCH = 1_024         # queued rows staged at once
HIST_CLUSTER = 8           # blocks whose tiles are summed on chip
# the queue (a chunk and a carried part batch, uint32), the staged values
# (3 x float32 a row) and the warp counts
HIST_FIXED_SMEM = (HIST_CHUNK + HIST_BATCH) * 4 + HIST_BATCH * 12 + 33 * 4
_ACTIVE_CLUSTERS: dict = {}


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


def hist_plan(F: int, B: int, n: int, sms: int, active=None) -> dict:
    """Kernel H's launch plan on a card with ``sms`` multiprocessors that
    runs ``active`` of its clusters at once (default ``sms // 8``, the
    most it could; the wrapper asks the card).

    A block holds a (features, B, 3) float64 tile of its feature chunk
    beside the fixed queue and staging buffers; the grid is
    ``(row_blocks, chunks)`` with ``row_blocks`` a multiple of the
    cluster size, one wave of clusters, and no more clusters than the
    rows fill at one compaction chunk a block.  Row block ``i`` owns rows
    ``[i * rows_per_block, min((i + 1) * rows_per_block, n))``, feature
    chunk ``j`` features ``[j * fc, min((j + 1) * fc, F))``."""
    fc = min(F, (_SMEM_MAX - HIST_FIXED_SMEM) // (B * 3 * 8))
    if fc < 1:
        raise ValueError(f"kernel H holds one feature's {B} bins in shared "
                         f"memory: at most "
                         f"{(_SMEM_MAX - HIST_FIXED_SMEM) // 24} bins")
    chunks = -(-F // fc)
    if active is None:
        active = sms // HIST_CLUSTER
    clusters = max(1, min(active // chunks,
                          -(-n // (HIST_CLUSTER * HIST_CHUNK))))
    row_blocks = clusters * HIST_CLUSTER
    per_block = -(-n // row_blocks)
    rows_per_block = -(-per_block // 16) * 16     # 16-row aligned ranges
    return {"fc": fc, "chunks": chunks, "clusters": clusters,
            "row_blocks": row_blocks, "rows_per_block": rows_per_block,
            "nbits": max(1, (B - 1).bit_length()),
            "smem": fc * B * 3 * 8 + HIST_FIXED_SMEM}


def _active_clusters(lib, device, bin_bytes, idx_bytes, smem) -> int:
    """Clusters of kernel H the card runs at once, asked once."""
    key = (torch.device(device).index, bin_bytes, idx_bytes, smem)
    if key not in _ACTIVE_CLUSTERS:
        got = lib.ltt_hist_active_clusters(bin_bytes, idx_bytes, smem)
        if got < 1:
            raise RuntimeError(f"kernel H: no cluster of {HIST_CLUSTER} "
                               f"blocks with {smem} bytes of shared memory "
                               f"fits the card (occupancy query gave {got})")
        _ACTIVE_CLUSTERS[key] = got
    return _ACTIVE_CLUSTERS[key]


def masked_histogram_plan(bins: torch.Tensor, leaf_idx: torch.Tensor,
                          max_bin: int) -> dict:
    """Kernel H's launch plan for these operands on their card, whose
    active clusters are asked once (a graph capture asks first)."""
    F, n = bins.shape
    lib = kernels.load()
    sms = kernels.sm_count(bins.device)
    smem = hist_plan(F, max_bin, n, sms)["smem"]
    return hist_plan(F, max_bin, n, sms, _active_clusters(
        lib, bins.device, bins.element_size(), leaf_idx.element_size(), smem))


def masked_histogram(bins: torch.Tensor, grad: torch.Tensor,
                     hess: torch.Tensor, mask: torch.Tensor,
                     leaf_idx: torch.Tensor, leaf_id: torch.Tensor,
                     max_bin: int) -> torch.Tensor:
    """Masked leaf histogram, (F, B, 3) float32.

    bins (F, N) uint8/int16; grad/hess/mask (N,) float32; leaf_idx (N,)
    uint8/int32; leaf_id a 0-dim int32 tensor on the same device (read by
    the kernel, so choosing the leaf needs no host sync).  CUDA tensors
    go to kernel H, whose work follows the leaf's rows (it compacts them
    in the kernel) and whose sums are the same bits on every launch; CPU
    tensors go to :func:`masked_histogram_plain`."""
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
    if leaf_idx.data_ptr() % 16:
        leaf_idx = leaf_idx.clone()        # the kernel loads aligned words
    lib = kernels.load()
    plan = masked_histogram_plan(bins, leaf_idx, max_bin)
    partial = torch.empty(plan["clusters"] * F * max_bin * 3,
                          dtype=torch.float64, device=bins.device)
    out = torch.empty(F, max_bin, 3, dtype=torch.float32, device=bins.device)
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    rc = lib.ltt_hist_masked(
        bins.data_ptr(), bins.element_size(), grad.data_ptr(),
        hess.data_ptr(), mask.data_ptr(), leaf_idx.data_ptr(),
        leaf_idx.element_size(), leaf_id.data_ptr(), n, F, max_bin,
        plan["fc"], plan["row_blocks"], plan["rows_per_block"],
        plan["nbits"], partial.data_ptr(), out.data_ptr(), stream)
    kernels.check(rc, "kernel H (ltt_hist_masked)")
    LAUNCHES["histogram"] += 1
    return out


# ---- batched passes: kernels M, R, V and V-lanes -----------------------

_MAX_LANES = 64


def multi_width(quantized: bool, two_col: bool = False) -> int:
    """Subsets per batched pass (``lightgbm_tpu/ops/histogram.py:54``):
    21 float, 42 quantized, 64 two-column quantized."""
    if two_col:
        return 64
    return 42 if quantized else 21


def _subset_sums(sel, vals, width, F, nbins, two_col, cell_of):
    """(W, F, nbins, 3) float32 sums of ``vals`` over the rows with
    ``sel >= 0``: ``cell_of(f, s, keep)`` gives each kept row's bin in
    feature ``f``, or ``nbins`` for a row that adds nowhere.  Float64
    ``index_add_`` (exact on integers), one rounding; with ``two_col``
    only grad and hess are summed and the count channel is a hess copy."""
    cols = 2 if two_col else 3
    keep = torch.nonzero(sel >= 0).squeeze(1)
    s = sel.index_select(0, keep).to(torch.int64)
    v = vals[:, :cols].index_select(0, keep).to(torch.float64)
    slots = nbins + 1
    out = torch.zeros(width * F * slots, cols, dtype=torch.float64,
                      device=vals.device)
    for f in range(F):
        out.index_add_(0, (s * F + f) * slots + cell_of(f, s, keep), v)
    out = out.to(torch.float32).reshape(width, F, slots, cols)[:, :, :nbins]
    if two_col:
        out = torch.cat([out, out[..., 1:2]], dim=-1)
    return out.contiguous()


def multi_histogram_plain(bins: torch.Tensor, vals: torch.Tensor,
                          sel: torch.Tensor, max_bin: int, width: int,
                          two_col: bool = False, shift: int = 0,
                          miss_bin=None) -> torch.Tensor:
    """Histograms of ``width`` row-disjoint subsets -> (W, F, B, 3)
    float32 — plain PyTorch.

    bins (F, N); vals (N, C) float32 or int8, C >= 3 (C >= 2 with
    ``two_col``); sel (N,) subset id per row, -1 = none.  With
    ``two_col`` only grad and hess are summed and the count channel is a
    copy of hess.  With ``shift`` > 0 the fine bins collapse
    ``2^shift``-to-1 and ``max_bin`` is the coarse bin count; ``miss_bin``
    (F,) int32 (-1 = none, read only with a shift) sends a row at its
    feature's missing bin to the reserved last coarse slot
    ``max_bin - 1``.  Sums in float64 (exact on integers), one
    rounding."""
    F = bins.shape[0]
    mb = miss_bin.to(torch.int64) if shift and miss_bin is not None else None

    def cell_of(f, s, keep):
        b = bins[f].index_select(0, keep).to(torch.int64)
        if not shift:
            return b
        cb = b >> shift
        return cb if mb is None else torch.where(b == mb[f], max_bin - 1, cb)

    return _subset_sums(sel, vals, width, F, max_bin, two_col, cell_of)


def window_histogram_plain(bins: torch.Tensor, vals: torch.Tensor,
                           sel: torch.Tensor, win_lo: torch.Tensor,
                           r_bins: int, width: int, two_col: bool = False,
                           miss_bin=None) -> torch.Tensor:
    """Windowed histograms of ``width`` row-disjoint subsets -> (W, F, R,
    3) float32 — plain PyTorch.  Per (subset, feature) only the fine bins
    in ``[win_lo[s, f], win_lo[s, f] + r_bins)`` count, at relative
    positions; with ``miss_bin`` (F,) int32 (-1 = none) a row at its
    feature's missing bin is left out.  Otherwise as
    :func:`multi_histogram_plain`."""
    F = bins.shape[0]
    lo = win_lo.to(torch.int64)

    def cell_of(f, s, keep):
        b = bins[f].index_select(0, keep).to(torch.int64)
        rb = b - lo[:, f].index_select(0, s)
        ok = (rb >= 0) & (rb < r_bins)
        if miss_bin is not None:
            ok = ok & (b != miss_bin[f])
        return torch.where(ok, rb, torch.full_like(rb, r_bins))

    return _subset_sums(sel, vals, width, F, r_bins, two_col, cell_of)


def _lanes_of(leaf_idx: torch.Tensor, lane_ids: torch.Tensor,
              width: int) -> torch.Tensor:
    """(N,) lane of each row, -1 = none: the lane whose id equals the
    row's leaf id, compared in int64 (the last matching lane wins)."""
    li = leaf_idx.to(torch.int64)
    ids = lane_ids.to(torch.int64)
    lane = torch.full_like(li, -1)
    for w in range(width):
        lane = torch.where(li == ids[w], torch.full_like(lane, w), lane)
    return lane


def lanes_window_histogram_plain(bins: torch.Tensor, vals: torch.Tensor,
                                 leaf_idx: torch.Tensor,
                                 lane_ids: torch.Tensor,
                                 win_lo: torch.Tensor, r_bins: int,
                                 width: int, two_col: bool = False,
                                 miss_bin=None) -> torch.Tensor:
    """:func:`window_histogram_plain` with a row's subset the lane whose
    child-leaf id ``lane_ids[w]`` equals its leaf id — plain PyTorch."""
    sel = _lanes_of(leaf_idx, lane_ids, width).to(torch.int32)
    return window_histogram_plain(bins, vals, sel, win_lo, r_bins, width,
                                  two_col, miss_bin)


def _check_multi_inputs(bins, vals, two_col, width, *others,
                        max_width=_MAX_LANES):
    """Checks of the batched wrappers: types, shapes, the lane count,
    contiguity and one device for ``bins``, ``vals`` and ``others``
    (tensors or None).  Whether a tile fits shared memory is the launch
    plan's check."""
    F, n = bins.shape
    if bins.dtype not in (torch.uint8, torch.int16):
        raise TypeError(f"bins must be uint8/int16, got {bins.dtype}")
    if vals.dtype not in (torch.int8, torch.float32) or vals.dim() != 2 or \
            vals.shape[0] != n or vals.shape[1] < (2 if two_col else 3):
        raise ValueError("vals must be int8/float32 (N, 3), or (N, 2) with "
                         "two_col")
    if not 1 <= width <= max_width:
        raise ValueError(f"width must be in [1, {max_width}]")
    if not (bins.is_contiguous() and vals.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    if any(x is not None and x.device != bins.device
           for x in (vals,) + others):
        raise ValueError("all inputs must be on one device")
    return F, n


def _narrow_sel(sel, n):
    """The selector of kernels M and V as the int8 operand of the shared
    body, 16-byte aligned: an int32 selector is narrowed (one more
    launch).  Its ids must lie in [-1, width); they are not read (a check
    would wait on the card), and an id of 128 or more would wrap."""
    if sel.dtype not in (torch.int32, torch.int8) or sel.shape != (n,) or \
            not sel.is_contiguous():
        raise ValueError("sel must be contiguous int32/int8 (N,)")
    if sel.dtype == torch.int32:
        sel = sel.to(torch.int8)           # ids in [-1, width): exact
    return _aligned(sel)


def _check_leaf_idx(leaf_idx, n, leaf_bound):
    """The leaf vector's checks; returns the bound below every leaf id
    (256 for uint8)."""
    if leaf_idx.dtype not in (torch.uint8, torch.int32) or \
            leaf_idx.shape != (n,) or not leaf_idx.is_contiguous():
        raise ValueError("leaf_idx must be contiguous uint8/int32 (N,)")
    if leaf_idx.dtype == torch.uint8:
        leaf_bound = 256
    if not 1 <= leaf_bound <= 32768:
        raise ValueError("leaf_bound must be in [1, 32768]")
    return leaf_bound


def _check_miss_bin(miss_bin, F):
    """``miss_bin`` contiguous, or None."""
    if miss_bin is None:
        return None
    if miss_bin.dtype != torch.int32 or miss_bin.shape != (F,):
        raise ValueError(f"miss_bin must be int32 ({F},)")
    return miss_bin.contiguous()


def _check_win_lo(win_lo, width, F):
    if win_lo.dtype != torch.int32 or win_lo.shape != (width, F):
        raise ValueError(f"win_lo must be int32 ({width}, {F})")
    return win_lo.contiguous()


def _partial(rb, F, width, nbins, two_col, vals):
    """Per-row-block partials: int32 for int8 values, float64 else."""
    return torch.empty(rb * F * width * nbins * (2 if two_col else 3),
                       dtype=torch.int32 if vals.dtype == torch.int8
                       else torch.float64, device=vals.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


# the launch constants of the body shared by kernels R, M and V-lanes
# (csrc/group_hist.cuh)
ROUTED_GROUP = 16               # consecutive rows a thread takes at once
ROUTED_SM_SMEM = 233_472        # shared memory of one SM (228 KB)
_BLOCK_RESERVED_SMEM = 1_024    # shared memory the card keeps per block
_MAX_GROUP_LANES = 128          # lanes of one call (int8 lane ids)
_GROUP_PLANS: dict = {}


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def group_threads(acc_bytes: int) -> int:
    """Threads a block of the shared body: 1024 with int8 values (4-byte
    cells), 512 with float values (12-byte cells)."""
    return 1024 if acc_bytes == 4 else 512


def group_smem(fpb: int, W: int, B: int, cols: int, acc_bytes: int,
               member_bytes: int = 0, map_words: int = 1) -> int:
    """Shared memory a block of the shared body: ``fpb`` features' (W, B,
    cols) tiles (``acc_bytes`` a cell: 4, an int32, for
    int8 values; 12, an int64 and a uint32 word, for float values), the
    membership's table (``member_bytes``: V-lanes' leaf -> lane table) and
    the bin map's ``map_words`` int32 words a feature (1: the missing bin;
    V-lanes 1 + W: and the window starts)."""
    cells = fpb * W * B * cols
    tiles = _align16(cells * 4) if acc_bytes == 4 else \
        _align16(cells * 8) + _align16(cells * 4)
    return tiles + _align16(member_bytes) + _align16(fpb * 4 * map_words)


def routed_row_cap(acc_bytes: int) -> int:
    """The shared body's most rows a block: no int32 partial of int8
    values, and no uint32 low word of float values (10 bits a row), can
    overflow."""
    return 1 << 24 if acc_bytes == 4 else 1 << 22


def group_plan(F: int, B: int, W: int, cols: int, acc_bytes: int, n: int,
               sms: int, per_sm=None, member_bytes: int = 0,
               map_words: int = 1) -> dict:
    """The launch plan of the shared body on a card with ``sms``
    multiprocessors that runs ``per_sm`` of its blocks at once on each
    (default: the most the threads and shared memory allow; the wrappers
    ask the card).  ``member_bytes`` and ``map_words`` as in
    :func:`group_smem`.

    A block holds the tiles of ``fpb`` features: as many as leave room for
    two blocks an SM, and one where a tile is larger.  The features split
    into ``groups`` of near-equal size; the grid is ``(groups,
    row_blocks)``, one wave of the blocks the card runs at once, no more
    row blocks than give every thread a 16-row group, and at most
    :func:`routed_row_cap` rows a block.  Row block ``i`` owns rows ``[i *
    rows_per_block, min((i + 1) * rows_per_block, n))``,
    ``rows_per_block`` a multiple of 16; feature group ``j`` features
    ``[j * fpb, min((j + 1) * fpb, F))``."""
    tile = W * B * cols * acc_bytes
    kw = dict(member_bytes=member_bytes, map_words=map_words)
    if group_smem(1, W, B, cols, acc_bytes, **kw) > _SMEM_MAX:
        raise ValueError(f"one feature's (W={W}, B={B}) tile needs {tile} "
                         f"bytes of shared memory (at most {_SMEM_MAX})")
    budget = ROUTED_SM_SMEM // 2 - _BLOCK_RESERVED_SMEM - 32 - \
        _align16(member_bytes)
    fpb = max(1, min(F, budget // (tile + 4 * map_words)))
    groups = -(-F // fpb)
    fpb = -(-F // groups)
    smem = group_smem(fpb, W, B, cols, acc_bytes, **kw)
    threads = group_threads(acc_bytes)
    if per_sm is None:
        per_sm = max(1, min(2048 // threads, ROUTED_SM_SMEM //
                            (smem + _BLOCK_RESERVED_SMEM)))
    n = max(n, 1)
    rb = max(1, per_sm * sms // groups)
    rb = min(rb, -(-n // (threads * ROUTED_GROUP)))  # a group a thread
    rb = max(rb, -(-n // routed_row_cap(acc_bytes)))
    rows_per_block = _align16(-(-n // rb))
    rb = -(-n // rows_per_block)
    return {"fpb": fpb, "groups": groups, "row_blocks": rb,
            "rows_per_block": rows_per_block, "smem": smem}


def _asked_plan(name, key, device, query, plan_of) -> dict:
    """``plan_of(sms, per_sm)`` with the blocks an SM runs at once asked of
    the card (``query(smem)``, the smem of ``plan_of(sms, None)``), once
    per kernel ``name`` and ``key`` (what selects its instantiation, and
    its shape)."""
    key = (name, key, torch.device(device).index)
    plan = _GROUP_PLANS.get(key)
    if plan is None:
        sms = kernels.sm_count(device)
        smem = plan_of(sms, None)["smem"]
        got = query(smem)
        if got < 1:
            raise RuntimeError(f"{name}: no block with {smem} bytes of "
                               f"shared memory fits the card (occupancy "
                               f"query gave {got})")
        plan = _GROUP_PLANS[key] = plan_of(sms, got)
    return plan


def _group_launch_plan(query, key, device, F, B, W, cols, acc_bytes, n,
                       **kw) -> dict:
    """:func:`group_plan` through :func:`_asked_plan` (``key``: the
    kernel's name, then what selects its instantiation)."""
    return _asked_plan(
        key[0], (key[1:], F, B, W, cols, acc_bytes, n,
                 tuple(sorted(kw.items()))), device, query,
        lambda sms, per_sm: group_plan(F, B, W, cols, acc_bytes, n, sms,
                                       per_sm, **kw))


def _aligned(t):
    """``t``, or a 16-byte aligned copy (the body loads 16-byte words)."""
    return t.clone() if t.data_ptr() % 16 else t


def _value_columns(vals, two_col):
    """The (N, cols) value operand of the shared body, 16-byte aligned."""
    cols = 2 if two_col else 3
    if vals.shape[1] != cols:
        vals = vals[:, :cols].contiguous()
    return _aligned(vals), cols


def _exp_scratch(vals, n):
    """Float values: (blocks, scratch) of the exponent launch of kernels M,
    V and V-lanes; (0, None) for int8 values."""
    if vals.dtype == torch.int8:
        return 0, None
    blocks = max(1, min(8 * kernels.sm_count(vals.device), -(-n // 256)))
    return blocks, torch.empty(blocks * vals.shape[1], dtype=torch.int32,
                               device=vals.device)


def multi_histogram(bins: torch.Tensor, vals: torch.Tensor,
                    sel: torch.Tensor, max_bin: int, width: int,
                    two_col: bool = False, shift: int = 0,
                    miss_bin=None) -> torch.Tensor:
    """Batched histogram over ``width`` disjoint row subsets, full or
    coarse, as :func:`multi_histogram_plain`.  CUDA tensors go to kernel
    M on the shared body over the int8 selector (an int32 ``sel`` is
    narrowed first: one more launch; vals int8 for quantized values,
    exact, or float32, in fixed point after an exponent launch), planned
    by :func:`group_plan`; CPU tensors to the plain version.  Every id of
    ``sel`` must lie in ``[-1, width)``: the narrowing does not check
    (a check would wait on the card), and an id of 128 or more would
    wrap."""
    if bins.device.type == "cpu":
        return multi_histogram_plain(bins, vals, sel, max_bin, width,
                                     two_col, shift, miss_bin)
    F, n = _check_multi_inputs(bins, vals, two_col, width, sel, miss_bin)
    mb = _check_miss_bin(miss_bin, F) if shift else None
    if not 0 <= shift <= 15:
        raise ValueError("shift must be in [0, 15]")
    sel = _narrow_sel(sel, n)
    vals, cols = _value_columns(vals, two_col)
    lib = kernels.load()
    dev = bins.device
    acc = 4 if vals.dtype == torch.int8 else 12
    plan = _group_launch_plan(
        lambda smem: lib.ltt_multi_active_blocks(
            bins.element_size(), int(acc == 4), cols, smem),
        ("kernel M", bins.element_size()), dev, F, max_bin, width, cols,
        acc, n)
    exp_blocks, emax = _exp_scratch(vals, n)
    part = _partial(plan["row_blocks"], F, width, max_bin, two_col, vals)
    out = torch.empty(width, F, max_bin, 3, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ltt_multi_hist(
        bins.data_ptr(), bins.element_size(), sel.data_ptr(),
        vals.data_ptr(), int(acc == 4), int(two_col), n, F, max_bin, width,
        shift, _ptr(mb), plan["fpb"], plan["row_blocks"],
        plan["rows_per_block"], exp_blocks, _ptr(emax), part.data_ptr(),
        out.data_ptr(), stream)
    kernels.check(rc, "kernel M (ltt_multi_hist)")
    LAUNCHES["multi_histogram"] += 1
    return out


def routed_histogram_plain(bins: torch.Tensor, vals: torch.Tensor,
                           leaf_idx: torch.Tensor, tables: torch.Tensor,
                           max_bin: int, width: int, two_col: bool = False,
                           miss_bin=None, shift: int = 0):
    """Route the rows of a wave and histogram the smaller children ->
    (hist (W, F, B, 3), new leaf_idx, sel (N,) int32) — plain PyTorch.

    tables (5 or 6, W) int32: lane leaf ids, split columns, thresholds,
    new (right) leaf ids, smaller-is-left flags and, in row 5, default
    left; miss_bin (F,) int32 per-feature missing bin (-1 = none) or
    None.  A row at its lane feature's missing bin goes left when the
    lane's default is left.  Routing compares fine bins; with ``shift``
    the histogram is coarse, as :func:`multi_histogram_plain`'s."""
    W = width
    t = tables.to(torch.int64)
    colw, thrw, neww, slw = (t[k, :W] for k in range(1, 5))
    li = leaf_idx.to(torch.int64)
    lane = _lanes_of(leaf_idx, tables[0], W)
    in_wave = lane >= 0
    safe = lane.clamp(min=0)
    col_id = colw[safe]
    col = bins.gather(0, col_id[None, :])[0].to(torch.int64)
    gl = col <= thrw[safe]
    if t.shape[0] >= 6 and miss_bin is not None:
        mb_row = miss_bin.to(torch.int64)[col_id]
        is_miss = (col == mb_row) & (mb_row >= 0)
        gl = gl | ((t[5, :W][safe] > 0) & is_miss)
    gl = gl & in_wave
    li_new = torch.where(in_wave & ~gl, neww[safe], li).to(leaf_idx.dtype)
    to_small = gl == (slw[safe] > 0)
    sel = torch.where(in_wave & to_small, lane,
                      torch.full_like(lane, -1)).to(torch.int32)
    hist = multi_histogram_plain(bins, vals, sel, max_bin, width, two_col,
                                 shift, miss_bin)
    return hist, li_new, sel


def routed_histogram(bins: torch.Tensor, vals: torch.Tensor,
                     leaf_idx: torch.Tensor, tables: torch.Tensor,
                     max_bin: int, width: int, two_col: bool = False,
                     miss_bin=None, want_sel: bool = False,
                     leaf_bound: int = 256, shift: int = 0):
    """As :func:`routed_histogram_plain`.  CUDA tensors go to kernel R (a
    routing launch, then a histogram over 16-row groups of its one-byte
    subset ids, planned by :func:`group_plan`); the int32 ``sel`` is
    written only with ``want_sel`` (None otherwise).  ``leaf_bound``:
    every leaf id is below it (256 for uint8 leaf ids).  CPU tensors go to
    the plain version, which always returns ``sel``."""
    if bins.device.type == "cpu":
        return routed_histogram_plain(bins, vals, leaf_idx, tables, max_bin,
                                      width, two_col, miss_bin, shift)
    F, n = _check_multi_inputs(bins, vals, two_col, width, leaf_idx,
                               tables, miss_bin)
    leaf_bound = _check_leaf_idx(leaf_idx, n, leaf_bound)
    if tables.dtype != torch.int32 or tables.dim() != 2 or \
            tables.shape[0] not in (5, 6) or tables.shape[1] != width:
        raise ValueError(f"tables must be int32 (5 or 6, {width})")
    mb = _check_miss_bin(miss_bin, F)
    if F > 2048:
        raise ValueError("kernel R routes at most 2048 features")
    if not 0 <= shift <= 15:
        raise ValueError("shift must be in [0, 15]")
    vals, cols = _value_columns(vals, two_col)
    lib = kernels.load()
    dev = bins.device
    tables = tables.contiguous()
    acc = 4 if vals.dtype == torch.int8 else 12
    plan = _group_launch_plan(
        lambda smem: lib.ltt_routed_active_blocks(
            bins.element_size(), int(acc == 4), cols, smem),
        ("kernel R", bins.element_size()), dev, F, max_bin, width, cols,
        acc, n)
    sms = kernels.sm_count(dev)
    route_blocks = max(1, min(8 * sms, -(-n // 256)))
    leaf_out = torch.empty_like(leaf_idx)
    lane = torch.empty(n, dtype=torch.int8, device=dev)
    sel = torch.empty(n, dtype=torch.int32, device=dev) if want_sel else None
    part = _partial(plan["row_blocks"], F, width, max_bin, two_col, vals)
    # float values: each routing block's largest exponent of each column
    emax = None if acc == 4 else torch.empty(route_blocks * cols,
                                             dtype=torch.int32, device=dev)
    out = torch.empty(width, F, max_bin, 3, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ltt_routed_hist(
        bins.data_ptr(), bins.element_size(), vals.data_ptr(),
        int(vals.dtype == torch.int8), int(two_col), leaf_idx.data_ptr(),
        leaf_idx.element_size(), tables.data_ptr(), tables.shape[0],
        _ptr(mb), leaf_bound, n, F, max_bin, width, shift, route_blocks,
        plan["fpb"], plan["row_blocks"], plan["rows_per_block"],
        leaf_out.data_ptr(), lane.data_ptr(), _ptr(sel), _ptr(emax),
        part.data_ptr(), out.data_ptr(), stream)
    kernels.check(rc, "kernel R (ltt_routed_hist)")
    LAUNCHES["routed_histogram"] += 1
    return out, leaf_out, sel


def window_histogram(bins: torch.Tensor, vals: torch.Tensor,
                     sel: torch.Tensor, win_lo: torch.Tensor, r_bins: int,
                     width: int, two_col: bool = False,
                     miss_bin=None) -> torch.Tensor:
    """Windowed batched histogram over up to 128 subsets, as
    :func:`window_histogram_plain`.  CUDA tensors go to kernel V on the
    shared body over the int8 selector (an int32 ``sel`` is narrowed
    first: one more launch; win_lo int32 (W, F); vals int8 for quantized
    values, exact, or float32, in fixed point after an exponent launch),
    planned by :func:`group_plan`; CPU tensors to the plain version.
    Every id of ``sel`` must lie in ``[-1, width)``, as for
    :func:`multi_histogram`."""
    if bins.device.type == "cpu":
        return window_histogram_plain(bins, vals, sel, win_lo, r_bins, width,
                                      two_col, miss_bin)
    F, n = _check_multi_inputs(bins, vals, two_col, width, sel, win_lo,
                               miss_bin, max_width=_MAX_GROUP_LANES)
    lo = _check_win_lo(win_lo, width, F)
    mb = _check_miss_bin(miss_bin, F)
    sel = _narrow_sel(sel, n)
    vals, cols = _value_columns(vals, two_col)
    lib = kernels.load()
    dev = bins.device
    acc = 4 if vals.dtype == torch.int8 else 12
    plan = _group_launch_plan(
        lambda smem: lib.ltt_window_active_blocks(
            bins.element_size(), int(acc == 4), cols, smem),
        ("kernel V", bins.element_size()), dev, F, r_bins, width, cols, acc,
        n, map_words=1 + width)
    exp_blocks, emax = _exp_scratch(vals, n)
    part = _partial(plan["row_blocks"], F, width, r_bins, two_col, vals)
    out = torch.empty(width, F, r_bins, 3, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ltt_window_hist(
        bins.data_ptr(), bins.element_size(), sel.data_ptr(),
        vals.data_ptr(), int(acc == 4), int(two_col), lo.data_ptr(),
        _ptr(mb), n, F, r_bins, width, plan["fpb"], plan["row_blocks"],
        plan["rows_per_block"], exp_blocks, _ptr(emax), part.data_ptr(),
        out.data_ptr(), stream)
    kernels.check(rc, "kernel V (ltt_window_hist)")
    LAUNCHES["window_histogram"] += 1
    return out


def lanes_window_plan(bins: torch.Tensor, leaf_idx: torch.Tensor,
                      vals: torch.Tensor, r_bins: int, width: int,
                      two_col: bool, leaf_bound: int) -> dict:
    """Kernel V-lanes' launch plan for these operands on their card (its
    blocks an SM asked once; a graph capture asks first, for both widths
    of the coarse-to-fine wave).  ``leaf_bound`` as the wrapper takes it
    (256 for uint8 leaf ids)."""
    F, n = bins.shape
    cols = 2 if two_col else 3
    acc = 4 if vals.dtype == torch.int8 else 12
    idx_bytes = leaf_idx.element_size()
    lib = kernels.load()
    return _group_launch_plan(
        lambda smem: lib.ltt_lanes_active_blocks(
            bins.element_size(), idx_bytes, int(acc == 4), cols, smem),
        ("kernel V-lanes", bins.element_size(), idx_bytes), bins.device, F,
        r_bins, width, cols, acc, n, member_bytes=leaf_bound,
        map_words=1 + width)


def lanes_window_histogram(bins: torch.Tensor, vals: torch.Tensor,
                           leaf_idx: torch.Tensor, lane_ids: torch.Tensor,
                           win_lo: torch.Tensor, r_bins: int, width: int,
                           two_col: bool = False, miss_bin=None,
                           leaf_bound: int = 256) -> torch.Tensor:
    """Windowed batched histogram with lanes from the leaf vector, as
    :func:`lanes_window_histogram_plain`, over up to 128 lanes (a wave's
    2W children in one call).  CUDA tensors go to kernel V-lanes on the
    shared body (leaf_idx uint8/int32 with every id below ``leaf_bound``,
    256 for uint8; lane_ids int32 (W,); float values in fixed point after
    an exponent launch), planned by :func:`group_plan`; CPU tensors to the
    plain version."""
    if bins.device.type == "cpu":
        return lanes_window_histogram_plain(bins, vals, leaf_idx, lane_ids,
                                            win_lo, r_bins, width, two_col,
                                            miss_bin)
    F, n = _check_multi_inputs(bins, vals, two_col, width, leaf_idx,
                               lane_ids, win_lo, miss_bin,
                               max_width=_MAX_GROUP_LANES)
    leaf_bound = _check_leaf_idx(leaf_idx, n, leaf_bound)
    if lane_ids.dtype != torch.int32 or lane_ids.shape != (width,):
        raise ValueError(f"lane_ids must be int32 ({width},)")
    ids = lane_ids.contiguous()
    lo = _check_win_lo(win_lo, width, F)
    mb = _check_miss_bin(miss_bin, F)
    leaf_idx = _aligned(leaf_idx)
    vals, cols = _value_columns(vals, two_col)
    lib = kernels.load()
    dev = bins.device
    acc = 4 if vals.dtype == torch.int8 else 12
    idx_bytes = leaf_idx.element_size()
    plan = lanes_window_plan(bins, leaf_idx, vals, r_bins, width, two_col,
                             leaf_bound)
    exp_blocks, emax = _exp_scratch(vals, n)
    part = _partial(plan["row_blocks"], F, width, r_bins, two_col, vals)
    out = torch.empty(width, F, r_bins, 3, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ltt_lanes_window_hist(
        bins.data_ptr(), bins.element_size(), leaf_idx.data_ptr(), idx_bytes,
        ids.data_ptr(), leaf_bound, vals.data_ptr(), int(acc == 4),
        int(two_col), lo.data_ptr(), _ptr(mb), n, F, r_bins, width,
        plan["fpb"], plan["row_blocks"], plan["rows_per_block"], exp_blocks,
        _ptr(emax), part.data_ptr(), out.data_ptr(), stream)
    kernels.check(rc, "kernel V-lanes (ltt_lanes_window_hist)")
    LAUNCHES["lanes_window_histogram"] += 1
    return out


# ---- leaf renewal sums: kernel Q ---------------------------------------

LEAF_THREADS = 256              # threads a block of kernel Q
LEAF_ROW_CAP = 1 << 15          # rows a block: no 32-bit word overflows
_LEAF_STATIC_SMEM = 16          # its static shared memory (the exponents)


def leaf_smem(L: int) -> int:
    """Kernel Q's shared memory a block: an (L, 3) tile of three 32-bit
    words a cell (``WordTile``, ``csrc/group_hist.cuh``)."""
    return _align16(L * 3 * 12)


LEAF_MAX = (_SMEM_MAX - _LEAF_STATIC_SMEM) // 36  # most leaves: 6456


def leaf_plan(n: int, L: int, sms: int, per_sm=None) -> dict:
    """Kernel Q's launch plan on a card with ``sms`` multiprocessors that
    runs ``per_sm`` of its blocks at once on each (default: the most the
    threads and shared memory allow; the wrapper asks the card).  The grid
    is one wave of row blocks, no more than give every thread a 16-row
    group, and at most :data:`LEAF_ROW_CAP` rows a block.  Row block ``i``
    owns rows ``[i * rows_per_block, min((i + 1) * rows_per_block, n))``,
    ``rows_per_block`` a multiple of 16."""
    if not 1 <= L <= LEAF_MAX:
        raise ValueError(f"kernel Q holds 1 to {LEAF_MAX} leaves in shared "
                         f"memory, not {L}")
    smem = leaf_smem(L)
    if per_sm is None:
        per_sm = max(1, min(2048 // LEAF_THREADS, ROUTED_SM_SMEM //
                            (smem + _BLOCK_RESERVED_SMEM)))
    n = max(n, 1)
    rb = max(1, per_sm * sms)
    rb = min(rb, -(-n // (LEAF_THREADS * ROUTED_GROUP)))  # a group a thread
    rb = max(rb, -(-n // LEAF_ROW_CAP))
    rows_per_block = _align16(-(-n // rb))
    rb = -(-n // rows_per_block)
    return {"row_blocks": rb, "rows_per_block": rows_per_block,
            "smem": smem}


def leaf_stats_plain(leaf_idx: torch.Tensor, grad: torch.Tensor,
                     hess: torch.Tensor, mask: torch.Tensor,
                     num_leaves: int) -> torch.Tensor:
    """Per-leaf ``[sum grad*m, sum hess*m, sum m]`` -> (L, 3) float32,
    summed in float64 — plain PyTorch."""
    v = torch.stack([grad * mask, hess * mask, mask], dim=-1)
    out = torch.zeros(num_leaves, 3, dtype=torch.float64,
                      device=leaf_idx.device)
    out.index_add_(0, leaf_idx.to(torch.int64), v.to(torch.float64))
    return out.to(torch.float32)


def leaf_stats(leaf_idx: torch.Tensor, grad: torch.Tensor,
               hess: torch.Tensor, mask: torch.Tensor,
               num_leaves: int) -> torch.Tensor:
    """As :func:`leaf_stats_plain`.  CUDA tensors go to kernel Q (a bound
    launch for each column's fixed-point scale, the sums, a fixed-order
    reduction: the same bits on every launch), planned by
    :func:`leaf_plan`; CPU tensors to the plain version.  Every id must be
    below ``num_leaves`` (at most :data:`LEAF_MAX`)."""
    if leaf_idx.device.type == "cpu":
        return leaf_stats_plain(leaf_idx, grad, hess, mask, num_leaves)
    n = leaf_idx.shape[0]
    if leaf_idx.dtype not in (torch.uint8, torch.int32) or \
            leaf_idx.dim() != 1 or not leaf_idx.is_contiguous():
        raise ValueError("leaf_idx must be contiguous uint8/int32 (N,)")
    for name, x in (("grad", grad), ("hess", hess), ("mask", mask)):
        if x.dtype != torch.float32 or x.shape != (n,) or \
                not x.is_contiguous() or x.device != leaf_idx.device:
            raise ValueError(f"{name} must be contiguous float32 ({n},) on "
                             "the device of leaf_idx")
    if not 1 <= num_leaves <= LEAF_MAX:
        raise ValueError(f"kernel Q holds at most {LEAF_MAX} leaves")
    leaf_idx, grad, hess, mask = (_aligned(x)
                                  for x in (leaf_idx, grad, hess, mask))
    lib = kernels.load()
    dev = leaf_idx.device
    idx_bytes = leaf_idx.element_size()
    plan = _asked_plan(
        "kernel Q", (idx_bytes, n, num_leaves), dev,
        lambda smem: lib.ltt_leaf_active_blocks(idx_bytes, smem),
        lambda sms, per_sm: leaf_plan(n, num_leaves, sms, per_sm))
    bound_blocks = max(1, min(8 * kernels.sm_count(dev), -(-n // 1024)))
    bounds = torch.empty(bound_blocks * 3, dtype=torch.float32, device=dev)
    part = torch.empty(plan["row_blocks"] * num_leaves * 3,
                       dtype=torch.float64, device=dev)
    out = torch.empty(num_leaves, 3, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ltt_leaf_stats(leaf_idx.data_ptr(), idx_bytes, grad.data_ptr(),
                            hess.data_ptr(), mask.data_ptr(), n, num_leaves,
                            plan["row_blocks"], plan["rows_per_block"],
                            bound_blocks, bounds.data_ptr(), part.data_ptr(),
                            out.data_ptr(), stream)
    kernels.check(rc, "kernel Q (ltt_leaf_stats)")
    LAUNCHES["leaf_stats"] += 1
    return out
