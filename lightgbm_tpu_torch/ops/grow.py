"""Leaf-wise (best-first) tree growth on the device.

Counterpart of ``lightgbm_tpu/ops/grow.py``: the serial learner's
``build_tree_impl`` (:326; its ``route_rows``, :1833, is ``ops/route.py``).
Two loops share the histogram pool (per-leaf histograms for the
subtraction trick, where the larger child is parent minus smaller,
:1120-1132):

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
- with categorical features (``SplitParams.any_cat``) or bundled
  features a wave is not routed in the pass (:1497-1516; ``route_wave``
  :1224-1290): each row in the wave looks up its lane, reads its lane's
  split column and goes left where its bin is in the lane's left mask (a
  category set, or a bin mask translated onto the bundle's bins), and the
  smaller children's histograms come from the batched pass over that
  selector (kernel M).  The leaf vector is then int32 (:892-895).

With exclusive feature bundling (``GrowState(bundles=...)``, EFB, :339-364)
``xt`` is the (G, N) bundle matrix: the histogram passes and the pool hold
bundle columns, the subtraction trick runs on them, and :func:`expand`
turns a batch of bundle histograms into logical features' before every
scan (:507-517), so kernel S, the categorical scan and the records see
features.  A split routes rows through its feature's bundle column and its
mask translated by ``from_bundle`` (``goes_left_of``, :857-871).

With monotone constraints (``SplitParams.monotone``) each leaf carries output
bounds: a split's children get theirs from :func:`child_bounds` before
their scans (:1139-1170, :1461-1466, :1658-1663), every scan clips to
them, and the leaf values are clipped to them at the end (:1742-1744),
before the quantized renewal, which does not clip (:1771-1798).

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

The loops run as phases over a :class:`GrowState`, the static buffers of
growth allocated once per booster: :func:`tree_head` (quantization, the
root's passes and best split, the per-leaf state reset and, on the wave
loop, the first wave's flags), :func:`serial_steps` (the non-speculative
loop's ``num_leaves - 1`` steps), :func:`wave_body` (one wave after its
flag read, ending in the next wave's flags) and :func:`tree_tail` (leaf
values and the quantized renewal).  Every phase writes the state in
place and reads nothing back to the host, so ``ops/graphs.py`` captures
each once as a CUDA graph and replays it for every tree; run eagerly
(:func:`build_tree`, every tree on the CPU) the phases launch the same
kernels in the same order.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils import prng
from .histogram import (lanes_window_histogram, leaf_stats,
                        masked_histogram, multi_histogram, routed_histogram,
                        window_histogram)
from .split import (LOOP, NEG_INF, ROOT, WAVE, SplitParams, choose_window,
                    depth_limit, find_best_split, find_best_split_c2f, fma32,
                    leaf_output)

__all__ = ["GrowParams", "GrowState", "build_tree", "tree_head",
           "serial_steps", "wave_loop", "wave_body", "read_flags",
           "tree_tail", "quantize_gradients", "key_words", "row_uniform",
           "expand", "bin_sum", "child_bounds", "BOUND_RECORDS"]

_M32 = 0xFFFFFFFF
_INF = float("inf")


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


def row_uniform(n: int, word, device) -> torch.Tensor:
    """Per-row rounding noise in [0, 1): the JAX package's
    ``_row_uniform`` (:441-452), a Wang-style mix of (row index, key word)
    in uint32 arithmetic, done here in int64 and masked, since PyTorch
    has no uint32 multiply on every backend.  ``word`` is a host int or a
    0-dim int64 tensor on ``device``; a captured graph reads the tensor
    at every replay, where a host int would stay the capture's."""
    h = torch.arange(n, dtype=torch.int64, device=device) ^ (word & _M32)
    h = _mul32(h ^ (h >> 16), 0x7feb352d)
    h = _mul32(h ^ (h >> 15), 0x846ca68b)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


def key_words(key) -> tuple:
    """The two words of a tree's (2,) uint32 quantization key that the
    rounding reads: ``split(key)`` into the gradient and hessian keys
    (:414-415), then :func:`prng.key_word` of each."""
    kg, kh = prng.split(key)
    return prng.key_word(kg), prng.key_word(kh)


def quantize_gradients(grad: torch.Tensor, hess: torch.Tensor,
                       mask: torch.Tensor, quantize: int, two_col: bool,
                       key) -> tuple:
    """Stochastic rounding of the masked gradients (:409-459) ->
    (grad_q, hess_q, hist_scale).  ``key`` is the tree's (2,) uint32
    Threefry key, or its two words (:func:`key_words`) as a (2,) int64
    tensor on the device of ``grad``; ``hist_scale`` (3,) dequantizes a
    histogram (the count channel takes the hess scale under ``two_col``,
    where it is a hess copy).  The scales are ``max|v| * f32(1 /
    quantize)``: the reference's compile turns its division by the
    constant into that product.  The divisions by a scale are IEEE
    float32, so the card, the CPU and the JAX package round to the same
    integers."""
    words = key if torch.is_tensor(key) else key_words(key)
    inv_q = (torch.ones((), dtype=torch.float32) / quantize).item()
    g_w = grad * mask
    h_w = hess * mask
    sg = torch.clamp(g_w.abs().max(), min=1e-30) * inv_q
    sh = torch.clamp(h_w.abs().max(), min=1e-30) * inv_q
    n, dev = grad.shape[0], grad.device
    gq = torch.floor(g_w / sg + row_uniform(n, words[0], dev))
    hq = torch.floor(h_w / sh + row_uniform(n, words[1], dev))
    scale = torch.stack([sg, sh, sh if two_col else torch.ones_like(sh)])
    return gq, hq, scale


class GrowState:
    """The static buffers of one booster's tree growth.

    The tree's inputs (``feature_mask`` (F,) bool, ``key_words`` (2,)
    int64: the quantization key's words, :func:`key_words`), the
    objective's gradients (``grad_raw``, ``hess_raw``) and what the passes
    read of them (quantized ``grad``/``hess`` and ``hist_scale`` on the
    non-speculative loop, the value operand ``kvals`` on the wave loop),
    the leaf assignment, the per-leaf state (histogram pool, leaf stats,
    depths, each leaf's best split), the split records and the leaf
    values.  On the wave loop the per-leaf state has a dummy row L, the
    target of invalid lanes, the records a dummy slot L-1, and the next
    wave's lanes and flags (``topg``, ``ids``, ``valid_w``, ``t0``,
    ``flags``) live here too.  With ``bundles`` (:class:`BundleMaps`) ``xt``
    is the (G, N) bundle matrix and the pool holds bundle columns.  With
    monotone constraints the per-feature directions ``mono``, the
    per-leaf output bounds ``leaf_min``/``leaf_max`` and the records'
    children's bounds (``left_min``, ``left_max``, ``right_min``,
    ``right_max``, :994-1002) live here too; with a feature penalty its
    multipliers ``pen``.

    Allocated once; :func:`tree_head` resets everything a tree reads
    before it writes it, so one state serves every tree of a booster, and
    the tensors keep their addresses, which a captured graph needs."""

    def __init__(self, xt: torch.Tensor, sample_mask: torch.Tensor,
                 num_bins: torch.Tensor, missing_type: torch.Tensor,
                 params: GrowParams, is_cat=None, bundles=None):
        p = params
        sp = p.split
        L = p.num_leaves
        B = sp.max_bin
        G, N = xt.shape
        F = num_bins.shape[0]
        dev = xt.device
        # the bundle maps (io/bundle.py BundleMaps), or None
        self.bundles = bundles
        if bundles is not None and (bundles.num_groups != G or
                                    p.refine_shift or p.two_col):
            raise ValueError("bundled growth takes the (G, N) bundle matrix "
                             "and no two-column or coarse-to-fine passes")
        f32, i32, i64 = torch.float32, torch.int32, torch.int64
        self.xt, self.sample_mask = xt, sample_mask
        self.num_bins, self.missing_type = num_bins, missing_type
        # (F,) bool: the categorical features (with split.any_cat)
        self.is_cat = is_cat
        if sp.any_cat and is_cat is None:
            raise ValueError("split.any_cat needs is_cat")
        self.params = p
        self.wave = bool(p.wave and p.speculate > 1)
        # a wave routed outside the pass (categorical or bundled features)
        self.route_outside = self.wave and (sp.any_cat or
                                            bundles is not None)
        self.li_dtype = torch.uint8 if L <= 256 and not \
            self.route_outside else torch.int32

        def zeros(shape, dtype=f32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.feature_mask = torch.ones(F, dtype=torch.bool, device=dev)
        self.key_words = zeros(2, i64)
        self.grad_raw = zeros(N)
        self.hess_raw = zeros(N)
        self.hist_scale = zeros(3) if p.quantize else None
        self.leaf_idx = zeros(N, self.li_dtype)
        self.ids32 = torch.arange(L, dtype=i32, device=dev)
        self.Bp = B
        if self.wave:
            self.width = W = min(p.speculate, L)
            self.kvals = zeros((N, 2 if p.two_col else 3),
                               torch.int8 if 0 < p.quantize <= 127 else f32)
            self.miss_bin = torch.where(
                missing_type != 0, num_bins - 1,
                torch.full_like(num_bins, -1)).to(i32) \
                if sp.any_missing and bundles is None else None
            self.leaf_bound = 256 if self.li_dtype == torch.uint8 else L + 1
            if p.refine_shift:
                # the last coarse slot is reserved for the missing bin,
                # which value bins (at most B - 2) never reach (:696-706)
                self.Bp = ((B - 1) >> p.refine_shift) + 1 + \
                    int(sp.any_missing)
                # two coarse bins at fine resolution
                self.R = 2 << p.refine_shift
            self.w_ar = torch.arange(W, dtype=i64, device=dev)
            self.topg = zeros(W)
            self.ids = zeros(W, i64)
            self.valid_w = zeros(W, torch.bool)
            self.t0 = zeros((), i64)
            self.flags = zeros(3)
        else:
            self.ids64 = self.ids32.to(i64)
            self.grad = zeros(N) if p.quantize else self.grad_raw
            self.hess = zeros(N) if p.quantize else self.hess_raw
        rows = L + 1 if self.wave else L
        # coarse under c2f (:973-985); bundle columns under EFB
        self.pool = zeros((rows, G, self.Bp, 3))
        self.leaf_stats = zeros((rows, 3))
        self.leaf_depth = zeros(rows, i32)
        self.best = {
            "gain": zeros(rows), "feature": zeros(rows, i32),
            "threshold": zeros(rows, i32),
            "default_left": zeros(rows, torch.bool),
            "left_stats": zeros((rows, 3)),
            "left_mask": zeros((rows, B), torch.bool),
        }
        if sp.any_cat:
            self.best["is_cat"] = zeros(rows, torch.bool)
        # a wave's lane of each leaf (-1: none), row L the dummy's
        self.lane_of = zeros(rows, i64) if self.route_outside else None
        # monotone constraints and the feature penalty (per logical feature)
        self.mono = torch.tensor(sp.monotone, dtype=i32, device=dev) \
            if sp.has_monotone else None
        self.pen = torch.tensor(sp.penalty, dtype=f32, device=dev) \
            if sp.has_penalty else None
        # the root's (1, 2) output bounds (:906-907), None unconstrained
        self.root_bounds = None
        if self.mono is not None:
            self.leaf_min = zeros(rows)
            self.leaf_max = zeros(rows)
            self.root_bounds = torch.tensor([[-_INF, _INF]], device=dev)
        self.rec = _records(L if self.wave else L - 1, B, dev, sp.any_cat,
                            self.mono is not None)
        self.n_leaves = torch.ones((), dtype=i32, device=dev)
        self.leaf_values = zeros(L)
        self.leaf_values_final = zeros(L)
        self.leaf_stats_exact = zeros((L, 3)) if p.quantize else None

    def is_wide(self, live: int) -> bool:
        """Whether a wave of ``live`` lanes runs the wide c2f variant of
        :func:`wave_body` (more than W/2 lanes live)."""
        return bool(self.params.refine_shift) and 2 * live > self.width

    def result(self, waves: int = 0) -> dict:
        """The tree as :func:`build_tree` returns it: views of the state's
        buffers (the next tree overwrites them)."""
        L = self.params.num_leaves
        out = {k: v[:L - 1] for k, v in self.rec.items()}
        out.update(leaf_idx=self.leaf_idx, leaf_stats=self.leaf_stats[:L],
                   n_leaves=self.n_leaves, leaf_values=self.leaf_values,
                   leaf_values_final=self.leaf_values_final)
        if self.leaf_stats_exact is not None:
            out["leaf_stats_exact"] = self.leaf_stats_exact
        if self.wave:
            out["n_waves"] = torch.tensor(waves, dtype=torch.int32,
                                          device=self.xt.device)
        return out


def build_tree(xt: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
               sample_mask: torch.Tensor, feature_mask: torch.Tensor,
               num_bins: torch.Tensor, missing_type: torch.Tensor,
               params: GrowParams, quant_key=None, is_cat=None,
               bundles=None) -> dict:
    """Grow one tree, eagerly, over a state of its own.

    xt: (F, N) binned features (uint8/int16), or with ``bundles`` the
    (G, N) bundle matrix; grad/hess/sample_mask:
    (N,) float32 (the mask 0/1 under quantization); feature_mask: (F,)
    bool; num_bins/missing_type: (F,) int32.  All on one device.
    ``quant_key``: the tree's (2,) uint32 key for quantization
    (``PRNGKey(0)`` when None, as in the JAX package).  Returns the
    per-split records (length num_leaves-1), the final leaf assignment,
    per-leaf values and the realized leaf count, as device tensors; with
    quantization also ``leaf_stats_exact``, the full-precision per-leaf
    sums the values were renewed from."""
    st = GrowState(xt, sample_mask, num_bins, missing_type, params, is_cat,
                   bundles)
    st.feature_mask.copy_(feature_mask)
    if params.quantize:
        key = prng.prng_key(0) if quant_key is None else quant_key
        st.key_words.copy_(torch.tensor(key_words(key), dtype=torch.int64))
    tree_head(st, grad, hess)
    waves = 0
    if st.wave:
        waves = wave_loop(st, lambda wide: wave_body(st, wide))
    else:
        serial_steps(st)
    tree_tail(st)
    return st.result(waves)


def wave_loop(st: GrowState, body) -> int:
    """The wave loop after :func:`tree_head`: a flag read, then
    ``body(wide)`` (:func:`wave_body`, or a replay of its graph) while the
    read finds a wave to run -> the number of waves (the flag reads are one
    more)."""
    waves = 0
    live = read_flags(st)
    while live is not None:
        body(st.is_wide(live))
        waves += 1
        live = read_flags(st)
    return waves


def tree_head(st: GrowState, grad: torch.Tensor, hess: torch.Tensor) -> None:
    """A tree's first phase: the objective's gradients into the state,
    quantized with the state's key words, the root's passes and best
    split, the per-leaf state and records reset, and on the wave loop
    the first wave's lanes and flags."""
    p = st.params
    st.grad_raw.copy_(grad)
    st.hess_raw.copy_(hess)
    g, h = st.grad_raw, st.hess_raw
    if p.quantize:
        g, h, scale = quantize_gradients(g, h, st.sample_mask, p.quantize,
                                         p.two_col, st.key_words)
        st.hist_scale.copy_(scale)
    if st.wave:
        st.kvals.copy_(_value_operand(g, h, st.sample_mask, p))
        _wave_root(st, g, h)
        _wave_head(st)
    else:
        if p.quantize:
            st.grad.copy_(g)
            st.hess.copy_(h)
        _serial_root(st)


_XLA_WINDOW = 32


def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    """Float32 sum over axis -2, one element at a time from the first."""
    s = x[..., 0, :]
    for i in range(1, x.shape[-2]):
        s = s + x[..., i, :]
    return s


def bin_sum(hf: torch.Tensor) -> torch.Tensor:
    """Float32 sum over the bins axis of (..., B, 3) in the order of XLA's
    ``jnp.sum`` on the CPU, which the JAX package's ``expand`` runs
    (``lightgbm_tpu/ops/grow.py:515``): up to 32 bins one at a time;
    above, the bins padded with zeros to ``c = ceil(B / 32)`` windows of
    32 (half the padding, rounded down, in front), each window summed one
    at a time, then the window sums one at a time: bit for bit against
    the JAX package at every B from 2 to 299 (20 of them held in
    ``tests/test_torch_efb_bundles.py``).  Each add is one elementwise
    launch on the card."""
    B = hf.shape[-2]
    c = -(-B // _XLA_WINDOW)
    if c == 1:
        return _sequential_sum(hf)
    pad = c * _XLA_WINDOW - B
    lead = hf.shape[:-2]
    hf = torch.cat([hf.new_zeros(lead + (pad // 2, 3)), hf,
                    hf.new_zeros(lead + (pad - pad // 2, 3))], dim=-2)
    win = _sequential_sum(hf.reshape(lead + (c, _XLA_WINDOW, 3)))
    return _sequential_sum(win)


def expand(hist: torch.Tensor, stats: torch.Tensor, bundles) -> torch.Tensor:
    """Bundle histograms (W, G, B, 3) -> logical features' (W, F, B, 3)
    (the JAX package's ``expand``, :507-517): each feature's slot range
    gathered through ``to_bundle``, its -1 slots zeroed, and its skipped
    default bin rebuilt as the leaf's ``stats`` (W, 3) minus the sum of
    its other bins (:func:`bin_sum`) on the ``fix`` row.  The identity
    without ``bundles``."""
    if bundles is None:
        return hist
    W, _, B, _ = hist.shape
    F = bundles.group.shape[0]
    hf = hist.index_select(1, bundles.group)                 # (W, F, B, 3)
    idx = bundles.to_bundle.clamp(min=0)
    hf = torch.gather(hf, 2, idx[None, :, :, None].expand(W, F, B, 3))
    hf = hf * (bundles.to_bundle >= 0).to(hf.dtype)[None, :, :, None]
    rem = stats[:, None, :] - bin_sum(hf)                    # (W, F, 3)
    return hf + bundles.fix[None, :, :, None] * rem[:, :, None, :]


def _best_splits(hists, stats, depth, st: GrowState, bounds=None,
                 site: str = ROOT) -> dict:
    """Best split of each of a batch of leaves, no split where the children
    would pass ``max_depth``: one kernel-S launch on the card, which
    applies the depth limit itself, under the monotone constraints (each
    leaf's output bounds ``bounds`` (W, 2)) and the feature penalty;
    ``site``: the scan's place in the loop (``ops/split.py``).  Bundle
    histograms are expanded to features first."""
    p = st.params
    stats = stats.contiguous()
    return find_best_split(expand(hists, stats, st.bundles).contiguous(),
                           stats, st.num_bins, st.missing_type,
                           st.feature_mask, p.split, depth, p.max_depth,
                           st.is_cat, st.mono, st.pen, bounds, site)


def child_bounds(ls, rs, mn_p, mx_p, feat, cat_flag, mono,
                 sp: SplitParams) -> tuple:
    """The children's output bounds of splits (``child_bounds``,
    :838-855; serial_tree_learner.cpp:767-777): a numerical split on a
    monotone feature pins its children on either side of ``mid``, the
    mean of the two child outputs clipped to the parent's ``[mn_p,
    mx_p]``; a categorical split (``cat_flag``, or None without
    categorical features) or a free feature passes the parent's bounds
    on.  Elementwise, so the exact loop's one split and a wave's W share
    it: ``ls``/``rs`` (..., 3) stats, ``feat`` the split features ->
    (l_min, l_max, r_min, r_max)."""
    l1, l2, mds = sp.lambda_l1, sp.lambda_l2, sp.max_delta_step
    lo = torch.minimum(torch.maximum(
        leaf_output(ls[..., 0], ls[..., 1], l1, l2, mds), mn_p), mx_p)
    ro = torch.minimum(torch.maximum(
        leaf_output(rs[..., 0], rs[..., 1], l1, l2, mds), mn_p), mx_p)
    mid = 0.5 * (lo + ro)
    mono_f = mono.index_select(0, feat.reshape(-1).to(torch.int64)) \
        .reshape(feat.shape)
    up, dn = mono_f > 0, mono_f < 0
    if cat_flag is not None:
        up, dn = up & ~cat_flag, dn & ~cat_flag
    return (torch.where(dn, mid, mn_p), torch.where(up, mid, mx_p),
            torch.where(up, mid, mn_p), torch.where(dn, mid, mx_p))


def _dequant(st: GrowState, h: torch.Tensor) -> torch.Tensor:
    return h if st.hist_scale is None else h * st.hist_scale


def larger_child(parent: torch.Tensor, raw_small: torch.Tensor,
                 hist_scale, fused: bool = True) -> torch.Tensor:
    """The subtraction trick: parent minus the smaller child.  A quantized
    child is dequantized inside the subtraction, ``parent - raw * scale``
    with one rounding (a fused multiply-add), as the reference's compiled
    loop computes it; the pool then holds the reference's values bit for
    bit.  ``fused=False``: the product rounded first, as the reference's
    exact loop computes it when its categorical scan is compiled into the
    loop (the product's second use, the smaller child, keeps the compile
    from fusing it)."""
    if hist_scale is None:
        return parent - raw_small
    if not fused:
        return parent - raw_small * hist_scale
    return fma32(-raw_small, hist_scale.expand_as(raw_small), parent)


def _root_stats(grad, hess, mask, two_col, hist_scale):
    """[sum g*m, sum h*m, count] in float64, rounded once; the count is
    the hess sum under ``two_col``; dequantized by ``hist_scale``."""
    gm = (grad * mask).to(torch.float64).sum()
    hm = (hess * mask).to(torch.float64).sum()
    cnt = hm if two_col else mask.to(torch.float64).sum()
    stats = torch.stack([gm, hm, cnt]).to(torch.float32)
    return stats if hist_scale is None else stats * hist_scale


def _reset_leaves(st: GrowState, hist0, stats0, best0) -> None:
    """The per-leaf state of a tree with one leaf, the root, and empty
    records."""
    st.pool.zero_()
    st.pool[0] = hist0
    st.leaf_stats.zero_()
    st.leaf_stats[0] = stats0
    st.leaf_depth.zero_()
    for k, arr in st.best.items():
        arr.fill_(NEG_INF if k == "gain" else 0)
        arr[0] = best0[k][0]
    for k, arr in st.rec.items():
        arr.fill_(_BOUND_FILL.get(k, 0))
    if st.mono is not None:
        st.leaf_min.fill_(-_INF)
        st.leaf_max.fill_(_INF)
    st.n_leaves.fill_(1)


# the records of each split's children's monotone bounds, which start open
# (:999-1002)
BOUND_RECORDS = ("left_min", "left_max", "right_min", "right_max")
_BOUND_FILL = dict(zip(BOUND_RECORDS, (-_INF, _INF, -_INF, _INF)))


def _masked_hist(st: GrowState, leaf_id) -> tuple:
    """(raw, dequantized) histogram of one leaf (kernel H)."""
    h = masked_histogram(st.xt, st.grad, st.hess, st.sample_mask,
                         st.leaf_idx, leaf_id, st.params.split.max_bin)
    return h, _dequant(st, h)


def _serial_root(st: GrowState) -> None:
    st.leaf_idx.zero_()
    root_stats = _root_stats(st.grad, st.hess, st.sample_mask, False,
                             st.hist_scale)
    root_hist = _masked_hist(st, st.ids32[0])[1]
    root_best = _best_splits(root_hist[None], root_stats[None],
                             torch.zeros(1, dtype=torch.int32,
                                         device=st.xt.device), st,
                             st.root_bounds)
    _reset_leaves(st, root_hist, root_stats, root_best)


def serial_steps(st: GrowState) -> None:
    """The non-speculative best-first loop's ``num_leaves - 1`` steps
    (:1056-1211)."""
    L = st.params.num_leaves
    xt, ids32, best, rec = st.xt, st.ids32, st.best, st.rec
    zero3 = torch.zeros(3, dtype=torch.float32, device=xt.device)
    for t in range(L - 1):
        new = t + 1
        l1 = torch.argmax(best["gain"]).reshape(1)          # (1,) int64
        cand = {k: _pick(v, l1) for k, v in best.items()}
        valid = cand["gain"] > 0

        # row routing: rows of leaf l that go right move to leaf `new`
        feat = cand["feature"].to(torch.int64).reshape(1)
        mask = cand["left_mask"]
        if st.bundles is not None:
            # the feature's bundle column, its mask on the bundle's bins
            mask = mask.index_select(0, _pick(st.bundles.from_bundle, feat))
            feat = st.bundles.group.index_select(0, feat)
        col = _pick(xt, feat)
        goes_left = mask[col.to(torch.int32)]
        mine = st.leaf_idx == _pick(ids32, l1).to(st.li_dtype)
        st.leaf_idx.masked_fill_(mine & ~goes_left & valid, new)

        left_stats = cand["left_stats"]
        parent_stats = _pick(st.leaf_stats, l1)
        right_stats = parent_stats - left_stats
        # subtraction trick: smaller child from one pass, larger = parent
        # minus smaller
        small_is_left = left_stats[2] <= right_stats[2]
        small_id = torch.where(small_is_left, _pick(ids32, l1), ids32[new])
        raw_small, hist_small = _masked_hist(st, small_id)
        # the reference's compile of the step fuses the subtraction unless
        # it also holds the categorical scan, and then still under the
        # monotone clip (probed as ops/split.py's fusion sites)
        sp = st.params.split
        hist_large = larger_child(_pick(st.pool, l1), raw_small,
                                  st.hist_scale,
                                  fused=not sp.any_cat or sp.has_monotone)
        hist_l = torch.where(small_is_left, hist_small, hist_large)
        hist_r = torch.where(small_is_left, hist_large, hist_small)
        depth = _pick(st.leaf_depth, l1) + 1
        bounds = None
        if st.mono is not None:
            # the children's bounds before their scans (:1139-1147)
            l_min, l_max, r_min, r_max = child_bounds(
                left_stats, right_stats, _pick(st.leaf_min, l1),
                _pick(st.leaf_max, l1), cand["feature"], cand.get("is_cat"),
                st.mono, sp)
            bounds = torch.stack([torch.stack([l_min, l_max]),
                                  torch.stack([r_min, r_max])])
        children = _best_splits(torch.stack([hist_l, hist_r]),
                                torch.stack([left_stats, right_stats]),
                                depth.reshape(1), st, bounds, LOOP)

        pair = torch.cat([l1, st.ids64[new].reshape(1)])
        _put(st.pool, pair, torch.stack([hist_l, hist_r]), valid)
        _put(st.leaf_stats, pair, torch.stack([left_stats, right_stats]),
             valid)
        _put(st.leaf_depth, pair, depth.expand(2), valid)
        for k, arr in best.items():
            _put(arr, pair, children[k], valid)
        if bounds is not None:
            _put(st.leaf_min, pair, bounds[:, 0], valid)
            _put(st.leaf_max, pair, bounds[:, 1], valid)
            for k, v in (("left_min", l_min), ("left_max", l_max),
                         ("right_min", r_min), ("right_max", r_max)):
                rec[k][t] = torch.where(valid, v, rec[k][t])

        rec["leaf"][t] = torch.where(valid, _pick(ids32, l1),
                                     torch.full_like(ids32[0], -1))
        for k in ("feature", "threshold", "default_left", "left_mask",
                  "is_cat"):
            if k in rec:
                rec[k][t] = cand[k]
        rec["gain"][t] = torch.where(valid, cand["gain"],
                                     torch.zeros_like(cand["gain"]))
        rec["left_stats"][t] = torch.where(valid, left_stats, zero3)
        rec["right_stats"][t] = torch.where(valid, right_stats, zero3)
        rec["valid"][t] = valid
        st.n_leaves.add_(valid.to(torch.int32))


def _records(S: int, B: int, dev, any_cat: bool = False,
             bounds: bool = False) -> dict:
    def per_split(shape, dtype):
        return torch.zeros((S,) + shape, dtype=dtype, device=dev)

    rec = {
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
    if any_cat:
        rec["is_cat"] = per_split((), torch.bool)
    if bounds:
        for k in BOUND_RECORDS:
            rec[k] = per_split((), torch.float32)
    return rec


def _value_operand(grad, hess, mask, p: GrowParams) -> torch.Tensor:
    """(N, 2|3) value operand of the batched passes: int8 for quantized
    values within int8 (1 byte an entry, exact), float32 otherwise."""
    cols = [grad * mask, hess * mask] + ([] if p.two_col else [mask])
    vals = torch.stack(cols, dim=-1)
    if 0 < p.quantize <= 127:
        vals = vals.to(torch.int8)
    return vals.contiguous()


def _scan_c2f(st: GrowState, coarse, win, lo, stats, depth, bounds=None,
              site: str = ROOT) -> dict:
    p = st.params
    b = find_best_split_c2f(coarse, win, lo, stats, st.num_bins,
                            st.missing_type, st.feature_mask, p.split,
                            p.refine_shift, st.mono, st.pen, bounds, site)
    return depth_limit(b, depth, p.max_depth)


def _window(st: GrowState, coarse, stats, bounds=None) -> torch.Tensor:
    return choose_window(coarse, stats, st.num_bins, st.missing_type,
                         st.params.split, st.params.refine_shift, st.mono,
                         bounds)


def _wave_root(st: GrowState, g, h) -> None:
    """The wave loop's root: the batched pass with one live lane, coarse
    then windowed under c2f (:908-919), where no pass runs at full
    resolution."""
    p = st.params
    shift = p.refine_shift
    dev = st.xt.device
    st.leaf_idx.zero_()
    root_stats = _root_stats(g, h, st.sample_mask, p.two_col, st.hist_scale)
    zero1 = torch.zeros(1, dtype=torch.int32, device=dev)
    sel0 = torch.zeros(st.xt.shape[1], dtype=torch.int8, device=dev)
    root_hist = _dequant(st, multi_histogram(
        st.xt, st.kvals, sel0, st.Bp, 1, p.two_col, shift, st.miss_bin))
    rb = st.root_bounds
    if shift:
        lo0 = _window(st, root_hist, root_stats[None], rb)
        root_win = _dequant(st, window_histogram(
            st.xt, st.kvals, sel0, lo0, st.R, 1, p.two_col, st.miss_bin))
        root_best = _scan_c2f(st, root_hist, root_win, lo0,
                              root_stats[None], zero1, rb)
    else:
        root_best = _best_splits(root_hist, root_stats[None], zero1, st, rb)
    _reset_leaves(st, root_hist[0], root_stats, root_best)


def _wave_head(st: GrowState) -> None:
    """The next wave's lanes (the top-W leaves by gain, ``top_k`` order:
    descending, ties to the lower leaf id; valid lanes form a prefix, so
    record slots stay contiguous) and its flags (``wave_cond`` and the
    live lane count), which :func:`read_flags` reads."""
    L = st.params.num_leaves
    W = st.width
    gain = st.best["gain"][:L]
    t0 = st.n_leaves.to(torch.int64) - 1          # next free record slot
    remaining = (L - 1) - t0
    srt = torch.sort(gain, descending=True, stable=True)
    st.topg.copy_(srt.values[:W])
    st.ids.copy_(srt.indices[:W])
    st.valid_w.copy_((st.topg > 0) & (st.w_ar < remaining))
    st.t0.copy_(t0)
    st.flags.copy_(torch.stack([st.n_leaves.to(torch.float32), gain.max(),
                                st.valid_w.sum().to(torch.float32)]))


def read_flags(st: GrowState):
    """The one read of a wave: the live lane count of the next wave, or
    None when the tree is done (``wave_cond`` fails)."""
    n_leaves, max_gain, live = st.flags.tolist()
    if not (n_leaves < st.params.num_leaves and max_gain > 0):
        return None
    return int(live)


def wave_body(st: GrowState, wide: bool = False) -> None:
    """One wave after its flag read: ``wave_body`` / ``wave_body_c2f`` and
    ``commit_wave`` (:1293-1339, :1432-1724), then the next wave's lanes
    and flags.  ``wide`` (c2f only, :meth:`GrowState.is_wide`): more than
    W/2 lanes are live, so the windowed pass takes all 2W children."""
    p = st.params
    sp = p.split
    L = p.num_leaves
    W = st.width
    shift = p.refine_shift
    i32 = torch.int32
    best, rec = st.best, st.rec
    ids, topg, valid_w = st.ids, st.topg, st.valid_w
    dummy = torch.full_like(ids, L)
    ids_leaf = torch.where(valid_w, ids, dummy)
    t_j = st.t0 + st.w_ar
    ids_rec = torch.where(valid_w, t_j, torch.full_like(t_j, L - 1))
    new_ids = t_j + 1
    new_leaf = torch.where(valid_w, new_ids, dummy)

    cw = {k: v.index_select(0, ids) for k, v in best.items()}
    lstat_w = cw["left_stats"]
    rstat_w = st.leaf_stats.index_select(0, ids) - lstat_w
    small_left_w = lstat_w[:, 2] <= rstat_w[:, 2]
    depth_w = st.leaf_depth.index_select(0, ids) + 1
    if st.mono is not None:
        # the children's output bounds (:1461-1466, :1658-1663)
        l_min, l_max, r_min, r_max = child_bounds(
            lstat_w, rstat_w, st.leaf_min.index_select(0, ids),
            st.leaf_max.index_select(0, ids), cw["feature"], cw.get("is_cat"),
            st.mono, sp)

    if st.route_outside:
        hist_small = _route_wave(st, ids_leaf, cw, small_left_w, new_ids)
    else:
        rows = [ids_leaf, cw["feature"], cw["threshold"], new_ids,
                small_left_w]
        if sp.any_missing:
            rows.append(cw["default_left"])
        tbl = torch.stack([r.to(i32) for r in rows])
        hist_small, leaf_out, _ = routed_histogram(
            st.xt, st.kvals, st.leaf_idx, tbl, st.Bp, W, p.two_col,
            st.miss_bin, leaf_bound=st.leaf_bound, shift=shift)
        st.leaf_idx.copy_(leaf_out)
    hist_large = larger_child(st.pool.index_select(0, ids), hist_small,
                              st.hist_scale)
    hist_small = _dequant(st, hist_small)
    sl4 = small_left_w[:, None, None, None]
    hist_l = torch.where(sl4, hist_small, hist_large)
    hist_r = torch.where(sl4, hist_large, hist_small)
    if shift:
        # children interleaved [l0, r0, l1, r1, ...]: live children form a
        # prefix, so the children past W hold rows only when more than W/2
        # lanes are live (:1648-1688).  Then one pass takes all 2W lanes
        # (the reference's two passes of W come from its lane width; live
        # child ids are distinct and dummy ids match no row, so the sums
        # are the same), else W lanes and zeros for the rest.
        def pair(a, b):
            return torch.stack([a, b], 1).reshape((2 * W,) + a.shape[1:])

        ch_ids = pair(ids_leaf, new_leaf)
        ch_hist = pair(hist_l, hist_r)
        ch_stats = pair(lstat_w, rstat_w)
        ch_depth = pair(depth_w, depth_w)
        ch_bounds = None if st.mono is None else torch.stack(
            [pair(l_min, r_min), pair(l_max, r_max)], 1)        # (2W, 2)
        win_lo = _window(st, ch_hist, ch_stats, ch_bounds)      # (2W, F)
        lane_ids = ch_ids.to(i32)
        if wide:
            win = lanes_window_histogram(
                st.xt, st.kvals, st.leaf_idx, lane_ids, win_lo, st.R, 2 * W,
                p.two_col, st.miss_bin, st.leaf_bound)
        else:
            win = lanes_window_histogram(
                st.xt, st.kvals, st.leaf_idx, lane_ids[:W], win_lo[:W], st.R,
                W, p.two_col, st.miss_bin, st.leaf_bound)
            win = torch.cat([win, torch.zeros_like(win)])
        win = _dequant(st, win)
        bests = _scan_c2f(st, ch_hist, win, win_lo, ch_stats, ch_depth,
                          ch_bounds, WAVE)
    else:
        ch_ids = torch.cat([ids_leaf, new_leaf])
        ch_hist = torch.cat([hist_l, hist_r])
        ch_stats = torch.cat([lstat_w, rstat_w])
        ch_depth = torch.cat([depth_w, depth_w])
        ch_bounds = None if st.mono is None else torch.stack(
            [torch.cat([l_min, r_min]), torch.cat([l_max, r_max])], 1)
        # all 2W children's best splits in one batched scan
        bests = _best_splits(ch_hist, ch_stats, ch_depth, st, ch_bounds,
                             WAVE)

    st.pool.index_copy_(0, ch_ids, ch_hist)
    st.leaf_stats.index_copy_(0, ch_ids, ch_stats)
    st.leaf_depth.index_copy_(0, ch_ids, ch_depth)
    for k, arr in best.items():
        arr.index_copy_(0, ch_ids, bests[k].to(arr.dtype))
    if ch_bounds is not None:
        # commit_wave's bounds (:1309-1322)
        st.leaf_min.index_copy_(0, ch_ids, ch_bounds[:, 0].contiguous())
        st.leaf_max.index_copy_(0, ch_ids, ch_bounds[:, 1].contiguous())
        for k, val in (("left_min", l_min), ("left_max", l_max),
                       ("right_min", r_min), ("right_max", r_max)):
            rec[k].index_copy_(0, ids_rec, val)
    for k, val in (("leaf", ids), ("feature", cw["feature"]),
                   ("threshold", cw["threshold"]),
                   ("default_left", cw["default_left"]),
                   ("gain", topg), ("left_stats", lstat_w),
                   ("right_stats", rstat_w),
                   ("left_mask", cw["left_mask"]), ("valid", valid_w),
                   ("is_cat", cw.get("is_cat"))):
        if k in rec:
            rec[k].index_copy_(0, ids_rec, val.to(rec[k].dtype))
    st.n_leaves.add_(valid_w.sum().to(i32))
    _wave_head(st)


def _route_wave(st: GrowState, ids_leaf, cw: dict, small_left_w,
                new_ids) -> torch.Tensor:
    """A wave's rows routed by their lanes' left masks, outside the pass
    (the non-routed branch of ``wave_body``, :1497-1516): each row's lane
    from the leaf -> lane table (-1 outside the wave), its bin in its
    lane's split column, goes left where that bin is in the lane's mask
    (bundled: the split feature's bundle column and its mask translated
    onto the bundle's bins, ``col_of_lane`` and ``lane_mask``); the rows
    bound for the smaller child go to the batched pass (kernel M) as their
    lane's subset, and the rows that go right move to the lane's new leaf.
    -> the smaller children's raw histograms (W, G, B, 3)."""
    W = st.width
    li = st.leaf_idx
    lane_of = st.lane_of
    lane_of.fill_(-1)
    # invalid lanes write -1 to the dummy row L, which no row holds
    lane_of.index_put_((ids_leaf,), torch.where(
        st.valid_w, st.w_ar, torch.full_like(st.w_ar, -1)))
    lane = lane_of.index_select(0, li.to(torch.int64))      # (N,)
    in_wave = lane >= 0
    w = lane.clamp(min=0)
    col_of_lane = cw["feature"].to(torch.int64)
    lane_mask = cw["left_mask"]
    if st.bundles is not None:
        lane_mask = torch.gather(lane_mask, 1, st.bundles.from_bundle
                                 .index_select(0, col_of_lane))
        col_of_lane = st.bundles.group.index_select(0, col_of_lane)
    feat = col_of_lane.index_select(0, w)
    col = torch.gather(st.xt, 0, feat[None]).squeeze(0).to(torch.int64)
    goes_left = in_wave & lane_mask[w, col]
    to_small = goes_left == small_left_w.index_select(0, w)
    sel = torch.where(in_wave & to_small, lane,
                      torch.full_like(lane, -1)).to(torch.int8)
    hist = multi_histogram(st.xt, st.kvals, sel, st.Bp, W,
                           st.params.two_col)
    moved = in_wave & ~goes_left
    st.leaf_idx.copy_(torch.where(moved, new_ids.index_select(0, w).to(
        li.dtype), li))
    return hist


def tree_tail(st: GrowState) -> None:
    """A tree's last phase: the leaf values from the leaf stats (clipped to
    the leaves' monotone bounds) and, under quantization, their renewal
    from full-precision sums (RenewIntGradTreeOutput) keyed by the final
    leaf assignment (kernel Q); no value where the tree did not split."""
    p = st.params
    sp = p.split
    L = p.num_leaves
    leaf_stats_ = st.leaf_stats[:L]
    leaf_values = leaf_output(leaf_stats_[:, 0], leaf_stats_[:, 1],
                              sp.lambda_l1, sp.lambda_l2, sp.max_delta_step)
    if st.mono is not None:
        # the monotone bounds' clip (:1742-1744); the renewal below does
        # not clip, as the JAX package's does not (:1771-1798)
        leaf_values = torch.minimum(torch.maximum(
            leaf_values, st.leaf_min[:L]), st.leaf_max[:L])
    final = leaf_values
    if p.quantize:
        ex = leaf_stats(st.leaf_idx, st.grad_raw, st.hess_raw,
                        st.sample_mask, L)
        st.leaf_stats_exact.copy_(ex)
        final = torch.where(ex[:, 2] > 0,
                            leaf_output(ex[:, 0], ex[:, 1], sp.lambda_l1,
                                        sp.lambda_l2, sp.max_delta_step),
                            leaf_values)
    st.leaf_values.copy_(leaf_values)
    st.leaf_values_final.copy_(torch.where(st.n_leaves > 1, final,
                                           torch.zeros_like(final)))

