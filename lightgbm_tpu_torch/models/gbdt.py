"""GBDT boosting loop.

Counterpart of ``lightgbm_tpu/models/gbdt.py`` for the serial learner:
``records_to_tree`` (:38-125, with categorical splits, the monotone
bounds' clip, the quantized renewal and the two-column count restore) and
``_constraint_tuples`` (:788-809) are copied; the serial subset of
the tier resolution (:381-418, :491-512: wave growth, two-column passes,
coarse-to-fine refinement, quantized gradients, the lane width, and the
categorical gate: no two-column passes, no coarse-to-fine, no in-pass
routing), one
boosting iteration (:2245-2310: boost_from_average, gradients, tree build
with the tree's quantization key, score update) and the fused super-step
(``_fused_ok``, ``_fused_bias_pending``, ``_train_superstep``,
``_serve_fused``, the stop replay and the rewind ``_fused_rewind``,
:1194-1225, :1476-1880, :2455-2480), validation sets (``ValidSet``,
``add_valid``, :1020-1054; the per-tree valid score update, :2608-2631)
and the evaluation (``eval_set``, ``_eval_one_set``, :2866-2900) are
ported.

Row sampling (bernoulli and stratified bagging here, GOSS and MVS in
``models/boosting.py``) draws a float32 weight a row inside each tree's
head, so that the draw is part of the tree's CUDA graph: the gradients
are multiplied by it and the tree's sample mask set to where it is above
0, as ``_dispatch_build`` does (:2104-2126).  The draw is keyed by the
PRNG fold of the tree's global iteration (the slot's ``bag_words``), so
fused and sequential runs draw the same bits; bagging's
``bagging_freq`` cache is the draw of the last redraw's iteration,
computed anew for each tree, so no sampling state outlives a block.

The score update is the one the JAX package's iteration performs, from
the build's own float32 leaf values (renewed under quantization):
``score += leaf_values_final * learning_rate`` gathered by leaf id
(kernel L on the card).  The learning rate is a device float32 scalar the
host writes before a block's trees, so a captured graph multiplies by the
current rate, and each block records the rate its trees were built with:
its host trees are shrunk by that rate, and a served block whose rate
differs from the current one (a ``learning_rates`` schedule) is rewound
to its served boundary before the next tree.

A validation set holds its binned matrix on the booster's device and a
float64 score.  After each tree its scorer (``ops/graphs.py``
``ValidScorer``) routes the valid rows through the tree's device records
(``route_rows``, kernel T) and adds the shrunken float32 leaf values into
the score with kernel L's float64 mode; on the card it replays as one
CUDA graph a valid set.  Validation sets and a training metric turn the
fused super-step off (``_fused_ok``), as in the JAX package: each iteration's
metrics read the scores after its tree; a set attached mid-block rewinds
the block.  Each tree runs through an ``ops/graphs.py``
runner: on the card as replays of CUDA graphs from the second tree on,
eagerly on the CPU (or when the booster is made with ``eager=True``).

Trees are dispatched in blocks, each with one packed fetch of its
records: with ``fused_iters = K > 1`` a block holds K trees (the tail
block fewer, down to ``num_iterations``; iteration 0 under
``boost_from_average`` runs alone, unfused), else one.  With
``superstep_pipeline_depth = d`` up to d more blocks are dispatched
before the oldest one's records land.  A block keeps a device copy of its
start score and each tree's leaf values and leaf assignment; a tree that
cannot split (the stop tree) ends training, drops the blocks dispatched
after it (their feature-fraction draws and tree ids are rewound) and
replays the score of the trees before it.  ``update()`` serves one tree a
call, as the per-iteration path does; trees, scores and predictions are
the same bits at every K and depth.  ``rollback_one_iter`` (:3299-3344,
:1881-1899) pops the last served tree and restores the score from its
block's start copy.

DART, random forests (``models/boosting.py``) and the objectives that
refit their leaves (L1, quantile, MAPE) need the host tree every
iteration (``_per_tree_host``; the JAX package's ``_superstep_enabled``,
``_pipeline_enabled`` and the renewal exclusion of ``_fused_ok``,
:202-227, :1163-1216): they run blocks of one tree, the tree's tail adds
nothing to the score, and the booster adds the host tree's float32 leaf
values once the tree lands (``_landed``), after the objective's renewal
(``renew_tree_output`` on the score before the tree, its leaf ids and its
sample mask, :2589-2593), as the JAX package's per-iteration path does
(:2590-2631).

A multiclass objective trains K = ``num_tree_per_iteration`` trees an
iteration (:213-217, :2485-2534), one a class, without fusion: the
training score is (K, N) and a validation set's (K, n), each row padded
to 16 bytes for kernel L.  Class 0's head computes the (K, N) gradients
of the iteration's starting score into static buffers, and class k's
head reads row k, so each class's tree is one CUDA graph (a head and a
tail a class on the wave loop) and trains on the gradients the JAX
package gives it; its tail adds into row k.  Each class tree draws its
own feature-fraction mask and quantization tree id, in tree order; a
sample (bagging, GOSS, MVS) is the iteration's: class 0's head draws it
once from the (K, N) gradients into a static buffer its K trees read.
An iteration stops training only when all its K trees have one leaf.

Custom gradients (``train_one_iter(grad, hess)``, a ``fobj``; also a
booster without an objective, :2457-2536) are copied from a pinned host
buffer into static (K, N) buffers, and every tree's head reads them
there: such an iteration is a block of its own, without boost_from_average;
a head captured for the other kind of gradients is captured anew.  The
metrics get each set's query boundaries (ranking: ``ndcg@k``,
``map@k``).

The numerical-health checks (``utils/health.py``, the JAX package's
``_check_tree_health``, ``_check_stop_health`` and the super-step's
``nonfinite`` flag, :1363-1373, :1684-1702, :2215-2240) read what the
host fetches anyway: each tree's record row carries the minimum and
maximum of its gradients, hessians, leaf values and score row, computed
in the tree's graphs, and a landed block is checked before it is served.
A failing block is dropped with every block after it and the booster put
back at its served boundary before ``NumericalHealthError`` is raised.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..config import Config
from ..io.binning import BIN_CATEGORICAL
from ..io.bundle import find_bundles
from ..io.dataset import TorchDataset
from ..objectives import Objective
from ..ops import sample
from ..ops.graphs import TreeRunner, ValidScorer
from ..ops.grow import (BOUND_RECORDS, GrowParams, GrowState, key_words,
                        tree_head, tree_tail)
from ..ops.histogram import multi_width
from ..ops.lookup import take_small_add
from ..ops.predict import flatten_forest, predict_raw
from ..ops.split import SplitParams
from ..utils import prng
from ..utils.health import abort_nonfinite
from ..utils.log import Log
from .tree import Tree, cat_bitset

__all__ = ["GBDT", "ValidSet", "records_to_tree", "host_records",
           "record_layout", "pack_records", "fetch_records"]

_KEPS = 1e-15
# the records the host reads of a tree (records_to_tree), besides the leaf
# count and, under quantization, the renewal sums
_HOST_RECORDS = ("leaf", "feature", "threshold", "default_left", "gain",
                 "left_stats", "right_stats", "valid")
# the ``health`` record's (8,) float32 words: the minimum and maximum of the
# tree's gradients, hessians, final leaf values and score row
_H_GRAD, _H_HESS, _H_VALS, _H_SCORE = (slice(0, 2), slice(2, 4),
                                       slice(4, 6), slice(6, 8))


def class_rows(num_class: int, n: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """A zero score: (n,) for one class, else a (num_class, n) view of
    rows padded to 16 bytes (kernel L adds into a row's aligned words)."""
    if num_class == 1:
        return torch.zeros(n, dtype=dtype, device=device)
    n16 = -(-n * dtype.itemsize // 16) * 16 // dtype.itemsize
    return torch.zeros((num_class, n16), dtype=dtype,
                       device=device)[:, :n]


def _class_row(score: torch.Tensor, k: int) -> torch.Tensor:
    """Class k's row of a score ((n,) for one class)."""
    return score if score.dim() == 1 else score[k]


def _pad_bins(max_bin: int) -> int:
    """Bins padded to a multiple of 8 (``lightgbm_tpu/ops/histogram.py:99``),
    the stream size of the coarse-to-fine gate."""
    return (max_bin + 7) // 8 * 8


def records_to_tree(rec, config, train_set, counts_proxy=False) -> Tree:
    """Materialize one host :class:`Tree` from a fetched split-record
    dict.  A categorical record (``is_cat``) becomes a split on the
    categories of its left mask's bins (bin 0 and the missing bin hold
    none; ``[0]`` when no category is left).  With ``leaf_stats_exact``
    (quantized training) the leaf values are renewed from the
    full-precision sums, without the monotone clip, as the JAX package
    renews them (:98-104);
    with ``counts_proxy`` (two-column passes, whose count slots hold hess
    sums) the leaf and internal counts are restored from them.  With the
    children's monotone bounds (``left_min`` ...) each split's child
    values are clipped to them (:69-75)."""
    cfg = config
    ds = train_set
    tree = Tree(cfg.num_leaves)

    def _thl1(s, l1):
        return np.sign(s) * max(abs(s) - l1, 0.0) if l1 > 0 else s

    def out(g, h):
        o = -np.sign(_thl1(g, cfg.lambda_l1)) * abs(
            _thl1(g, cfg.lambda_l1)) / (h + cfg.lambda_l2 + _KEPS)
        if cfg.max_delta_step > 0:
            o = np.clip(o, -cfg.max_delta_step, cfg.max_delta_step)
        return float(o)

    for i in range(cfg.num_leaves - 1):
        if not bool(rec["valid"][i]):
            break
        leaf = int(rec["leaf"][i])
        real_f = ds.real_feature_index(int(rec["feature"][i]))
        mapper = ds.mappers[real_f]
        ls = rec["left_stats"][i]
        rs = rec["right_stats"][i]
        lv, rv = out(ls[0], ls[1]), out(rs[0], rs[1])
        if "left_min" in rec:
            # the monotone bounds, which the device loop clipped to as well
            lv = float(np.clip(lv, rec["left_min"][i], rec["left_max"][i]))
            rv = float(np.clip(rv, rec["right_min"][i],
                               rec["right_max"][i]))
        if "is_cat" in rec and bool(rec["is_cat"][i]):
            bins = np.nonzero(rec["left_mask"][i])[0]
            cats = [mapper.bin_2_categorical[b] for b in bins
                    if 0 < b < len(mapper.bin_2_categorical)] or [0]
            tree.split_categorical(
                leaf, real_f, cat_bitset(cats), lv, rv, float(ls[1]),
                float(rs[1]), int(round(ls[2])), int(round(rs[2])),
                float(rec["gain"][i]), mapper.missing_type)
        else:
            thr_bin = int(rec["threshold"][i])
            tree.split(leaf, real_f, thr_bin, mapper.bin_to_value(thr_bin),
                       lv, rv, float(ls[1]), float(rs[1]),
                       int(round(ls[2])), int(round(rs[2])),
                       float(rec["gain"][i]), mapper.missing_type,
                       bool(rec["default_left"][i]))
        node = tree.num_leaves - 2
        tree.internal_value[node] = out(ls[0] + rs[0], ls[1] + rs[1])
    if "leaf_stats_exact" in rec:
        # RenewIntGradTreeOutput: leaf outputs from full-precision sums
        ex = np.asarray(rec["leaf_stats_exact"], np.float64)
        for leaf in range(tree.num_leaves):
            if leaf < len(ex) and ex[leaf, 2] > 0:
                tree.leaf_value[leaf] = out(ex[leaf, 0], ex[leaf, 1])
        if counts_proxy:
            # real counts: leaves from the renewal sums, internal nodes in
            # one reverse-id sweep (a child's node id exceeds its parent's)
            for leaf in range(tree.num_leaves):
                if leaf < len(ex):
                    tree.leaf_count[leaf] = int(round(ex[leaf, 2]))

            def child_count(c):
                return tree.leaf_count[~c] if c < 0 else \
                    tree.internal_count[c]

            for node in range(tree.num_leaves - 2, -1, -1):
                tree.internal_count[node] = \
                    child_count(tree.left_child[node]) + \
                    child_count(tree.right_child[node])
    return tree


def host_records(st: GrowState) -> dict:
    """The device records of the tree in ``st`` that the host reads: the
    split records (with categorical features also each split's kind and
    left mask; with monotone constraints its children's bounds), the leaf
    count and, under quantization, the renewal sums
    ``leaf_stats_exact``."""
    S = st.params.num_leaves - 1
    keys = _HOST_RECORDS + (("is_cat", "left_mask") if "is_cat" in st.rec
                            else ()) + tuple(k for k in BOUND_RECORDS
                                             if k in st.rec)
    rec = {k: st.rec[k][:S] for k in keys}
    rec["n_leaves"] = st.n_leaves
    if st.leaf_stats_exact is not None:
        rec["leaf_stats_exact"] = st.leaf_stats_exact
    return rec


def record_layout(rec: dict) -> list:
    """(key, shape, dtype) of each record, in packing order."""
    return [(k, tuple(rec[k].shape), rec[k].dtype) for k in sorted(rec)]


def pack_records(rec: dict, layout: list, out: torch.Tensor) -> None:
    """Every record into one float64 row ``out`` (every value — ids,
    bins, float32 stats, flags — is exact in float64)."""
    torch.cat([rec[k].to(torch.float64).reshape(-1) for k, _, _ in layout],
              out=out)


def fetch_records(rows: torch.Tensor, layout: list) -> dict:
    """(K, P) packed rows -> each record as a (K, ...) numpy array of its
    own dtype, in one copy to the host (none for host rows)."""
    flat = rows.cpu().numpy()
    K = flat.shape[0]
    out, off = {}, 0
    for k, shape, dtype in layout:
        size = int(np.prod(shape)) if shape else 1
        vals = flat[:, off:off + size].reshape((K,) + shape)
        if dtype == torch.bool:
            vals = vals > 0.5
        elif dtype == torch.float32:
            vals = vals.astype(np.float32)
        else:
            vals = vals.astype(np.int64)
        out[k] = vals
        off += size
    return out


class ValidSet:
    """A validation set: its raw rows (host; a scipy matrix stays sparse),
    labels and weights, its binned matrix ``xt`` (F, N), or the (G, N)
    bundle matrix when the booster bundles (``bundles``, the
    :class:`FeatureBundles`; ``lightgbm_tpu/models/gbdt.py:1047-1048``), and
    float64 score (N,) ((K, N) for K classes) on the booster's device, and
    its scorer."""

    def __init__(self, name: str, raw, data: TorchDataset,
                 device: torch.device, num_class: int = 1, bundles=None):
        self.name = name
        self.raw = raw
        self.metadata = data.metadata
        self.xt = data.binned.to(device)
        if bundles is not None:
            self.xt = bundles.bundle_columns(self.xt)
        self.label = data.label.to(device=device, dtype=torch.float64)
        self.weight = None if data.weight is None else \
            data.weight.to(device=device, dtype=torch.float64)
        self.score = class_rows(num_class, data.num_data, torch.float64,
                                device)
        self.scorer: ValidScorer = None
        # DART: each tree's leaf ids on this set (None for a constant tree)
        self.leaf_idx_per_tree: list = []


class GBDT:
    """Gradient boosting loop of the port (serial learner, gbdt, with
    bernoulli and stratified bagging).

    ``metrics``: the evaluation metrics (``metrics.create_metrics``).
    ``eager=True`` launches every tree's kernels from Python on the card
    too, as the port did before its trees ran on CUDA graphs (for
    profiling and for the tests that hold the graphs to it)."""

    # DART and random forests need the host tree each iteration
    # (lightgbm_tpu/models/gbdt.py:202-227): blocks of one tree, no fused
    # super-step, and the tree's values added to the scores after it lands
    # instead of in its tail graph.  An instance also needs it when its
    # objective refits leaves (set in __init__)
    _per_tree_host = False
    # whether a stop iteration's gradients are checked (random forests'
    # iteration has no stop, lightgbm_tpu/models/boosting.py:417-439)
    _stop_health = True

    def __init__(self, config: Config, train_set: TorchDataset,
                 objective: Objective, metrics=(), eager: bool = False):
        config.check_supported()
        self.config = config
        self.train_set = train_set
        self.objective = objective
        self.metrics = list(metrics)
        self.valid_sets: List[ValidSet] = []
        self.device = train_set.device
        self.models: List[Tree] = []
        self.iter = 0
        self.num_class = max(int(config.num_class), 1)
        # a custom objective (objective None) trains one tree an iteration
        self.num_tree_per_iteration = C = 1 if objective is None else int(
            objective.num_model_per_iteration)
        self._per_tree_host = type(self)._per_tree_host or (
            objective is not None and objective.renews)
        # random forests average their trees' outputs
        self.average_output = False
        # the host's rate (callbacks change it) and the device's, which the
        # captured tail reads; written before a block whose rate differs
        self.shrinkage_rate = config.learning_rate
        self.num_data = train_set.num_data
        F = len(train_set.used_features)
        self.num_features = F
        mappers = [train_set.mappers[i] for i in train_set.used_features]
        self.max_bin = int(2 ** np.ceil(np.log2(max(
            train_set.max_bin_count, 2))))
        dev = self.device
        self._xt = self._bundle(config, train_set, mappers)
        config.check_histogram_pool(self._xt.shape[0], self.max_bin)
        self._num_bins = torch.as_tensor([m.num_bin for m in mappers],
                                         dtype=torch.int32, device=dev)
        self._missing_type = torch.as_tensor(
            [m.missing_type for m in mappers], dtype=torch.int32, device=dev)
        any_missing = bool(any(m.missing_type != 0 for m in mappers))
        self._is_cat = torch.as_tensor(
            [m.bin_type == BIN_CATEGORICAL for m in mappers],
            dtype=torch.bool, device=dev)
        any_cat = bool(any(m.bin_type == BIN_CATEGORICAL for m in mappers))
        # tiers of the serial learner (lightgbm_tpu/models/gbdt.py:381-418,
        # :491-512).  Non-wave speculative arming grows the same trees as
        # the plain loop at speculative_tolerance=0, so it is not a tier
        # here.  Categorical features and bundles turn off the two-column
        # passes (their scans and the default bins' rebuild read real
        # counts), coarse-to-fine and the in-pass routing (their splits
        # need bin masks): :391-396, :410-418, :911-914
        wave_on = bool(config.wave_splits)
        plain_bins = not any_cat and self._bundles is None
        two_col = bool(config.use_quantized_grad and wave_on and
                       plain_bins and config.min_data_in_leaf <= 1 and
                       config.min_sum_hessian_in_leaf > 0)
        self._counts_proxy = two_col
        # coarse-to-fine refinement: the JAX package's stream-size gate
        # (lightgbm_tpu/models/gbdt.py:410-418), unchanged
        refine_shift = 0
        if (config.hist_refinement and wave_on and plain_bins and
                self.max_bin >= 48 and
                F * _pad_bins(self.max_bin) >= 7000):
            refine_shift = 4 if self.max_bin > 64 else 3
        quantize = config.num_grad_quant_bins \
            if config.use_quantized_grad else 0
        self.grow_params = GrowParams(
            split=SplitParams(
                max_bin=self.max_bin,
                lambda_l1=config.lambda_l1,
                lambda_l2=config.lambda_l2,
                min_data_in_leaf=config.min_data_in_leaf,
                min_sum_hessian_in_leaf=config.min_sum_hessian_in_leaf,
                min_gain_to_split=config.min_gain_to_split,
                max_delta_step=config.max_delta_step,
                max_cat_to_onehot=config.max_cat_to_onehot,
                max_cat_threshold=config.max_cat_threshold,
                cat_l2=config.cat_l2,
                cat_smooth=config.cat_smooth,
                min_data_per_group=config.min_data_per_group,
                any_missing=any_missing,
                any_cat=any_cat,
                counts_proxy=two_col,
                **self._constraint_tuples(config, train_set)),
            num_leaves=config.num_leaves,
            max_depth=config.max_depth,
            quantize=quantize,
            two_col=two_col,
            wave=wave_on,
            speculate=min(multi_width(bool(config.use_quantized_grad),
                                      two_col), config.num_leaves)
            if wave_on else 0,
            refine_shift=refine_shift)
        # quantization key stream: one fold per dispatched tree
        self._quant_key = prng.prng_key(
            config.data_random_seed & 0x7FFFFFFF) if quantize else None
        self._trees_dispatched = 0
        self.last_waves = 0
        self._mask = torch.ones(self.num_data, dtype=torch.float32,
                                device=dev)
        self._score = class_rows(C, self.num_data, torch.float32, dev)
        # a multiclass iteration's gradients, written by class 0's head;
        # custom gradients (train_one_iter(grad, hess)) go there too, from
        # a pinned host buffer, and every head then reads them
        self._grad_all = torch.zeros((C, self.num_data), device=dev) \
            if C > 1 else None
        self._hess_all = torch.zeros_like(self._grad_all) \
            if C > 1 else None
        self._host_gh = None
        self._custom = False
        self._rng_feature = np.random.RandomState(
            config.feature_fraction_seed & 0x7FFFFFFF)
        if objective is not None:
            objective.init(train_set.metadata, self.num_data, dev)
        # row sampling: a weight a row drawn in each tree's head from the
        # key words of the tree's iteration (:meth:`_sample_words`), which a
        # block's slot holds like the quantization words
        # (lightgbm_tpu/models/gbdt.py:732, :2104-2126)
        self._bag_key = prng.prng_key(config.bagging_seed & 0x7FFFFFFF)
        self._sampled = self._samples()
        self._bag_words = torch.zeros(4, dtype=torch.int64, device=dev)
        # a multiclass iteration's weights, drawn by class 0's head from the
        # (K, N) gradients and read by every class tree's
        self._class_w = torch.zeros(self.num_data, device=dev) \
            if self._sampled and C > 1 else None
        self._label_pos = (train_set.label > 0).to(torch.uint8) \
            if self._bagging_active() and self._pos_neg() else None

        # one tree's static buffers, its device epilogue and its runner
        self._state = st = GrowState(self._xt, self._mask, self._num_bins,
                                     self._missing_type, self.grow_params,
                                     self._is_cat if any_cat else None,
                                     self._bundle_maps)
        self._vals = torch.zeros(config.num_leaves, dtype=torch.float32,
                                 device=dev)
        self._lr = torch.full((), self.shrinkage_rate, dtype=torch.float32,
                              device=dev)
        self._lr_host = self.shrinkage_rate
        # the numerical-health words, written in the tree's graphs
        # (:meth:`_minmax`) and packed with its records
        self._health = torch.zeros(8, dtype=torch.float32, device=dev)
        self._layout = record_layout(self._host_records())
        self._row = torch.zeros(sum(int(np.prod(s)) if s else 1
                                    for _, s, _ in self._layout),
                                dtype=torch.float64, device=dev)
        self.runner = TreeRunner(st, self._tree_head, self._tree_tail,
                                 graphs=not eager and dev.type == "cuda",
                                 classes=C)
        # blocks: dispatched and not landed (oldest first), the one being
        # served, and the ring of their buffers
        self._sq: list = []
        self._fused_block = None
        self._stop_flag = False
        self._slots: list = []
        self._next_slot = 0
        # trees of each landed block, and its one records fetch
        self.block_sizes: List[int] = []
        self.records_fetches = 0

    @staticmethod
    def _constraint_tuples(config: Config, train_set: TorchDataset) -> dict:
        """``monotone`` and ``penalty`` of the split parameters
        (``lightgbm_tpu/models/gbdt.py:788-809``): the config's lists are
        indexed by original column, remapped through ``used_features``
        (missing entries neutral: 0 and 1.0); a tuple stays empty where
        all of it is neutral, so the unconstrained scans run.  With EFB
        they stay over logical features."""
        used = train_set.used_features
        mono = ()
        if config.monotone_constraints:
            mc = list(config.monotone_constraints)
            vals = [int(mc[i]) if i < len(mc) else 0 for i in used]
            if any(vals):
                mono = tuple(vals)
        pen = ()
        if config.feature_contri:
            fc = list(config.feature_contri)
            vals = [float(fc[i]) if i < len(fc) else 1.0 for i in used]
            if any(v != 1.0 for v in vals):
                pen = tuple(vals)
        return {"monotone": mono, "penalty": pen}

    def _bundle(self, config: Config, train_set: TorchDataset,
                mappers) -> torch.Tensor:
        """Exclusive feature bundling (``lightgbm_tpu/models/gbdt.py:303-350``,
        the reference's FindGroups / FastFeatureBundling): the JAX package's
        groups, found on the same row sample, kept where the histogram
        passes' cost model says they pay: ``G * pad(max(B, B_bun)) < 0.95 *
        F * pad(B)`` (bins padded to a multiple of 8) with fewer groups than
        features.  Then the committed width is ``max(B, B_bun)``, not
        rounded to a power of two, and the device maps and the (G, N)
        bundle matrix are made.  Categorical features take default bin 0.
        -> the matrix growth reads ((F, N) unbundled).  ``_bundles`` is the
        :class:`FeatureBundles` (None unbundled), ``_bundle_maps`` its
        device maps."""
        self._bundles = None
        self._bundle_maps = None
        F = len(mappers)
        if not config.enable_bundle or F <= 1:
            return train_set.binned
        db = np.asarray([0 if m.bin_type == BIN_CATEGORICAL else m.default_bin
                         for m in mappers], np.int32)
        nb = np.asarray([m.num_bin for m in mappers], np.int32)
        bundles = find_bundles(train_set.binned, nb, db,
                               max_conflict_rate=config.max_conflict_rate,
                               bin_budget=min(config.max_bin, 255),
                               seed=config.data_random_seed)
        B_bun = int(bundles.group_num_bins.max())
        cost_bundled = bundles.num_groups * _pad_bins(max(self.max_bin, B_bun))
        if bundles.num_groups >= F or \
                cost_bundled >= 0.95 * F * _pad_bins(self.max_bin):
            return train_set.binned
        self._bundles = bundles
        self.max_bin = max(self.max_bin, B_bun)
        self._bundle_maps = bundles.device_maps(self.max_bin, nb, self.device)
        Log.info("EFB: bundled %d features into %d groups", F,
                 bundles.num_groups)
        return bundles.bundle_columns(train_set.binned)

    # ---- one tree on the device ---------------------------------------

    def _gradients(self):
        """The objective's gradients at the training score."""
        return self.objective.get_gradients(self._score)

    def _tree_head(self, k: int = 0) -> None:
        """The gradients, weighted by the tree's sample where it has one
        (its presence mask into the tree's static sample mask), then the
        tree's head (lightgbm_tpu/models/gbdt.py:2104-2126).  Class k of a
        multiclass iteration reads row k of the iteration's gradients,
        which class 0's head computes from the starting score, and the
        iteration's sample, which class 0's head draws from all K rows of
        them (the JAX package's one ``bag`` an iteration, :2526-2530).
        Custom gradients are read from the static buffers they were
        copied to.  The health words take the gradients' and hessians'
        range before the sample weighs them: all K rows at class 0's head
        (the JAX package's stop check reads the iteration's K rows,
        :2536), which the iteration's other class trees carry on."""
        C = self.num_tree_per_iteration
        if self._custom:
            grad, hess = self._grad_all[k], self._hess_all[k]
            if k == 0:
                self._minmax(self._grad_all, _H_GRAD)
                self._minmax(self._hess_all, _H_HESS)
        elif C == 1:
            grad, hess = self._gradients()
            self._minmax(grad, _H_GRAD)
            self._minmax(hess, _H_HESS)
        else:
            if k == 0:
                g, h = self._gradients()
                self._grad_all.copy_(g)
                self._hess_all.copy_(h)
                self._minmax(self._grad_all, _H_GRAD)
                self._minmax(self._hess_all, _H_HESS)
            grad, hess = self._grad_all[k], self._hess_all[k]
        if self._sampled:
            if C == 1:
                w = self._sample_weights(self._bag_words, grad, hess)
                self._mask.copy_(w > 0)
            else:
                w = self._class_w
                if k == 0:
                    w.copy_(self._sample_weights(self._bag_words,
                                                 self._grad_all,
                                                 self._hess_all))
                    self._mask.copy_(w > 0)
            grad, hess = grad * w, hess * w
        tree_head(self._state, grad, hess)

    def _tree_tail(self, k: int = 0) -> None:
        """The leaf values, the score add where the tail makes it, the
        health words of both (the JAX super-step's flag reads the values
        and the new score, :1370-1373) and the packed records."""
        st = self._state
        tree_tail(st)
        self._minmax(st.leaf_values_final, _H_VALS)
        if not self._per_tree_host:
            torch.mul(st.leaf_values_final, self._lr, out=self._vals)
            row = _class_row(self._score, k)
            take_small_add(row, self._vals, st.leaf_idx)
            self._minmax(row, _H_SCORE)
        pack_records(self._host_records(), self._layout, self._row)

    def _minmax(self, x: torch.Tensor, words: slice) -> None:
        """``x``'s minimum and maximum into two health words: one
        reduction on the device, non-finite exactly when some element is
        (both reductions propagate NaN), read with the tree's records."""
        h = self._health[words]
        torch.aminmax(x, out=(h[0], h[1]))

    def _host_records(self) -> dict:
        """What the host fetches of a tree: :func:`host_records` and the
        health words."""
        return dict(host_records(self._state), health=self._health)

    def _feature_fraction_mask(self) -> np.ndarray:
        F = self.num_features
        frac = self.config.feature_fraction
        mask = np.zeros(F, bool)
        if frac >= 1.0:
            mask[:] = True
        else:
            k = max(1, int(frac * F))
            mask[self._rng_feature.choice(F, size=k, replace=False)] = True
        return mask

    # ---- row sampling --------------------------------------------------

    def _pos_neg(self) -> bool:
        cfg = self.config
        return cfg.pos_bagging_fraction < 1.0 or cfg.neg_bagging_fraction < 1.0

    def _bagging_active(self) -> bool:
        """Bernoulli or stratified bagging
        (``lightgbm_tpu/models/gbdt.py:1069``)."""
        cfg = self.config
        return cfg.bagging_freq > 0 and (cfg.bagging_fraction < 1.0 or
                                         self._pos_neg())

    def _samples(self) -> bool:
        """Whether every tree is drawn a sample (fixed for a booster)."""
        return self._bagging_active()

    def _sample_words(self, it: int) -> tuple:
        """The four key words of iteration ``it``'s draw: bagging redraws
        every ``bagging_freq`` iterations, so its mask at ``it`` is the draw
        of ``fold_in(key, it - it % bagging_freq)``, the JAX package's
        cached mask (:1127-1140, :1603) computed anew."""
        if not self._bagging_active():
            return 0, 0, 0, 0
        key = prng.fold_in(self._bag_key,
                           it - it % self.config.bagging_freq)
        return int(key[0]), int(key[1]), 0, 0

    def _sample_weights(self, words: torch.Tensor, grad: torch.Tensor,
                        hess: torch.Tensor) -> torch.Tensor:
        """The (N,) float32 weights of the draw keyed by ``words``
        ((4,) int64, :meth:`_sample_words`) for the gradients ``grad`` and
        ``hess`` ((N,), or (K, N) for K classes): bagging's
        (``_draw_bag_mask_impl``, :1110-1125)."""
        cfg = self.config
        return sample.bag_weights(words, self.num_data, cfg.bagging_fraction,
                                  cfg.pos_bagging_fraction,
                                  cfg.neg_bagging_fraction, self._label_pos)

    def sample_weights(self, it: int, grad: torch.Tensor,
                       hess: torch.Tensor):
        """Iteration ``it``'s (N,) float32 row weights for these gradients,
        or None when the booster does not sample."""
        if not self._sampled:
            return None
        words = torch.tensor(self._sample_words(it), dtype=torch.int64,
                             device=grad.device)
        return self._sample_weights(words, grad, hess)

    def _quant_words(self, tid: int) -> tuple:
        """Key words of dispatched tree ``tid``: the booster's key folded
        by the tree id (fresh stochastic-rounding randomness a tree)."""
        if self._quant_key is None:
            return 0, 0
        return key_words(prng.fold_in(self._quant_key, tid))

    # ---- the fused super-step -----------------------------------------

    def _fused_ok(self) -> bool:
        """Super-step eligibility (``lightgbm_tpu/models/gbdt.py:1195``):
        DART and random forests (``_per_tree_host``), validation sets and
        a training metric need the host tree or the scores every
        iteration, so they run the per-iteration path, as do leaf-renewal
        objectives (``_per_tree_host``) and multiclass ones; so do custom
        gradients (``train_one_iter`` checks them) and a booster without
        an objective."""
        return (not self._per_tree_host and self.config.fused_iters > 1 and
                self.objective is not None and
                self.num_tree_per_iteration == 1 and
                self.num_features > 0 and not self.valid_sets and
                not self.config.is_provide_training_metric)

    def _fused_bias_pending(self) -> bool:
        """True when the next iteration is the boost_from_average iteration
        0: it adds the bias to the score from the host and runs unfused."""
        return (self.iter == 0 and self.config.boost_from_average and
                not self.models and not self._sq)

    def _pipeline_depth(self) -> int:
        return max(int(self.config.superstep_pipeline_depth), 0) \
            if self._fused_ok() else 0

    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One boosting iteration; returns True when the tree could not
        split (training stops).  ``grad`` and ``hess``: custom gradients
        as host arrays ((N,) or (K, N)), as the JAX package's
        ``_train_one_iter_impl`` takes them (:2457-2536): blocks of one
        iteration, no fusion, no pipelining, no boost_from_average."""
        custom = grad is not None
        if not custom and self.objective is None:
            Log.fatal("no objective: a custom objective passes its "
                      "gradients to each iteration")
        if self._stop_flag:
            return True
        fused = not custom and self._fused_ok()
        blk = self._fused_block
        if blk is not None:
            in_flight = blk["served"] < self._block_iters(blk)
            # a learning_rates schedule changed the shrinkage since
            # dispatch: the unserved trees were built at the old rate
            lr_drift = blk["lr"] != self.shrinkage_rate
            if fused and in_flight and not lr_drift:
                return self._serve_fused()
            if in_flight:
                # eligibility drifted mid-block (a valid set attached, a
                # training metric asked for) or the rate changed: rewind
                # to the served boundary, then dispatch anew
                self._fused_rewind()
            elif not fused:
                self._fused_block = None
                self._discard_queue()
        if self._sq and self._sq[0]["lr"] != self.shrinkage_rate:
            # blocks dispatched ahead at the old rate
            self._discard_queue()
        fused = fused and not self._fused_bias_pending()
        self._use_custom(custom)
        if custom:
            self._load_gradients(grad, hess)
        target = 1 + self._pipeline_depth() if fused else 1
        while len(self._sq) < target:
            if not self._dispatch_block(fused, required=not self._sq):
                break
        return self._land_block()

    def _use_custom(self, custom: bool) -> None:
        """Switch the heads between the objective's gradients and the
        static custom ones; captured graphs hold the other kind, so they
        are captured anew at the next tree."""
        if custom != self._custom:
            self._custom = custom
            self.runner.graphs = None

    def _load_gradients(self, grad, hess) -> None:
        """Custom (K, N) gradients, ``np.atleast_2d`` of float32, through a
        pinned host buffer into the static buffers the heads read."""
        C, N = self.num_tree_per_iteration, self.num_data
        g = np.atleast_2d(np.asarray(grad, np.float32))
        h = np.atleast_2d(np.asarray(hess, np.float32))
        if g.shape != (C, N) or h.shape != (C, N):
            Log.fatal("custom gradients of shape %s and %s; expected "
                      "(%d, %d)", g.shape, h.shape, C, N)
        if self._grad_all is None:
            self._grad_all = torch.zeros((C, N), device=self.device)
            self._hess_all = torch.zeros_like(self._grad_all)
        if self._host_gh is None:
            self._host_gh = torch.zeros(
                (2, C, N), dtype=torch.float32,
                pin_memory=self.device.type == "cuda")
        # the previous iteration's copy out of the buffer has landed: the
        # iteration waited for its tree's records after it
        self._host_gh[0].copy_(torch.from_numpy(g))
        self._host_gh[1].copy_(torch.from_numpy(h))
        self._grad_all.copy_(self._host_gh[0], non_blocking=True)
        self._hess_all.copy_(self._host_gh[1], non_blocking=True)

    def _slot(self) -> dict:
        """The next block's buffers, from a ring of 1 + depth: a block's
        buffers are reused once it is landed and served."""
        if not self._slots:
            dev = self.device
            N, L = self.num_data, self.config.num_leaves
            C = self.num_tree_per_iteration
            # a block's trees: fused_iters of one class, or one iteration
            # of C classes
            K = max(int(self.config.fused_iters), 1) if C == 1 else C
            cuda = dev.type == "cuda"
            for _ in range(1 + self._pipeline_depth()):
                rows = torch.zeros((K, self._row.shape[0]),
                                   dtype=torch.float64, device=dev)
                # rows padded to 16 bytes: kernel L reads aligned ids
                n16 = -(-N // 16) * 16
                self._slots.append({
                    "start": class_rows(C, N, torch.float32, dev),
                    "masks": torch.zeros((K, self.num_features),
                                         dtype=torch.bool, device=dev),
                    "words": torch.zeros((K, 2), dtype=torch.int64,
                                         device=dev),
                    # the host side of the two, pinned: copied to the
                    # card without waiting for the trees queued before
                    "host_masks": torch.zeros((K, self.num_features),
                                              dtype=torch.bool,
                                              pin_memory=cuda),
                    "host_words": torch.zeros((K, 2), dtype=torch.int64,
                                              pin_memory=cuda),
                    # each tree's sampling key words (_sample_words)
                    "bag_words": torch.zeros((K, 4), dtype=torch.int64,
                                             device=dev),
                    "host_bag_words": torch.zeros((K, 4),
                                                  dtype=torch.int64,
                                                  pin_memory=cuda),
                    "rows": rows,
                    "host": torch.zeros(rows.shape, dtype=torch.float64,
                                        pin_memory=True) if cuda else rows,
                    "leaf_idx": torch.zeros((K, n16),
                                            dtype=self._state.li_dtype,
                                            device=dev),
                    "vals": torch.zeros((K, L), dtype=torch.float32,
                                        device=dev),
                })
        slot = self._slots[self._next_slot % len(self._slots)]
        self._next_slot += 1
        return slot

    def _boost_from_average(self) -> list:
        """Iteration 0's initial score of each class, added to its row of
        the training score and of every validation set's."""
        inits = [0.0] * self.num_tree_per_iteration
        if self.iter == 0 and self.config.boost_from_average and \
                not self.models and not self._custom and \
                self.objective is not None:
            for k in range(len(inits)):
                init = self.objective.boost_from_score(k)
                if abs(init) > _KEPS:
                    inits[k] = init
                    _class_row(self._score, k).add_(init)
                    for vs in self.valid_sets:
                        _class_row(vs.score, k).add_(init)
                    Log.info("Start training from score %f", init)
        return inits

    def _block_iters(self, blk: dict) -> int:
        """The iterations a landed block holds (up to its stop)."""
        return len(blk["trees"]) // self.num_tree_per_iteration

    def _dispatch_block(self, fused: bool, required: bool) -> bool:
        """Dispatch one block at the queue's frontier: its trees' inputs
        drawn on the host in sequential order, its trees run on the
        device, their packed records copied to the host without waiting.
        False, dispatching nothing, when a block that is not ``required``
        would start at or past ``num_iterations``."""
        cfg = self.config
        i0 = self._sq[-1]["i0"] + self._sq[-1]["k"] if self._sq \
            else self.iter
        C = self.num_tree_per_iteration
        K, init_score, undo = 1, [0.0] * C, None
        if fused:
            K = int(cfg.fused_iters)
            remaining = cfg.num_iterations - i0
            if remaining <= 0 and not required:
                return False
            if 0 < remaining < K:
                K = remaining           # the tail block
        else:
            undo = self._undo_state()
            init_score = self._boost_from_average()
        # the dispatch fence: the host state a block consumes before its
        # records land, restored when the block is dropped
        fence = {"rng_state": self._rng_feature.get_state(),
                 "tid": self._trees_dispatched}
        tid = self._trees_dispatched
        if self.shrinkage_rate != self._lr_host:
            self._lr.fill_(self.shrinkage_rate)
            self._lr_host = self.shrinkage_rate
        T = K * C                       # trees, in tree order
        self._trees_dispatched += T
        slot = self._slot()
        slot["host_masks"][:T] = torch.from_numpy(np.stack(
            [self._feature_fraction_mask() for _ in range(T)]))
        slot["host_words"][:T] = torch.tensor(
            [self._quant_words(tid + t) for t in range(T)])
        # a bagging draw is the iteration's, shared by its class trees
        slot["host_bag_words"][:T] = torch.tensor(
            [self._sample_words(i0 + t // C) for t in range(T)])
        for name in ("masks", "words", "bag_words"):
            slot[name][:T].copy_(slot["host_" + name][:T], non_blocking=True)
        slot["start"].copy_(self._score)
        st = self._state
        waves = []
        for t in range(T):
            st.feature_mask.copy_(slot["masks"][t])
            st.key_words.copy_(slot["words"][t])
            if self._sampled:
                self._bag_words.copy_(slot["bag_words"][t])
            waves.append(self.runner.run() if C == 1
                         else self.runner.run(t % C))
            # valid sets run the per-iteration path: blocks of one
            # iteration
            for vs in self.valid_sets:
                vs.scorer.run(self.runner, t % C)
            slot["rows"][t].copy_(self._row)
            slot["leaf_idx"][t, :self.num_data].copy_(st.leaf_idx)
            slot["vals"][t].copy_(self._vals)
        event = None
        if slot["host"] is not slot["rows"]:
            slot["host"][:T].copy_(slot["rows"][:T], non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        self._sq.append({"slot": slot, "i0": i0, "k": K, "fence": fence,
                         "init_score": init_score, "waves": waves,
                         "event": event, "lr": self.shrinkage_rate,
                         "fused": fused, "undo": undo})
        return True

    def _undo_state(self):
        """What a block of one iteration changes that its start copy does
        not restore: iteration 0's training score before the
        boost_from_average bias, and each validation set's score (its
        scorer adds in the tree's graph); None when neither applies."""
        first = self.iter == 0 and not self.models
        if not first and not self.valid_sets:
            return None
        return (self._score.clone() if first else None,
                [vs.score.clone() for vs in self.valid_sets])

    def _discard_queue(self) -> None:
        """Drop every dispatched block not landed and restore what their
        dispatches consumed: the training score (the oldest one's start
        copy), the feature-fraction draws and the tree ids."""
        if not self._sq:
            return
        first = self._sq[0]
        self._sq = []
        self._score.copy_(first["slot"]["start"])
        self._rng_feature.set_state(first["fence"]["rng_state"])
        self._trees_dispatched = int(first["fence"]["tid"])

    def _fused_rewind(self) -> None:
        """Discard the landed block's unserved trees and every block
        dispatched after it, and restore the sequential state at its
        served boundary: the score replayed over the served trees, the
        tree ids, and the feature-fraction stream rewound to the block's
        start with the served trees' draws drawn again
        (``lightgbm_tpu/models/gbdt.py:1855-1878``)."""
        self._discard_queue()
        blk = self._fused_block
        pos = blk["served"]
        self._score.copy_(self._replay_score(pos))
        self._trees_dispatched = int(blk["fence"]["tid"]) + pos
        self._rng_feature.set_state(blk["fence"]["rng_state"])
        for _ in range(pos):
            self._feature_fraction_mask()
        self._fused_block = None

    def _land_block(self) -> bool:
        """Fetch the oldest dispatched block's records (one copy, already
        on its way), make its trees, and serve the first iteration.  The
        first iteration's trees take the bias of a boost_from_average
        iteration after :meth:`_landed`, which sees the trees as the
        scores add them.  A refitting objective renews each tree's leaves
        before its shrinkage (blocks of one tree).

        The numerical-health checks read the fetched rows, and raise
        :class:`NumericalHealthError` after :meth:`_restore_boundary`:
        a fused block by the JAX super-step's rule (:meth:`_fused_health`,
        phase ``"superstep"``); a block of one iteration by the JAX
        per-iteration path's (:2536, :2582, phase ``"tree"``): each host
        tree's leaf values as it is made, before its renewal, and, when
        every class tree of the iteration is constant, the gradients and
        hessians of all K rows."""
        entry = self._sq.pop(0)
        slot, K = entry["slot"], entry["k"]
        C = self.num_tree_per_iteration
        if entry["event"] is not None:
            entry["event"].synchronize()
        host = fetch_records(slot["host"][:K * C], self._layout)
        self.records_fetches += 1
        self.block_sizes.append(K)
        health = host.pop("health")
        if entry["fused"]:
            self._fused_health(entry, health, host["n_leaves"][:K])
        inits = entry["init_score"]
        const = host["n_leaves"][:K * C] <= 1
        trees, stop_idx = [], None
        for t in range(K * C):
            k = t % C
            if const[t]:
                # a tree that could not split: constant, its score
                # contribution was 0
                tree = Tree(2)
                tree.leaf_value[0] = inits[k]
            else:
                tree = records_to_tree({n: v[t] for n, v in host.items()},
                                       self.config, self.train_set,
                                       counts_proxy=self._counts_proxy)
                if not entry["fused"]:
                    self._tree_health(entry, tree)
                if self.objective is not None and self.objective.renews:
                    self.objective.renew_tree_output(
                        tree, slot["start"],
                        slot["leaf_idx"][t, :self.num_data], self._mask)
                # the rate the block's device score used
                tree.apply_shrinkage(entry["lr"])
            trees.append(tree)
            if k == C - 1 and const[t + 1 - C:t + 1].all():
                # the stop iteration: every class tree constant
                stop_idx = t // C
                break
        if stop_idx is not None and not entry["fused"] and \
                self._stop_health and not np.isfinite(
                    health[0, _H_GRAD.start:_H_HESS.stop]).all():
            # non-finite gradients make every gain NaN and pass for a tree
            # that cannot split
            self._restore_boundary(entry)
            abort_nonfinite(entry["i0"], "tree",
                            "non-finite gradients at the stop boundary "
                            "(bad labels/scores, not an exhausted tree)")
        self._fused_block = {"slot": slot, "trees": trees,
                             "stop_idx": stop_idx, "served": 0,
                             "waves": entry["waves"], "lr": entry["lr"],
                             "fence": entry["fence"],
                             "fused": entry["fused"],
                             "init_score": inits}
        if stop_idx is not None:
            # trees after the stop ran on the device: drop the blocks
            # dispatched after this one and replay the score up to it
            self._discard_queue()
            self._score.copy_(self._replay_score(stop_idx))
        for k, init in enumerate(inits):
            if abs(init) > _KEPS and const[k] and (
                    stop_idx is not None or C > 1):
                # a constant tree of the bias iteration holds the initial
                # score and adds it once more, as the JAX package's does
                # (lightgbm_tpu/models/gbdt.py:2566-2570); the stop
                # iteration's training score is replayed instead
                if stop_idx is None:
                    _class_row(self._score, k).add_(
                        torch.tensor(np.float32(init), device=self.device))
                for vs in self.valid_sets:
                    _class_row(vs.score, k).add_(init)
        self._landed(self._fused_block)
        for k, init in enumerate(inits):
            if not const[k] and abs(init) > _KEPS:
                trees[k].add_bias(init)
        return self._serve_fused()

    def _fused_health(self, entry: dict, health: np.ndarray,
                      n_leaves: np.ndarray) -> None:
        """The JAX super-step's rule (:1684-1702): an iteration is bad
        where its gradients, leaf values or new score are not all finite;
        at the first bad iteration ``j`` the block is dropped and the
        error raised at ``i0 + j``, unless a stop tree (which a finite
        tree ends training at) comes before it."""
        words = np.concatenate([health[:, _H_GRAD], health[:, _H_VALS],
                                health[:, _H_SCORE]], axis=1)
        bad = ~np.isfinite(words).all(axis=1)
        if not bad.any():
            return
        j = int(np.argmax(bad))
        stops = np.nonzero(n_leaves <= 1)[0]
        if stops.size and int(stops[0]) < j:
            return
        self._restore_boundary(entry)
        abort_nonfinite(entry["i0"] + j, "superstep",
                        f"fused block of {entry['k']} starting at "
                        f"iteration {entry['i0']}")

    def _tree_health(self, entry: dict, tree: Tree) -> None:
        """A host tree's leaf values, after ``records_to_tree`` and before
        the renewal and the shrinkage (``_check_tree_health``, :2215)."""
        vals = tree.leaf_value[:max(tree.num_leaves, 1)]
        bad = ~np.isfinite(vals)
        if bad.any():
            self._restore_boundary(entry)
            abort_nonfinite(entry["i0"], "tree",
                            f"{int(bad.sum())} non-finite leaf value(s)")

    def _restore_boundary(self, entry: dict) -> None:
        """Put the booster back at its served boundary before a landed
        block that failed a health check: the block and every block
        dispatched after it dropped (the training score from its start
        copy, the feature-fraction draws and tree ids from its fence),
        then what the start copy does not hold (:meth:`_undo_state`).
        The iteration count and the served trees never moved.  The last
        served block's buffers may have been reused, so it can no longer
        be rolled back."""
        self._sq.insert(0, entry)
        self._discard_queue()
        if entry["undo"] is not None:
            score, valid = entry["undo"]
            if score is not None:
                self._score.copy_(score)
            for vs, saved in zip(self.valid_sets, valid):
                vs.score.copy_(saved)
        self._fused_block = None

    def _landed(self, blk: dict) -> None:
        """What a boosting mode does with a landed block before it is
        served: under a refitting objective (blocks of one tree) the
        renewed tree's float32 values into the training score and each
        validation set's, as the JAX package's per-iteration path adds
        them (lightgbm_tpu/models/gbdt.py:2594-2631); nothing else here
        (DART and random forests override it)."""
        if not self._per_tree_host or blk["stop_idx"] == 0:
            return
        vals = self._tree_values(blk["trees"][0])
        take_small_add(self._score, vals, self._landed_leaf_idx(blk))
        for vs in self.valid_sets:
            take_small_add(vs.score, vals, vs.scorer.li)

    def _tree_values(self, tree: Tree) -> torch.Tensor:
        """A host tree's leaf values as kernel L's float32 table on the
        device, padded to ``max(num_leaves, tree.num_leaves)``
        (``lightgbm_tpu/models/boosting.py:222-235``)."""
        vals = np.zeros(max(self.config.num_leaves, tree.num_leaves),
                        np.float32)
        vals[:tree.num_leaves] = tree.leaf_value[:tree.num_leaves]
        return torch.from_numpy(vals).to(self.device)

    def _landed_leaf_idx(self, blk: dict, t: int = 0) -> torch.Tensor:
        """The training leaf ids of a landed block's tree ``t``."""
        return blk["slot"]["leaf_idx"][t, :self.num_data]

    def _serve_fused(self) -> bool:
        """Append the next iteration's trees of the landed block: one
        boosting iteration from the caller's point of view.

        At a stop (an iteration whose every class tree is constant) the
        served list is the JAX package's per-iteration path's
        (:2520-2540): the constant trees are appended, ``iter`` does not
        advance, training ends.  That path is the oracle at a stop: every
        configuration can take it (valid sets, renewal, K > 1, DART, RF,
        custom gradients), and the JAX package's pipelined path, its
        default for K = 1 without valid sets, gains one more constant tree
        and an iteration from its one-tree lag, as its docstring states
        (:2245-2252)."""
        blk = self._fused_block
        C = self.num_tree_per_iteration
        t = blk["served"]
        blk["served"] = t + 1
        self.models.extend(blk["trees"][t * C:(t + 1) * C])
        self.last_waves = blk["waves"][(t + 1) * C - 1]
        if t == blk["stop_idx"]:
            self._stop_flag = True
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        self.iter += 1
        return False

    def _replay_score(self, pos: int) -> torch.Tensor:
        """The landed block's start score plus its first ``pos``
        iterations' score adds: the same kernel-L adds on the same
        operands as on the block's run, so the same bits."""
        slot = self._fused_block["slot"]
        C = self.num_tree_per_iteration
        score = class_rows(C, self.num_data, torch.float32, self.device)
        score.copy_(slot["start"])
        for t in range(pos * C):
            take_small_add(_class_row(score, t % C), slot["vals"][t],
                           slot["leaf_idx"][t, :self.num_data])
        return score

    def rollback_one_iter(self) -> None:
        """Undo the last served iteration (``GBDT::RollbackOneIter``,
        ``lightgbm_tpu/models/gbdt.py:3299-3344``): pop its trees, restore
        the training score from its block's start copy and the trees
        served before it, and subtract the popped tree's prediction from
        each validation set's score.  Inside a fused block the feature
        fraction draws and tree ids are rewound as well (``_fused_rollback``,
        :1881-1899); after a stop tree the iteration count steps back too,
        as in the JAX package.  Nothing happens when no tree of the last
        landed block is served."""
        blk = self._fused_block
        if blk is None or blk["served"] == 0 or (
                self.iter <= 0 and not blk["fused"]):
            return
        self._discard_queue()
        self._stop_flag = False
        C = self.num_tree_per_iteration
        popped = self.models[-C:]
        del self.models[-C:]
        pos = blk["served"] - 1
        score = self._replay_score(pos)
        for k, init in enumerate(blk["init_score"]):
            if pos == 0 and abs(init) > _KEPS:
                # back before the boost_from_average bias the block's
                # start copy holds
                _class_row(score, k).sub_(torch.tensor(np.float32(init),
                                                       device=self.device))
        self._score.copy_(score)
        if blk["fused"]:
            self._trees_dispatched = int(blk["fence"]["tid"]) + pos
            self._rng_feature.set_state(blk["fence"]["rng_state"])
            for _ in range(pos):
                self._feature_fraction_mask()
        if self.valid_sets:
            ff = flatten_forest(popped, self.device)
            for vs in self.valid_sets:
                vs.score -= predict_raw(ff, vs.raw, self.device, C)
        self.iter -= 1
        self._fused_block = None

    def train_score_tensor(self) -> torch.Tensor:
        """(N,) float32 training score of the trees served so far ((K, N)
        for K classes), on the device: while a block is served, or blocks
        are in flight, the device score is ahead."""
        blk = self._fused_block
        if blk is not None and blk["served"] < self._block_iters(blk):
            return self._replay_score(blk["served"])
        if self._sq:
            return self._sq[0]["slot"]["start"]
        return self._score

    def train_score(self) -> np.ndarray:
        """:meth:`train_score_tensor` as a host array."""
        return self.train_score_tensor().cpu().numpy().copy()

    # ---- validation sets and metrics ----------------------------------

    def add_valid(self, name: str, raw: np.ndarray,
                  data: TorchDataset) -> None:
        """Register a validation set: ``data`` is its binned matrix, aligned
        with the train set's bin mappers, and ``raw`` its rows.  The trees
        served so far are added to its score from ``raw``
        (``lightgbm_tpu/models/gbdt.py:1020-1054``)."""
        vs = ValidSet(name, raw, data, self.device,
                      self.num_tree_per_iteration, self._bundles)
        if self.models:
            self._replay_valid(vs)
        vs.scorer = ValidScorer(self._state, vs.xt,
                                None if self._per_tree_host else self._vals,
                                vs.score, self._bundle_maps)
        self.valid_sets.append(vs)

    def _replay_valid(self, vs: ValidSet) -> None:
        """Add the trees served so far to a new validation set's score."""
        vs.score += predict_raw(flatten_forest(self.models, self.device),
                                vs.raw, self.device,
                                self.num_tree_per_iteration)

    def _eval_one_set(self, name: str, score: torch.Tensor, label, weight,
                      query_boundaries=None) -> list:
        """Every metric on one dataset's raw float64 score, after the
        objective's output transform (none without an objective);
        multiclass metrics get the (rows, K) probabilities; every metric
        gets the set's query boundaries, and rank metrics give one entry a
        position (``lightgbm_tpu/models/gbdt.py:2866-2889``)."""
        if score.dim() == 2:
            score = score.T
        if self.objective is not None:
            score = self.objective.convert_output(score)
        out = []
        for m in self.metrics:
            if hasattr(m, "eval_all"):
                for mname, val in m.eval_all(label, score, weight,
                                             query_boundaries):
                    out.append((name, mname, val, m.higher_better))
            else:
                out.append((name, m.name,
                            m.eval(label, score, weight, query_boundaries),
                            m.higher_better))
        return out

    def eval_set(self) -> list:
        """Every metric on the training data (with
        ``is_provide_training_metric``) and each validation set, as
        (dataset name, metric name, value, higher_better)."""
        out = []
        if self.config.is_provide_training_metric and self.objective:
            ts = self.train_set
            out.extend(self._eval_one_set(
                "training", self.train_score_tensor().to(torch.float64),
                ts.label, ts.weight, ts.metadata.query_boundaries))
        for vs in self.valid_sets:
            out.extend(self._eval_one_set(vs.name, vs.score, vs.label,
                                          vs.weight,
                                          vs.metadata.query_boundaries))
        return out
