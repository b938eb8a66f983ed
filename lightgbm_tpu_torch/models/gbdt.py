"""GBDT boosting loop.

Counterpart of ``lightgbm_tpu/models/gbdt.py`` for the serial learner:
``records_to_tree`` (:38-125, with the quantized renewal and the
two-column count restore) is copied; the serial subset of the tier
resolution (:381-418, :491-512: wave growth, two-column passes,
coarse-to-fine refinement, quantized gradients, the lane width) and one
boosting iteration (:2245-2310: boost_from_average, gradients, tree build
with the tree's quantization key, score update) become a plain
per-iteration loop.  The
score update is the one the JAX package's pipelined iteration performs,
from the build's own float32 leaf values (renewed under quantization):
``score += leaf_values_final * learning_rate`` gathered by leaf id
(kernel L on the card).  There is no fused super-step and no pipelining
yet: each iteration fetches its tree's records in one copy.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..config import Config
from ..io.dataset import TorchDataset
from ..objectives import Objective
from ..ops.grow import GrowParams, build_tree
from ..ops.histogram import multi_width
from ..ops.lookup import take_small_add
from ..ops.split import SplitParams
from ..utils import prng
from ..utils.log import Log
from .tree import Tree

__all__ = ["GBDT", "records_to_tree", "fetch_records"]

_KEPS = 1e-15


def _pad_bins(max_bin: int) -> int:
    """Bins padded to a multiple of 8 (``lightgbm_tpu/ops/histogram.py:99``),
    the stream size of the coarse-to-fine gate."""
    return (max_bin + 7) // 8 * 8


def records_to_tree(rec, config, train_set, counts_proxy=False) -> Tree:
    """Materialize one host :class:`Tree` from a fetched split-record
    dict (numerical splits).  With ``leaf_stats_exact`` (quantized
    training) the leaf values are renewed from the full-precision sums;
    with ``counts_proxy`` (two-column passes, whose count slots hold hess
    sums) the leaf and internal counts are restored from them."""
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
        thr_bin = int(rec["threshold"][i])
        tree.split(leaf, real_f, thr_bin, mapper.bin_to_value(thr_bin), lv,
                   rv, float(ls[1]), float(rs[1]), int(round(ls[2])),
                   int(round(rs[2])), float(rec["gain"][i]),
                   mapper.missing_type, bool(rec["default_left"][i]))
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


def fetch_records(rec: dict) -> dict:
    """One device->host copy for every record except the (N,) leaf
    assignment: the records are packed into one float64 buffer (every
    value — ids, bins, float32 stats, flags — is exact in float64)."""
    keys = [k for k in sorted(rec) if k != "leaf_idx"]
    flat = torch.cat([rec[k].to(torch.float64).reshape(-1) for k in keys])
    flat = flat.cpu().numpy()
    out, off = {}, 0
    for k in keys:
        shape = tuple(rec[k].shape)
        size = int(np.prod(shape)) if shape else 1
        vals = flat[off:off + size].reshape(shape)
        if rec[k].dtype == torch.bool:
            vals = vals > 0.5
        elif rec[k].dtype == torch.float32:
            vals = vals.astype(np.float32)
        else:
            vals = vals.astype(np.int64)
        out[k] = vals
        off += size
    return out


class GBDT:
    """Gradient boosting loop of the port (serial learner, gbdt)."""

    def __init__(self, config: Config, train_set: TorchDataset,
                 objective: Objective):
        config.check_supported()
        self.config = config
        self.train_set = train_set
        self.objective = objective
        self.device = train_set.device
        self.models: List[Tree] = []
        self.iter = 0
        self.num_class = 1
        self.num_tree_per_iteration = 1
        self.shrinkage_rate = config.learning_rate
        self.num_data = train_set.num_data
        F = len(train_set.used_features)
        self.num_features = F
        mappers = [train_set.mappers[i] for i in train_set.used_features]
        self.max_bin = int(2 ** np.ceil(np.log2(max(
            train_set.max_bin_count, 2))))
        dev = self.device
        self._num_bins = torch.as_tensor([m.num_bin for m in mappers],
                                         dtype=torch.int32, device=dev)
        self._missing_type = torch.as_tensor(
            [m.missing_type for m in mappers], dtype=torch.int32, device=dev)
        any_missing = bool(any(m.missing_type != 0 for m in mappers))
        # tiers of the serial learner (lightgbm_tpu/models/gbdt.py:381-418,
        # :491-512).  Non-wave speculative arming grows the same trees as
        # the plain loop at speculative_tolerance=0, so it is not a tier
        # here.
        wave_on = bool(config.wave_splits)
        two_col = bool(config.use_quantized_grad and wave_on and
                       config.min_data_in_leaf <= 1 and
                       config.min_sum_hessian_in_leaf > 0)
        self._counts_proxy = two_col
        # coarse-to-fine refinement: the JAX package's stream-size gate
        # (lightgbm_tpu/models/gbdt.py:410-418), unchanged
        refine_shift = 0
        if (config.hist_refinement and wave_on and self.max_bin >= 48 and
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
                any_missing=any_missing,
                counts_proxy=two_col),
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
        self._xt = train_set.binned
        self._mask = torch.ones(self.num_data, dtype=torch.float32,
                                device=dev)
        self._score = torch.zeros(self.num_data, dtype=torch.float32,
                                  device=dev)
        self._rng_feature = np.random.RandomState(
            config.feature_fraction_seed & 0x7FFFFFFF)
        objective.init(train_set.metadata, self.num_data, dev)

    def _feature_fraction_mask(self) -> torch.Tensor:
        F = self.num_features
        frac = self.config.feature_fraction
        mask = np.zeros(F, bool)
        if frac >= 1.0:
            mask[:] = True
        else:
            k = max(1, int(frac * F))
            mask[self._rng_feature.choice(F, size=k, replace=False)] = True
        return torch.as_tensor(mask, device=self.device)

    def train_one_iter(self) -> bool:
        """One boosting iteration; returns True when the tree could not
        split (training stops)."""
        init_score = 0.0
        if self.iter == 0 and self.config.boost_from_average and \
                not self.models:
            init = self.objective.boost_from_score()
            if abs(init) > _KEPS:
                init_score = init
                self._score.add_(init)
                Log.info("Start training from score %f", init)
        grad, hess = self.objective.get_gradients(self._score)
        key = None
        if self._quant_key is not None:
            # fresh stochastic-rounding randomness per tree
            key = prng.fold_in(self._quant_key, self._trees_dispatched)
        self._trees_dispatched += 1
        rec = build_tree(self._xt, grad, hess, self._mask,
                         self._feature_fraction_mask(), self._num_bins,
                         self._missing_type, self.grow_params, quant_key=key)
        vals = rec["leaf_values_final"] * self.shrinkage_rate
        take_small_add(self._score, vals, rec["leaf_idx"])
        recs = fetch_records(rec)
        if "n_waves" in recs:
            self.last_waves = int(recs["n_waves"])
        if int(recs["n_leaves"]) <= 1:
            tree = Tree(2)
            tree.leaf_value[0] = init_score
            self.models.append(tree)
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        tree = records_to_tree(recs, self.config, self.train_set,
                               counts_proxy=self._counts_proxy)
        tree.apply_shrinkage(self.shrinkage_rate)
        if abs(init_score) > _KEPS:
            tree.add_bias(init_score)
        self.models.append(tree)
        self.iter += 1
        return False
