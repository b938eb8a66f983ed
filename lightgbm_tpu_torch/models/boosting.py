"""Boosting modes: row sampling, DART, random forests, and the factory.

Counterpart of ``lightgbm_tpu/models/boosting.py`` for GOSS (:28-106),
MVS (:107-176), DART (:177-371) and RF (:374-439), dispatched by
``config.boosting`` as ``create_boosting`` (:442-458) dispatches them.

GOSS and MVS are the serial :class:`GBDT` with their own per-row weights,
drawn in every tree's head on the device (``ops/sample.py``: kernel B's
sampling step on the card, threshold and draw) from the PRNG fold of the
tree's global iteration, so fused and sequential runs draw the same
bits.  With K classes they read ``sum_k |g * h|`` over the iteration's
(K, N) gradients (kernel B's class sum on the card), once an iteration.

DART and RF need the host trees every iteration, so they run blocks of one
iteration (no fused super-steps) and add each tree's host leaf values,
cast to float32, to its class's row of the training score with kernel L
once the iteration lands, as the JAX package's per-iteration path does.
DART keeps each tree's training leaf ids on the device (uint8 up to 256
leaves) and each validation set's (from kernel T) to drop and renormalize
past iterations; its drops draw from a numpy ``RandomState`` on the host
before the iteration is dispatched.  RF trains every tree on the
gradients of the constant initial scores and keeps each class's score
the average of its trees.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..config import Config
from ..io.dataset import TorchDataset
from ..objectives import Objective
from ..ops import sample
from ..ops.lookup import take_small_add
from ..ops.predict import flatten_forest, predict_raw
from ..utils import prng
from ..utils.health import NumericalHealthError
from ..utils.log import Log
from .gbdt import _KEPS, GBDT, ValidSet, _class_row

__all__ = ["GOSS", "MVS", "DART", "RF", "create_boosting"]


class GOSS(GBDT):
    """Gradient-based one-side sampling: every row whose ``|g * h|`` is
    above the ``top_rate`` quantile, rows at it admitted at the rate that
    fills ``top_k``, and of the rest a bernoulli sample at ``other_rate``'s
    expected size, upweighted by ``(N - top_k) / other_k``
    (``GOSS._goss_mask_impl``); with K classes ``gh`` is ``sum_k |g[k] *
    h[k]|``.  Like the JAX package it samples from the first iteration on
    (upstream skips the first ``1 / learning_rate``)."""

    def __init__(self, config: Config, *args, **kwargs):
        if config.top_rate + config.other_rate > 1.0:
            Log.fatal("GOSS requires top_rate + other_rate <= 1")
        if config.top_rate <= 0 or config.other_rate <= 0:
            Log.fatal("GOSS requires top_rate > 0 and other_rate > 0")
        if config.bagging_freq > 0 and config.bagging_fraction < 1.0:
            Log.fatal("Cannot use bagging in GOSS")
        super().__init__(config, *args, **kwargs)
        Log.info("Using GOSS")

    def _samples(self) -> bool:
        return True

    def _sample_words(self, it: int) -> tuple:
        """``split(fold_in(key, it))``: the rest's key, then the ties'."""
        ku, kt = prng.split(prng.fold_in(self._bag_key, it))
        return int(ku[0]), int(ku[1]), int(kt[0]), int(kt[1])

    def _sample_weights(self, words: torch.Tensor, grad: torch.Tensor,
                        hess: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        n = self.num_data
        # with K classes, sum_k |g * h| over the (K, N) rows (:82)
        gh = (grad * hess).abs() if grad.dim() == 1 else \
            sample.class_gh(grad, hess)
        top_k = max(int(n * cfg.top_rate), 1)
        other_k = int(n * cfg.other_rate)
        return sample.goss_step(words, gh, top_k,
                                other_k / max(n - top_k, 1),
                                (n - top_k) / float(max(other_k, 1)))[0]


class MVS(GBDT):
    """Minimal-variance sampling: the score ``s = sqrt(|g * h|^2 +
    var_weight)``, the threshold ``mu`` of an expected sample of
    ``bagging_fraction * N`` rows, each row kept with probability
    ``min(s / mu, 1)`` and weighted by its inverse
    (``MVS._mvs_mask_impl``); with K classes ``|g * h|`` is the sum over
    the classes.  It samples only with ``bagging_fraction < 1``, every
    iteration (``bagging_freq`` is not read)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        Log.info("Using MVS")

    def _samples(self) -> bool:
        return self.config.bagging_fraction < 1.0

    def _sample_words(self, it: int) -> tuple:
        key = prng.fold_in(self._bag_key, it)
        return int(key[0]), int(key[1]), 0, 0

    def _sample_weights(self, words: torch.Tensor, grad: torch.Tensor,
                        hess: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        target = cfg.bagging_fraction * self.num_data
        if grad.dim() == 2:
            # K classes: the scores of sum_k |g * h| (:165)
            return sample.mvs_class_step(words, grad, hess, cfg.var_weight,
                                         target)[0]
        return sample.mvs_step(words, (grad * hess).abs(), cfg.var_weight,
                               target)[0]


class DART(GBDT):
    """Dropouts meet MART (``dart.hpp:17``): each iteration drops a random
    subset of past iterations from the training score, fits the new
    trees against the reduced score at the rate ``lr / (1 + k)``, then
    renormalizes the dropped iterations by ``k / (k + 1)`` (xgboost mode:
    ``lr / (lr + k)`` and ``k / (k + lr)``).  A drop index names an
    iteration: with K classes its trees ``i * K + c`` leave and re-enter
    class row c (``lightgbm_tpu/models/boosting.py:237-373``), and
    ``tree_weight`` holds a weight an iteration."""

    _per_tree_host = True       # drops and renormalization

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # each tree's training leaf ids on the device (None: a constant
        # tree)
        self._train_leaf_idx: List = []
        self._rng_drop = np.random.RandomState(
            self.config.drop_seed & 0x7FFFFFFF)
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0
        self._drop_index: List[int] = []
        self._dart_undo = None
        Log.info("Using DART")

    # ---- per-tree contributions from the kept leaf ids -----------------

    def _add_contrib(self, mi: int, sign: float) -> None:
        """``score += sign * tree mi``'s float32 leaf values at its kept
        training leaf ids, in its class's row (``_train_contrib``,
        :222-235): kernel L, the values negated to subtract."""
        tree = self.models[mi]
        row = _class_row(self._score, mi % self.num_tree_per_iteration)
        la = self._train_leaf_idx[mi]
        if la is None:
            v = np.float32(tree.leaf_value[0]) * np.float32(sign)
            row.add_(torch.tensor(v, device=self.device))
            return
        take_small_add(row, self._tree_values(tree) * sign, la)

    def _valid_contrib(self, mi: int, vs: ValidSet) -> torch.Tensor:
        """Tree mi's float64 values on a validation set, from its kept leaf
        ids there, or its prediction where none are kept (a constant tree,
        a set attached after it)."""
        tree = self.models[mi]
        la = vs.leaf_idx_per_tree[mi]
        if la is None:
            return predict_raw(flatten_forest([tree], self.device), vs.raw,
                               self.device)
        lv = torch.from_numpy(tree.leaf_value).to(self.device)
        return lv[la.to(torch.int64)]

    def _replay_valid(self, vs: ValidSet) -> None:
        """A set attached after training began keeps no ids of the trees
        before it: their contributions come from their prediction."""
        vs.leaf_idx_per_tree.extend([None] * len(self.models))
        super()._replay_valid(vs)

    def _iteration_trees(self, i: int) -> range:
        """The model indices of iteration ``i``'s trees, one a class."""
        K = self.num_tree_per_iteration
        return range(i * K, (i + 1) * K)

    # ---- one iteration --------------------------------------------------

    def _select_drops(self) -> None:
        """The iterations to drop this iteration and the new trees' rate
        (``DroppingTrees``, :238-269), drawn from the host's stream."""
        cfg = self.config
        self._drop_index = []
        if self._rng_drop.random_sample() < cfg.skip_drop or self.iter == 0:
            pass
        elif cfg.uniform_drop:
            rate = cfg.drop_rate
            if cfg.max_drop > 0:
                rate = min(rate, cfg.max_drop / float(self.iter))
            for i in range(self.iter):
                if self._rng_drop.random_sample() < rate:
                    self._drop_index.append(i)
                    if len(self._drop_index) >= cfg.max_drop > 0:
                        break
        else:
            inv_avg = len(self.tree_weight) / max(self.sum_weight, _KEPS)
            rate = cfg.drop_rate
            if cfg.max_drop > 0:
                rate = min(rate, cfg.max_drop * inv_avg /
                           max(self.sum_weight, _KEPS))
            for i in range(self.iter):
                if self._rng_drop.random_sample() < \
                        rate * self.tree_weight[i] * inv_avg:
                    self._drop_index.append(i)
                    if len(self._drop_index) >= cfg.max_drop > 0:
                        break
        k = float(len(self._drop_index))
        lr = cfg.learning_rate
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = lr / (1.0 + k)
        else:
            self.shrinkage_rate = lr if not self._drop_index else \
                lr / (lr + k)

    def _drop(self) -> None:
        """Select the drops and take their trees out of the training score,
        so the new trees' gradients see the reduced ensemble."""
        self._select_drops()
        for i in self._drop_index:
            for mi in self._iteration_trees(i):
                self._add_contrib(mi, -1.0)

    def train_one_iter(self, grad=None, hess=None) -> bool:
        # the snapshot is taken before the drops, so a rollback restores
        # a consistent state (:272-301); custom gradients were computed
        # by the caller from the score before the drops, as there
        pre_score = self._score.clone()
        pre_valid = [vs.score.clone() for vs in self.valid_sets]
        pre_weights = (list(self.tree_weight), self.sum_weight)
        self._drop()
        try:
            stop = super().train_one_iter(grad, hess)
        except NumericalHealthError:
            # the JAX package raises here with the drops still out of its
            # score (:283); the port puts them back: its served boundary
            self._score.copy_(pre_score)
            for vs, snap in zip(self.valid_sets, pre_valid):
                vs.score.copy_(snap)
            self._drop_index = []
            raise
        if stop:
            # no tree was added: the dropped trees go back in
            for i in self._drop_index:
                for mi in self._iteration_trees(i):
                    self._add_contrib(mi, 1.0)
            self._drop_index = []
            self._dart_undo = None
            return stop
        scale = self._normalize()
        if not self.config.uniform_drop:
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
        self._dart_undo = (pre_score, pre_valid, pre_weights,
                           list(self._drop_index), scale)
        return False

    def _landed(self, blk: dict) -> None:
        """Each new tree's host values into its class's row of the
        training score and of each validation set's (float64
        ``leaf_value[la]``, :2619-2626), its leaf ids kept; a constant
        tree (every tree of a stop iteration) keeps none: ``_land_block``
        adds its value, the bias of an iteration-0 tree, as the JAX
        package does."""
        K = self.num_tree_per_iteration
        for t, tree in enumerate(blk["trees"]):
            k = t % K
            if tree.num_leaves <= 1:
                self._train_leaf_idx.append(None)
                for vs in self.valid_sets:
                    vs.leaf_idx_per_tree.append(None)
                continue
            li = self._landed_leaf_idx(blk, t)
            take_small_add(_class_row(self._score, k),
                           self._tree_values(tree), li)
            self._train_leaf_idx.append(li.clone())
            lv = torch.from_numpy(tree.leaf_value).to(self.device)
            for vs in self.valid_sets:
                la = vs.scorer.leaf_ids(k).clone()
                vs.leaf_idx_per_tree.append(la)
                _class_row(vs.score, k).add_(lv[la.to(torch.int64)])

    def _normalize(self) -> float:
        """Scale each dropped iteration's trees by ``k / (k + 1)`` and put
        them back in the scores at their new weight (``Normalize``,
        :331-371)."""
        k = float(len(self._drop_index))
        if k == 0:
            return 1.0
        cfg = self.config
        lr = cfg.learning_rate
        scale = k / (k + 1.0) if not cfg.xgboost_dart_mode else \
            k / (k + lr)
        K = self.num_tree_per_iteration
        for i in self._drop_index:
            for mi in self._iteration_trees(i):
                self.models[mi].apply_shrinkage(scale)
                # train score: the net change is -(1 - scale) x the
                # original
                self._add_contrib(mi, 1.0)
                if self.valid_sets:
                    factor = (1.0 - scale) / scale
                    for vs in self.valid_sets:
                        _class_row(vs.score, mi % K).sub_(
                            self._valid_contrib(mi, vs) * factor)
            if not cfg.uniform_drop:
                unit = (k + 1.0) if not cfg.xgboost_dart_mode else (k + lr)
                self.sum_weight -= self.tree_weight[i] / unit
                self.tree_weight[i] *= scale
        return scale

    def rollback_one_iter(self) -> None:
        """Undo the last DART iteration: the scores from before its drops,
        the dropped trees unscaled, the iteration's K trees popped
        (:304-329)."""
        if self.iter <= 0 or self._dart_undo is None:
            return
        pre_score, pre_valid, (tw, sw), dropped, scale = self._dart_undo
        for i in dropped:
            for mi in self._iteration_trees(i):
                self.models[mi].apply_shrinkage(1.0 / scale)
        self._score.copy_(pre_score)
        for vs, snap in zip(self.valid_sets, pre_valid):
            vs.score.copy_(snap)
        self.tree_weight, self.sum_weight = tw, sw
        for _ in range(self.num_tree_per_iteration):
            self.models.pop()
            if self._train_leaf_idx:
                self._train_leaf_idx.pop()
            for vs in self.valid_sets:
                if vs.leaf_idx_per_tree:
                    vs.leaf_idx_per_tree.pop()
        self.iter -= 1
        self._dart_undo = None
        self._fused_block = None

    def leaf_idx_bytes(self) -> int:
        """Device bytes of the kept leaf ids, training and validation (a
        tree each)."""
        kept = self._train_leaf_idx + [la for vs in self.valid_sets
                                       for la in vs.leaf_idx_per_tree]
        return sum(la.numel() * la.element_size() for la in kept
                   if la is not None)


class RF(GBDT):
    """Random forest (``rf.hpp:18``): unit shrinkage, bagging required,
    gradients computed once from the constant initial score, and the
    score kept as the average of the trees' outputs; with K classes a
    score, fixed gradients and an average a class
    (``lightgbm_tpu/models/boosting.py:394-448``)."""

    _per_tree_host = True       # averaged-score updates
    # a forest goes on past a tree that cannot split: its iteration checks
    # each tree's leaf values, and no stop (:417-439)
    _stop_health = False

    def __init__(self, config: Config, *args, **kwargs):
        if not (config.bagging_freq > 0 and 0 < config.bagging_fraction < 1):
            Log.fatal("random forest requires bagging "
                      "(bagging_freq > 0, 0 < bagging_fraction < 1)")
        super().__init__(config, *args, **kwargs)
        if self.objective is None:
            Log.fatal("rf does not support a custom objective")
        self.average_output = True
        self.shrinkage_rate = 1.0
        Log.info("Using RF")
        # each class's initial score (a Dataset refuses init_score, which
        # RF refuses too, rf.hpp:38)
        C = self.num_tree_per_iteration
        self._init_scores = [
            self.objective.boost_from_score(k)
            if self.config.boost_from_average else 0.0 for k in range(C)]
        # the fixed gradients at the constant initial scores
        # (RF::Boosting): (N,), or (K, N) for K classes
        base = torch.from_numpy(np.repeat(
            np.asarray(self._init_scores, np.float32)[:, None],
            self.num_data, axis=1)).to(self.device)
        grad, hess = self.objective.get_gradients(base[0] if C == 1
                                                  else base)
        self._rf_grad, self._rf_hess = grad.clone(), hess.clone()
        self._rf_undo = None
        self._m = 0.0

    def _gradients(self):
        return self._rf_grad, self._rf_hess

    def _boost_from_average(self) -> list:
        """Every tree's bias is its class's initial score; it enters the
        score after the tree lands (:422-430), not before the first
        tree."""
        return list(self._init_scores)

    def train_one_iter(self, grad=None, hess=None) -> bool:
        if grad is not None:
            Log.fatal("rf does not support a custom objective")
        # the scores before the iteration, for a rollback (:407-409)
        last_undo = self._rf_undo
        self._rf_undo = (self._score.clone(),
                         [vs.score.clone() for vs in self.valid_sets])
        # score <- (score * m + tree + bias) / (m + 1), :411-436
        self._m = float(self.iter)
        self._score.mul_(torch.tensor(np.float32(self._m),
                                      device=self.device))
        for vs in self.valid_sets:
            vs.score.mul_(self._m)
        try:
            return super().train_one_iter()
        except NumericalHealthError:
            # back to the scores before the iteration's multiply
            score, valid = self._rf_undo
            self._score.copy_(score)
            for vs, snap in zip(self.valid_sets, valid):
                vs.score.copy_(snap)
            self._rf_undo = last_undo
            raise

    def _landed(self, blk: dict) -> None:
        """Each class tree's float32 values into its class's row of the
        scores (float64 widened on the validation sets), its bias, then
        the average: the training score multiplied by ``1 / (m + 1)`` in
        float32, the validation scores divided by ``m + 1`` in float64, as
        the JAX package does.  A tree that could not split holds the bias
        alone, which ``_land_block`` added to the validation scores and,
        unless every class tree is constant, to the training score."""
        K = self.num_tree_per_iteration
        stop = blk["stop_idx"] == 0
        for t, tree in enumerate(blk["trees"]):
            k = t % K
            row = _class_row(self._score, k)
            init = self._init_scores[k]
            split = tree.num_leaves > 1
            if split:
                vals = self._tree_values(tree)
                take_small_add(row, vals, self._landed_leaf_idx(blk, t))
                for vs in self.valid_sets:
                    vrow = _class_row(vs.score, k)
                    take_small_add(vrow, vals, vs.scorer.leaf_ids(k))
                    if abs(init) > _KEPS:
                        vrow.add_(init)
            if abs(init) > _KEPS and (split or stop):
                row.add_(torch.tensor(np.float32(init), device=self.device))
        m = self._m
        self._score.mul_(torch.tensor(np.float32(1.0 / (m + 1.0)),
                                      device=self.device))
        for vs in self.valid_sets:
            vs.score /= (m + 1.0)
        # a forest goes on past an iteration that could not split
        blk["stop_idx"] = None

    def rollback_one_iter(self) -> None:
        """Restore the scores from before the last iteration and pop its
        K trees (``GBDT.rollback_one_iter`` with RF's snapshots)."""
        if self.iter <= 0 or self._rf_undo is None:
            return
        score, valid = self._rf_undo
        self._score.copy_(score)
        for vs, snap in zip(self.valid_sets, valid):
            vs.score.copy_(snap)
        del self.models[-self.num_tree_per_iteration:]
        self.iter -= 1
        self._rf_undo = None
        self._fused_block = None


_BOOSTING_TYPES = {"gbdt": GBDT, "gbrt": GBDT, "goss": GOSS, "mvs": MVS,
                   "dart": DART, "rf": RF, "random_forest": RF}


def create_boosting(config: Config, train_set: TorchDataset,
                    objective: Objective, metrics=(),
                    eager: bool = False) -> GBDT:
    """The booster of ``config.boosting`` (``Boosting::CreateBoosting``):
    gbdt, GOSS, MVS, DART or a random forest."""
    config.check_supported()
    cls = _BOOSTING_TYPES.get(config.boosting)
    if cls is None:
        Log.fatal("unknown boosting type %s", config.boosting)
    return cls(config, train_set, objective, metrics, eager=eager)
