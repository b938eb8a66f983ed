"""Boosting modes that sample rows, and the boosting factory.

Counterpart of ``lightgbm_tpu/models/boosting.py`` for GOSS (:28-106)
and MVS (:107-176), dispatched by ``config.boosting`` as
``create_boosting`` (:442-458) dispatches them.  Each is the serial
:class:`GBDT` with its own per-row weights, drawn in every tree's head on
the device (``ops/sample.py``, kernel B on the card) from the PRNG fold
of the tree's global iteration, so fused and sequential runs draw the
same bits.  DART and random forests are not ported yet: asking for them
raises ``NotImplementedError`` (``Config.check_supported``).
"""
from __future__ import annotations

import torch

from ..config import Config
from ..io.dataset import TorchDataset
from ..objectives import Objective
from ..ops import sample
from ..utils import prng
from ..utils.log import Log
from .gbdt import GBDT

__all__ = ["GOSS", "MVS", "create_boosting"]


class GOSS(GBDT):
    """Gradient-based one-side sampling: every row whose ``|g * h|`` is
    above the ``top_rate`` quantile, rows at it admitted at the rate that
    fills ``top_k``, and of the rest a bernoulli sample at ``other_rate``'s
    expected size, upweighted by ``(N - top_k) / other_k``
    (``GOSS._goss_mask_impl``).  Like the JAX package it samples from the
    first iteration on (upstream skips the first ``1 / learning_rate``)."""

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
        gh = (grad * hess).abs()
        top_k = max(int(n * cfg.top_rate), 1)
        other_k = int(n * cfg.other_rate)
        thr, _, _, p_tie = sample.goss_threshold(gh, top_k)
        return sample.goss_weights(words, gh, thr, p_tie,
                                   other_k / max(n - top_k, 1),
                                   (n - top_k) / float(max(other_k, 1)))


class MVS(GBDT):
    """Minimal-variance sampling: the score ``s = sqrt(|g * h|^2 +
    var_weight)``, the threshold ``mu`` of an expected sample of
    ``bagging_fraction * N`` rows, each row kept with probability
    ``min(s / mu, 1)`` and weighted by its inverse
    (``MVS._mvs_mask_impl``).  It samples only with ``bagging_fraction <
    1``, every iteration (``bagging_freq`` is not read)."""

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
        s = sample.mvs_scores((grad * hess).abs(), cfg.var_weight)
        mu = sample.mvs_threshold(s, cfg.bagging_fraction * self.num_data)
        return sample.mvs_weights(words, s, mu)


_BOOSTING_TYPES = {"gbdt": GBDT, "gbrt": GBDT, "goss": GOSS, "mvs": MVS}


def create_boosting(config: Config, train_set: TorchDataset,
                    objective: Objective, metrics=(),
                    eager: bool = False) -> GBDT:
    """The booster of ``config.boosting`` (``Boosting::CreateBoosting``).
    DART and random forests raise ``NotImplementedError``."""
    config.check_supported()
    cls = _BOOSTING_TYPES.get(config.boosting)
    if cls is None:
        Log.fatal("unknown boosting type %s", config.boosting)
    return cls(config, train_set, objective, metrics, eager=eager)
