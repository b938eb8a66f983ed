"""Evaluation metrics.

Counterpart of ``lightgbm_tpu/metrics.py`` (the reference's
``src/metric/``, factory ``metric.cpp:12-51``): the registry, the default
metric of each objective, ``create_metrics`` and every ``Metric`` class,
under the same names.

The pointwise metrics and ``auc`` compute in float64 torch on the
scores' device, so a validation set's score never leaves the card: each
evaluation reads back one scalar.  ``auc`` keeps the reference's tie
handling (one area term per unique score) with a stable sort,
``unique_consecutive`` and float64 cumulative sums.  The multiclass and
rank metrics compute in numpy on a host copy, as the JAX package does.

``eval(label, score, weight=None, query_boundaries=None)`` takes the
transformed prediction (probability for binary, per-class probabilities
for multiclass, raw for regression) as a tensor or an array, the label
and weight likewise, and returns a Python float.
"""
from __future__ import annotations

from typing import Dict, List, Type

import numpy as np
import torch

from .utils.log import Log

__all__ = ["Metric", "register", "default_metric_for", "create_metrics",
           "default_label_gain"]

_REGISTRY: Dict[str, Type["Metric"]] = {}


def register(*names):
    def deco(cls):
        for n in names:
            _REGISTRY[n] = cls
        cls.name = names[0]
        return cls
    return deco


# objective name -> default metric (metric.cpp behavior: metric defaults
# to the objective's own loss)
_DEFAULT_FOR_OBJECTIVE = {
    "regression": "l2", "regression_l2": "l2", "l2": "l2", "mse": "l2",
    "rmse": "rmse", "l2_root": "rmse",
    "regression_l1": "l1", "l1": "l1", "mae": "l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "quantile": "quantile", "mape": "mape", "gamma": "gamma",
    "tweedie": "tweedie",
    "binary": "binary_logloss",
    "multiclass": "multi_logloss", "softmax": "multi_logloss",
    "multiclassova": "multi_logloss", "ova": "multi_logloss",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "lambdarank": "ndcg",
}


def default_metric_for(objective: str) -> str:
    return _DEFAULT_FOR_OBJECTIVE.get(objective, "l2")


def create_metrics(names, config) -> List["Metric"]:
    out = []
    for n in names:
        n = n.strip()
        if not n or n in ("None", "na", "null", "custom"):
            continue
        if n not in _REGISTRY:
            Log.warning("unknown metric %s (skipped)", n)
            continue
        m = _REGISTRY[n](config)
        if not any(type(o) is type(m) for o in out):
            out.append(m)
    return out


def default_label_gain(n: int = 31) -> np.ndarray:
    """label_gain = 2^i - 1 (``dcg_calculator.cpp:30``)."""
    return np.concatenate([[0.0], (2.0 ** np.arange(1, n).astype(np.float64)
                                   - 1.0)])


def _f64(x, device=None) -> torch.Tensor:
    """A float64 tensor of ``x`` (a tensor keeps its device)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.as_tensor(np.asarray(x), dtype=torch.float64,
                           device=device)


class Metric:
    name = "base"
    higher_better = False

    def __init__(self, config):
        self.config = config

    def eval(self, label, score, weight=None, query_boundaries=None
             ) -> float:
        """score is the TRANSFORMED prediction (probability for binary,
        per-class probabilities for multiclass, raw for regression)."""
        raise NotImplementedError


class _PointwiseMetric(Metric):
    """A weighted mean of a per-row loss, in float64 on the score's
    device; subclasses define ``loss(label, score)``."""

    def loss(self, label: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def eval(self, label, score, weight=None, query_boundaries=None):
        score = _f64(score)
        label = _f64(label, score.device)
        return self._avg(self.loss(label, score), weight).item()

    @staticmethod
    def _avg(values: torch.Tensor, weight) -> torch.Tensor:
        if weight is None:
            return values.mean()
        w = _f64(weight, values.device)
        return (values * w).sum() / w.sum()


def _log_loss(label, p):
    return -(label * torch.log(p) + (1 - label) * torch.log(1 - p))


@register("l2", "mean_squared_error", "mse")
class L2Metric(_PointwiseMetric):
    def loss(self, label, score):
        return (score - label) ** 2


@register("rmse", "root_mean_squared_error", "l2_root")
class RMSEMetric(_PointwiseMetric):
    def loss(self, label, score):
        return (score - label) ** 2

    def eval(self, label, score, weight=None, query_boundaries=None):
        return float(np.sqrt(super().eval(label, score, weight)))


@register("l1", "mean_absolute_error", "mae", "regression_l1")
class L1Metric(_PointwiseMetric):
    def loss(self, label, score):
        return torch.abs(score - label)


@register("binary_logloss", "binary")
class BinaryLoglossMetric(_PointwiseMetric):
    def loss(self, label, score):
        return _log_loss(label, score.clamp(1e-15, 1 - 1e-15))


@register("binary_error")
class BinaryErrorMetric(_PointwiseMetric):
    def loss(self, label, score):
        pred = (score > 0.5).to(torch.float64)
        return (pred != label).to(torch.float64)


@register("quantile")
class QuantileMetric(_PointwiseMetric):
    def loss(self, label, score):
        alpha = float(self.config.alpha)
        d = label - score
        return torch.where(d >= 0, alpha * d, (alpha - 1) * d)


@register("huber")
class HuberMetric(_PointwiseMetric):
    def loss(self, label, score):
        a = float(self.config.alpha)
        d = torch.abs(score - label)
        return torch.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))


@register("fair")
class FairMetric(_PointwiseMetric):
    def loss(self, label, score):
        c = float(self.config.fair_c)
        x = torch.abs(score - label)
        return c * x - c * c * torch.log1p(x / c)


@register("poisson")
class PoissonMetric(_PointwiseMetric):
    """Poisson negative log-likelihood (score is the mean)."""
    def loss(self, label, score):
        mu = score.clamp_min(1e-10)
        return mu - label * torch.log(mu)


@register("mape", "mean_absolute_percentage_error")
class MAPEMetric(_PointwiseMetric):
    def loss(self, label, score):
        return torch.abs(score - label) / torch.abs(label).clamp_min(1.0)


@register("gamma")
class GammaMetric(_PointwiseMetric):
    """Gamma negative log-likelihood."""
    def loss(self, label, score):
        mu = score.clamp_min(1e-10)
        return label / mu + torch.log(mu)


@register("gamma_deviance", "gamma-deviance")
class GammaDevianceMetric(_PointwiseMetric):
    def loss(self, label, score):
        eps = 1e-10
        r = label / score.clamp_min(eps)
        return 2.0 * (torch.log((1.0 / r.clamp_min(eps)).clamp_min(eps)) +
                      r - 1.0)


@register("tweedie")
class TweedieMetric(_PointwiseMetric):
    def loss(self, label, score):
        rho = float(self.config.tweedie_variance_power)
        mu = score.clamp_min(1e-10)
        a = label * torch.pow(mu, 1 - rho) / (1 - rho)
        b = torch.pow(mu, 2 - rho) / (2 - rho)
        return -a + b


@register("cross_entropy", "xentropy")
class CrossEntropyMetric(_PointwiseMetric):
    def loss(self, label, score):
        return _log_loss(label, score.clamp(1e-15, 1 - 1e-15))


@register("cross_entropy_lambda", "xentlambda")
class CrossEntropyLambdaMetric(_PointwiseMetric):
    """An unweighted mean: the weight enters the per-row probability."""

    def eval(self, label, score, weight=None, query_boundaries=None):
        # score is log1p(exp(raw)) = hhat
        hhat = _f64(score).clamp_min(1e-15)
        label = _f64(label, hhat.device)
        if weight is None:
            z = 1.0 - torch.exp(-hhat)
        else:
            z = 1.0 - torch.exp(-_f64(weight, hhat.device) * hhat)
        z = z.clamp(1e-15, 1 - 1e-15)
        return _log_loss(label, z).mean().item()


@register("kldiv", "kullback_leibler")
class KLDivMetric(_PointwiseMetric):
    def loss(self, label, score):
        p = score.clamp(1e-15, 1 - 1e-15)
        y = label.clamp(0.0, 1.0)

        def xlogx(x):
            return torch.where(x > 0, x * torch.log(x.clamp_min(1e-15)),
                               torch.zeros_like(x))
        return xlogx(y) + xlogx(1 - y) - \
            (y * torch.log(p) + (1 - y) * torch.log(1 - p))


@register("auc")
class AUCMetric(Metric):
    """ROC AUC by rank-sum over sorted scores with tie handling
    (``binary_metric.hpp`` AUCMetric): per unique score, area +=
    tie_pos * (neg_below + tie_neg / 2)."""
    higher_better = True

    def eval(self, label, score, weight=None, query_boundaries=None):
        score = _f64(score)
        label = _f64(label, score.device)
        w = torch.ones_like(label) if weight is None \
            else _f64(weight, score.device)
        s, order = torch.sort(score, stable=True)
        pos_row = label[order] > 0
        w = w[order]
        wp = torch.where(pos_row, w, torch.zeros_like(w))
        wn = w - wp
        _, counts = torch.unique_consecutive(s, return_counts=True)
        ends = torch.cumsum(counts, 0) - 1
        # running totals at each unique score's last row, and the ties
        cum_pos = torch.cumsum(wp, 0)[ends]
        cum_neg = torch.cumsum(wn, 0)[ends]
        tie_pos = torch.diff(cum_pos, prepend=cum_pos.new_zeros(1))
        tie_neg = torch.diff(cum_neg, prepend=cum_neg.new_zeros(1))
        neg_below = cum_neg - tie_neg
        area = (tie_pos * (neg_below + tie_neg / 2.0)).sum()
        pos = wp.sum()
        neg = w.sum() - pos
        auc = torch.where((pos > 0) & (neg > 0), area / (pos * neg),
                          torch.ones_like(area))
        return auc.item()


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


class _HostMetric(Metric):
    """Evaluated in numpy on a host copy of its inputs."""

    def eval(self, label, score, weight=None, query_boundaries=None):
        return self._eval(np.asarray(_host(label), np.float64),
                          np.asarray(_host(score), np.float64),
                          None if weight is None else _host(weight),
                          None if query_boundaries is None
                          else np.asarray(_host(query_boundaries)))

    def _eval(self, label, score, weight, query_boundaries):
        raise NotImplementedError

    @staticmethod
    def _avg(values, weight):
        values = np.asarray(values, np.float64)
        if weight is None:
            return float(np.mean(values))
        return float(np.sum(values * weight) / np.sum(weight))


@register("multi_logloss", "multiclass", "softmax", "multiclassova",
          "multiclass_ova", "ova", "ovr")
class MultiLoglossMetric(_HostMetric):
    """score: (rows, num_class) probabilities."""
    def _eval(self, label, score, weight, query_boundaries):
        rows = np.arange(len(label))
        p = np.clip(score[rows, label.astype(np.int64)], 1e-15, 1.0)
        return self._avg(-np.log(p), weight)


@register("multi_error")
class MultiErrorMetric(_HostMetric):
    def _eval(self, label, score, weight, query_boundaries):
        k = max(int(self.config.multi_error_top_k), 1)
        if k == 1:
            pred = np.argmax(score, axis=1)
            err = pred != label.astype(np.int64)
        else:
            topk = np.argsort(-score, axis=1)[:, :k]
            err = ~np.any(topk == label.astype(np.int64)[:, None], axis=1)
        return self._avg(err.astype(np.float64), weight)


class _RankMetric(_HostMetric):
    """Reports one value per ``eval_at`` position (``eval_all``);
    ``eval`` is the first."""
    higher_better = True

    def __init__(self, config):
        super().__init__(config)
        self.eval_at = [int(k) for k in (config.eval_at or [1, 2, 3, 4, 5])]
        gains = config.label_gain
        self.label_gain = (np.asarray(gains, np.float64) if gains
                           else default_label_gain())

    def _eval(self, label, score, weight, query_boundaries):
        return self._eval_all(label, score, weight, query_boundaries)[0][1]

    def eval_all(self, label, score, weight=None, query_boundaries=None):
        return self._eval_all(np.asarray(_host(label), np.float64),
                              np.asarray(_host(score), np.float64),
                              None if weight is None else _host(weight),
                              None if query_boundaries is None
                              else np.asarray(_host(query_boundaries)))

    def _eval_all(self, label, score, weight, query_boundaries):
        if query_boundaries is None:
            raise ValueError(f"{self.name} requires query boundaries")
        out = []
        for k in self.eval_at:
            vals, ws = [], []
            for q in range(len(query_boundaries) - 1):
                lo, hi = query_boundaries[q], query_boundaries[q + 1]
                vals.append(self._query(label[lo:hi], score[lo:hi], k))
                ws.append(weight[lo] if weight is not None else 1.0)
            vals = np.asarray(vals)
            ws = np.asarray(ws)
            out.append((f"{self.name}@{k}",
                        float(np.sum(vals * ws) / np.sum(ws))))
        return out


@register("ndcg", "lambdarank")
class NDCGMetric(_RankMetric):
    """NDCG at each ``eval_at`` position."""

    def _query(self, label, score, k):
        g = self.label_gain[label.astype(np.int64)]
        if g.sum() <= 0:
            return 1.0  # no relevant docs counts as 1
        order = np.argsort(-score, kind="stable")
        top = g[order[:k]]
        dcg = np.sum(top / np.log2(np.arange(len(top)) + 2.0))
        ideal = np.sort(g)[::-1][:k]
        idcg = np.sum(ideal / np.log2(np.arange(len(ideal)) + 2.0))
        return dcg / idcg


@register("map", "mean_average_precision")
class MAPMetric(_RankMetric):
    def _query(self, label, score, k):
        rel = (label > 0).astype(np.float64)
        order = np.argsort(-score, kind="stable")
        r = rel[order[:k]]
        hits = np.cumsum(r)
        denom = np.arange(1, len(r) + 1)
        n_rel = min(int(rel.sum()), k) or 1
        return np.sum(r * hits / denom) / n_rel if rel.sum() > 0 else 0.0
