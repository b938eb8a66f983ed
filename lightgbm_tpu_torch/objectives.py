"""Objective functions: gradients/hessians on the device.

Counterpart of ``lightgbm_tpu/objectives.py`` (:170-632): the regression
objectives (L2, L1, quantile, Huber, Fair, Poisson, MAPE, gamma,
Tweedie), binary log loss, cross-entropy (and its lambda form) and
multiclass (softmax and one-vs-all) and LambdaRank over query groups
(``lambdarank``, alias ``rank``, :633-776), under every alias the JAX
package registers: every objective it has.  ``get_gradients(score) ->
(grad, hess)`` over (N,) float32 device tensors, or (K, N) for the
multiclass objectives (``num_model_per_iteration = K``);
``boost_from_score(class_id)`` (the initial score) and ``convert_output``
(raw score -> prediction, on a numpy array or a tensor, which stays on
its device; (rows, K) for multiclass).  A name the JAX package does not
register (``rank_xendcg`` among them: only its config docstring names it)
is refused as unknown, as there.  A custom objective (``fobj``) is no
objective here: ``Booster`` takes its gradients (``models/gbdt.py``).

LambdaRank's pairwise lambdas run on the card as kernel U
(``ops/rank.py``, ``csrc/rank.cu``): float64 terms, each document's sums
rounded once to float32, within one float32 ulp of its plain version on
the CPU (the two sum in different orders; in practice the same bits).

Gradients that need ``exp``, ``log1p``, a sigmoid or a softmax are
evaluated in float64 and rounded once to float32: ``exp`` differs by an
ulp between the card's and the CPU's float32 libraries, and the one
rounding keeps the two devices' gradients identical (they are within a
few ulp of the JAX package's float32 chains).  Where the JAX package
rounds an argument to float32 before ``exp`` (``score + max_delta``,
``(1 - rho) * score``), the port rounds it the same way.  Gradients of
pure arithmetic (``sign``, ``where``, ``clip``, products, the Fair
quotient) stay in float32 in the JAX package's operation order, so they
are its bits.

L1, quantile and MAPE refit each leaf to a percentile of its residuals
(``renew_tree_output``, ``_RenewableRegression``): on the device, the
residuals ``label - score`` in float64, sorted by residual inside each
leaf, counted per leaf, and the unweighted percentile interpolated in
float64.  The weighted percentile (any ``weight=``; MAPE always) sums the
leaf's sorted weights in float32 in ``np.cumsum``'s sequential order,
which a parallel scan does not reproduce: that pass runs on the host over
the sorted weights (:func:`leaf_percentiles`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

import numpy as np
import torch

from .metrics import default_label_gain
from .ops.rank import lambda_gradients, rank_layout
from .utils.log import Log

__all__ = ["Objective", "RegressionL2", "RegressionL1", "Quantile", "Huber",
           "Fair", "Poisson", "MAPE", "Gamma", "Tweedie", "Binary",
           "MulticlassSoftmax", "MulticlassOVA", "CrossEntropy",
           "CrossEntropyLambda", "LambdaRank", "create_objective",
           "weighted_percentile", "leaf_percentiles", "RENEW_STATS"]

_REGISTRY: Dict[str, Type["Objective"]] = {}
# what the last renewals moved to the host: rows whose weights were
# fetched for the sequential sums, and leaves recomputed in row order
RENEW_STATS = {"calls": 0, "host_rows": 0, "row_order_leaves": 0}


def register(*names):
    def deco(cls):
        for n in names:
            _REGISTRY[n] = cls
        cls.name = names[0]
        return cls
    return deco


def _xp(x):
    """The array module of ``x``: torch for a tensor, else numpy."""
    return torch if isinstance(x, torch.Tensor) else np


def create_objective(name: str, config) -> "Objective":
    """Factory (``ObjectiveFunction::CreateObjectiveFunction``); an
    unknown name is fatal, as in the JAX package."""
    if name not in _REGISTRY:
        Log.fatal("unknown objective %s", name)
    return _REGISTRY[name](config)


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the JAX package's weak-typed Python
    constants meet a float32 array."""
    return float(np.float32(x))


def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` as a true division (``float / Tensor`` in PyTorch is a
    reciprocal times ``num``, another rounding)."""
    return torch.div(torch.full_like(den, num), den)


class Objective:
    name = "base"
    num_model_per_iteration = 1
    # whether the objective refits each leaf after the tree is made
    renews = False

    def __init__(self, config):
        self.config = config
        self.label: Optional[torch.Tensor] = None
        self.weight: Optional[torch.Tensor] = None

    def init(self, metadata, num_data: int, device: torch.device) -> None:
        self.num_data = num_data
        self.label = torch.as_tensor(metadata.label, dtype=torch.float32,
                                     device=device)
        self.weight = None if metadata.weight is None else torch.as_tensor(
            metadata.weight, dtype=torch.float32, device=device)
        self._label_np = np.asarray(metadata.label)
        self._weight_np = metadata.weight

    def _w(self, grad, hess):
        if self.weight is not None:
            return grad * self.weight, hess * self.weight
        return grad, hess

    def _w64(self, grad, hess):
        """float64 gradients weighted, then rounded once to float32."""
        if self.weight is not None:
            w = self.weight.to(torch.float64)
            grad, hess = grad * w, hess * w
        return grad.to(torch.float32), hess.to(torch.float32)

    def _weighted_mean_label(self) -> float:
        lab = np.asarray(self.label.cpu(), np.float64)
        if self._weight_np is not None:
            w = np.asarray(self._weight_np, np.float32).astype(np.float64)
            return float(np.sum(lab * w) / np.sum(w))
        return float(np.mean(lab))

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def convert_output(self, raw):
        return raw

    def renew_tree_output(self, tree, score, leaf_idx, mask) -> None:
        """Per-leaf refit after the tree is made (L1, quantile, MAPE);
        nothing for the others."""
        return None


@register("regression", "regression_l2", "l2", "mean_squared_error", "mse",
          "l2_root", "root_mean_squared_error", "rmse")
class RegressionL2(Objective):
    """L2 loss (``regression_objective.hpp`` RegressionL2loss);
    ``reg_sqrt`` fits sqrt(|label|) like the reference."""

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if self.config.reg_sqrt:
            self.label = torch.sign(self.label) * torch.sqrt(
                torch.abs(self.label))

    def get_gradients(self, score):
        return self._w(score - self.label, torch.ones_like(score))

    def boost_from_score(self, class_id=0):
        return self._weighted_mean_label()

    def convert_output(self, raw):
        if self.config.reg_sqrt:
            return _xp(raw).sign(raw) * raw * raw
        return raw


def weighted_percentile(values: np.ndarray, weights: Optional[np.ndarray],
                        alpha: float) -> float:
    """PercentileFun / WeightedPercentileFun (regression_objective.hpp),
    the JAX package's ``_weighted_percentile``, copied."""
    if len(values) == 0:
        return 0.0
    order = np.argsort(values)
    v = values[order]
    if weights is None:
        pos = alpha * (len(v) - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, len(v) - 1)
        return float(v[lo] + (pos - lo) * (v[hi] - v[lo]))
    w = weights[order]
    cum = np.cumsum(w)
    threshold = alpha * cum[-1]
    idx = int(np.searchsorted(cum, threshold, side="left"))
    return float(v[min(idx, len(v) - 1)])


def leaf_percentiles(residual: torch.Tensor, leaf_idx: torch.Tensor,
                     in_bag: torch.Tensor, weight: Optional[torch.Tensor],
                     alpha: float, num_leaves: int) -> Dict[int, float]:
    """Each leaf's ``weighted_percentile`` of the residuals of its in-bag
    rows -> {leaf: value} for the leaves with any.

    ``residual`` (N,) float64, ``leaf_idx`` (N,) integer, ``in_bag`` (N,)
    bool and ``weight`` (N,) float32 or None, on one device.  The rows are
    sorted by residual, then stably by leaf (out-of-bag rows last), so a
    leaf's rows are a sorted segment with ties in row order.  Unweighted,
    the interpolation runs on the device in float64 and only the (L,)
    values come back.  Weighted, the segments' float32 weights come to the
    host, where ``np.cumsum`` and ``np.searchsorted`` pick each leaf's
    position as the reference does, and the values at those positions
    come back.  ``np.argsort`` orders ties its own way, and the float32
    prefix sums depend on the order of tied rows whose weights differ, so
    a leaf holding such a tie is recomputed on the host from its rows in
    row order (a stable sort by leaf alone gives them, in one copy for
    all such leaves), exactly as the reference does."""
    dev = residual.device
    L = int(num_leaves)
    key = torch.where(in_bag, leaf_idx.to(torch.int64),
                      torch.full_like(leaf_idx, L, dtype=torch.int64))
    by_res = torch.sort(residual, stable=True).indices
    order = by_res[torch.sort(key[by_res], stable=True).indices]
    v = residual[order]
    counts = torch.bincount(key, minlength=L + 1)[:L]
    starts = torch.cumsum(counts, 0) - counts
    RENEW_STATS["calls"] += 1
    if weight is None:
        n = counts
        pos = alpha * (n - 1).clamp(min=0).to(torch.float64)
        lo = torch.floor(pos).to(torch.int64)
        hi = torch.minimum(lo + 1, (n - 1).clamp(min=0))
        v_lo = v[(starts + lo).clamp(max=v.numel() - 1)]
        v_hi = v[(starts + hi).clamp(max=v.numel() - 1)]
        vals = v_lo + (pos - lo.to(torch.float64)) * (v_hi - v_lo)
        vals, n = vals.cpu().numpy(), counts.cpu().numpy()
        return {leaf: float(vals[leaf]) for leaf in range(L) if n[leaf] > 0}
    w = weight[order]
    k = key[order]
    # leaves holding tied residuals with different weights
    tie = (v[1:] == v[:-1]) & (k[1:] == k[:-1]) & (w[1:] != w[:-1]) & \
        (k[1:] < L)
    tied = torch.zeros(L + 1, dtype=torch.bool, device=dev)
    tied[k[1:][tie]] = True
    n = counts.cpu().numpy()
    s = starts.cpu().numpy()
    n_in = int(n.sum())
    w_host = w[:n_in].cpu().numpy()
    tied = tied[:L].cpu().numpy()
    RENEW_STATS["host_rows"] += n_in
    if tied.any():
        # every leaf's rows in row order, at the same segments
        by_row = torch.sort(key, stable=True).indices[:n_in]
        v_rows = residual[by_row].cpu().numpy()
        w_rows = weight[by_row].cpu().numpy()
        RENEW_STATS["host_rows"] += n_in
    out, pick = {}, {}
    for leaf in range(L):
        if n[leaf] == 0:
            continue
        a, b = int(s[leaf]), int(s[leaf] + n[leaf])
        if tied[leaf]:
            RENEW_STATS["row_order_leaves"] += 1
            out[leaf] = weighted_percentile(v_rows[a:b], w_rows[a:b], alpha)
            continue
        cum = np.cumsum(w_host[a:b])
        threshold = alpha * cum[-1]
        idx = int(np.searchsorted(cum, threshold, side="left"))
        pick[leaf] = a + min(idx, b - a - 1)
    if pick:
        at = torch.as_tensor(list(pick.values()), dtype=torch.int64,
                             device=dev)
        vals = v[at].cpu().numpy()
        for leaf, val in zip(pick, vals):
            out[leaf] = float(val)
    return out


class _RenewableRegression(Objective):
    """Base of the objectives whose leaf outputs are refit as per-leaf
    percentiles of the residuals (``RenewTreeOutput``,
    ``regression_objective.hpp``; the JAX package's
    ``_RenewableRegression``)."""
    renew_alpha = 0.5
    renews = True

    def _renew_weight(self) -> Optional[torch.Tensor]:
        return self.weight

    def renew_tree_output(self, tree, score, leaf_idx, mask) -> None:
        """``score``: the (N,) float32 training score before this tree;
        ``leaf_idx`` its rows' leaves; ``mask`` (N,) the tree's sample
        (in bag where above 0).  Sets ``tree.leaf_value`` of every leaf
        with an in-bag row."""
        N = self.num_data
        residual = self.label.to(torch.float64) - \
            score[:N].to(torch.float64)
        vals = leaf_percentiles(residual, leaf_idx[:N], mask[:N] > 0,
                                self._renew_weight(), self.renew_alpha,
                                tree.num_leaves)
        for leaf, val in vals.items():
            tree.leaf_value[leaf] = val

    def _label_percentile(self, weights, alpha) -> float:
        return weighted_percentile(
            np.asarray(self.label.cpu(), np.float64),
            None if weights is None else np.asarray(weights, np.float32),
            alpha)


@register("regression_l1", "l1", "mean_absolute_error", "mae")
class RegressionL1(_RenewableRegression):
    """L1 loss: constant gradients with per-leaf median refit."""

    def get_gradients(self, score):
        return self._w(torch.sign(score - self.label),
                       torch.ones_like(score))

    def boost_from_score(self, class_id=0):
        return self._label_percentile(self._weight_np, 0.5)


@register("quantile")
class Quantile(_RenewableRegression):
    """Pinball loss at ``alpha`` with per-leaf quantile refit."""

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(config.alpha)
        self.renew_alpha = self.alpha

    def get_gradients(self, score):
        below = torch.full_like(score, _f32(-self.alpha))
        above = torch.full_like(score, _f32(1.0 - self.alpha))
        grad = torch.where(self.label > score, below, above)
        return self._w(grad, torch.ones_like(score))

    def boost_from_score(self, class_id=0):
        return self._label_percentile(self._weight_np, self.alpha)


@register("huber")
class Huber(Objective):
    """Huber loss with transition at ``alpha``."""

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(config.alpha)

    def get_gradients(self, score):
        a = _f32(self.alpha)
        grad = torch.clamp(score - self.label, min=-a, max=a)
        return self._w(grad, torch.ones_like(score))

    def boost_from_score(self, class_id=0):
        return self._weighted_mean_label()


@register("fair")
class Fair(Objective):
    """Fair loss: c*d/(|d|+c) gradient (regression_objective.hpp)."""

    def __init__(self, config):
        super().__init__(config)
        self.c = float(config.fair_c)

    def get_gradients(self, score):
        d = score - self.label
        denom = torch.abs(d) + _f32(self.c)
        grad = (d * _f32(self.c)) / denom
        hess = _div(_f32(self.c * self.c), denom * denom)
        return self._w(grad, hess)


@register("poisson")
class Poisson(Objective):
    """Poisson regression with log link."""

    def __init__(self, config):
        super().__init__(config)
        self.max_delta = float(config.poisson_max_delta_step)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if np.any(np.asarray(metadata.label) < 0):
            Log.fatal("poisson objective requires non-negative labels")

    def get_gradients(self, score):
        grad = torch.exp(score.to(torch.float64)) - \
            self.label.to(torch.float64)
        hess = torch.exp((score + _f32(self.max_delta)).to(torch.float64))
        return self._w64(grad, hess)

    def boost_from_score(self, class_id=0):
        return float(np.log(max(self._weighted_mean_label(), 1e-12)))

    def convert_output(self, raw):
        return _xp(raw).exp(raw)


@register("mape")
class MAPE(_RenewableRegression):
    """Mean absolute percentage error: L1 with 1/|label| row weights and
    weighted-median leaf refit."""

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        lab = np.asarray(metadata.label, np.float64)
        w = 1.0 / np.maximum(1.0, np.abs(lab))
        if metadata.weight is not None:
            w = w * np.asarray(metadata.weight, np.float64)
        w = w / np.sum(w) * num_data
        self._label_weight_np = w.astype(np.float32)
        self._label_weight = torch.as_tensor(self._label_weight_np,
                                             device=device)
        self.weight = None  # folded into _label_weight

    def get_gradients(self, score):
        grad = torch.sign(score - self.label) * self._label_weight
        return grad, self._label_weight

    def _renew_weight(self):
        return self._label_weight

    def boost_from_score(self, class_id=0):
        return self._label_percentile(self._label_weight_np, 0.5)


@register("gamma")
class Gamma(Objective):
    """Gamma regression with log link."""

    def get_gradients(self, score):
        e = torch.exp(-score.to(torch.float64))
        le = self.label.to(torch.float64) * e
        return self._w64(1.0 - le, le)

    def boost_from_score(self, class_id=0):
        return float(np.log(max(self._weighted_mean_label(), 1e-12)))

    def convert_output(self, raw):
        return _xp(raw).exp(raw)


@register("tweedie")
class Tweedie(Objective):
    """Tweedie deviance with variance power rho in [1, 2)."""

    def __init__(self, config):
        super().__init__(config)
        self.rho = float(config.tweedie_variance_power)

    def get_gradients(self, score):
        r1, r2 = _f32(1.0 - self.rho), _f32(2.0 - self.rho)
        a = torch.exp((score * r1).to(torch.float64))
        b = torch.exp((score * r2).to(torch.float64))
        y = self.label.to(torch.float64)
        grad = -y * a + b
        hess = -y * r1 * a + r2 * b
        return self._w64(grad, hess)

    def boost_from_score(self, class_id=0):
        return float(np.log(max(self._weighted_mean_label(), 1e-12)))

    def convert_output(self, raw):
        return _xp(raw).exp(raw)


@register("binary")
class Binary(Objective):
    """Log loss (``binary_objective.hpp``): labels {0,1} mapped to ±1,
    sigmoid scaling, ``scale_pos_weight`` / ``is_unbalance`` class
    weights, initial score log(p/(1-p))/sigmoid."""

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        lab = np.asarray(metadata.label)
        vals = np.unique(lab)
        if not np.all(np.isin(vals, [0.0, 1.0])):
            Log.fatal("binary objective requires 0/1 labels, got %s",
                      vals[:5])
        cnt_pos = float(np.sum(lab == 1))
        cnt_neg = float(np.sum(lab == 0))
        # minority class upweighting + multiplicative scale_pos_weight
        # (binary_objective.hpp:82-91)
        w_neg, w_pos = 1.0, 1.0
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w_neg = cnt_pos / cnt_neg
            else:
                w_pos = cnt_neg / cnt_pos
        w_pos *= float(self.config.scale_pos_weight)
        self.label_weights = (w_neg, w_pos)
        if metadata.weight is not None:
            sw = np.asarray(metadata.weight, np.float64)
            sum_pos = float(np.sum(sw * (lab == 1)))
            sum_neg = float(np.sum(sw * (lab == 0)))
        else:
            sum_pos, sum_neg = cnt_pos, cnt_neg
        self._p_mean = (sum_pos * w_pos) / max(
            sum_pos * w_pos + sum_neg * w_neg, 1e-12)
        # float32 like the JAX package, widened for the evaluation
        self.sign_label = torch.as_tensor(
            np.where(lab == 1, 1.0, -1.0).astype(np.float32),
            device=device).to(torch.float64)
        self.cls_weight = torch.as_tensor(
            np.where(lab == 1, w_pos, w_neg).astype(np.float32),
            device=device).to(torch.float64)
        self._weight64 = None if self.weight is None else \
            self.weight.to(torch.float64)

    def get_gradients(self, score):
        # response = -yl*sigma / (1 + exp(yl*sigma*score))
        t = self.sign_label * _f32(self.sigmoid)
        response = -t / (1.0 + torch.exp(t * score.to(torch.float64)))
        absr = torch.abs(response)
        grad = response * self.cls_weight
        hess = absr * (_f32(self.sigmoid) - absr) * self.cls_weight
        if self._weight64 is not None:
            grad = grad * self._weight64
            hess = hess * self._weight64
        return grad.to(torch.float32), hess.to(torch.float32)

    def boost_from_score(self, class_id=0):
        p = min(max(self._p_mean, 1e-12), 1 - 1e-12)
        return float(np.log(p / (1 - p)) / self.sigmoid)

    def convert_output(self, raw):
        return 1.0 / (1.0 + _xp(raw).exp(-self.sigmoid * raw))


def _class_labels(metadata, num_class: int) -> np.ndarray:
    lab = np.asarray(metadata.label).astype(np.int32)
    if lab.min() < 0 or lab.max() >= num_class:
        Log.fatal("multiclass label out of range [0, %d)", num_class)
    return lab


@register("multiclass", "softmax")
class MulticlassSoftmax(Objective):
    """Softmax multiclass (``multiclass_objective.hpp``): one tree per
    class per iteration; grad = p - 1{y=k}, hess = 2 p (1-p)."""

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        if self.num_class < 2:
            Log.fatal("multiclass objective requires num_class >= 2")
        self.num_model_per_iteration = self.num_class

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        lab = _class_labels(metadata, self.num_class)
        self._onehot = torch.as_tensor(
            np.eye(self.num_class, dtype=np.float64)[lab].T.copy(),
            device=device)                                   # (K, N)
        counts = np.bincount(lab, minlength=self.num_class).astype(
            np.float64)
        self._class_init = np.log(np.maximum(counts / counts.sum(), 1e-10))

    def get_gradients(self, score):
        # score (K, N)
        p = torch.softmax(score.to(torch.float64), dim=0)
        grad = p - self._onehot
        hess = 2.0 * p * (1.0 - p)
        if self.weight is not None:
            w = self.weight.to(torch.float64)[None, :]
            grad, hess = grad * w, hess * w
        return grad.to(torch.float32), hess.to(torch.float32)

    def boost_from_score(self, class_id=0):
        return float(self._class_init[class_id])

    def convert_output(self, raw):
        # raw (rows, K)
        xp = _xp(raw)
        if xp is torch:
            return torch.softmax(raw, dim=-1)
        e = np.exp(raw - raw.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)


@register("multiclassova", "multiclass_ova", "ova", "ovr")
class MulticlassOVA(Objective):
    """One-vs-all multiclass: K independent binary objectives."""

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        if self.num_class < 2:
            Log.fatal("multiclassova requires num_class >= 2")
        self.num_model_per_iteration = self.num_class
        self.sigmoid = float(config.sigmoid)

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        lab = _class_labels(metadata, self.num_class)
        self._sign = torch.as_tensor(np.where(
            np.eye(self.num_class, dtype=bool)[lab].T, 1.0, -1.0),
            device=device)                                    # (K, N)
        counts = np.bincount(lab, minlength=self.num_class).astype(
            np.float64)
        p = np.clip(counts / counts.sum(), 1e-12, 1 - 1e-12)
        self._class_init = np.log(p / (1 - p)) / self.sigmoid

    def get_gradients(self, score):
        t = self._sign * _f32(self.sigmoid)
        response = -t / (1.0 + torch.exp(t * score.to(torch.float64)))
        absr = torch.abs(response)
        grad = response
        hess = absr * (_f32(self.sigmoid) - absr)
        if self.weight is not None:
            w = self.weight.to(torch.float64)[None, :]
            grad, hess = grad * w, hess * w
        return grad.to(torch.float32), hess.to(torch.float32)

    def boost_from_score(self, class_id=0):
        return float(self._class_init[class_id])

    def convert_output(self, raw):
        return 1.0 / (1.0 + _xp(raw).exp(-self.sigmoid * raw))


@register("cross_entropy", "xentropy")
class CrossEntropy(Objective):
    """Cross-entropy for probabilistic labels in [0, 1]
    (``xentropy_objective.hpp:71``)."""

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        lab = np.asarray(metadata.label)
        if lab.min() < 0 or lab.max() > 1:
            Log.fatal("cross_entropy labels must be in [0, 1]")

    def get_gradients(self, score):
        z = torch.sigmoid(score.to(torch.float64))
        return self._w64(z - self.label.to(torch.float64), z * (1.0 - z))

    def boost_from_score(self, class_id=0):
        p = np.clip(self._weighted_mean_label(), 1e-12, 1 - 1e-12)
        return float(np.log(p / (1 - p)))

    def convert_output(self, raw):
        return 1.0 / (1.0 + _xp(raw).exp(-raw))


@register("cross_entropy_lambda", "xentlambda")
class CrossEntropyLambda(Objective):
    """Alternative-parameterization cross-entropy
    (``xentropy_objective.hpp:181``)."""

    def get_gradients(self, score):
        s = score.to(torch.float64)
        y = self.label.to(torch.float64)
        if self.weight is None:
            z = torch.sigmoid(s)
            return (z - y).to(torch.float32), \
                (z * (1.0 - z)).to(torch.float32)
        w = self.weight.to(torch.float64)
        epf = torch.exp(s)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-w * hhat)
        enf = 1.0 / epf
        grad = (1.0 - y / z) * w / (1.0 + enf)
        c = 1.0 / (1.0 - z)
        d = 1.0 + epf
        a = w * epf / (d * d)
        d = c - 1.0
        b = (c / (d * d)) * (1.0 + w * epf - c)
        hess = a * (1.0 + y * b)
        return grad.to(torch.float32), hess.to(torch.float32)

    def boost_from_score(self, class_id=0):
        p = np.clip(self._weighted_mean_label(), 1e-12, 1 - 1e-12)
        return float(np.log(np.expm1(-np.log1p(-p))))

    def convert_output(self, raw):
        return _xp(raw).log1p(_xp(raw).exp(raw))


@register("lambdarank", "rank")
class LambdaRank(Objective):
    """LambdaRank with NDCG gains (``rank_objective.hpp:19``,
    ``lightgbm_tpu/objectives.py:633-776``): ``sigmoid``,
    ``lambdamart_norm``, ``max_position`` and ``label_gain`` (default
    ``2^i - 1``) from the config.  ``init`` needs the dataset's query
    boundaries and builds the static layout (``ops/rank.py``
    ``rank_layout``: each row's gain, each query's inverse ideal DCG in
    float64 truncated at ``max_position`` then float32, the discount
    table).  ``get_gradients`` writes into two static (N,) buffers:
    kernel U for a CUDA score, its plain version for a CPU one."""

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        self.norm = bool(config.lambdamart_norm)
        self.max_position = int(config.max_position)
        gains = config.label_gain
        self.label_gain = (np.asarray(gains, np.float64) if gains
                           else default_label_gain())

    def init(self, metadata, num_data, device):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            Log.fatal("lambdarank requires query information (set group)")
        lab = np.asarray(metadata.label).astype(np.int64)
        if lab.max() >= len(self.label_gain):
            Log.fatal("label %d exceeds label_gain table size %d",
                      int(lab.max()), len(self.label_gain))
        self.layout = rank_layout(metadata.query_boundaries, lab,
                                  self.label_gain, self.max_position, device)
        self._out = tuple(torch.empty(num_data, dtype=torch.float32,
                                      device=device) for _ in range(2))

    def get_gradients(self, score):
        return lambda_gradients(score.reshape(-1), self.layout, self.weight,
                                self.sigmoid, self.norm, out=self._out)
