"""Objective functions: gradients/hessians on the device.

Counterpart of ``lightgbm_tpu/objectives.py`` for the objectives of this
slice: ``BinaryLogloss`` (``binary``) and ``RegressionL2``
(``regression``).  ``get_gradients(score) -> (grad, hess)`` over (N,)
float32 device tensors, ``boost_from_score`` (the initial score) and
``convert_output`` (raw score -> prediction, on a numpy array or a
tensor, which stays on its device).  Any other objective name raises.

The binary gradients are evaluated in float64 and rounded once to
float32: ``exp`` differs by an ulp between the card's and the CPU's
float32 libraries, and the one rounding keeps the two devices' gradients
identical.  The L2 gradient ``score - label`` is exact either way.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Type

import numpy as np
import torch

from .utils.log import Log

__all__ = ["Objective", "RegressionL2", "Binary", "create_objective"]

_REGISTRY: Dict[str, Type["Objective"]] = {}


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
    """Factory (``ObjectiveFunction::CreateObjectiveFunction``)."""
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"objective {name!r} is not implemented by lightgbm_tpu_torch "
            f"yet (binary and regression are)")
    return _REGISTRY[name](config)


class Objective:
    name = "base"

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

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self) -> float:
        return 0.0

    def convert_output(self, raw):
        return raw


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
        grad = score - self.label
        hess = torch.ones_like(score)
        if self.weight is not None:
            grad, hess = grad * self.weight, hess * self.weight
        return grad, hess

    def boost_from_score(self):
        lab = np.asarray(self.label.cpu(), np.float64)
        if self._weight_np is not None:
            w = np.asarray(self._weight_np, np.float64)
            return float(np.sum(lab * w) / np.sum(w))
        return float(np.mean(lab))

    def convert_output(self, raw):
        if self.config.reg_sqrt:
            return _xp(raw).sign(raw) * raw * raw
        return raw


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
        t = self.sign_label * np.float32(self.sigmoid).item()
        response = -t / (1.0 + torch.exp(t * score.to(torch.float64)))
        absr = torch.abs(response)
        grad = response * self.cls_weight
        hess = absr * (np.float32(self.sigmoid).item() - absr) * \
            self.cls_weight
        if self._weight64 is not None:
            grad = grad * self._weight64
            hess = hess * self._weight64
        return grad.to(torch.float32), hess.to(torch.float32)

    def boost_from_score(self):
        p = min(max(self._p_mean, 1e-12), 1 - 1e-12)
        return float(np.log(p / (1 - p)) / self.sigmoid)

    def convert_output(self, raw):
        return 1.0 / (1.0 + _xp(raw).exp(-self.sigmoid * raw))
