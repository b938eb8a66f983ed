"""Public ``Dataset`` / ``Booster`` API.

Counterpart of ``lightgbm_tpu/basic.py`` for this slice: a ``Dataset``
over a dense numerical matrix (binned on the device at first use), and a
``Booster`` that trains, predicts and reads and writes the model text.
The device comes from ``device_type`` (``cuda`` by default, which raises
without a card; ``cpu`` on request).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .config import Config
from .io.dataset import TorchDataset
from .models import model_io
from .models.gbdt import GBDT
from .objectives import create_objective
from .ops.predict import flatten_forest, predict_raw
from .utils.device import resolve_device
from .utils.log import Log

__all__ = ["Dataset", "Booster"]


def _to_matrix(data) -> np.ndarray:
    """float32 stays narrow; anything else becomes float64."""
    mat = np.asarray(data)
    if mat.dtype != np.float32:
        mat = np.asarray(mat, dtype=np.float64)
    if mat.ndim == 1:
        mat = mat.reshape(-1, 1)
    return mat


class Dataset:
    """Training data: binned on the device at first use."""

    def __init__(self, data, label=None, weight=None, feature_name="auto",
                 params: Optional[Dict[str, Any]] = None, **kwargs):
        unsupported = {k: v for k, v in kwargs.items()
                       if v is not None and v != "auto"}
        if unsupported:
            raise NotImplementedError(
                f"Dataset arguments {sorted(unsupported)} are not "
                f"implemented by lightgbm_tpu_torch yet")
        self.data = data
        self.label = label
        self.weight = weight
        self.feature_name = feature_name
        self.params = dict(params) if params else {}
        self._constructed: Optional[TorchDataset] = None

    def construct(self) -> "Dataset":
        if self._constructed is not None:
            return self
        cfg = Config(self.params)
        cfg.check_supported()
        names = None if self.feature_name in ("auto", None) \
            else list(self.feature_name)
        self._constructed = TorchDataset.from_raw(
            _to_matrix(self.data), self.label, cfg,
            resolve_device(cfg.device_type), weight=self.weight,
            feature_names=names)
        return self

    def num_data(self) -> int:
        return self.construct()._constructed.num_data

    def num_feature(self) -> int:
        return self.construct()._constructed.num_total_features


class Booster:
    """Trained model handle."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_str: Optional[str] = None,
                 model_file: Optional[str] = None, _eager: bool = False):
        """``_eager`` (internal): launch every kernel of training from
        Python on the card too, not as replays of CUDA graphs."""
        self.params = dict(params) if params else {}
        self._gbdt: Optional[GBDT] = None
        self.models = []
        if train_set is not None:
            train_set.params = {**train_set.params, **self.params}
            train_set.construct()
            self.config = Config(self.params)
            self.device = train_set._constructed.device
            self._objective = create_objective(self.config.objective,
                                               self.config)
            self._gbdt = GBDT(self.config, train_set._constructed,
                              self._objective, eager=_eager)
            self.models = self._gbdt.models
            ds = train_set._constructed
            self._feature_names = ds.feature_names
            self._feature_infos = ds.feature_infos()
            self._max_feature_idx = ds.num_total_features - 1
        elif model_str is not None or model_file is not None:
            if model_file is not None:
                with open(model_file) as f:
                    model_str = f.read()
            self.model_from_string(model_str)
        else:
            Log.fatal("need train_set, model_str or model_file")

    def model_from_string(self, model_str: str) -> "Booster":
        """Load trees and header fields from model text."""
        info = model_io.load_model_from_string(model_str)
        obj = info["objective"].split()
        cfg_params: Dict[str, Any] = {**self.params,
                                      "objective": obj[0] if obj
                                      else "regression"}
        for tok in obj[1:]:
            if ":" in tok:
                k, v = tok.split(":", 1)
                cfg_params[k] = v
        self.config = Config(cfg_params)
        self.device = resolve_device(self.config.device_type)
        self._objective = create_objective(self.config.objective,
                                           self.config)
        self._gbdt = None
        self.models = info["models"]
        self._feature_names = info["feature_names"]
        self._feature_infos = info["feature_infos"]
        self._max_feature_idx = info["max_feature_idx"]
        return self

    def update(self) -> bool:
        """One boosting iteration; True when training should stop."""
        if self._gbdt is None:
            Log.fatal("this booster holds no training data")
        return self._gbdt.train_one_iter()

    def current_iteration(self) -> int:
        return self._gbdt.iter if self._gbdt is not None else len(self.models)

    def num_trees(self) -> int:
        return len(self.models)

    def predict(self, data, num_iteration: Optional[int] = None,
                raw_score: bool = False) -> np.ndarray:
        trees = self.models
        if num_iteration is not None and num_iteration > 0:
            trees = trees[:num_iteration]
        ff = flatten_forest(trees, self.device)
        raw = predict_raw(ff, _to_matrix(data), self.device).cpu().numpy()
        return raw if raw_score else self._objective.convert_output(raw)

    def _objective_string(self) -> str:
        if self.config.objective == "binary":
            return f"binary sigmoid:{self.config.sigmoid:g}"
        return self.config.objective

    def model_to_string(self, num_iteration: Optional[int] = None) -> str:
        return model_io.save_model_to_string(
            self.models, num_class=1, num_tree_per_iteration=1,
            label_index=0, max_feature_idx=self._max_feature_idx,
            objective_str=self._objective_string(),
            feature_names=self._feature_names,
            feature_infos=self._feature_infos,
            num_iteration=-1 if num_iteration is None else num_iteration,
            parameters="")

    def save_model(self, filename: str,
                   num_iteration: Optional[int] = None) -> "Booster":
        model_io.write_model_file(str(filename),
                                  self.model_to_string(num_iteration))
        return self

    def feature_name(self) -> List[str]:
        return list(self._feature_names)
