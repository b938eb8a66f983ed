"""Public ``Dataset`` / ``Booster`` API.

Counterpart of ``lightgbm_tpu/basic.py`` for this slice: a ``Dataset`` over a
dense matrix (an array, or a pandas frame whose column names become the
feature names and whose ``category`` columns become their codes and
categorical features) or a scipy sparse matrix (binned from its columns,
kept sparse, densified in bounded row chunks where rows are predicted),
with categorical features named by ``categorical_feature`` (indices or
names, or the parameter's ``"0,1,2"`` / ``"name:c1,c2"``) and optional
query groups
(``group=``, per-query row counts; binned on the device at first use; a
validation set, ``reference=`` or ``create_valid``, bins with its reference's
mappers), and a ``Booster`` that trains (with the objective's gradients, or a
custom objective's through ``update(fobj=)``; objectives ``none``, ``custom``,
``null`` and ``na`` make none), evaluates its metrics on the training data and
validation sets, predicts and reads and writes the model text.  The device
comes from ``device_type`` (``cuda`` by default, which raises without a card;
``cpu`` on request); a dataset with a reference lives on its reference's
device.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .config import Config
from .io.dataset import TorchDataset
from .metrics import create_metrics, default_metric_for
from .models import model_io
from .models.boosting import create_boosting
from .models.gbdt import GBDT
from .objectives import create_objective
from .ops.predict import flatten_forest, is_sparse, predict_raw
from .utils.device import resolve_device
from .utils.log import Log

__all__ = ["Dataset", "Booster"]


# objective names that make no objective: a custom fobj gives the gradients
# (lightgbm_tpu/basic.py:437-441)
_NO_OBJECTIVE = ("none", "custom", "null", "na")


def _resolve_cat_indices(spec, names) -> List[int]:
    """Categorical features named by index or by column name -> column
    indices (``lightgbm_tpu/basic.py:37-48``)."""
    cat_idx = []
    for c in spec:
        if isinstance(c, str):
            if not names or c not in names:
                Log.fatal("categorical feature name %s not found", c)
            cat_idx.append(names.index(c))
        else:
            cat_idx.append(int(c))
    return cat_idx


def _param_cat_spec(spec) -> list:
    """The ``categorical_feature`` parameter (``"0,1,2"``, ``"name:c1,c2"``
    or a list) as a list of indices and names
    (``lightgbm_tpu/basic.py:127-140``)."""
    if isinstance(spec, str):
        spec = spec[5:] if spec.startswith("name:") else spec
        spec = [s.strip() for s in spec.split(",") if s.strip()]
        spec = [int(s) if s.lstrip("+-").isdigit() else s for s in spec]
    return list(spec)


def _to_matrix(data):
    """(matrix, column names or None, categorical column indices) of the
    JAX package's input types (``lightgbm_tpu/basic.py:50-80``): a pandas
    frame's values with its column names, each ``category`` column
    replaced by its codes (-1 for a missing value) and listed as
    categorical, a scipy sparse matrix (CSR, CSC, COO) as CSR, never
    densified whole (``lightgbm_tpu/basic.py:225-245``), else an array.
    float32 stays narrow; anything else becomes float64.  An ``object``
    column is fatal as in the JAX package."""
    if is_sparse(data):
        return data.tocsr(), None, []
    names = None
    cat_idx: List[int] = []
    if hasattr(data, "dtypes") and hasattr(data, "columns"):  # pandas
        names = [str(c) for c in data.columns]
        df = data.copy()
        for i, col in enumerate(df.columns):
            if str(df[col].dtype) == "category":
                df[col] = df[col].cat.codes
                cat_idx.append(i)
            elif df[col].dtype == object:
                Log.fatal("pandas object column %s is not supported; "
                          "use category dtype or numeric", col)
        mat = df.values
    else:
        mat = np.asarray(data)
    if mat.dtype != np.float32:
        mat = np.asarray(mat, dtype=np.float64)
    if mat.ndim == 1:
        mat = mat.reshape(-1, 1)
    return mat, names, cat_idx


class Dataset:
    """Training or validation data: binned on the device at first use,
    with the bin mappers of ``reference`` when one is given.
    ``categorical_feature``: column indices or names; ``"auto"`` takes
    the ``categorical_feature`` parameter, and a pandas frame's
    ``category`` columns, as the JAX package does."""

    def __init__(self, data, label=None, reference: "Dataset" = None,
                 weight=None, group=None, feature_name="auto",
                 categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None, **kwargs):
        unsupported = sorted(k for k, v in kwargs.items()
                             if v is not None and not
                             (isinstance(v, str) and v == "auto"))
        if unsupported:
            raise NotImplementedError(
                f"Dataset arguments {unsupported} are not "
                f"implemented by lightgbm_tpu_torch yet")
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params) if params else {}
        self._constructed: Optional[TorchDataset] = None
        self.raw_mat: Optional[np.ndarray] = None
        self.used_indices: Optional[np.ndarray] = None

    def construct(self) -> "Dataset":
        if self._constructed is not None:
            return self
        cfg = Config(self.params)
        cfg.check_supported()
        if self.categorical_feature in ("auto", None) and \
                cfg.categorical_feature:
            self.categorical_feature = _param_cat_spec(
                cfg.categorical_feature)
        mat, names, cat_idx = _to_matrix(self.data)
        if self.feature_name not in ("auto", None):
            names = list(self.feature_name)
        if self.categorical_feature not in ("auto", None):
            cat_idx = _resolve_cat_indices(self.categorical_feature, names)
        label, weight = self.label, self.weight
        if self.used_indices is not None:
            mat = mat[self.used_indices]
            label = None if label is None else \
                np.asarray(label)[self.used_indices]
            weight = None if weight is None else \
                np.asarray(weight)[self.used_indices]
        mappers = None
        device = None
        if self.reference is not None:
            ref = self.reference.construct()._constructed
            mappers, device = ref.mappers, ref.device
        # scipy input is binned from its CSC columns and stays sparse
        make = TorchDataset.from_sparse if is_sparse(mat) else \
            TorchDataset.from_raw
        self._constructed = make(
            mat, label, cfg, device or resolve_device(cfg.device_type),
            weight=weight, feature_names=names, mappers=mappers,
            group=self.group, categorical_features=cat_idx)
        self.raw_mat = mat
        return self

    def create_valid(self, data, label=None, weight=None, group=None,
                     params: Optional[Dict[str, Any]] = None) -> "Dataset":
        """A validation set binned with this dataset's mappers."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, params=params or self.params)

    def subset(self, used_indices, params: Optional[Dict[str, Any]] = None
               ) -> "Dataset":
        """The rows ``used_indices``, binned with this dataset's mappers
        (a validation set's subset keeps its reference's), without query
        groups, as in the JAX package."""
        ds = Dataset(self.data, label=self.label,
                     reference=self.reference if self.reference is not None
                     else self, weight=self.weight,
                     feature_name=self.feature_name,
                     params=params or self.params)
        ds.used_indices = np.asarray(used_indices)
        return ds

    def num_data(self) -> int:
        return self.construct()._constructed.num_data

    def num_feature(self) -> int:
        return self.construct()._constructed.num_total_features

    def get_label(self) -> np.ndarray:
        return np.asarray(self.construct()._constructed.metadata.label)

    def get_weight(self) -> Optional[np.ndarray]:
        return self.construct()._constructed.metadata.weight

    def get_group(self) -> Optional[np.ndarray]:
        """Per-query counts, or None."""
        qb = self.construct()._constructed.metadata.query_boundaries
        return None if qb is None else np.diff(qb)

    def set_group(self, group) -> "Dataset":
        self.group = group
        if self._constructed is not None:
            self._constructed.metadata.set_query(group)
        return self


class Booster:
    """Trained model handle."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_str: Optional[str] = None,
                 model_file: Optional[str] = None, _eager: bool = False):
        """``_eager`` (internal): launch every kernel of training from
        Python on the card too, not as replays of CUDA graphs."""
        self.params = dict(params) if params else {}
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._gbdt: Optional[GBDT] = None
        self.train_set = train_set
        self.models = []
        if train_set is not None:
            train_set.params = {**train_set.params, **self.params}
            train_set.construct()
            self.config = Config(self.params)
            self.device = train_set._constructed.device
            self._objective = None \
                if self.config.objective in _NO_OBJECTIVE else \
                create_objective(self.config.objective, self.config)
            metrics = create_metrics(self._resolve_metric_names(self.config),
                                     self.config)
            self._gbdt = create_boosting(self.config, train_set._constructed,
                                         self._objective, metrics,
                                         eager=_eager)
            self.models = self._gbdt.models
            self.average_output = self._gbdt.average_output
            self.num_class = self._gbdt.num_class
            self.num_tree_per_iteration = self._gbdt.num_tree_per_iteration
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

    @staticmethod
    def _resolve_metric_names(config) -> List[str]:
        """``metric``: comma-separated names or a list; empty means the
        objective's own loss, and ``None`` / ``na`` / ``null`` none
        (``lightgbm_tpu/basic.py:457-470``)."""
        m = config.metric
        if isinstance(m, str):
            names = [t.strip() for t in m.split(",")] if m else []
        else:
            names = list(m or [])
        if not names:
            if config.objective in _NO_OBJECTIVE:
                return []
            names = [default_metric_for(config.objective)]
        if any(n.lower() in ("none", "na", "null") for n in names):
            return []
        return names

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
        # model text of a custom objective names none
        self._objective = create_objective(self.config.objective,
                                           self.config) if obj else None
        self._gbdt = None
        self.models = info["models"]
        self.average_output = info["average_output"]
        self.num_class = info["num_class"]
        self.num_tree_per_iteration = info["num_tree_per_iteration"]
        self._feature_names = info["feature_names"]
        self._feature_infos = info["feature_infos"]
        self._max_feature_idx = info["max_feature_idx"]
        return self

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Register a validation set; it is binned with the training set's
        mappers if it was not given a reference."""
        if self._gbdt is None:
            Log.fatal("this booster holds no training data")
        data.reference = data.reference or self.train_set
        data.construct()
        if not self.train_set._constructed.check_align(data._constructed):
            Log.fatal("validation set %s bins are not aligned with the "
                      "training set (construct it with reference=train_set)",
                      name)
        self._gbdt.add_valid(name, data.raw_mat, data._constructed)
        return self

    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting iteration; True when training should stop.  With
        ``fobj``, the iteration's gradients are ``fobj(score, train_set)``
        on the float64 training score of class 0 (the JAX package's
        ``train_score[0]``, :521-530), as host arrays."""
        if self._gbdt is None:
            Log.fatal("this booster holds no training data")
        if train_set is not None and train_set is not self.train_set:
            raise NotImplementedError(
                "update(train_set=) with another dataset (reset_training_"
                "data) is not implemented by lightgbm_tpu_torch yet")
        if fobj is None:
            return self._gbdt.train_one_iter()
        score = self._gbdt.train_score()
        if score.ndim == 2:
            score = score[0]
        grad, hess = fobj(score.astype(np.float64), self.train_set)
        return self._gbdt.train_one_iter(np.asarray(grad, np.float32),
                                         np.asarray(hess, np.float32))

    def rollback_one_iter(self) -> "Booster":
        """Undo the last boosting iteration (``GBDT.rollback_one_iter``)."""
        if self._gbdt is None:
            Log.fatal("this booster holds no training data")
        self._gbdt.rollback_one_iter()
        return self

    def eval_set(self) -> list:
        """(data name, metric name, value, higher_better) of every metric
        on the training data (with ``is_provide_training_metric``) and
        each validation set."""
        return self._gbdt.eval_set()

    def eval_valid(self) -> list:
        return [r for r in self._gbdt.eval_set() if r[0] != "training"]

    def eval_train(self) -> list:
        return [r for r in self._gbdt.eval_set() if r[0] == "training"]

    def current_iteration(self) -> int:
        return self._gbdt.iter if self._gbdt is not None else len(self.models)

    def num_trees(self) -> int:
        return len(self.models)

    def _num_iteration(self, num_iteration: Optional[int]) -> int:
        """``None`` means the best iteration when early stopping found one,
        else every tree; an explicit value <= 0 every tree."""
        if num_iteration is None:
            return self.best_iteration if self.best_iteration > 0 else -1
        return num_iteration

    def predict(self, data, num_iteration: Optional[int] = None,
                raw_score: bool = False) -> np.ndarray:
        """(rows,) predictions, or (rows, K) for K classes (class k sums
        trees k, k + K, ...); ``num_iteration`` counts iterations of K
        trees (``lightgbm_tpu/models/gbdt.py:2975-2996``)."""
        trees = self.models
        k = self.num_tree_per_iteration
        ni = self._num_iteration(num_iteration)
        if ni > 0:
            trees = trees[:ni * k]
        ff = flatten_forest(trees, self.device)
        mat = _to_matrix(data)[0]
        raw = predict_raw(ff, mat, self.device, k).cpu().numpy()
        if k > 1:
            raw = raw.T
        if self.average_output and trees:
            # a random forest's output is the mean of its trees
            # (lightgbm_tpu/models/gbdt.py:2993-2994)
            raw = raw / max(len(trees) // k, 1)
        if raw_score or self._objective is None:
            return raw
        return self._objective.convert_output(raw)

    def _objective_string(self) -> str:
        obj = self.config.objective
        if obj in _NO_OBJECTIVE:
            return ""
        if obj == "binary":
            return f"binary sigmoid:{self.config.sigmoid:g}"
        if obj in ("multiclass", "multiclassova"):
            return f"{obj} num_class:{self.config.num_class}"
        return obj

    def model_to_string(self, num_iteration: Optional[int] = None) -> str:
        return model_io.save_model_to_string(
            self.models, num_class=self.num_class,
            num_tree_per_iteration=self.num_tree_per_iteration,
            label_index=0, max_feature_idx=self._max_feature_idx,
            objective_str=self._objective_string(),
            feature_names=self._feature_names,
            feature_infos=self._feature_infos,
            num_iteration=self._num_iteration(num_iteration),
            parameters="", average_output=self.average_output)

    def dump_model(self, num_iteration: Optional[int] = None) -> Dict:
        """The model as JSON (``lightgbm_tpu/basic.py:720-734``)."""
        return model_io.dump_model_json(
            self.models, num_class=self.num_class,
            num_tree_per_iteration=self.num_tree_per_iteration,
            label_index=0, max_feature_idx=self._max_feature_idx,
            objective_str=self._objective_string(),
            feature_names=self._feature_names,
            num_iteration=-1 if num_iteration is None else num_iteration)

    def save_model(self, filename: str,
                   num_iteration: Optional[int] = None) -> "Booster":
        model_io.write_model_file(str(filename),
                                  self.model_to_string(num_iteration))
        return self

    def feature_name(self) -> List[str]:
        return list(self._feature_names)
