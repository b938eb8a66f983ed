"""Carry state across from the JAX package: bin mappers and trees.

:func:`from_jax_arrays` builds the port's objects from plain numpy
arrays and dicts (or model text) that a caller extracts from the JAX
package's objects; it never unpickles a JAX class, so nothing of the JAX
package is imported here.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .basic import Booster
from .io.binning import BIN_CATEGORICAL, BinMapper
from .models.tree import Tree

__all__ = ["mapper_from_arrays", "tree_from_arrays", "from_jax_arrays"]

_TREE_FIELDS = {
    "split_feature": np.int32, "split_gain": np.float64,
    "threshold": np.float64, "decision_type": np.int8,
    "left_child": np.int32, "right_child": np.int32,
    "internal_value": np.float64, "internal_weight": np.float64,
    "internal_count": np.int64,
}
_LEAF_FIELDS = {"leaf_value": np.float64, "leaf_weight": np.float64,
                "leaf_count": np.int64}


def mapper_from_arrays(d: Dict[str, Any]) -> BinMapper:
    """A :class:`BinMapper` from ``num_bin``, ``missing_type``,
    ``bin_type``, ``bin_upper_bound`` and ``default_bin`` (``min_val`` /
    ``max_val`` optional, for the model text's feature infos); a
    categorical one also from ``categorical_2_bin`` (code -> bin) and
    ``bin_2_categorical`` (bin -> code, -1 for bin 0), and
    ``is_trivial`` when given (a categorical mapper with one category is
    trivial though it has two bins)."""
    m = BinMapper()
    m.num_bin = int(d["num_bin"])
    m.bin_type = int(d["bin_type"])
    m.missing_type = int(d["missing_type"])
    m.bin_upper_bound = np.asarray(d["bin_upper_bound"], np.float64)
    m.default_bin = int(d["default_bin"])
    m.min_val = float(d.get("min_val", 0.0))
    m.max_val = float(d.get("max_val", 0.0))
    if m.bin_type == BIN_CATEGORICAL:
        m.categorical_2_bin = {int(k): int(v) for k, v in
                               dict(d["categorical_2_bin"]).items()}
        m.bin_2_categorical = [int(c) for c in d["bin_2_categorical"]]
    m.is_trivial = bool(d.get("is_trivial", m.num_bin <= 1))
    return m


def tree_from_arrays(d: Dict[str, Any]) -> Tree:
    """A :class:`Tree` from its per-node and per-leaf arrays
    (``num_leaves``, ``split_feature``, ``threshold``, ``decision_type``,
    ``left_child``, ``right_child``, ``leaf_value``; with categorical
    nodes ``num_cat``, ``cat_boundaries`` and ``cat_threshold``; the other
    fields of the model text are optional)."""
    num_leaves = int(d["num_leaves"])
    tree = Tree(max(num_leaves, 2))
    tree.num_leaves = num_leaves
    n_in = num_leaves - 1
    for key, dtype in _TREE_FIELDS.items():
        if key in d and n_in > 0:
            getattr(tree, key)[:n_in] = np.asarray(d[key], dtype)[:n_in]
    for key, dtype in _LEAF_FIELDS.items():
        if key in d:
            getattr(tree, key)[:num_leaves] = \
                np.asarray(d[key], dtype)[:num_leaves]
    tree.num_cat = int(d.get("num_cat", 0))
    if tree.num_cat:
        tree.cat_boundaries = [int(x) for x in d["cat_boundaries"]]
        tree.cat_threshold = [int(x) for x in d["cat_threshold"]]
    if n_in > 0:
        tree.threshold_bin[:n_in] = np.asarray(
            d.get("threshold_bin", tree.threshold[:n_in]), np.int32)[:n_in]
        tree._rebuild_parents()
    tree.shrinkage = float(d.get("shrinkage", 1.0))
    return tree


def from_jax_arrays(mappers: Sequence[Dict[str, Any]],
                    trees: Optional[Sequence[Dict[str, Any]]] = None,
                    model_text: Optional[str] = None,
                    objective: str = "regression",
                    params: Optional[Dict[str, Any]] = None,
                    feature_names: Optional[List[str]] = None) -> Booster:
    """A port :class:`Booster` holding the JAX package's trees.

    ``mappers``: one dict per raw feature (see
    :func:`mapper_from_arrays`).  Trees come from ``trees`` (dicts, see
    :func:`tree_from_arrays`) or from ``model_text``.  ``objective`` is
    the model text's objective string (e.g. ``"binary sigmoid:1"``);
    ``params`` carries ``device_type`` and the like."""
    bin_mappers = [mapper_from_arrays(d) for d in mappers]
    names = list(feature_names) if feature_names else \
        [f"Column_{i}" for i in range(len(bin_mappers))]
    if model_text is None:
        if trees is None:
            raise ValueError("pass trees or model_text")
        from .models import model_io
        model_text = model_io.save_model_to_string(
            [tree_from_arrays(t) for t in trees], num_class=1,
            num_tree_per_iteration=1, label_index=0,
            max_feature_idx=len(bin_mappers) - 1, objective_str=objective,
            feature_names=names,
            feature_infos=[m.feature_info() for m in bin_mappers])
    booster = Booster(params=params, model_str=model_text)
    booster.mappers = bin_mappers
    return booster
