"""Model text serialization.

Capability parity with ``src/boosting/gbdt_model_text.cpp``: versioned
text model (``SaveModelToString:244``), load (``LoadModelFromString:343``)
and the feature importances it prints (``FeatureImportance:513``).  The format matches the reference's v2 text
layout so models can be exchanged with the reference implementation and
with the JAX package; categorical features' infos list their categories
and categorical nodes carry ``cat_boundaries`` / ``cat_threshold``.  A
copy of the text and JSON parts of ``lightgbm_tpu/models/model_io.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..utils.log import Log
from .tree import Tree

_EOT = "end of trees"


def write_model_file(filename: str, text: str) -> None:
    """Write model text to a temporary file beside ``filename`` and
    rename it over the target, so a crash mid-save never leaves a
    truncated model file."""
    import os
    tmp = f"{filename}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, filename)


def save_model_to_string(models: List[Tree], *, num_class: int,
                         num_tree_per_iteration: int, label_index: int,
                         max_feature_idx: int, objective_str: str,
                         feature_names: List[str],
                         feature_infos: List[str],
                         num_iteration: int = -1,
                         parameters: str = "",
                         average_output: bool = False) -> str:
    k = num_tree_per_iteration
    n_trees = len(models)
    if num_iteration is not None and num_iteration > 0:
        n_trees = min(n_trees, num_iteration * k)
    tree_strs = [models[i].to_string(i) for i in range(n_trees)]
    out = ["tree", "version=v2",
           f"num_class={num_class}",
           f"num_tree_per_iteration={k}",
           f"label_index={label_index}",
           f"max_feature_idx={max_feature_idx}",
           f"objective={objective_str}"]
    if average_output:
        out.append("average_output")  # RF marker (gbdt_model_text.cpp:258)
    out += ["feature_names=" + " ".join(feature_names),
            "feature_infos=" + " ".join(feature_infos),
            "tree_sizes=" + " ".join(str(len(s) + 1) for s in tree_strs),
            ""]
    for s in tree_strs:
        out.append(s)
    out.append(_EOT + "\n")
    imp = feature_importance(models[:n_trees], "split")
    pairs = sorted([(feature_names[i], int(v)) for i, v in enumerate(imp)
                    if i < len(feature_names) and v > 0],
                   key=lambda x: -x[1])
    out.append("feature importances:")
    out += [f"{n}={v}" for n, v in pairs]
    if parameters:
        out.append("\nparameters:")
        out.append(parameters)
        out.append("end of parameters")
    return "\n".join(out) + "\n"


def load_model_from_string(text: str) -> Dict:
    """Parse a model file into {models, header fields}."""
    if not text.startswith("tree"):
        Log.fatal("model text does not start with 'tree' header")
    header, _, rest = text.partition("\nTree=")
    kv: Dict[str, str] = {}
    for line in header.splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            kv[k] = v
    trees_text = rest.split(_EOT)[0] if rest else ""
    models = []
    for block in trees_text.split("\nTree="):
        block = block.strip()
        if not block:
            continue
        models.append(Tree.from_string("Tree=" + block))
    return {
        "models": models,
        "num_class": int(kv.get("num_class", "1")),
        "num_tree_per_iteration": int(kv.get("num_tree_per_iteration", "1")),
        "label_index": int(kv.get("label_index", "0")),
        "max_feature_idx": int(kv.get("max_feature_idx", "0")),
        "objective": kv.get("objective", "regression"),
        "feature_names": kv.get("feature_names", "").split(),
        "feature_infos": kv.get("feature_infos", "").split(),
        "average_output": any(line.strip() == "average_output"
                              for line in header.splitlines()),
    }


def dump_model_json(models: List[Tree], *, num_class: int,
                    num_tree_per_iteration: int, label_index: int,
                    max_feature_idx: int, objective_str: str,
                    feature_names: List[str],
                    num_iteration: int = -1) -> Dict:
    """The model as JSON (``GBDT::DumpModel``)."""
    k = num_tree_per_iteration
    n_trees = len(models)
    if num_iteration is not None and num_iteration > 0:
        n_trees = min(n_trees, num_iteration * k)
    return {"name": "tree", "version": "v2", "num_class": num_class,
            "num_tree_per_iteration": k, "label_index": label_index,
            "max_feature_idx": max_feature_idx, "objective": objective_str,
            "feature_names": feature_names,
            "tree_info": [models[i].to_json(i) for i in range(n_trees)]}


def feature_importance(models: List[Tree], importance_type: str = "split",
                       num_features: Optional[int] = None) -> np.ndarray:
    """split count or total gain per feature
    (``GBDT::FeatureImportance``)."""
    if num_features is None:
        num_features = 0
        for t in models:
            if t.num_leaves > 1:
                num_features = max(num_features,
                                   int(t.split_feature[:t.num_leaves - 1]
                                       .max()) + 1)
    imp = np.zeros(num_features, dtype=np.float64)
    for t in models:
        n = t.num_leaves - 1
        for i in range(n):
            f = t.split_feature[i]
            if importance_type == "split":
                imp[f] += 1
            else:
                imp[f] += t.split_gain[i]
    return imp
