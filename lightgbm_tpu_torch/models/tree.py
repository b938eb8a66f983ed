"""Decision tree model object.

Capability parity with the reference's ``include/LightGBM/tree.h:20`` /
``src/io/tree.cpp``: a flat struct-of-arrays tree with per-internal-node
split feature / bin & real thresholds / gain / decision flags and per-leaf
outputs, shrinkage, and text serialization in the reference's model
format (``src/boosting/gbdt_model_text.cpp``) so that models are
interchangeable with the reference implementation.  A copy of the part of
``lightgbm_tpu/models/tree.py`` this package uses: numerical and
categorical splits (a category bitset a node), model text and the JSON
dump; prediction, and so the split decision, is on the device
(``ops/predict.py``).

Node encoding: internal nodes are numbered ``0 .. num_leaves-2``; child
pointers that are negative encode leaves as ``~leaf_index`` (two's-complement
bitwise-not), the same scheme the reference uses.

decision_type bit layout (``tree.h`` decision_type_):
  bit 0: categorical split
  bit 1: default_left (missing goes left)
  bits 2-3: missing type (0=None, 1=Zero, 2=NaN)
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

_CAT_MASK = 1
_DEFAULT_LEFT_MASK = 2


class Tree:
    """A trained decision tree (host-side numpy struct-of-arrays)."""

    def __init__(self, max_leaves: int):
        self.max_leaves = int(max_leaves)
        n_inner = max(self.max_leaves - 1, 1)
        self.num_leaves = 1
        self.num_cat = 0
        # per internal node
        self.split_feature = np.zeros(n_inner, dtype=np.int32)
        self.split_gain = np.zeros(n_inner, dtype=np.float64)
        self.threshold = np.zeros(n_inner, dtype=np.float64)   # real value
        self.threshold_bin = np.zeros(n_inner, dtype=np.int32)  # bin id
        self.decision_type = np.zeros(n_inner, dtype=np.int8)
        self.left_child = np.zeros(n_inner, dtype=np.int32)
        self.right_child = np.zeros(n_inner, dtype=np.int32)
        self.internal_value = np.zeros(n_inner, dtype=np.float64)
        self.internal_weight = np.zeros(n_inner, dtype=np.float64)
        self.internal_count = np.zeros(n_inner, dtype=np.int64)
        # per leaf
        self.leaf_value = np.zeros(self.max_leaves, dtype=np.float64)
        self.leaf_weight = np.zeros(self.max_leaves, dtype=np.float64)
        self.leaf_count = np.zeros(self.max_leaves, dtype=np.int64)
        self.leaf_parent = np.full(self.max_leaves, -1, dtype=np.int32)
        self.leaf_depth = np.zeros(self.max_leaves, dtype=np.int32)
        # categorical split storage: thresholds are bitsets of category ids;
        # node i with categorical split uses words
        # cat_threshold[cat_boundaries[k]:cat_boundaries[k+1]] where
        # k = int(threshold[i])
        self.cat_boundaries: List[int] = [0]
        self.cat_threshold: List[int] = []
        self.shrinkage = 1.0

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def split(self, leaf: int, feature: int, threshold_bin: int,
              threshold_real: float, left_value: float, right_value: float,
              left_weight: float, right_weight: float,
              left_count: int, right_count: int,
              gain: float, missing_type: int, default_left: bool) -> int:
        """Numerical split of ``leaf``; returns the new (right) leaf index.

        Mirrors ``Tree::Split`` (``src/io/tree.cpp:51``): the left child
        keeps the parent's leaf index, the right child becomes leaf
        ``num_leaves``.
        """
        new_node = self.num_leaves - 1
        new_leaf = self.num_leaves
        parent = self.leaf_parent[leaf]
        if parent >= 0:
            if self.left_child[parent] == ~leaf:
                self.left_child[parent] = new_node
            else:
                self.right_child[parent] = new_node
        self.split_feature[new_node] = feature
        self.split_gain[new_node] = gain
        self.threshold[new_node] = threshold_real
        self.threshold_bin[new_node] = threshold_bin
        dt = (missing_type << 2)
        if default_left:
            dt |= _DEFAULT_LEFT_MASK
        self.decision_type[new_node] = dt
        self.left_child[new_node] = ~leaf
        self.right_child[new_node] = ~new_leaf
        self.internal_value[new_node] = self.leaf_value[leaf]
        self.internal_weight[new_node] = left_weight + right_weight
        self.internal_count[new_node] = left_count + right_count
        depth = self.leaf_depth[leaf] + 1
        self.leaf_value[leaf] = left_value
        self.leaf_weight[leaf] = left_weight
        self.leaf_count[leaf] = left_count
        self.leaf_parent[leaf] = new_node
        self.leaf_depth[leaf] = depth
        self.leaf_value[new_leaf] = right_value
        self.leaf_weight[new_leaf] = right_weight
        self.leaf_count[new_leaf] = right_count
        self.leaf_parent[new_leaf] = new_node
        self.leaf_depth[new_leaf] = depth
        self.num_leaves += 1
        return new_leaf

    def split_categorical(self, leaf: int, feature: int, cat_bitset: List[int],
                          left_value: float, right_value: float,
                          left_weight: float, right_weight: float,
                          left_count: int, right_count: int,
                          gain: float, missing_type: int) -> int:
        """Categorical split: left iff the category is in the bitset
        (``Tree::SplitCategorical``, ``src/io/tree.cpp:72``); the node's
        threshold is its index among the tree's categorical nodes."""
        new_leaf = self.split(leaf, feature, 0, 0.0, left_value, right_value,
                              left_weight, right_weight, left_count,
                              right_count, gain, missing_type, False)
        node = self.num_leaves - 2
        self.decision_type[node] |= _CAT_MASK
        self.threshold[node] = float(self.num_cat)
        self.threshold_bin[node] = self.num_cat
        self.cat_threshold.extend(cat_bitset)
        self.cat_boundaries.append(len(self.cat_threshold))
        self.num_cat += 1
        return new_leaf

    def cat_list(self, k: int) -> List[int]:
        """The categories of categorical node ``k``'s bitset."""
        lo, hi = self.cat_boundaries[k], self.cat_boundaries[k + 1]
        return [(w - lo) * 32 + b for w in range(lo, hi) for b in range(32)
                if (self.cat_threshold[w] >> b) & 1]

    def apply_shrinkage(self, rate: float) -> None:
        self.leaf_value[:self.num_leaves] *= rate
        self.internal_value[:max(self.num_leaves - 1, 1)] *= rate
        self.shrinkage *= rate

    def add_bias(self, bias: float) -> None:
        self.leaf_value[:self.num_leaves] += bias
        self.internal_value[:max(self.num_leaves - 1, 1)] += bias

    # ------------------------------------------------------------------
    # serialization — reference text model format
    # ------------------------------------------------------------------
    def _arr_str(self, arr, n, fmt=None) -> str:
        if fmt is None:
            return " ".join(str(x) for x in arr[:n])
        return " ".join(fmt % x for x in arr[:n])

    def to_string(self, index: int) -> str:
        n_inner = self.num_leaves - 1
        lines = [f"Tree={index}",
                 f"num_leaves={self.num_leaves}",
                 f"num_cat={self.num_cat}"]
        if n_inner > 0:
            lines += [
                "split_feature=" + self._arr_str(self.split_feature, n_inner),
                "split_gain=" + self._arr_str(self.split_gain, n_inner, "%g"),
                "threshold=" + self._arr_str(self.threshold, n_inner, "%.17g"),
                "decision_type=" + self._arr_str(self.decision_type, n_inner),
                "left_child=" + self._arr_str(self.left_child, n_inner),
                "right_child=" + self._arr_str(self.right_child, n_inner),
                "leaf_value=" + self._arr_str(self.leaf_value,
                                              self.num_leaves, "%.17g"),
                "leaf_weight=" + self._arr_str(self.leaf_weight,
                                               self.num_leaves, "%g"),
                "leaf_count=" + self._arr_str(self.leaf_count,
                                              self.num_leaves),
                "internal_value=" + self._arr_str(self.internal_value,
                                                  n_inner, "%g"),
                "internal_weight=" + self._arr_str(self.internal_weight,
                                                   n_inner, "%g"),
                "internal_count=" + self._arr_str(self.internal_count,
                                                  n_inner),
            ]
            if self.num_cat > 0:
                lines += [
                    "cat_boundaries=" + " ".join(map(str, self.cat_boundaries)),
                    "cat_threshold=" + " ".join(map(str, self.cat_threshold)),
                ]
        else:
            lines += ["leaf_value=" + self._arr_str(self.leaf_value, 1,
                                                    "%.17g")]
        lines.append(f"shrinkage={self.shrinkage:g}")
        return "\n".join(lines) + "\n"

    @classmethod
    def from_string(cls, text: str) -> "Tree":
        kv: Dict[str, str] = {}
        for line in text.splitlines():
            line = line.strip()
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k] = v
        num_leaves = int(kv["num_leaves"])
        tree = cls(max(num_leaves, 2))
        tree.num_leaves = num_leaves
        tree.num_cat = int(kv.get("num_cat", "0"))
        n_inner = num_leaves - 1

        def arr(key, dtype, n):
            if key not in kv or n == 0:
                return None
            vals = np.array(kv[key].split(), dtype=np.float64)
            return vals[:n].astype(dtype)

        if n_inner > 0:
            for key, attr, dtype in [
                    ("split_feature", "split_feature", np.int32),
                    ("split_gain", "split_gain", np.float64),
                    ("threshold", "threshold", np.float64),
                    ("decision_type", "decision_type", np.int8),
                    ("left_child", "left_child", np.int32),
                    ("right_child", "right_child", np.int32),
                    ("internal_value", "internal_value", np.float64),
                    ("internal_weight", "internal_weight", np.float64),
                    ("internal_count", "internal_count", np.int64)]:
                v = arr(key, dtype, n_inner)
                if v is not None:
                    getattr(tree, attr)[:n_inner] = v
            tree.threshold_bin[:n_inner] = tree.threshold[:n_inner].astype(
                np.int32)
            for key, attr, dtype in [
                    ("leaf_value", "leaf_value", np.float64),
                    ("leaf_weight", "leaf_weight", np.float64),
                    ("leaf_count", "leaf_count", np.int64)]:
                v = arr(key, dtype, num_leaves)
                if v is not None:
                    getattr(tree, attr)[:num_leaves] = v
            if tree.num_cat > 0:
                tree.cat_boundaries = [int(x) for x in
                                       kv["cat_boundaries"].split()]
                tree.cat_threshold = [int(x) for x in
                                      kv["cat_threshold"].split()]
            # recover leaf_parent / leaf_depth from children
            tree._rebuild_parents()
        else:
            tree.leaf_value[0] = float(kv["leaf_value"].split()[0])
        tree.shrinkage = float(kv.get("shrinkage", "1"))
        return tree

    def _rebuild_parents(self) -> None:
        n_inner = self.num_leaves - 1
        depth = np.zeros(max(n_inner, 1), dtype=np.int32)
        for node in range(n_inner):
            for child in (self.left_child[node], self.right_child[node]):
                if child < 0:
                    self.leaf_parent[~child] = node
                    self.leaf_depth[~child] = depth[node] + 1
                else:
                    depth[child] = depth[node] + 1

    def to_json(self, index: int) -> Dict:
        """The tree as ``dump_model`` gives it; a categorical node's
        threshold is its category list."""
        def node_json(node: int) -> Dict:
            if node < 0:
                leaf = ~node
                return {"leaf_index": int(leaf),
                        "leaf_value": float(self.leaf_value[leaf]),
                        "leaf_weight": float(self.leaf_weight[leaf]),
                        "leaf_count": int(self.leaf_count[leaf])}
            dt = int(self.decision_type[node])
            is_cat = bool(dt & _CAT_MASK)
            return {"split_index": int(node),
                    "split_feature": int(self.split_feature[node]),
                    "split_gain": float(self.split_gain[node]),
                    "threshold": (self.cat_list(self.threshold_bin[node])
                                  if is_cat else float(self.threshold[node])),
                    "decision_type": "==" if is_cat else "<=",
                    "default_left": bool(dt & _DEFAULT_LEFT_MASK),
                    "missing_type": ["None", "Zero", "NaN"][(dt >> 2) & 3],
                    "internal_value": float(self.internal_value[node]),
                    "internal_weight": float(self.internal_weight[node]),
                    "internal_count": int(self.internal_count[node]),
                    "left_child": node_json(int(self.left_child[node])),
                    "right_child": node_json(int(self.right_child[node]))}

        structure = {"leaf_value": float(self.leaf_value[0])} \
            if self.num_leaves <= 1 else node_json(0)
        return {"tree_index": int(index), "num_leaves": int(self.num_leaves),
                "num_cat": int(self.num_cat),
                "shrinkage": float(self.shrinkage),
                "tree_structure": structure}

    def __repr__(self) -> str:
        return (f"Tree(num_leaves={self.num_leaves}, "
                f"shrinkage={self.shrinkage})")


def cat_bitset(categories) -> List[int]:
    """32-bit words with bit ``c % 32`` of word ``c // 32`` set for each
    category ``c`` (``Common::ConstructBitset``)."""
    if len(categories) == 0:
        return [0]
    words = [0] * (int(max(categories)) // 32 + 1)
    for c in categories:
        words[int(c) // 32] |= 1 << (int(c) % 32)
    return words
