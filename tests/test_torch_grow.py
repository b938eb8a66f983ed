"""One tree: the JAX growth loop vs the PyTorch port's, on the CPU.

``lightgbm_tpu.ops.grow.build_tree_impl`` runs its serial learner with
the histogram pool, no speculation, the XLA split scan and the segsum
histogram — the non-speculative path this slice ports — and
``lightgbm_tpu_torch.ops.grow.build_tree`` runs the port on the same
binned matrix and gradients (numpy, fixed seeds).

Tolerances, and why: split records (leaf, feature, threshold,
default_left, left_mask, valid) and the final leaf assignment must be
identical.  Gains, child stats and leaf values agree within rtol 1e-5
plus an absolute term of 1e-6 times the root's sum of |value| (for a
leaf value -G/H, that term over the leaf's H): the port sums histograms
in float64 and rounds once, the reference in float32, and a child taken
as parent minus sibling carries the parent's rounding.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from lightgbm_tpu.config import Config as JConfig  # noqa: E402
from lightgbm_tpu.io.dataset import TpuDataset  # noqa: E402
from lightgbm_tpu.ops.grow import GrowParams as JGrowParams  # noqa: E402
from lightgbm_tpu.ops.grow import build_tree_impl  # noqa: E402
from lightgbm_tpu.ops.grow import route_rows as j_route_rows  # noqa: E402
from lightgbm_tpu.ops.split import SplitParams as JSplitParams  # noqa: E402
from lightgbm_tpu_torch.config import Config  # noqa: E402
from lightgbm_tpu_torch.io.dataset import TorchDataset  # noqa: E402
from lightgbm_tpu_torch.ops.grow import GrowParams, build_tree  # noqa: E402
from lightgbm_tpu_torch.ops.route import route_rows  # noqa: E402
from lightgbm_tpu_torch.ops.split import SplitParams  # noqa: E402

RTOL = 1e-5
ATOL_OF_ROOT = 1e-6

# (name, nan rows, num_leaves, max_depth, min_data_in_leaf, lambda_l2,
#  feature fraction mask)
CASES = [
    ("dense", False, 15, -1, 20, 0.0, False),
    ("nan", True, 15, -1, 20, 0.0, False),
    ("depth_l2_mask", True, 15, 3, 5, 1.0, True),
    ("depth_2", False, 15, 2, 20, 0.0, False),
]


def _inputs(seed, nan, n=4000, F=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    if nan:
        X[rng.rand(n) < 0.15, 1] = np.nan
        X[rng.rand(n) < 0.05, 4] = np.nan
    Xn = np.nan_to_num(X)
    z = Xn[:, 0] - 0.7 * Xn[:, 1] * Xn[:, 2] + 0.2 * rng.randn(n)
    p = 1.0 / (1.0 + np.exp(-z))
    grad = (p - (rng.rand(n) < p)).astype(np.float32)
    hess = (p * (1 - p)).astype(np.float32)
    return X, grad, hess


def _close(a, b, atol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.all(np.abs(a - b) <= RTOL * np.abs(a) + atol), \
        np.max(np.abs(a - b))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_build_tree_matches_build_tree_impl(case):
    name, nan, L, max_depth, md, l2, use_fmask = case
    X, grad, hess = _inputs(CASES.index(case) + 1, nan)
    params = {"max_bin": 63}
    ds = TpuDataset.from_raw(X, np.zeros(len(X)), JConfig(params))
    tds = TorchDataset.from_raw(X, np.zeros(len(X)), Config(params),
                                torch.device("cpu"))
    mappers = [ds.mappers[i] for i in ds.used_features]
    F = len(mappers)
    B = int(2 ** np.ceil(np.log2(max(ds.max_bin_count, 2))))
    nb = np.asarray([m.num_bin for m in mappers], np.int32)
    mt = np.asarray([m.missing_type for m in mappers], np.int32)
    fmask = np.ones(F, bool)
    if use_fmask:
        fmask[2] = False
    mask = np.ones(len(X), np.float32)
    any_missing = bool(np.any(mt != 0))
    skw = dict(max_bin=B, min_data_in_leaf=md, lambda_l2=l2,
               min_sum_hessian_in_leaf=1e-3, any_missing=any_missing)
    jp = JGrowParams(split=JSplitParams(any_cat=False, **skw), num_leaves=L,
                     max_depth=max_depth, hist_impl="segsum",
                     use_hist_pool=True, speculate=0, split_kernel="xla")
    ref = build_tree_impl(jnp.asarray(ds.binned.T), jnp.asarray(grad),
                          jnp.asarray(hess), jnp.asarray(mask),
                          jnp.asarray(fmask), jnp.asarray(nb),
                          jnp.asarray(mt), jnp.zeros(F, bool), jp)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    tp = GrowParams(split=SplitParams(**skw), num_leaves=L,
                    max_depth=max_depth)
    t = lambda a: torch.from_numpy(np.array(a))
    got = build_tree(tds.binned, t(grad), t(hess), t(mask), t(fmask), t(nb),
                     t(mt), tp)
    got = {k: v.numpy() for k, v in got.items()}

    valid = ref["valid"]
    np.testing.assert_array_equal(got["valid"], valid)
    n_leaves = int(ref["n_leaves"])
    assert n_leaves == (L if max_depth <= 0 else min(L, 2 ** max_depth))
    assert int(got["n_leaves"]) == int(ref["n_leaves"])
    for k in ("leaf", "feature", "threshold", "default_left"):
        np.testing.assert_array_equal(got[k][valid], ref[k][valid], k)
    np.testing.assert_array_equal(got["left_mask"][valid],
                                  ref["left_mask"][valid])
    np.testing.assert_array_equal(got["leaf_idx"].astype(np.int64),
                                  ref["leaf_idx"].astype(np.int64))
    root = np.array([np.abs(grad).sum(), hess.sum(), len(X)])
    for k in ("left_stats", "right_stats", "leaf_stats"):
        _close(got[k], ref[k], ATOL_OF_ROOT * root)
    # gain = child gains - parent gain: the subtraction cancels, so the
    # absolute term scales with the root's gain terms
    _close(got["gain"], ref["gain"], ATOL_OF_ROOT * root[0] ** 2 / root[1])
    # a leaf value is -G / (H + l2): the sum error divides by the leaf's H
    h_leaf = np.maximum(ref["leaf_stats"][:, 1], 1e-3) + l2
    for k in ("leaf_values", "leaf_values_final"):
        _close(got[k], ref[k], ATOL_OF_ROOT * root[0] / h_leaf)

    # replaying the records over the matrix gives the same assignment
    li = route_rows(tds.binned, t(ref["leaf"]), t(ref["feature"]),
                    t(ref["left_mask"]), t(ref["valid"]), L)
    ref_li = j_route_rows(jnp.asarray(ds.binned.T), jnp.asarray(ref["leaf"]),
                          jnp.asarray(ref["feature"]),
                          jnp.asarray(ref["left_mask"]),
                          jnp.asarray(ref["valid"]), L)
    np.testing.assert_array_equal(li.numpy(), np.asarray(ref_li))
    np.testing.assert_array_equal(li.numpy(), got["leaf_idx"].astype(np.int32))
