"""Leaf renewal of the port (``objectives.leaf_percentiles``,
``renew_tree_output``) against the JAX package's
(``_RenewableRegression.renew_tree_output``, ``_weighted_percentile``),
``device_type=cpu`` and ``JAX_PLATFORMS=cpu``.

The renewed leaf values must equal the JAX package's bit for bit, on the
same float32 scores, leaf ids and in-bag masks: L1 and quantile
(``alpha`` 0.9 and 0.1) unweighted and with row weights, MAPE (its label
weights), with every row in bag, a bagged mask (70%) and a GOSS-like one
(the top 20% and a 10% sample of the rest; the renewal reads only
presence).  The weighted cases include weights built so that a prefix
sum lands on the threshold (integer weights: exact sums; and a run of
``float32(0.1)`` whose sequential float32 sums round away from the
pairwise ones), and tied residuals (labels and scores on a grid) with
equal and with different weights — the latter take the host's row-order
pass (``RENEW_STATS["row_order_leaves"]``), where ``np.argsort`` orders
the ties its own way.

Then training: L1 and MAPE, each with bernoulli bagging and with GOSS,
three trees on the exact loop against ``lightgbm_tpu``, held as
``tests/test_torch_objectives.py`` holds its trainings.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu.objectives as jobj  # noqa: E402
import lightgbm_tpu_torch as ltt  # noqa: E402
import lightgbm_tpu_torch.objectives as tobj  # noqa: E402
from lightgbm_tpu.config import Config as JConfig  # noqa: E402
from lightgbm_tpu_torch.config import Config as TConfig  # noqa: E402
from test_torch_objectives import _train_data, hold_to_jax  # noqa: E402

L = 31


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread, the other workers' cores left
    alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Meta:
    def __init__(self, label, weight):
        self.label = np.asarray(label, np.float32)
        self.weight = None if weight is None else \
            np.asarray(weight, np.float32)


class _Tree:
    def __init__(self, n_leaves, seed):
        self.num_leaves = n_leaves
        self.leaf_value = np.random.RandomState(seed).randn(n_leaves)


def _renew_both(name, label, weight, score, leaf, mask, alpha=0.9):
    """The two packages' renewed leaf values on the same inputs."""
    n = len(label)
    p = {"objective": name, "alpha": alpha}
    oj = jobj.create_objective(name, JConfig(p))
    oj.init(_Meta(label, weight), n)
    ot = tobj.create_objective(name, TConfig(p))
    ot.init(_Meta(label, weight), n, torch.device("cpu"))
    tj, tt = _Tree(L, 0), _Tree(L, 0)
    oj.renew_tree_output(tj, score, leaf, mask)
    ot.renew_tree_output(tt, torch.from_numpy(score), torch.from_numpy(leaf),
                         torch.from_numpy(mask))
    return tj.leaf_value, tt.leaf_value


def _inputs(seed, n, mask_kind, grid=False):
    rng = np.random.RandomState(seed)
    leaf = rng.randint(0, L - 3, n).astype(np.uint8)   # 3 leaves empty
    if grid:
        # labels and per-leaf scores on a grid: residuals tie
        label = rng.randint(0, 6, n).astype(np.float32)
        score = (np.arange(L) % 3 * 0.5).astype(np.float32)[leaf]
    else:
        label = rng.randn(n).astype(np.float32) * 2
        score = rng.randn(n).astype(np.float32)
    if mask_kind == "all":
        mask = np.ones(n, np.float32)
    elif mask_kind == "bagged":
        mask = (rng.rand(n) < 0.7).astype(np.float32)
    else:                                  # GOSS-like: presence only
        top = rng.rand(n) < 0.2
        mask = np.where(top | (rng.rand(n) < 0.1), 1.0, 0.0).astype(
            np.float32)
    return label, score, leaf, mask


MASKS = ("all", "bagged", "goss")


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("name,alpha", [("regression_l1", 0.5),
                                        ("quantile", 0.9),
                                        ("quantile", 0.1)])
def test_unweighted_renewal_is_the_reference(name, alpha, mask_kind):
    label, score, leaf, mask = _inputs(1, 6000, mask_kind)
    a, b = _renew_both(name, label, None, score, leaf, mask, alpha)
    np.testing.assert_array_equal(b, a)
    assert not np.array_equal(a, _Tree(L, 0).leaf_value)


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("name,alpha", [("regression_l1", 0.5),
                                        ("quantile", 0.9), ("mape", 0.5)])
def test_weighted_renewal_is_the_reference(name, alpha, mask_kind):
    label, score, leaf, mask = _inputs(2, 6000, mask_kind)
    if name == "mape":
        label = np.abs(label) + 0.1
    weight = np.random.RandomState(3).rand(6000) * 3
    a, b = _renew_both(name, label, None if name == "mape" else weight,
                       score, leaf, mask, alpha)
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("w", [1.0, 2.0, 0.1])
@pytest.mark.parametrize("alpha", [0.5, 0.3, 0.9])
def test_prefix_sum_at_the_threshold(w, alpha):
    """Equal weights put a prefix sum at or next to ``alpha`` times the
    total in every leaf: exactly for integer weights, and for 0.1 only in
    float32's sequential rounding."""
    label, score, leaf, mask = _inputs(4, 5000, "all")
    weight = np.full(len(label), w, np.float32)
    a, b = _renew_both("quantile", label, weight, score, leaf, mask, alpha)
    np.testing.assert_array_equal(b, a)
    if w == 0.1:
        # the sequential float32 sums are not the pairwise ones here
        seg = np.full(4096, np.float32(0.1))
        assert np.cumsum(seg)[-1] != np.float32(seg.sum(dtype=np.float32))


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("weights", ["none", "equal", "different"])
def test_tied_residuals(weights, mask_kind):
    label, score, leaf, mask = _inputs(5, 4000, mask_kind, grid=True)
    weight = {"none": None,
              "equal": np.full(len(label), 0.7, np.float32),
              "different": np.random.RandomState(6).rand(len(label))
              }[weights]
    before = dict(tobj.RENEW_STATS)
    for name, alpha in (("regression_l1", 0.5), ("quantile", 0.9)):
        a, b = _renew_both(name, label, weight, score, leaf, mask, alpha)
        np.testing.assert_array_equal(b, a)
    moved = tobj.RENEW_STATS["row_order_leaves"] - before[
        "row_order_leaves"]
    # only ties whose weights differ need the host's row order
    assert (moved > 0) == (weights == "different")
    if weights == "none":
        assert tobj.RENEW_STATS["host_rows"] == before["host_rows"]


def test_empty_and_single_row_leaves():
    label, score, leaf, mask = _inputs(7, 200, "all")
    leaf[:] = 0
    leaf[5] = 1                       # one row in leaf 1, none in 2..30
    for weight in (None, np.ones(200)):
        a, b = _renew_both("regression_l1", label, weight, score, leaf,
                           mask)
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b[2:], _Tree(L, 0).leaf_value[2:])


@pytest.mark.parametrize("sampling", ["bagging", "goss"])
@pytest.mark.parametrize("name", ["regression_l1", "mape"])
def test_sampled_training_matches_jax(name, sampling):
    X, y = _train_data("mape" if name == "mape" else "regression_l1")
    extra = {"bagging_fraction": 0.7, "bagging_freq": 1} \
        if sampling == "bagging" else {"boosting": "goss"}
    p = {"objective": name, "num_leaves": 15, "max_bin": 63, "verbose": -1,
         "metric": "None", **extra}
    bj = lgb.train(p, lgb.Dataset(X, label=y, params=p), num_boost_round=3,
                   verbose_eval=False)
    pt = dict(p, device_type="cpu")
    bt = ltt.train(pt, ltt.Dataset(X, label=y, params=pt), num_boost_round=3)
    assert hold_to_jax(bj, bt, X, y) is None
