"""The tree list at a no-split stop, held to the JAX package's
per-iteration path (``JAX_PLATFORMS=cpu``; the port with
``device_type=cpu``).

The oracle at a stop is the JAX package's per-iteration path
(``_train_one_iter_impl``, ``lightgbm_tpu/models/gbdt.py:2520-2540``): an
iteration whose every class tree is constant appends those trees, leaves
``current_iteration()`` where it was and ends training.  Every
configuration can take that path (valid sets, renewal, K > 1, DART, RF),
while the JAX package's pipelined path, its default for K = 1 without a
valid set (``_pipeline_ok``, :1163-1174), keeps one more constant tree and
one more iteration from its one-tree lag (its docstring, :2245-2252).
Without a valid set the JAX booster takes the per-iteration path here by
``booster._gbdt._pipeline_enabled = False`` on its own instance.

The matrix: a stop at iteration 0 (``min_data_in_leaf`` above the row
count, 3,000 x 6) and mid-training (a binary feature that the first tree
fits exactly at ``learning_rate`` 1; softmax: the hessians fall under
``min_sum_hessian_in_leaf``), without and with a validation set, K = 1
and softmax K = 3, DART and RF (a forest goes on past a tree that cannot
split in both packages), and the port's ``fused_iters`` 4 at pipeline
depths 0 and 1.  Model text (numeric lines within rtol 1e-5, as
``tests/test_torch_slice.py`` holds them), ``num_trees()``,
``current_iteration()`` and raw predictions (``hold_to_jax``) agree.  One
more test pins the pipelined path's difference as a counted parity note,
so that a change in either package shows.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as ltt  # noqa: E402
from test_torch_objectives import hold_to_jax  # noqa: E402

ROUNDS = 6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wide():
    """3,000 x 6 rows: more than ``min_data_in_leaf`` = 3,001 allows to
    split, so iteration 0 stops."""
    rng = np.random.RandomState(0)
    X = rng.randn(3000, 6)
    return X, X[:, 0] + 0.1 * rng.randn(3000)


def _stop_data():
    """A binary feature that separates two label values
    (``tests/test_torch_superstep.py``): at learning rate 1 the first tree
    fits them, and the second cannot split."""
    rng = np.random.RandomState(3)
    X = rng.randn(400, 6)
    X[:, 0] = rng.rand(400) > 0.5
    return X, np.where(X[:, 0] > 0, 2.0, -1.0)


def _classes():
    """Three classes named by feature 0 (feature 1 noise in one class, the
    rest constant): at learning rate 1 the softmax hessians fall under
    ``min_sum_hessian_in_leaf`` = 10 after three iterations;
    ``min_gain_to_split`` keeps the trees off splits of equal gradients,
    whose gains are rounding noise."""
    rng = np.random.RandomState(4)
    X = rng.randn(600, 6)
    X[:, 0] = rng.choice(3, 600, p=[0.2, 0.3, 0.5])
    X[:, 1] = rng.randn(600) * (X[:, 0] == 2)
    X[:, 2:] = 0.0
    return X, X[:, 0].copy()


def _wide_classes():
    X, y = _wide()
    return X, (y > 0).astype(np.float64) + (y > 1)


IT0 = {"min_data_in_leaf": 3001}
MID = {"boost_from_average": False, "learning_rate": 1.0, "num_leaves": 7}
RF = {"boosting": "rf", "bagging_freq": 1, "bagging_fraction": 0.5}
MC = {"objective": "multiclass", "num_class": 3}
# (params, data, the port's and per-iteration path's (trees, iteration))
CASES = {
    "iteration 0": ({"objective": "regression", **IT0}, _wide, (1, 0)),
    "mid-training": ({"objective": "regression", **MID}, _stop_data, (2, 1)),
    "softmax iteration 0": ({**MC, **IT0}, _wide_classes, (3, 0)),
    "softmax mid-training": ({**MC, "learning_rate": 1.0, "num_leaves": 7,
                              "min_sum_hessian_in_leaf": 10.0,
                              "min_gain_to_split": 1e-3}, _classes,
                             (12, 3)),
    "dart iteration 0": ({"objective": "regression", "boosting": "dart",
                          **IT0}, _wide, (1, 0)),
    "dart mid-training": ({"objective": "regression", "boosting": "dart",
                           **MID}, _stop_data, (2, 1)),
    "rf iteration 0": ({"objective": "regression", **RF, **IT0}, _wide,
                       (ROUNDS, ROUNDS)),
    # a leaf of equal gradients splits on rounding noise without the
    # minimum gain
    "rf mid-training": ({"objective": "regression", **RF, "num_leaves": 7,
                         "min_gain_to_split": 1e-3}, _stop_data,
                        (ROUNDS, ROUNDS)),
}


def _train(pkg, params, X, y, valid, pipelined=False):
    """``ROUNDS`` updates, or fewer to a stop; the JAX booster on its
    per-iteration path unless ``pipelined``."""
    p = {"verbose": -1, "metric": "None", "num_iterations": ROUNDS,
         **params}
    if pkg is ltt:
        p["device_type"] = "cpu"
    ds = pkg.Dataset(X, label=y, params=p)
    b = pkg.Booster(params=p, train_set=ds)
    if valid:
        b.add_valid(ds.create_valid(X[:100], label=y[:100]), "holdout")
    if pkg is lgb and not pipelined:
        b._gbdt._pipeline_enabled = False
    for _ in range(ROUNDS):
        if b.update():
            break
    return b


@pytest.mark.parametrize("valid", [False, True], ids=["alone", "valid set"])
@pytest.mark.parametrize("case", list(CASES))
def test_stop_matches_per_iteration_path(case, valid):
    params, data, (n_trees, it) = CASES[case]
    X, y = data()
    bj = _train(lgb, params, X, y, valid)
    bt = _train(ltt, params, X, y, valid)
    assert (bj.num_trees(), bj.current_iteration()) == (n_trees, it)
    assert (bt.num_trees(), bt.current_iteration()) == (n_trees, it)
    assert hold_to_jax(bj, bt, X, y) is None


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("case", ["iteration 0", "mid-training"])
def test_fused_stop_matches_per_iteration_path(case, depth):
    """``fused_iters`` 4: the block's stop tree ends training where the
    JAX per-iteration path ends it."""
    params, data, (n_trees, it) = CASES[case]
    X, y = data()
    bj = _train(lgb, params, X, y, False)
    bt = _train(ltt, dict(params, fused_iters=4,
                          superstep_pipeline_depth=depth), X, y, False)
    g = bt._gbdt
    assert g._stop_flag and g.block_sizes[-1] == (1 if it == 0 else 4)
    assert (bt.num_trees(), bt.current_iteration()) == (n_trees, it)
    assert hold_to_jax(bj, bt, X, y) is None


@pytest.mark.parametrize("case,pipelined", [("iteration 0", (2, 2)),
                                            ("mid-training", (3, 3))])
def test_pipelined_path_note(case, pipelined):
    """Parity note: the JAX package's default pipelined path ends a stop
    with one more constant tree and iteration than its per-iteration path
    and the port; the trees before them and the predictions agree."""
    params, data, port = CASES[case]
    X, y = data()
    bj = _train(lgb, params, X, y, False, pipelined=True)
    bt = _train(ltt, params, X, y, False)
    assert (bj.num_trees(), bj.current_iteration()) == pipelined
    assert (bt.num_trees(), bt.current_iteration()) == port
    extra = bj._gbdt.models[-1]
    assert extra.num_leaves == 1 and extra.leaf_value[0] == 0.0
    np.testing.assert_allclose(
        bt.predict(X, raw_score=True),
        bj.predict(X, raw_score=True, predict_engine=False), rtol=0,
        atol=1e-5)
