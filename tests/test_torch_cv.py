"""``cv`` and ``learning_rates`` schedules of the port
(``device_type=cpu``) against the JAX package (``JAX_PLATFORMS=cpu``), and
the schedule's fused super-step against the per-iteration path.

The contract, and why:

- ``cv`` (3 folds, 8 rounds, ``metric=auc,binary_logloss``): every
  fold's rows equal the JAX package's (``_make_folds``: stratified or
  not, shuffled or not), and each metric's mean and standard deviation
  over the folds within 1e-6 of the JAX package's, stratified and
  shuffled, and shuffled alone;
- a ``learning_rates`` schedule (or the ``reset_parameter`` callback) at
  ``fused_iters=4``: the same trees and training score, bit for bit, as
  ``fused_iters=1``.  The rate is a device scalar written before each
  block and each block records the rate it was built at; a block served
  at a rate other than its own is rewound.  Without that rewind a
  block's later trees would be built at its dispatch's rate, so this
  test fails without it, on the CPU too;
- the schedule's trees against the JAX package's: identical splits,
  the same shrinkage per tree, raw predictions within 1e-5 (the
  prediction contract of ``tests/test_torch_slice.py``).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as ltt  # noqa: E402

ROUNDS = 10
METRIC_ATOL = 1e-6
SCORE_ATOL = 1e-5
BASE = {"objective": "binary", "verbose": -1, "num_leaves": 15,
        "max_bin": 63}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread, the other workers' cores left
    alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n, F, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n) < 0.1, 3] = np.nan
    z = X[:, 0] + 0.5 * np.nan_to_num(X[:, 1]) - 0.4 * X[:, 2] * X[:, 4]
    y = (z + 0.8 * rng.randn(n) > 0).astype(np.float64)
    return X, y


DATA = _data(2000, 8, 0)


LRS = [0.1 * 0.85 ** i for i in range(ROUNDS)]


def _lr_train(pkg, fused, depth=0, callbacks=None, **kw):
    X, y = DATA
    p = dict(BASE, metric="None")
    if pkg is ltt:
        p.update(device_type="cpu", fused_iters=fused,
                 superstep_pipeline_depth=depth)
    return pkg.train(p, pkg.Dataset(X, label=y, params=p),
                     num_boost_round=ROUNDS, verbose_eval=False,
                     callbacks=callbacks, **kw)


@pytest.mark.parametrize("how", ["learning_rates, depth 0",
                                 "learning_rates, depth 1",
                                 "reset_parameter callback, depth 1"])
def test_learning_rates_fused_same_bits(how):
    """A per-iteration rate schedule at fused_iters=4: each block's trees
    after the first were built at its dispatch's rate, so the block is
    rewound at the next rate; the same bits as fused_iters=1.  Through
    engine.train's learning_rates the pipeline depth drops to 0; through
    the raw callback a block dispatched ahead is dropped instead."""
    depth = int(how[-1])
    if how.startswith("reset"):
        kw = dict(callbacks=[ltt.reset_parameter(learning_rate=LRS)])
    else:
        kw = dict(learning_rates=LRS)
    one = _lr_train(ltt, 1, **kw)
    four = _lr_train(ltt, 4, depth, **kw)
    assert one.model_to_string() == four.model_to_string()
    np.testing.assert_array_equal(one._gbdt.train_score(),
                                  four._gbdt.train_score())
    assert [t.shrinkage for t in four.models] == \
        pytest.approx(LRS, rel=1e-15)
    assert four._gbdt.block_sizes[:2] == [1, 4]


def test_learning_rates_trees_match_jax():
    bj = _lr_train(lgb, 1, learning_rates=LRS)
    bt = _lr_train(ltt, 4, learning_rates=LRS)
    X = DATA[0]
    for a, b in zip(bj._gbdt.models, bt.models):
        n = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves
        for k in ("split_feature", "threshold_bin", "left_child",
                  "right_child"):
            np.testing.assert_array_equal(getattr(a, k)[:n],
                                          getattr(b, k)[:n], k)
        assert a.shrinkage == pytest.approx(b.shrinkage, rel=1e-15)
    np.testing.assert_allclose(
        bt.predict(X, raw_score=True),
        bj.predict(X, raw_score=True, predict_engine=False), rtol=0,
        atol=SCORE_ATOL)


@pytest.mark.parametrize("stratified", [True, False],
                         ids=["stratified", "plain"])
def test_cv_matches_jax(stratified):
    X, y = _data(3000, 8, 0)
    p = dict(BASE, metric="auc,binary_logloss")
    out = {}
    for pkg in (lgb, ltt):
        pp = dict(p, device_type="cpu") if pkg is ltt else p
        out[pkg] = pkg.cv(pp, pkg.Dataset(X, label=y, params=pp),
                          num_boost_round=8, nfold=3, stratified=stratified,
                          shuffle=True, seed=3)
    assert sorted(out[ltt]) == sorted(out[lgb]) == [
        "valid auc-mean", "valid auc-stdv", "valid binary_logloss-mean",
        "valid binary_logloss-stdv"]
    for k, v in out[lgb].items():
        assert len(out[ltt][k]) == len(v) == 8
        np.testing.assert_allclose(out[ltt][k], v, rtol=0, atol=METRIC_ATOL)


def test_make_folds_match_jax():
    from lightgbm_tpu import engine as je
    from lightgbm_tpu_torch import engine as te
    X, y = _data(700, 5, 2)
    for strat in (True, False):
        for shuffle in (True, False):
            a = je._make_folds(lgb.Dataset(X, label=y), 4, strat, shuffle, 7)
            b = te._make_folds(ltt.Dataset(X, label=y,
                                           params={"device_type": "cpu"}),
                               4, strat, shuffle, 7)
            for (tr_a, te_a), (tr_b, te_b) in zip(a, b):
                np.testing.assert_array_equal(tr_a, tr_b)
                np.testing.assert_array_equal(te_a, te_b)
