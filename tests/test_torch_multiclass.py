"""Multiclass training of the port (softmax and one-vs-all, K trees an
iteration; ``device_type=cpu``) against the JAX package
(``JAX_PLATFORMS=cpu``).

Data: 4,000 rows, 4 classes (``argmax`` of the first four features plus
noise), 10% NaN in one feature; 8 features, 15 leaves, 3 iterations (12
trees).  Float coarse-to-fine waves, whose JAX compile dominates, are in
``tests/test_torch_multiclass_c2f.py``.

The contract, and why:

- trees, model text and predictions ((rows, K)) as
  ``tests/test_torch_objectives.py`` holds its trainings: identical
  trees, the model text's numeric lines within rtol 1e-5 plus 1e-6 of a
  scale, raw and converted predictions within 1e-4 of a class's reach
  (``pred_atol``), or a near tie at the first differing split.  The
  scale is the row count times the largest unshrunk leaf output (at
  least 1): a split gain's float32 error is about twice the leaf output
  times its gradient sum's, and one-vs-all's small hessians give outputs
  near 4, gains near 400 and gain differences up to 0.01.  The leaf
  values are quotients of gradient sums the JAX package rounds in
  float32: up to rel 3.6e-5 apart in small coarse-to-fine leaves, the
  predictions up to 4.3e-5.  Loops: the exact loop, float waves,
  quantized two-column waves and the exact loop with
  ``feature_fraction=0.7`` and bernoulli bagging (each class
  tree draws its own feature mask and quantization tree id in tree
  order; the iteration's bagging draw is shared by its K trees).  On
  these data one cell meets a near tie: one-vs-all with feature fraction
  and bagging, at the last tree's eleventh split;
- the gradients of an iteration are those of its starting score: a port
  that recomputes them before each class tree (so class k sees classes
  0..k-1's updates) fails the same comparison (``_per_tree_gradients``);
- ``num_iteration`` counts iterations of K trees in ``predict`` and in
  the model text; a loaded model keeps ``num_class`` and
  ``num_tree_per_iteration`` and predicts the same bits;
- validation sets: ``multi_logloss`` and ``multi_error`` every iteration
  within 1e-6 of the JAX package's, early stopping at the same iteration
  (``best_iteration`` counts iterations), each valid score within 1e-6
  of the port's prediction of its trees (float32 leaf values added into
  float64, as ``tests/test_torch_valid.py`` states);
- ``rollback_one_iter`` pops K trees: the training score is then the
  bits of a booster that trained one iteration fewer, the valid score its
  prediction, and training on gives the uninterrupted booster's model;
- stratified ``cv`` on the four labels: the JAX package's folds, and each
  metric's mean and deviation within 1e-6 of its;
- K > 1 trains under GOSS, MVS, DART and random forests: K trees an
  iteration, and the training score within 1e-5 of the trees' prediction
  (a forest's averaged).  Their contracts against the JAX package are in
  ``tests/test_torch_multiclass_sampled.py`` (GOSS, MVS) and
  ``tests/test_torch_multiclass_dart_rf.py`` (DART, random forests).

``tests/test_torch_multiclass_card.py`` holds the card's graphed
multiclass training to its eager launches and to the CPU.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as ltt  # noqa: E402
from lightgbm_tpu_torch.models.gbdt import GBDT  # noqa: E402
from test_torch_objectives import (first_difference, hold_to_jax,  # noqa
                                   pred_atol)

K = 4
ROUNDS = 3
PRED_ATOL = 1e-4
METRIC_ATOL = 1e-6
CONFIGS = {
    "exact": {},
    "float waves": {"wave_splits": True, "hist_refinement": False},
    "quantized two-column waves": {"wave_splits": True,
                                   "use_quantized_grad": True,
                                   "min_data_in_leaf": 0,
                                   "hist_refinement": False},
    "exact, feature fraction and bagging": {"feature_fraction": 0.7,
                                            "bagging_fraction": 0.8,
                                            "bagging_freq": 1},
}
NEAR_TIES = {("multiclassova", "exact, feature fraction and bagging"):
             (11, 10)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread, the other workers' cores left
    alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=4000, F=8, seed=11):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n) < 0.1, 1] = np.nan
    y = np.argmax(np.nan_to_num(X[:, :K]) + 0.5 * rng.randn(n, K), 1)
    return X, y.astype(float)


def _params(objective, extra=()):
    return {"objective": objective, "num_class": K, "num_leaves": 15,
            "max_bin": 63, "verbose": -1, "metric": "None", **dict(extra)}


def _gain_scale(bj, n, lr=0.1):
    """The row count times the largest unshrunk leaf output, at least 1."""
    out = max(np.abs(t.leaf_value[:t.num_leaves]).max()
              for t in bj._gbdt.models) / lr
    return n * max(1.0, out)


def _train_both(p, X, y, rounds=ROUNDS):
    bj = lgb.train(p, lgb.Dataset(X, label=y, params=p),
                   num_boost_round=rounds, verbose_eval=False)
    pt = dict(p, device_type="cpu")
    bt = ltt.train(pt, ltt.Dataset(X, label=y, params=pt),
                   num_boost_round=rounds)
    return bj, bt


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_trees_match_jax(objective, config):
    hold_config(objective, config, CONFIGS[config], 8, 0)


def hold_config(objective, config, extra, F, refine_shift):
    """Train both packages on one loop and hold the port to the JAX
    package (the module docstring's first contract)."""
    X, y = _data(F=F)
    p = _params(objective, extra)
    bj, bt = _train_both(p, X, y)
    assert bt.num_trees() == ROUNDS * K
    assert bt._gbdt.grow_params.refine_shift == refine_shift
    diff = hold_to_jax(bj, bt, X, y, _gain_scale(bj, len(y)), PRED_ATOL)
    assert diff == NEAR_TIES.get((objective, config))
    if diff is None:
        pj = bj.predict(X, predict_engine=False)
        pt = bt.predict(X)
        assert pt.shape == (len(y), K)
        np.testing.assert_allclose(pt, pj, rtol=0, atol=pred_atol(
            bj._gbdt.models, K, PRED_ATOL))
        if objective == "multiclass":
            np.testing.assert_allclose(pt.sum(axis=1), 1.0, rtol=1e-12)


def _per_tree_gradients(self, k=0):
    """The wrong order: every class tree's gradients from the score as
    the earlier class trees of its iteration left it."""
    g, h = self._gradients()
    self._grad_all.copy_(g)
    self._hess_all.copy_(h)
    return _TREE_HEAD(self, k)


_TREE_HEAD = GBDT._tree_head


def test_gradients_of_the_iteration_start(monkeypatch):
    X, y = _data()
    p = _params("multiclass")
    bj, bt = _train_both(p, X, y)
    assert first_difference(bj._gbdt.models, bt.models) is None
    monkeypatch.setattr(GBDT, "_tree_head", _per_tree_gradients)
    pt = dict(p, device_type="cpu")
    wrong = ltt.train(pt, ltt.Dataset(X, label=y, params=pt),
                      num_boost_round=ROUNDS)
    # the first tree of every iteration still agrees; class 1 of the
    # first iteration already trains on other gradients
    diff = first_difference(bj._gbdt.models, wrong.models)
    assert diff is not None and diff[0] == 1


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_num_iteration_model_text_and_load(objective):
    X, y = _data()
    p = _params(objective)
    bj, bt = _train_both(p, X, y, rounds=4)
    for ni in (1, 2, None):
        kw = {} if ni is None else {"num_iteration": ni}
        np.testing.assert_allclose(
            bt.predict(X, raw_score=True, **kw),
            bj.predict(X, raw_score=True, predict_engine=False, **kw),
            rtol=0, atol=pred_atol(bj._gbdt.models, K, PRED_ATOL))
    text = bt.model_to_string(num_iteration=2)
    lines = text.splitlines()
    assert f"num_class={K}" in lines and \
        f"num_tree_per_iteration={K}" in lines
    assert f"objective={objective} num_class:{K}" in lines
    assert sum(line.startswith("Tree=") for line in lines) == 2 * K
    loaded = ltt.Booster(model_str=bt.model_to_string(),
                         params={"device_type": "cpu"})
    assert loaded.num_class == loaded.num_tree_per_iteration == K
    assert loaded.model_to_string() == bt.model_to_string()
    np.testing.assert_array_equal(loaded.predict(X), bt.predict(X))
    np.testing.assert_array_equal(loaded.predict(X, num_iteration=1),
                                  bt.predict(X, num_iteration=1))
    # and the JAX package reads the port's model text
    jl = lgb.Booster(model_str=bt.model_to_string())
    np.testing.assert_allclose(jl.predict(X, predict_engine=False),
                               bt.predict(X), rtol=0, atol=1e-12)


def test_valid_sets_and_early_stopping():
    X, y = _data(6000)
    Xv, yv = X[4000:], y[4000:]
    X, y = X[:4000], y[:4000]
    p = dict(_params("multiclass"), metric="multi_logloss,multi_error",
             learning_rate=0.5)
    res = {}
    out = {}
    for pkg in (lgb, ltt):
        pp = dict(p, device_type="cpu") if pkg is ltt else p
        ds = pkg.Dataset(X, label=y, params=pp)
        r = res[pkg] = {}
        kw = {"verbose_eval": False}
        out[pkg] = pkg.train(pp, ds, num_boost_round=40,
                             valid_sets=[ds.create_valid(Xv, label=yv)],
                             valid_names=["v"], evals_result=r,
                             early_stopping_rounds=3, **kw)
    bj, bt = out[lgb], out[ltt]
    assert first_difference(bj._gbdt.models, bt.models) is None
    # it stopped early, at the same iteration
    assert 0 < bt.best_iteration == bj.best_iteration
    n_it = len(res[ltt]["v"]["multi_logloss"])
    assert n_it < 40 and n_it == len(res[lgb]["v"]["multi_logloss"])
    assert bt.num_trees() == n_it * K
    for m in ("multi_logloss", "multi_error"):
        np.testing.assert_allclose(res[ltt]["v"][m], res[lgb]["v"][m],
                                   rtol=0, atol=METRIC_ATOL)
    g = bt._gbdt
    score = g.valid_sets[0].score
    assert score.shape == (K, len(yv)) and score.dtype == torch.float64
    np.testing.assert_allclose(score.numpy().T,
                               bt.predict(Xv, raw_score=True,
                                          num_iteration=n_it),
                               rtol=0, atol=1e-6)
    # the default predict takes the best iteration's trees
    np.testing.assert_array_equal(
        bt.predict(Xv), bt.predict(Xv, num_iteration=bt.best_iteration))
    assert sum(line.startswith("Tree=") for line in
               bt.model_to_string().splitlines()) == bt.best_iteration * K


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_rollback_pops_an_iteration(objective):
    X, y = _data(3000)
    Xv, yv = X[2000:], y[2000:]
    X, y = X[:2000], y[:2000]
    p = dict(_params(objective), device_type="cpu")

    def booster(n):
        ds = ltt.Dataset(X, label=y, params=p)
        b = ltt.Booster(params=p, train_set=ds)
        b.add_valid(ds.create_valid(Xv, label=yv), "v")
        for _ in range(n):
            b.update()
        return b

    full, short, b = booster(3), booster(2), booster(3)
    b.rollback_one_iter()
    assert b.num_trees() == 2 * K and b.current_iteration() == 2
    np.testing.assert_array_equal(b._gbdt.train_score(),
                                  short._gbdt.train_score())
    np.testing.assert_allclose(b._gbdt.valid_sets[0].score.numpy().T,
                               b.predict(Xv, raw_score=True), rtol=0,
                               atol=1e-6)
    b.update()
    assert b.model_to_string() == full.model_to_string()
    np.testing.assert_array_equal(b._gbdt.train_score(),
                                  full._gbdt.train_score())


def test_stratified_cv_matches_jax():
    from lightgbm_tpu import engine as je
    from lightgbm_tpu_torch import engine as te
    X, y = _data(6000)          # folds of 4000 training rows
    folds_j = je._make_folds(lgb.Dataset(X, label=y), 3, True, True, 3)
    folds_t = te._make_folds(ltt.Dataset(X, label=y,
                                         params={"device_type": "cpu"}),
                             3, True, True, 3)
    for (tr_a, te_a), (tr_b, te_b) in zip(folds_j, folds_t):
        np.testing.assert_array_equal(tr_a, tr_b)
        np.testing.assert_array_equal(te_a, te_b)
        # every class in each fold at its share
        counts = np.bincount(y[te_b].astype(int), minlength=K)
        share = np.bincount(y.astype(int), minlength=K) / 3
        assert np.all(np.abs(counts - share) <= 1)
    p = dict(_params("multiclass"), metric="multi_logloss,multi_error")
    out = {}
    for pkg in (lgb, ltt):
        pp = dict(p, device_type="cpu") if pkg is ltt else p
        out[pkg] = pkg.cv(pp, pkg.Dataset(X, label=y, params=pp),
                          num_boost_round=4, nfold=3, stratified=True,
                          shuffle=True, seed=3)
    assert sorted(out[ltt]) == sorted(out[lgb])
    for k, v in out[lgb].items():
        np.testing.assert_allclose(out[ltt][k], v, rtol=0, atol=METRIC_ATOL)


@pytest.mark.parametrize("boosting", [
    {"boosting": "goss"}, {"boosting": "mvs", "bagging_fraction": 0.5},
    {"boosting": "dart"},
    {"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1}])
@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_single_tree_boosting_refuses_classes(objective, boosting):
    """Once refused (hence the name), these boosting modes now train K
    trees an iteration."""
    X, y = _data(500)
    p = dict(_params(objective), device_type="cpu", **boosting)
    b = ltt.train(p, ltt.Dataset(X, label=y, params=p), num_boost_round=2)
    assert b.num_trees() == 2 * K and b.num_tree_per_iteration == K
    pred = b.predict(X, raw_score=True)
    assert pred.shape == (len(y), K) and np.isfinite(pred).all()
    np.testing.assert_allclose(b._gbdt.train_score().T, pred, rtol=0,
                               atol=1e-5)
