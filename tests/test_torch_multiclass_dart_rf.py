"""DART and random forests at K > 1 classes (softmax and one-vs-all) of
the port against the JAX package, on the CPU (``JAX_PLATFORMS=cpu``).

Data are ``tests/test_torch_multiclass.py``'s (4 classes, 8 features, 15
leaves), 4,000 training rows and the next 1,000 as a validation set.
DART in its three modes (weighted drops, the default, with
``skip_drop=0``; ``xgboost_dart_mode``; ``uniform_drop`` with
``max_drop=2``), each at ``drop_rate=0.3``, and a random forest
(``bagging_fraction=0.632``, ``bagging_freq=1``, ``feature_fraction=0.8``)
train through ``train`` with the validation set,
``metric=multi_logloss,multi_error`` and ``early_stopping_rounds=2``.
The contract, and why:

- a drop index names an iteration, whose K trees leave and re-enter
  their classes' rows: both packages drop the same iterations at every
  iteration (a numpy ``RandomState`` of ``drop_seed`` on both sides);
- identical trees, model text and predictions within ``pred_atol`` (the
  contract of ``tests/test_torch_multiclass.py``), or a near tie at the
  first differing split, named in ``NEAR_TIES``: on these data the
  softmax forest meets one at tree 17's thirteenth split (adjacent
  thresholds, gains 4.9618969 and 4.9618988: a forest's gradients take
  two values a class, so its bins' sums tie often);
- the validation metrics within 1e-6 of the JAX package's at every
  iteration before a near tie's, the same number of iterations evaluated
  and the same ``best_iteration`` (which counts iterations of K trees),
  and the
  validation score within 1e-6 of the port's own prediction of its trees
  (float32 leaf values added into float64; a forest's averaged);
- ``rollback_one_iter`` pops an iteration's K trees: the training and
  validation scores are then the bits of a booster that trained one
  iteration fewer, its predictions within 1e-9 of that booster's (DART's
  dropped trees are scaled and unscaled in float64), and the training
  score within ``pred_atol`` of the JAX package's after its rollback;
- model text: ``num_tree_per_iteration = K`` (and ``average_output`` for
  a forest, whose raw score of a class is the mean of its trees); a model
  read back predicts the port's bits, and the JAX package reads the same
  text and predicts within 1e-12;
- stratified ``cv``: each metric's mean and deviation within 1e-6 of the
  JAX package's.

The card's graphed runs of these boosters are held to their eager
launches in ``tests/test_torch_multiclass_card.py``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as ltt  # noqa: E402
from test_torch_multiclass import (K, METRIC_ATOL, PRED_ATOL,  # noqa: E402
                                   _data, _gain_scale, _params)
from test_torch_objectives import hold_to_jax, pred_atol  # noqa: E402

ROUNDS = 6
DART = {"boosting": "dart", "drop_rate": 0.3}
MODES = {
    "dart": dict(DART, skip_drop=0.0),
    "dart xgboost": dict(DART, xgboost_dart_mode=True, skip_drop=0.2),
    "dart uniform": dict(DART, uniform_drop=True, max_drop=2,
                         skip_drop=0.2),
    "rf": {"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
           "feature_fraction": 0.8},
}
METRICS = ("multi_logloss", "multi_error")
# (mode, objective) -> (tree, split) of the first differing split
NEAR_TIES = {("rf", "multiclass"): (17, 12)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _split():
    X, y = _data(5000)
    return X[:4000], y[:4000], X[4000:], y[4000:]


def _p(mode, objective, **kw):
    return _params(objective, {**MODES[mode], "learning_rate": 0.3,
                               "metric": ",".join(METRICS), **kw})


def _train(pkg, p, X, y, Xv, yv, drops):
    """``pkg.train`` with the validation set and early stopping; each
    iteration's drops appended to ``drops`` (DART)."""
    pp = dict(p, device_type="cpu") if pkg is ltt else p
    ds = pkg.Dataset(X, label=y, params=pp)
    res = {}

    def record(env):
        g = env.model._gbdt
        if hasattr(g, "_drop_index"):
            drops.append(list(g._drop_index))
    kw = {"verbose_eval": False} if pkg is lgb else {}
    b = pkg.train(pp, ds, num_boost_round=ROUNDS,
                  valid_sets=[ds.create_valid(Xv, label=yv)],
                  valid_names=["v"], evals_result=res,
                  early_stopping_rounds=2, callbacks=[record], **kw)
    return b, res


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
@pytest.mark.parametrize("mode", list(MODES))
def test_trains_as_the_jax_package(mode, objective):
    X, y, Xv, yv = _split()
    p = _p(mode, objective)
    drops_j, drops_t = [], []
    bj, rj = _train(lgb, p, X, y, Xv, yv, drops_j)
    bt, rt = _train(ltt, p, X, y, Xv, yv, drops_t)
    assert drops_t == drops_j
    if mode != "rf":
        assert any(drops_t)
    n_it = len(rt["v"]["multi_logloss"])
    assert n_it == len(rj["v"]["multi_logloss"])
    assert bt.best_iteration == bj.best_iteration
    assert bt.num_trees() == n_it * K
    lr = 1.0 if mode == "rf" else 0.3
    tie = NEAR_TIES.get((mode, objective))
    assert hold_to_jax(bj, bt, X, y, _gain_scale(bj, len(y), lr=lr),
                       PRED_ATOL) == tie
    held = n_it if tie is None else tie[0] // K
    for m in METRICS:
        np.testing.assert_allclose(rt["v"][m][:held], rj["v"][m][:held],
                                   rtol=0, atol=METRIC_ATOL)
    g = bt._gbdt
    score = g.valid_sets[0].score
    assert score.shape == (K, len(yv)) and score.dtype == torch.float64
    np.testing.assert_allclose(
        score.numpy().T, bt.predict(Xv, raw_score=True, num_iteration=n_it),
        rtol=0, atol=1e-6)


def _booster(p, X, y, Xv, yv, n):
    pp = dict(p, device_type="cpu")
    ds = ltt.Dataset(X, label=y, params=pp)
    b = ltt.Booster(params=pp, train_set=ds)
    b.add_valid(ds.create_valid(Xv, label=yv), "v")
    for _ in range(n):
        b.update()
    return b


@pytest.mark.parametrize("mode", ["dart", "rf"])
def test_rollback_pops_an_iteration(mode):
    X, y, Xv, yv = _split()
    p = _p(mode, "multiclass")
    short, b = (_booster(p, X, y, Xv, yv, n) for n in (3, 4))
    if mode == "dart":
        assert b._gbdt._dart_undo[3], "the last iteration dropped none"
    b.rollback_one_iter()
    assert b.num_trees() == 3 * K and b.current_iteration() == 3
    np.testing.assert_array_equal(b._gbdt.train_score(),
                                  short._gbdt.train_score())
    assert torch.equal(b._gbdt.valid_sets[0].score,
                       short._gbdt.valid_sets[0].score)
    np.testing.assert_allclose(b.predict(Xv, raw_score=True),
                               short.predict(Xv, raw_score=True), rtol=0,
                               atol=1e-9)
    bj = lgb.Booster(params=p, train_set=lgb.Dataset(X, label=y, params=p))
    bj.add_valid(lgb.Dataset(Xv, label=yv, reference=bj.train_set), "v")
    for _ in range(4):
        bj.update()
    bj.rollback_one_iter()
    np.testing.assert_allclose(b._gbdt.train_score(),
                               np.asarray(bj._gbdt.train_score), rtol=0,
                               atol=pred_atol(bj._gbdt.models, K, PRED_ATOL))
    if mode == "dart":
        assert len(b._gbdt._train_leaf_idx) == 3 * K
        assert len(b._gbdt.valid_sets[0].leaf_idx_per_tree) == 3 * K


@pytest.mark.parametrize("mode", ["dart", "rf"])
def test_model_text_round_trip(mode):
    X, y, Xv, yv = _split()
    p = _p(mode, "multiclassova")
    b = _booster(p, X, y, Xv, yv, 3)
    text = b.model_to_string()
    lines = text.splitlines()
    assert f"num_tree_per_iteration={K}" in lines
    assert ("average_output" in lines) == (mode == "rf")
    loaded = ltt.Booster(model_str=text, params={"device_type": "cpu"})
    assert loaded.average_output == (mode == "rf")
    np.testing.assert_array_equal(loaded.predict(Xv), b.predict(Xv))
    np.testing.assert_array_equal(loaded.predict(Xv, num_iteration=2),
                                  b.predict(Xv, num_iteration=2))
    jl = lgb.Booster(model_str=text)
    np.testing.assert_allclose(jl.predict(Xv, predict_engine=False),
                               b.predict(Xv), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        jl.predict(Xv, raw_score=True, predict_engine=False),
        b.predict(Xv, raw_score=True), rtol=0,
        atol=pred_atol(b.models, K, 1e-12))


@pytest.mark.parametrize("mode", ["dart", "rf"])
def test_stratified_cv_matches_jax(mode):
    X, y = _data(4500)
    p = _p(mode, "multiclass")
    out = {}
    for pkg in (lgb, ltt):
        pp = dict(p, device_type="cpu") if pkg is ltt else p
        out[pkg] = pkg.cv(pp, pkg.Dataset(X, label=y, params=pp),
                          num_boost_round=3, nfold=3, stratified=True,
                          shuffle=True, seed=3)
    assert sorted(out[ltt]) == sorted(out[lgb])
    for k, v in out[lgb].items():
        np.testing.assert_allclose(out[ltt][k], v, rtol=0, atol=METRIC_ATOL)
