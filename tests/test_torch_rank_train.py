"""Training under ``objective=lambdarank`` on grouped data: the port
(``device_type=cpu``) against the JAX package (``JAX_PLATFORMS=cpu``).

Data: bench.py's MS-LTR generator (relevance ``X0 + 0.5 X1 + 0.8
noise`` cut at its 60/80/92/98th percentiles into labels 0-4) at a small
size, queries of 5 to 119 documents, 8 features, ``max_bin=63``.

The contract.  The two packages' gradients differ by a few float32 ulp
(``tests/test_torch_rank.py``), and their histograms sum in float64 (the
port) and float32 (the JAX package), so trees are held as
``tests/test_torch_objectives.py`` holds the objective zoo
(``hold_to_jax``): identical splits, model text and predictions, or a
near tie (gains within rel 1e-5) at the first differing split and
nothing compared after it.  The 255-leaf exact run meets one in its
first tree (split 141: gains 0.46489680 and 0.46489817).  Metrics
recorded before the first differing tree are within 1e-9 of the JAX
package's; ``ndcg@k`` and ``map@k`` computed by the two packages on the
same scores agree within 1e-9, and ``cv``'s folds are the JAX package's
row indices.  ``fused_iters=4`` trains the bits of ``fused_iters=1``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu.engine as jengine  # noqa: E402
import lightgbm_tpu.metrics as jmetrics  # noqa: E402
import lightgbm_tpu_torch as ltt  # noqa: E402
import lightgbm_tpu_torch.engine as tengine  # noqa: E402
import lightgbm_tpu_torch.metrics as tmetrics  # noqa: E402
from test_torch_objectives import first_difference, hold_to_jax  # noqa

METRIC_ATOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_ranking(nq, F=8, seed=0, lo=5, hi=120):
    """bench.py's MS-LTR generator (``bench.py:2239-2244``) with queries of
    ``lo`` to ``hi - 1`` documents."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(lo, hi, nq)
    n = int(counts.sum())
    X = rng.randn(n, F)
    rel = X[:, 0] + 0.5 * X[:, 1] + 0.8 * rng.randn(n)
    y = np.clip(np.digitize(rel, np.percentile(rel, [60, 80, 92, 98])),
                0, 4).astype(np.float32)
    return X, y, counts


BASE = {"objective": "lambdarank", "max_bin": 63, "verbose": -1,
        "metric": "ndcg", "eval_at": [1, 3, 5]}


def _both(params, X, y, counts, rounds, valid=None, **kw):
    """(JAX booster, port booster, JAX evals, port evals)."""
    ej, et = {}, {}
    vj = [] if valid is None else [lgb.Dataset(valid[0], label=valid[1],
                                               group=valid[2])]
    bj = lgb.train(params,
                   lgb.Dataset(X, label=y, group=counts, params=params),
                   rounds, valid_sets=vj, evals_result=ej,
                   verbose_eval=False, **kw)
    pt = dict(params, device_type="cpu")
    dt = ltt.Dataset(X, label=y, group=counts, params=pt)
    vt = [] if valid is None else [dt.create_valid(valid[0], label=valid[1],
                                                   group=valid[2])]
    bt = ltt.train(pt, dt, rounds, valid_sets=vt, evals_result=et,
                   verbose_eval=False, **kw)
    return bj, bt, ej, et


def _same_metrics_before(ej, et, first_tree):
    assert ej.keys() == et.keys()
    for name in ej:
        assert ej[name].keys() == et[name].keys()
        for m in ej[name]:
            a, b = np.asarray(ej[name][m]), np.asarray(et[name][m])
            assert len(a) == len(b)
            np.testing.assert_allclose(b[:first_tree], a[:first_tree],
                                       rtol=0, atol=METRIC_ATOL)


def test_exact_255_leaves_matches_jax():
    X, y, counts = make_ranking(130)
    Xv, yv, cv_ = make_ranking(30, seed=1)
    p = dict(BASE, num_leaves=255)
    bj, bt, ej, et = _both(p, X, y, counts, 5, valid=(Xv, yv, cv_))
    assert [t.num_leaves for t in bt.models] == [255] * 5
    diff = hold_to_jax(bj, bt, X, y)
    _same_metrics_before(ej, et, 5 if diff is None else diff[0])
    assert set(et["valid_0"]) == {"ndcg@1", "ndcg@3", "ndcg@5"}
    # the ranking is learned: ndcg@5 rises over the five trees
    assert et["valid_0"]["ndcg@5"][-1] > et["valid_0"]["ndcg@5"][0]


def test_bagging_valid_set_early_stopping_matches_jax():
    """Bernoulli bagging, a grouped validation set with ``ndcg`` and
    ``map``, early stopping: the same trees, masks and best iteration."""
    X, y, counts = make_ranking(60, seed=2)
    Xv, yv, cv_ = make_ranking(25, seed=3)
    p = dict(BASE, num_leaves=15, bagging_fraction=0.7, bagging_freq=1,
             metric="ndcg,map", learning_rate=0.3)
    bj, bt, ej, et = _both(p, X, y, counts, 12, valid=(Xv, yv, cv_),
                           early_stopping_rounds=2)
    diff = hold_to_jax(bj, bt, X, y)
    assert diff is None
    _same_metrics_before(ej, et, len(bt.models))
    assert set(et["valid_0"]) == {f"{m}@{k}" for m in ("ndcg", "map")
                                  for k in (1, 3, 5)}
    assert bt.best_iteration == bj.best_iteration


def test_rollback_one_iter_matches_jax():
    X, y, counts = make_ranking(50, seed=4)
    Xv, yv, cv_ = make_ranking(20, seed=5)
    p = dict(BASE, num_leaves=15)
    pt = dict(p, device_type="cpu")
    bj = lgb.Booster(p, lgb.Dataset(X, label=y, group=counts, params=p))
    bj.add_valid(lgb.Dataset(Xv, label=yv, group=cv_), "v")
    dt = ltt.Dataset(X, label=y, group=counts, params=pt)
    bt = ltt.Booster(pt, dt)
    bt.add_valid(dt.create_valid(Xv, label=yv, group=cv_), "v")
    for b in (bj, bt):
        for _ in range(3):
            b.update()
        b.rollback_one_iter()
        b.update()
    assert first_difference(bj._gbdt.models, bt.models) is None
    hold_to_jax(bj, bt, X, y)
    # model text: objective=lambdarank, loaded back, the identity output
    text = bt.model_to_string()
    assert "\nobjective=lambdarank\n" in text
    loaded = ltt.Booster(model_str=text, params={"device_type": "cpu"})
    np.testing.assert_array_equal(loaded.predict(Xv), bt.predict(Xv))
    np.testing.assert_array_equal(loaded.predict(Xv),
                                  bt.predict(Xv, raw_score=True))
    for (dj, mj, vj, _), (dt_, mt, vt, _) in zip(bj.eval_valid(),
                                                 bt.eval_valid()):
        assert (dj, mj) == (dt_, mt)
        assert abs(vj - vt) <= METRIC_ATOL


@pytest.mark.parametrize("loop", ["exact", "quantized waves"])
def test_fused_iters_4_bits_of_1(loop):
    X, y, counts = make_ranking(40, seed=6)
    extra = {} if loop == "exact" else {
        "wave_splits": True, "use_quantized_grad": True,
        "min_data_in_leaf": 0}
    out = []
    for k in (1, 4):
        p = dict(BASE, num_leaves=15, metric="None", fused_iters=k,
                 device_type="cpu", **extra)
        b = ltt.train(p, ltt.Dataset(X, label=y, group=counts, params=p), 6)
        # iteration 0 alone (boost_from_average), then blocks of k trees
        assert b._gbdt.block_sizes == ([1] * 6 if k == 1 else [1, 4, 1])
        out.append((b.model_to_string(), b._gbdt.train_score()))
    assert out[0][0] == out[1][0]
    np.testing.assert_array_equal(out[0][1], out[1][1])


@pytest.mark.parametrize("name", ["ndcg", "map"])
def test_rank_metrics_match_jax(name):
    """``ndcg@k`` and ``map@k`` at k = 1, 3, 5 on equal scores, with ties
    and with row weights, from both packages' metric classes and from the
    port's evaluation of a booster's training and validation sets."""
    rng = np.random.RandomState(8)
    _, y, counts = make_ranking(40, seed=8)
    qb = np.concatenate([[0], np.cumsum(counts)])
    params = {"eval_at": [1, 3, 5]}
    mj = jmetrics.create_metrics([name], lgb.Config(params))[0]
    mt = tmetrics.create_metrics([name], ltt.Config(params))[0]
    w = np.repeat(rng.rand(len(counts)) + 0.5, counts)
    for score in (rng.randn(len(y)), rng.randint(0, 4, len(y)) * 0.5,
                  np.zeros(len(y))):
        for weight in (None, w):
            a = mj.eval_all(y.astype(np.float64), score, weight, qb)
            b = mt.eval_all(y, torch.from_numpy(score), weight, qb)
            assert [k for k, _ in a] == [k for k, _ in b] == \
                [f"{name}@{k}" for k in (1, 3, 5)]
            np.testing.assert_allclose([v for _, v in b], [v for _, v in a],
                                       rtol=0, atol=METRIC_ATOL)
    # a booster's sets carry their query boundaries to the metric
    X, y, counts = make_ranking(30, seed=9)
    Xv, yv, cv_ = make_ranking(12, seed=10)
    p = dict(BASE, num_leaves=7, metric=name, device_type="cpu")
    dt = ltt.Dataset(X, label=y, group=counts, params=p)
    b = ltt.train(p, dt, 2, valid_sets=[dt, dt.create_valid(
        Xv, label=yv, group=cv_)])
    got = {(d, m): v for d, m, v, _ in b.eval_set()}
    for d, (Xs, ys, cs) in (("training", (X, y, counts)),
                            ("valid_1", (Xv, yv, cv_))):
        ref = mt.eval_all(ys, b.predict(Xs, raw_score=True), None,
                          np.concatenate([[0], np.cumsum(cs)]))
        for m, v in ref:
            assert abs(got[(d, m)] - v) <= METRIC_ATOL


class _GroupKFold:
    """A ``GroupKFold``-like splitter: query ids modulo the fold count."""

    def __init__(self, k):
        self.k = k

    def split(self, X, y=None, groups=None):
        fold = np.asarray(groups) % self.k
        for f in range(self.k):
            yield np.nonzero(fold != f)[0], np.nonzero(fold == f)[0]


def test_cv_group_folds_match_jax():
    X, y, counts = make_ranking(45, seed=11)
    p = dict(BASE, num_leaves=15)
    pt = dict(p, device_type="cpu")
    dj = lgb.Dataset(X, label=y, group=counts, params=p)
    dt = ltt.Dataset(X, label=y, group=counts, params=pt)
    for shuffle, folds in ((True, None), (False, None),
                           (False, _GroupKFold(3))):
        fj = jengine._make_folds(dj, 3, False, shuffle, 7, folds)
        ft = tengine._make_folds(dt, 3, False, shuffle, 7, folds)
        assert len(fj) == len(ft) == 3
        for (a, b), (c, d) in zip(fj, ft):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    rj = lgb.cv(p, dj, num_boost_round=3, nfold=3, seed=7,
                verbose_eval=False)
    rt = ltt.cv(pt, dt, num_boost_round=3, nfold=3, seed=7)
    assert rj.keys() == rt.keys()
    assert "valid ndcg@5-mean" in rt
    for k in rj:
        np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=METRIC_ATOL)


def test_reference_example_ndcg(rank_example):
    """The reference's ``examples/lambdarank`` (the ``rank_example``
    fixture; it skips where the examples are absent) at 50 rounds: the
    port's ``ndcg@5`` within 0.02 of the JAX package's
    (``tests/test_engine.py``'s bound)."""
    X, y, q, Xt, yt, qt = rank_example
    p = {"objective": "lambdarank", "metric": "ndcg", "eval_at": [1, 3, 5],
         "verbose": -1}
    _, _, ej, et = _both(p, X, y, q, 50, valid=(Xt, yt, qt))
    assert abs(et["valid_0"]["ndcg@5"][-1] - ej["valid_0"]["ndcg@5"][-1]) \
        <= 0.02
