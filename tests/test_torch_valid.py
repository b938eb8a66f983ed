"""Validation sets, metrics, callbacks, early stopping and ``cv`` of the
port (``device_type=cpu``) against the JAX package (``JAX_PLATFORMS=cpu``).

Each configuration trains once per package, module-scoped: 10 rounds,
binary, ``metric=auc,binary_logloss``, the training data and a holdout as
``valid_sets``, ``evals_result`` and ``early_stopping_rounds=10`` (which
cannot run out of patience in 10 rounds, so the stop at the last round
sets ``best_iteration``), and a ``feval`` that records each raw score it
is shown.  Configurations: the exact loop (31 leaves), float waves,
quantized two-column waves (31 leaves, 8 features, 63 bins) and quantized
two-column waves with coarse-to-fine refinement (15 leaves, 28 features,
255 bins: the refinement gate).  Their trees are identical to the JAX
package's.

The contract, and why:

- the binned holdout (``Dataset(reference=)``, ``create_valid``,
  ``subset``): byte-identical to the JAX package's;
- every recorded metric at every iteration: ``binary_logloss`` within
  1e-6 of the JAX package's; ``auc`` within 1e-6 plus 1 / (positives x
  negatives) for each positive-negative pair the two packages' scores put
  in a different order (or tie in one and not the other).  The scores
  differ by up to a few 1e-6, at every iteration within the prediction
  contract of ``tests/test_torch_slice.py`` (1e-5): the port sums
  histograms in float64 and rounds once, the JAX package in float32 in
  row order, so leaf values differ in the sixth digit, and rows whose
  scores are that close may swap places.  At the first tree the binary
  gradients take two values and the hessian one, so leaves with equal
  label counts have equal sums: exactly equal values in the port, values
  an ulp apart in the JAX package, whose AUC then orders what the port's
  ties.  On these data the AUC moves by up to 1.7e-4 so (quantized waves,
  first iteration), so the 1e-6 alone does not hold for ``auc``;
- each recorded value is the port's metric of the score it recorded, to
  1e-12 relative; the holdout score equals the port's prediction of its
  trees within 1e-6 (float32 leaf values added into float64) and the JAX
  package's within 1e-5;
- ``best_iteration``, the number of trees and the early stop's round:
  equal;
- ``fused_iters=4`` with a validation set, with one attached mid-block,
  and with a training metric: the same trees, scores and metrics, bit for
  bit, as ``fused_iters=1``;
- kernel L's float64 plain mode: exactly ``score + vals[idx].double()``.

``tests/test_torch_cv.py`` holds ``cv`` and the ``learning_rates``
schedules.

The test marked ``cuda`` holds the card's graphed validation scorer to
its eager launches and needs a card; it skips here.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as ltt  # noqa: E402
from lightgbm_tpu_torch import callback as tcb  # noqa: E402
from lightgbm_tpu_torch import metrics as tm  # noqa: E402
from lightgbm_tpu_torch.ops import lookup  # noqa: E402

ROUNDS = 10
METRIC_ATOL = 1e-6
SCORE_ATOL = 1e-5
BASE = {"objective": "binary", "verbose": -1,
        "metric": "auc,binary_logloss"}
CONFIGS = {
    "exact": {"num_leaves": 31, "max_bin": 63},
    "float waves": {"num_leaves": 31, "max_bin": 63, "wave_splits": True,
                    "hist_refinement": False},
    "quantized waves": {"num_leaves": 31, "max_bin": 63, "wave_splits": True,
                        "use_quantized_grad": True, "min_data_in_leaf": 0,
                        "hist_refinement": False},
    "quantized c2f waves": {"num_leaves": 15, "max_bin": 255,
                            "wave_splits": True, "use_quantized_grad": True,
                            "min_data_in_leaf": 0},
}


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


def _data_of(name):
    """(train X, y, holdout X, y) of a configuration."""
    if "c2f" in name:
        return _data(3000, 28, 0) + _data(1500, 28, 1)
    return _data(4000, 8, 0) + _data(2000, 8, 1)


class _Recorder:
    """A ``feval`` that records the raw scores it is shown, by dataset,
    and reports nothing."""

    def __init__(self):
        self.scores = {}

    def __call__(self, score, dataset):
        self.scores.setdefault(id(dataset), []).append(np.array(score))


def _train(pkg, name, **kw):
    """One package's training of configuration ``name`` -> (booster,
    evals_result, the holdout's raw score at each iteration, the holdout's
    labels)."""
    X, y, Xv, yv = _data_of(name)
    p = dict(BASE, **CONFIGS[name])
    if pkg is ltt:
        p["device_type"] = "cpu"
    train = pkg.Dataset(X, label=y, params=p)
    hold = train.create_valid(Xv, label=yv)
    rec, res = _Recorder(), {}
    args = dict(valid_sets=[train, hold], valid_names=["training", "hold"],
                evals_result=res, verbose_eval=False, feval=rec,
                early_stopping_rounds=ROUNDS)
    args.update(kw)
    b = pkg.train(p, train, num_boost_round=ROUNDS, **args)
    return b, res, rec.scores.get(id(hold)), yv


@pytest.fixture(scope="module")
def trained():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = (_train(lgb, name), _train(ltt, name))
        return cache[name]
    return get


def _reordered_pairs(a, b, y):
    """Positive-negative pairs that scores ``a`` and ``b`` order
    differently (one strictly, the other the other way or tied), over
    positives x negatives."""
    pos, neg = y > 0, y <= 0
    da = np.sign(a[pos][:, None] - a[neg][None, :])
    db = np.sign(b[pos][:, None] - b[neg][None, :])
    return float(np.sum(da != db)) / (pos.sum() * neg.sum())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_trees_match_jax(trained, name):
    (bj, _, _, _), (bt, _, _, _) = trained(name)
    mj, mt = bj._gbdt.models, bt.models
    assert len(mj) == len(mt) == ROUNDS
    for a, b in zip(mj, mt):
        n = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves
        for k in ("split_feature", "threshold_bin", "decision_type",
                  "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(a, k)[:n],
                                          getattr(b, k)[:n], k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_metrics_match_jax_every_iteration(trained, name):
    (bj, rj, sj, yv), (bt, rt, st, _) = trained(name)
    assert sorted(rt) == sorted(rj) == ["hold", "training"]
    for data in rj:
        assert sorted(rt[data]) == sorted(rj[data]) == \
            ["auc", "binary_logloss"]
        a = np.asarray(rt[data]["binary_logloss"])
        b = np.asarray(rj[data]["binary_logloss"])
        assert a.shape == b.shape == (ROUNDS,)
        np.testing.assert_allclose(a, b, rtol=0, atol=METRIC_ATOL)
    for i in range(ROUNDS):
        # the holdout's AUC, its pairs reordered between the two scores
        np.testing.assert_allclose(st[i], sj[i], rtol=0, atol=SCORE_ATOL)
        slack = _reordered_pairs(st[i], sj[i], yv)
        assert abs(rt["hold"]["auc"][i] - rj["hold"]["auc"][i]) <= \
            METRIC_ATOL + slack
    np.testing.assert_allclose(rt["training"]["auc"], rj["training"]["auc"],
                               rtol=0, atol=METRIC_ATOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_recorded_metrics_are_the_scores_metrics(trained, name):
    """Each recorded holdout value is the metric of the score the feval
    saw at that iteration, and the holdout score is the trees'
    prediction."""
    _, (bt, rt, st, yv) = trained(name)
    cfg = ltt.Config(dict(BASE, **CONFIGS[name]))
    for i in range(ROUNDS):
        prob = 1 / (1 + np.exp(-st[i]))
        for m in tm.create_metrics(["auc", "binary_logloss"], cfg):
            np.testing.assert_allclose(rt["hold"][m.name][i],
                                       m.eval(yv, prob), rtol=1e-12)
    Xv = _data_of(name)[2]
    score = bt._gbdt.valid_sets[0].score.numpy()
    np.testing.assert_array_equal(score, st[-1])
    np.testing.assert_allclose(score, bt.predict(Xv, raw_score=True,
                                                 num_iteration=-1),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_holdout_score_and_best_iteration_match_jax(trained, name):
    (bj, _, sj, _), (bt, _, st, _) = trained(name)
    assert len(st) == len(sj) == ROUNDS
    np.testing.assert_allclose(st[-1], sj[-1], rtol=0, atol=SCORE_ATOL)
    assert bt.best_iteration == bj.best_iteration > 0
    assert sorted(bt.best_score) == sorted(bj.best_score)
    for data, vals in bj.best_score.items():
        assert sorted(bt.best_score[data]) == sorted(vals)
    # predict and the model text default to the best iteration
    Xv = _data_of(name)[2]
    np.testing.assert_array_equal(
        bt.predict(Xv), bt.predict(Xv, num_iteration=bt.best_iteration))
    assert bt.model_to_string().count("Tree=") == \
        bj.model_to_string().count("Tree=") == bt.best_iteration


def test_early_stop_fires_like_jax(trained):
    """A feval that stops improving after round 3 stops training 3 rounds
    later, at the same round in both packages, best_iteration 4."""
    trained("exact")            # the JAX compile of this configuration

    def frozen():
        calls = {}

        def feval(score, dataset):
            k = calls[id(dataset)] = calls.get(id(dataset), 0) + 1
            return ("frozen", float(max(4 - k, 0)), False)
        return feval

    out = {}
    for pkg in (lgb, ltt):
        b, res, _, _ = _train(pkg, "exact", feval=frozen(),
                              early_stopping_rounds=3)
        out[pkg] = (b.best_iteration, b.num_trees(),
                    len(res["hold"]["auc"]), res["hold"]["frozen"])
    assert out[ltt] == out[lgb]
    assert out[ltt][:3] == (4, 7, 7)


def _port_booster(name, fused, depth=0, **extra):
    X, y, Xv, yv = _data_of(name)
    p = dict(BASE, **CONFIGS[name], device_type="cpu", fused_iters=fused,
             superstep_pipeline_depth=depth, num_iterations=ROUNDS,
             **extra)
    train = ltt.Dataset(X, label=y, params=p)
    return ltt.Booster(p, train), train, Xv, yv


def _bits(b):
    g = b._gbdt
    return (b.model_to_string(), g.train_score(),
            [vs.score.cpu().numpy().copy() for vs in g.valid_sets])


def _assert_same_bits(a, b):
    assert a[0] == b[0]
    np.testing.assert_array_equal(a[1], b[1])
    assert len(a[2]) == len(b[2])
    for x, y in zip(a[2], b[2]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["exact", "quantized c2f waves"])
def test_fused_with_valid_set_is_per_iteration(name):
    """A validation set turns fusion off: blocks of one tree, and the
    same bits and metrics as fused_iters=1."""
    runs = {}
    for fused in (1, 4):
        b, train, Xv, yv = _port_booster(name, fused)
        b.add_valid(train.create_valid(Xv, label=yv), "hold")
        evals = [b.update() or b.eval_valid() for _ in range(ROUNDS)]
        assert b._gbdt.block_sizes == [1] * ROUNDS
        runs[fused] = (_bits(b), evals)
    _assert_same_bits(runs[1][0], runs[4][0])
    assert runs[1][1] == runs[4][1]


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("name", ["exact", "quantized waves"])
def test_add_valid_mid_block_rewinds(name, depth):
    """A validation set attached after the bias iteration and 2 trees of
    a block of 4: the block is rewound to its served boundary, the set's
    score starts from the served trees, and the model, scores and metrics
    equal fused_iters=1's."""
    runs = {}
    for fused in (1, 4):
        b, train, Xv, yv = _port_booster(name, fused, depth)
        for _ in range(3):
            b.update()
        b.add_valid(train.create_valid(Xv, label=yv), "hold")
        evals = []
        for _ in range(ROUNDS - 3):
            b.update()
            evals.append(b.eval_valid())
        runs[fused] = (_bits(b), evals, b._gbdt.block_sizes)
    _assert_same_bits(runs[1][0], runs[4][0])
    assert runs[1][1] == runs[4][1]
    assert runs[4][2] == [1, 4] + [1] * (ROUNDS - 3)


def test_training_metric_turns_fusion_off():
    b, _, _, _ = _port_booster("float waves", 4,
                               is_provide_training_metric=True)
    evals = [b.update() or b.eval_train() for _ in range(4)]
    assert b._gbdt.block_sizes == [1] * 4
    assert [e[:2] for e in evals[0]] == [("training", "auc"),
                                            ("training", "binary_logloss")]
    assert b.eval_valid() == []


@pytest.mark.parametrize("how", ["reference", "create_valid", "subset"])
def test_aligned_binned_matrix_matches_jax(how):
    """The holdout binned with the training set's mappers: the port's
    (F, N) matrix is the JAX package's (N, F) one transposed, byte for
    byte; a subset shares its parent's mappers."""
    X, y = _data(3000, 8, 0)
    Xv, yv = _data(1000, 8, 1)
    Xv[:7] = 1e9                     # beyond every bin's upper bound
    idx = np.arange(0, 3000, 3)
    made = {}
    for pkg in (lgb, ltt):
        params = {"max_bin": 63, "verbose": -1}
        if pkg is ltt:
            params["device_type"] = "cpu"
        train = pkg.Dataset(X, label=y, params=params)
        if how == "reference":
            ds = pkg.Dataset(Xv, label=yv, reference=train)
        elif how == "create_valid":
            ds = train.create_valid(Xv, label=yv)
        else:
            ds = train.subset(idx)
        ds.construct()
        made[pkg] = (train, ds)
    jb = np.asarray(made[lgb][1]._constructed.binned)
    tb = made[ltt][1]._constructed.binned.numpy()
    assert tb.dtype == jb.dtype
    np.testing.assert_array_equal(tb, jb.T)
    assert made[ltt][0]._constructed.check_align(made[ltt][1]._constructed)
    np.testing.assert_array_equal(made[ltt][1].get_label(),
                                  made[lgb][1].get_label())


def test_dataset_api():
    X, y = _data(500, 5, 3)
    w = np.linspace(0.5, 1.5, 500)
    p = {"device_type": "cpu", "max_bin": 15}
    train = ltt.Dataset(X, label=y, weight=w, params=p)
    np.testing.assert_array_equal(train.get_label(), y.astype(np.float32))
    np.testing.assert_array_equal(train.get_weight(), w.astype(np.float32))
    valid = train.create_valid(X[:50], label=y[:50])
    assert valid.reference is train and valid.params == train.params
    assert valid.get_weight() is None
    other = ltt.Dataset(X[:, :4], label=y, params=p).construct()
    assert not train.construct()._constructed.check_align(
        other._constructed)
    grouped = ltt.Dataset(X, label=y, group=[250, 250], params=p)
    np.testing.assert_array_equal(grouped.get_group(), [250, 250])
    with pytest.raises(NotImplementedError):
        ltt.Dataset(X, label=y, params=p, init_score=np.zeros(500))
    # a categorical feature bins as in the JAX package, and its validation
    # set with the training mappers
    Xc = X.copy()
    Xc[:, 0] = np.floor(np.abs(Xc[:, 0]) * 3)
    cat = ltt.Dataset(Xc, label=y, params=p, categorical_feature=[0])
    catj = lgb.Dataset(Xc, label=y, params=p, categorical_feature=[0])
    for t, j in ((cat, catj), (cat.create_valid(Xc[:50] + 1, label=y[:50]),
                               catj.create_valid(Xc[:50] + 1,
                                                 label=y[:50]))):
        np.testing.assert_array_equal(
            t.construct()._constructed.binned.numpy(),
            np.asarray(j.construct()._constructed.binned).T)
    assert cat._constructed.mappers[0].bin_type == 1


@pytest.mark.parametrize("metric,objective", [
    ("", "binary"), ("", "regression"), ("None", "binary"),
    ("auc, binary_logloss", "binary"), (["l1", "l2"], "regression"),
    (["auc", "na"], "binary"), ("custom", "binary")])
def test_metric_resolution_matches_jax(metric, objective):
    params = {"metric": metric, "objective": objective}
    assert ltt.Booster._resolve_metric_names(ltt.Config(params)) == \
        lgb.Booster._resolve_metric_names(lgb.Config(params))
    # the alias resolves too
    alias = {"metrics": metric, "objective": objective}
    assert ltt.Booster._resolve_metric_names(ltt.Config(alias)) == \
        lgb.Booster._resolve_metric_names(lgb.Config(alias))


def test_params_set_early_stopping_and_first_metric_only():
    """``early_stopping_round`` and ``first_metric_only`` in params act as
    the keywords do: the frozen first metric stops training."""
    X, y, Xv, yv = _data_of("exact")
    res = {}

    def feval(score, dataset):
        return ("frozen", 1.0, False)

    p = dict(BASE, **CONFIGS["exact"], device_type="cpu",
             metric="binary_logloss", early_stopping_round=2,
             first_metric_only=True)
    train = ltt.Dataset(X, label=y, params=p)
    b = ltt.train(p, train, num_boost_round=ROUNDS, feval=feval,
                  valid_sets=[train.create_valid(Xv, label=yv)],
                  evals_result=res, verbose_eval=False)
    # binary_logloss keeps improving: only the first metric counts
    assert b.num_trees() == ROUNDS
    assert b.best_iteration == ROUNDS
    p["metric"] = "None"
    b = ltt.train(p, ltt.Dataset(X, label=y, params=p),
                  num_boost_round=ROUNDS, feval=feval,
                  valid_sets=[ltt.Dataset(Xv, label=yv, reference=train)],
                  verbose_eval=False)
    # the frozen metric is now the first: stops 2 rounds after round 1
    assert (b.num_trees(), b.best_iteration) == (3, 1)


def test_unported_arguments_raise():
    X, y, _, _ = _data_of("exact")
    p = dict(BASE, device_type="cpu")
    for kw in ({"init_model": "model.txt"}, {"mesh": object()},
               {"resume_from": "auto"}):
        with pytest.raises(NotImplementedError):
            ltt.train(p, ltt.Dataset(X, label=y, params=p),
                      num_boost_round=1, **kw)
    # a custom objective is ported: an L2 fobj trains
    b = ltt.train(p, ltt.Dataset(X, label=y, params=p), num_boost_round=1,
                  fobj=lambda s, d: (s - d.get_label(), np.ones_like(s)))
    assert b.num_trees() == 1


def test_callback_names_match_jax():
    """The JAX package's callbacks, but record_telemetry (which waits for
    the port's observability plane); no name the JAX package lacks."""
    from lightgbm_tpu import callback as jcb
    public = {n for n in dir(jcb) if not n.startswith("_")} - \
        {"record_telemetry"}
    assert {n for n in dir(tcb) if not n.startswith("_")} == public


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_take_small_add_float64_plain_is_exact(dtype):
    rng = np.random.RandomState(9)
    vals = torch.from_numpy(rng.randn(255).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 255, 10_001)).to(dtype)
    score = torch.from_numpy(rng.randn(10_001) * 1e3)
    want = score + vals[idx.to(torch.int64)].double()
    before = dict(lookup.LAUNCHES)
    got = lookup.take_small_add(score.clone(), vals, idx)
    assert got.dtype == torch.float64
    assert torch.equal(got, want)
    assert lookup.LAUNCHES == before      # the plain version launches none


LRS = [0.1 * 0.85 ** i for i in range(ROUNDS)]


@pytest.mark.cuda
def test_valid_scorer_graphs_match_eager_on_card():
    """On the card: the validation scorer as graph replays against eager
    launches, and fused_iters=4 under a rate schedule, the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs of the kernels)")
    X, y, Xv, yv = _data_of("quantized waves")
    out = {}
    for mode, fused in (("eager", 1), ("graphs", 1), ("graphs", 4)):
        p = dict(BASE, **CONFIGS["quantized waves"], fused_iters=fused)
        train = ltt.Dataset(X, label=y, params=p)
        b = ltt.Booster(p, train, _eager=mode == "eager")
        b._gbdt.config.num_iterations = ROUNDS
        b.add_valid(train.create_valid(Xv, label=yv), "hold")
        for i in range(ROUNDS):
            b._gbdt.shrinkage_rate = LRS[i]
            b.update()
        out[mode, fused] = _bits(b)
        assert (b._gbdt.valid_sets[0].scorer.graph is None) == \
            (mode == "eager")
    _assert_same_bits(out["eager", 1], out["graphs", 1])
    _assert_same_bits(out["eager", 1], out["graphs", 4])
