"""The port's metrics (``lightgbm_tpu_torch/metrics.py``) against the JAX
package's (``lightgbm_tpu/metrics.py``) on the same numpy inputs.

Every registered metric class, unweighted and weighted, on inputs made
from a numpy seed: regression losses on real labels, the
Poisson/gamma/tweedie family on positive means, the binary and
cross-entropy family on probabilities (some exactly 0 and 1, so the
clipping shows), ``auc`` on scores with many ties, the multiclass metrics
on (N, K) probabilities (``multi_error`` also at top-2), and the rank
metrics on query boundaries at every ``eval_at`` position.  The port gets
its inputs as CPU tensors where it computes in torch (the pointwise
metrics and ``auc``), as arrays where it computes in numpy (multiclass,
rank).

Tolerance: relative 1e-9 (both compute in float64; torch and numpy sum in
different orders).  The weights are float64 arrays: given float32 ones
(a dataset's metadata), the JAX package sums them in float32
(``np.sum``), the port in float64, and the two differ by about 4e-8
relative.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
from lightgbm_tpu import metrics as jm  # noqa: E402
from lightgbm_tpu_torch import Config  # noqa: E402
from lightgbm_tpu_torch import metrics as tm  # noqa: E402

RTOL = 1e-9
N = 3000
PARAMS = {"alpha": 0.7, "fair_c": 0.8, "tweedie_variance_power": 1.3}

REGRESSION = ("l2", "rmse", "l1", "quantile", "huber", "fair", "mape")
POSITIVE = ("poisson", "gamma", "gamma_deviance", "tweedie")
PROBABILITY = ("binary_logloss", "binary_error", "cross_entropy", "kldiv")
POINTWISE = REGRESSION + POSITIVE + PROBABILITY + ("cross_entropy_lambda",
                                                   "auc")
RANK = ("ndcg", "map")


def _inputs(name, seed=0):
    """(label, score) of the metric's kind, from a numpy seed."""
    rng = np.random.RandomState(seed)
    if name in REGRESSION:
        label = rng.randn(N) * 3
        return label, label + rng.randn(N)
    if name in POSITIVE:
        label = rng.gamma(2.0, 1.5, N)
        label[rng.rand(N) < 0.1] = 0.0 if name != "gamma" else 0.5
        return label, rng.gamma(2.0, 1.5, N) + 0.01
    if name == "cross_entropy_lambda":
        return (rng.rand(N) < 0.4).astype(np.float64), \
            rng.gamma(1.5, 0.7, N)
    if name == "auc":
        label = (rng.rand(N) < 0.35).astype(np.float64)
        # few distinct scores: most rows tie with others, across labels
        return label, np.round(rng.rand(N) + 0.3 * label, 2)
    label = (rng.rand(N) < 0.4).astype(np.float64)
    if name in ("cross_entropy", "kldiv"):
        label = np.where(rng.rand(N) < 0.3, rng.rand(N), label)
    score = 1 / (1 + np.exp(-rng.randn(N) * 2))
    score[:5], score[5:10] = 0.0, 1.0
    return label, score


def _weight(seed=1):
    return np.random.RandomState(seed).uniform(0.2, 2.0, N)


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", POINTWISE)
def test_pointwise_metric_matches_jax(name, weighted):
    label, score = _inputs(name)
    w = _weight() if weighted else None
    ref = jm._REGISTRY[name](lgb.Config(PARAMS)).eval(label, score, w)
    port = tm._REGISTRY[name](Config(PARAMS))
    got = port.eval(torch.from_numpy(label), torch.from_numpy(score),
                    None if w is None else torch.from_numpy(w))
    assert isinstance(got, float)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)
    assert port.higher_better == (name == "auc")


def test_auc_ties_and_degenerate_labels():
    """All rows tied gives 0.5; one class only gives 1.0 (as the
    reference)."""
    port = tm.AUCMetric(Config())
    y = np.array([0, 1, 0, 1, 1], np.float64)
    assert port.eval(torch.from_numpy(y), torch.zeros(5)) == 0.5
    ones = torch.ones(5, dtype=torch.float64)
    assert port.eval(ones, torch.arange(5.0)) == 1.0
    ref = jm.AUCMetric(lgb.Config()).eval(y, np.array([.1, .4, .4, .4, .9]))
    assert port.eval(torch.from_numpy(y),
                     torch.tensor([.1, .4, .4, .4, .9])) == ref


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name,top_k", [("multi_logloss", 1),
                                        ("multi_error", 1),
                                        ("multi_error", 2)])
def test_multiclass_metric_matches_jax(name, top_k, weighted):
    rng = np.random.RandomState(3)
    K = 4
    label = rng.randint(0, K, N).astype(np.float64)
    raw = rng.randn(N, K) + np.eye(K)[label.astype(int)]
    prob = np.exp(raw) / np.exp(raw).sum(1, keepdims=True)
    w = _weight(4) if weighted else None
    params = {"multi_error_top_k": top_k}
    ref = jm._REGISTRY[name](lgb.Config(params)).eval(label, prob, w)
    got = tm._REGISTRY[name](Config(params)).eval(label, prob, w)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", RANK)
def test_rank_metric_matches_jax(name, weighted):
    rng = np.random.RandomState(5)
    sizes = rng.randint(1, 30, 80)
    qb = np.concatenate([[0], np.cumsum(sizes)])
    n = int(qb[-1])
    label = rng.randint(0, 5, n).astype(np.float64)
    label[qb[3]:qb[4]] = 0                 # a query with no relevant doc
    score = np.round(rng.randn(n), 1)      # ties inside queries
    w = np.repeat(rng.uniform(0.5, 2, len(sizes)), sizes) if weighted \
        else None
    params = {"eval_at": [1, 3, 5, 10]}
    ref = jm._REGISTRY[name](lgb.Config(params))
    port = tm._REGISTRY[name](Config(params))
    want = ref.eval_all(label, score, w, qb)
    got = port.eval_all(label, score, w, qb)
    assert [k for k, _ in got] == [k for k, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=RTOL, atol=0)
    assert port.eval(label, score, w, qb) == got[0][1]
    assert port.higher_better


def test_registry_and_defaults_match_jax():
    """The same names, defaults per objective and de-duplication."""
    assert sorted(tm._REGISTRY) == sorted(jm._REGISTRY)
    for n in jm._REGISTRY:
        assert tm._REGISTRY[n].name == jm._REGISTRY[n].name
    assert tm._DEFAULT_FOR_OBJECTIVE == jm._DEFAULT_FOR_OBJECTIVE
    for obj in ("binary", "regression", "lambdarank", "anything"):
        assert tm.default_metric_for(obj) == jm.default_metric_for(obj)
    names = ["auc", "binary", "binary_logloss", "None", "nonexistent",
             " l2 "]
    assert [m.name for m in tm.create_metrics(names, Config())] == \
        [m.name for m in jm.create_metrics(names, lgb.Config())]
    np.testing.assert_array_equal(tm.default_label_gain(),
                                  __import__("lightgbm_tpu.objectives",
                                             fromlist=["x"]
                                             ).default_label_gain())
