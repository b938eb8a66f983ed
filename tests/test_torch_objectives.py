"""The objective zoo of the port (``device_type=cpu``) against the JAX
package's (``JAX_PLATFORMS=cpu``).

Gradients and hessians, on the same float32 scores (4 classes for the
multiclass objectives), with and without row weights:

- L1, quantile, Huber, Fair and MAPE (pure float32 arithmetic in the JAX
  package's operation order): bit for bit;
- Poisson, gamma, Tweedie, cross-entropy, its lambda form unweighted and
  one-vs-all (float64 in the port, rounded once; float32 with XLA's own
  ``exp`` in the JAX package): within 2 ulp of the magnitude of the terms
  the formula adds or subtracts (``_term_scales``: where the terms cancel,
  an ulp of the result means nothing), and within 4 ulp weighted (the
  JAX package rounds the unweighted value, then its product with the
  weight: two roundings against the port's one);
- softmax: within 32 ulp of max(p, 1{y=k}) (the JAX package's float32
  softmax rounds K exponentials, their sum and the quotient; measured up
  to 20 ulp of p in the hessian);
- the weighted lambda form: the JAX package's float32 chain cancels in
  ``z = 1 - exp(-w * log1p(e^s))`` for small ``w``, in ``c - 1`` after
  it and in ``1 - y / z``, so its relative error grows as ``z`` falls (a
  hessian off by 99.7% at ``w = 0.0011``): it is held to the port within
  1e-3 / z of the port's magnitude plus 1e-6 (measured up to 7.3e-4 /
  z), and the port itself within 1 ulp of a numpy float64 evaluation of
  the same formula.

``boost_from_score`` (every class) equal to the float; ``convert_output``
within 1e-12 (numpy on both sides, and the port's tensor form within
1e-12 of its numpy form).

Three-tree training against ``lightgbm_tpu`` on the exact loop and on
float waves (4,000 rows x 6 features with 10% NaN in one, 15 leaves,
``max_bin=63``), model text compared as ``tests/test_torch_slice.py``
does (the numeric lines within rtol 1e-5 plus 1e-6 of a scale, here the
larger of sum |label|, the row count and the first tree's root hessian
sum, since Poisson-like hessians outgrow the labels), and raw
predictions within 1e-5 times the larger of 1 and the sum over a class's
trees of their largest |leaf value| (each leaf value is held within rel
1e-5; Fair's predictions reach 1.2 and differ by 1.2e-5) — unless a split
differs.  Then the trees agree up to the
first differing split, where the two packages' gains for their choices
are within rel 1e-5 of each other (a near tie: the port sums histograms
in float64, the JAX package in float32 in row order, as the slice's test
states), and nothing after it is compared.  On these data that happens
once: quantile on the exact loop, the third tree's eleventh split, gains
2.0975046 and 2.0975051.
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
from test_torch_slice import PRED_ATOL  # noqa: E402
from test_torch_slice import _assert_model_text_matches  # noqa: E402

NEW = ("regression_l1", "quantile", "huber", "fair", "poisson", "mape",
       "gamma", "tweedie", "cross_entropy", "cross_entropy_lambda")
MULTI = ("multiclass", "multiclassova")
ARITHMETIC = ("regression_l1", "quantile", "huber", "fair", "mape")
K = 4
N = 20_000
GAIN_RTOL = 1e-5


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


def _labels(name, rng, n):
    z = rng.randn(n)
    if name in MULTI:
        return rng.randint(0, K, n).astype(float)
    if name == "poisson":
        return rng.poisson(np.exp(0.5 * z)).astype(float)
    if name in ("gamma", "mape"):
        return np.exp(0.5 * z) * rng.gamma(2.0, 0.5, n)
    if name == "tweedie":
        return np.where(rng.rand(n) < 0.3, 0.0, np.exp(0.5 * z))
    if name.startswith("cross_entropy"):
        return 1.0 / (1.0 + np.exp(-z))
    return z


def _pair(name, label, weight, n):
    p = {"objective": name, "num_class": K if name in MULTI else 1}
    oj = jobj.create_objective(name, JConfig(p))
    oj.init(_Meta(label, weight), n)
    ot = tobj.create_objective(name, TConfig(p))
    ot.init(_Meta(label, weight), n, torch.device("cpu"))
    return oj, ot


def _term_scales(name, s, y, w):
    """Per element, the magnitude of the terms the gradient and the
    hessian add or subtract (float64)."""
    s = s.astype(np.float64)
    y = y.astype(np.float64)
    if name == "poisson":
        sg, sh = np.maximum(np.exp(s), np.abs(y)), np.exp(s + 0.7)
    elif name == "gamma":
        e = y * np.exp(-s)
        sg, sh = np.maximum(1.0, e), e
    elif name == "tweedie":
        a, b = np.exp(-0.5 * s), np.exp(0.5 * s)
        sg, sh = np.maximum(y * a, b), 0.5 * np.maximum(y * a, b)
    elif name in ("cross_entropy", "cross_entropy_lambda"):
        z = 1.0 / (1.0 + np.exp(-s))
        sg, sh = np.maximum(z, y), z
    elif name == "multiclass":
        e = np.exp(s - s.max(0))
        p = e / e.sum(0)
        onehot = np.arange(K)[:, None] == y[None, :].astype(int)
        sg = sh = np.maximum(p, onehot)
    else:                                   # one-vs-all
        t = np.where(np.arange(K)[:, None] == y[None, :].astype(int), 1.0,
                     -1.0)
        sg = sh = np.abs(t / (1.0 + np.exp(t * s)))
    if w is not None:
        sg, sh = sg * w, sh * w
    return sg, sh


def _lambda_weighted64(s, y, w):
    """``CrossEntropyLambda``'s weighted formula in numpy float64, rounded
    once to float32."""
    s, y, w = (np.asarray(a, np.float64) for a in (s, y, w))
    epf = np.exp(s)
    z = 1.0 - np.exp(-w * np.log1p(epf))
    grad = (1.0 - y / z) * w / (1.0 + 1.0 / epf)
    c = 1.0 / (1.0 - z)
    d = 1.0 + epf
    a = w * epf / (d * d)
    d = c - 1.0
    b = (c / (d * d)) * (1.0 + w * epf - c)
    return grad.astype(np.float32), (a * (1.0 + y * b)).astype(np.float32)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", NEW + MULTI)
def test_gradients_match_jax(name, weighted):
    rng = np.random.RandomState((NEW + MULTI).index(name))
    label = _labels(name, rng, N)
    weight = rng.rand(N) * 2.0 if weighted else None
    oj, ot = _pair(name, label, weight, N)
    shape = (K, N) if name in MULTI else (N,)
    s = (rng.randn(*shape) * 2.0).astype(np.float32)
    gj, hj = (np.asarray(a) for a in oj.gradient_fn()(s))
    gt, ht = (a.numpy() for a in ot.get_gradients(torch.from_numpy(s)))
    assert gt.dtype == ht.dtype == np.float32 and gt.shape == shape
    if name in ARITHMETIC:
        np.testing.assert_array_equal(gt, gj)
        np.testing.assert_array_equal(ht, hj)
        return
    w32 = None if weight is None else weight.astype(np.float32)
    if name == "cross_entropy_lambda" and weighted:
        g64, h64 = _lambda_weighted64(s, label.astype(np.float32), w32)
        assert _ulps(gt, g64).max() <= 1 and _ulps(ht, h64).max() <= 1
        s64 = s.astype(np.float64)
        z = 1.0 - np.exp(-w32.astype(np.float64) * np.log1p(np.exp(s64)))
        for j, t in ((gj, gt), (hj, ht)):
            assert np.all(np.abs(j - t) <= 1e-3 / z * (np.abs(t) + 1e-6))
        return
    sg, sh = _term_scales(name, s, label.astype(np.float32), w32)
    ulp = 32 if name == "multiclass" else 4 if weighted else 2
    for j, t, sc in ((gj, gt, sg), (hj, ht, sh)):
        bound = ulp * np.spacing(np.float32(sc)).astype(np.float64)
        assert np.all(np.abs(j.astype(np.float64) - t) <= bound), \
            np.max(np.abs(j.astype(np.float64) - t) / bound)


@pytest.mark.parametrize("name", NEW + MULTI)
def test_boost_from_score_and_convert_output(name):
    rng = np.random.RandomState(7)
    n = 1000
    label = _labels(name, rng, n)
    for weight in (None, rng.rand(n) + 0.5):
        oj, ot = _pair(name, label, weight, n)
        for k in range(K if name in MULTI else 1):
            assert ot.boost_from_score(k) == oj.boost_from_score(k)
    raw = rng.randn(50, K) if name in MULTI else rng.randn(50)
    cj = np.asarray(oj.convert_output(raw))
    ct = ot.convert_output(raw)
    np.testing.assert_allclose(ct, cj, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ot.convert_output(torch.from_numpy(raw))
                               .numpy(), ct, rtol=1e-12, atol=1e-12)


def test_aliases_and_ranking():
    """Every alias the JAX package registers for these objectives names
    the same objective in the port; ``lambdarank`` trains on grouped data
    and refuses data without groups, as the JAX package does;
    ``rank_xendcg``, which the JAX package does not register, is an
    unknown objective in both."""
    for alias, cls in jobj._REGISTRY.items():
        if cls.name in NEW + MULTI:
            assert tobj._REGISTRY[alias].name == cls.name, alias
    rng = np.random.RandomState(2)
    X = rng.randn(300, 4)
    y = rng.randint(0, 3, 300).astype(float)
    p = {"objective": "lambdarank", "num_leaves": 7, "verbose": -1,
         "metric": "None", "device_type": "cpu"}
    b = ltt.train(p, ltt.Dataset(X, label=y, group=[100, 150, 50], params=p),
                  num_boost_round=2)
    assert b.num_trees() == 2
    with pytest.raises(ltt.LightGBMError, match="group"):
        ltt.train(p, ltt.Dataset(X, label=y, params=p), num_boost_round=1)
    with pytest.raises(ltt.LightGBMError, match="unknown objective"):
        tobj.create_objective("rank_xendcg", TConfig({}))


def _train_data(name, n=4000, F=6, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n) < 0.1, 1] = np.nan
    Xn = np.nan_to_num(X)
    z = Xn[:, 0] + 0.5 * Xn[:, 1] - 0.7 * Xn[:, 2] * Xn[:, 3] + \
        0.3 * rng.randn(n)
    if name == "poisson":
        y = rng.poisson(np.exp(0.4 * z))
    elif name in ("gamma", "tweedie", "mape"):
        y = np.exp(0.5 * z) * rng.gamma(2.0, 0.5, n)
    elif name.startswith("cross_entropy"):
        y = 1.0 / (1.0 + np.exp(-z))
    else:
        y = z
    return X, y.astype(float)


def _splits(tree):
    """The tree's splits in the order they were made (node i is the i-th
    split): feature, threshold bin, decision type and children."""
    return [(int(tree.split_feature[i]), int(tree.threshold_bin[i]),
             int(tree.decision_type[i]), int(tree.left_child[i]),
             int(tree.right_child[i])) for i in range(tree.num_leaves - 1)]


def first_difference(models_j, models_t):
    """(tree, node) of the first differing split, or None."""
    for i, (a, b) in enumerate(zip(models_j, models_t)):
        sa, sb = _splits(a), _splits(b)
        for j in range(max(len(sa), len(sb))):
            if j >= len(sa) or j >= len(sb) or sa[j] != sb[j]:
                return i, j
    return None


def pred_atol(models, k, atol=PRED_ATOL):
    """``atol`` times the larger of 1 and the sum over a class's trees of
    their largest |leaf value| (the most a class's prediction reaches)."""
    reach = max(sum(np.abs(t.leaf_value[:t.num_leaves]).max()
                    for t in models[c::k]) for c in range(k))
    return atol * max(1.0, reach)


def hold_to_jax(bj, bt, X, y, scale_extra=0.0, atol=PRED_ATOL):
    """The slice's contract: identical trees, model text and predictions,
    or a near tie at the first differing split (module docstring).
    Returns the first difference."""
    mj, mt = bj._gbdt.models, bt.models
    k = bt.num_tree_per_iteration
    assert len(mj) == len(mt)
    diff = first_difference(mj, mt)
    scale = max(np.abs(y).sum(), len(y), scale_extra)
    if diff is None:
        _assert_model_text_matches(bj.model_to_string(),
                                   bt.model_to_string(), scale)
        pj = bj.predict(X, raw_score=True, predict_engine=False)
        np.testing.assert_allclose(bt.predict(X, raw_score=True), pj,
                                   rtol=0, atol=pred_atol(mj, k, atol))
        return None
    i, j = diff
    ga, gb = mj[i].split_gain[j], mt[i].split_gain[j]
    assert abs(ga - gb) <= GAIN_RTOL * max(abs(ga), abs(gb)), (diff, ga, gb)
    for t in range(i):
        # the trees before it split alike (first_difference); their
        # values agree as the model text's numeric lines do
        n = mj[t].num_leaves
        va, vb = mj[t].leaf_value[:n], mt[t].leaf_value[:n]
        assert np.all(np.abs(va - vb) <= 1e-5 * np.abs(va) + 1e-6 * scale)
    return diff


@pytest.mark.parametrize("loop", ["exact", "float waves"])
@pytest.mark.parametrize("name", NEW)
def test_three_trees_match_jax(name, loop):
    X, y = _train_data(name)
    extra = {} if loop == "exact" else {"wave_splits": True,
                                        "hist_refinement": False}
    p = {"objective": name, "num_leaves": 15, "max_bin": 63, "verbose": -1,
         "metric": "None", **extra}
    bj = lgb.train(p, lgb.Dataset(X, label=y, params=p), num_boost_round=3,
                   verbose_eval=False)
    pt = dict(p, device_type="cpu")
    bt = ltt.train(pt, ltt.Dataset(X, label=y, params=pt), num_boost_round=3)
    root_hess = bj._gbdt.models[0].internal_weight[0]
    diff = hold_to_jax(bj, bt, X, y, root_hess)
    # the one near tie of these data (module docstring)
    assert diff == ((2, 10) if (name, loop) == ("quantile", "exact")
                    else None)


@pytest.mark.parametrize("name", NEW)
def test_fused_iters_same_bits(name):
    """``fused_iters=4`` gives the trees and training score of
    ``fused_iters=1``, bit for bit; the refitting objectives (L1,
    quantile, MAPE) run blocks of one tree, as the JAX package's
    ``_fused_ok`` excludes them."""
    X, y = _train_data(name, n=2000)
    out = {}
    for fused in (1, 4):
        p = {"objective": name, "num_leaves": 15, "max_bin": 63,
             "verbose": -1, "device_type": "cpu", "fused_iters": fused,
             "wave_splits": True, "hist_refinement": False}
        b = ltt.train(p, ltt.Dataset(X, label=y, params=p),
                      num_boost_round=9)
        out[fused] = b
    renews = tobj.create_objective(name, TConfig({})).renews
    assert renews == (name in ("regression_l1", "quantile", "mape"))
    assert out[4]._gbdt.block_sizes == ([1] * 9 if renews
                                        else [1, 4, 4])
    assert out[4].model_to_string() == out[1].model_to_string()
    np.testing.assert_array_equal(out[4]._gbdt.train_score(),
                                  out[1]._gbdt.train_score())
