"""Training on bundled features: the port (``device_type=cpu``) against the
JAX package (``JAX_PLATFORMS=cpu``), both bundling by default.

Data: ``tests/test_efb.py``'s one-hot generator (3,000 rows, 8 blocks of 6
indicator columns, ``RandomState(0)``), its label above its median
(binary) or in its terciles (softmax, 3 classes); 15 leaves,
``max_bin=63``, ``min_data_in_leaf=0``, ``min_sum_hessian_in_leaf=1``, 3
rounds, on the exact loop (float histograms), on the exact loop with
quantized gradients and on quantized waves (three-column W = 15: bundles turn off the two-column passes, coarse to
fine and the in-pass routing, and the wave's rows are routed outside the
pass through their features' bundle columns).  Both packages bundle the
48 columns into 8 groups at a committed width of 7 bins.  Before the port
bundled, its waves split on other features than the JAX package's in
every tree (3 of 3; the predictions 0.094 apart) and its exact loop split
alike on this label; ``test_unbundled_trees_differed`` keeps that record
on the port's unbundled run.

Tolerances: ``hold_to_jax`` (``tests/test_torch_objectives.py``):
identical splits (feature, threshold, decision type, children), model
text within rtol 1e-5 plus 1e-6 of a scale, predictions within 1e-5 of
their reach, or a near tie at the first differing split (gains within rel
1e-5).  The scale is the row count times the largest unshrunk leaf output
(``tests/test_torch_multiclass.py`` ``_gain_scale``): on the exact loop
the histograms are float sums, which the port rounds once from float64
and the JAX package adds in float32 row by row (``ROADMAP.md`` Queue 3
item 10), and a split gain's float32 error is about twice the leaf output
times its gradient sum's; the split gains of the binary exact cell differ
by up to rel 8.1e-4 (a gain of 1.285 against 1.286), 2.9e-5 on a gain of
204 (the unbundled cell: up to rel 1.4e-3).  The quantized waves' binary
gains are equal.  The near ties (``FIRST_DIFF``): softmax on the waves,
bundled or not, at the first tree's second node, whose gains agree to rel
2.4e-7 (the softmax gradients are float64 rounded once in the port and
float32 in the JAX package, so the quantization's scale and one rounding
differ, and the next split is one of gain ~1e-5, at the quantized
histograms' resolution); the categorical cell on both exact loops at
the third tree's eighth split (float histograms: gains 18.727384 and
18.727324, rel 3.3e-6; the bundles' default bins are rebuilt from the
float sums above, and the quantized loop's renewed leaf values are float
sums too).  The
default bins the bundles skip are rebuilt in the JAX package's float32
order (``ops/grow.py`` ``bin_sum``).  A validation set is bundled too
(its (G, n) matrix), routed by kernel T's plain version on records
translated onto bundle columns: its score equals the trees' prediction
within 1e-6 (float32 leaf values added in float64), DART's too, and the
JAX package's valid score within the predictions' 1e-5 of their reach.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as ltt  # noqa: E402
from test_efb import _sparse_onehot_data  # noqa: E402
from test_torch_multiclass import _gain_scale  # noqa: E402
from test_torch_objectives import hold_to_jax  # noqa: E402

ROUNDS = 3
PARAMS = {"num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 0,
          "min_sum_hessian_in_leaf": 1, "verbose": -1, "metric": "None"}
LOOPS = {"exact": {},
         "quantized exact": {"use_quantized_grad": True},
         "waves": {"wave_splits": True, "use_quantized_grad": True}}
OBJECTIVES = {"binary": {"objective": "binary"},
              "softmax": {"objective": "multiclass", "num_class": 3}}
# trees whose splits differed from the JAX package's bundled ones while
# the port did not bundle (module docstring)
UNBUNDLED_DIFFERED = {"exact": 0, "quantized exact": 0, "waves": 3}
# the near ties at the first differing split, (tree, node) (module
# docstring); None: identical trees
FIRST_DIFF = {("binary", "exact"): None, ("binary", "quantized exact"): None,
              ("binary", "waves"): None, ("softmax", "exact"): None,
              ("softmax", "quantized exact"): None,
              ("softmax", "waves"): (0, 1), ("categorical", "exact"): (2, 7),
              ("categorical", "quantized exact"): (2, 7),
              ("categorical", "waves"): None}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def onehot(objective="binary", n=3000, seed=0):
    X, y = _sparse_onehot_data(np.random.RandomState(seed), n=n)
    if objective == "softmax":
        return X, np.digitize(y, np.quantile(y, [1 / 3, 2 / 3])).astype(
            float)
    return X, (y > np.median(y)).astype(float)


def with_categorical(n=3000):
    """The one-hot blocks, a 5-level categorical column and a numerical
    column with 10% NaN; the label from all three."""
    rng = np.random.RandomState(7)
    X, y = _sparse_onehot_data(rng, n=n)
    cat = rng.randint(0, 5, size=n).astype(float)
    num = rng.randn(n)
    num[rng.rand(n) < 0.1] = np.nan
    y = y + 0.5 * np.isin(cat, [1, 3]) + 0.3 * np.nan_to_num(num)
    return np.column_stack([X, cat, num]), (y > np.median(y)).astype(float)


def _train(X, y, params, rounds=ROUNDS):
    bj = lgb.train(params, lgb.Dataset(X, label=y, params=params),
                   num_boost_round=rounds, verbose_eval=False)
    pt = dict(params, device_type="cpu")
    bt = ltt.train(pt, ltt.Dataset(X, label=y, params=pt),
                   num_boost_round=rounds)
    return bj, bt


def _assert_bundled(bj, bt, loop):
    gj, gt = bj._gbdt, bt._gbdt
    assert gj._bundles is not None and gt._bundles is not None
    assert gt._bundles.groups == gj._bundles.groups
    assert gt.max_bin == gj.max_bin
    gp = gt.grow_params
    assert not gp.two_col and gp.refine_shift == 0
    if loop == "waves":
        assert gp.wave and gp.quantize > 0 and gt._state.route_outside
        assert gt._state.li_dtype == torch.int32


@pytest.mark.parametrize("objective", list(OBJECTIVES))
@pytest.mark.parametrize("loop", list(LOOPS))
def test_bundled_trees_match_jax(loop, objective):
    X, y = onehot(objective)
    p = dict(PARAMS, **OBJECTIVES[objective], **LOOPS[loop])
    bj, bt = _train(X, y, p)
    _assert_bundled(bj, bt, loop)
    assert bt._gbdt._bundles.num_groups == 8 and bt._gbdt.max_bin == 7
    diff = hold_to_jax(bj, bt, X, y, _gain_scale(bj, len(y)))
    assert diff == FIRST_DIFF[objective, loop]


@pytest.mark.parametrize("loop", list(LOOPS))
def test_unbundled_trees_differed(loop):
    """The fault bundling mends: the port's unbundled trees split on other
    features than the JAX package's bundled ones in 3 of 3 trees on the
    waves, where its bundled trees split alike (on the exact loop both
    split alike on these data)."""
    X, y = onehot()
    p = dict(PARAMS, objective="binary", **LOOPS[loop])
    bj, bt = _train(X, y, p)
    pt = dict(p, device_type="cpu", enable_bundle=False)
    bu = ltt.train(pt, ltt.Dataset(X, label=y, params=pt),
                   num_boost_round=ROUNDS)
    assert bu._gbdt._bundles is None
    feats = [list(t.split_feature[:t.num_leaves - 1])
             for t in bj._gbdt.models]
    assert [list(t.split_feature[:t.num_leaves - 1])
            for t in bt.models] == feats
    differ = sum(list(t.split_feature[:t.num_leaves - 1]) != f
                 for t, f in zip(bu.models, feats))
    assert differ == UNBUNDLED_DIFFERED[loop]


@pytest.mark.parametrize("loop", list(LOOPS))
def test_categorical_and_missing_beside_bundles(loop):
    """A categorical column (default bin 0 in the bundling) and NaNs
    beside the one-hot blocks: categorical scans on expanded histograms."""
    X, y = with_categorical()
    p = dict(PARAMS, objective="binary", categorical_feature="48",
             **LOOPS[loop])
    bj, bt = _train(X, y, p)
    _assert_bundled(bj, bt, loop)
    gp = bt._gbdt.grow_params
    assert gp.split.any_cat and gp.split.any_missing
    diff = hold_to_jax(bj, bt, X, y, _gain_scale(bj, len(y)))
    assert diff == FIRST_DIFF["categorical", loop]
    n_cat = [t.num_cat for t in bt.models]
    assert n_cat == [t.num_cat for t in bj._gbdt.models]
    # the exact loops split on the categorical column (the waves' trees,
    # the JAX package's too, choose the numerical and one-hot ones)
    assert (sum(n_cat) > 0) == (loop != "waves")


@pytest.mark.parametrize("boosting", ["gbdt", "dart"])
@pytest.mark.parametrize("loop", list(LOOPS))
def test_bundled_valid_set_scores(loop, boosting):
    """A validation set bundled with the training set's groups: its
    (G, n) matrix, its score the served trees' prediction within 1e-6 and
    the JAX package's valid score within 1e-5 of its reach."""
    X, y = onehot(n=4000)
    Xt, yt, Xv, yv = X[:3000], y[:3000], X[3000:], y[3000:]
    p = dict(PARAMS, objective="binary", metric="auc", boosting=boosting,
             **LOOPS[loop])
    rj, rt = {}, {}
    tj = lgb.Dataset(Xt, label=yt, params=p)
    bj = lgb.train(p, tj, num_boost_round=4, valid_sets=[
        lgb.Dataset(Xv, label=yv, reference=tj)], evals_result=rj,
        verbose_eval=False)
    pt = dict(p, device_type="cpu")
    tt = ltt.Dataset(Xt, label=yt, params=pt)
    bt = ltt.train(pt, tt, num_boost_round=4,
                   valid_sets=[tt.create_valid(Xv, label=yv)],
                   evals_result=rt)
    _assert_bundled(bj, bt, loop)
    vs = bt._gbdt.valid_sets[0]
    assert tuple(vs.xt.shape) == (bt._gbdt._bundles.num_groups, len(yv))
    score = vs.score.numpy()
    np.testing.assert_allclose(score, bt.predict(Xv, raw_score=True),
                               rtol=0, atol=1e-6)
    jscore = np.asarray(bj._gbdt.valid_sets[0].score).reshape(-1)
    np.testing.assert_allclose(score, jscore, rtol=0, atol=1e-5 * max(
        1.0, float(np.abs(jscore).max())))
    assert len(rt["valid_0"]["auc"]) == len(rj["valid_0"]["auc"]) == 4
