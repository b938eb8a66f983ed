"""Training with categorical features: the port (``device_type=cpu``)
against the JAX package (``JAX_PLATFORMS=cpu``).

Data: ``tests/test_consistency.py``'s categorical generator (8,000 rows,
6 numerical columns and 4 categorical ones of 12 levels) plus one column
of 3 levels, which takes the one-vs-other scan (``max_cat_to_onehot`` is
4); the 12-level columns take the sorted many-vs-many scan.  63 leaves,
``max_bin=63``, 4 iterations, on the exact loop and on quantized waves
(W=42, three columns: categorical features turn the two-column passes,
coarse-to-fine and the in-pass routing off), binary and L2; quantized
gradients on both loops, so that histograms are exact integer sums.

Tolerances, and why:

- the merged scan (kernel S's plain version on the numerical features,
  the categorical scan on the rest, one merge) against the JAX
  ``find_best_split`` on the same histograms: the same record (feature,
  kind, left mask, default direction) and bit-equal gains and left
  stats; on a tie across the two scans the lower feature wins, as the
  JAX package's first maximum over all features;
- trees: ``hold_to_jax`` (``tests/test_torch_objectives.py``): identical
  splits (feature, threshold, decision type, children), category sets,
  model text within the slice's numeric tolerance and predictions within
  ``pred_atol``, or, at the first differing split, a near tie: gains
  within rel 1e-5.  The near tie named here (``FLIPS``): the
  many-vs-many scan meets every partition twice, its sorted prefix on
  the left (from the low end) and the same prefix on the right (from
  the high end), at the same candidate index; their gains tie in exact
  arithmetic and float32 rounding picks the side.  On the same
  histograms the port picks the JAX package's side (the scan test), but
  the binary gradients (float64, one rounding) and, from the second tree
  on, the quantized renewal sums (kernel Q's plain version: float64, one
  rounding) differ by an ulp from the JAX package's float32 ones, so the
  histograms differ in their last bits and a side can flip.  On these
  data it does: binary, the first tree's sixth split on the exact loop
  and its eighth on the waves, feature 7 into {9, 10, 11} and the rest
  (gains 51.077454 in the JAX package, 51.07748 and 51.077457 in the
  port); L2 on the exact loop, the second tree's eighth split, feature 6
  into {2, 5, 7} and the rest.  L2 on the waves is identical.  The test
  checks that the first difference is that swap: one categorical
  feature, one row count, disjoint category sets, the children traded.
- the tiers: wave growth on, W = 42, quantized, no two-column passes, no
  coarse-to-fine, routing outside the pass (``SplitParams.any_cat``),
  and an int32 leaf vector on the waves.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as ltt  # noqa: E402
import lightgbm_tpu_torch.ops.grow as tgrow  # noqa: E402
from lightgbm_tpu.ops.split import SplitParams as JSplitParams  # noqa: E402
from lightgbm_tpu.ops.split import find_best_split as jfind  # noqa: E402
from lightgbm_tpu_torch.ops import split as ts  # noqa: E402

from test_torch_objectives import first_difference  # noqa: E402
from test_torch_objectives import hold_to_jax  # noqa: E402

ROUNDS = 4
CATS = "6,7,8,9,10"
# the first differing split, (tree, split), of each configuration: a
# many-vs-many partition whose sides the two packages swap (module
# docstring)
FLIPS = {("binary", "exact"): (0, 5), ("binary", "waves"): (0, 7),
         ("regression", "exact"): (1, 7), ("regression", "waves"): None}
LOOPS = {"exact": {"use_quantized_grad": True},
         "waves": {"wave_splits": True, "use_quantized_grad": True,
                   "min_data_in_leaf": 1}}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cat_data(objective="binary", n=8000):
    """``test_consistency.py``'s generator (seed 11) and a 3-level column."""
    rng = np.random.RandomState(11)
    Xn = rng.randn(n, 6)
    Xc = rng.randint(0, 12, size=(n, 4)).astype(float)
    Xs = rng.randint(0, 3, size=(n, 1)).astype(float)
    X = np.column_stack([Xn, Xc, Xs])
    logit = Xn[:, 0] + 0.9 * np.isin(Xc[:, 0], [2, 5, 7]) - \
        0.6 * (Xc[:, 1] > 8) + 0.3 * Xn[:, 1] + 0.5 * (Xs[:, 0] == 1)
    u = rng.random_sample(n)
    if objective == "regression":
        return X, logit + 0.3 * rng.randn(n)
    return X, (u < 1 / (1 + np.exp(-logit))).astype(float)


def params(objective, loop):
    return {"objective": objective, "num_leaves": 63, "max_bin": 63,
            "verbose": -1, "metric": "None", "categorical_feature": CATS,
            **LOOPS[loop]}


def _cat_sets(tree):
    return [tuple(tree.cat_threshold[tree.cat_boundaries[k]:
                                     tree.cat_boundaries[k + 1]])
            for k in range(tree.num_cat)]


@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_categorical_trees_match_jax(objective, loop):
    X, y = cat_data(objective)
    p = params(objective, loop)
    bj = lgb.train(p, lgb.Dataset(X, label=y, params=p),
                   num_boost_round=ROUNDS, verbose_eval=False)
    pt = dict(p, device_type="cpu")
    bt = ltt.train(pt, ltt.Dataset(X, label=y, params=pt),
                   num_boost_round=ROUNDS)
    g = bt._gbdt
    assert g.grow_params.split.any_cat and g.grow_params.quantize > 0
    assert not g.grow_params.two_col and g.grow_params.refine_shift == 0
    if loop == "waves":
        assert g.grow_params.wave and g.grow_params.speculate == 42
        assert g._state.li_dtype == torch.int32
    mj, mt = bj._gbdt.models, bt.models
    assert sum(t.num_cat for t in mt) > 0
    diff = hold_to_jax(bj, bt, X, y)
    assert diff == FLIPS[objective, loop]
    stop = len(mt) if diff is None else diff[0]
    for a, b in zip(mj[:stop], mt[:stop]):
        assert _cat_sets(a) == _cat_sets(b)
    if diff is not None:
        # the named near tie: one partition of one leaf's rows, its two
        # sides swapped (the category sets are disjoint, the children
        # trade places)
        i, j = diff
        a, b = mj[i], mt[i]
        assert a.decision_type[j] & 1 and b.decision_type[j] & 1
        assert a.split_feature[j] == b.split_feature[j]
        assert a.internal_count[j] == b.internal_count[j]
        assert (a.left_child[j], a.right_child[j]) == \
            (b.right_child[j], b.left_child[j])
        sa = set(a._cat_list(int(a.threshold_bin[j])))
        sb = set(b.cat_list(int(b.threshold_bin[j])))
        assert sa and sb and not sa & sb


def _scan_inputs(seed, F=6, B=32):
    """Histograms of W leaves over F features (0, 2, 3 categorical with 12,
    3 and 9 value bins, 1 and 4 numerical, 5 categorical with a missing
    bin) whose bins sum to each leaf's parent stats, with quantized-like
    values (integers times a float32 scale)."""
    rng = np.random.RandomState(seed)
    nb = np.array([13, 30, 4, 10, 25, 8], np.int32)
    mt = np.array([0, 2, 0, 0, 0, 2], np.int32)
    is_cat = np.array([True, False, True, True, False, True])
    W = 3
    hist = np.zeros((W, F, B, 3), np.float32)
    cnt = rng.randint(0, 300, size=(W, F, B)).astype(np.float32)
    cnt[:, :, 0] = rng.randint(0, 3, size=(W, F))
    for f in range(F):
        cnt[:, f, nb[f]:] = 0
    gi = np.round(rng.randn(W, F, B) * np.sqrt(cnt + 1) * 7)
    hi = np.round(cnt * rng.uniform(3, 5, size=(W, F, B)))
    scale = np.float32(0.0173), np.float32(0.0061)
    hist[..., 0] = (gi * (cnt > 0)).astype(np.float32) * scale[0]
    hist[..., 1] = hi.astype(np.float32) * scale[1]
    hist[..., 2] = cnt
    # one parent for every feature: the last feature's totals, its
    # difference put in each other feature's bin 0
    parent = hist[:, -1].astype(np.float64).sum(1).astype(np.float32)
    for f in range(F - 1):
        hist[:, f, 0] += parent - hist[:, f].astype(np.float64).sum(1)
    return hist, parent, nb, mt, is_cat


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("l2", [0.0, 1.5])
def test_merged_scan_matches_jax_find_best_split(seed, l2):
    hist, parent, nb, mt, is_cat = _scan_inputs(seed)
    W, F, B, _ = hist.shape
    kw = dict(max_bin=B, lambda_l2=l2, min_data_in_leaf=5,
              min_sum_hessian_in_leaf=1e-3, min_data_per_group=30,
              max_cat_threshold=6, cat_smooth=5.0)
    jp = JSplitParams(any_cat=True, any_missing=True, **kw)
    tp = ts.SplitParams(any_cat=True, any_missing=True, **kw)
    fm = np.ones(F, bool)
    fm[4] = seed != 3
    rec = ts.find_best_split_plain(
        torch.as_tensor(hist), torch.as_tensor(parent), torch.as_tensor(nb),
        torch.as_tensor(mt), torch.as_tensor(fm), tp,
        is_cat=torch.as_tensor(is_cat))
    kinds = set()
    for w in range(W):
        r = jfind(jnp.asarray(hist[w]), jnp.asarray(parent[w]),
                  jnp.asarray(nb), jnp.asarray(mt), jnp.asarray(is_cat),
                  jnp.asarray(fm), jp)
        assert int(rec["feature"][w]) == int(r["feature"])
        assert bool(rec["is_cat"][w]) == bool(r["is_cat"])
        assert bool(rec["default_left"][w]) == bool(r["default_left"])
        np.testing.assert_array_equal(rec["left_mask"][w].numpy(),
                                      np.asarray(r["left_mask"]))
        assert float(rec["gain"][w]) == float(r["gain"])
        np.testing.assert_array_equal(rec["left_stats"][w].numpy(),
                                      np.asarray(r["left_stats"]))
        kinds.add(bool(r["is_cat"]))
    assert True in kinds


def test_merge_prefers_the_lower_feature_on_equal_gains():
    def rec(gain, feature):
        return {"gain": torch.tensor([gain]),
                "feature": torch.tensor([feature], dtype=torch.int32),
                "threshold": torch.tensor([feature], dtype=torch.int32),
                "default_left": torch.tensor([False]),
                "left_stats": torch.zeros(1, 3),
                "left_mask": torch.zeros(1, 4, dtype=torch.bool)}

    for (gn, fn), (gc, fc), cat in (((2.0, 3), (2.0, 1), True),
                                    ((2.0, 1), (2.0, 3), False),
                                    ((1.0, 0), (2.0, 5), True),
                                    ((3.0, 5), (2.0, 0), False)):
        out = ts.merge_records(rec(gn, fn), rec(gc, fc))
        assert bool(out["is_cat"][0]) == cat
        assert int(out["feature"][0]) == (fc if cat else fn)


def test_categorical_wave_routes_outside_the_pass():
    """The wave loop's routing on categorical data: no kernel-R call, one
    batched pass (kernel M's plain version here) a wave over the int8
    selector of the smaller children; the serial loop routes by the left
    mask too, and both grow the JAX package's first tree."""
    X, y = cat_data("binary", n=3000)
    calls = {"routed": 0, "multi": 0}
    real_routed, real_multi = tgrow.routed_histogram, tgrow.multi_histogram

    def routed(*a, **k):
        calls["routed"] += 1
        return real_routed(*a, **k)

    def multi(bins, vals, sel, *a, **k):
        calls["multi"] += 1
        assert sel.dtype == torch.int8
        return real_multi(bins, vals, sel, *a, **k)

    tgrow.routed_histogram, tgrow.multi_histogram = routed, multi
    try:
        p = dict(params("binary", "waves"), device_type="cpu")
        bt = ltt.train(p, ltt.Dataset(X, label=y, params=p),
                       num_boost_round=1)
    finally:
        tgrow.routed_histogram, tgrow.multi_histogram = real_routed, \
            real_multi
    assert calls["routed"] == 0
    assert calls["multi"] == bt._gbdt.last_waves + 1
    pj = params("binary", "waves")
    bj = lgb.train(pj, lgb.Dataset(X, label=y, params=pj), num_boost_round=1,
                   verbose_eval=False)
    assert first_difference(bj._gbdt.models, bt.models) is None
    assert _cat_sets(bj._gbdt.models[0]) == _cat_sets(bt.models[0])


def test_cv_and_valid_set_with_categorical_features():
    """``cv`` and a validation set with the categorical parameter, held to
    the JAX package's as the trees are: a fold whose trees are identical
    gives the JAX package's held-out L2 loss within 1e-6 relative (L2:
    its gradients are the JAX package's bits, where binary ones differ by
    an ulp);
    a fold with a differing split meets a near tie there (gains within rel
    1e-5) and nothing after it is compared."""
    X, y = cat_data("regression", n=3000)
    p = dict(params("regression", "exact"), metric="l2", num_leaves=15)
    rj = lgb.cv(p, lgb.Dataset(X, label=y, params=p), num_boost_round=2,
                nfold=3, verbose_eval=False, return_cvbooster=True)
    pt = dict(p, device_type="cpu")
    rt = ltt.cv(pt, ltt.Dataset(X, label=y, params=pt), num_boost_round=2,
                nfold=3, return_cvbooster=True)
    same = 0
    for bj, bt in zip(rj["cvbooster"].boosters, rt["cvbooster"].boosters):
        assert sum(t.num_cat for t in bt.models) > 0
        mj, mt = bj._gbdt.models, bt.models
        diff = first_difference(mj, mt)
        if diff is None:
            same += 1
            (_, _, vj, _), = bj.eval_valid()
            (_, _, vt, _), = bt.eval_valid()
            np.testing.assert_allclose(vt, vj, rtol=1e-6)
        else:
            i, j = diff
            ga, gb = mj[i].split_gain[j], mt[i].split_gain[j]
            assert abs(ga - gb) <= 1e-5 * max(abs(ga), abs(gb))
    assert same >= 1
    res = {}
    tr = ltt.Dataset(X[:2000], label=y[:2000], params=pt)
    bt = ltt.train(pt, tr, num_boost_round=2,
                   valid_sets=[tr.create_valid(X[2000:], label=y[2000:])],
                   evals_result=res, verbose_eval=False)
    resj = {}
    trj = lgb.Dataset(X[:2000], label=y[:2000], params=p)
    bj = lgb.train(p, trj, num_boost_round=2,
                   valid_sets=[trj.create_valid(X[2000:], label=y[2000:])],
                   evals_result=resj, verbose_eval=False)
    assert first_difference(bj._gbdt.models, bt.models) is None
    np.testing.assert_allclose(res["valid_0"]["l2"], resj["valid_0"]["l2"],
                               rtol=1e-6)


def test_categorical_wave_launch_plans():
    """Kernel M at a categorical wave's shape on the Higgs row (W = 42
    three int8 columns, 256 padded bins: a feature's tile is 42 x 256 x 3
    x 4 = 129,024 bytes, one feature a block, one block an SM) and kernel
    Q on its int32 leaf vector: the plans fit, and the plain leaf sums of
    int32 ids are those of the same ids as uint8."""
    from lightgbm_tpu_torch.ops import histogram as th
    from test_torch_kernel_plans import (H100_SMS, HIGGS,  # noqa: E402
                                         _check_group_plan, _check_leaf_plan)
    F, _, N = HIGGS
    assert 42 * 256 * 3 * 4 == 129_024 < th._SMEM_MAX
    plan = _check_group_plan(F, 256, 42, 3, 4, N, H100_SMS, 1)
    assert plan["fpb"] == 1 and plan["groups"] == F
    _check_leaf_plan(N, 255, H100_SMS)
    rng = np.random.RandomState(0)
    li = torch.from_numpy(rng.randint(0, 255, 10_000).astype(np.int32))
    g, h = (torch.from_numpy(rng.randn(10_000).astype(np.float32))
            for _ in range(2))
    m = torch.ones(10_000)
    assert torch.equal(th.leaf_stats(li, g, h, m, 255),
                       th.leaf_stats(li.to(torch.uint8), g, h, m, 255))
