"""Training under monotone constraints and the feature penalty on the
exact loop: the port (``device_type=cpu``) against the JAX package
(``JAX_PLATFORMS=cpu``).

Data: 3,000 rows of 6 features with 5% NaN, the label ``x0 + 0.5 x1 - 0.3
x2 + sin(3 x3)`` plus noise above its median (binary; L1 on the value,
softmax on its terciles); ``monotone_constraints=[1, 1, -1, 0, 0, 0]``,
``feature_contri=[1, 1, 1, 0.5, 1, 1]``; 31 leaves, ``max_bin=63``, 3
rounds.  The categorical cell makes x4 an 8-level and x5 a 3-level
categorical column (the constraint stays on x0-x2: categorical splits
clip to the bounds and carry no direction); the bundled cell is
``tests/test_efb.py``'s one-hot blocks beside two numerical columns with
10% NaN, the constraint on 3 indicator columns and both numerical ones.

Contract, and why:

- trees: ``hold_to_jax`` (``tests/test_torch_objectives.py``): identical
  splits, model text within rtol 1e-5 plus 1e-6 of the root's sums,
  predictions within 1e-5, or a near tie at the first differing split.
  Two near ties occur (``FIRST_DIFF``), neither of the constraints' making:
  the categorical cell's float exact loop at the second tree's third
  split, a many-vs-many partition on x4 whose gains agree to rel 6.3e-6
  (116.508438 and 116.507706: float histograms, Queue 3 item 10; the same
  cell unconstrained trades sides at the second tree's second split, rel
  1.0e-6); and softmax, whose gradients the port rounds once from float64
  and the JAX package computes in float32, so that its histograms, and
  the gains of identical splits, differ by up to rel 7.9e-6 (abs 1.2e-4)
  in every tree, constrained or not: the third tree's seventeenth split
  goes to another leaf of equal feature and threshold at gains 1.054428
  and 1.054413 (rel 1.4e-5), which this file holds within rel 2e-5, twice
  the identical splits' largest difference.
- each split's children's bounds (``rec_left_min`` ... in the JAX
  package, ``left_min`` ... in the port): the same infinities, and the
  finite ones bit for bit on the first tree of the quantized loops
  (their histograms are integers times a scale, equal in both packages),
  within rel 1e-5 elsewhere (float histograms: Queue 3 item 10's float32
  order).
- the first tree's split gains: bit for bit on the quantized loops.
  Under the monotone clip the reference's CPU compile fuses other
  products of a gain at each site of the loop (``ops/split.py``
  ``_CLIP_FUSION``: the root keeps its unconstrained order, the exact
  loop's step fuses the first product in both default directions, and
  with categorical features present its one-vs-other scan the second and
  its dequantized subtraction stays fused); these cells are where those
  sites were probed, 4 seeds of 30 splits each for every loop, 40 roots.
- the penalty alone compiles no clip: the unconstrained order holds.
- monotonicity, swept over each constrained feature's range for 64 rows:
  the float exact loop's trees never step against a constraint.  Under
  quantized gradients the leaf values are renewed from the
  full-precision sums without the clip, as the JAX package renews them
  (``lightgbm_tpu/ops/grow.py:1771-1790``, ``models/gbdt.py:98-104``),
  so a renewed tree can step against its constraint by a little, in
  both packages alike (``ROADMAP.md`` Queue 3, a quirk copied on
  purpose): there the trees built from the clipped values before the
  renewal are held monotone, and the renewed ones are counted.
- on ``tests/test_constraints.py:15-37``'s generator the
  port's predictions never step against a constraint (1e-10), as the
  JAX package's do, and an unconstrained run on the same wiggly target
  does, so the check can fail.
- the leaf renewal of L1 (``objectives.py``) refits the leaves as
  percentiles without the clip, as the JAX package's
  ``_RenewableRegression.renew_tree_output`` does
  (``lightgbm_tpu/objectives.py:222-239``); the trees are held as above.
"""
import contextlib
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu.models.gbdt as jgbdt  # noqa: E402
import lightgbm_tpu_torch as ltt  # noqa: E402
import lightgbm_tpu_torch.models.gbdt as tgbdt  # noqa: E402
from lightgbm_tpu_torch.ops.predict import flatten_forest, predict_raw  # noqa: E402
from test_constraints import _is_correctly_constrained, _monotone_data  # noqa: E402
from test_torch_objectives import hold_to_jax  # noqa: E402

MONO = [1, 1, -1, 0, 0, 0]
PEN = [1, 1, 1, 0.5, 1, 1]
BASE = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
        "verbose": -1, "metric": "None", "monotone_constraints": MONO,
        "feature_contri": PEN}
BOUNDS = ("left_min", "left_max", "right_min", "right_max")
BOUND_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def monotone_data(seed=0, n=3000, F=6, cat=False, label="binary"):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n, F) < 0.05] = np.nan
    z = np.nan_to_num(X)
    y = z[:, 0] + 0.5 * z[:, 1] - 0.3 * z[:, 2] + np.sin(3 * z[:, 3]) + \
        0.3 * rng.randn(n)
    if cat:
        X[:, 4] = rng.randint(0, 8, n)
        X[:, 5] = rng.randint(0, 3, n)
        y = y + 1.5 * np.isin(X[:, 4], [1, 3, 5]) - 1.0 * (X[:, 5] == 2)
    if label == "value":
        return X, y
    if label == "terciles":
        return X, np.digitize(y, np.quantile(y, [1 / 3, 2 / 3])).astype(float)
    return X, (y > np.median(y)).astype(float)


def bundled_data(seed=0, n=3000):
    from test_efb import _sparse_onehot_data
    rng = np.random.RandomState(seed)
    X, y = _sparse_onehot_data(rng, n=n)
    num = rng.randn(n, 2)
    num[rng.rand(n, 2) < 0.1] = np.nan
    y = y + 0.4 * np.nan_to_num(num[:, 0]) - 0.2 * np.nan_to_num(num[:, 1])
    return np.column_stack([X, num]), (y > np.median(y)).astype(float)


# the bundled cell's constraints over its 50 original columns
BUNDLED = {"monotone_constraints": [1, -1, 0, 0, 0, 0, 1] + [0] * 41 + [1, -1],
           "feature_contri": [1.0] * 12 + [0.5] + [1.0] * 37,
           "min_data_in_leaf": 0, "min_sum_hessian_in_leaf": 1}


@contextlib.contextmanager
def records():
    """The records each package turns into a host tree, in tree order:
    (the JAX package's, the port's)."""
    jrec, trec = [], []
    jfn, tfn = jgbdt.records_to_tree, tgbdt.records_to_tree

    def jwrap(rec, *a, **k):
        jrec.append({n: np.asarray(v) for n, v in rec.items()})
        return jfn(rec, *a, **k)

    def twrap(rec, *a, **k):
        trec.append({n: np.asarray(v) for n, v in rec.items()})
        return tfn(rec, *a, **k)

    jgbdt.records_to_tree, tgbdt.records_to_tree = jwrap, twrap
    try:
        yield jrec, trec
    finally:
        jgbdt.records_to_tree, tgbdt.records_to_tree = jfn, tfn


def train_both(X, y, params, rounds=3):
    """(JAX booster, port booster, JAX records, port records)."""
    with records() as (jrec, trec):
        bj = lgb.train(params, lgb.Dataset(X, label=y, params=params),
                       num_boost_round=rounds, verbose_eval=False)
        pt = dict(params, device_type="cpu")
        bt = ltt.train(pt, ltt.Dataset(X, label=y, params=pt),
                       num_boost_round=rounds)
        _ = bj._gbdt.models, bt.models      # land every tree
    return bj, bt, jrec, trec


def assert_bounds(jrec, trec, exact_first):
    """Each split's children's bounds: the same infinities; the finite ones
    bit for bit on the first tree where ``exact_first``, else within rel
    BOUND_RTOL.  -> the count of finite bounds of the first tree."""
    assert len(jrec) == len(trec)
    finite = 0
    for i, (a, b) in enumerate(zip(jrec, trec)):
        n = int(np.sum(a["valid"]))
        assert n == int(np.sum(b["valid"]))
        for k in BOUNDS:
            ja, tb = a["rec_" + k][:n], b[k][:n]
            np.testing.assert_array_equal(np.isinf(ja), np.isinf(tb), k)
            np.testing.assert_array_equal(ja[np.isinf(ja)], tb[np.isinf(tb)])
            fin = np.isfinite(ja)
            if i == 0:
                finite += int(fin.sum())
            if i == 0 and exact_first:
                np.testing.assert_array_equal(ja, tb, k)
            else:
                np.testing.assert_allclose(tb[fin], ja[fin], rtol=BOUND_RTOL,
                                           atol=1e-7, err_msg=k)
    return finite


def first_tree_gains_equal(bj, bt):
    a, b = bj._gbdt.models[0], bt.models[0]
    n = a.num_leaves - 1
    assert b.num_leaves == a.num_leaves
    np.testing.assert_array_equal(np.asarray(b.split_gain[:n]),
                                  np.asarray(a.split_gain[:n]))


def sweep_violations(trees, X, feats, signs, rows=64, k=1):
    """(steps that break a constraint, largest break) of the trees'
    raw prediction when each constrained feature sweeps its observed
    range (40 points) with the other features of ``rows`` base rows
    fixed."""
    ff = flatten_forest(trees, torch.device("cpu"))
    base = X[:rows]
    bad, worst = 0, 0.0
    for f, s in zip(feats, signs):
        col = X[:, f][np.isfinite(X[:, f])]
        grid = np.linspace(col.min(), col.max(), 40)
        M = np.repeat(base, len(grid), axis=0)
        M[:, f] = np.tile(grid, rows)
        pred = predict_raw(ff, M, torch.device("cpu"), k).cpu().numpy()
        step = np.diff(pred.reshape(rows, len(grid)), axis=1) * s
        bad += int(np.sum(step < -1e-10))
        worst = max(worst, float(-step.min()))
    return bad, worst


LOOPS = {"exact": {}, "quantized exact": {"use_quantized_grad": True}}
# near ties at the first differing split, (tree, split) (module docstring)
FIRST_DIFF = {"categorical exact": (1, 2), "softmax": (2, 16)}
SOFTMAX_TIE_RTOL = 2e-5


def pre_renewal_trees(bt, trec):
    """The port's trees from its records without the renewal: the clipped
    leaf values of the loop."""
    g = bt._gbdt
    return [tgbdt.records_to_tree({k: v for k, v in r.items()
                                   if k != "leaf_stats_exact"}, g.config,
                                  bt.train_set._constructed)
            for r in trec]


def assert_monotone(bt, trec, X, feats, signs):
    """The trees keep the constraints; quantized, the trees before the
    renewal do, and the renewed ones' breaks are counted -> (breaks,
    largest) of the trees as served."""
    served = sweep_violations(bt.models, X, feats, signs)
    if "leaf_stats_exact" not in trec[0]:
        assert served[0] == 0, served
    else:
        assert sweep_violations(pre_renewal_trees(bt, trec), X, feats,
                                signs)[0] == 0
    return served


@pytest.mark.parametrize("loop", list(LOOPS))
def test_exact_loop_matches_jax(loop):
    X, y = monotone_data()
    p = dict(BASE, **LOOPS[loop])
    bj, bt, jrec, trec = train_both(X, y, p)
    sp = bt._gbdt.grow_params.split
    assert sp.has_monotone and sp.has_penalty and not bt._gbdt._state.wave
    assert sp.monotone == tuple(MONO) and sp.penalty == tuple(PEN)
    assert hold_to_jax(bj, bt, X, y) is None
    quantized = loop != "exact"
    assert assert_bounds(jrec, trec, quantized) > 10
    if quantized:
        first_tree_gains_equal(bj, bt)
    breaks, _ = assert_monotone(bt, trec, X, [0, 1, 2], [1, 1, -1])
    # the renewal steps against the constraints in the JAX package too
    assert (breaks > 0) == quantized
    if quantized:
        assert sweep_violations(bj._gbdt.models, X, [0, 1, 2],
                                [1, 1, -1])[0] > 0


def test_penalty_alone_keeps_the_unconstrained_order():
    """No clip: the unconstrained fusion; the quantized first tree's gains
    bit for bit, and the penalized feature (x3, 0.5) splits less often
    than without the penalty."""
    X, y = monotone_data()
    p = dict(BASE, use_quantized_grad=True)
    p.pop("monotone_constraints")
    bj, bt, jrec, trec = train_both(X, y, p)
    sp = bt._gbdt.grow_params.split
    assert sp.has_penalty and not sp.has_monotone
    assert "left_min" not in trec[0] and "rec_left_min" not in jrec[0]
    assert hold_to_jax(bj, bt, X, y) is None
    first_tree_gains_equal(bj, bt)
    p.pop("feature_contri")
    free = ltt.train(dict(p, device_type="cpu"),
                     ltt.Dataset(X, label=y, params=dict(p,
                                                         device_type="cpu")),
                     num_boost_round=3)

    def on_x3(b):
        return sum(int(np.sum(np.asarray(t.split_feature[:t.num_leaves - 1])
                              == 3)) for t in b.models)
    assert on_x3(bt) < on_x3(free)


@pytest.mark.parametrize("quantized", [False, True])
def test_categorical_exact_loop(quantized):
    X, y = monotone_data(cat=True)
    p = dict(BASE, categorical_feature="4,5",
             use_quantized_grad=quantized)
    bj, bt, jrec, trec = train_both(X, y, p)
    assert bt._gbdt.grow_params.split.any_cat
    diff = hold_to_jax(bj, bt, X, y)
    assert diff == (None if quantized else FIRST_DIFF["categorical exact"])
    assert sum(t.num_cat for t in bt.models) > 0
    assert assert_bounds(jrec[:1], trec[:1], quantized) > 10
    if quantized:
        first_tree_gains_equal(bj, bt)
    assert_monotone(bt, trec, X, [0, 1, 2], [1, 1, -1])


def test_bundled_exact_loop():
    """Bundled features: the constraints index logical features (the 50
    original columns), never bundles."""
    X, y = bundled_data()
    p = dict(BASE, use_quantized_grad=True, **BUNDLED)
    bj, bt, jrec, trec = train_both(X, y, p)
    g = bt._gbdt
    assert g._bundles is not None and g._bundles.num_groups < 50
    assert len(g.grow_params.split.monotone) == 50
    assert hold_to_jax(bj, bt, X, y) is None
    assert assert_bounds(jrec, trec, True) > 0
    first_tree_gains_equal(bj, bt)


def test_softmax_three_classes():
    X, y = monotone_data(label="terciles")
    p = dict(BASE, objective="multiclass", num_class=3,
             use_quantized_grad=True)
    bj, bt, jrec, trec = train_both(X, y, p, rounds=2)
    assert bt.num_tree_per_iteration == 3 and len(trec) == 6
    from test_torch_objectives import first_difference
    mj, mt = bj._gbdt.models, bt.models
    i, j = first_difference(mj, mt)
    assert (i, j) == FIRST_DIFF["softmax"]
    ga, gb = mj[i].split_gain[j], mt[i].split_gain[j]
    assert mj[i].split_feature[j] == mt[i].split_feature[j]
    assert abs(ga - gb) <= SOFTMAX_TIE_RTOL * abs(ga)
    # the trees before it: their splits' bounds within the histograms'
    # resolution, every tree's splits alike up to it
    assert_bounds(jrec[:i], trec[:i], False)
    for t in range(i):
        n = mj[t].num_leaves
        np.testing.assert_allclose(mt[t].leaf_value[:n], mj[t].leaf_value[:n],
                                   rtol=1e-4, atol=1e-6)
    assert_monotone(bt, trec, X, [0, 1, 2], [1, 1, -1])


def test_l1_renews_without_the_clip():
    """L1's percentile renewal replaces the clipped leaf values, in both
    packages."""
    X, yv = monotone_data(label="value")
    p = dict(BASE, objective="regression_l1")
    bj, bt, jrec, trec = train_both(X, yv, p)
    assert bt._gbdt._per_tree_host
    assert hold_to_jax(bj, bt, X, yv) is None
    assert_bounds(jrec, trec, False)
    # the host trees' values are the renewal's, not the clipped ones
    rec = dict(trec[1])
    clipped = tgbdt.records_to_tree(rec, bt._gbdt.config,
                                    bt.train_set._constructed)
    n = clipped.num_leaves
    assert not np.allclose(clipped.leaf_value[:n] * 0.1,
                           bt.models[1].leaf_value[:n])


def test_monotone_generator_is_kept_and_the_check_can_fail():
    """``tests/test_constraints.py``'s check on the port's trees."""
    X, y = _monotone_data(np.random.RandomState(42))
    p = {"objective": "regression", "monotone_constraints": [1, -1, 0],
         "num_leaves": 31, "min_data_in_leaf": 20, "verbose": -1,
         "device_type": "cpu"}
    b = ltt.train(p, ltt.Dataset(X, label=y, params=p), num_boost_round=30)
    assert _is_correctly_constrained(b)
    p.pop("monotone_constraints")
    un = ltt.train(p, ltt.Dataset(X, label=y, params=p), num_boost_round=30)
    assert not _is_correctly_constrained(un)


@pytest.mark.parametrize("mono_alias,pen_alias", [
    ("mc", "fp"), ("monotone_constraint", "feature_contrib"),
    ("monotone_constraints", "fc"), ("mc", "feature_penalty")])
def test_aliases(mono_alias, pen_alias):
    X, y = monotone_data(n=500)
    p = {"objective": "binary", "verbose": -1, "device_type": "cpu",
         "num_leaves": 7, mono_alias: MONO, pen_alias: PEN}
    b = ltt.train(p, ltt.Dataset(X, label=y, params=p), num_boost_round=1)
    sp = b._gbdt.grow_params.split
    assert sp.monotone == tuple(MONO) and sp.penalty == tuple(PEN)
