"""DART of the port against the JAX package's DART, on the CPU.

Both packages train the same data, 12 rounds with a validation set, on
the exact loop (binary, 15 leaves) and on float waves (L2, 15 leaves,
``hist_refinement=false``), in DART's three modes: weighted drops (the
default), uniform drops with ``max_drop=2``, and xgboost mode; each with
``drop_rate=0.3`` and ``skip_drop=0.2`` (weighted: 0).  The contract,
and why:

- the same trees dropped at every iteration (both packages draw from a
  numpy ``RandomState`` seeded with ``drop_seed``), the same
  ``tree_weight`` and ``sum_weight`` (exact: host arithmetic on the same
  numbers) and the same shrinkage in every tree's text;
- the same tree structure (split features, thresholds, decision types,
  children, counts); leaf values within 1e-5 absolute and 1e-4 relative:
  gbdt's leaf values on this data differ from the reference's by up to
  3e-5 relative (the port sums histograms in float64 and rounds once, the
  reference in float32), and DART's drops and renormalization add host
  float64 arithmetic on the same numbers;
- training and validation scores within 1e-5 of the reference's; the
  training score within 1e-5 and the validation score within 1e-9 of the
  port's own prediction of its trees;
- after ``rollback_one_iter`` the scores within 1e-5 of the reference's
  after its rollback, the model one tree shorter, and the model and the
  scores agreeing as above.

A test marked ``cuda`` holds DART on the card's CUDA graphs to its eager
launches and to the CPU, and skips here.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu_torch as ltt  # noqa: E402

ROUNDS = 12
PATHS = {
    "exact": {"objective": "binary", "num_leaves": 15, "max_bin": 63},
    "float waves": {"objective": "regression", "num_leaves": 15,
                    "max_bin": 63, "wave_splits": True,
                    "hist_refinement": False},
}
MODES = {
    "weighted": {"skip_drop": 0.0},
    "uniform": {"uniform_drop": True, "max_drop": 2, "skip_drop": 0.2},
    "xgboost": {"xgboost_dart_mode": True, "skip_drop": 0.2},
}
STRUCTURE = ("split_feature", "threshold_bin", "decision_type", "left_child",
             "right_child")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def data(path, seed=11, n=2000, F=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n + 500, F)
    X[rng.rand(n + 500) < 0.1, 3] = np.nan
    Xn = np.nan_to_num(X)
    y = Xn[:, 0] + 0.5 * Xn[:, 1] - 0.7 * Xn[:, 2] * Xn[:, 3] + \
        0.3 * rng.randn(n + 500)
    if PATHS[path]["objective"] == "binary":
        y = (y > 0).astype(np.float64)
    return X[:n], y[:n], X[n:], y[n:]


def params(path, extra):
    return {"verbose": -1, "metric": "None", **PATHS[path], **extra}


def _spy_drops(g, drops):
    select = g._select_drops

    def spy():
        select()
        drops.append(list(g._drop_index))

    g._select_drops = spy


def train_both(p, path, rounds=ROUNDS):
    """(JAX booster, port booster, drops of each) after ``rounds``
    iterations with the held-out rows as a validation set."""
    import lightgbm_tpu as lgb
    X, y, Xv, yv = data(path)
    bj = lgb.Booster(params=p, train_set=lgb.Dataset(X, label=y, params=p))
    bj.add_valid(lgb.Dataset(Xv, label=yv, reference=bj.train_set), "v")
    pt = dict(p, device_type="cpu")
    dt = ltt.Dataset(X, label=y, params=pt)
    bt = ltt.Booster(params=pt, train_set=dt)
    bt.add_valid(dt.create_valid(Xv, label=yv), "v")
    drops = ([], [])
    for b, d in zip((bj, bt), drops):
        _spy_drops(b._gbdt, d)
        for _ in range(rounds):
            b.update()
    return bj, bt, drops


def assert_same_model(bj, bt):
    mj, mt = bj._gbdt.models, bt.models
    assert len(mj) == len(mt)
    for i, (a, b) in enumerate(zip(mj, mt)):
        assert a.num_leaves == b.num_leaves, i
        n = a.num_leaves - 1
        for k in STRUCTURE:
            np.testing.assert_array_equal(getattr(a, k)[:n],
                                          getattr(b, k)[:n], f"{i} {k}")
        np.testing.assert_array_equal(a.leaf_count[:n + 1],
                                      b.leaf_count[:n + 1])
        assert a.shrinkage == b.shrinkage, i
        np.testing.assert_allclose(b.leaf_value[:n + 1], a.leaf_value[:n + 1],
                                   rtol=1e-4, atol=1e-5, err_msg=str(i))


def assert_scores(bj, bt, X, Xv):
    gj, gt = bj._gbdt, bt._gbdt
    train, valid = gt.train_score(), gt.valid_sets[0].score.numpy()
    np.testing.assert_allclose(train, np.asarray(gj.train_score[0]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(valid, gj.valid_sets[0].score[0], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(train, bt.predict(X, raw_score=True),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(valid, bt.predict(Xv, raw_score=True),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("path", list(PATHS))
def test_dart_matches_jax(path, mode):
    p = params(path, {"boosting": "dart", "drop_rate": 0.3, **MODES[mode]})
    bj, bt, (dj, dt) = train_both(p, path)
    X, _, Xv, _ = data(path)
    gj, gt = bj._gbdt, bt._gbdt
    assert dj == dt
    assert sum(len(d) for d in dt) >= 4          # trees were dropped
    assert gt.tree_weight == gj.tree_weight
    assert gt.sum_weight == gj.sum_weight
    assert not gt._fused_ok() and gt.block_sizes == [1] * ROUNDS
    assert_same_model(bj, bt)
    assert_scores(bj, bt, X, Xv)
    # the kept leaf ids: uint8 at 15 leaves, one a tree
    assert len(gt._train_leaf_idx) == ROUNDS
    assert all(la.dtype == torch.uint8 for la in gt._train_leaf_idx)
    assert len(gt.valid_sets[0].leaf_idx_per_tree) == ROUNDS
    for b in (bj, bt):
        b.rollback_one_iter()
    assert len(bt.models) == ROUNDS - 1 and gt.iter == gj.iter == ROUNDS - 1
    assert_same_model(bj, bt)
    assert_scores(bj, bt, X, Xv)
    # a second rollback has no snapshot left
    bt.rollback_one_iter()
    assert len(bt.models) == ROUNDS - 1


def test_dart_trains_on_after_rollback_as_jax_does():
    p = params("exact", {"boosting": "dart", "drop_rate": 0.5,
                         "skip_drop": 0.0})
    bj, bt, _ = train_both(p, "exact", rounds=6)
    X, _, Xv, _ = data("exact")
    for b in (bj, bt):
        b.rollback_one_iter()
        for _ in range(3):
            b.update()
    assert_same_model(bj, bt)
    assert_scores(bj, bt, X, Xv)


def test_dart_valid_set_attached_mid_training():
    """A set attached after 4 rounds takes the earlier trees from their
    prediction, so later drops reach it as they reach one attached
    first."""
    p = dict(params("exact", {"boosting": "dart", "drop_rate": 0.5,
                              "skip_drop": 0.0}), device_type="cpu")
    X, y, Xv, yv = data("exact")
    boosters = []
    for late in (False, True):
        dt = ltt.Dataset(X, label=y, params=p)
        b = ltt.Booster(params=p, train_set=dt)
        if not late:
            b.add_valid(dt.create_valid(Xv, label=yv), "v")
        for i in range(8):
            if late and i == 4:
                b.add_valid(dt.create_valid(Xv, label=yv), "v")
            b.update()
        boosters.append(b)
    a, b = (x._gbdt for x in boosters)
    assert a.tree_weight == b.tree_weight
    np.testing.assert_allclose(b.valid_sets[0].score.numpy(),
                               a.valid_sets[0].score.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(b.valid_sets[0].score.numpy(),
                               boosters[1].predict(Xv, raw_score=True),
                               rtol=0, atol=1e-9)


@pytest.mark.cuda
def test_dart_graphs_match_eager_and_cpu_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = params("float waves", {"boosting": "dart", "drop_rate": 0.3,
                               "skip_drop": 0.0})
    X, y, Xv, yv = data("float waves")
    runs = {}
    for label, dev, kw in (("graphs", "cuda", {}),
                           ("eager", "cuda", {"_eager": True}),
                           ("cpu", "cpu", {})):
        pp = dict(p, device_type=dev)
        ds = ltt.Dataset(X, label=y, params=pp)
        b = ltt.Booster(params=pp, train_set=ds, **kw)
        b.add_valid(ds.create_valid(Xv, label=yv), "v")
        for _ in range(8):
            b.update()
        runs[label] = b
    g, e, c = runs["graphs"], runs["eager"], runs["cpu"]
    assert g._gbdt.runner.graphs is not None
    assert g.model_to_string() == e.model_to_string()
    assert np.array_equal(g._gbdt.train_score(), e._gbdt.train_score())
    for ta, tc in zip(g.models, c.models):
        n = ta.num_leaves
        assert n == tc.num_leaves
        np.testing.assert_array_equal(ta.split_feature[:n - 1],
                                      tc.split_feature[:n - 1])
        np.testing.assert_allclose(ta.leaf_value[:n], tc.leaf_value[:n],
                                   rtol=1e-5, atol=0)
    np.testing.assert_allclose(g._gbdt.valid_sets[0].score.cpu().numpy(),
                               g.predict(Xv, raw_score=True), rtol=0,
                               atol=1e-9)
