"""Random forests of the port against the JAX package's, on the CPU.

Both packages train the same data, 8 rounds with a validation set
(``bagging_fraction=0.632``, ``bagging_freq=1``, ``feature_fraction=0.8``),
on the exact loop (binary, 15 leaves, bias from ``boost_from_average``)
and on float waves (L2, 15 leaves).  The contract, and why:

- the same tree structure; leaf values within 1e-5 absolute and 1e-4
  relative (gbdt's on this data differ from the reference's by up to 3e-5
  relative: float64 against float32 histogram sums), each tree's bias
  included;
- the averaged training and validation scores within 1e-5 of the
  reference's, and of the port's own averaged prediction (the validation
  score within 1e-9: it is float64 throughout);
- ``predict`` averages: the port's predictions within 1e-5 of the
  reference's; the model text carries ``average_output`` and a model
  read back predicts the same bits;
- ``rollback_one_iter`` restores the scores of the iteration before, as
  the reference's does;
- the configurations the reference refuses are refused: no bagging
  (both raise ``LightGBMError``); an initial score (the reference's RF
  refuses it, the port's ``Dataset`` refuses ``init_score`` outright).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu_torch as ltt  # noqa: E402
from test_torch_dart import assert_same_model, data  # noqa: E402

ROUNDS = 8
RF = {"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
      "feature_fraction": 0.8}
PATHS = {
    "exact": {"objective": "binary", "num_leaves": 15, "max_bin": 63},
    "float waves": {"objective": "regression", "num_leaves": 15,
                    "max_bin": 63, "wave_splits": True,
                    "hist_refinement": False},
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train_both(path, boosting="rf"):
    import lightgbm_tpu as lgb
    p = {"verbose": -1, "metric": "None", **PATHS[path], **RF,
         "boosting": boosting}
    X, y, Xv, yv = data(path)
    bj = lgb.Booster(params=p, train_set=lgb.Dataset(X, label=y, params=p))
    bj.add_valid(lgb.Dataset(Xv, label=yv, reference=bj.train_set), "v")
    pt = dict(p, device_type="cpu")
    dt = ltt.Dataset(X, label=y, params=pt)
    bt = ltt.Booster(params=pt, train_set=dt)
    bt.add_valid(dt.create_valid(Xv, label=yv), "v")
    for b in (bj, bt):
        for _ in range(ROUNDS):
            assert not b.update()
    return bj, bt


def _assert_scores(bj, bt, X, Xv):
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


@pytest.mark.parametrize("boosting", ["rf", "random_forest"])
@pytest.mark.parametrize("path", list(PATHS))
def test_rf_matches_jax(path, boosting):
    bj, bt = _train_both(path, boosting)
    X, _, Xv, _ = data(path)
    gt = bt._gbdt
    assert gt.average_output and bj._gbdt.average_output
    assert not gt._fused_ok() and gt.block_sizes == [1] * ROUNDS
    assert_same_model(bj, bt)
    _assert_scores(bj, bt, X, Xv)
    np.testing.assert_allclose(bt.predict(Xv),
                               bj.predict(Xv, predict_engine=False),
                               rtol=0, atol=1e-5)
    for b in (bj, bt):
        b.rollback_one_iter()
    assert len(bt.models) == ROUNDS - 1 and gt.iter == bj._gbdt.iter
    assert_same_model(bj, bt)
    _assert_scores(bj, bt, X, Xv)


def test_rf_model_text_round_trip(tmp_path):
    X, y, Xv, _ = data("exact")
    p = {"verbose": -1, "metric": "None", **PATHS["exact"], **RF,
         "device_type": "cpu"}
    b = ltt.train(p, ltt.Dataset(X, label=y, params=p), num_boost_round=5)
    text = b.model_to_string()
    assert "\naverage_output\n" in text
    path = str(tmp_path / "rf.txt")
    b.save_model(path)
    b2 = ltt.Booster(model_file=path, params={"device_type": "cpu"})
    assert b2.average_output
    np.testing.assert_array_equal(b.predict(Xv), b2.predict(Xv))
    # the JAX package reads the port's text as a forest too
    import lightgbm_tpu as lgb
    bj = lgb.Booster(model_str=text)
    np.testing.assert_allclose(bj.predict(Xv, predict_engine=False),
                               b.predict(Xv), rtol=0, atol=1e-12)
    # and a gbdt model has no marker
    pg = dict(p, boosting="gbdt")
    g = ltt.train(pg, ltt.Dataset(X, label=y, params=pg), num_boost_round=2)
    assert "average_output" not in g.model_to_string()


@pytest.mark.parametrize("extra", [
    {"boosting": "rf"},
    {"boosting": "rf", "bagging_freq": 1},
    {"boosting": "random_forest", "bagging_fraction": 0.5},
])
def test_rf_without_bagging_is_refused(extra):
    import lightgbm_tpu as lgb
    X, y, _, _ = data("exact")
    p = {"objective": "binary", "verbose": -1, **extra}
    for pkg, kw in ((lgb, {}), (ltt, {"device_type": "cpu"})):
        pp = dict(p, **kw)
        with pytest.raises(pkg.LightGBMError, match="requires bagging"):
            pkg.train(pp, pkg.Dataset(X, label=y, params=pp),
                      num_boost_round=1)


def test_rf_with_an_initial_score_is_refused():
    import lightgbm_tpu as lgb
    X, y, _, _ = data("exact")
    p = {"objective": "binary", "verbose": -1, **RF}
    init = np.zeros(len(y))
    with pytest.raises(lgb.LightGBMError, match="initial score"):
        lgb.train(p, lgb.Dataset(X, label=y, init_score=init, params=p),
                  num_boost_round=1)
    pt = dict(p, device_type="cpu")
    with pytest.raises(NotImplementedError, match="init_score"):
        ltt.train(pt, ltt.Dataset(X, label=y, init_score=init, params=pt),
                  num_boost_round=1)


@pytest.mark.cuda
def test_rf_graphs_match_eager_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    X, y, Xv, yv = data("exact")
    p = {"verbose": -1, "metric": "None", **PATHS["exact"], **RF,
         "device_type": "cuda"}
    out = []
    for kw in ({}, {"_eager": True}):
        ds = ltt.Dataset(X, label=y, params=p)
        b = ltt.Booster(params=p, train_set=ds, **kw)
        b.add_valid(ds.create_valid(Xv, label=yv), "v")
        for _ in range(6):
            b.update()
        out.append(b)
    g, e = out
    assert g._gbdt.runner.graphs is not None
    assert g.model_to_string() == e.model_to_string()
    assert np.array_equal(g._gbdt.train_score(), e._gbdt.train_score())
    np.testing.assert_allclose(g._gbdt.valid_sets[0].score.cpu().numpy(),
                               g.predict(Xv, raw_score=True), rtol=0,
                               atol=1e-9)
