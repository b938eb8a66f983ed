"""Custom objectives (``fobj``) in the port (``device_type=cpu``) against
the JAX package (``JAX_PLATFORMS=cpu``).

A numpy binary log loss and a numpy L2 loss, each the same function of
the float64 score for both packages, through ``train`` (with a
validation set and a custom metric, ``feval``), ``Booster.update(fobj=)``
and ``cv``, on the exact loop and on float waves without coarse-to-fine:
the same gradients give the same trees (splits identical), and the model
text, predictions, recorded metrics and ``cv`` results are held as
``tests/test_torch_slice.py`` holds them (the numeric lines within rtol
1e-5; predictions and metrics within 1e-5, the port summing histograms
in float64 and the JAX package in float32).  The refusals are the JAX
package's: ``objective=none`` without ``fobj`` is fatal; ``fobj`` with
another objective warns and trains without it.  A custom objective's
model text names no objective (``objective=``, as the JAX package writes
it), loads back into the port, and predicts raw scores.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as ltt  # noqa: E402
from test_torch_objectives import hold_to_jax  # noqa: E402

METRIC_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def logloss_fobj(score, dataset):
    y = dataset.get_label()
    p = 1.0 / (1.0 + np.exp(-score))
    return p - y, p * (1.0 - p)


def l2_fobj(score, dataset):
    return score - dataset.get_label(), np.ones_like(score)


def error_feval(score, dataset):
    y = dataset.get_label()
    return "error", float(np.mean((score > 0) != (y > 0.5))), False


def _data(kind, seed=0, n=3000, F=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n) < 0.1, 2] = np.nan
    z = np.nan_to_num(X[:, 0]) + 0.5 * X[:, 1] + 0.3 * rng.randn(n)
    return X, (z > 0).astype(float) if kind == "logloss" else z


FOBJ = {"logloss": logloss_fobj, "l2": l2_fobj}
LOOPS = {"exact": {}, "float waves": {"wave_splits": True,
                                      "hist_refinement": False}}
BASE = {"num_leaves": 15, "max_bin": 63, "verbose": -1}


def _params(loop, **kw):
    return dict(BASE, **LOOPS[loop], **kw)


@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("kind", list(FOBJ))
def test_train_with_fobj_matches_jax(kind, loop):
    X, y = _data(kind)
    Xv, yv = _data(kind, seed=1, n=800)
    p = _params(loop, metric="None")
    ej, et = {}, {}
    bj = lgb.train(p, lgb.Dataset(X, label=y, params=p), 4, fobj=FOBJ[kind],
                   feval=error_feval, evals_result=ej, verbose_eval=False,
                   valid_sets=[lgb.Dataset(Xv, label=yv)])
    pt = dict(p, device_type="cpu")
    dt = ltt.Dataset(X, label=y, params=pt)
    bt = ltt.train(pt, dt, 4, fobj=FOBJ[kind], feval=error_feval,
                   evals_result=et, verbose_eval=False,
                   valid_sets=[dt.create_valid(Xv, label=yv)])
    assert len(bt.models) == 4
    assert hold_to_jax(bj, bt, X, y) is None
    # feval on the training data and the validation set
    assert ej.keys() == et.keys() == {"training", "valid_0"}
    for name in ej:
        np.testing.assert_allclose(et[name]["error"], ej[name]["error"],
                                   rtol=0, atol=METRIC_ATOL)
    # no objective: no boost_from_average bias, no output transform
    np.testing.assert_array_equal(bt.predict(Xv),
                                  bt.predict(Xv, raw_score=True))


@pytest.mark.parametrize("loop", list(LOOPS))
def test_booster_update_with_fobj_matches_jax(loop):
    """``Booster.update(fobj=)`` under an objective the model text keeps
    (binary: the output transform is its sigmoid), with a rollback."""
    X, y = _data("logloss", seed=2)
    p = _params(loop, objective="binary", metric="binary_logloss")
    pt = dict(p, device_type="cpu")
    bj = lgb.Booster(p, lgb.Dataset(X, label=y, params=p))
    bt = ltt.Booster(pt, ltt.Dataset(X, label=y, params=pt))
    for b in (bj, bt):
        for _ in range(3):
            b.update(fobj=logloss_fobj)
        b.rollback_one_iter()
        b.update(fobj=logloss_fobj)
        b.update()          # the objective's own gradients again
    assert hold_to_jax(bj, bt, X, y) is None
    np.testing.assert_allclose(bt.predict(X), bj.predict(
        X, predict_engine=False), rtol=0, atol=METRIC_ATOL)


@pytest.mark.parametrize("kind", list(FOBJ))
def test_cv_with_fobj_matches_jax(kind):
    X, y = _data(kind, seed=3, n=2400)
    p = dict(BASE, metric="l2")
    rj = lgb.cv(p, lgb.Dataset(X, label=y, params=p), num_boost_round=3,
                nfold=3, fobj=FOBJ[kind], feval=error_feval,
                verbose_eval=False)
    pt = dict(p, device_type="cpu")
    rt = ltt.cv(pt, ltt.Dataset(X, label=y, params=pt), num_boost_round=3,
                nfold=3, fobj=FOBJ[kind], feval=error_feval)
    assert rj.keys() == rt.keys() and "valid l2-mean" in rt
    for k in rj:
        np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=METRIC_ATOL)


def test_refusals_match_jax():
    X, y = _data("l2", seed=4, n=300)
    for params in ({"objective": "none"}, {"objective": "custom"}):
        with pytest.raises(Exception, match="requires a custom fobj"):
            lgb.train(dict(params, verbose=-1), lgb.Dataset(X, label=y), 1)
        pt = dict(params, verbose=-1, device_type="cpu")
        with pytest.raises(ltt.LightGBMError, match="requires a custom fobj"):
            ltt.train(pt, ltt.Dataset(X, label=y, params=pt), 1)
    # another objective: a warning, and the custom gradients train
    pt = dict(BASE, objective="regression", device_type="cpu")
    b = ltt.train(pt, ltt.Dataset(X, label=y, params=pt), 2, fobj=l2_fobj)
    assert b.config.objective == "none" and b.num_trees() == 2
    # no objective and no gradients
    b = ltt.Booster(dict(pt, objective="none"),
                    ltt.Dataset(X, label=y, params=pt))
    with pytest.raises(ltt.LightGBMError, match="custom objective"):
        b.update()
    with pytest.raises(ltt.LightGBMError, match="custom gradients"):
        b._gbdt.train_one_iter(np.zeros(5), np.zeros(5))


def test_model_text_round_trip():
    X, y = _data("l2", seed=5)
    p = dict(BASE, device_type="cpu")
    b = ltt.train(p, ltt.Dataset(X, label=y, params=p), 3, fobj=l2_fobj)
    text = b.model_to_string()
    bj = lgb.train(dict(BASE), lgb.Dataset(X, label=y), 3, fobj=l2_fobj,
                   verbose_eval=False)
    assert "\nobjective=\n" in text and "\nobjective=\n" in \
        bj.model_to_string()
    loaded = ltt.Booster(model_str=text, params={"device_type": "cpu"})
    assert loaded._objective is None
    np.testing.assert_array_equal(loaded.predict(X), b.predict(X))
    np.testing.assert_array_equal(loaded.predict(X, raw_score=True),
                                  b.predict(X))
