"""The whole slice: ``lightgbm_tpu.train`` vs ``lightgbm_tpu_torch.train``.

Binary and L2 data, with and without NaN, 4k rows x 6 features,
max_bin 63, 15 leaves, 3 rounds; the port runs with device_type=cpu.
The JAX package predicts through its host traversal
(``predict_engine=False``), its per-tree oracle path.

Tolerances, and why:

- trees: identical (split feature, threshold, decision type with
  default_left, children, leaf counts);
- predictions: within 1e-5 (absolute);
- model text: every line byte-identical except those that print sums of
  gradients or hessians — ``leaf_value`` (%.17g), ``split_gain``,
  ``leaf_weight``, ``internal_value`` and ``internal_weight`` (%g) — and
  ``tree_sizes``, which counts their characters.  Those are compared
  numerically, within rtol 1e-5 plus 1e-6 times the root's sum.  The
  port sums histograms in float64 and rounds once; the JAX package sums
  in float32 in row order, so a printed sixth significant digit can
  differ (the test of one tree states the same bound).
- ``convert.from_jax_arrays``: predictions within 1e-9 (float64
  accumulation on both sides).
"""
import os
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as ltt  # noqa: E402
from lightgbm_tpu_torch import convert  # noqa: E402

PRED_ATOL = 1e-5
NUM_RTOL = 1e-5
NUM_ATOL_OF_ROOT = 1e-6
NUMERIC_LINES = ("leaf_value", "split_gain", "leaf_weight", "internal_value",
                 "internal_weight", "tree_sizes")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(seed, objective, nan, n=4000, F=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    if nan:
        X[rng.rand(n) < 0.15, 1] = np.nan
        X[rng.rand(n) < 0.05, 3] = np.nan
    Xn = np.nan_to_num(X)
    z = Xn[:, 0] + 0.5 * Xn[:, 1] - 0.7 * Xn[:, 2] * Xn[:, 3] + \
        0.3 * rng.randn(n)
    y = z if objective == "regression" else (z > 0).astype(float)
    return X, y


def _train_both(objective, nan, seed):
    X, y = _data(seed, objective, nan)
    p = {"objective": objective, "num_leaves": 15, "max_bin": 63,
         "verbose": -1, "metric": "None"}
    bj = lgb.train(p, lgb.Dataset(X, label=y, params=p), num_boost_round=3,
                   verbose_eval=False)
    pt = dict(p, device_type="cpu")
    bt = ltt.train(pt, ltt.Dataset(X, label=y, params=pt), num_boost_round=3)
    return X, y, bj, bt


def _assert_model_text_matches(tj, tt, scale):
    lj, lt = tj.splitlines(), tt.splitlines()
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        key = a.split("=", 1)[0]
        if key not in NUMERIC_LINES:
            assert a == b
            continue
        assert b.startswith(key + "=")
        va = np.asarray(a.split("=", 1)[1].split(), np.float64)
        vb = np.asarray(b.split("=", 1)[1].split(), np.float64)
        if key == "tree_sizes":
            continue        # character counts of the numeric lines
        atol = NUM_ATOL_OF_ROOT * scale
        assert np.all(np.abs(va - vb) <= NUM_RTOL * np.abs(va) + atol), \
            (key, np.max(np.abs(va - vb)))


@pytest.mark.parametrize("objective,nan", [("binary", False),
                                           ("binary", True),
                                           ("regression", False),
                                           ("regression", True)])
def test_train_matches_jax(objective, nan):
    seed = {"binary": 0, "regression": 2}[objective] + int(nan)
    X, y, bj, bt = _train_both(objective, nan, seed)
    mj, mt = bj._gbdt.models, bt.models
    assert len(mj) == len(mt) == 3
    for a, b in zip(mj, mt):
        assert a.num_leaves == b.num_leaves == 15
        n = a.num_leaves - 1
        for k in ("split_feature", "threshold_bin", "decision_type",
                  "left_child", "right_child", "internal_count"):
            np.testing.assert_array_equal(getattr(a, k)[:n],
                                          getattr(b, k)[:n], k)
        np.testing.assert_array_equal(a.threshold[:n], b.threshold[:n])
        np.testing.assert_array_equal(a.leaf_count[:n + 1],
                                      b.leaf_count[:n + 1])
    pj = bj.predict(X, predict_engine=False)
    pt = bt.predict(X)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=PRED_ATOL)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True,
                                          predict_engine=False),
                               rtol=0, atol=PRED_ATOL)
    scale = max(np.abs(y).sum(), len(y))
    _assert_model_text_matches(bj.model_to_string(), bt.model_to_string(),
                               scale)


def test_model_text_round_trip():
    X, y, _, bt = _train_both("binary", True, 1)
    text = bt.model_to_string()
    loaded = ltt.Booster(params={"device_type": "cpu"}, model_str=text)
    assert loaded.model_to_string() == text
    np.testing.assert_array_equal(loaded.predict(X), bt.predict(X))


def _mapper_dicts(ds):
    return [{"num_bin": m.num_bin, "missing_type": m.missing_type,
             "bin_type": m.bin_type, "bin_upper_bound": m.bin_upper_bound,
             "default_bin": m.default_bin, "min_val": m.min_val,
             "max_val": m.max_val} for m in ds.mappers]


def _tree_dicts(models):
    keys = ("split_feature", "split_gain", "threshold", "threshold_bin",
            "decision_type", "left_child", "right_child", "internal_value",
            "internal_weight", "internal_count", "leaf_value", "leaf_weight",
            "leaf_count")
    return [{"num_leaves": t.num_leaves, "shrinkage": t.shrinkage,
             **{k: np.array(getattr(t, k)) for k in keys}} for t in models]


@pytest.mark.parametrize("source", ["arrays", "model_text"])
def test_convert_from_jax_arrays(source):
    X, y = _data(4, "binary", True)
    p = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
         "verbose": -1, "metric": "None"}
    bj = lgb.train(p, lgb.Dataset(X, label=y, params=p), num_boost_round=3,
                   verbose_eval=False)
    mappers = _mapper_dicts(bj._gbdt.train_set)
    if source == "arrays":
        bt = convert.from_jax_arrays(mappers, trees=_tree_dicts(bj._gbdt.models),
                                     objective="binary sigmoid:1",
                                     params={"device_type": "cpu"})
    else:
        bt = convert.from_jax_arrays(mappers,
                                     model_text=bj.model_to_string(),
                                     params={"device_type": "cpu"})
    assert [m.num_bin for m in bt.mappers] == [m["num_bin"] for m in mappers]
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True,
                                          predict_engine=False),
                               rtol=0, atol=1e-9)


def test_cuda_default_raises_without_a_card():
    """No silent CPU fallback: device_type defaults to cuda."""
    if ltt.Config().device_type != "cuda":
        pytest.fail("device_type must default to cuda")
    import torch
    X, y = _data(5, "binary", False, n=200)
    ds = ltt.Dataset(X, label=y, params={"objective": "binary"})
    if torch.cuda.is_available():
        ds.construct()
        assert ds._constructed.binned.is_cuda
    else:
        with pytest.raises(ltt.LightGBMError, match="device_type=cpu"):
            ds.construct()


@pytest.mark.parametrize("params", [
    {"feature_contri": [0.5, 1, 1, 1, 1, 1]},
    {"tree_learner": "voting"},
    {"speculative_tolerance": 0.1}, {"forcedsplits_filename": "forced.json"},
    {"tree_learner": "data"}, {"monotone_constraints": [1, 0, 0, 0, 0, 0]},
])
def test_unimplemented_parameters_raise(params):
    """Forced splits, speculative arming and parallel learners raise.  The
    feature penalty and monotone constraints, which raised here until the
    port had them, train and give the JAX package's trees."""
    if "feature_contri" in params or "monotone_constraints" in params:
        X, y = _data(6, "binary", True, n=2000)
        p = {"objective": "binary", "verbose": -1, "num_leaves": 15,
             "max_bin": 63, "metric": "None", **params}
        bj = lgb.train(p, lgb.Dataset(X, label=y, params=p),
                       num_boost_round=2, verbose_eval=False)
        pt = dict(p, device_type="cpu")
        bt = ltt.train(pt, ltt.Dataset(X, label=y, params=pt),
                       num_boost_round=2)
        sp = bt._gbdt.grow_params.split
        assert sp.has_penalty or sp.has_monotone
        from test_torch_objectives import hold_to_jax
        assert hold_to_jax(bj, bt, X, y) is None
        return
    X, y = _data(6, "binary", False, n=200)
    p = {"objective": "binary", "device_type": "cpu", "verbose": -1,
         **params}
    with pytest.raises(NotImplementedError):
        ltt.train(p, ltt.Dataset(X, label=y, params=p), num_boost_round=1)


@pytest.mark.parametrize("params", [
    {"categorical_feature": "0"},
    {"categorical_feature": [0, 2]},
])
def test_categorical_parameter_trains_as_jax(params):
    """The categorical parameter, which the port refused before it had
    categorical features, bins and trains as in the JAX package: the
    binned matrix byte-identical and one tree the JAX package's."""
    X, y = _data(6, "binary", False, n=2000)
    X[:, 0] = np.floor(np.abs(X[:, 0]) * 4) % 12
    X[:, 2] = np.floor(np.abs(X[:, 2]) * 3) % 7
    p = {"objective": "binary", "verbose": -1, "num_leaves": 15,
         "max_bin": 63, "metric": "None", "min_data_per_group": 20,
         "use_quantized_grad": True, **params}
    bj = lgb.train(p, lgb.Dataset(X, label=y, params=p), num_boost_round=1,
                   verbose_eval=False)
    pt = dict(p, device_type="cpu")
    bt = ltt.train(pt, ltt.Dataset(X, label=y, params=pt), num_boost_round=1)
    np.testing.assert_array_equal(
        bt.train_set._constructed.binned.numpy(),
        np.asarray(bj.train_set._constructed.binned).T)
    assert [m.bin_type for m in bt.train_set._constructed.mappers] == \
        [m.bin_type for m in bj.train_set._constructed.mappers]
    assert bt.models[0].num_cat > 0
    from test_torch_objectives import hold_to_jax
    assert hold_to_jax(bj, bt, X, y) is None


def test_port_imports_nothing_of_jax():
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "import lightgbm_tpu_torch as t; "
            "import lightgbm_tpu_torch.basic, lightgbm_tpu_torch.engine, "
            "lightgbm_tpu_torch.convert, lightgbm_tpu_torch.ops.kernels, "
            "lightgbm_tpu_torch.utils.prng; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'lightgbm_tpu' or "
            "m.startswith('lightgbm_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {**os.environ, "PYTHONPATH": ""}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
