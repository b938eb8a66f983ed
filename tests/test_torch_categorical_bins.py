"""Categorical binning of the port (``device_type=cpu``) against the JAX
package (``JAX_PLATFORMS=cpu``).

The same numpy columns, made from seeds, are binned by both packages.

Tolerances, and why:

- bin mappers (``BinMapper`` of ``lightgbm_tpu_torch/io/binning.py``, a
  copy of the JAX package's): every field equal — bin type, missing
  type, bin count, triviality, the category tables ``categorical_2_bin``
  and ``bin_2_categorical`` and the model text's ``feature_info``;
- binned matrices: byte-identical (the device lookup of
  ``io/dataset.py`` ``_value_to_bin`` against the JAX package's numpy
  ``value_to_bin``), on the training columns and on new values (unseen,
  negative, non-integer, infinite, NaN, codes above 31);
- pandas ``category`` columns and both spellings of the
  ``categorical_feature`` parameter (indices, ``name:``) give the JAX
  package's matrix and categorical columns;
- ``convert.from_jax_arrays`` carries categorical mappers and trees
  across: predictions within 1e-9 (float64 sums on both sides).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as ltt  # noqa: E402
from lightgbm_tpu.io import binning as jbin  # noqa: E402
from lightgbm_tpu_torch import convert  # noqa: E402
from lightgbm_tpu_torch.io import binning as tbin  # noqa: E402
from lightgbm_tpu_torch.io.dataset import _value_to_bin  # noqa: E402

from test_torch_slice import _tree_dicts  # noqa: E402

N = 3000


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _column(case, seed=0):
    """(values, find_bin keywords) of one categorical column."""
    rng = np.random.RandomState(seed)
    kw = {}
    if case == "12 levels":
        v = rng.randint(0, 12, N).astype(float)
    elif case == "4 levels":
        v = rng.randint(0, 4, N).astype(float)
    elif case == "rare cut":
        # a long tail: the rarest categories fall past 99% of the mass
        v = np.minimum(rng.geometric(0.35, N) - 1, 40).astype(float)
    elif case == "negative":
        v = rng.randint(-3, 9, N).astype(float)
    elif case == "nan":
        v = rng.randint(0, 7, N).astype(float)
        v[rng.rand(N) < 0.1] = np.nan
    elif case == "nan unused":
        v = rng.randint(0, 7, N).astype(float)
        v[rng.rand(N) < 0.1] = np.nan
        kw = {"use_missing": False}
    elif case == "zero as missing":
        v = rng.randint(0, 7, N).astype(float)
        v[rng.rand(N) < 0.1] = np.nan
        kw = {"zero_as_missing": True}
    elif case == "codes above 31":
        v = rng.choice([1, 5, 33, 40, 64, 70, 97, 130], N).astype(float)
    elif case == "max_bin cut":
        v = rng.randint(0, 30, N).astype(float)
        kw = {"max_bin": 15}
    else:
        raise ValueError(case)
    return v, kw


CASES = ["12 levels", "4 levels", "rare cut", "negative", "nan",
         "nan unused", "zero as missing", "codes above 31", "max_bin cut"]
# values no training column holds in that form
PROBES = np.array([np.nan, -1.0, -0.5, -0.0, 0.0, 0.5, 2.7, 3.0, 11.0,
                   12.0, 31.0, 32.0, 33.0, 40.5, 64.0, 1e9, np.inf,
                   -np.inf, 1e300])


def _mappers(v, kw):
    out = []
    for mod in (jbin, tbin):
        m = mod.BinMapper()
        m.find_bin(v, len(v), kw.get("max_bin", 63), 3,
                   use_missing=kw.get("use_missing", True),
                   zero_as_missing=kw.get("zero_as_missing", False),
                   bin_type=mod.BIN_CATEGORICAL)
        out.append(m)
    return out


@pytest.mark.parametrize("case", CASES)
def test_categorical_mapper_and_bins_match_jax(case):
    v, kw = _column(case)
    mj, mt = _mappers(v, kw)
    for k in ("bin_type", "missing_type", "num_bin", "is_trivial",
              "categorical_2_bin", "bin_2_categorical"):
        assert getattr(mt, k) == getattr(mj, k), k
    assert mt.feature_info() == mj.feature_info()
    assert mt.missing_bin == mj.missing_bin
    for b in range(1, len(mj.bin_2_categorical)):
        assert mt.bin_to_value(b) == mj.bin_to_value(b)
    for vals in (v, PROBES):
        want = mj.value_to_bin(vals)
        np.testing.assert_array_equal(mt.value_to_bin(vals), want)
        dev = _value_to_bin(torch.as_tensor(vals, dtype=torch.float64), mt)
        np.testing.assert_array_equal(dev.numpy(), want)


@pytest.mark.parametrize("case", ["12 levels", "nan", "rare cut"])
def test_numerical_device_bins_match_jax(case):
    """The device binning of a numerical column (the host's
    ``value_to_bin`` takes categorical mappers only) against the JAX
    package's on the same column read as numbers."""
    v, kw = _column(case, seed=3)
    v = v + np.random.RandomState(1).rand(N)
    mj, mt = jbin.BinMapper(), tbin.BinMapper()
    for m in (mj, mt):
        m.find_bin(v, N, 63, 3)
    vals = np.concatenate([v, PROBES])
    dev = _value_to_bin(torch.as_tensor(vals, dtype=torch.float64), mt)
    np.testing.assert_array_equal(dev.numpy(), mj.value_to_bin(vals))
    with pytest.raises(ValueError, match="device"):
        mt.value_to_bin(vals)


def _cat_data(seed=0, n=2000):
    rng = np.random.RandomState(seed)
    X = np.column_stack([rng.randn(n), rng.randint(0, 12, n),
                         rng.randn(n), rng.randint(0, 4, n),
                         rng.randint(0, 40, n)]).astype(float)
    X[rng.rand(n) < 0.05, 1] = np.nan
    y = (X[:, 0] + np.isin(X[:, 1], [2, 5, 7]) + 0.3 * rng.randn(n) >
         0.5).astype(float)
    return X, y


def _both_binned(data, params, **kw):
    made = []
    for pkg, extra in ((lgb, {}), (ltt, {"device_type": "cpu"})):
        p = dict(params, **extra)
        made.append(pkg.Dataset(data, label=np.zeros(len(data)), params=p,
                                **kw).construct())
    dj, dt = (d._constructed for d in made)
    return dj, dt


def _assert_same_binning(dj, dt):
    assert [m.bin_type for m in dt.mappers] == \
        [m.bin_type for m in dj.mappers]
    assert [m.categorical_2_bin for m in dt.mappers] == \
        [m.categorical_2_bin for m in dj.mappers]
    jb = np.asarray(dj.binned)
    tb = dt.binned.numpy()
    assert tb.dtype == jb.dtype
    np.testing.assert_array_equal(tb, jb.T)
    assert dt.feature_infos() == [m.feature_info() for m in dj.mappers]


@pytest.mark.parametrize("spec", [
    {"categorical_feature": [1, 3, 4]},
    {"params": {"categorical_feature": "1,3,4"}},
    {"params": {"categorical_feature": "name:b,d,e"},
     "feature_name": ["a", "b", "c", "d", "e"]},
    {"categorical_feature": ["b", "d", "e"],
     "feature_name": ["a", "b", "c", "d", "e"]},
])
def test_dataset_categorical_spec_matches_jax(spec):
    X, _ = _cat_data()
    spec = dict(spec)
    params = {"max_bin": 63, "verbose": -1, **spec.pop("params", {})}
    dj, dt = _both_binned(X, params, **spec)
    assert sum(m.bin_type == tbin.BIN_CATEGORICAL for m in dt.mappers) == 3
    _assert_same_binning(dj, dt)


def test_pandas_category_columns_match_jax():
    X, _ = _cat_data(1)
    df = pd.DataFrame(X, columns=["a", "b", "c", "d", "e"])
    df["b"] = pd.Categorical(np.where(np.isnan(X[:, 1]), None,
                                      [f"k{int(v)}" if v == v else None
                                       for v in X[:, 1]]))
    df["d"] = df["d"].astype(int).astype("category")
    dj, dt = _both_binned(df, {"max_bin": 63, "verbose": -1})
    cats = [i for i, m in enumerate(dt.mappers)
            if m.bin_type == tbin.BIN_CATEGORICAL]
    assert cats == [1, 3]
    _assert_same_binning(dj, dt)
    # a validation frame bins with the training mappers
    vj = lgb.Dataset(df[:300], label=np.zeros(300),
                     reference=lgb.Dataset(df, label=np.zeros(len(df)),
                                           params={"verbose": -1}))
    tr = ltt.Dataset(df, label=np.zeros(len(df)),
                     params={"verbose": -1, "device_type": "cpu"})
    vt = tr.create_valid(df[:300], label=np.zeros(300))
    np.testing.assert_array_equal(vt.construct()._constructed.binned.numpy(),
                                  np.asarray(vj.construct()._constructed
                                             .binned).T)


def _mapper_dicts(ds):
    return [{"num_bin": m.num_bin, "missing_type": m.missing_type,
             "bin_type": m.bin_type, "bin_upper_bound": m.bin_upper_bound,
             "default_bin": m.default_bin, "min_val": m.min_val,
             "max_val": m.max_val, "is_trivial": m.is_trivial,
             "categorical_2_bin": m.categorical_2_bin,
             "bin_2_categorical": m.bin_2_categorical} for m in ds.mappers]


@pytest.mark.parametrize("source", ["arrays", "model_text"])
def test_convert_carries_categorical_mappers_and_trees(source):
    X, y = _cat_data(2)
    p = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
         "verbose": -1, "metric": "None", "categorical_feature": "1,3,4",
         "min_data_per_group": 20}
    bj = lgb.train(p, lgb.Dataset(X, label=y, params=p), num_boost_round=3,
                   verbose_eval=False)
    assert sum(t.num_cat for t in bj._gbdt.models) > 0
    mappers = _mapper_dicts(bj.train_set._constructed)
    if source == "arrays":
        trees = _tree_dicts(bj._gbdt.models)
        for d, t in zip(trees, bj._gbdt.models):
            d.update(num_cat=t.num_cat, cat_boundaries=list(t.cat_boundaries),
                     cat_threshold=list(t.cat_threshold))
        bt = convert.from_jax_arrays(mappers, trees=trees,
                                     objective="binary sigmoid:1",
                                     params={"device_type": "cpu"})
    else:
        bt = convert.from_jax_arrays(mappers, model_text=bj.model_to_string(),
                                     params={"device_type": "cpu"})
    for a, b in zip(bt.mappers, bj.train_set._constructed.mappers):
        assert a.categorical_2_bin == b.categorical_2_bin
        assert a.bin_2_categorical == b.bin_2_categorical
        assert a.is_trivial == b.is_trivial
        assert a.feature_info() == b.feature_info()
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True,
                                          predict_engine=False),
                               rtol=0, atol=1e-9)
