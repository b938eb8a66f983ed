"""Input types and refused parameters of the port (``device_type=cpu``)
against the JAX package (``JAX_PLATFORMS=cpu``).

Input types (``lightgbm_tpu_torch/basic.py`` ``_to_matrix``, the JAX package's
``lightgbm_tpu/basic.py:50-80``): a scipy CSR, CSC or COO matrix is densified,
so the port trains the same trees and model text, and predicts the same bits,
as on the dense array.  The JAX package bins the same sparse input by CSC
columns and trains the model text of its dense array.  Against it the port's
trees split alike (features, threshold bins, children).  Their predictions are
held within 1e-4 of their reach (``tests/test_torch_objectives.py``
``pred_atol``) and their split gains within rel 1e-3, not the slice's 1e-5 and
1e-5: on these data, where 70% of the values are exact zeros, the predictions
differ by up to 2.2e-5 and a child's gain by 7.9e-4 relative (126.0855 in the
JAX package, 126.0751 in the port) though the splits agree.  The gap is the JAX
package's float32 order, not the port's error (``ROADMAP.md`` Queue 3 item 10,
``test_zero_heavy_gap_is_the_jax_float32_sum``): bins, thresholds and leaf
counts are identical, and the first quantity that differs is a histogram cell.
The zero bin of feature 3 holds 1,021 of the 1,500 rows; the JAX package's CPU
``segment_sum`` adds their hessians one at a time in float32 and ends at
255.13708, 213 float32 ulps (2^-16 each) above the exact sum 255.13384, which
the port's float64 sum rounds to once.  In the first tree the leaf hessian sums
then differ by up to 0.0035 (a leaf of 601 rows), and the gains and leaf values
with them.  The same generator without zeros gives 9e-6: no bin holds more
than a few dozen rows.  A pandas frame's column names become the feature
names, as the JAX package's ``feature_name()`` gives them; a ``category``
column becomes its codes and a categorical feature, binned and trained as in
the JAX package; an ``object`` column is fatal in both packages.

Refusals (``lightgbm_tpu_torch/config.py`` ``UNSUPPORTED`` and
``Config.check_histogram_pool``): each parameter the JAX package acts on
in ``train`` and the port would otherwise ignore raises
``NotImplementedError``; the histogram pool is refused exactly where the
JAX package's ``tier_decision["use_hist_pool"]`` is false.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as ltt  # noqa: E402
from lightgbm_tpu_torch import LightGBMError  # noqa: E402
from lightgbm_tpu_torch.config import Config as TConfig  # noqa: E402
from test_torch_objectives import first_difference  # noqa: E402
from test_torch_objectives import hold_to_jax  # noqa: E402
from test_torch_objectives import pred_atol  # noqa: E402

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "verbose": -1, "metric": "None"}
ROUNDS = 3
# split gains on zero-heavy data (module docstring)
GAIN_RTOL_ZEROS = 1e-3
PRED_ATOL_ZEROS = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sparse_data(n=1500, F=8, seed=4):
    """Rows with about 70% zeros a feature, and a label from two of them."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F) * (rng.rand(n, F) < 0.3)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.randn(n) > 0).astype(float)
    return X, y


def _train_port(data, y, extra=None, rounds=ROUNDS, **ds_kw):
    p = dict(PARAMS, device_type="cpu", **(extra or {}))
    return ltt.train(p, ltt.Dataset(data, label=y, params=p, **ds_kw),
                     num_boost_round=rounds)


@pytest.fixture(scope="module")
def dense_booster():
    X, y = _sparse_data()
    return X, y, _train_port(X, y)


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo"])
def test_sparse_input_trains_the_dense_trees(fmt, dense_booster):
    X, y, bd = dense_booster
    S = sp.csr_matrix(X).asformat(fmt)
    bs = _train_port(S, y)
    assert bs.model_to_string() == bd.model_to_string()
    np.testing.assert_array_equal(bs.predict(S, raw_score=True),
                                  bd.predict(X, raw_score=True))
    # the JAX package on the same sparse input
    bj = lgb.train(PARAMS, lgb.Dataset(S, label=y, params=PARAMS),
                   num_boost_round=ROUNDS, verbose_eval=False)
    mj, mt = bj._gbdt.models, bs.models
    assert first_difference(mj, mt) is None
    np.testing.assert_allclose(
        bs.predict(S, raw_score=True),
        bj.predict(S, raw_score=True, predict_engine=False), rtol=0,
        atol=pred_atol(mj, 1, PRED_ATOL_ZEROS))
    for a, b in zip(mj, mt):
        n = a.num_leaves - 1
        np.testing.assert_allclose(b.split_gain[:n], a.split_gain[:n],
                                   rtol=GAIN_RTOL_ZEROS)


def test_pandas_names_reach_the_model_text():
    X, y = _sparse_data(n=800, F=5, seed=5)
    cols = ["age", "income", "score 2", "x_3", "7"]
    df = pd.DataFrame(X, columns=cols)
    bt = _train_port(df, y, rounds=2)
    bj = lgb.train(PARAMS, lgb.Dataset(df, label=y, params=PARAMS),
                   num_boost_round=2, verbose_eval=False)
    assert bt.feature_name() == bj.feature_name()
    names = [ln for ln in bt.model_to_string().splitlines()
             if ln.startswith("feature_names=")]
    assert names == [ln for ln in bj.model_to_string().splitlines()
                     if ln.startswith("feature_names=")]
    # the frame trains the array's trees under the frame's names, and an
    # explicit feature_name wins over the columns, as in the JAX package
    ba = _train_port(X, y, rounds=2, feature_name=cols)
    assert ba.model_to_string() == bt.model_to_string()
    np.testing.assert_array_equal(bt.predict(df, raw_score=True),
                                  ba.predict(X, raw_score=True))
    other = [f"f{i}" for i in range(5)]
    assert _train_port(df, y, rounds=1,
                       feature_name=other).feature_name() == other


@pytest.mark.parametrize("kind", ["object"])
def test_pandas_category_and_object_columns_refused(kind):
    """An ``object`` column is fatal in both packages (a ``category``
    column trains: ``test_pandas_category_column_trains_as_jax``)."""
    X, y = _sparse_data(n=200, F=3, seed=6)
    df = pd.DataFrame(X, columns=["a", "b", "c"])
    df["b"] = pd.Series(np.where(X[:, 1] > 0, "hi", "lo"), dtype=kind)
    with pytest.raises(LightGBMError, match="object column b"):
        _train_port(df, y, rounds=1)
    with pytest.raises(Exception, match="object column b"):
        lgb.Dataset(df, label=y, params=PARAMS).construct()


@pytest.mark.parametrize("levels", [2, 9])
def test_pandas_category_column_trains_as_jax(levels):
    """A ``category`` column becomes its codes (-1 for a missing value)
    and a categorical feature: the binned matrix byte-identical to the JAX
    package's, its trees the JAX package's (``hold_to_jax``), and a frame
    predicts as its codes do."""
    X, y = _sparse_data(n=2000, F=3, seed=6)
    df = pd.DataFrame(X, columns=["a", "b", "c"])
    codes = np.floor(np.abs(X[:, 1]) * 5).astype(int) % levels
    names = np.array([f"k{i}" for i in range(levels)], dtype=object)
    col = names[codes]
    col[::17] = None
    df["b"] = pd.Series(col, dtype="category")
    y = (X[:, 0] + (codes == 1) + 0.2 * np.random.RandomState(6).randn(
        2000) > 0.3).astype(float)
    p = dict(PARAMS, use_quantized_grad=True, min_data_per_group=20)
    bj = lgb.train(p, lgb.Dataset(df, label=y, params=p), num_boost_round=2,
                   verbose_eval=False)
    bt = _train_port(df, y, extra={"use_quantized_grad": True,
                                   "min_data_per_group": 20}, rounds=2)
    dt = bt.train_set._constructed
    assert [m.bin_type for m in dt.mappers] == [0, 1, 0]
    np.testing.assert_array_equal(
        dt.binned.numpy(), np.asarray(bj.train_set._constructed.binned).T)
    assert sum(t.num_cat for t in bt.models) > 0
    assert hold_to_jax(bj, bt, df.assign(b=df["b"].cat.codes).values, y) \
        is None
    np.testing.assert_array_equal(
        bt.predict(df, raw_score=True),
        bt.predict(df.assign(b=df["b"].cat.codes).values, raw_score=True))


def test_zero_heavy_gap_is_the_jax_float32_sum():
    """The zero-heavy gap's first differing quantity (module docstring):
    identical bins, and a histogram cell the JAX package's CPU
    ``segment_sum`` ends at its float32 row-order sum, where the port's
    float64 sum rounds the exact value once."""
    from lightgbm_tpu.ops.histogram import histogram_segsum
    from lightgbm_tpu_torch.ops.histogram import histogram_plain
    import jax.numpy as jnp
    X, y = _sparse_data()
    dj = lgb.Dataset(X, label=y, params=PARAMS).construct()._constructed
    p = dict(PARAMS, device_type="cpu")
    dt = ltt.Dataset(X, label=y, params=p).construct()._constructed
    xt = dt.binned.numpy()
    np.testing.assert_array_equal(xt, np.asarray(dj.binned).T)
    # the first tree's hessians: one value a row, p (1 - p) at the prior
    prior = np.float32(y.mean())
    h = np.full(len(y), prior * (1 - prior), np.float32)
    vals = np.stack([np.zeros_like(h), h, np.ones_like(h)], 1)
    hj = np.asarray(histogram_segsum(jnp.asarray(xt), jnp.asarray(vals), 64))
    ht = histogram_plain(torch.as_tensor(xt), torch.as_tensor(vals),
                         64).numpy()
    f, b = np.unravel_index(np.argmax(hj[..., 2]), hj[..., 2].shape)
    rows = xt[f] == b
    assert rows.sum() > 1000
    seq = np.float32(0)
    for v in h[rows]:
        seq = np.float32(seq + v)
    assert hj[f, b, 1] == seq
    assert ht[f, b, 1] == np.float32(h[rows].astype(np.float64).sum())
    assert abs(hj[f, b, 1] - ht[f, b, 1]) > 50 * np.spacing(ht[f, b, 1])


REFUSED = {
    "checkpoint_dir": ({"checkpoint_dir": "ckpts"}, "checkpoints"),
    "snapshot_freq with checkpoint_dir": (
        {"checkpoint_dir": "ckpts", "snapshot_freq": 1}, "checkpoints"),
    "resume_from": ({"resume_from": "auto"}, "checkpoint resumes"),
    "telemetry_file": ({"telemetry_file": "run.jsonl"}, "telemetry"),
    "stream_ingest": ({"stream_ingest": True}, "streamed"),
    "paged_training": ({"paged_training": "on"}, "paged"),
    "hbm_budget_mb": ({"hbm_budget_mb": 64.0}, "paged"),
    "histogram_pool_size": ({"histogram_pool_size": 0.01}, "histogram pool"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_parameters_the_port_would_ignore_are_refused(case, tmp_path,
                                                      monkeypatch):
    monkeypatch.chdir(tmp_path)
    extra, what = REFUSED[case]
    X, y = _sparse_data(n=300, F=4, seed=7)
    with pytest.raises(NotImplementedError, match=what):
        _train_port(X, y, extra=extra, rounds=1)
    # nothing written where the JAX package would write
    assert list(tmp_path.iterdir()) == []


POOLS = [0.01, 0.1, 0.2, 1.0, -1.0]


@pytest.mark.parametrize("pool_mb", POOLS)
def test_histogram_pool_refused_where_jax_drops_it(pool_mb):
    """15 leaves x 6 features x 64 padded bins x 12 bytes = 69,120 bytes:
    the JAX package keeps its pool from 0.07 MB up."""
    X, y = _sparse_data(n=600, F=6, seed=8)
    p = dict(PARAMS, histogram_pool_size=pool_mb)
    bj = lgb.Booster(params=p, train_set=lgb.Dataset(X, label=y, params=p))
    keeps = bj._gbdt.tier_decision["use_hist_pool"]
    assert keeps == (pool_mb >= 0.0692 or pool_mb <= 0)
    if keeps:
        _train_port(X, y, extra={"histogram_pool_size": pool_mb}, rounds=1)
    else:
        with pytest.raises(NotImplementedError, match="histogram pool"):
            _train_port(X, y, extra={"histogram_pool_size": pool_mb},
                        rounds=1)


def test_histogram_pool_default_budget():
    """Without ``histogram_pool_size`` the budget is 4 GB: 255 leaves x 28
    features x 256 bins fit, 4096 leaves x 400 features do not."""
    TConfig({"num_leaves": 255}).check_histogram_pool(28, 256)
    TConfig({"num_leaves": 4096, "histogram_pool_size": 6000}
            ).check_histogram_pool(400, 256)
    with pytest.raises(NotImplementedError, match="4000.0 MB"):
        TConfig({"num_leaves": 4096}).check_histogram_pool(400, 256)


@pytest.mark.parametrize("name", ["tpu_rows_per_block", "split_kernel"])
def test_tpu_only_knobs_are_inert(name):
    value = {"tpu_rows_per_block": 4096, "split_kernel": "xla"}[name]
    cfg = TConfig({name: value})
    assert name in TConfig._INERT and getattr(cfg, name) == value
    cfg.check_supported()
