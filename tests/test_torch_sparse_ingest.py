"""Sparse (scipy CSR, CSC, COO) ingest of the port (``device_type=cpu``)
against the JAX package (``JAX_PLATFORMS=cpu``): ``TorchDataset.
from_sparse`` (``lightgbm_tpu_torch/io/dataset.py``) after
``lightgbm_tpu/io/dataset.py:198-250``.

Tolerances: none.  The bin mappers (every field) and the binned matrix
are byte-identical to ``TpuDataset.from_sparse``'s (transposed), for each
format, alone and with a reference dataset's mappers (a validation set),
on columns with negative values, NaN, explicit zeros, a categorical
column and an all-zero column.  A sparse Dataset keeps its raw rows
sparse: a validation set's score, ``predict`` and the replay of served
trees densify bounded row chunks (``ops/predict.py``
``DENSE_CHUNK_BYTES``), and predict the dense rows' bits.  Memory:
``tracemalloc`` sees the construction of a 50,000 x 1,000 matrix at 0.5%
density peak below a fortieth of its float64 densify (400 MB), and its
prediction below a quarter.  ``cv`` takes its folds' rows sparse and
gives the dense matrix's results.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import tracemalloc  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu_torch as ltt  # noqa: E402
from lightgbm_tpu.config import Config as JConfig  # noqa: E402
from lightgbm_tpu.io.dataset import TpuDataset  # noqa: E402
from lightgbm_tpu_torch.config import Config as TConfig  # noqa: E402
from lightgbm_tpu_torch.io.dataset import TorchDataset  # noqa: E402

CPU = torch.device("cpu")
PARAMS = {"objective": "binary", "num_leaves": 7, "max_bin": 63,
          "verbose": -1, "metric": "None", "device_type": "cpu"}
MAPPER_FIELDS = ("num_bin", "bin_type", "missing_type", "is_trivial",
                 "default_bin", "bin_upper_bound", "categorical_2_bin",
                 "bin_2_categorical", "min_val", "max_val", "sparse_rate")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sparse_data(n=3000, seed=2):
    """12 columns at 20% density: normal values (negative too), NaN in
    column 1, small category codes in column 3 (categorical), an all-zero
    column 5, explicit zeros stored in column 7."""
    rng = np.random.RandomState(seed)
    F = 12
    X = rng.randn(n, F) * (rng.rand(n, F) < 0.2)
    X[rng.rand(n) < 0.05, 1] = np.nan
    X[:, 3] = rng.randint(0, 6, n) * (rng.rand(n) < 0.3)
    X[:, 5] = 0.0
    y = (np.nan_to_num(X[:, 0]) + 0.5 * (X[:, 3] == 2) +
         0.3 * rng.randn(n) > 0).astype(float)
    S = sp.csr_matrix(X)
    # explicit zeros stored in column 7
    rows = np.nonzero(X[:, 7] == 0)[0][:50]
    S = S.tolil()
    S[rows, 7] = 1.0
    S = S.tocsr()
    S.data[np.isin(S.indices, [7]) & (S.data == 1.0)] = 0.0
    return S, y


def _same_mappers(a, b):
    assert len(a) == len(b)
    for ma, mb in zip(a, b):
        for k in MAPPER_FIELDS:
            va, vb = getattr(ma, k), getattr(mb, k)
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb)
            else:
                assert va == vb, k


@pytest.mark.parametrize("reference", [False, True])
@pytest.mark.parametrize("fmt", ["csr", "csc", "coo"])
def test_from_sparse_equals_jax(fmt, reference):
    S, y = sparse_data()
    assert (S.data == 0).sum() > 0
    cfg = {"max_bin": 63}
    kw = dict(categorical_features=[3])
    dj = TpuDataset.from_sparse(S.asformat(fmt), y, JConfig(cfg), **kw)
    dt = TorchDataset.from_sparse(S.asformat(fmt), y, TConfig(cfg), CPU,
                                  **kw)
    if reference:
        V, yv = sparse_data(n=800, seed=9)
        dj = TpuDataset.from_sparse(V.asformat(fmt), yv, JConfig(cfg),
                                    mappers=dj.mappers, **kw)
        dt = TorchDataset.from_sparse(V.asformat(fmt), yv, TConfig(cfg),
                                      CPU, mappers=dt.mappers, **kw)
    _same_mappers(dj.mappers, dt.mappers)
    assert dt.used_features == dj.used_features and 5 not in dt.used_features
    assert dt.binned.dtype == torch.uint8
    np.testing.assert_array_equal(dt.binned.numpy(), np.asarray(dj.binned).T)
    np.testing.assert_array_equal(dt.metadata.label, dj.metadata.label)


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo"])
def test_sparse_dataset_stays_sparse(fmt):
    """Training, a validation set, predict and subsets on sparse input: the
    raw rows stay sparse, the valid score is the trees' prediction, and
    sparse rows predict the dense rows' bits."""
    S, y = sparse_data()
    V, yv = sparse_data(n=800, seed=9)
    S, V = S.asformat(fmt), V.asformat(fmt)
    p = dict(PARAMS, categorical_feature="3")
    ds = ltt.Dataset(S, label=y, params=p)
    b = ltt.train(p, ds, num_boost_round=3,
                  valid_sets=[ds.create_valid(V, label=yv)])
    assert sp.issparse(ds.raw_mat)
    vs = b._gbdt.valid_sets[0]
    assert sp.issparse(vs.raw)
    dense = V.toarray()
    pred = b.predict(V, raw_score=True)
    np.testing.assert_array_equal(pred, b.predict(dense, raw_score=True))
    np.testing.assert_allclose(vs.score.numpy(), pred, rtol=0, atol=1e-6)
    # a subset bins the same rows as the dense matrix's subset
    idx = np.arange(0, 3000, 3)
    sub = ds.subset(idx).construct()
    ref = ltt.Dataset(S.toarray(), label=y, params=p)
    dsub = ref.subset(idx).construct()
    assert sp.issparse(sub.raw_mat)
    np.testing.assert_array_equal(sub._constructed.binned.numpy(),
                                  dsub._constructed.binned.numpy())
    # a rollback subtracts the popped tree from the valid score in chunks
    b.rollback_one_iter()
    np.testing.assert_allclose(vs.score.numpy(), b.predict(V, raw_score=True),
                               rtol=0, atol=1e-6)


def test_sparse_ingest_and_predict_memory():
    """No allocation near the float64 densify: tracemalloc's peak over the
    construction and over ``predict`` of a 50,000 x 1,000 CSR matrix."""
    rng = np.random.RandomState(4)
    n, F = 50_000, 1_000
    S = sp.random(n, F, density=0.005, format="csr", random_state=rng,
                  dtype=np.float64)
    y = (np.asarray(S[:, :10].sum(1)).ravel() > 0.02).astype(float)
    dense_bytes = n * F * 8
    small = ltt.train(PARAMS, ltt.Dataset(S[:3000], label=y[:3000],
                                          params=PARAMS), num_boost_round=2)
    tracemalloc.start()
    try:
        ds = ltt.Dataset(S, label=y, params=PARAMS).construct()
        build_peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.reset_peak()
        pred = small.predict(S, raw_score=True)
        predict_peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert ds._constructed.binned.shape == (F, n)
    assert pred.shape == (n,)
    assert build_peak < dense_bytes / 40, build_peak
    assert predict_peak < dense_bytes / 4, predict_peak


def test_cv_on_sparse_input():
    """``cv`` over a CSR matrix: its folds' rows taken as sparse rows, each
    fold binned from them, the dense matrix's results bit for bit."""
    S, y = sparse_data(n=1500)
    p = dict(PARAMS, metric="binary_logloss")
    kw = dict(num_boost_round=3, nfold=3, seed=1)
    rs = ltt.cv(p, ltt.Dataset(S, label=y, params=p), **kw)
    rd = ltt.cv(p, ltt.Dataset(S.toarray(), label=y, params=p), **kw)
    assert rs == rd and len(rs["valid binary_logloss-mean"]) == 3
