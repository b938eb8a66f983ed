"""Parity of the PyTorch port's kernel modules with the JAX package.

The same numpy inputs (fixed seeds) go through the JAX function and its
counterpart in ``lightgbm_tpu_torch`` on the CPU, where every wrapper
takes its kernel's plain PyTorch version.  The JAX Pallas kernels run in
interpret mode, as the JAX package's own tests run them on the CPU.

Tolerances, and why:

- binned matrix: byte-identical.
- histogram vs ``histogram_segsum``: rtol 1e-6, plus the reference's
  own float32 rounding bound ``n * 2^-24 * sum|v|`` per bucket — the
  port sums in float64 and rounds once, the reference sums in float32 in
  row order.  Dyadic values, whose sums are exact either way, must
  agree exactly.
- histogram vs ``histogram_pallas`` (interpret): rtol 1e-4, plus the bf16
  hi/lo split's bound ``2^-16 * sum|v|`` per bucket.
- best split: identical feature, threshold, default_left and left_mask;
  gain within rtol 1e-6 of the child gains before the parent's gain
  shift is subtracted (prefix sums are float64-rounded in the port,
  float32 scans in the reference, and the subtraction cancels).
- leaf lookup: exact.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from lightgbm_tpu.config import Config as JConfig  # noqa: E402
from lightgbm_tpu.io.dataset import TpuDataset  # noqa: E402
from lightgbm_tpu.ops.histogram import histogram, histogram_segsum  # noqa: E402
from lightgbm_tpu.ops.lookup import take_small  # noqa: E402
from lightgbm_tpu.ops.split import SplitParams as JSplitParams  # noqa: E402
from lightgbm_tpu.ops.split import (find_best_split,  # noqa: E402
                                    find_best_split_pallas)
from lightgbm_tpu_torch.config import Config  # noqa: E402
from lightgbm_tpu_torch.io.dataset import TorchDataset  # noqa: E402
from lightgbm_tpu_torch.ops import histogram as th  # noqa: E402
from lightgbm_tpu_torch.ops import lookup as tl  # noqa: E402
from lightgbm_tpu_torch.ops import split as ts  # noqa: E402

CPU = torch.device("cpu")
HIST_RTOL = 1e-6
HIST_PALLAS_RTOL = 1e-4
GAIN_RTOL = 1e-6


def _raw_matrix(seed, n=4000, F=6, nan=True):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[:, 1] = np.round(X[:, 1] * 3)          # few distinct values
    X[rng.rand(n) < 0.2, 2] = 0.0            # a heavy zero
    if nan:
        X[rng.rand(n) < 0.1, 3] = np.nan
    return X


@pytest.mark.parametrize("case", ["plain", "nan", "zero_as_missing",
                                  "max_bin_15"])
def test_binned_matrix_byte_identical(case):
    X = _raw_matrix(3, nan=case != "plain")
    params = {"max_bin": 15 if case == "max_bin_15" else 63,
              "zero_as_missing": case == "zero_as_missing"}
    ref = TpuDataset.from_raw(X, np.zeros(len(X)), JConfig(params))
    got = TorchDataset.from_raw(X, np.zeros(len(X)), Config(params), CPU)
    assert got.used_features == ref.used_features
    for a, b in zip(ref.mappers, got.mappers):
        assert (a.num_bin, a.missing_type, a.default_bin) == \
            (b.num_bin, b.missing_type, b.default_bin)
        np.testing.assert_array_equal(a.bin_upper_bound, b.bin_upper_bound)
    assert got.binned.dtype == torch.uint8
    np.testing.assert_array_equal(got.binned.numpy(), ref.binned.T)


def _hist_inputs(seed, F=6, N=4000, B=64, dyadic=False):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B - 2, size=(F, N)).astype(np.uint8)
    g = rng.randn(N)
    h = np.abs(rng.randn(N)) + 0.1
    if dyadic:
        g, h = np.round(g * 256) / 256, np.round(h * 256) / 256
    vals = np.stack([g, h, np.ones(N)], -1).astype(np.float32)
    return bins, vals


def _bucket_bound(bins, vals, B, unit):
    """Per-bucket rounding bound of a float32 (or bf16-split) sum:
    count * unit * sum|v|."""
    absh = th.histogram_plain(torch.from_numpy(bins),
                              torch.from_numpy(np.abs(vals)), B).numpy()
    return absh[..., 2:3] * unit * absh


def test_histogram_plain_matches_segsum():
    B = 64
    bins, vals = _hist_inputs(0)
    ref = np.asarray(histogram_segsum(jnp.asarray(bins), jnp.asarray(vals), B))
    got = th.histogram_plain(torch.from_numpy(bins), torch.from_numpy(vals),
                             B).numpy()
    bound = HIST_RTOL * np.abs(ref) + _bucket_bound(bins, vals, B, 2.0 ** -24)
    assert np.all(np.abs(got - ref) <= bound)
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])


def test_histogram_plain_exact_on_dyadic_values():
    B = 64
    bins, vals = _hist_inputs(1, dyadic=True)
    ref = np.asarray(histogram_segsum(jnp.asarray(bins), jnp.asarray(vals), B))
    got = th.histogram_plain(torch.from_numpy(bins), torch.from_numpy(vals),
                             B).numpy()
    np.testing.assert_array_equal(got, ref)


def test_histogram_plain_matches_pallas_interpret(monkeypatch):
    monkeypatch.setenv("LTPU_PALLAS_INTERPRET", "1")
    B = 64
    bins, vals = _hist_inputs(2, N=2048)
    ref = np.asarray(histogram(jnp.asarray(bins), jnp.asarray(vals), B,
                               impl="pallas", rows_per_block=1024))
    got = th.histogram_plain(torch.from_numpy(bins), torch.from_numpy(vals),
                             B).numpy()
    bound = HIST_PALLAS_RTOL * np.abs(ref) + \
        _bucket_bound(bins, vals, B, 2.0 ** -16)
    assert np.all(np.abs(got - ref) <= bound)


def test_masked_histogram_wrapper_takes_plain_on_cpu():
    """On CPU tensors the wrapper is the plain version, and it equals
    the JAX growth loop's ``masked_hist`` (mask x leaf membership)."""
    B = 64
    bins, vals = _hist_inputs(4)
    rng = np.random.RandomState(4)
    leaf_idx = rng.randint(0, 3, size=bins.shape[1]).astype(np.uint8)
    mask = (rng.rand(bins.shape[1]) < 0.9).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    before = th.LAUNCHES["histogram"]
    got = th.masked_histogram(t(bins), t(vals[:, 0]), t(vals[:, 1]), t(mask),
                              t(leaf_idx), torch.tensor(1, dtype=torch.int32),
                              B).numpy()
    assert th.LAUNCHES["histogram"] == before
    m = mask * (leaf_idx == 1)
    jv = np.stack([vals[:, 0] * m, vals[:, 1] * m, m], -1)
    ref = np.asarray(histogram_segsum(jnp.asarray(bins), jnp.asarray(jv), B))
    bound = HIST_RTOL * np.abs(ref) + _bucket_bound(bins, jv, B, 2.0 ** -24)
    assert np.all(np.abs(got - ref) <= bound)


# (name, any_missing, miss_rate, min_data, min_hess, l1, l2, max_delta)
SPLIT_CASES = [
    ("numerical", False, 0.0, 1, 1e-3, 0.0, 0.0, 0.0),
    ("missing", True, 0.1, 1, 1e-3, 0.0, 0.0, 0.0),
    ("missing_dense", True, 0.45, 1, 1e-3, 0.0, 0.0, 0.0),
    ("missing_none_present", True, 0.0, 1, 1e-3, 0.0, 0.0, 0.0),
    ("min_data", True, 0.1, 40, 1e-3, 0.0, 0.0, 0.0),
    ("min_hessian", True, 0.1, 1, 2.0, 0.0, 0.0, 0.0),
    ("l1_l2", True, 0.1, 5, 1e-3, 0.5, 2.0, 0.0),
    ("max_delta", False, 0.0, 5, 1e-3, 0.0, 1.0, 0.3),
    ("kitchen_sink", True, 0.15, 25, 0.5, 0.2, 0.7, 0.5),
]


def _split_inputs(seed, any_missing, miss_rate, F=7, B=16, W=1,
                  n_rows=400):
    """Histograms of W leaves of n_rows rows each over F features: every
    feature sees the same rows, so each leaf's stats are consistent."""
    rng = np.random.RandomState(seed)
    nb = rng.randint(6, B + 1, size=F).astype(np.int32)
    mt = (np.full(F, 2, np.int32) if any_missing else np.zeros(F, np.int32))
    hist = np.zeros((W, F, B, 3), np.float32)
    for w in range(W):
        g = rng.randn(n_rows).astype(np.float32)
        h = (np.abs(rng.randn(n_rows)) + 0.1).astype(np.float32)
        v = np.stack([g, h, np.ones(n_rows, np.float32)], -1)
        for f in range(F):
            bins = rng.randint(0, nb[f] - (1 if any_missing else 0),
                               size=n_rows)
            if any_missing:
                bins[rng.rand(n_rows) < miss_rate] = nb[f] - 1  # missing
            np.add.at(hist[w, f], bins, v)
    parent = hist[:, 0].sum(axis=1)
    return hist, parent, nb, mt


def _gain_shift(parent, kw):
    p = ts.SplitParams(**kw)
    lane = ts.lane_scalars(torch.from_numpy(parent).reshape(-1, 3), p)
    return lane[:, 3].numpy()


def _assert_same_choice(ref, got, ctx, shift):
    for k in ("feature", "threshold", "default_left"):
        assert int(ref[k]) == int(got[k]), (ctx, k, ref[k], got[k])
    np.testing.assert_array_equal(np.asarray(ref["left_mask"]),
                                  np.asarray(got["left_mask"]), ctx)
    g_ref, g_got = float(ref["gain"]), float(got["gain"])
    assert abs(g_got - g_ref) <= GAIN_RTOL * (abs(g_ref) + abs(shift)), \
        (ctx, g_got, g_ref)
    np.testing.assert_allclose(np.asarray(got["left_stats"]),
                               np.asarray(ref["left_stats"]), rtol=1e-5,
                               atol=1e-4, err_msg=ctx)


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
def test_best_split_plain_matches_xla_and_pallas(case, monkeypatch):
    monkeypatch.setenv("LTPU_PALLAS_INTERPRET", "1")
    name, any_missing, miss_rate, md, msh, l1, l2, mds = case
    seed = SPLIT_CASES.index(case) + 11
    hist, parent, nb, mt = _split_inputs(seed, any_missing, miss_rate)
    F, B = hist.shape[1:3]
    kw = dict(max_bin=B, min_data_in_leaf=md, min_sum_hessian_in_leaf=msh,
              lambda_l1=l1, lambda_l2=l2, max_delta_step=mds,
              any_missing=any_missing)
    jp = JSplitParams(any_cat=False, **kw)
    fm = np.ones(F, bool)
    ref = find_best_split(jnp.asarray(hist[0]), jnp.asarray(parent[0]),
                          jnp.asarray(nb), jnp.asarray(mt), jnp.zeros(F, bool),
                          jnp.asarray(fm), jp)
    ref_k = find_best_split_pallas(jnp.asarray(hist[0]), jnp.asarray(parent[0]),
                                   jnp.asarray(nb), jnp.asarray(mt),
                                   jnp.asarray(fm), jp)
    got = ts.find_best_split_plain(
        torch.from_numpy(hist), torch.from_numpy(parent), torch.from_numpy(nb),
        torch.from_numpy(mt), torch.from_numpy(fm), ts.SplitParams(**kw))
    got = {k: v[0] for k, v in got.items()}
    assert float(ref["gain"]) > 0, name     # a real split is chosen
    shift = _gain_shift(parent[0], kw)[0]
    _assert_same_choice(ref, got, name + "/xla", shift)
    _assert_same_choice(ref_k, got, name + "/pallas", shift)


def test_best_split_batched_lanes_and_feature_mask():
    """A (W, F, B, 3) batch equals W single-leaf scans, with a feature
    mask and a leaf that cannot split (all gains masked)."""
    hist, parent, nb, mt = _split_inputs(5, True, 0.1, F=9, B=32, W=3)
    F, B = hist.shape[1:3]
    fm = np.ones(F, bool)
    fm[[0, 4]] = False
    kw = dict(max_bin=B, min_data_in_leaf=3, any_missing=True)
    jp = JSplitParams(any_cat=False, **kw)
    hist[2] = 0.0                          # an empty leaf
    parent[2] = 0.0
    got = ts.find_best_split(
        torch.from_numpy(hist), torch.from_numpy(parent), torch.from_numpy(nb),
        torch.from_numpy(mt), torch.from_numpy(fm), ts.SplitParams(**kw))
    for w in range(3):
        ref = find_best_split(jnp.asarray(hist[w]), jnp.asarray(parent[w]),
                              jnp.asarray(nb), jnp.asarray(mt),
                              jnp.zeros(F, bool), jnp.asarray(fm), jp)
        one = {k: v[w] for k, v in got.items()}
        if w == 2:
            assert float(one["gain"]) <= 0 and float(ref["gain"]) <= 0
            assert int(one["feature"]) == int(ref["feature"])
            assert int(one["threshold"]) == int(ref["threshold"])
        else:
            _assert_same_choice(ref, one, f"lane{w}",
                                _gain_shift(parent[w], kw)[0])


def test_take_small_plain_matches_take_small_exactly():
    rng = np.random.RandomState(6)
    vals = rng.randn(255).astype(np.float32)
    idx = rng.randint(0, 255, size=5000).astype(np.uint8)
    ref = np.asarray(take_small(jnp.asarray(vals), jnp.asarray(idx)))
    got = tl.take_small_plain(torch.from_numpy(vals), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), ref)
    score = rng.randn(5000).astype(np.float32)
    s = torch.from_numpy(score.copy())
    before = tl.LAUNCHES["leaf_lookup"]
    tl.take_small_add(s, torch.from_numpy(vals), torch.from_numpy(idx))
    assert tl.LAUNCHES["leaf_lookup"] == before
    np.testing.assert_array_equal(s.numpy(), score + ref)
