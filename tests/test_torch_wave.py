"""Wave growth: the JAX package's wave loop vs the port's, on the CPU.

``lightgbm_tpu.ops.grow.build_tree`` (``build_tree_impl`` compiled
whole, as the training path runs it) with ``wave=True`` runs the
segsum histograms and the XLA split scan; the port's ``build_tree`` runs
its plain versions (the routed pass routes the rows, kernel M's plain
version builds the root).  Then ``ltt.train`` against ``lgb.train`` with
wave growth, quantized or not.

Tolerances, and why:

- one tree: split records (leaf, feature, threshold, default_left,
  left_mask, valid) and the final leaf assignment identical.  Child and
  leaf stats within rtol 1e-5 plus, for float gradients, 1e-6 times the
  root's sum of |g| (the port sums histograms in float64 and rounds
  once, the reference in float32); quantized stats are integers times a
  scale, equal but for the last ulp where the reference's compile fuses
  a multiply-add the port does not.  ``leaf_stats_exact`` (the renewal
  sums of the raw gradients) within rtol 1e-5 plus the reference's own
  float32 rounding of a leaf's sum, count * 2^-24 * sum|g|; its count
  channel exact.  Quantized sums are exact on both sides, and the port's
  split scan adds its prefixes in the reference's order with its fused
  multiply-adds, so quantized trees tie-break as the reference does even
  in leaves of a few rows.
- training: the slice test's contract (identical split features,
  thresholds, decision types, children and counts; predictions within
  1e-5).  The two-column cases train the L2 objective, whose gradients
  are exact float32 on both sides: the port's binary gradients are
  rounded once from float64 and can differ from the reference's float32
  ``exp`` by an ulp, which moves the max-abs quantization scale, and
  exactly tied candidates then break differently; the two-column tree
  above holds the binary-style case on identical gradients.  From the
  second tree on, the inputs differ in the last ulp on every objective:
  the renewed leaf values come from float64 sums in the port and
  float32 row-order sums in the reference, so the scores, the gradients
  and the scale move by an ulp.  Exact ties in quantized sums (two
  thresholds around a bin the leaf's rows left, which holds only a
  subtraction residual) can then break differently.  The two-column case
  keeps ``min_sum_hessian_in_leaf`` at 5, so no leaf holds a handful of
  rows, where such ties are common, and its seeded data holds none in
  three trees; the one-tree tests hold the two-column path, ties and
  all, on identical gradients.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as ltt  # noqa: E402
from lightgbm_tpu.ops.grow import GrowParams as JGrowParams  # noqa: E402
from lightgbm_tpu.ops.grow import build_tree as jax_build_tree  # noqa: E402
from lightgbm_tpu.ops.split import SplitParams as JSplitParams  # noqa: E402
from lightgbm_tpu_torch.ops.grow import GrowParams, build_tree  # noqa: E402
from lightgbm_tpu_torch.ops.split import SplitParams  # noqa: E402
from lightgbm_tpu_torch.utils import prng  # noqa: E402

from test_torch_quant import assert_same_trees  # noqa: E402
from test_torch_slice import _data  # noqa: E402

RTOL_STATS = 1e-5


def _wave_data(with_missing):
    """The data of tests/test_wave.py: 8192 rows x 6 features, 13 value
    bins plus a missing bin on every feature (10% of rows)."""
    rng = np.random.RandomState(1)
    N, F = 8192, 6
    bins = rng.randint(0, 13, size=(F, N)).astype(np.uint8)
    nbins = np.full(F, 14, np.int32)
    mt = np.zeros(F, np.int32)
    if with_missing:
        bins[rng.random_sample((F, N)) < 0.1] = 13
        mt[:] = 2
    grad = rng.randn(N).astype(np.float32)
    hess = np.ones(N, np.float32)
    return bins, nbins, mt, grad, hess


def _both(L, W, with_missing, quantize=0, two_col=False):
    bins, nb, mt, grad, hess = _wave_data(with_missing)
    F, N = bins.shape
    kw = dict(max_bin=16, min_data_in_leaf=0 if two_col else 5,
              min_sum_hessian_in_leaf=1e-3, any_missing=with_missing,
              counts_proxy=two_col)
    key = prng.fold_in(prng.prng_key(7), 3)
    jp = JGrowParams(split=JSplitParams(any_cat=False, **kw), num_leaves=L,
                     hist_impl="segsum", wave=True, speculate=W,
                     quantize=quantize, two_col=two_col)
    ref = jax_build_tree(jnp.asarray(bins), jnp.asarray(grad),
                         jnp.asarray(hess), jnp.ones(N, jnp.float32),
                         jnp.ones(F, bool), jnp.asarray(nb),
                         jnp.asarray(mt), jnp.zeros(F, bool), jp,
                         quant_key=jnp.asarray(key))
    tp = GrowParams(split=SplitParams(**kw), num_leaves=L, quantize=quantize,
                    two_col=two_col, wave=True, speculate=W)
    t = lambda a: torch.from_numpy(np.array(a))
    got = build_tree(t(bins), t(grad), t(hess), torch.ones(N),
                     torch.ones(F, dtype=torch.bool), t(nb), t(mt), tp,
                     quant_key=key)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in got.items()}
    return ref, got, grad, bins


def _assert_same_tree(ref, got, grad, quantized, float_atol=1e-6):
    valid = ref["valid"]
    assert valid.any()
    np.testing.assert_array_equal(got["valid"], valid)
    assert int(got["n_leaves"]) == int(ref["n_leaves"])
    for k in ("leaf", "feature", "threshold", "default_left", "left_mask"):
        np.testing.assert_array_equal(got[k][valid], ref[k][valid], k)
    li = got["leaf_idx"].astype(np.int64)
    np.testing.assert_array_equal(li, ref["leaf_idx"].astype(np.int64))
    # the reference's float32 rounding of a sum over a leaf's rows:
    # count * 2^-24 * sum |g|, per leaf (the port rounds once)
    L = len(ref["leaf_stats"])
    cnt = np.bincount(li, minlength=L)[:L]
    absg = np.bincount(li, weights=np.abs(grad), minlength=L)[:L]
    f32_bound = (cnt * 2.0 ** -24 * absg)[:, None]
    for k in ("leaf_stats", "left_stats", "right_stats"):
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL_STATS,
                                   atol=0 if quantized else
                                   float_atol * np.abs(grad).sum(),
                                   err_msg=k)
    if quantized:
        ex_r, ex_g = ref["leaf_stats_exact"], got["leaf_stats_exact"]
        assert np.all(np.abs(ex_g - ex_r) <= RTOL_STATS * np.abs(ex_r) +
                      f32_bound)
        np.testing.assert_array_equal(ex_g[:, 2], ex_r[:, 2])


@pytest.mark.parametrize("L,W", [(3, 2), (16, 8), (31, 21)])
@pytest.mark.parametrize("with_missing", [False, True])
def test_wave_tree_matches_jax(L, W, with_missing):
    ref, got, grad, _ = _both(L, W, with_missing)
    assert int(got["n_leaves"]) == L
    _assert_same_tree(ref, got, grad, False)
    # self-consistency (tests/test_wave.py): recorded leaf stats are the
    # stats of the rows routed there
    li = got["leaf_idx"]
    for leaf in range(L):
        rows = li == leaf
        assert abs(rows.sum() - got["leaf_stats"][leaf, 2]) < 0.5


@pytest.mark.parametrize("two_col", [False, True])
@pytest.mark.parametrize("with_missing", [False, True])
def test_quantized_wave_tree_matches_jax(two_col, with_missing):
    L, W = (40, 16) if two_col else (31, 8)
    ref, got, grad, _ = _both(L, W, with_missing, quantize=120,
                              two_col=two_col)
    _assert_same_tree(ref, got, grad, True)
    assert int(got["n_waves"]) >= 2


# (name, objective, nan, data seed, extra params)
TRAIN_CASES = [
    ("float_waves", "binary", False, 31, {"wave_splits": True,
                                          "num_leaves": 31}),
    ("float_waves", "regression", True, 32, {"wave_splits": True,
                                             "num_leaves": 31}),
    ("two_col_w64", "regression", False, 1, {
        "wave_splits": True, "use_quantized_grad": True, "num_leaves": 127,
        "min_data_in_leaf": 0, "min_sum_hessian_in_leaf": 5.0}),
]


@pytest.mark.parametrize("case", TRAIN_CASES,
                         ids=[f"{c[0]}-{c[1]}-nan{int(c[2])}"
                              for c in TRAIN_CASES])
def test_wave_training_matches_jax(case):
    name, objective, nan, seed, extra = case
    X, y = _data(seed, objective, nan)
    p = {"objective": objective, "max_bin": 63, "verbose": -1,
         "metric": "None", **extra}
    bj = lgb.train(p, lgb.Dataset(X, label=y, params=p), num_boost_round=3,
                   verbose_eval=False)
    pt = dict(p, device_type="cpu")
    bt = ltt.train(pt, ltt.Dataset(X, label=y, params=pt), num_boost_round=3)
    gp = bt._gbdt.grow_params
    assert gp.wave and gp.speculate == bj._gbdt.grow_params.speculate
    assert gp.speculate == {"float_waves": 21, "two_col_w64": 64}[name]
    assert bt._gbdt._counts_proxy == (name == "two_col_w64")
    assert_same_trees(bj, bt, X, 3)
    if name == "two_col_w64":
        # counts restored from the renewal sums: leaves sum to N
        for tr in bt.models:
            assert int(tr.leaf_count[:tr.num_leaves].sum()) == len(y)
            assert int(tr.internal_count[0]) == len(y)


def _gate_data(F, seed=41, n=2000):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    return X, (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)


def test_c2f_gate_raises_and_trains_without_refinement():
    """The coarse-to-fine gate (``refine_shift``) resolves as the JAX
    package's on the same data: 4 at 255 bins, 3 at 63 bins (with the
    features x padded bins >= 7000 stream gate met), 0 below the stream
    gate or with hist_refinement=false; and wave255's tier trains."""
    X28, y28 = _gate_data(28)
    X112, y112 = _gate_data(112, n=600)
    cases = [(X28, y28, 255, {}, 4), (X112, y112, 63, {}, 3),
             (X28, y28, 63, {}, 0),
             (X28, y28, 255, {"hist_refinement": False}, 0)]
    for X, y, max_bin, extra, want in cases:
        p = {"objective": "binary", "max_bin": max_bin, "num_leaves": 15,
             "wave_splits": True, "verbose": -1, **extra}
        bj = lgb.Booster(params=p, train_set=lgb.Dataset(X, label=y,
                                                         params=p))
        pt = dict(p, device_type="cpu")
        bt = ltt.Booster(params=pt, train_set=ltt.Dataset(X, label=y,
                                                          params=pt))
        got = bt._gbdt.grow_params.refine_shift
        assert got == bj._gbdt.grow_params.refine_shift == want, \
            (max_bin, extra)
    p = {"objective": "binary", "max_bin": 255, "num_leaves": 15,
         "wave_splits": True, "verbose": -1, "device_type": "cpu"}
    bt = ltt.train(p, ltt.Dataset(X28, label=y28, params=p),
                   num_boost_round=2)
    assert bt._gbdt.grow_params.refine_shift == 4
    assert bt.num_trees() == 2 and bt._gbdt.max_bin == 256
    assert bt.models[0].num_leaves == 15


# (name, extra params): the exact loop, float waves and two-column
# quantized waves, each with a binding depth limit (31 leaves > 2^4)
DEPTH_CASES = [
    ("exact", {}),
    ("float_waves", {"wave_splits": True}),
    ("two_col_w64", {"wave_splits": True, "use_quantized_grad": True,
                     "min_data_in_leaf": 0, "min_sum_hessian_in_leaf": 5.0}),
]


@pytest.mark.parametrize("name,extra", DEPTH_CASES,
                         ids=[c[0] for c in DEPTH_CASES])
def test_max_depth_training_matches_jax(name, extra):
    """The depth limit folded into the split scan (kernel S applies it on
    the card; the plain version here) grows the JAX package's trees:
    identical splits and counts at max_depth=4, no tree deeper than 4."""
    X, y = _data(51, "regression", True)
    p = {"objective": "regression", "max_bin": 63, "num_leaves": 31,
         "max_depth": 4, "verbose": -1, "metric": "None", **extra}
    bj = lgb.train(p, lgb.Dataset(X, label=y, params=p), num_boost_round=3,
                   verbose_eval=False)
    pt = dict(p, device_type="cpu")
    bt = ltt.train(pt, ltt.Dataset(X, label=y, params=pt), num_boost_round=3)
    assert bt._gbdt.grow_params.max_depth == 4
    assert bt._gbdt.grow_params.wave == (name != "exact")
    assert_same_trees(bj, bt, X, 3)
    for tr in bt.models:
        assert 1 < tr.num_leaves <= 16
        assert int(np.max(tr.leaf_depth[:tr.num_leaves])) == 4
