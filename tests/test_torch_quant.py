"""Quantized gradients and the batched passes: the JAX package vs the port.

The same numpy inputs (fixed seeds) go through the JAX function and its
counterpart in ``lightgbm_tpu_torch`` on the CPU, where every wrapper
takes its kernel's plain PyTorch version.  The JAX Pallas kernels run in
interpret mode, as the JAX package's own tests run them on the CPU.

Tolerances, and why:

- key words of the quantization stream: exact (the port's numpy
  Threefry against ``jax.random``);
- batched histogram (kernel M's plain version) vs
  ``histogram_segsum_multi``: exact on integer (quantized) values, both
  sums being exact; on float values rtol 1e-6 plus the reference's own
  float32 rounding bound ``count * 2^-24 * sum|v|`` per bucket (the port
  sums in float64 and rounds once);
- vs ``histogram_pallas_multi`` in interpret mode: exact on integers,
  rtol 1e-4 plus ``2^-16 * sum|v|`` on floats (the TPU's bf16 hi/lo
  split);
- routed pass (kernel R's plain version) vs
  ``histogram_segsum_multi_routed`` and ``histogram_pallas_multi_routed``:
  histogram, new leaf vector and selector exact (integer values);
- leaf sums (kernel Q's plain version) vs the JAX fallback
  ``histogram(leaf_idx ...)``: within the reference's float32 rounding;
  vs ``leaf_stats_pallas``: within 2^-16 relative (its hi/lo split);
- the counts-proxy scan vs ``find_best_split(counts_proxy=True)``:
  identical feature, threshold, default_left and left mask, gain and
  left stats bit-equal (same float32 prefix order and fused
  multiply-adds as the reference's CPU compile);
- quantized training without waves, and with W = 42 waves, ``ltt.train``
  vs ``lgb.train``: the slice test's contract (identical trees,
  predictions within 1e-5).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as ltt  # noqa: E402
from lightgbm_tpu.ops.histogram import (histogram,  # noqa: E402
                                        histogram_pallas_multi,
                                        histogram_pallas_multi_routed,
                                        histogram_segsum_multi,
                                        histogram_segsum_multi_routed,
                                        leaf_stats_pallas)
from lightgbm_tpu.ops.split import SplitParams as JSplitParams  # noqa: E402
from lightgbm_tpu.ops.split import find_best_split  # noqa: E402
from lightgbm_tpu_torch.ops import histogram as th  # noqa: E402
from lightgbm_tpu_torch.ops import split as ts  # noqa: E402
from lightgbm_tpu_torch.utils import prng  # noqa: E402

from test_torch_slice import _data  # noqa: E402

PRED_ATOL = 1e-5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", [0, 1, 12345, 0x7FFFFFFF])
def test_prng_key_words_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    mine = prng.prng_key(seed)
    np.testing.assert_array_equal(np.asarray(key), mine)
    for tree in (0, 1, 7, 4099):
        k = jax.random.fold_in(key, tree)
        m = prng.fold_in(mine, tree)
        np.testing.assert_array_equal(np.asarray(k), m)
        kg, kh = jax.random.split(k)
        mg, mh = prng.split(m)
        for a, b in ((kg, mg), (kh, mh)):
            np.testing.assert_array_equal(np.asarray(a), b)
            w = np.asarray(a).ravel()
            assert prng.key_word(b) == int(w[0] ^ w[-1])


def _multi_inputs(seed, F=5, N=3000, B=32, W=42, integer=True):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B - 1, size=(F, N)).astype(np.uint8)
    if integer:
        vals = np.stack([rng.randint(-120, 121, N), rng.randint(0, 121, N),
                         np.ones(N)], -1).astype(np.float32)
    else:
        vals = np.stack([rng.randn(N), np.abs(rng.randn(N)) + 0.1,
                         np.ones(N)], -1).astype(np.float32)
    sel = rng.randint(-1, W, size=N).astype(np.int32)
    return bins, vals, sel


@pytest.mark.parametrize("W,two_col", [(42, False), (64, True)])
def test_multi_histogram_exact_on_integers(W, two_col):
    B = 32
    bins, vals, sel = _multi_inputs(W, W=W)
    ref = np.asarray(histogram_segsum_multi(jnp.asarray(bins),
                                            jnp.asarray(vals),
                                            jnp.asarray(sel), B, W,
                                            two_col=two_col))
    cols = 2 if two_col else 3
    before = th.LAUNCHES["multi_histogram"]
    got = th.multi_histogram(t(bins), t(vals[:, :cols]).to(torch.int8),
                             t(sel), B, W, two_col).numpy()
    assert th.LAUNCHES["multi_histogram"] == before
    np.testing.assert_array_equal(got, ref)


def test_multi_histogram_float_within_rounding():
    B, W = 32, 21
    bins, vals, sel = _multi_inputs(3, W=W, integer=False)
    ref = np.asarray(histogram_segsum_multi(jnp.asarray(bins),
                                            jnp.asarray(vals),
                                            jnp.asarray(sel), B, W))
    got = th.multi_histogram(t(bins), t(vals), t(sel), B, W).numpy()
    absh = th.multi_histogram_plain(t(bins), t(np.abs(vals)), t(sel), B,
                                    W).numpy()
    bound = 1e-6 * np.abs(ref) + absh[..., 2:3] * 2.0 ** -24 * absh
    assert np.all(np.abs(got - ref) <= bound)
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])


@pytest.mark.parametrize("integer", [True, False])
def test_multi_histogram_matches_pallas_interpret(integer, monkeypatch):
    monkeypatch.setenv("LTPU_PALLAS_INTERPRET", "1")
    B, W = 16, 42 if integer else 21
    bins, vals, sel = _multi_inputs(5, F=3, N=2048, B=B, W=W,
                                    integer=integer)
    jv = jnp.asarray(vals).astype(jnp.int8) if integer else jnp.asarray(vals)
    ref = np.asarray(histogram_pallas_multi(
        jnp.asarray(bins), jv, jnp.asarray(sel), B, W, rows_per_block=1024,
        exact=integer))
    got = th.multi_histogram(t(bins), t(vals), t(sel), B, W).numpy()
    if integer:
        np.testing.assert_array_equal(got, ref)
    else:
        absh = th.multi_histogram_plain(t(bins), t(np.abs(vals)), t(sel), B,
                                        W).numpy()
        assert np.all(np.abs(got - ref) <= 1e-4 * np.abs(ref) +
                      2.0 ** -16 * absh)


def _routed_inputs(seed, F=5, N=2048, B=16, W=8, miss=False):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B - 1, size=(F, N)).astype(np.uint8)
    miss_bin = np.full(F, -1, np.int32)
    if miss:
        miss_bin[::2] = B - 2
    vals = np.stack([rng.randint(-120, 121, N), rng.randint(0, 121, N),
                     np.ones(N)], -1).astype(np.float32)
    li = rng.randint(0, 30, size=N).astype(np.uint8)
    ids = rng.choice(30, size=W, replace=False).astype(np.int32)
    ids[-1] = 40                               # a dummy lane (id L)
    rows = [ids, rng.randint(0, F, W), rng.randint(0, B - 3, W),
            np.arange(30, 30 + W), rng.randint(0, 2, W)]
    if miss:
        rows.append(rng.randint(0, 2, W))
    tbl = np.stack(rows).astype(np.int32)
    return bins, vals, li, tbl, (miss_bin if miss else None)


@pytest.mark.parametrize("miss", [False, True])
@pytest.mark.parametrize("two_col", [False, True])
def test_routed_histogram_matches_segsum(miss, two_col):
    B, W = 16, 8
    bins, vals, li, tbl, mb = _routed_inputs(7 + miss, miss=miss)
    h, ln, s = histogram_segsum_multi_routed(
        jnp.asarray(bins), jnp.asarray(vals), jnp.asarray(li),
        jnp.asarray(tbl), B, W, two_col=two_col,
        miss_bin=None if mb is None else jnp.asarray(mb))
    cols = 2 if two_col else 3
    before = th.LAUNCHES["routed_histogram"]
    gh, gl, gs = th.routed_histogram(
        t(bins), t(vals[:, :cols]).to(torch.int8), t(li), t(tbl), B, W,
        two_col, None if mb is None else t(mb))
    assert th.LAUNCHES["routed_histogram"] == before
    np.testing.assert_array_equal(gh.numpy(), np.asarray(h))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(ln))
    assert gl.dtype == torch.uint8
    np.testing.assert_array_equal(gs.numpy(), np.asarray(s))
    if miss:
        # the missing row changed at least one row's route
        _, nl, _ = th.routed_histogram(t(bins), t(vals).to(torch.int8),
                                       t(li), t(tbl[:5]), B, W)
        assert not torch.equal(nl, gl)


def test_routed_histogram_matches_pallas_interpret(monkeypatch):
    monkeypatch.setenv("LTPU_PALLAS_INTERPRET", "1")
    B, W = 16, 8
    bins, vals, li, tbl, mb = _routed_inputs(9, F=3, miss=True)
    h, ln, s = histogram_pallas_multi_routed(
        jnp.asarray(bins), jnp.asarray(vals).astype(jnp.int8),
        jnp.asarray(li), jnp.asarray(tbl), B, W, rows_per_block=1024,
        exact=True, miss_bin=jnp.asarray(mb))
    gh, gl, gs = th.routed_histogram(t(bins), t(vals).to(torch.int8), t(li),
                                     t(tbl), B, W, False, t(mb))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(h))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(ln))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(s))


def _leaf_inputs(seed, N=4096, L=31):
    rng = np.random.RandomState(seed)
    li = rng.randint(0, L, size=N).astype(np.uint8)
    g = rng.randn(N).astype(np.float32)
    h = (np.abs(rng.randn(N)) + 0.1).astype(np.float32)
    m = (rng.rand(N) < 0.9).astype(np.float32)
    return li, g, h, m


def test_leaf_stats_match_jax_fallback_and_pallas(monkeypatch):
    L = 31
    li, g, h, m = _leaf_inputs(11, L=L)
    before = th.LAUNCHES["leaf_stats"]
    got = th.leaf_stats(t(li), t(g), t(h), t(m), L).numpy()
    assert th.LAUNCHES["leaf_stats"] == before
    vals = np.stack([g * m, h * m, m], -1)
    ref = np.asarray(histogram(jnp.asarray(li)[None], jnp.asarray(vals),
                               max_bin=L, impl="segsum"))[0]
    absv = th.leaf_stats_plain(t(li), t(np.abs(g)), t(h), t(m), L).numpy()
    bound = 1e-6 * np.abs(ref) + absv[:, 2:3] * 2.0 ** -24 * absv
    assert np.all(np.abs(got - ref) <= bound)
    np.testing.assert_array_equal(got[:, 2], ref[:, 2])
    monkeypatch.setenv("LTPU_PALLAS_INTERPRET", "1")
    pal = np.asarray(leaf_stats_pallas(jnp.asarray(li), jnp.asarray(g),
                                       jnp.asarray(h), jnp.asarray(m),
                                       rows_per_block=1024))[:L]
    assert np.all(np.abs(got - pal) <= 2.0 ** -16 * absv + 1e-6)


@pytest.mark.parametrize("any_missing", [False, True])
def test_counts_proxy_scan_matches_find_best_split(any_missing):
    """Two-column histograms: the count channel is the hess copy, the
    feasibility test is hessian only."""
    rng = np.random.RandomState(13 + any_missing)
    F, B, n = 6, 32, 60
    nb = np.full(F, 30, np.int32)
    mt = np.full(F, 2 if any_missing else 0, np.int32)
    hist = np.zeros((2, F, B, 3), np.float32)
    parent = np.zeros((2, 3), np.float32)
    scale = np.array([0.0071, 0.0021, 0.0021], np.float32)
    for w in range(2):
        gq = rng.randint(-120, 121, n).astype(np.float32)
        hq = rng.randint(0, 121, n).astype(np.float32)
        ints = np.zeros((F, B, 3), np.float32)
        for f in range(F):
            b = rng.randint(0, 29 if any_missing else 30, n)
            if any_missing:
                b[rng.rand(n) < 0.2] = 29
            np.add.at(ints[f, :, 0], b, gq)
            np.add.at(ints[f, :, 1], b, hq)
        ints[..., 2] = ints[..., 1]
        hist[w] = ints * scale
        parent[w] = np.array([gq.sum(), hq.sum(), hq.sum()],
                             np.float32) * scale
    kw = dict(max_bin=B, min_data_in_leaf=0, min_sum_hessian_in_leaf=0.5,
              any_missing=any_missing, counts_proxy=True)
    got = ts.find_best_split(t(hist), t(parent), t(nb), t(mt),
                             torch.ones(F, dtype=torch.bool),
                             ts.SplitParams(**kw))
    for w in range(2):
        ref = find_best_split(jnp.asarray(hist[w]), jnp.asarray(parent[w]),
                              jnp.asarray(nb), jnp.asarray(mt),
                              jnp.zeros(F, bool), jnp.ones(F, bool),
                              JSplitParams(any_cat=False, **kw))
        assert float(ref["gain"]) > 0
        for k in ("feature", "threshold", "default_left"):
            assert int(got[k][w]) == int(ref[k]), k
        np.testing.assert_array_equal(got["left_mask"][w].numpy(),
                                      np.asarray(ref["left_mask"]))
        assert np.float32(got["gain"][w]) == np.float32(ref["gain"])
        np.testing.assert_array_equal(got["left_stats"][w].numpy(),
                                      np.asarray(ref["left_stats"]))


def assert_same_trees(bj, bt, X, n_trees):
    mj, mt = bj._gbdt.models, bt.models
    assert len(mj) == len(mt) == n_trees
    for a, b in zip(mj, mt):
        assert a.num_leaves == b.num_leaves
        n = a.num_leaves - 1
        for k in ("split_feature", "threshold_bin", "decision_type",
                  "left_child", "right_child", "internal_count"):
            np.testing.assert_array_equal(getattr(a, k)[:n],
                                          getattr(b, k)[:n], k)
        np.testing.assert_array_equal(a.leaf_count[:n + 1],
                                      b.leaf_count[:n + 1])
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True,
                                          predict_engine=False),
                               rtol=0, atol=PRED_ATOL)


@pytest.mark.parametrize("objective,nan", [("binary", True),
                                           ("regression", False)])
def test_quantized_training_without_waves_matches_jax(objective, nan):
    X, y = _data(21 + nan, objective, nan)
    p = {"objective": objective, "num_leaves": 15, "max_bin": 63,
         "verbose": -1, "metric": "None", "use_quantized_grad": True}
    bj = lgb.train(p, lgb.Dataset(X, label=y, params=p), num_boost_round=3,
                   verbose_eval=False)
    pt = dict(p, device_type="cpu")
    bt = ltt.train(pt, ltt.Dataset(X, label=y, params=pt), num_boost_round=3)
    assert bt._gbdt.grow_params.quantize == 120
    assert not bt._gbdt.grow_params.wave
    assert_same_trees(bj, bt, X, 3)


@pytest.mark.parametrize("objective,nan", [("binary", True),
                                           ("regression", False)])
def test_quantized_wave_training_matches_jax(objective, nan):
    """Quantized waves with a real count channel: W = 42 lanes."""
    X, y = _data(25 + nan, objective, nan)
    p = {"objective": objective, "num_leaves": 63, "max_bin": 63,
         "verbose": -1, "metric": "None", "use_quantized_grad": True,
         "wave_splits": True, "min_data_in_leaf": 20}
    bj = lgb.train(p, lgb.Dataset(X, label=y, params=p), num_boost_round=3,
                   verbose_eval=False)
    pt = dict(p, device_type="cpu")
    bt = ltt.train(pt, ltt.Dataset(X, label=y, params=pt), num_boost_round=3)
    gp = bt._gbdt.grow_params
    assert gp.wave and gp.speculate == 42 and not gp.two_col
    assert_same_trees(bj, bt, X, 3)
