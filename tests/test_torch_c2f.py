"""Coarse-to-fine refinement: the JAX package vs the port, on the CPU.

The same numpy inputs (fixed seeds) go through the JAX function and its
counterpart in ``lightgbm_tpu_torch``; every wrapper takes its kernel's
plain PyTorch version because the tensors lie on the CPU.  The JAX Pallas
kernels run in interpret mode, as the JAX package's own tests run them.

Tolerances, and why:

- coarse batched histogram (kernel M's plain version at ``shift`` 3 and
  4, with and without the reserved missing slot), coarse routed pass
  (kernel R's), windowed histograms (kernels V and V-lanes) against the
  segsum references and the interpret-mode kernels: exact, on integer
  (quantized) values, whose sums are exact on both sides;
- ``choose_window`` / ``find_best_split_c2f``, batched over children,
  against the JAX functions child by child on quantized histograms:
  window starts, feature, threshold, default direction, left stats and
  left mask identical, gains bit-equal.  One exception: with the counts
  proxy and missing values, the reference's standalone compile of
  ``find_best_split_c2f`` fuses some default-left window gains otherwise
  than its growth loop does (which the tree tests hold the port to); a
  gain there may differ by one float32 ulp;
- one tree, ``build_tree(refine_shift=3)`` against the JAX ``build_tree``
  (``build_tree_impl`` compiled whole, as training runs it) at
  ``tests/test_c2f.py``'s shapes: split records and leaf assignment
  identical; quantized stats and gains equal; float stats within rtol
  1e-5 plus 1e-5 times the root's sum of |g|, ten times
  ``test_torch_wave.py``'s bound: a split's left stats are a coarse
  prefix plus a window prefix of bins that the reference sums in float32
  (the port in float64), and a child's stats come from its parent's by
  subtraction, so each bin's rounding reaches the leaves through more
  additions than on the full-resolution path;
- one training at 28 features x 255 bins (the gate resolves
  ``refine_shift = 4`` on both sides), two-column quantized, L2, NaN in
  one feature: ``test_torch_quant.py``'s contract (identical trees,
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
from lightgbm_tpu.ops import histogram as jh  # noqa: E402
from lightgbm_tpu.ops import split as js  # noqa: E402
from lightgbm_tpu.ops.grow import GrowParams as JGrowParams  # noqa: E402
from lightgbm_tpu.ops.grow import build_tree as jax_build_tree  # noqa: E402
from lightgbm_tpu_torch.ops import histogram as th  # noqa: E402
from lightgbm_tpu_torch.ops import split as ts  # noqa: E402
from lightgbm_tpu_torch.ops.grow import GrowParams, build_tree  # noqa: E402
from lightgbm_tpu_torch.utils import prng  # noqa: E402

from test_torch_quant import assert_same_trees  # noqa: E402
from test_torch_wave import _assert_same_tree  # noqa: E402


def t(a):
    return torch.from_numpy(np.array(a))


def _coarse_inputs(seed, F=5, N=2048, B=64, W=8, miss=True):
    """Integer values, fine bins of B-1 value bins plus, with ``miss``, a
    missing bin B-1 on every other feature (10% of its rows)."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B - 1, size=(F, N)).astype(np.uint8)
    miss_bin = np.full(F, -1, np.int32)
    if miss:
        miss_bin[::2] = B - 1
        for f in range(0, F, 2):
            bins[f, rng.rand(N) < 0.1] = B - 1
    vals = np.stack([rng.randint(-120, 121, N), rng.randint(0, 121, N),
                     np.ones(N)], -1).astype(np.float32)
    sel = rng.randint(-1, W, size=N).astype(np.int32)
    return bins, vals, sel, (miss_bin if miss else None)


def _bc(B, shift, miss):
    return ((B - 1) >> shift) + 1 + int(miss)


@pytest.mark.parametrize("shift,B", [(3, 64), (4, 256)])
@pytest.mark.parametrize("miss", [False, True])
def test_coarse_multi_histogram_matches_segsum(shift, B, miss):
    W = 8
    bins, vals, sel, mb = _coarse_inputs(shift + 2 * miss, B=B, W=W,
                                         miss=miss)
    Bc = _bc(B, shift, miss)
    jmb = None if mb is None else jnp.asarray(mb)
    for two_col in (False, True):
        ref = np.asarray(jh.histogram_segsum_multi(
            jnp.asarray(bins), jnp.asarray(vals), jnp.asarray(sel), Bc, W,
            two_col=two_col, shift=shift, miss_bin=jmb))
        cols = 2 if two_col else 3
        before = th.LAUNCHES["multi_histogram"]
        got = th.multi_histogram(t(bins), t(vals[:, :cols]).to(torch.int8),
                                 t(sel), Bc, W, two_col, shift,
                                 None if mb is None else t(mb)).numpy()
        assert th.LAUNCHES["multi_histogram"] == before
        np.testing.assert_array_equal(got, ref)
    if miss:
        # the reserved slot holds exactly the missing rows of a feature
        full = th.multi_histogram(t(bins), t(vals), t(sel), B, W).numpy()
        np.testing.assert_array_equal(got[:, 0, -1, :2], full[:, 0, -1, :2])


def test_coarse_multi_histogram_matches_pallas_interpret(monkeypatch):
    monkeypatch.setenv("LTPU_PALLAS_INTERPRET", "1")
    B, W, shift = 64, 42, 3
    bins, vals, sel, mb = _coarse_inputs(5, F=3, W=W)
    Bc = _bc(B, shift, True)
    ref = np.asarray(jh.histogram_pallas_multi(
        jnp.asarray(bins), jnp.asarray(vals).astype(jnp.int8),
        jnp.asarray(sel), Bc, W, rows_per_block=1024, exact=True,
        shift=shift, miss_bin=jnp.asarray(mb)))
    got = th.multi_histogram(t(bins), t(vals).to(torch.int8), t(sel), Bc, W,
                             False, shift, t(mb)).numpy()
    np.testing.assert_array_equal(got, ref)


def _routed_tables(rng, F, B, W, L=30):
    li = rng.randint(0, L, size=2048).astype(np.uint8)
    ids = rng.choice(L, size=W, replace=False).astype(np.int32)
    ids[-1] = 256                        # a dummy lane past uint8 ids
    rows = [ids, rng.randint(0, F, W), rng.randint(0, B - 3, W),
            np.arange(L, L + W), rng.randint(0, 2, W), rng.randint(0, 2, W)]
    return li, np.stack(rows).astype(np.int32)


@pytest.mark.parametrize("interpret", [False, True])
def test_coarse_routed_histogram_matches_jax(interpret, monkeypatch):
    """Routing reads fine bins; only the histogram half is coarse."""
    B, W, shift = 64, 8, 3
    bins, vals, _, mb = _coarse_inputs(9, F=3 if interpret else 5, W=W)
    li, tbl = _routed_tables(np.random.RandomState(10), bins.shape[0], B, W)
    Bc = _bc(B, shift, True)
    rest = (jnp.asarray(li), jnp.asarray(tbl), Bc, W)
    if interpret:
        monkeypatch.setenv("LTPU_PALLAS_INTERPRET", "1")
        h, ln, s = jh.histogram_pallas_multi_routed(
            jnp.asarray(bins), jnp.asarray(vals).astype(jnp.int8), *rest,
            rows_per_block=1024, exact=True, shift=shift,
            miss_bin=jnp.asarray(mb))
    else:
        h, ln, s = jh.histogram_segsum_multi_routed(
            jnp.asarray(bins), jnp.asarray(vals), *rest, shift=shift,
            miss_bin=jnp.asarray(mb))
    gh, gl, gs = th.routed_histogram(t(bins), t(vals).to(torch.int8), t(li),
                                     t(tbl), Bc, W, False, t(mb),
                                     shift=shift)
    np.testing.assert_array_equal(gh.numpy(), np.asarray(h))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(ln))
    assert gl.dtype == torch.uint8
    np.testing.assert_array_equal(gs.numpy(), np.asarray(s))


def _window_case(seed, F=3, N=2048, B=64, W=6, shift=3):
    """Windows at both edges (0 and the last coarse-aligned start), rows
    with sel = -1 and missing-bin rows."""
    bins, vals, sel, mb = _coarse_inputs(seed, F=F, N=N, B=B, W=W)
    R = 2 << shift
    rng = np.random.RandomState(seed + 1)
    top = (((B - 1) >> shift) - 1) << shift
    lo = (rng.randint(0, ((B - 1) >> shift), size=(W, F)) << shift)
    lo[0, :] = 0
    lo[1, :] = top
    return bins, vals, sel, mb, lo.astype(np.int32), R


@pytest.mark.parametrize("two_col", [False, True])
def test_window_histogram_matches_segsum(two_col):
    bins, vals, sel, mb, lo, R = _window_case(3)
    W = lo.shape[0]
    assert (sel < 0).any() and (bins == 63).any()
    cols = 2 if two_col else 3
    ref = np.asarray(jh.histogram_segsum_multi_win(
        jnp.asarray(bins), jnp.asarray(vals), jnp.asarray(sel),
        jnp.asarray(lo), R, W, two_col=two_col, miss_bin=jnp.asarray(mb)))
    before = th.LAUNCHES["window_histogram"]
    got = th.window_histogram(t(bins), t(vals[:, :cols]).to(torch.int8),
                              t(sel), t(lo), R, W, two_col, t(mb)).numpy()
    assert th.LAUNCHES["window_histogram"] == before
    np.testing.assert_array_equal(got, ref)
    # without a missing-bin vector the missing rows land in the top window
    nomiss = th.window_histogram_plain(t(bins), t(vals), t(sel), t(lo), R,
                                       W).numpy()
    assert not np.array_equal(nomiss[1], got[1])


def test_window_histogram_matches_pallas_interpret(monkeypatch):
    monkeypatch.setenv("LTPU_PALLAS_INTERPRET", "1")
    bins, vals, sel, mb, lo, R = _window_case(4)
    W = lo.shape[0]
    ref = np.asarray(jh.histogram_pallas_multi_win(
        jnp.asarray(bins), jnp.asarray(vals).astype(jnp.int8),
        jnp.asarray(sel), jnp.asarray(lo), R, W, rows_per_block=1024,
        exact=True, miss_bin=jnp.asarray(mb)))
    got = th.window_histogram(t(bins), t(vals).to(torch.int8), t(sel), t(lo),
                              R, W, False, t(mb)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("interpret", [False, True])
def test_lanes_window_histogram_matches_jax(interpret, monkeypatch):
    """Lane ids against a uint8 leaf vector, dummy lanes carrying 256 (a
    uint8 compare would wrap it onto leaf 0)."""
    bins, vals, _, mb, lo, R = _window_case(6, W=8)
    W = lo.shape[0]
    rng = np.random.RandomState(7)
    li = rng.randint(0, 12, size=bins.shape[1]).astype(np.uint8)
    ids = rng.choice(12, size=W, replace=False).astype(np.int32)
    ids[-2:] = 256
    assert (li == 0).any()
    rest = (jnp.asarray(li), jnp.asarray(ids), jnp.asarray(lo), R, W)
    if interpret:
        monkeypatch.setenv("LTPU_PALLAS_INTERPRET", "1")
        ref = jh.histogram_pallas_multi_win_lanes(
            jnp.asarray(bins), jnp.asarray(vals).astype(jnp.int8), *rest,
            rows_per_block=1024, exact=True, miss_bin=jnp.asarray(mb))
    else:
        ref = jh.histogram_segsum_multi_win_lanes(
            jnp.asarray(bins), jnp.asarray(vals), *rest,
            miss_bin=jnp.asarray(mb))
    before = th.LAUNCHES["lanes_window_histogram"]
    got = th.lanes_window_histogram(t(bins), t(vals).to(torch.int8), t(li),
                                    t(ids), t(lo), R, W, False, t(mb))
    assert th.LAUNCHES["lanes_window_histogram"] == before
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not got[-2:].any()


def _leaf_hists(seed, B, shift, miss, proxy, n_children=4, F=6, N=300):
    """Dequantized coarse histograms, windows and parents of a batch of
    children, with few distinct gradient values (exact ties)."""
    rng = np.random.RandomState(seed)
    nb = np.full(F, B, np.int32)
    mt = np.full(F, 2 if miss else 0, np.int32)
    mb = jnp.asarray(nb - 1) if miss else None
    Bc = _bc(B, shift, miss)
    scale = np.array([0.0071, 0.0021, 0.0021 if proxy else 1.0], np.float32)
    sp = js.SplitParams(max_bin=B, min_data_in_leaf=0 if proxy else 3,
                        min_sum_hessian_in_leaf=1e-3, any_cat=False,
                        any_missing=miss, counts_proxy=proxy)
    cw = jax.jit(js.choose_window, static_argnames=("params", "shift"))
    zs = jnp.zeros(N, jnp.int32)
    out = []
    for _ in range(n_children):
        bins = rng.randint(0, B - 1 if miss else B, size=(F, N))
        if miss:
            bins[rng.rand(F, N) < 0.15] = B - 1
        g = rng.randint(-3, 4, N).astype(np.float32)
        h = rng.randint(0, 3, N).astype(np.float32) if proxy \
            else np.ones(N, np.float32)
        vals = np.stack([g, h, h if proxy else np.ones(N, np.float32)], -1)
        coarse = jh.histogram_segsum_multi(
            jnp.asarray(bins), jnp.asarray(vals), zs, Bc, 1, shift=shift,
            miss_bin=mb)[0] * scale
        parent = jnp.asarray(vals.sum(0) * scale)
        lo = cw(coarse, parent, jnp.asarray(nb), sp, shift,
                missing_type=jnp.asarray(mt))
        win = jh.histogram_segsum_multi_win(
            jnp.asarray(bins), jnp.asarray(vals), zs, lo[None], 2 << shift,
            1, miss_bin=mb)[0] * scale
        ref = js.find_best_split_c2f(coarse, win, lo, parent, jnp.asarray(nb),
                                     jnp.ones(F, bool), sp, shift,
                                     missing_type=jnp.asarray(mt))
        out.append((coarse, win, lo, parent, ref))
    stack = [t(np.stack([np.asarray(o[k]) for o in out])) for k in range(4)]
    tp = ts.SplitParams(max_bin=B, min_data_in_leaf=sp.min_data_in_leaf,
                        min_sum_hessian_in_leaf=1e-3, any_missing=miss,
                        counts_proxy=proxy)
    return stack, [o[4] for o in out], t(nb), t(mt), tp


@pytest.mark.parametrize("shift,B", [(3, 64), (4, 256)])
@pytest.mark.parametrize("miss,proxy", [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_c2f_scans_match_jax(shift, B, miss, proxy):
    (coarse, win, lo, parent), refs, nb, mt, tp = _leaf_hists(
        11 + shift + 2 * miss + 4 * proxy, B, shift, miss, proxy)
    got_lo = ts.choose_window(coarse, parent, nb, mt, tp, shift)
    np.testing.assert_array_equal(got_lo.numpy(), lo.numpy())
    fm = torch.ones(nb.shape[0], dtype=torch.bool)
    got = ts.find_best_split_c2f(coarse, win, lo, parent, nb, mt, fm, tp,
                                 shift)
    for w, ref in enumerate(refs):
        assert float(ref["gain"]) > 0
        for k in ("feature", "threshold", "default_left"):
            assert int(got[k][w]) == int(ref[k]), (w, k)
        np.testing.assert_array_equal(got["left_mask"][w].numpy(),
                                      np.asarray(ref["left_mask"]))
        np.testing.assert_array_equal(got["left_stats"][w].numpy(),
                                      np.asarray(ref["left_stats"]))
        g, r = np.float32(got["gain"][w]), np.float32(ref["gain"])
        if miss and proxy:
            assert abs(g - r) <= np.spacing(r), (w, g, r)
        else:
            assert g == r, (w, g, r)


def _tree_data(with_missing, seed=3, N=8192, F=6, B=63):
    """tests/test_c2f.py's tree data, with 10% missing rows on every
    feature when asked."""
    rng = np.random.RandomState(seed)
    nvb = B - 1 if with_missing else B
    bins = rng.randint(0, nvb, size=(F, N)).astype(np.uint8)
    if with_missing:
        bins[rng.random_sample((F, N)) < 0.1] = B - 1
    logit = (bins[0] / B - 0.5) + 0.7 * (bins[1] > 40) - \
        0.4 * (bins[2] < 9)
    y = (rng.random_sample(N) < 1 / (1 + np.exp(-3 * logit))
         ).astype(np.float32)
    p0 = y.mean()
    grad = (p0 - y + 0.05 * rng.randn(N)).astype(np.float32)
    hess = np.full(N, p0 * (1 - p0), np.float32)
    return (bins, np.full(F, B, np.int32),
            np.full(F, 2 if with_missing else 0, np.int32), grad, hess)


# (num_leaves, W, missing values, quantize, two_col)
TREE_CASES = [(31, 20, False, 0, False), (31, 21, True, 0, False),
              (31, 8, True, 120, False), (40, 16, False, 120, True),
              (63, 16, True, 120, True)]


@pytest.mark.parametrize("case", TREE_CASES,
                         ids=[f"L{c[0]}-W{c[1]}-miss{int(c[2])}-q{c[3]}"
                              f"-twocol{int(c[4])}" for c in TREE_CASES])
def test_c2f_tree_matches_jax(case):
    L, W, with_missing, quantize, two_col = case
    bins, nb, mt, grad, hess = _tree_data(with_missing)
    F, N = bins.shape
    kw = dict(max_bin=63, min_data_in_leaf=0 if two_col else 5,
              min_sum_hessian_in_leaf=1e-3, any_missing=with_missing,
              counts_proxy=two_col)
    key = prng.fold_in(prng.prng_key(7), 3)
    jp = JGrowParams(split=js.SplitParams(any_cat=False, **kw), num_leaves=L,
                     hist_impl="segsum", wave=True, speculate=W,
                     quantize=quantize, two_col=two_col, refine_shift=3)
    ref = jax_build_tree(jnp.asarray(bins), jnp.asarray(grad),
                         jnp.asarray(hess), jnp.ones(N, jnp.float32),
                         jnp.ones(F, bool), jnp.asarray(nb), jnp.asarray(mt),
                         jnp.zeros(F, bool), jp, quant_key=jnp.asarray(key))
    tp = GrowParams(split=ts.SplitParams(**kw), num_leaves=L,
                    quantize=quantize, two_col=two_col, wave=True,
                    speculate=W, refine_shift=3)
    before = dict(th.LAUNCHES)
    got = build_tree(t(bins), t(grad), t(hess), torch.ones(N),
                     torch.ones(F, dtype=torch.bool), t(nb), t(mt), tp,
                     quant_key=key)
    assert th.LAUNCHES == before
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in got.items()}
    _assert_same_tree(ref, got, grad, bool(quantize), float_atol=1e-5)
    assert int(got["n_leaves"]) == L and int(got["n_waves"]) >= 4
    if quantize:
        np.testing.assert_array_equal(got["gain"], ref["gain"])


def test_c2f_training_matches_jax():
    """wave255's tier at a small row count: 28 x 255 bins resolves
    refine_shift = 4 and two-column W = 64 passes on both sides."""
    rng = np.random.RandomState(5)
    N, F = 3000, 28
    X = rng.randn(N, F)
    X[rng.rand(N) < 0.1, 3] = np.nan
    Xn = np.nan_to_num(X)
    y = Xn[:, 0] + 0.5 * X[:, 1] - 0.7 * X[:, 2] * Xn[:, 3] + \
        0.3 * rng.randn(N)
    p = {"objective": "regression", "max_bin": 255, "verbose": -1,
         "metric": "None", "wave_splits": True, "use_quantized_grad": True,
         "num_leaves": 31, "min_data_in_leaf": 0,
         "min_sum_hessian_in_leaf": 5.0}
    bj = lgb.train(p, lgb.Dataset(X, label=y, params=p), num_boost_round=3,
                   verbose_eval=False)
    pt = dict(p, device_type="cpu")
    bt = ltt.train(pt, ltt.Dataset(X, label=y, params=pt), num_boost_round=3)
    gj, gp = bj._gbdt.grow_params, bt._gbdt.grow_params
    assert gp.refine_shift == gj.refine_shift == 4
    assert gp.two_col and gp.speculate == gj.speculate == 31
    assert_same_trees(bj, bt, X, 3)
