"""Exclusive feature bundling (EFB) in the port (``device_type=cpu``)
against the JAX package (``JAX_PLATFORMS=cpu``): the bundles, their maps,
the bundle matrix, the bundling decision and the default bin's rebuild.

Data: ``tests/test_efb.py``'s one-hot generator (8 blocks of 6 indicator
columns, 3,000 rows), the same at 60,000 rows (above the 50,000-row
sample conflicts are counted on), and sparse columns that overlap on a
few rows (conflicts, bundled at ``max_conflict_rate=0.1`` and not at 0).

Tolerances: none.  The groups, offsets, bin counts, the four maps and the
bundle matrix's bytes equal the JAX package's (``lightgbm_tpu/io/
bundle.py``), with conflicting rows written by the later member in both;
the decision (bundled or not, committed width, the tiers it turns off, the
histogram pool counted over bundle columns) equals the JAX package's
``GBDT``.  ``expand`` and its bin sum equal the JAX package's expression
compiled by XLA on the CPU bit for bit (``ops/grow.py`` ``bin_sum``:
windows of 32 bins, the padding split around them).
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
from lightgbm_tpu.io.bundle import find_bundles as jfind  # noqa: E402
from lightgbm_tpu_torch.io.bundle import find_bundles  # noqa: E402
from lightgbm_tpu_torch.ops.grow import bin_sum, expand  # noqa: E402
from test_efb import _sparse_onehot_data  # noqa: E402

PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
          "min_data_in_leaf": 0, "min_sum_hessian_in_leaf": 1,
          "verbose": -1, "metric": "None"}
# bundle widths: up to one window, two, three and more, each with the
# padding XLA splits around them
SUM_WIDTHS = (2, 7, 16, 25, 31, 32, 33, 48, 63, 64, 65, 80, 96, 100, 127,
              128, 160, 200, 255, 256)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conflict_data(n=4000, F=24, density=0.04, seed=3):
    """Sparse columns of small integers, overlapping on a few rows."""
    rng = np.random.RandomState(seed)
    X = rng.randint(1, 4, size=(n, F)) * (rng.rand(n, F) < density)
    y = (X[:, :4].sum(1) + rng.rand(n) > 1.5).astype(float)
    return X.astype(float), y


def _onehot(n=3000, cards=6, groups=8):
    X, y = _sparse_onehot_data(np.random.RandomState(0), n=n, groups=groups,
                               cards=cards)
    return X, (y > np.median(y)).astype(float)


DATA = {
    "onehot": lambda: _onehot(),
    "onehot 60k rows": lambda: _onehot(n=60_000),
    "overlapping columns": lambda: _conflict_data(),
}


def _both(X, y, params):
    """The two packages' constructed datasets and boosters (no tree)."""
    bj = lgb.Booster(params=params,
                     train_set=lgb.Dataset(X, label=y, params=params))
    pt = dict(params, device_type="cpu")
    bt = ltt.Booster(params=pt, train_set=ltt.Dataset(X, label=y, params=pt))
    return bj, bt


def _inputs(bt):
    """(binned (F, N) tensor, num_bins, default bins) of the port's set."""
    ts = bt._gbdt.train_set
    ms = [ts.mappers[i] for i in ts.used_features]
    nb = np.asarray([m.num_bin for m in ms], np.int32)
    db = np.asarray([0 if m.bin_type else m.default_bin for m in ms],
                    np.int32)
    return ts.binned, nb, db


def _same_bundles(a, b):
    assert a.groups == b.groups
    for k in ("group_id", "offsets", "default_bin", "group_num_bins",
              "is_singleton"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("data", list(DATA))
def test_bundles_maps_and_matrix_equal_jax(data, rate):
    X, y = DATA[data]()
    bj, bt = _both(X, y, PARAMS)
    xt, nb, db = _inputs(bt)
    binned = np.asarray(bj._gbdt.train_set.binned)
    np.testing.assert_array_equal(xt.numpy(), binned.T)
    want = jfind(binned, nb, db, max_conflict_rate=rate, bin_budget=63)
    # on the device's (F, N) matrix and on the host's (N, F) copy
    for got in (find_bundles(xt, nb, db, rate, 63),
                find_bundles(binned, nb, db, rate, 63)):
        _same_bundles(want, got)
    nz = binned != db[None, :]
    clash = max(int((nz[:, g].sum(1) > 1).sum()) for g in want.groups)
    if data == "overlapping columns":
        # every column holds values: conflicts merge them only at 0.1
        assert (clash > 0) == (rate > 0)
    else:
        assert clash == 0
    B = int(max(want.group_num_bins.max(), 2))
    np.testing.assert_array_equal(got.to_bundle_map(B, nb),
                                  want.to_bundle_map(B, nb))
    np.testing.assert_array_equal(got.from_bundle_map(B, nb),
                                  want.from_bundle_map(B, nb))
    # the bundle matrix: numpy and tensor code, the later member written
    # where members conflict
    mat = want.bundle_matrix(binned)
    np.testing.assert_array_equal(got.bundle_matrix(binned), mat)
    cols = got.bundle_columns(xt)
    assert cols.dtype == xt.dtype
    np.testing.assert_array_equal(cols.numpy(), mat.T)
    maps = got.device_maps(B, nb, torch.device("cpu"))
    fix = np.zeros((len(nb), B), np.float32)
    for f in range(len(nb)):
        if not want.is_singleton[want.group_id[f]]:
            fix[f, db[f]] = 1.0
    np.testing.assert_array_equal(maps.fix.numpy(), fix)


@pytest.mark.parametrize("data", ["onehot", "overlapping columns", "dense"])
@pytest.mark.parametrize("loop", ["exact", "quantized waves"])
def test_bundling_decision_equals_jax(data, loop):
    """Bundled where the JAX package bundles, at its committed width
    (not a power of two), with its maps and tiers; unbundled on dense data
    (one group a feature)."""
    if data == "dense":
        rng = np.random.RandomState(5)
        X = rng.randn(2000, 10)
        y = (X[:, 0] > 0).astype(float)
    else:
        X, y = DATA[data]()
    extra = {} if loop == "exact" else {"wave_splits": True,
                                        "use_quantized_grad": True,
                                        "min_data_in_leaf": 1}
    p = dict(PARAMS, num_leaves=63, **extra)
    bj, bt = _both(X, y, p)
    gj, gt = bj._gbdt, bt._gbdt
    assert (gj._bundles is None) == (gt._bundles is None)
    assert gj.max_bin == gt.max_bin
    assert gt._xt.shape[0] == (gt._bundles.num_groups if gt._bundles
                               else gt.num_features)
    for k in ("two_col", "refine_shift", "speculate", "wave"):
        assert getattr(gj.grow_params, k) == getattr(gt.grow_params, k), k
    if gj._bundles is None:
        assert data == "dense" and gt._bundle_maps is None
        return
    assert data != "dense"
    _same_bundles(gj._bundles, gt._bundles)
    assert gt.max_bin == max(int(gt._bundles.group_num_bins.max()),
                             gt.train_set.max_bin_count)
    if data == "onehot":
        assert gt.max_bin == 7
    m = gt._bundle_maps
    for a, b in zip(gj._bundle_maps, (m.group, m.to_bundle, m.from_bundle,
                                      m.fix)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    if loop != "exact":
        # three-column W=42 waves: bundles turn off the two-column passes
        assert gt.grow_params.speculate == 42 and not gt.grow_params.two_col


@pytest.mark.parametrize("bundle", [True, False])
def test_histogram_pool_counts_bundle_columns(bundle):
    """The pool of 15 leaves x 8 bundles x 7 bins x 12 bytes (10,080
    bytes) fits 0.012 MB; the unbundled 15 x 48 x 2 x 12 (17,280) does not:
    the JAX package keeps its pool exactly where the port trains."""
    X, y = _onehot()
    p = dict(PARAMS, histogram_pool_size=0.012, enable_bundle=bundle)
    bj = lgb.Booster(params=p, train_set=lgb.Dataset(X, label=y, params=p))
    assert bj._gbdt.tier_decision["use_hist_pool"] == bundle
    pt = dict(p, device_type="cpu")
    if bundle:
        ltt.train(pt, ltt.Dataset(X, label=y, params=pt), num_boost_round=1)
    else:
        with pytest.raises(NotImplementedError, match="histogram pool"):
            ltt.train(pt, ltt.Dataset(X, label=y, params=pt),
                      num_boost_round=1)


@pytest.mark.parametrize("B", SUM_WIDTHS)
def test_bin_sum_is_xla_order(B):
    rng = np.random.RandomState(B)
    x = (rng.randn(3, 40, B, 3) *
         np.exp(rng.randn(3, 40, B, 3) * 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=2))(x))
    np.testing.assert_array_equal(bin_sum(torch.from_numpy(x)).numpy(), want)


def _jax_expand(hist_cols, stats, bm_group, bm_to, bm_fix):
    """The JAX package's ``expand`` (``lightgbm_tpu/ops/grow.py:507-517``)
    for one leaf, as written there."""
    B = hist_cols.shape[1]
    hf = hist_cols[bm_group]
    idx = jnp.clip(bm_to, 0, B - 1)
    hf = jnp.take_along_axis(hf, idx[..., None], axis=1)
    hf = hf * (bm_to >= 0)[..., None]
    rem = stats[None, :] - jnp.sum(hf, axis=1)
    return hf + bm_fix[..., None] * rem[:, None, :]


@pytest.mark.parametrize("cards", [6, 24, 62, 99])
def test_expand_equals_jax(cards):
    """One-hot blocks of 6, 24, 62 and 99 columns: widths 7, 25, 63 and
    100 (``max_bin=255`` lets a bundle take 99 indicators); float
    histograms of three leaves, each leaf's stats its rows' sums."""
    X, y = _onehot(n=2000, cards=cards, groups=4)
    p = dict(PARAMS, max_bin=63 if cards < 63 else 255)
    bt = ltt.Booster(params=dict(p, device_type="cpu"),
                     train_set=ltt.Dataset(X, label=y, params=dict(
                         p, device_type="cpu")))
    g = bt._gbdt
    assert g._bundles is not None and g.max_bin == cards + 1
    m = g._bundle_maps
    G, B = g._xt.shape[0], g.max_bin
    rng = np.random.RandomState(cards)
    hist = (rng.randn(3, G, B, 3) *
            np.exp(rng.randn(3, G, B, 3))).astype(np.float32)
    hist[..., 2] = np.abs(hist[..., 2])
    stats = (hist[:, 0].astype(np.float64).sum(1) +
             rng.randn(3, 3)).astype(np.float32)
    got = expand(torch.from_numpy(hist), torch.from_numpy(stats), m).numpy()
    fn = jax.jit(_jax_expand)
    for w in range(3):
        want = np.asarray(fn(hist[w], stats[w], m.group.numpy(),
                             m.to_bundle.numpy(), m.fix.numpy()))
        np.testing.assert_array_equal(got[w], want)
