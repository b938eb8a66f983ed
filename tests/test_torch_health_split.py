"""The port's split scan on non-finite histograms against the JAX package's
(``JAX_PLATFORMS=cpu``), and the reduction the health words use.

Non-finite gradients reach the split scan as NaN or infinite histogram
cells.  Whether a tree then splits decides where the numerical-health
check fires (``models/gbdt.py``: a tree that cannot split is checked at
the stop, a split tree by its leaf values), so the port's
``find_best_split_plain`` is held to the JAX package's XLA scan
``find_best_split`` and its Pallas kernel (``find_best_split_pallas``,
in interpret mode as ``tests/test_split_kernel.py`` runs it) on
histograms of 400 rows over 7 features and 16 bins, with and without
missing values:

- one row's gradient NaN, +inf or -inf, or its hessian NaN or +inf, added
  to every feature as the passes add it (the parent holds it too);
- one cell NaN or +inf in one feature, the parent finite (no pass makes
  this, but it shows the scan's first-NaN rule);
- the parent's gradient NaN;
- three leaves in one batch, one of them with the NaN row.

What each scan chooses is recorded in ``CHOICES``: none of the three
splits on any of them (the net gain is NaN, or ``NEG_INF`` where a NaN
hessian fails ``min_sum_hessian_in_leaf``; the loops split only where it
is above 0).  The port's record is the XLA scan's, field for field, NaN
for NaN (both take the first NaN as the maximum, as ``torch.max`` and
``jnp.argmax`` do, and kernel S since this slice); the Pallas kernel's
record names its padded feature slot instead, and where a NaN hessian
fails every candidate its left stats differ from the XLA scan's.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from lightgbm_tpu.ops.split import SplitParams as JSplitParams  # noqa: E402
from lightgbm_tpu.ops.split import (find_best_split,  # noqa: E402
                                    find_best_split_pallas)
from lightgbm_tpu_torch.ops import split as ts  # noqa: E402

F, B, ROWS, BAD = 7, 16, 400, 17

POISONS = ("nan_grad", "inf_grad", "ninf_grad", "nan_hess", "inf_hess",
           "nan_cell", "inf_cell", "nan_parent")
# what every scan chooses: (feature, threshold) of the port's and the XLA
# scan's record; none of them splits
CHOICES = {"nan_grad": (0, 0), "inf_grad": (0, 0), "ninf_grad": (0, 0),
           "nan_hess": (0, 0), "inf_hess": (0, 0), "nan_cell": (3, 2),
           "inf_cell": (3, 2), "nan_parent": (0, 0)}


def _inputs(poison, any_missing, seed=3, W=1):
    """(W, F, B, 3) histograms of ROWS rows a leaf, every feature over the
    same rows, the first leaf poisoned; (W, 3) parents; bins; types."""
    rng = np.random.RandomState(seed)
    nb = rng.randint(6, B + 1, size=F).astype(np.int32)
    mt = np.full(F, 2 if any_missing else 0, np.int32)
    hist = np.zeros((W, F, B, 3), np.float32)
    for w in range(W):
        g = rng.randn(ROWS).astype(np.float32)
        h = (np.abs(rng.randn(ROWS)) + 0.1).astype(np.float32)
        if w == 0:
            if poison in ("nan_grad", "inf_grad", "ninf_grad"):
                g[BAD] = {"nan_grad": np.nan, "inf_grad": np.inf,
                          "ninf_grad": -np.inf}[poison]
            if poison in ("nan_hess", "inf_hess"):
                h[BAD] = np.nan if poison == "nan_hess" else np.inf
        v = np.stack([g, h, np.ones(ROWS, np.float32)], -1)
        for f in range(F):
            bins = rng.randint(0, nb[f] - (1 if any_missing else 0),
                               size=ROWS)
            if any_missing:
                bins[rng.rand(ROWS) < 0.1] = nb[f] - 1
            np.add.at(hist[w, f], bins, v)
    parent = hist[:, 0].sum(axis=1)
    if poison in ("nan_cell", "inf_cell"):
        hist[0, 3, 2, 0] = np.nan if poison == "nan_cell" else np.inf
    if poison == "nan_parent":
        parent[0, 0] = np.nan
    return hist, parent, nb, mt


def _scans(hist, parent, nb, mt, any_missing, w=0):
    kw = dict(max_bin=B, min_data_in_leaf=1, min_sum_hessian_in_leaf=1e-3,
              any_missing=any_missing)
    jp = JSplitParams(any_cat=False, **kw)
    fm = np.ones(F, bool)
    args = (jnp.asarray(hist[w]), jnp.asarray(parent[w]), jnp.asarray(nb),
            jnp.asarray(mt))
    xla = find_best_split(*args, jnp.zeros(F, bool), jnp.asarray(fm), jp)
    pallas = find_best_split_pallas(*args, jnp.asarray(fm), jp)
    port = ts.find_best_split_plain(
        torch.from_numpy(hist), torch.from_numpy(parent),
        torch.from_numpy(nb), torch.from_numpy(mt), torch.from_numpy(fm),
        ts.SplitParams(**kw))
    return xla, pallas, {k: v[w].numpy() for k, v in port.items()}


def _same_floats(a, b):
    """Equal where finite, NaN where NaN, the same infinities."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.array_equal(np.isnan(a), np.isnan(b)), (a, b)
    fin = ~np.isnan(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=1e-5, atol=1e-4)


def _assert_same_record(ref, got):
    for k in ("feature", "threshold", "default_left"):
        assert int(ref[k]) == int(got[k]), (k, ref[k], got[k])
    _same_floats(float(ref["gain"]), float(got["gain"]))
    _same_floats(ref["left_stats"], got["left_stats"])
    np.testing.assert_array_equal(np.asarray(ref["left_mask"]),
                                  np.asarray(got["left_mask"]))


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("LTPU_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("any_missing", [False, True],
                         ids=["no missing", "missing"])
@pytest.mark.parametrize("poison", POISONS)
def test_scan_on_non_finite_histograms(poison, any_missing):
    hist, parent, nb, mt = _inputs(poison, any_missing)
    xla, pallas, port = _scans(hist, parent, nb, mt, any_missing)
    for rec in (xla, pallas, port):
        assert not float(rec["gain"]) > 0, poison       # no split
    assert (int(port["feature"]), int(port["threshold"])) == CHOICES[poison]
    _assert_same_record(xla, port)
    if poison == "nan_hess":
        # every candidate fails min_sum_hessian: no NaN gain anywhere
        assert float(port["gain"]) == float(xla["gain"]) == \
            float(pallas["gain"]) < -1e29
        assert (int(pallas["feature"]), int(pallas["threshold"])) == \
            CHOICES[poison]
    else:
        assert np.isnan(float(port["gain"])) and \
            np.isnan(float(pallas["gain"]))
        assert int(pallas["feature"]) >= F       # its padded slot


@pytest.mark.parametrize("poison", ["nan_grad", "inf_grad"])
def test_batched_leaves_keep_their_own_choice(poison):
    """Three leaves in one scan: the poisoned one splits nowhere, the two
    clean ones choose as the XLA scan does, leaf by leaf."""
    hist, parent, nb, mt = _inputs(poison, True, seed=5, W=3)
    for w in range(3):
        xla, _, port = _scans(hist, parent, nb, mt, True, w)
        _assert_same_record(xla, port)
        assert (float(port["gain"]) > 0) == (w > 0), w


@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
def test_health_words_reduction(value, where):
    """``torch.aminmax``, which writes the health words: a NaN or an
    infinity anywhere gives a non-finite minimum or maximum; finite
    values give finite ones (``GBDT._minmax``)."""
    x = torch.from_numpy(np.random.RandomState(0).randn(10007)
                         .astype(np.float32))
    words = torch.zeros(2)
    torch.aminmax(x, out=(words[0], words[1]))
    assert torch.isfinite(words).all()
    i = {"first": 0, "middle": 5003, "last": 10006}[where]
    x[i] = float(value)
    torch.aminmax(x, out=(words[0], words[1]))
    assert not torch.isfinite(words).all()
