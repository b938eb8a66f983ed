"""The split scans under monotone constraints and the feature penalty: the
port's plain versions against the JAX package's ``find_best_split`` (XLA),
``choose_window`` and ``find_best_split_c2f`` on the CPU.

The case matrix is ``tests/test_split_kernel.py:55-66``'s constrained
cases (monotone with and without missing values, the penalty, all of
them with min_data and min_hessian), on seeded data, plus finite output
bounds, a batch of lanes with bounds of their own, categorical features
under bounds, the coarse-to-fine scans and the bundled shape (652
features of 25 bins).

Contract, and why:

- The choice (feature, threshold, default direction, left mask and left
  stats) is identical in every case.
- The numerical scan's gains are bit for bit the reference's: every
  feature's best gain (one feature unmasked at a time).  Under the clip
  the reference's CPU compile fuses other products of a gain than it
  does unconstrained, and which ones depends on the unit it compiles:
  the standalone ``find_best_split`` fuses the first product in both
  default directions, as the exact loop's step does (``site=LOOP``);
  without the clip (the penalty alone) the root's unconstrained order
  holds.  A wrong guess shows here: 7 of the 35 per-feature gains of the
  monotone cases differ by an ulp under the root's order.
- The categorical scans under bounds, the penalty's product and the
  feature mask: bit for bit too (the standalone categorical scan fuses
  the first products, the root's order).
- ``choose_window`` is eager in the JAX package, one compiled op at a
  time, so nothing is fused there and the gains the port's ``site=None``
  scan fuses may differ by an ulp; the windows are identical.  The
  standalone ``find_best_split_c2f`` compiles as its own unit, so its
  gains are held within rel 1e-6 of the gain's scale (the child gains
  before the parent's is subtracted), its choice exactly.  The growth
  loop's c2f scans are held bit for bit in
  ``tests/test_torch_monotone_train.py``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from lightgbm_tpu.ops.split import SplitParams as JSplitParams  # noqa: E402
from lightgbm_tpu.ops.split import choose_window as j_choose_window  # noqa: E402
from lightgbm_tpu.ops.split import find_best_split as j_best  # noqa: E402
from lightgbm_tpu.ops.split import find_best_split_c2f as j_c2f  # noqa: E402
from lightgbm_tpu_torch.ops import split as ts  # noqa: E402

GAIN_RTOL = 1e-6

# (name, any_missing, miss_rate, monotone, min_data, min_hess, penalty,
# finite bounds)
CASES = [
    ("monotone", True, 0.1, True, 1, 1e-3, False, False),
    ("monotone_nomiss", False, 0.0, True, 1, 1e-3, False, False),
    ("monotone_bounds", True, 0.1, True, 1, 1e-3, False, True),
    ("penalty", False, 0.0, False, 1, 1e-3, True, False),
    ("penalty_missing", True, 0.2, False, 5, 1e-3, True, False),
    ("kitchen_sink", True, 0.15, True, 25, 0.5, True, True),
    ("min_hessian_bounds", True, 0.1, True, 1, 2.0, False, True),
]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hist(rng, F, B, nb, any_missing, miss_rate, n_rows=400, W=1):
    """W leaves of ``n_rows`` rows each over F features: every feature
    sees the same rows, so a leaf's stats agree across features."""
    hist = np.zeros((W, F, B, 3), np.float32)
    for w in range(W):
        g = rng.randn(n_rows).astype(np.float32)
        h = (np.abs(rng.randn(n_rows)) + 0.1).astype(np.float32)
        v = np.stack([g, h, np.ones(n_rows, np.float32)], -1)
        for f in range(F):
            bins = rng.randint(0, nb[f] - (1 if any_missing else 0),
                               size=n_rows)
            if any_missing:
                bins[rng.rand(n_rows) < miss_rate] = nb[f] - 1
            np.add.at(hist[w, f], bins, v)
    return hist, hist[:, 0].sum(axis=1)


def _case(case, seed, W=1, F=7, B=16):
    name, any_missing, miss_rate, mono_on, md, msh, pen_on, finite = case
    rng = np.random.RandomState(seed)
    nb = rng.randint(6, B + 1, size=F).astype(np.int32)
    mt = np.full(F, 2 if any_missing else 0, np.int32)
    hist, parent = _hist(rng, F, B, nb, any_missing, miss_rate, W=W)
    mono = rng.randint(-1, 2, F).astype(np.int32) if mono_on else None
    if mono is not None:
        mono[0] = 1                  # at least one constrained feature
    pen = (0.5 + rng.random_sample(F)).astype(np.float32) if pen_on \
        else None
    bounds = None
    if mono_on:
        bounds = np.tile(np.float32([-np.inf, np.inf]), (W, 1))
        if finite:
            # bounds that bind: around each leaf's own output
            out = -parent[:, 0] / (parent[:, 1] + 1e-15)
            bounds = np.stack([out - 0.02, out + 0.03], 1).astype(np.float32)
    kw = dict(max_bin=B, min_data_in_leaf=md, min_sum_hessian_in_leaf=msh,
              any_missing=any_missing)
    mt_tuple = tuple(mono.tolist()) if mono is not None else ()
    pen_tuple = tuple(pen.tolist()) if pen is not None else ()
    jp = JSplitParams(any_cat=False, monotone=mt_tuple, penalty=pen_tuple,
                      **kw)
    tp = ts.SplitParams(monotone=mt_tuple, penalty=pen_tuple, **kw)
    return hist, parent, nb, mt, mono, pen, bounds, jp, tp


def _j_scan(hist, parent, nb, mt, fm, jp, mono, pen, bounds, is_cat=None):
    F = hist.shape[0]
    return j_best(jnp.asarray(hist), jnp.asarray(parent), jnp.asarray(nb),
                  jnp.asarray(mt), jnp.asarray(np.zeros(F, bool) if is_cat
                                               is None else is_cat),
                  jnp.asarray(fm), jp,
                  monotone=None if mono is None else jnp.asarray(mono),
                  penalty=None if pen is None else jnp.asarray(pen),
                  min_output=None if bounds is None
                  else jnp.float32(bounds[0]),
                  max_output=None if bounds is None
                  else jnp.float32(bounds[1]))


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _t_scan(hist, parent, nb, mt, fm, tp, mono, pen, bounds, site,
            is_cat=None):
    return ts.find_best_split_plain(
        _t(hist), _t(parent), _t(nb), _t(mt), _t(fm), tp, is_cat=_t(is_cat),
        monotone=_t(mono), penalty=_t(pen), bounds=_t(bounds), site=site)


def _assert_same_choice(ref, got, ctx, w=0):
    for k in ("feature", "threshold", "default_left"):
        assert int(ref[k]) == int(got[k][w]), (ctx, k, ref[k], got[k][w])
    np.testing.assert_array_equal(np.asarray(ref["left_mask"]),
                                  got["left_mask"][w].numpy(), ctx)
    np.testing.assert_array_equal(np.asarray(ref["left_stats"]),
                                  got["left_stats"][w].numpy(), ctx)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_constrained_scan_matches_xla(case):
    hist, parent, nb, mt, mono, pen, bounds, jp, tp = _case(
        case, CASES.index(case) + 101)
    F = hist.shape[1]
    site = ts.LOOP if mono is not None else ts.ROOT
    fm = np.ones(F, bool)
    b0 = None if bounds is None else bounds[0]
    ref = _j_scan(hist[0], parent[0], nb, mt, fm, jp, mono, pen, b0)
    got = _t_scan(hist, parent, nb, mt, fm, tp, mono, pen, bounds, site)
    assert float(ref["gain"]) > 0, case[0]
    _assert_same_choice(ref, got, case[0])
    assert float(got["gain"][0]) == float(ref["gain"]), case[0]
    # every feature's best gain, bit for bit
    pf = np.asarray(ref["per_feature_gain"])
    for f in range(F):
        one = np.zeros(F, bool)
        one[f] = True
        g = _t_scan(hist, parent, nb, mt, one, tp, mono, pen, bounds, site)
        assert float(g["gain"][0]) == float(pf[f]), (case[0], f)


def test_root_order_differs_under_the_clip():
    """The fusion site matters: the root's unconstrained order gives other
    bits than the reference's standalone scan on the monotone cases (the
    count the module docstring names), so the test above can fail."""
    differ = total = 0
    for case in CASES:
        if not case[3]:
            continue
        hist, parent, nb, mt, mono, pen, bounds, jp, tp = _case(
            case, CASES.index(case) + 101)
        F = hist.shape[1]
        pf = np.asarray(_j_scan(hist[0], parent[0], nb, mt, np.ones(F, bool),
                                jp, mono, pen, bounds[0])["per_feature_gain"])
        for f in range(F):
            one = np.zeros(F, bool)
            one[f] = True
            g = _t_scan(hist, parent, nb, mt, one, tp, mono, pen, bounds,
                        ts.ROOT)
            total += 1
            differ += float(g["gain"][0]) != float(pf[f])
    assert (differ, total) == (7, 35)


def test_lanes_with_their_own_bounds():
    """A batch of 4 lanes, each with its own finite bounds (one lane pinned
    so that every candidate violates or clips), equals 4 single scans."""
    case = ("lanes", True, 0.1, True, 3, 1e-3, True, True)
    hist, parent, nb, mt, mono, pen, bounds, jp, tp = _case(case, 7, W=4,
                                                            F=9, B=32)
    bounds[2] = [0.5, 0.5]
    F = hist.shape[1]
    fm = np.ones(F, bool)
    fm[4] = False
    got = _t_scan(hist, parent, nb, mt, fm, tp, mono, pen, bounds, ts.LOOP)
    for w in range(4):
        ref = _j_scan(hist[w], parent[w], nb, mt, fm, jp, mono, pen,
                      bounds[w])
        assert float(got["gain"][w]) == float(ref["gain"]), w
        if float(ref["gain"]) > 0:
            _assert_same_choice(ref, got, f"lane {w}", w)


def _cat_case(seed, W=2):
    rng = np.random.RandomState(seed)
    F, B = 6, 16
    nb = np.array([12, 3, 16, 9, 14, 5], np.int32)
    mt = np.array([0, 0, 2, 0, 2, 0], np.int32)
    is_cat = np.array([True, True, False, True, False, False])
    hist, parent = _hist(rng, F, B, nb, True, 0.1, W=W)
    mono = np.array([0, 0, 1, 0, -1, 1], np.int32)
    pen = np.array([0.7, 1.0, 1.2, 0.9, 1.0, 0.6], np.float32)
    out = -parent[:, 0] / (parent[:, 1] + 1e-15)
    bounds = np.stack([out - 0.05, out + 0.05], 1).astype(np.float32)
    kw = dict(max_bin=B, min_data_in_leaf=3, min_data_per_group=10,
              max_cat_to_onehot=4, cat_smooth=5.0, any_missing=True)
    jp = JSplitParams(any_cat=True, monotone=tuple(mono.tolist()),
                      penalty=tuple(pen.tolist()), **kw)
    tp = ts.SplitParams(any_cat=True, monotone=tuple(mono.tolist()),
                        penalty=tuple(pen.tolist()), **kw)
    return hist, parent, nb, mt, is_cat, mono, pen, bounds, jp, tp


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_categorical_under_bounds(seed):
    """Categorical features clip to the lane's bounds with no direction;
    the penalty scales the merged gains; first-max order over all
    features.  Bit for bit against the standalone scan."""
    hist, parent, nb, mt, is_cat, mono, pen, bounds, jp, tp = \
        _cat_case(seed)
    F = hist.shape[1]
    fm = np.ones(F, bool)
    got = _t_scan(hist, parent, nb, mt, fm, tp, mono, pen, bounds, ts.ROOT,
                  is_cat)
    for w in range(hist.shape[0]):
        ref = _j_scan(hist[w], parent[w], nb, mt, fm, jp, mono, pen,
                      bounds[w], is_cat)
        _assert_same_choice(ref, got, f"seed {seed} lane {w}", w)
        assert bool(got["is_cat"][w]) == bool(ref["is_cat"])
        assert float(got["gain"][w]) == float(ref["gain"])
        pf = np.asarray(ref["per_feature_gain"])
        for f in np.nonzero(is_cat)[0]:
            one = np.zeros(F, bool)
            one[f] = True
            g = _t_scan(hist[w:w + 1], parent[w:w + 1], nb, mt, one, tp, mono,
                        pen, bounds[w:w + 1], ts.ROOT, is_cat)
            assert float(g["gain"][0]) == float(pf[f]), (seed, w, f)


def test_categorical_choices_under_the_clip():
    """The categorical cases above choose categorical splits and clipped
    numerical ones, so both scans are held."""
    kinds = set()
    for seed in (1, 2, 3):
        hist, parent, nb, mt, is_cat, mono, pen, bounds, jp, tp = \
            _cat_case(seed)
        got = _t_scan(hist, parent, nb, mt, np.ones(6, bool), tp, mono, pen,
                      bounds, ts.ROOT, is_cat)
        kinds.update(bool(c) for c in got["is_cat"])
    assert kinds == {True, False}


def _c2f_case(seed, W=3, F=6, B=256, shift=4, two_col=False):
    rng = np.random.RandomState(seed)
    nb = rng.randint(100, B, size=F).astype(np.int32)
    mt = np.full(F, 2, np.int32)
    n = 3000
    fine = np.zeros((W, F, B, 3), np.float32)
    for w in range(W):
        g = np.round(rng.randn(n) * 8).astype(np.float32) * 0.125
        h = np.round(rng.rand(n) * 8 + 1).astype(np.float32) * 0.125
        c = h if two_col else np.ones(n, np.float32)
        v = np.stack([g, h, c], -1)
        for f in range(F):
            bins = rng.randint(0, nb[f] - 1, size=n)
            bins[rng.rand(n) < 0.05] = nb[f] - 1
            np.add.at(fine[w, f], bins, v)
    parent = fine[:, 0].sum(axis=1)
    Bc = ((B - 1) >> shift) + 2
    coarse = np.zeros((W, F, Bc, 3), np.float32)
    for f in range(F):
        for j in range(nb[f] - 1):
            coarse[:, f, j >> shift] += fine[:, f, j]
        coarse[:, f, -1] = fine[:, f, nb[f] - 1]
    mono = np.array([1, -1, 0, 1, 0, -1], np.int32)[:F]
    pen = np.array([1.0, 0.5, 1.0, 1.5, 0.8, 1.0], np.float32)[:F]
    out = -parent[:, 0] / (parent[:, 1] + 1e-15)
    bounds = np.stack([out - 0.05, out + 0.1], 1).astype(np.float32)
    bounds[0] = [-np.inf, np.inf]
    kw = dict(max_bin=B, min_data_in_leaf=1 if two_col else 5,
              min_sum_hessian_in_leaf=1.0 if two_col else 1e-3,
              any_missing=True, counts_proxy=two_col,
              monotone=tuple(mono.tolist()), penalty=tuple(pen.tolist()))
    return (fine, coarse, parent, nb, mt, mono, pen, bounds,
            JSplitParams(any_cat=False, **kw), ts.SplitParams(**kw), shift)


@pytest.mark.parametrize("two_col", [False, True])
def test_c2f_scans_under_bounds_and_penalty(two_col):
    fine, coarse, parent, nb, mt, mono, pen, bounds, jp, tp, shift = \
        _c2f_case(5 + two_col, two_col=two_col)
    W, F = coarse.shape[:2]
    R = 2 << shift
    lo = ts.choose_window(_t(coarse), _t(parent), _t(nb), _t(mt), tp, shift,
                          _t(mono), _t(bounds))
    win = np.zeros((W, F, R, 3), np.float32)
    for w in range(W):
        for f in range(F):
            a = int(lo[w, f])
            e = min(a + R, nb[f] - 1)
            win[w, f, :e - a] = fine[w, f, a:e]
    got = ts.find_best_split_c2f(_t(coarse), _t(win), lo, _t(parent), _t(nb),
                                 _t(mt), torch.ones(F, dtype=torch.bool), tp,
                                 shift, _t(mono), _t(pen), _t(bounds),
                                 ts.WAVE)
    shift_g = ts.lane_scalars(_t(parent), tp)[:, 3].numpy()
    for w in range(W):
        jlo = np.asarray(j_choose_window(
            jnp.asarray(coarse[w]), jnp.asarray(parent[w]), jnp.asarray(nb),
            jp, shift, jnp.asarray(mono), jnp.float32(bounds[w, 0]),
            jnp.float32(bounds[w, 1]), missing_type=jnp.asarray(mt)))
        np.testing.assert_array_equal(lo[w].numpy(), jlo)
        ref = j_c2f(jnp.asarray(coarse[w]), jnp.asarray(win[w]),
                    jnp.asarray(jlo), jnp.asarray(parent[w]), jnp.asarray(nb),
                    jnp.ones(F, bool), jp, shift, monotone=jnp.asarray(mono),
                    penalty=jnp.asarray(pen),
                    min_output=jnp.float32(bounds[w, 0]),
                    max_output=jnp.float32(bounds[w, 1]),
                    missing_type=jnp.asarray(mt))
        assert float(ref["gain"]) > 0
        _assert_same_choice(ref, got, f"c2f lane {w}", w)
        g_ref, g_got = float(ref["gain"]), float(got["gain"][w])
        assert abs(g_got - g_ref) <= GAIN_RTOL * (abs(g_ref) + abs(shift_g[w]))


def test_bundled_shape():
    """The bundled shape's scan (652 logical features of 25 bins, as the
    port's EFB expands the one-hot bundles): 2 lanes, monotone on the first
    4 features, the penalty on 4 more."""
    rng = np.random.RandomState(19)
    F, B, W = 652, 25, 2
    nb = rng.randint(2, B + 1, size=F).astype(np.int32)
    mt = np.zeros(F, np.int32)
    hist, parent = _hist(rng, F, B, nb, False, 0.0, n_rows=300, W=W)
    mono = np.zeros(F, np.int32)
    mono[:4] = [1, -1, 1, -1]
    pen = np.ones(F, np.float32)
    pen[4:8] = 0.5
    out = -parent[:, 0] / (parent[:, 1] + 1e-15)
    bounds = np.stack([out - 0.1, out + 0.1], 1).astype(np.float32)
    kw = dict(max_bin=B, min_data_in_leaf=5, any_missing=False,
              monotone=tuple(mono.tolist()), penalty=tuple(pen.tolist()))
    jp = JSplitParams(any_cat=False, **kw)
    tp = ts.SplitParams(**kw)
    fm = np.ones(F, bool)
    got = _t_scan(hist, parent, nb, mt, fm, tp, mono, pen, bounds, ts.LOOP)
    for w in range(W):
        ref = _j_scan(hist[w], parent[w], nb, mt, fm, jp, mono, pen,
                      bounds[w])
        _assert_same_choice(ref, got, f"lane {w}", w)
        assert float(got["gain"][w]) == float(ref["gain"])
        one = np.zeros(F, bool)
        one[:8] = True               # the constrained and penalized features
        g = _t_scan(hist[w:w + 1], parent[w:w + 1], nb, mt, one, tp, mono, pen,
                    bounds[w:w + 1], ts.LOOP)
        r = _j_scan(hist[w], parent[w], nb, mt, one, jp, mono, pen,
                    bounds[w])
        assert float(g["gain"][0]) == float(r["gain"])
        assert int(g["feature"][0]) == int(r["feature"])


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """``find_best_split`` on CPU tensors is the plain version, with the
    constraints and the site passed through."""
    case = CASES[-2]
    hist, parent, nb, mt, mono, pen, bounds, jp, tp = _case(case, 3, W=2)
    fm = np.ones(hist.shape[1], bool)
    a = ts.find_best_split(_t(hist), _t(parent), _t(nb), _t(mt), _t(fm), tp,
                           monotone=_t(mono), penalty=_t(pen),
                           bounds=_t(bounds), site=ts.WAVE)
    b = _t_scan(hist, parent, nb, mt, fm, tp, mono, pen, bounds, ts.WAVE)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_split_params_flags():
    p = ts.SplitParams(max_bin=8)
    assert not p.has_monotone and not p.has_penalty
    assert not ts.SplitParams(max_bin=8, monotone=(0, 0)).has_monotone
    assert ts.SplitParams(max_bin=8, monotone=(0, -1)).has_monotone
    assert not ts.SplitParams(max_bin=8, penalty=(1.0, 1.0)).has_penalty
    assert ts.SplitParams(max_bin=8, penalty=(1.0, 0.5)).has_penalty
