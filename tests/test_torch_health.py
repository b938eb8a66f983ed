"""The numerical-health checks of the port (``models/gbdt.py``,
``utils/health.py``) on its per-iteration blocks, held to the JAX
package's per-iteration path (``JAX_PLATFORMS=cpu``; the port with
``device_type=cpu``).

The JAX package raises ``NumericalHealthError`` rather than grow a NaN
model (``lightgbm_tpu/utils/health.py``): on its per-iteration path
(``_train_one_iter_impl``, ``_train_one_tree``) it checks each host
tree's leaf values, and, when every class tree of an iteration is
constant, the gradients and hessians of all K rows (non-finite gradients
make every gain NaN, and no tree splits).  Its booster takes that path
here by ``booster._gbdt._pipeline_enabled = False`` on its own instance.

Every case feeds both packages the same rows (2,000 x 5, seed 0, 28
features for coarse-to-fine, 48 one-hot columns for the bundled loop) and
expects the port's error at the JAX package's iteration and phase:

- one NaN or one +inf label, regression, on the exact loop, float waves,
  quantized two-column waves, coarse-to-fine, categorical, bundled and
  constrained (monotone and penalty) data, under bagging, GOSS, MVS and
  DART: iteration 0, phase ``"tree"``;
- labels poisoned in place after two clean iterations (regression; binary
  through its sign labels, which the binary objective's gradients read,
  since a NaN label is fatal at ``Dataset`` construction in both
  packages);
- custom gradients: softmax K = 3 through ``train_one_iter(grad, hess)``
  with one row's gradients NaN in every class at iteration 1, and
  ``fobj`` (K = 1); a NaN in one class's row alone leaves that class's
  tree constant and the others split, so neither package checks it (a
  counted parity note);
- a split tree whose host leaf values are not finite (the tree check; a
  non-finite input never lets a tree split, so the test makes one NaN
  leaf value in each package's ``records_to_tree``);
- ``train`` with an infinite label (a validation set, early stopping and
  callbacks), and ``cv``.

After the error the port's booster is at its served boundary: its
``current_iteration()``, ``num_trees()``, model text, training score
(bit for bit), tree ids and feature-fraction stream equal those before
the failing ``update()``.  The JAX package leaves the stop iteration's
constant trees appended and, under DART, its drops out of the score; the
port is held to its own boundary there.  A random forest checks no stop
(``lightgbm_tpu/models/boosting.py:417-439``): on NaN labels both
packages train on, constant trees of NaN values, as a counted parity
note.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
from lightgbm_tpu.utils.health import \
    NumericalHealthError as JaxHealthError  # noqa: E402
import lightgbm_tpu_torch as ltt  # noqa: E402
from lightgbm_tpu_torch.models import gbdt as tgbdt  # noqa: E402
from lightgbm_tpu_torch.utils.health import NumericalHealthError  # noqa: E402
from lightgbm_tpu_torch.utils.log import LightGBMError  # noqa: E402
from test_efb import _sparse_onehot_data  # noqa: E402

ROUNDS = 3
BAD_ROW = 7


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _regression(F=5, seed=0, n=2000):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    return X, X[:, 0] + 0.1 * rng.randn(n)


def _categorical():
    X, y = _regression()
    X[:, 0] = np.floor(np.abs(X[:, 0]) * 3) % 6
    return X, y + X[:, 0]


def _onehot():
    return _sparse_onehot_data(np.random.RandomState(0), n=2000)


QUANT = {"wave_splits": True, "use_quantized_grad": True,
         "min_data_in_leaf": 0}
# (extra parameters, data); every loop trains regression at 7 leaves
LOOPS = {
    "exact": ({}, _regression),
    "float waves": ({"wave_splits": True, "hist_refinement": False},
                    _regression),
    "quantized waves": ({**QUANT, "hist_refinement": False}, _regression),
    "c2f": ({**QUANT, "max_bin": 255}, lambda: _regression(F=28)),
    "categorical": ({"categorical_feature": "0", "wave_splits": True},
                    _categorical),
    "bundled": ({"max_bin": 63}, _onehot),
    "constrained": ({"monotone_constraints": [1, 0, -1, 0, 0],
                     "feature_contri": [1.0, 0.5, 1.0, 1.0, 1.0]},
                    _regression),
    "bagging": ({"bagging_freq": 1, "bagging_fraction": 0.7}, _regression),
    "goss": ({"boosting": "goss"}, _regression),
    "mvs": ({"boosting": "mvs", "bagging_fraction": 0.7}, _regression),
    "dart": ({"boosting": "dart"}, _regression),
}


def _params(extra, pkg):
    p = {"objective": "regression", "num_leaves": 7, "verbose": -1,
         "metric": "None", "num_iterations": ROUNDS, **extra}
    if pkg is ltt:
        p["device_type"] = "cpu"
    return p


def _booster(pkg, extra, X, y):
    p = _params(extra, pkg)
    b = pkg.Booster(params=p, train_set=pkg.Dataset(X, label=y, params=p))
    if pkg is lgb:
        b._gbdt._pipeline_enabled = False
    return b


def _jax_error(b, step=None, rounds=ROUNDS):
    """(iteration, phase) of the JAX booster's error within ``rounds``
    calls of ``step`` (default ``update``)."""
    with pytest.raises(JaxHealthError) as e:
        for _ in range(rounds):
            (step or b.update)()
    return e.value.iteration, e.value.phase


def _state(b):
    g = b._gbdt
    return (b.current_iteration(), b.num_trees(), b.model_to_string(),
            g.train_score(), g._trees_dispatched,
            g._rng_feature.get_state()[1].copy())


def _port_error(b, step=None, rounds=ROUNDS, queued=False):
    """The port's error within ``rounds`` calls of ``step``; the booster
    must be back at the boundary of the failing call.  With ``queued``
    (blocks dispatched ahead before the call) the tree ids and the
    feature-fraction stream are those of the served trees instead."""
    for _ in range(rounds):
        before = _state(b)
        try:
            (step or b.update)()
        except NumericalHealthError as e:
            after = _state(b)
            assert after[:3] == before[:3]
            np.testing.assert_array_equal(after[3], before[3])
            if not queued:
                assert after[4] == before[4]
                np.testing.assert_array_equal(after[5], before[5])
            return e.iteration, e.phase
    pytest.fail("the port trained on non-finite state")


def _poison_label(y, value):
    y = y.copy()
    y[BAD_ROW] = value
    return y


@pytest.mark.parametrize("value", [np.nan, np.inf], ids=["nan", "inf"])
@pytest.mark.parametrize("loop", list(LOOPS))
def test_non_finite_label_raises_as_jax(loop, value):
    extra, data = LOOPS[loop]
    X, y = data()
    y = _poison_label(y, value)
    want = _jax_error(_booster(lgb, extra, X, y))
    bt = _booster(ltt, extra, X, y)
    if loop == "bundled":
        assert bt._gbdt._bundles is not None
    if loop == "c2f":
        assert bt._gbdt.grow_params.refine_shift == 4
    assert _port_error(bt) == want == (0, "tree")


def _poison_jax_labels(b, y):
    """The JAX objective's labels anew (its gradient function re-jitted)."""
    g = b._gbdt
    meta = g.train_set.metadata
    meta.set_label(y)
    g.objective.init(meta, g.num_data)
    g.objective._gradient_fn_jit = None


@pytest.mark.parametrize("valid", [False, True], ids=["alone", "valid set"])
def test_midstream_labels_regression(valid):
    """Two clean iterations, then every third label NaN in place (the
    port's objective reads its labels from the tensor its gradients
    captured): both raise at iteration 2.  A validation set's score is
    back where it was too (its scorer had added the failing tree)."""
    X, y = _regression()
    bad = y.copy()
    bad[::3] = np.nan
    bj, bt = _booster(lgb, {}, X, y), _booster(ltt, {}, X, y)
    if valid:
        bt.add_valid(bt.train_set.create_valid(X[:300], label=y[:300]), "v")
    for _ in range(2):
        bj.update()
        bt.update()
    _poison_jax_labels(bj, bad)
    bt._gbdt.objective.label.copy_(torch.from_numpy(bad.astype(np.float32)))
    scores = [vs.score.clone() for vs in bt._gbdt.valid_sets]
    assert _port_error(bt) == _jax_error(bj) == (2, "tree")
    assert bt.num_trees() == 2
    for vs, before in zip(bt._gbdt.valid_sets, scores):
        assert torch.equal(vs.score, before)


def test_binary_nan_label_is_fatal_in_both():
    X, y = _regression()
    y = _poison_label((y > 0).astype(np.float64), np.nan)
    with pytest.raises(lgb.LightGBMError):
        _booster(lgb, {"objective": "binary"}, X, y)
    with pytest.raises(LightGBMError):
        _booster(ltt, {"objective": "binary"}, X, y)


def test_midstream_labels_binary():
    """Binary: the sign labels the gradients read, NaN in place after two
    clean iterations."""
    X, y = _regression()
    y = (y > 0).astype(np.float64)
    extra = {"objective": "binary"}
    bj, bt = _booster(lgb, extra, X, y), _booster(ltt, extra, X, y)
    for _ in range(2):
        bj.update()
        bt.update()
    import jax.numpy as jnp
    sign = np.asarray(bj._gbdt.objective.sign_label).copy()
    sign[BAD_ROW] = np.nan
    bj._gbdt.objective.sign_label = jnp.asarray(sign)
    bj._gbdt.objective._gradient_fn_jit = None
    bt._gbdt.objective.sign_label[BAD_ROW] = float("nan")
    assert _port_error(bt) == _jax_error(bj) == (2, "tree")


def _softmax_grads(score, y, k):
    """Softmax gradients of a (K, N) float64 score, float32."""
    p = np.exp(score - score.max(axis=0))
    p /= p.sum(axis=0)
    onehot = (np.arange(k)[:, None] == y[None, :]).astype(np.float64)
    return (p - onehot).astype(np.float32), \
        (2.0 * p * (1.0 - p)).astype(np.float32)


@pytest.mark.parametrize("rows", ["every class", "class 1"])
def test_custom_gradients_softmax(rows):
    """K = 3 through ``train_one_iter(grad, hess)``, one row's gradients
    NaN from iteration 1 on: in every class row, each class tree is
    constant and both packages raise at iteration 1; in class 1's row
    alone, class 1's tree is constant and the others split, so the
    iteration is no stop and neither package checks it (a parity note:
    both train on, class 1 constant)."""
    X, y = _regression()
    y = np.digitize(y, [-0.5, 0.5]).astype(np.float64)
    extra = {"objective": "multiclass", "num_class": 3}
    bj, bt = _booster(lgb, extra, X, y), _booster(ltt, extra, X, y)
    bad = slice(None) if rows == "every class" else 1

    def step(b):
        def call():
            score = np.asarray(b._gbdt.train_score(), np.float64) \
                if b is bt else np.asarray(b._gbdt._score, np.float64)
            g, h = _softmax_grads(score, y, 3)
            if b.current_iteration() >= 1:
                g[bad, BAD_ROW] = np.nan
            b._gbdt.train_one_iter(g, h)
        return call

    if rows == "every class":
        assert _port_error(bt, step(bt)) == _jax_error(bj, step(bj)) == \
            (1, "tree")
        assert bt.num_trees() == 3
        return
    for b in (bj, bt):
        for _ in range(ROUNDS):
            step(b)()
        assert b.current_iteration() == ROUNDS
        assert [t.num_leaves == 1 for t in b._gbdt.models[3:]] == \
            [False, True, False] * (ROUNDS - 1)


def test_fobj_nan_gradients():
    X, y = _regression()
    extra = {"objective": "none"}

    def fobj(score, ds):
        g = (score - ds.get_label()).astype(np.float32)
        if np.any(score != 0):
            g[BAD_ROW] = np.nan
        return g, np.ones_like(g)

    bj, bt = _booster(lgb, extra, X, y), _booster(ltt, extra, X, y)
    assert _port_error(bt, lambda: bt.update(fobj=fobj)) == \
        _jax_error(bj, lambda: bj.update(fobj=fobj)) == (1, "tree")


def test_split_tree_with_non_finite_leaf_values(monkeypatch):
    """The tree check: a split tree whose host leaf values hold a NaN,
    made in each package's ``records_to_tree`` from iteration 1 on."""
    X, y = _regression()
    bj, bt = _booster(lgb, {}, X, y), _booster(ltt, {}, X, y)
    bj.update()
    bt.update()
    make_j = bj._gbdt._records_to_tree

    def nan_leaf(tree):
        tree.leaf_value[1] = np.nan
        return tree

    bj._gbdt._records_to_tree = lambda recs: nan_leaf(make_j(recs))
    make_t = tgbdt.records_to_tree
    monkeypatch.setattr(tgbdt, "records_to_tree",
                        lambda *a, **k: nan_leaf(make_t(*a, **k)))
    with pytest.raises(JaxHealthError) as ej:
        bj.update()
    assert _port_error(bt, rounds=1) == \
        (ej.value.iteration, ej.value.phase) == (1, "tree")
    assert "non-finite leaf value" in ej.value.detail


def test_random_forest_trains_on_as_jax():
    """Parity note: a forest's iteration checks no stop in either
    package, so NaN labels give constant trees of NaN values and no
    error."""
    X, y = _regression()
    y = _poison_label(y, np.nan)
    extra = {"boosting": "rf", "bagging_freq": 1, "bagging_fraction": 0.5}
    bj, bt = _booster(lgb, extra, X, y), _booster(ltt, extra, X, y)
    for _ in range(ROUNDS):
        bj.update()
        bt.update()
    for b in (bj, bt):
        assert b.num_trees() == b.current_iteration() == ROUNDS
        assert all(t.num_leaves == 1 and np.isnan(t.leaf_value[0])
                   for t in b._gbdt.models)


def test_train_with_valid_set_and_callbacks_raises():
    """``train`` with an infinite label, a validation set, early stopping
    and callbacks raises in both packages (the JAX package's
    ``test_engine_train_fails_loudly_on_nan``); ``cv`` raises too."""
    X, y = _regression(n=600)
    y = _poison_label(y, np.inf)
    for pkg, err in ((lgb, JaxHealthError), (ltt, NumericalHealthError)):
        p = dict(_params({}, pkg), metric="l2")
        ds = pkg.Dataset(X, label=y, params=p)
        valid = ds.create_valid(X[:100], label=np.zeros(100))
        record = {}
        with pytest.raises(err) as e:
            pkg.train(p, ds, num_boost_round=5, valid_sets=[valid],
                      early_stopping_rounds=2, evals_result=record,
                      callbacks=[pkg.record_evaluation({})],
                      **({"verbose_eval": False} if pkg is lgb else {}))
        assert (e.value.iteration, e.value.phase) == (0, "tree")
        with pytest.raises(err):
            pkg.cv(p, pkg.Dataset(X, label=y, params=p), num_boost_round=3,
                   nfold=2, **({"verbose_eval": False} if pkg is lgb
                               else {}))
