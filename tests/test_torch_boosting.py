"""Training with row sampling (bagging, GOSS, MVS) of the port against the
JAX package (``JAX_PLATFORMS=cpu``), and against itself fused.

The contract, and why:

- Each mode (bernoulli bagging at ``bagging_freq=3``, stratified bagging,
  GOSS, MVS) trains 6 rounds on the exact loop and on quantized
  two-column waves, and holds
  the contract of ``tests/test_torch_slice.py``: identical split
  features, thresholds, decision types, children and counts; raw
  predictions within 1e-5.  The exact loop trains the binary objective,
  the waves the L2 objective with ``min_sum_hessian_in_leaf=5``, for the
  reasons ``tests/test_torch_wave.py`` gives (the port's binary gradients
  are rounded once from float64 and can differ from the reference's
  float32 ``exp`` by an ulp, which moves the quantization scale).
- Every iteration's mask is recorded on both sides (the JAX booster's
  ``_bagging_mask`` wrapped from the test, the port's weight function
  likewise).  Bagging's masks are equal at every iteration.  GOSS's and
  MVS's masks are equal wherever the two packages' gradients are the same
  bits; where they are not (from the second tree on the renewed leaf
  values, float64 sums in the port and float32 in the reference, move the
  scores by an ulp), the port's weight function fed the JAX gradients
  gives the JAX mask bit for bit: the difference is the scores', not the
  draw's.
- The coarse-to-fine waves' cases are in
  ``tests/test_torch_boosting_c2f.py`` (the JAX package's compile of that
  loop takes most of a file's time), the fused super-steps' in
  ``tests/test_torch_boosting_fused.py``.
- The configurations the JAX package refuses are refused alike: GOSS with
  bagging, ``top_rate + other_rate > 1``.  DART and random forests train
  (their contracts: ``tests/test_torch_dart.py``, ``tests/test_torch_rf.py``).

The test marked ``cuda`` holds sampled training on the card's CUDA graphs
to its eager launches and to the CPU, and skips here.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu_torch as ltt  # noqa: E402
from lightgbm_tpu_torch.ops import sample  # noqa: E402

ROUNDS = 6
MODES = {
    "bernoulli": {"bagging_fraction": 0.7, "bagging_freq": 3},
    "stratified": {"pos_bagging_fraction": 0.5,
                   "neg_bagging_fraction": 0.9, "bagging_freq": 1},
    "goss": {"boosting": "goss"},
    "mvs": {"boosting": "mvs", "bagging_fraction": 0.6},
}
TWO_COL = {"wave_splits": True, "use_quantized_grad": True,
           "num_leaves": 31, "min_data_in_leaf": 0,
           "min_sum_hessian_in_leaf": 5.0}
PATHS = {
    "exact": {"objective": "binary", "num_leaves": 15, "max_bin": 63},
    "two-column waves": {"objective": "regression", "max_bin": 63,
                         "hist_refinement": False, **TWO_COL},
    "two-column c2f waves": {"objective": "regression", "max_bin": 255,
                             **TWO_COL},
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread, the other workers' cores left
    alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(F, seed=5, n=3000):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n) < 0.1, 3] = np.nan
    Xn = np.nan_to_num(X)
    y = Xn[:, 0] + 0.5 * Xn[:, 1] - 0.7 * Xn[:, 2] * Xn[:, 3] + \
        0.3 * rng.randn(n)
    return X, y


# coarse-to-fine's gate needs features x padded bins >= 7000: 28 x 256
DATA = {"exact": _data(6), "two-column waves": _data(6),
        "two-column c2f waves": _data(28)}


def _xy(path):
    X, y = DATA[path]
    if PATHS[path]["objective"] == "binary":
        y = (y > 0).astype(np.float64)
    return X, y


def _params(path, mode, **kw):
    return {"verbose": -1, "metric": "None", **PATHS[path], **MODES[mode],
            **kw}


# ---------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------
def _train_jax(p, X, y):
    """The JAX booster trained ROUNDS iterations, and each iteration's
    (iteration, grad, hess, mask) from its wrapped ``_bagging_mask``."""
    import lightgbm_tpu as lgb
    b = lgb.Booster(params=p, train_set=lgb.Dataset(X, label=y, params=p))
    g, seen = b._gbdt, []
    draw = g._bagging_mask

    def spy(grad=None, hess=None):
        out = draw(grad, hess)
        seen.append((g.iter, np.asarray(grad[0]), np.asarray(hess[0]),
                     np.asarray(out)))
        return out

    g._bagging_mask = spy
    for _ in range(ROUNDS):
        b.update()
    return b, seen


def _train_port(p, X, y):
    """The port's booster (CPU) trained ROUNDS iterations, and each tree's
    (grad, hess, weights) from its wrapped weight function."""
    p = dict(p, device_type="cpu")
    b = ltt.Booster(params=p, train_set=ltt.Dataset(X, label=y, params=p))
    g, seen = b._gbdt, []
    draw = g._sample_weights

    def spy(words, grad, hess):
        w = draw(words, grad, hess)
        seen.append((grad.numpy().copy(), hess.numpy().copy(),
                     w.numpy().copy()))
        return w

    g._sample_weights = spy
    for _ in range(ROUNDS):
        b.update()
    return b, seen


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def check_training_matches_jax(path, mode):
    """The training contract above for one path and mode."""
    from test_torch_quant import assert_same_trees
    X, y = _xy(path)
    p = _params(path, mode)
    bj, mj = _train_jax(p, X, y)
    bt, mt = _train_port(p, X, y)
    assert len(mj) == len(mt) == ROUNDS
    assert bt._gbdt.grow_params.refine_shift == \
        bj._gbdt.grow_params.refine_shift == (4 if "c2f" in path else 0)
    drawn = 0
    for it, ((jit, jg, jh, jw), (tg, th, tw)) in enumerate(zip(mj, mt)):
        assert jit == it
        if mode in ("bernoulli", "stratified") or (
                np.array_equal(_bits(jg), _bits(tg)) and
                np.array_equal(_bits(jh), _bits(th))):
            np.testing.assert_array_equal(_bits(tw), _bits(jw),
                                          f"iteration {it}")
        else:
            w = bt._gbdt.sample_weights(it, torch.from_numpy(jg.copy()),
                                        torch.from_numpy(jh.copy()))
            np.testing.assert_array_equal(_bits(w), _bits(jw),
                                          f"iteration {it}, JAX gradients")
        drawn += int((jw == 0).sum() > 0)
    assert drawn == ROUNDS              # every iteration left rows out
    assert_same_trees(bj, bt, X, ROUNDS)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("path", ["exact", "two-column waves"])
def test_sampled_training_matches_jax(path, mode):
    check_training_matches_jax(path, mode)


# ---------------------------------------------------------------------
# what the JAX package refuses
# ---------------------------------------------------------------------
@pytest.mark.parametrize("extra,match", [
    ({"boosting": "goss", "bagging_fraction": 0.5, "bagging_freq": 1},
     "Cannot use bagging in GOSS"),
    ({"boosting": "goss", "top_rate": 0.6, "other_rate": 0.5},
     "top_rate \\+ other_rate"),
])
def test_refused_as_the_jax_package_refuses(extra, match):
    import lightgbm_tpu as lgb
    X, y = _xy("exact")
    p = {"objective": "binary", "verbose": -1, **extra}
    for pkg, kw in ((lgb, {}), (ltt, {"device_type": "cpu"})):
        with pytest.raises(pkg.LightGBMError, match=match):
            pp = dict(p, **kw)
            pkg.train(pp, pkg.Dataset(X, label=y, params=pp),
                      num_boost_round=1)


@pytest.mark.parametrize("boosting", ["dart", "rf", "random_forest"])
def test_dart_and_rf_train(boosting):
    """Each trains through ``ltt.train`` (their contracts against the JAX
    package: ``tests/test_torch_dart.py``, ``tests/test_torch_rf.py``)."""
    X, y = _xy("exact")
    p = {"objective": "binary", "verbose": -1, "device_type": "cpu",
         "boosting": boosting, "bagging_fraction": 0.5, "bagging_freq": 1}
    b = ltt.train(p, ltt.Dataset(X, label=y, params=p), num_boost_round=3)
    assert b.num_trees() == 3
    assert type(b._gbdt).__name__ == ("DART" if boosting == "dart" else "RF")
    prob = b.predict(X)
    assert np.all((prob > 0) & (prob < 1))


# ---------------------------------------------------------------------
# on the card: CUDA graphs against eager launches and the CPU
# ---------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (kernel B in CUDA graphs)")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(MODES))
def test_sampled_graphs_match_eager_and_cpu_on_card(card, mode):
    X, y = _xy("two-column c2f waves")
    p = dict(_params("two-column c2f waves", mode), num_iterations=6)
    runs = {}
    for label, dev, kw in (("eager", "cuda", {"_eager": True}),
                           ("graphs", "cuda", {}), ("cpu", "cpu", {})):
        pp = dict(p, device_type=dev)
        for k in sample.LAUNCHES:
            sample.LAUNCHES[k] = 0
        b = ltt.Booster(params=pp, train_set=ltt.Dataset(X, label=y,
                                                         params=pp), **kw)
        for _ in range(6):
            b.update()
        runs[label] = (b, sum(sample.LAUNCHES.values()))
    assert runs["eager"][1] == runs["graphs"][1] == 6
    a, e, c = (runs[k][0] for k in ("graphs", "eager", "cpu"))
    assert a._gbdt.runner.graphs is not None
    assert a.model_to_string() == e.model_to_string()
    for ta, tc in zip(a.models, c.models):
        n = ta.num_leaves
        assert n == tc.num_leaves
        for k in ("split_feature", "threshold_bin", "left_child",
                  "right_child", "leaf_count"):
            np.testing.assert_array_equal(getattr(ta, k)[:n],
                                          getattr(tc, k)[:n], k)
        np.testing.assert_allclose(ta.leaf_value[:n], tc.leaf_value[:n],
                                   rtol=1e-5, atol=0)
