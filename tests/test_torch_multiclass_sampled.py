"""GOSS and MVS at K > 1 classes (softmax and one-vs-all) of the port
against the JAX package, on the CPU (``JAX_PLATFORMS=cpu``).

Data and contract are ``tests/test_torch_multiclass.py``'s: 4,000 rows,
4 classes, 10% NaN in one feature, 8 features, 15 leaves, 3 iterations
(12 trees); identical trees, model text and predictions within
``pred_atol``, or a near tie at the first differing split, named in
``NEAR_TIES``.  On these data two quantized cells meet one: GOSS with
softmax at tree 5's thirteenth split, gains within rel 1e-5; GOSS with
one-vs-all at tree 2's last split, where both packages split the same
leaf on the same feature at gains of 2^-13 and 2^-14 against a root gain
of 1079: splits that separate nothing, whose gains are float32 rounding
(the port's one-vs-all gradients are float64 rounded once, the JAX
package's a float32 chain, and differ by an ulp on a third of the rows).
A gain within ``ZERO_GAIN`` of its tree's root gain counts as zero.
What K > 1 adds, and why:

- each iteration draws one sample, from ``gh = sum_k |g[k] * h[k]|`` over
  its (K, N) gradients (``GOSS._goss_mask_impl``,
  ``MVS._mvs_mask_impl``), and its K trees share it
  (``lightgbm_tpu/models/gbdt.py:2526-2530``): the port's weight function
  is called once an iteration, on all K rows, and gives the JAX
  package's mask bit for bit where the two packages' gradients are the
  same bits, else on the JAX gradients (as ``tests/test_torch_boosting.py``
  states for K = 1); on the exact loop and on quantized two-column waves;
- kernel B's class sum: its plain version, ``class_gh_plain``, is the JAX
  package's ``jnp.sum(jnp.abs(grad * hess), axis=0)`` bit for bit (a
  sequential sum from class 0) at K = 2, 4, 5 and 16, and a booster's
  weights on given (K, N) gradients are ``_goss_mask_impl``'s and the
  jitted ``_mvs_mask_impl``'s, with ties at GOSS's threshold;
- a port that draws each class tree's weights from its own class's row
  (the K = 1 step run once a tree) fails the tree comparison.

The card's graphed runs of these boosters are held to their eager
launches in ``tests/test_torch_multiclass_card.py``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu_torch as ltt  # noqa: E402
from lightgbm_tpu_torch.models.gbdt import GBDT  # noqa: E402
from lightgbm_tpu_torch.ops import sample  # noqa: E402
from lightgbm_tpu_torch.ops.grow import tree_head  # noqa: E402
from test_torch_multiclass import (K, PRED_ATOL, ROUNDS, _data,  # noqa
                                   _gain_scale, _params)
from test_torch_objectives import first_difference, hold_to_jax  # noqa

MODES = {"goss": {"boosting": "goss"},
         "mvs": {"boosting": "mvs", "bagging_fraction": 0.5}}
# (mode, objective, loop) -> (tree, split) of the first difference, and
# whether its gains are within rel 1e-5 ("relative") or both zero
NEAR_TIES = {("goss", "multiclass", "quantized two-column waves"):
             (5, 12, "relative"),
             ("goss", "multiclassova", "quantized two-column waves"):
             (2, 13, "zero")}
# 8 float32 ulps of the root gain: a split that separates nothing
ZERO_GAIN = 8 * 2.0 ** -23
LOOPS = {"exact": {},
         "quantized two-column waves": {"wave_splits": True,
                                        "use_quantized_grad": True,
                                        "min_data_in_leaf": 0,
                                        "hist_refinement": False}}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _train_jax(p, X, y):
    """The JAX booster after ROUNDS iterations, and each iteration's
    (iteration, grad (K, N), hess, mask) from its wrapped
    ``_bagging_mask``."""
    import lightgbm_tpu as lgb
    b = lgb.Booster(params=p, train_set=lgb.Dataset(X, label=y, params=p))
    g, seen = b._gbdt, []
    draw = g._bagging_mask

    def spy(grad=None, hess=None):
        out = draw(grad, hess)
        seen.append((g.iter, np.asarray(grad), np.asarray(hess),
                     np.asarray(out)))
        return out

    g._bagging_mask = spy
    for _ in range(ROUNDS):
        b.update()
    return b, seen


def _train_port(p, X, y):
    """The port's booster (CPU) after ROUNDS iterations, and each call of
    its weight function: (grad, hess, weights)."""
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


@pytest.mark.parametrize("loop", list(LOOPS))
@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
@pytest.mark.parametrize("mode", list(MODES))
def test_sampled_multiclass_matches_jax(mode, objective, loop):
    X, y = _data()
    p = _params(objective, {**MODES[mode], **LOOPS[loop]})
    bj, mj = _train_jax(p, X, y)
    bt, mt = _train_port(p, X, y)
    # one draw an iteration, from all K rows of its gradients
    assert len(mj) == len(mt) == ROUNDS
    for it, ((jit, jg, jh, jw), (tg, th, tw)) in enumerate(zip(mj, mt)):
        assert jit == it and jg.shape == tg.shape == (K, len(y))
        if np.array_equal(_bits(jg), _bits(tg)) and \
                np.array_equal(_bits(jh), _bits(th)):
            np.testing.assert_array_equal(_bits(tw), _bits(jw),
                                          f"iteration {it}")
        else:
            w = bt._gbdt.sample_weights(it, torch.from_numpy(jg.copy()),
                                        torch.from_numpy(jh.copy()))
            np.testing.assert_array_equal(_bits(w), _bits(jw),
                                          f"iteration {it}, JAX gradients")
        assert 0 < (jw == 0).sum() < len(y)
    assert bt.num_trees() == ROUNDS * K
    hold(bj, bt, X, y, NEAR_TIES.get((mode, objective, loop)))


def hold(bj, bt, X, y, tie):
    """``hold_to_jax``'s contract, with the first difference ``tie``
    ((tree, split, kind) or None); a "zero" tie: both gains zero (below
    ``ZERO_GAIN`` of the root's), the trees before it alike."""
    scale = _gain_scale(bj, len(y))
    if tie is None or tie[2] == "relative":
        assert hold_to_jax(bj, bt, X, y, scale, PRED_ATOL) == (
            None if tie is None else tie[:2])
        return
    mj, mt = bj._gbdt.models, bt.models
    i, j = first_difference(mj, mt)
    assert (i, j) == tie[:2]
    for m in (mj[i], mt[i]):
        assert 0 <= m.split_gain[j] <= ZERO_GAIN * m.split_gain[0]
    for t in range(i):
        n = mj[t].num_leaves
        va, vb = mj[t].leaf_value[:n], mt[t].leaf_value[:n]
        assert np.all(np.abs(va - vb) <= 1e-5 * np.abs(va) + 1e-6 * scale)


@pytest.mark.parametrize("k", [2, 4, 5, 16])
def test_class_sum_plain_is_the_jax_sum(k):
    import jax
    import jax.numpy as jnp
    rng = np.random.RandomState(k)
    n = 20011
    scale = rng.choice([1e-4, 1.0, 1e4], size=(k, n))
    g = (rng.randn(k, n) * scale).astype(np.float32)
    h = (rng.rand(k, n) * scale[::-1]).astype(np.float32)
    g[:, ::7] = 0.0
    want = jax.jit(lambda a, b: jnp.sum(jnp.abs(a * b), axis=0))(g, h)
    got = sample.class_gh(torch.from_numpy(g), torch.from_numpy(h))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _class_grads(n, ties, seed):
    """(K, N) float32 gradients and hessians; with ``ties`` |g * h| takes a
    few exact values in every class, so the sum has runs of equal rows at
    GOSS's threshold."""
    rng = np.random.RandomState(seed)
    if ties:
        g = (rng.randint(-6, 7, (K, n)) / 4.0).astype(np.float32)
        h = np.full((K, n), 0.25, np.float32)
    else:
        g = rng.randn(K, n).astype(np.float32)
        h = (rng.rand(K, n) * 0.25).astype(np.float32)
    return g, h


@pytest.mark.parametrize("mode", list(MODES))
def test_weights_on_class_gradients_match_jax(mode):
    import jax.numpy as jnp
    import lightgbm_tpu as lgb
    X, y = _data()
    p = _params("multiclass", MODES[mode])
    gj = lgb.Booster(params=p, train_set=lgb.Dataset(X, label=y,
                                                     params=p))._gbdt
    pt = dict(p, device_type="cpu")
    gt = ltt.Booster(params=pt, train_set=ltt.Dataset(X, label=y,
                                                      params=pt))._gbdt
    for it, ties in ((0, False), (3, True), (8, False)):
        g, h = _class_grads(len(y), ties, it)
        G, H = jnp.asarray(g), jnp.asarray(h)
        want = gj._goss_mask_impl(it, G, H) if mode == "goss" else \
            gj._mvs_mask(it, G, H)              # jax.jit(_mvs_mask_impl)
        got = gt.sample_weights(it, torch.from_numpy(g), torch.from_numpy(h))
        assert got.shape == (len(y),)
        np.testing.assert_array_equal(_bits(got), _bits(want),
                                      f"iteration {it}")


def _per_class_draw(self, k=0):
    """The wrong sample: each class tree's weights drawn from its own
    class's row of the gradients."""
    if k == 0:
        g, h = self._gradients()
        self._grad_all.copy_(g)
        self._hess_all.copy_(h)
    grad, hess = self._grad_all[k], self._hess_all[k]
    w = self._sample_weights(self._bag_words, grad, hess)
    self._mask.copy_(w > 0)
    tree_head(self._state, grad * w, hess * w)


def test_a_draw_per_class_tree_fails(monkeypatch):
    import lightgbm_tpu as lgb
    X, y = _data()
    p = _params("multiclass", MODES["goss"])
    bj = lgb.train(p, lgb.Dataset(X, label=y, params=p),
                   num_boost_round=ROUNDS, verbose_eval=False)
    pt = dict(p, device_type="cpu")
    right = ltt.train(pt, ltt.Dataset(X, label=y, params=pt),
                      num_boost_round=ROUNDS)
    assert first_difference(bj._gbdt.models, right.models) is None
    monkeypatch.setattr(GBDT, "_tree_head", _per_class_draw)
    wrong = ltt.train(pt, ltt.Dataset(X, label=y, params=pt),
                      num_boost_round=ROUNDS)
    # class 0's own |g * h| is not the sum over the classes: the first
    # tree already trains on another sample
    assert first_difference(bj._gbdt.models, wrong.models) == (0, 0)
