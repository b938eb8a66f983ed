"""Training under monotone constraints and the feature penalty on the
waves: the port (``device_type=cpu``) against the JAX package
(``JAX_PLATFORMS=cpu``), with ``tests/test_torch_monotone_train.py``'s
data, constraints and contract.

Cells: float waves; quantized three-column waves; quantized two-column
waves (``min_data_in_leaf=0``, ``min_sum_hessian_in_leaf=1``);
categorical and bundled waves (routed outside the pass); and
``fused_iters=4`` against 1.  The coarse-to-fine waves are
``tests/test_torch_monotone_c2f.py``'s.

On the waves the reference compiles the children's scans under ``vmap``,
and under the clip that compile fuses the second product of every gain,
in both default directions and in the categorical scans (``ops/split.py``
``_CLIP_FUSION``, site ``WAVE``); the root keeps its unconstrained order.
With those, the first tree's gains and its children's bounds are the JAX
package's bit for bit on every quantized cell.  Two near ties at equal
gains occur later (``FIRST_DIFF``): the categorical waves' third tree
splits x4 into the complement partition at its second node (gains
175.302963 both; the same cell unconstrained does so too, at gains
174.76215 and 174.76221), and the bundled waves' second tree orders two
of a wave's splits the other way (node 10's right child is node 19 in
the JAX package, 20 in the port; gains 2.834320 both): from the second
tree on the renewed leaf values move scores by an ulp (float64 sums in
the port, float32 in the JAX package, ``ROADMAP.md`` Queue 3 item 1).
The trees before a near tie are held as the first one.  Monotonicity:
the float waves' trees never step against a constraint; the quantized
waves' renewed trees may, in both packages, so the trees before the
renewal are held monotone there (``ROADMAP.md`` Queue 3).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu_torch as ltt  # noqa: E402
from test_torch_monotone_train import (BASE, BUNDLED, assert_bounds,  # noqa: E402
                                       assert_monotone, bundled_data,
                                       first_tree_gains_equal, monotone_data,
                                       train_both)
from test_torch_objectives import hold_to_jax  # noqa: E402

# near ties at the first differing split, (tree, split) (module docstring)
FIRST_DIFF = {"categorical": (2, 1), "bundled": (1, 10)}

WAVES = {
    "float waves": {"wave_splits": True, "hist_refinement": False},
    "quantized waves": {"wave_splits": True, "use_quantized_grad": True,
                        "hist_refinement": False},
    "two-column waves": {"wave_splits": True, "use_quantized_grad": True,
                         "hist_refinement": False, "min_data_in_leaf": 0,
                         "min_sum_hessian_in_leaf": 1},
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", list(WAVES))
def test_waves_match_jax(cell):
    X, y = monotone_data()
    p = dict(BASE, **WAVES[cell])
    bj, bt, jrec, trec = train_both(X, y, p)
    g = bt._gbdt
    assert g._state.wave and g.grow_params.refine_shift == 0
    assert g.grow_params.two_col == (cell == "two-column waves")
    assert hold_to_jax(bj, bt, X, y) is None
    quantized = cell != "float waves"
    assert assert_bounds(jrec, trec, quantized) > 10
    if quantized:
        first_tree_gains_equal(bj, bt)
    assert_monotone(bt, trec, X, [0, 1, 2], [1, 1, -1])


def test_categorical_waves():
    X, y = monotone_data(cat=True)
    p = dict(BASE, wave_splits=True, use_quantized_grad=True,
             categorical_feature="4,5")
    bj, bt, jrec, trec = train_both(X, y, p)
    assert bt._gbdt._state.route_outside
    i, _ = diff = hold_to_jax(bj, bt, X, y)
    assert diff == FIRST_DIFF["categorical"]
    assert sum(t.num_cat for t in bt.models[:i]) > 0
    assert assert_bounds(jrec[:i], trec[:i], True) > 10
    first_tree_gains_equal(bj, bt)
    assert_monotone(bt, trec, X, [0, 1, 2], [1, 1, -1])


def test_bundled_waves():
    X, y = bundled_data()
    p = dict(BASE, wave_splits=True, use_quantized_grad=True, **BUNDLED)
    bj, bt, jrec, trec = train_both(X, y, p)
    g = bt._gbdt
    assert g._bundles is not None and g._state.route_outside
    i, _ = diff = hold_to_jax(bj, bt, X, y)
    assert diff == FIRST_DIFF["bundled"]
    assert assert_bounds(jrec[:i], trec[:i], True) > 0
    first_tree_gains_equal(bj, bt)
    assert_monotone(bt, trec, X, [48, 49], [1, -1])


def fused_same_bits(X, y, extra):
    """``fused_iters=4`` gives the trees, children's bounds and training
    score of ``fused_iters=1`` bit for bit: the bounds ride the block's one
    packed fetch."""
    out = {}
    for fused in (1, 4):
        p = dict(BASE, **extra, device_type="cpu", fused_iters=fused)
        out[fused] = ltt.train(p, ltt.Dataset(X, label=y, params=p),
                               num_boost_round=9)
    g = out[4]._gbdt
    assert g.block_sizes == [1, 4, 4] and g.records_fetches == 3
    assert any(k == "left_min" for k, _, _ in g._layout)
    assert out[4].model_to_string() == out[1].model_to_string()
    np.testing.assert_array_equal(out[4]._gbdt.train_score(),
                                  out[1]._gbdt.train_score())


@pytest.mark.parametrize("cell", ["quantized waves", "float waves"])
def test_fused_iters_same_bits(cell):
    X, y = monotone_data(n=2000)
    fused_same_bits(X, y, WAVES[cell])
