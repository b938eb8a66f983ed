"""Training under monotone constraints and the feature penalty on the
coarse-to-fine waves as they ship: the port (``device_type=cpu``) against
the JAX package (``JAX_PLATFORMS=cpu``), with
``tests/test_torch_monotone_train.py``'s data (30 features, so that the
stream gate turns coarse to fine on at ``max_bin=255``), constraints on
x0-x2, the penalty on x3, and contract.

Under the clip the coarse-to-fine split search's own coarse and fine
scans fuse the second product of every gain at a wave's children, and
the default-left one's at the root (``ops/split.py`` ``_CLIP_FUSION``),
while ``choose_window``'s coarse scan keeps the unconstrained first
products everywhere (probed: with the second there, 2 of 4 trees took
another window at a gain of ~3e-5 and split elsewhere).  With those the
trees, the first tree's gains and its children's bounds are the JAX
package's bit for bit, and the trees before the renewal are monotone.
``fused_iters=4`` gives ``fused_iters=1``'s bits.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402
import torch  # noqa: E402

from test_torch_monotone_train import (BASE, assert_bounds,  # noqa: E402
                                       assert_monotone,
                                       first_tree_gains_equal, monotone_data,
                                       train_both)
from test_torch_monotone_waves import fused_same_bits  # noqa: E402
from test_torch_objectives import hold_to_jax  # noqa: E402

C2F = {"wave_splits": True, "use_quantized_grad": True, "max_bin": 255,
       "min_data_in_leaf": 0, "min_sum_hessian_in_leaf": 1,
       "monotone_constraints": [1, 1, -1] + [0] * 27,
       "feature_contri": [1.0] * 3 + [0.5] + [1.0] * 26}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_coarse_to_fine_matches_jax():
    X, y = monotone_data(F=30)
    p = dict(BASE, **C2F)
    bj, bt, jrec, trec = train_both(X, y, p)
    g = bt._gbdt
    assert g.grow_params.refine_shift == 4 and g.grow_params.two_col
    assert hold_to_jax(bj, bt, X, y) is None
    assert assert_bounds(jrec, trec, True) > 10
    first_tree_gains_equal(bj, bt)
    assert_monotone(bt, trec, X, [0, 1, 2], [1, 1, -1])


def test_fused_iters_same_bits():
    X, y = monotone_data(F=30, n=2000)
    fused_same_bits(X, y, C2F)
