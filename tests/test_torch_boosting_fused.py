"""Fused super-steps with row sampling (bagging, GOSS, MVS) against the
per-iteration path of the port, on the CPU.

The contract: ``fused_iters=4`` gives the same trees, training scores and
predictions, bit for bit, as ``fused_iters=1``, in every mode of
``tests/test_torch_boosting.py`` (bernoulli bagging at
``bagging_freq=3``, which does not divide the block), at
``superstep_pipeline_depth`` 0 and 1 on two-column waves, and on the
exact loop and coarse-to-fine waves; and under a ``learning_rates``
schedule whose change mid-block rewinds the block.  A tree's draw is a
pure function of its global iteration (the bagging cache is the fold of
the last redraw's iteration), so a rewound or dropped block leaves no
sampling state to restore.  MVS at ``bagging_fraction=1`` and bagging
without ``bagging_freq`` draw nothing and train the unsampled trees.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu_torch as ltt  # noqa: E402
from test_torch_boosting import MODES, _data, _params, _xy  # noqa: E402

# coarse-to-fine waves on fewer rows: its gate reads features and bins
C2F_DATA = _data(28, n=1500)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread, the other workers' cores left
    alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train(p, X, y, fused=1, depth=1, **kw):
    p = dict(p, device_type="cpu", fused_iters=fused,
             superstep_pipeline_depth=depth)
    return ltt.train(p, ltt.Dataset(X, label=y, params=p),
                     num_boost_round=10, **kw)


def _assert_identical(a, b, X):
    assert a.model_to_string() == b.model_to_string()
    np.testing.assert_array_equal(a._gbdt.train_score(),
                                  b._gbdt.train_score())
    np.testing.assert_array_equal(a.predict(X, raw_score=True),
                                  b.predict(X, raw_score=True))


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("mode", list(MODES))
def test_fused_matches_per_iteration(mode, depth):
    X, y = _xy("two-column waves")
    p = _params("two-column waves", mode)
    a = _train(p, X, y, fused=1)
    b = _train(p, X, y, fused=4, depth=depth)
    assert b._gbdt.block_sizes == [1, 4, 4, 1]
    _assert_identical(a, b, X)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("path", ["exact", "two-column c2f waves"])
def test_fused_matches_per_iteration_on_other_paths(path, mode):
    X, y = C2F_DATA if "c2f" in path else _xy(path)
    p = _params(path, mode)
    b = _train(p, X, y, fused=4)
    assert b._gbdt.grow_params.refine_shift == (4 if "c2f" in path else 0)
    _assert_identical(_train(p, X, y, fused=1), b, X)


@pytest.mark.parametrize("mode", list(MODES))
def test_rate_change_mid_block_rewinds_to_the_same_bits(mode):
    """The rate changes at iteration 6, inside the block of iterations
    5-8: its trees after the first were built at the old rate, so the
    block is rewound and 6-9 dispatched anew (the trees' draws are keyed by
    their iterations, not by the blocks)."""
    X, y = _xy("exact")
    p = _params("exact", mode)
    lrs = [0.1] * 6 + [0.05] * 4
    a = _train(p, X, y, fused=1, learning_rates=lrs)
    b = _train(p, X, y, fused=4, learning_rates=lrs)
    assert b._gbdt.block_sizes == [1, 4, 4, 4]
    _assert_identical(a, b, X)
    assert [t.shrinkage for t in b.models] == pytest.approx(lrs, rel=1e-15)


def test_mvs_at_full_fraction_and_bagging_without_freq_do_not_sample():
    """MVS samples only below bagging_fraction 1, bagging only with
    bagging_freq > 0: both train the unsampled trees."""
    X, y = _xy("exact")
    base = _train({"objective": "binary", "verbose": -1, "num_leaves": 15},
                  X, y)
    for extra in ({"boosting": "mvs"}, {"bagging_fraction": 0.5}):
        b = _train({"objective": "binary", "verbose": -1, "num_leaves": 15,
                    **extra}, X, y)
        assert not b._gbdt._sampled
        assert [t.to_string(i) for i, t in enumerate(b.models)] == \
            [t.to_string(i) for i, t in enumerate(base.models)]
