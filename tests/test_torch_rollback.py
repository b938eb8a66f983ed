"""``rollback_one_iter`` of the port's gbdt against the JAX package's, on
the CPU.

The same data and parameters (binary, 15 leaves, the exact loop) train in
both packages, then both roll back one iteration and train on:

- per iteration with a validation set (the JAX package's sequential
  path): the training score back to the iteration's start, the
  validation score minus the popped tree's float64 prediction;
- inside a fused block (``fused_iters=4``; the JAX package's
  ``_fused_rollback``), after 3 and after 6 updates: the score replayed
  to the served boundary, the feature-fraction draws and tree ids
  rewound, so the trees trained after it are the JAX package's;
- after a stop tree (``min_gain_to_split=10`` stops at the eighth tree),
  per iteration with a validation set and inside a fused block: the
  constant stop tree popped, training allowed again, and the iteration
  count one lower than the trees, as in the JAX package.

The contract: the same tree structure (leaf values within 1e-5 absolute,
1e-4 relative, as ``tests/test_torch_dart.py`` states why), training and
validation scores within 1e-5 of the reference's, the same ``iter``; the
port's scores within 1e-5 of its own prediction of its trees (gbdt's
scorer adds the float32 leaf values, the prediction the float64 ones); a
rollback of the first iteration gives the zero score back (no bias), and
without feature fraction the same first tree again.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu_torch as ltt  # noqa: E402
from test_torch_dart import assert_same_model, data  # noqa: E402

BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
        "verbose": -1, "metric": "None", "feature_fraction": 0.8,
        "num_iterations": 12}
STOPS = {"learning_rate": 0.5, "min_gain_to_split": 10.0}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boosters(p, valid):
    import lightgbm_tpu as lgb
    X, y, Xv, yv = data("exact")
    bj = lgb.Booster(params=p, train_set=lgb.Dataset(X, label=y, params=p))
    pt = dict(p, device_type="cpu")
    dt = ltt.Dataset(X, label=y, params=pt)
    bt = ltt.Booster(params=pt, train_set=dt)
    if valid:
        bj.add_valid(lgb.Dataset(Xv, label=yv, reference=bj.train_set), "v")
        bt.add_valid(dt.create_valid(Xv, label=yv), "v")
    return bj, bt


def _step(boosters, n):
    stops = []
    for b in boosters:
        stops.append([b.update() for _ in range(n)])
    assert stops[0] == stops[1]
    return stops[1]


def _check(bj, bt):
    X, _, Xv, _ = data("exact")
    gj, gt = bj._gbdt, bt._gbdt
    assert gt.iter == gj.iter
    assert_same_model(bj, bt)
    train = gt.train_score()
    np.testing.assert_allclose(train, np.asarray(gj.train_score[0]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(train, bt.predict(X, raw_score=True,
                                                 num_iteration=-1),
                               rtol=0, atol=1e-5)
    if gt.valid_sets:
        valid = gt.valid_sets[0].score.numpy()
        np.testing.assert_allclose(valid, gj.valid_sets[0].score[0],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(valid, bt.predict(Xv, raw_score=True,
                                                     num_iteration=-1),
                                   rtol=0, atol=1e-5)


def test_rollback_per_iteration_with_a_valid_set():
    bj, bt = _boosters(BASE, valid=True)
    _step((bj, bt), 5)
    for b in (bj, bt):
        assert b.rollback_one_iter() is b
    assert len(bt.models) == 4
    _check(bj, bt)
    _step((bj, bt), 3)
    _check(bj, bt)


def test_rollback_of_the_first_iteration_drops_the_bias():
    p = dict(BASE, device_type="cpu", feature_fraction=1.0)
    X, y, _, _ = data("exact")
    b = ltt.Booster(params=p, train_set=ltt.Dataset(X, label=y, params=p))
    b.update()
    b.rollback_one_iter()
    assert b.num_trees() == 0 and b._gbdt.iter == 0
    assert not np.any(b._gbdt.train_score())
    b.update()
    b2 = ltt.Booster(params=p, train_set=ltt.Dataset(X, label=y, params=p))
    b2.update()
    assert b.model_to_string() == b2.model_to_string()
    assert np.array_equal(b._gbdt.train_score(), b2._gbdt.train_score())


@pytest.mark.parametrize("before", [3, 6])
def test_rollback_inside_a_fused_block(before):
    bj, bt = _boosters(dict(BASE, fused_iters=4), valid=False)
    _step((bj, bt), before)
    for b in (bj, bt):
        b.rollback_one_iter()
    assert len(bt.models) == before - 1
    _check(bj, bt)
    _step((bj, bt), 4)
    _check(bj, bt)
    # fused blocks on after the rollback: one fetch a block
    assert bt._gbdt.block_sizes[0] == 1 and max(bt._gbdt.block_sizes) == 4


@pytest.mark.parametrize("fused", [1, 4])
def test_rollback_after_a_stop_tree(fused):
    bj, bt = _boosters(dict(BASE, fused_iters=fused, **STOPS),
                       valid=fused == 1)
    stops = _step((bj, bt), 8)
    assert stops[-1] and not any(stops[:-1])
    assert bt.models[-1].num_leaves == 1
    for b in (bj, bt):
        b.rollback_one_iter()
    assert len(bt.models) == 7 and bt._gbdt.iter == 6
    assert not bt._gbdt._stop_flag
    _check(bj, bt)
    # training may go on: the same stop tree again
    assert _step((bj, bt), 1) == [True]
    _check(bj, bt)
