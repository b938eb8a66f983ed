"""The kernels' launch plans at MS-LTR's width, 136 features.

The histogram kernels ran on the card at 28 features until the ranking
slice; bench.py's MS-LTR row has 136.  Each plan is checked as
``tests/test_torch_kernel_plans.py`` checks it at 28 (it fits in a
Hopper block's shared memory, and its blocks cover every row and feature
once), at the MS-LTR row count and, composed piece by piece through the
plain versions against one whole call (exactly, on integer values), at
a few thousand rows: kernel H (the exact loop), R and M (wave255 full and
coarse, the root pass), V (the root's window) and V-lanes (a wave's 2W
children).  Kernel S's grid is a block a (feature, lane) and kernel T's
table does not depend on the width; both ran at 136 features on the card
(``chip_smoke.py`` phase 6's lambdarank cells against the CPU).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from lightgbm_tpu_torch.ops import histogram as th  # noqa: E402
from test_torch_kernel_plans import (H100_SMS, _check_group_plan,  # noqa
                                     _check_hist_plan, _compose,
                                     _hist_pieces, _lanes_kw)

F = 136
MSLTR_ROWS = 9_999 * 227
N = 5_003


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(B, W, seed):
    rng = np.random.RandomState(seed)
    bins = torch.from_numpy(rng.randint(0, B - 1, size=(F, N)).astype(
        np.uint8))
    vals = torch.from_numpy(rng.randint(-8, 9, size=(N, 3)).astype(
        np.float32))
    sel = torch.from_numpy(rng.randint(-1, W, size=N).astype(np.int32))
    return rng, bins, vals, sel


def test_hist_plan_at_136_features():
    _check_hist_plan(F, 256, MSLTR_ROWS, H100_SMS)
    plan = _check_hist_plan(F, 256, N, H100_SMS)
    _, bins, vals, _ = _data(256, 1, 1)
    whole = th.histogram_plain(bins, vals, 256)
    parts = torch.zeros_like(whole)
    for fs, rs in _hist_pieces(plan, F, N):
        if len(rs) and len(fs):
            sl = slice(rs.start, rs.stop)
            parts[fs.start:fs.stop] += th.histogram_plain(
                bins[fs.start:fs.stop, sl].contiguous(), vals[sl], 256)
    torch.testing.assert_close(parts, whole, rtol=0, atol=0)


# (B, W): wave255's routed and batched passes, full (256 bins) and
# coarse (shift 4: 17 bins), a wave's 64 lanes and the root's one
GROUP_SHAPES = [(256, 64), (17, 64), (256, 1), (17, 1)]


@pytest.mark.parametrize("B,W", GROUP_SHAPES,
                         ids=[f"B{b}-W{w}" for b, w in GROUP_SHAPES])
def test_group_plan_at_136_features(B, W):
    _check_group_plan(F, B, W, 2, 4, MSLTR_ROWS, H100_SMS)
    plan = _check_group_plan(F, B, W, 2, 4, N, H100_SMS)
    _, bins, vals, sel = _data(B, W, B + W)
    _compose(plan, F, N,
             th.multi_histogram_plain(bins, vals, sel, B, W, True),
             lambda f, r: th.multi_histogram_plain(
                 bins[f, r].contiguous(), vals[r], sel[r], B, W, True))


# (W, leaf bound): V-lanes on a wave's 2W = 128 children, uint8 leaf ids;
# V on the root's window (a selector)
LANES_SHAPES = [(128, 256), (1, 0)]


@pytest.mark.parametrize("W,bound", LANES_SHAPES,
                         ids=[f"W{w}-L{b}" for w, b in LANES_SHAPES])
def test_lanes_plan_at_136_features(W, bound):
    R, B = 32, 256
    kw = _lanes_kw(W, bound)
    _check_group_plan(F, R, W, 2, 4, MSLTR_ROWS, H100_SMS, **kw)
    plan = _check_group_plan(F, R, W, 2, 4, N, H100_SMS, **kw)
    rng, bins, vals, sel = _data(B, W, W + bound)
    lo = torch.from_numpy(rng.randint(0, B - R, size=(W, F)).astype(np.int32))
    miss = torch.from_numpy(np.where(np.arange(F) % 3 == 0, B - 2, -1).astype(
        np.int32))
    if not bound:
        _compose(plan, F, N,
                 th.window_histogram_plain(bins, vals, sel, lo, R, W, True,
                                           miss),
                 lambda f, r: th.window_histogram_plain(
                     bins[f, r].contiguous(), vals[r], sel[r],
                     lo[:, f].contiguous(), R, W, True, miss[f].contiguous()))
        return
    leaf = torch.from_numpy(rng.randint(0, 2 * W + 8, size=N).astype(
        np.int32))
    ids = torch.from_numpy(rng.permutation(2 * W + 8)[:W].astype(np.int32))
    _compose(plan, F, N,
             th.lanes_window_histogram_plain(bins, vals, leaf, ids, lo, R, W,
                                             True, miss),
             lambda f, r: th.lanes_window_histogram_plain(
                 bins[f, r].contiguous(), vals[r], leaf[r], ids,
                 lo[:, f].contiguous(), R, W, True, miss[f].contiguous()))
