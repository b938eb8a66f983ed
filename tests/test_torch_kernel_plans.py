"""Launch plans of kernels H, L, R, M, V, V-lanes and Q, and plain versions
vs JAX.

The kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there).  Here, on the CPU:

- the launch plans (``hist_plan``, ``lookup_plan``: pure functions of the
  shapes and the card's multiprocessor count) fit in a block's shared
  memory and cover every (feature, row) of kernel H, and every row of
  kernel L, exactly once.  Coverage is checked by composing the plain
  version over the plan's pieces: with integer values a piece counted
  twice or missed changes the sum;
- ``masked_histogram_plain`` against the JAX package's
  ``histogram_segsum`` on the masked values at leaf densities 1, 1/8 and
  1/255: integer values bit-equal; float values within rel 1e-6 plus the
  reference's own float32 rounding bound ``n * 2^-24 * sum|v|`` per
  bucket (the reference sums in float32 in row order, the port in
  float64 with one rounding);
- ``take_small_add_plain`` against JAX ``take_small`` followed by the add,
  for lengths that are not multiples of 16: exact;
- kernel R's plan (``group_plan``) fits a block's shared memory, covers
  every (feature, row) once (composed as kernel H's is), holds at most
  2^24 rows in a block's int32 partial (2^22 with float values, whose
  uint32 low words take 10 bits a row) and, at the Higgs shape, stays in
  one wave of the blocks the card runs at once;
- the plans of kernels M, V and V-lanes on the same body (``group_plan``:
  kernel M with one tile a block, V with the window starts beside the
  tiles, V-lanes also with its leaf -> lane table) fit a block's shared
  memory at W = 1 and 64 (M), 1, 21, 64 and 128 (V) and up to 128
  (V-lanes), cover every (feature, row) once, hold at most 2^24 rows a
  block (2^22 with float values) and stay in one wave at the Higgs shape;
- kernel Q's plan (``leaf_plan``) fits a block's shared memory up to
  ``LEAF_MAX`` leaves, covers every row once at uint8 and int32 leaf ids
  (composed as above over ``leaf_stats_plain``), holds at most 2^15 rows a
  block (its 32-bit fixed-point words cannot overflow) and stays in one
  wave at the Higgs shape;
- ``lanes_window_histogram_plain`` over a wave's 2W interleaved lanes in
  one call equals the two calls of W lanes the JAX reference makes
  (integer values: exact);
- ``routed_histogram_plain`` against the JAX package's
  ``histogram_segsum_multi_routed`` on kernel R's edge tables
  (``chip_smoke.ROUTED_EDGE_CASES``, which ``chip_smoke.py`` also holds the
  kernel to on the card): histogram, new leaf vector and selector
  identical (integer values).

Inputs are made from fixed seeds with numpy.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from lightgbm_tpu.ops.histogram import histogram_segsum  # noqa: E402
from lightgbm_tpu.ops.histogram import \
    histogram_segsum_multi_routed  # noqa: E402
from lightgbm_tpu.ops.lookup import take_small  # noqa: E402
from lightgbm_tpu_torch.ops import histogram as th  # noqa: E402
from lightgbm_tpu_torch.ops import lookup as tl  # noqa: E402

SMEM_MAX = 232_448            # dynamic shared memory a Hopper block can have
H100_SMS = 132
HIGGS = (28, 256, 10_500_000)

HIST_SHAPES = [(F, B, np.dtype(bdt), N)
               for F in (1, 3, 28) for B in (64, 255, 256)
               for bdt in ("uint8", "int16") for N in (1, 15, 17, 100_003)]


def _hist_pieces(plan, F, n):
    """Kernel H's (feature range, row range) pieces, one a block."""
    for j in range(plan["chunks"]):
        fs = range(j * plan["fc"], min((j + 1) * plan["fc"], F))
        for i in range(plan["row_blocks"]):
            lo = i * plan["rows_per_block"]
            yield fs, range(min(lo, n), min(lo + plan["rows_per_block"], n))


def _check_hist_plan(F, B, n, sms, active=None):
    plan = th.hist_plan(F, B, n, sms, active)
    assert plan["smem"] <= SMEM_MAX
    assert plan["smem"] == plan["fc"] * B * 3 * 8 + th.HIST_FIXED_SMEM
    assert plan["row_blocks"] % th.HIST_CLUSTER == 0
    assert plan["row_blocks"] == plan["clusters"] * th.HIST_CLUSTER
    assert plan["rows_per_block"] % 16 == 0
    assert plan["row_blocks"] * plan["chunks"] <= max(
        sms, th.HIST_CLUSTER * plan["chunks"])
    if active is not None:       # one wave of clusters
        assert plan["clusters"] * plan["chunks"] <= max(active,
                                                        plan["chunks"])
    assert 2 ** plan["nbits"] >= B
    cover = np.zeros(F, dtype=np.int64)
    for fs, rs in _hist_pieces(plan, F, n):
        cover[list(fs)] += len(rs)
    assert np.all(cover == n)
    # the row ranges tile [0, n) in order: each row exactly once
    rng_ = [rs for _, rs in _hist_pieces(plan, F, n)][:plan["row_blocks"]]
    assert rng_[0].start == 0 and rng_[-1].stop == n
    assert all(a.stop == b.start for a, b in zip(rng_, rng_[1:]))
    return plan


@pytest.mark.parametrize("F,B,bdt,N", HIST_SHAPES,
                         ids=[f"F{F}-B{B}-{d}-N{N}"
                              for F, B, d, N in HIST_SHAPES])
def test_hist_plan_fits_and_covers(F, B, bdt, N):
    plan = _check_hist_plan(F, B, N, H100_SMS)
    rng = np.random.RandomState(F * 1000 + B + N)
    bins = torch.from_numpy(rng.randint(0, B, size=(F, N)).astype(bdt))
    vals = torch.from_numpy(rng.randint(-8, 9, size=(N, 3)).astype(
        np.float32))
    whole = th.histogram_plain(bins, vals, B)
    parts = torch.zeros_like(whole)
    for fs, rs in _hist_pieces(plan, F, N):
        if len(rs) and len(fs):
            sl = slice(rs.start, rs.stop)
            parts[fs.start:fs.stop] += th.histogram_plain(
                bins[fs.start:fs.stop, sl].contiguous(), vals[sl], B)
    torch.testing.assert_close(parts, whole, rtol=0, atol=0)


@pytest.mark.parametrize("active,clusters", [(None, 16), (15, 15)])
def test_hist_plan_higgs_shape(active, clusters):
    """One feature chunk and one block an SM at most; the H100 runs 15
    clusters of 8 such blocks at once, and the grid holds no more."""
    F, B, N = HIGGS
    plan = _check_hist_plan(F, B, N, H100_SMS, active)
    assert (plan["chunks"], plan["clusters"], plan["fc"]) == (1, clusters,
                                                              28)
    assert plan["row_blocks"] <= H100_SMS


@pytest.mark.parametrize("sms,active", [(1, None), (8, None), (132, None),
                                        (132, 15)])
@pytest.mark.parametrize("F,B", [(28, 4096), (300, 256)])
def test_hist_plan_splits_features(F, B, sms, active):
    """Wide histograms split into feature chunks; each still fits."""
    plan = _check_hist_plan(F, B, 100_003, sms, active)
    assert plan["chunks"] > 1


def test_hist_plan_rejects_bins_past_shared_memory():
    with pytest.raises(ValueError):
        th.hist_plan(1, 10_000, 1000, H100_SMS)


LOOKUP_CASES = [(N, dt, sms) for N in (1, 15, 17, 100_003, 10_500_000)
                for dt in ("uint8", "int32") for sms in (1, 132)]


@pytest.mark.parametrize("N,dt,sms", LOOKUP_CASES,
                         ids=[f"N{N}-{d}-sm{s}" for N, d, s in LOOKUP_CASES])
def test_lookup_plan_covers_every_row_once(N, dt, sms):
    plan = tl.lookup_plan(N, sms)
    T, W = plan["tiles"], plan["warps"]
    assert plan["blocks"] <= tl.LOOKUP_BLOCKS_PER_SM * sms
    assert W == plan["blocks"] * tl.LOOKUP_WARPS_PER_BLOCK
    assert 0 <= N - T * tl.LOOKUP_TILE < tl.LOOKUP_TILE
    bounds = np.arange(W + 1, dtype=np.int64) * T // W
    per_warp = np.diff(bounds)
    assert bounds[-1] == T and per_warp.min() >= 0
    assert per_warp.max() - per_warp.min() <= 1     # no ragged last sweep
    # compose the plain add over the plan's pieces: each row added once
    rng = np.random.RandomState(N % 9973)
    vals = torch.from_numpy(rng.randn(255).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, 255, size=N).astype(dt))
    score = torch.from_numpy(rng.randn(N).astype(np.float32))
    want = tl.take_small_add_plain(score.clone(), vals, idx)
    got = score.clone()
    for w in np.flatnonzero(per_warp):
        sl = slice(int(bounds[w]) * tl.LOOKUP_TILE,
                   int(bounds[w + 1]) * tl.LOOKUP_TILE)
        got[sl] += vals[idx[sl].to(torch.int64)]
    tail = slice(T * tl.LOOKUP_TILE, N)
    got[tail] += vals[idx[tail].to(torch.int64)]
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _masked_inputs(seed, parts, integer, N=6000, F=5, B=64):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(F, N)).astype(np.uint8)
    if integer:
        grad = rng.randint(-8, 9, size=N).astype(np.float32)
        hess = rng.randint(1, 5, size=N).astype(np.float32)
    else:
        grad = rng.randn(N).astype(np.float32)
        hess = (rng.rand(N) + 0.05).astype(np.float32)
    mask = (rng.rand(N) < 0.9).astype(np.float32)
    leaf_idx = rng.randint(0, parts, size=N).astype(np.uint8)
    return bins, grad, hess, mask, leaf_idx, B


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "float"])
@pytest.mark.parametrize("parts", [1, 8, 255])
def test_masked_histogram_plain_matches_segsum(parts, integer):
    bins, grad, hess, mask, leaf_idx, B = _masked_inputs(parts, parts,
                                                         integer)
    m = mask * (leaf_idx == 0).astype(np.float32)
    vals = np.stack([grad * m, hess * m, m], axis=-1)
    ref = np.asarray(histogram_segsum(jnp.asarray(bins), jnp.asarray(vals),
                                      B))
    got = th.masked_histogram_plain(
        torch.from_numpy(bins), torch.from_numpy(grad),
        torch.from_numpy(hess), torch.from_numpy(mask),
        torch.from_numpy(leaf_idx), torch.zeros((), dtype=torch.int32),
        B).numpy()
    if integer:
        np.testing.assert_array_equal(got, ref)
        return
    F, N = bins.shape
    ids = bins.astype(np.int64) + np.arange(F)[:, None] * B
    absum = np.zeros((F * B, 3))
    count = np.zeros(F * B)
    np.add.at(absum, ids.reshape(-1), np.tile(np.abs(vals), (F, 1)))
    np.add.at(count, ids.reshape(-1), np.tile(m != 0, F))
    bucket = (count[:, None] * 2.0 ** -24 * absum).reshape(F, B, 3)
    assert np.all(np.abs(got - ref) <= 1e-6 * np.abs(ref) + bucket)


@pytest.mark.parametrize("dt", ["uint8", "int32"])
@pytest.mark.parametrize("N", [1, 15, 17, 1003, 100_003])
def test_take_small_add_plain_matches_take_small(N, dt):
    rng = np.random.RandomState(N)
    vals = rng.randn(255).astype(np.float32)
    idx = rng.randint(0, 255, size=N).astype(dt)
    score = rng.randn(N).astype(np.float32)
    ref = score + np.asarray(take_small(jnp.asarray(vals), jnp.asarray(idx)))
    got = tl.take_small_add_plain(torch.from_numpy(score.copy()),
                                  torch.from_numpy(vals),
                                  torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), ref)


# (F, B, W, cols, accumulator bytes a cell): coarse and full tiles, int8
# values (int32) and float values (an int64 and a uint32 word), a wide
# feature count
ROUTED_SHAPES = [(28, 17, 64, 2, 4), (28, 256, 64, 2, 4),
                 (28, 256, 21, 3, 12), (28, 17, 21, 3, 12), (3, 64, 42, 3, 4),
                 (300, 33, 64, 2, 4)]


def _routed_pieces(plan, F, n):
    """Kernel R's (feature range, row range) pieces, one a block."""
    for j in range(plan["groups"]):
        fs = range(j * plan["fpb"], min((j + 1) * plan["fpb"], F))
        for i in range(plan["row_blocks"]):
            lo = i * plan["rows_per_block"]
            yield fs, range(min(lo, n), min(lo + plan["rows_per_block"], n))


def _check_group_plan(F, B, W, cols, acc, n, sms, per_sm=None, **kw):
    plan = th.group_plan(F, B, W, cols, acc, n, sms, per_sm, **kw)
    assert plan["smem"] == th.group_smem(plan["fpb"], W, B, cols, acc, **kw)
    assert plan["smem"] <= SMEM_MAX
    assert plan["fpb"] * plan["groups"] >= F > plan["fpb"] * (
        plan["groups"] - 1)
    assert plan["rows_per_block"] % th.ROUTED_GROUP == 0
    assert plan["rows_per_block"] <= (1 << 24 if acc == 4 else 1 << 22)
    assert (plan["row_blocks"] - 1) * plan["rows_per_block"] < n <= \
        plan["row_blocks"] * plan["rows_per_block"]  # no empty block
    return plan


@pytest.mark.parametrize("F,B,W,cols,acc", ROUTED_SHAPES,
                         ids=[f"F{s[0]}-B{s[1]}-W{s[2]}-c{s[3]}-a{s[4]}"
                              for s in ROUTED_SHAPES])
@pytest.mark.parametrize("N", [1, 17, 100_003])
def test_routed_plan_fits_and_covers(F, B, W, cols, acc, N):
    plan = _check_group_plan(F, B, W, cols, acc, N, H100_SMS)
    rng = np.random.RandomState(F + B + N)
    bins = torch.from_numpy(rng.randint(0, B, size=(F, N)).astype(np.uint8))
    vals = torch.from_numpy(rng.randint(-8, 9, size=(N, 3)).astype(
        np.float32))
    sel = torch.from_numpy(rng.randint(-1, W, size=N).astype(np.int32))
    two = cols == 2
    whole = th.multi_histogram_plain(bins, vals, sel, B, W, two)
    parts = torch.zeros_like(whole)
    for fs, rs in _routed_pieces(plan, F, N):
        if len(rs) and len(fs):
            sl = slice(rs.start, rs.stop)
            parts[:, fs.start:fs.stop] += th.multi_histogram_plain(
                bins[fs.start:fs.stop, sl].contiguous(), vals[sl], sel[sl],
                B, W, two)
    torch.testing.assert_close(parts, whole, rtol=0, atol=0)


@pytest.mark.parametrize("B,W,cols,acc,per_sm,groups", [
    (17, 64, 2, 4, 2, 3),        # coarse, int8 values: 10 features a block
    (256, 64, 2, 4, 1, 28),      # full resolution: one feature a block
    (256, 21, 3, 12, 1, 28),     # full, float values
    (17, 21, 3, 12, 2, 4)])      # coarse, float values: 7 features
def test_routed_plan_higgs_shape(B, W, cols, acc, per_sm, groups):
    """One wave: no more blocks than the H100 runs at once."""
    F, _, N = HIGGS
    plan = _check_group_plan(F, B, W, cols, acc, N, H100_SMS, per_sm)
    assert plan["groups"] == groups
    assert plan["groups"] * plan["row_blocks"] <= per_sm * H100_SMS
    assert plan["groups"] * plan["row_blocks"] > per_sm * H100_SMS * 0.8


@pytest.mark.parametrize("N", [(1 << 24) + 1, 200_000_000])
def test_routed_plan_caps_rows_a_block(N):
    """At most 2^24 rows a block, however few blocks the card runs."""
    plan = _check_group_plan(28, 256, 64, 2, 4, N, 1, 1)
    assert plan["row_blocks"] >= -(-N // (1 << 24))


@pytest.mark.parametrize("N", [(1 << 22) + 1, 50_000_000])
def test_routed_plan_caps_float_rows_a_block(N):
    """At most 2^22 rows a block with float values: the uint32 low words
    (10 bits a row) cannot overflow."""
    plan = _check_group_plan(28, 256, 21, 3, 12, N, 1, 1)
    assert plan["row_blocks"] >= -(-N // (1 << 22))


def test_routed_plan_rejects_tiles_past_shared_memory():
    with pytest.raises(ValueError):
        th.group_plan(28, 2048, 64, 3, 8, 1000, H100_SMS)


# kernel M on the shared body: (F, B, W, cols, accumulator bytes) at the
# root pass (W = 1, coarse and full, two and three columns), a wave's
# width, the widest three-column tile, a few lanes of many bins, and the
# float and ragged shapes
MULTI_SHAPES = [(28, 17, 1, 2, 4), (28, 256, 1, 2, 4), (28, 17, 1, 3, 4),
                (28, 256, 1, 3, 4), (28, 256, 64, 2, 4), (28, 17, 64, 2, 4),
                (28, 256, 64, 3, 4), (28, 1024, 4, 2, 4),
                (28, 256, 21, 3, 12), (28, 17, 21, 3, 12), (3, 64, 42, 3, 4),
                (28, 256, 1, 3, 12)]
# kernel V-lanes: (F, R, W, cols, accumulator bytes, leaf bound): one lane,
# a window group, a wave's 2W children, int32 leaf ids, float values; and
# kernel V, leaf bound 0 (a selector, no leaf -> lane table): the root's
# window (W = 1, two-column int8, and float values), a float batch of 21,
# a wave's width and the widest call
LANES_SHAPES = [(28, 32, 1, 2, 4, 256), (28, 32, 64, 2, 4, 256),
                (28, 32, 128, 2, 4, 256), (28, 32, 128, 2, 4, 32768),
                (28, 16, 128, 2, 4, 256), (28, 32, 42, 3, 12, 256),
                (28, 32, 128, 3, 12, 32768), (5, 32, 128, 2, 4, 256),
                (28, 32, 1, 2, 4, 0), (28, 32, 1, 3, 12, 0),
                (28, 32, 21, 3, 12, 0), (28, 32, 64, 2, 4, 0),
                (28, 32, 128, 2, 4, 0)]


def _lanes_kw(W, bound):
    """The plan's extra shared memory of kernel V-lanes (``bound`` > 0:
    its leaf -> lane table) or V (``bound`` 0): the window starts."""
    return {"member_bytes": bound, "map_words": 1 + W}


def _compose(plan, F, N, whole, piece):
    """The plan's pieces through ``piece(feature slice, row slice)``,
    summed into the features they cover, against ``whole``."""
    parts = torch.zeros_like(whole)
    for fs, rs in _routed_pieces(plan, F, N):
        if len(rs) and len(fs):
            f, r = slice(fs.start, fs.stop), slice(rs.start, rs.stop)
            parts[:, f] += piece(f, r)
    torch.testing.assert_close(parts, whole, rtol=0, atol=0)


@pytest.mark.parametrize("F,B,W,cols,acc", MULTI_SHAPES,
                         ids=[f"F{s[0]}-B{s[1]}-W{s[2]}-c{s[3]}-a{s[4]}"
                              for s in MULTI_SHAPES])
@pytest.mark.parametrize("N", [17, 100_003])
def test_multi_plan_fits_and_covers(F, B, W, cols, acc, N):
    plan = _check_group_plan(F, B, W, cols, acc, N, H100_SMS)
    rng = np.random.RandomState(F + B + W + N)
    bins = torch.from_numpy(rng.randint(0, B, size=(F, N)).astype(np.uint8))
    vals = torch.from_numpy(rng.randint(-8, 9, size=(N, 3)).astype(
        np.float32))
    sel = torch.from_numpy(rng.randint(-1, W, size=N).astype(np.int32))
    two = cols == 2
    _compose(plan, F, N, th.multi_histogram_plain(bins, vals, sel, B, W, two),
             lambda f, r: th.multi_histogram_plain(
                 bins[f, r].contiguous(), vals[r], sel[r], B, W, two))


@pytest.mark.parametrize("F,R,W,cols,acc,bound", LANES_SHAPES,
                         ids=[f"F{s[0]}-R{s[1]}-W{s[2]}-c{s[3]}-a{s[4]}-L{s[5]}"
                              for s in LANES_SHAPES])
@pytest.mark.parametrize("N", [17, 100_003])
def test_lanes_plan_fits_and_covers(F, R, W, cols, acc, bound, N):
    plan = _check_group_plan(F, R, W, cols, acc, N, H100_SMS,
                             **_lanes_kw(W, bound))
    rng = np.random.RandomState(F + R + W + N)
    B = 256
    bins = torch.from_numpy(rng.randint(0, B - 1, size=(F, N)).astype(
        np.uint8))
    vals = torch.from_numpy(rng.randint(-8, 9, size=(N, 3)).astype(
        np.float32))
    leaf = torch.from_numpy(rng.randint(0, 2 * W + 8, size=N).astype(
        np.int32))
    ids = torch.from_numpy(rng.permutation(2 * W + 8)[:W].astype(np.int32))
    lo = torch.from_numpy(rng.randint(0, B - R, size=(W, F)).astype(np.int32))
    miss = torch.from_numpy(np.where(np.arange(F) % 3 == 0, B - 2, -1).astype(
        np.int32))
    two = cols == 2
    if not bound:                       # kernel V: a selector
        sel = torch.from_numpy(rng.randint(-1, W, size=N).astype(np.int32))
        _compose(plan, F, N,
                 th.window_histogram_plain(bins, vals, sel, lo, R, W, two,
                                           miss),
                 lambda f, r: th.window_histogram_plain(
                     bins[f, r].contiguous(), vals[r], sel[r],
                     lo[:, f].contiguous(), R, W, two, miss[f].contiguous()))
        return
    _compose(plan, F, N,
             th.lanes_window_histogram_plain(bins, vals, leaf, ids, lo, R, W,
                                             two, miss),
             lambda f, r: th.lanes_window_histogram_plain(
                 bins[f, r].contiguous(), vals[r], leaf[r], ids,
                 lo[:, f].contiguous(), R, W, two, miss[f].contiguous()))


@pytest.mark.parametrize("kernel,B,W,cols,acc,per_sm,groups", [
    ("M", 17, 1, 2, 4, 1, 1),         # the c2f root pass, one tile a block
    ("M", 256, 1, 2, 4, 1, 1),        # the no-c2f root pass
    ("M", 256, 64, 2, 4, 1, 28),      # a wave's width, full resolution
    ("M", 17, 21, 3, 12, 2, 4),       # coarse float values: 7 features
    ("M", 256, 21, 3, 12, 1, 28),     # float values
    ("V-lanes", 32, 64, 2, 4, 1, 5),  # a window group
    ("V-lanes", 32, 128, 2, 4, 1, 10),  # a wave's 2W children
    ("V-lanes", 32, 42, 3, 12, 1, 14),
    ("V", 32, 1, 2, 4, 2, 1),         # the root's window (the c2f path)
    ("V", 32, 1, 3, 12, 1, 1),        # the root's window, float values
    ("V", 32, 64, 2, 4, 1, 5),        # a wave's width
    ("V", 32, 21, 3, 12, 1, 7)])      # float values, 21 subsets
def test_group_plans_higgs_shape(kernel, B, W, cols, acc, per_sm, groups):
    """One wave: no more blocks than the H100 runs at once."""
    F, _, N = HIGGS
    kw = {"V-lanes": _lanes_kw(W, 256), "V": _lanes_kw(W, 0)}.get(kernel,
                                                                  {})
    plan = _check_group_plan(F, B, W, cols, acc, N, H100_SMS, per_sm, **kw)
    assert plan["groups"] == groups
    assert plan["groups"] * plan["row_blocks"] <= per_sm * H100_SMS
    assert plan["groups"] * plan["row_blocks"] > per_sm * H100_SMS * 0.8


_CAPS = [((1 << 24) + 1, 4), (200_000_000, 4), ((1 << 22) + 1, 12),
         (50_000_000, 12)]


@pytest.mark.parametrize("N,acc,bound",
                         [c + (256,) for c in _CAPS] +
                         [c + (0,) for c in _CAPS],
                         ids=[f"{n}-{a}" for n, a in _CAPS] +
                         [f"{n}-{a}-V" for n, a in _CAPS])
def test_lanes_plan_caps_rows_a_block(N, acc, bound):
    """At most 2^24 rows a block (2^22 with float values), however few
    blocks the card runs: kernels V-lanes and V (``bound`` 0)."""
    plan = _check_group_plan(28, 32, 128, 2, acc, N, 1, 1,
                             **_lanes_kw(128, bound))
    assert plan["row_blocks"] >= -(-N // th.routed_row_cap(acc))


def _check_leaf_plan(n, L, sms, per_sm=None):
    plan = th.leaf_plan(n, L, sms, per_sm)
    assert plan["smem"] == th.leaf_smem(L)
    assert plan["smem"] + 16 <= SMEM_MAX
    assert plan["rows_per_block"] % th.ROUTED_GROUP == 0
    assert plan["rows_per_block"] <= 1 << 15
    n = max(n, 1)
    assert (plan["row_blocks"] - 1) * plan["rows_per_block"] < n <= \
        plan["row_blocks"] * plan["rows_per_block"]  # no empty block
    return plan


@pytest.mark.parametrize("idx,L", [("uint8", 7), ("uint8", 31),
                                   ("uint8", 255), ("uint8", 256),
                                   ("int32", 255), ("int32", 1000),
                                   ("int32", th.LEAF_MAX)])
@pytest.mark.parametrize("N", [1, 17, 100_003])
def test_leaf_plan_fits_and_covers(idx, L, N):
    """Kernel Q's row blocks, through the plain version over each block's
    rows: every row once (integer values, so a row counted twice or missed
    changes a sum), at ids of both types."""
    plan = _check_leaf_plan(N, L, H100_SMS)
    assert plan["row_blocks"] <= 8 * H100_SMS
    rng = np.random.RandomState(L + N)
    li = rng.randint(0, L, size=N).astype(idx)
    g, h = (torch.from_numpy(rng.randint(-8, 9, size=N).astype(np.float32))
            for _ in range(2))
    m = torch.from_numpy((rng.rand(N) < 0.9).astype(np.float32))
    li = torch.from_numpy(li)
    whole = th.leaf_stats_plain(li, g, h, m, L)
    parts = torch.zeros_like(whole)
    for i in range(plan["row_blocks"]):
        r = slice(i * plan["rows_per_block"], (i + 1) * plan["rows_per_block"])
        parts += th.leaf_stats_plain(li[r], g[r], h[r], m[r], L)
    torch.testing.assert_close(parts, whole, rtol=0, atol=0)


@pytest.mark.parametrize("L,per_sm", [(255, 4), (7, 8), (1000, 3)])
def test_leaf_plan_higgs_shape(L, per_sm):
    """One wave at 10.5M rows: no more blocks than the H100 runs at
    once."""
    plan = _check_leaf_plan(HIGGS[2], L, H100_SMS, per_sm)
    assert per_sm * H100_SMS * 0.8 < plan["row_blocks"] <= per_sm * H100_SMS


@pytest.mark.parametrize("N", [(1 << 15) + 1, 50_000_000])
def test_leaf_plan_caps_rows_a_block(N):
    """At most 2^15 rows a block (16 bits of a value into each 32-bit word
    of a cell), however few blocks the card runs."""
    plan = _check_leaf_plan(N, 255, 1, 1)
    assert plan["row_blocks"] >= -(-N // (1 << 15))


def test_leaf_plan_rejects_past_the_limit():
    th.leaf_plan(1000, th.LEAF_MAX, H100_SMS)
    with pytest.raises(ValueError, match=str(th.LEAF_MAX)):
        th.leaf_plan(1000, th.LEAF_MAX + 1, H100_SMS)


@pytest.mark.parametrize("two_col", [True, False], ids=["two-col", "3-col"])
@pytest.mark.parametrize("idx,W,L", [("uint8", 64, 255), ("uint8", 21, 255),
                                     ("int32", 64, 1000)])
def test_lanes_plain_2w_equals_two_w_calls(idx, W, L, two_col):
    """A wave's 2W children in one call of kernel V-lanes' plain version,
    against the two calls of W lanes the JAX reference makes: live child
    ids are distinct, dead lanes carry the dummy id L, which no row holds
    (uint8 leaf vectors also a dummy 256, past every id)."""
    rng = np.random.RandomState(W + L)
    F, N, B, R = 6, 20_000, 256, 32
    bins = torch.from_numpy(rng.randint(0, B - 1, size=(F, N)).astype(
        np.uint8))
    vals = torch.from_numpy(rng.randint(-120, 121, size=(N, 3)).astype(
        np.int8))
    leaf = torch.from_numpy(rng.randint(0, L, size=N).astype(idx))
    live = 3 * W // 4
    ids = np.full(2 * W, L, np.int32)
    ids[:2 * live] = rng.permutation(L)[:2 * live]
    if idx == "uint8":
        ids[-3:] = 256
    ids = torch.from_numpy(ids)
    lo = torch.from_numpy((rng.randint(0, 14, size=(2 * W, F)) << 4).astype(
        np.int32))
    miss = torch.from_numpy(np.where(np.arange(F) % 2 == 0, B - 2, -1).astype(
        np.int32))
    one = th.lanes_window_histogram_plain(bins, vals, leaf, ids, lo, R, 2 * W,
                                          two_col, miss)
    two = torch.cat([th.lanes_window_histogram_plain(
        bins, vals, leaf, ids[h].contiguous(), lo[h].contiguous(), R, W,
        two_col, miss) for h in (slice(0, W), slice(W, 2 * W))])
    assert float(one.abs().sum()) > 0
    torch.testing.assert_close(one, two, rtol=0, atol=0)


@pytest.mark.parametrize("name", chip_smoke.ROUTED_EDGE_CASES)
@pytest.mark.parametrize("N", [2_003, 4_096])
def test_routed_plain_edge_tables_match_segsum(name, N):
    c = chip_smoke.routed_edge_case(name, N, seed=7)
    W, B, shift = c["width"], c["max_bin"], c["shift"]
    h, ln, s = histogram_segsum_multi_routed(
        jnp.asarray(c["bins"]),
        jnp.asarray(np.concatenate([c["vals"], np.ones((N, 1), np.int8)],
                                   1).astype(np.float32)),
        jnp.asarray(c["leaf_idx"]), jnp.asarray(c["tables"]), B, W,
        two_col=True, shift=shift, miss_bin=jnp.asarray(c["miss_bin"]))
    gh, gl, gs = th.routed_histogram(
        torch.from_numpy(c["bins"]), torch.from_numpy(c["vals"]),
        torch.from_numpy(c["leaf_idx"]), torch.from_numpy(c["tables"]), B,
        W, True, torch.from_numpy(c["miss_bin"]),
        leaf_bound=c["leaf_bound"], shift=shift)
    np.testing.assert_array_equal(gh.numpy(), np.asarray(h))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(ln))
    assert gl.dtype == torch.from_numpy(c["leaf_idx"]).dtype
    np.testing.assert_array_equal(gs.numpy(), np.asarray(s))
    if name == "no row selected":
        assert int((gs >= 0).sum()) == 0 and float(gh.abs().sum()) == 0
    elif name == "a leaf in two lanes":
        t = c["tables"]
        dup = t[0, 2]
        rows = c["leaf_idx"] == dup
        assert np.all(np.isin(gs.numpy()[rows], [-1, 5]))
        assert np.any(gs.numpy()[rows] == 5)
    elif name.startswith("missing"):
        # some row at a lane feature's missing bin routed by the default
        t = c["tables"]
        lane = np.full(N, -1)
        for w in range(W):
            lane[c["leaf_idx"] == t[0, w]] = w
        live = lane >= 0
        col = c["bins"][t[1, lane[live]], np.flatnonzero(live)]
        at_miss = col == c["miss_bin"][t[1, lane[live]]]
        assert at_miss.any()
