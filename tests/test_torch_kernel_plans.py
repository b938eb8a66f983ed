"""Launch plans of kernels H, L and R, and their plain versions against JAX.

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
- kernel R's plan (``routed_plan``) fits a block's shared memory, covers
  every (feature, row) once (composed as kernel H's is), holds at most
  2^24 rows in a block's int32 partial (2^22 with float values, whose
  uint32 low words take 10 bits a row) and, at the Higgs shape, stays in
  one wave of the blocks the card runs at once;
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


def _check_routed_plan(F, B, W, cols, acc, n, sms, per_sm=None):
    plan = th.routed_plan(F, B, W, cols, acc, n, sms, per_sm)
    assert plan["smem"] == th.routed_smem(plan["fpb"], W, B, cols, acc)
    assert plan["smem"] <= SMEM_MAX
    assert plan["fpb"] * plan["groups"] >= F > plan["fpb"] * (
        plan["groups"] - 1)
    assert plan["rows_per_block"] % th.ROUTED_GROUP == 0
    # no int32 partial (int8 values) nor uint32 low word (float) overflows
    assert plan["rows_per_block"] <= (1 << 24 if acc == 4 else 1 << 22)
    assert (plan["row_blocks"] - 1) * plan["rows_per_block"] < n <= \
        plan["row_blocks"] * plan["rows_per_block"]  # no empty block
    return plan


@pytest.mark.parametrize("F,B,W,cols,acc", ROUTED_SHAPES,
                         ids=[f"F{s[0]}-B{s[1]}-W{s[2]}-c{s[3]}-a{s[4]}"
                              for s in ROUTED_SHAPES])
@pytest.mark.parametrize("N", [1, 17, 100_003])
def test_routed_plan_fits_and_covers(F, B, W, cols, acc, N):
    plan = _check_routed_plan(F, B, W, cols, acc, N, H100_SMS)
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
    plan = _check_routed_plan(F, B, W, cols, acc, N, H100_SMS, per_sm)
    assert plan["groups"] == groups
    assert plan["groups"] * plan["row_blocks"] <= per_sm * H100_SMS
    assert plan["groups"] * plan["row_blocks"] > per_sm * H100_SMS * 0.8


@pytest.mark.parametrize("N", [(1 << 24) + 1, 200_000_000])
def test_routed_plan_caps_rows_a_block(N):
    """At most 2^24 rows a block, however few blocks the card runs."""
    plan = _check_routed_plan(28, 256, 64, 2, 4, N, 1, 1)
    assert plan["row_blocks"] >= -(-N // (1 << 24))


@pytest.mark.parametrize("N", [(1 << 22) + 1, 50_000_000])
def test_routed_plan_caps_float_rows_a_block(N):
    """At most 2^22 rows a block with float values: the uint32 low words
    (10 bits a row) cannot overflow."""
    plan = _check_routed_plan(28, 256, 21, 3, 12, N, 1, 1)
    assert plan["row_blocks"] >= -(-N // (1 << 22))


def test_routed_plan_rejects_tiles_past_shared_memory():
    with pytest.raises(ValueError):
        th.routed_plan(28, 2048, 64, 3, 8, 1000, H100_SMS)


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
