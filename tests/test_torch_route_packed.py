"""Kernel T's two parts (``csrc/route.cu``) as plain PyTorch: the pack of
a tree's split records into one table and the walk over it, against
``route_rows_plain`` and the JAX package's ``route_rows``
(``lightgbm_tpu/ops/grow.py:1833``), on the CPU.

Contract: ``route_walk_plain(xt, route_pack_plain(records))`` gives every
row the same leaf id as both, exactly, on random records from
``chip_smoke.route_records`` (a tenth invalid with garbage leaves, the
missing bin to a random side) at 2, 7, 255 and 1500 leaves, with uint8
and int16 bins, in uint8 and int32 ids, and on a tree of one leaf (no
records: every row in leaf 0).  The table's links are the ones the walk
needs: record ``t``'s node goes right to the first valid record on leaf
``t + 1`` and left to the next valid record on ``t``'s leaf, each with
its feature; the root to leaf 0's first; invalid records in no chain.  The
test marked ``cuda`` holds the table kernel T packs to the plain pack
word for word and its ids to the plain route on the card, and skips
here.
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from lightgbm_tpu_torch.ops import route  # noqa: E402

F = 5


def _case(L, B, seed, n=2000, dtype=torch.uint8, dev="cpu"):
    if L == 1:
        rec = (torch.zeros(1, dtype=torch.int32, device=dev),
               torch.zeros(1, dtype=torch.int32, device=dev),
               torch.zeros((1, B), dtype=torch.bool, device=dev),
               torch.zeros(1, dtype=torch.bool, device=dev))
    else:
        rec = chip_smoke.route_records(torch, dev, L, B, F, seed,
                                       n_bins=B - 3)
    xt = chip_smoke.route_bins(torch, dev, F, n, B - 3, seed, dtype)
    return xt, rec


def _jax(xt, rec, L):
    import jax.numpy as jnp
    from lightgbm_tpu.ops.grow import route_rows as j_route_rows
    return np.asarray(j_route_rows(jnp.asarray(xt.numpy()),
                                   *(jnp.asarray(r.numpy()) for r in rec),
                                   L))


@pytest.mark.parametrize("L,B,dtype", [(2, 64, torch.uint8),
                                       (7, 64, torch.uint8),
                                       (255, 256, torch.uint8),
                                       (255, 512, torch.int16),
                                       (1500, 256, torch.uint8),
                                       (1, 64, torch.uint8)])
def test_packed_walk_matches_plain_and_jax(L, B, dtype):
    for seed in (0, 1):
        xt, rec = _case(L, B, 100 * L + seed, dtype=dtype)
        table = route.route_pack_plain(*rec, L)
        assert table.dtype == torch.int32
        assert table.shape == (route.route_table_words(L - 1, B),)
        got = route.route_walk_plain(xt, table, L - 1, B)
        want = route.route_rows_plain(xt, *rec, L)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        np.testing.assert_array_equal(got.numpy(), _jax(xt, rec, L))
        if L >= 255:
            assert len(np.unique(got.numpy())) > 1
        if L <= 256:
            out = torch.full((xt.shape[1],), 9, dtype=torch.uint8)
            assert route.route_walk_plain(xt, table, L - 1, B, out) is out
            np.testing.assert_array_equal(out.numpy().astype(np.int32),
                                          want.numpy())


@pytest.mark.parametrize("L", [7, 255])
def test_pack_links_and_bits(L):
    B = 256
    rec = chip_smoke.route_records(torch, "cpu", L, B, F, 3 + L,
                                   n_bins=B - 3)
    leaf, feat, left, valid = rec
    S = L - 1
    table = route.route_pack_plain(*rec, L)
    nodes = table[:4 * S + 4].view(S + 1, 4).tolist()
    right = table[4 * S + 4:4 * S + 4 + S * (B // 32)].view(S, B // 32)
    # bin b of record t goes right iff bit b % 32 of word b // 32 is set
    words = right.numpy().view(np.uint32)
    bits = (words[:, :, None] >> np.arange(32)) & 1
    np.testing.assert_array_equal(bits.reshape(S, B).astype(bool),
                                  (~left & valid[:, None]).numpy())
    on = [t for t in range(S) if valid[t] and 0 <= leaf[t] <= t]
    assert len(on) < S                      # some records are off chain

    def first(l):
        return min([t for t in on if leaf[t] == l], default=-1)

    for t in range(S + 1):
        go = first(t + 1) if t < S else first(0)
        stay = min([u for u in on if u > t and leaf[u] == leaf[t]],
                   default=-1) if t in on else -1
        want = [go, int(feat[go]) if go >= 0 else 0, stay,
                int(feat[stay]) if stay >= 0 else 0]
        assert nodes[t] == want, t


def test_route_rows_on_cpu_is_the_plain_route():
    xt, rec = _case(31, 256, 5)
    before = dict(route.LAUNCHES)
    got = route.route_rows(xt, *rec, 31)
    assert route.LAUNCHES == before
    np.testing.assert_array_equal(
        got.numpy(), route.route_walk_plain(
            xt, route.route_pack_plain(*rec, 31), 30, 256).numpy())


def test_table_words():
    assert route.route_table_words(254, 256) == 3052     # 12 KB
    assert route.route_table_words(0, 64) == 4
    for S, B in ((1, 1), (6, 64), (1499, 256), (254, 512)):
        w = route.route_table_words(S, B)
        assert w % 4 == 0 and 0 <= w - (S * (-(-B // 32)) + 4 * S + 4) < 4


@pytest.mark.cuda
@pytest.mark.parametrize("L,B,dtype", [(1, 64, torch.uint8),
                                       (7, 64, torch.uint8),
                                       (255, 256, torch.uint8),
                                       (255, 512, torch.int16),
                                       (1500, 256, torch.uint8)])
def test_pack_and_walk_match_plain_on_card(L, B, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (kernel T)")
    dev = torch.device("cuda")
    S = L - 1
    xt, rec = _case(L, B, L, n=100_003, dtype=dtype, dev=dev)
    want = route.route_pack_plain(*(r.cpu() for r in rec), L)
    used = S * (-(-B // 32)) + 4 * S + 4
    for odt in (torch.uint8, torch.int32):
        if odt == torch.uint8 and L > 256:
            continue
        table = torch.full((route.route_table_words(S, B),), -7,
                           dtype=torch.int32, device=dev)
        out = torch.empty(xt.shape[1], dtype=odt, device=dev)
        got = route.route_rows(xt, *rec, L, out=out, table=table)
        np.testing.assert_array_equal(table[:used].cpu().numpy(),
                                      want[:used].numpy())
        ref = route.route_rows_plain(xt, *rec, L, out=torch.empty_like(out))
        assert torch.equal(got, ref)
