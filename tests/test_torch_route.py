"""The validation scorer's route (kernel T's plain version) against the JAX
package's ``route_rows``, on the CPU.

``lightgbm_tpu.ops.grow.route_rows`` (XLA) and
``lightgbm_tpu_torch.ops.route.route_rows_plain`` replay the same split
records over the same binned matrix: random records from
``chip_smoke.route_records`` (each split on one of the leaves that exist
before it, the bins at or below a random threshold going left, the
missing bin, the last one in use, to a random side; a tenth of the
records invalid, with garbage leaf ids) at 7, 31 and 255 leaves, uint8
and int16 bins.  The contract: the same leaf id on every row, exactly, in
uint8 and int32 ids.  On the CPU ``route_rows`` is the plain version and
counts no kernel launch.  The test marked ``cuda`` holds kernel T to the
plain version on the card, exactly, and skips here.
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


def _case(L, B, seed, n=3000, dtype=torch.uint8, dev="cpu"):
    rec = chip_smoke.route_records(torch, dev, L, B, F, seed, n_bins=B - 3)
    xt = chip_smoke.route_bins(torch, dev, F, n, B - 3, seed, dtype)
    return xt, rec


def _jax(xt, rec, L):
    import jax.numpy as jnp
    from lightgbm_tpu.ops.grow import route_rows as j_route_rows
    return np.asarray(j_route_rows(jnp.asarray(xt.numpy()),
                                   *(jnp.asarray(r.numpy()) for r in rec),
                                   L))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("L,B", [(7, 64), (31, 256), (255, 256)])
def test_plain_route_matches_jax(L, B, seed):
    xt, rec = _case(L, B, 10 * L + seed)
    got = route.route_rows_plain(xt, *rec, L)
    want = _jax(xt, rec, L)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the records move rows into more than one leaf, and some invalid
    # record names a leaf rows are in
    assert len(np.unique(want)) > 1
    assert not bool(rec[3].all())


def test_plain_route_int16_bins_matches_jax():
    xt, rec = _case(255, 512, 7, dtype=torch.int16)
    np.testing.assert_array_equal(
        route.route_rows_plain(xt, *rec, 255).numpy(), _jax(xt, rec, 255))


@pytest.mark.parametrize("L", [31, 255])
def test_uint8_ids_equal_int32_ids(L):
    xt, rec = _case(L, 256, 3 + L)
    a = route.route_rows_plain(xt, *rec, L)
    out = torch.full((xt.shape[1],), 9, dtype=torch.uint8)
    b = route.route_rows_plain(xt, *rec, L, out=out)
    assert b is out
    np.testing.assert_array_equal(a.numpy(), b.numpy().astype(np.int32))


def test_route_rows_takes_the_plain_version_on_the_cpu():
    xt, rec = _case(31, 256, 5)
    before = dict(route.LAUNCHES)
    got = route.route_rows(xt, *rec, 31)
    assert route.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), _jax(xt, rec, 31))


def test_route_plan_covers_the_rows():
    for n in (1, 1023, 1025, 500_000, 10_500_000):
        blocks = route.route_plan(n, 132)["blocks"]
        assert 1 <= blocks <= 2 * 132
        assert blocks * route.ROUTE_THREADS >= min(n, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("L,B,dtype", [(31, 256, torch.uint8),
                                       (255, 256, torch.uint8),
                                       (255, 512, torch.int16)])
def test_kernel_t_matches_plain_on_card(L, B, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (kernel T)")
    for n in (1, 31, 100_003):
        xt, rec = _case(L, B, n + L, n=n, dtype=dtype, dev="cuda")
        for odt in (torch.uint8, torch.int32):
            out = torch.empty(n, dtype=odt, device="cuda")
            got = route.route_rows(xt, *rec, L, out=out)
            want = route.route_rows_plain(xt, *rec, L,
                                          out=torch.empty_like(out))
            assert torch.equal(got, want)
