"""Kernel B's sampling step (``csrc/sample.cu``), its thresholds modelled in
plain PyTorch and numpy at the kernel's block sizes, against the plain
versions of ``ops/sample.py`` and the JAX package, on the CPU.

Contract (atol 0 everywhere: every value is the same bits):

- MVS's scan: a model of the kernel's decomposition (tiles of 4096 values
  as 256 chunks of 16; each tile's totals at levels 1-3 from the
  up-sweep; the levels above and their prefixes from its last block;
  the down-sweep's in-tile prefixes with the previous tile's last
  prefixes at levels 1 and 2 recomputed from the stored totals) gives
  ``split.prefix_sum`` and the jitted ``jnp.cumsum(x[::-1])[::-1]`` of the
  descending scores bit for bit at N = 1, 15, 16, 17, 255, 256, 257,
  4095, 4096, 4097, 65537 and 2^20 + 3; with the estimate and the first
  ``i`` that passes the target, it gives ``mvs_threshold``'s ``mu``;
- ``mvs_threshold`` on the branch where no ``i`` passes the target
  equals the JAX package's ``MVS._threshold_device``;
- GOSS's radix select: a model of the kernel's three passes (11, 11 and
  10 bits of an order-preserving key, NaN below every number) gives
  ``goss_threshold``'s ``thr``, ``n_gt``, ``n_tie`` and ``p_tie`` and the
  JAX package's ``_goss_mask_impl`` expressions, on ties, all zeros, NaN,
  ``inf`` and fewer non-NaN rows than ``top_k``;
- the steps on CPU tensors are the plain versions, and launch nothing.

The tests marked ``cuda`` hold the step's kernels to the plain versions
on the card and skip here; JAX is imported only by the tests that compare
with it.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from lightgbm_tpu_torch.ops import sample  # noqa: E402
from lightgbm_tpu_torch.ops.split import prefix_sum  # noqa: E402

SCAN_SIZES = (1, 15, 16, 17, 255, 256, 257, 4095, 4096, 4097, 65537,
              2 ** 20 + 3)
TILE, T, C = sample.SCAN_TILE, sample.SCAN_THREADS, sample.SCAN_CHUNK


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _same(a, b, what=""):
    np.testing.assert_array_equal(_bits(a), _bits(b), what)


# ---------------------------------------------------------------------
# MVS's scan, as the kernel decomposes it
# ---------------------------------------------------------------------
def _fold(a):
    """Running sums along the last axis, one float32 add at a time."""
    out = a.clone()
    for m in range(1, a.shape[-1]):
        out[..., m] = out[..., m - 1] + a[..., m]
    return out


def _fold_list(vals):
    acc = vals[0]
    for v in vals[1:]:
        acc = acc + v
    return acc


def scan_model(x):
    """The scan kernels' prefix sums of ``x`` (the scores ascending)."""
    n = x.shape[0]
    lens = sample.scan_levels(n)
    K = len(lens) - 1
    nb = -(-n // TILE)
    xp = torch.zeros(nb * TILE, dtype=torch.float32)
    xp[:n] = x
    # the up-sweep, a tile a block
    in0 = _fold(xp.view(nb, T, C))                  # each thread's chunk
    in1 = _fold(in0[..., -1].reshape(nb, C, C))     # threads 0-15
    in2 = _fold(in1[..., -1])                       # thread 0
    tot = {1: in0[..., -1].reshape(-1), 2: in1[..., -1].reshape(-1),
           3: in2[:, -1]}
    tot = {k: v[:lens[k]] for k, v in tot.items() if k <= K}
    # its last block: the totals above level 3 (no padding added), then
    # the prefixes from the top down to level 3
    for k in range(4, K + 1):
        lo = tot[k - 1]
        tot[k] = torch.stack([_fold_list(lo[c * C:(c + 1) * C])
                              for c in range(lens[k])])
    pre = {}
    for k in range(K, 2, -1):
        t = tot[k]
        p = torch.empty_like(t)
        for c in range(-(-lens[k] // C)):
            run = _fold(t[c * C:(c + 1) * C])
            p[c * C:(c + 1) * C] = run + pre[k + 1][c - 1] if c else run

        pre[k] = p

    def prefix_2(i):
        c = i // C
        acc = _fold_list(tot[2][c * C:i + 1])
        return acc + pre[3][c - 1] if c else acc

    def prefix_1(i):
        c = i // C
        acc = _fold_list(tot[1][c * C:i + 1])
        return acc + prefix_2(c - 1) if c else acc

    # the down-sweep, a tile a block
    p2 = in2.clone()
    if nb > 1:
        p2[1:] = in2[1:] + pre[3][:nb - 1, None]
    edge2 = torch.zeros(nb)
    edge1 = torch.zeros(nb)
    for b in range(1, nb):
        edge2[b] = prefix_2(C * b - 1)
        edge1[b] = prefix_1(T * b - 1)
    b = torch.arange(nb)[:, None]
    q = torch.arange(T) // C
    up1 = torch.where(q >= 1, p2[:, (q - 1).clamp(min=0)], edge2[:, None])
    in1f = in1.reshape(nb, T)
    p1 = torch.where(b * C + q >= 1, in1f + up1, in1f)
    t_ = torch.arange(T)
    up0 = torch.where(t_ >= 1, p1[:, (t_ - 1).clamp(min=0)], edge1[:, None])
    p0 = torch.where((b * T + t_ >= 1)[..., None], in0 + up0[..., None], in0)
    return p0.reshape(-1)[:n]


def mu_model(x, target):
    """The down-sweep's first ``i`` with ``est > target`` and the draw's
    ``mu`` (``mvs_mu``), on the scores ascending."""
    n = x.shape[0]
    if torch.isnan(x[-1]):
        return x[-1:]
    p0 = scan_model(x)
    i = torch.arange(n - 1, -1, -1, dtype=torch.float32)   # x's j -> i
    est = i + p0 / torch.clamp(x, min=np.float32(1e-35))
    over = torch.nonzero(est > np.float32(target)).flatten()
    if not over.numel():
        return x[:1]
    j = int(over.max())
    return (p0[j] / torch.clamp(np.float32(target) - i[j],
                                min=np.float32(1e-10))).reshape(1)


def _scores(n, seed):
    rng = np.random.RandomState(seed)
    g = rng.randn(n).astype(np.float32)
    h = (rng.rand(n) * 0.25).astype(np.float32)
    return sample.mvs_scores(torch.from_numpy(np.abs(g * h)), 1e-6)


def test_scan_levels_match_prefix_sum_recursion():
    assert sample.scan_levels(16) == [16]
    assert sample.scan_levels(17) == [17, 2]
    assert sample.scan_levels(10_500_000) == [10_500_000, 656_250, 41_016,
                                              2_564, 161, 11]
    assert sample.scan_words(10_500_000) == \
        4 + 656_250 + 41_016 + 2_564 + 161 + 11 + 2_564 + 161 + 11


@pytest.mark.parametrize("n", SCAN_SIZES)
def test_scan_model_is_prefix_sum_and_jax_cumsum(n):
    import jax
    import jax.numpy as jnp
    x = sample.sort_scores(_scores(n, n % 89))
    got = scan_model(x)
    # the plain version's suffix sums of the descending order, reversed
    _same(got, prefix_sum(x, 0))
    s_desc = x.flip(0).numpy()
    want = jax.jit(lambda v: jnp.cumsum(v[::-1])[::-1])(s_desc)
    _same(got.flip(0), want)


@pytest.mark.parametrize("n", (1, 17, 4097, 65537))
def test_mu_model_is_mvs_threshold(n):
    s = _scores(n, 7)
    x = sample.sort_scores(s)
    for frac in (0.1, 0.6, 0.99, 1.0):
        _same(mu_model(x, frac * n), sample.mvs_threshold(s, frac * n),
              f"bagging_fraction {frac}")


@pytest.mark.parametrize("n", (1, 64, 5000))
def test_mvs_threshold_when_no_i_passes(n):
    """Equal scores: est is n at every i, so a target of n (or more) is
    passed nowhere and mu is the smallest score."""
    import jax
    from lightgbm_tpu.models.boosting import MVS
    s = torch.full((n,), 0.75, dtype=torch.float32)
    jfn = jax.jit(MVS._threshold_device, static_argnums=1)
    for target in (float(n), n + 3.5):
        mu = sample.mvs_threshold(s, target)
        _same(mu, [0.75])
        _same(mu, [jfn(s.numpy(), target)])
        _same(mu_model(sample.sort_scores(s), target), mu)


def test_mvs_step_with_a_nan_score_keeps_no_row():
    s_in = _scores(100, 3)
    s_in[17] = float("nan")
    words = torch.tensor([5, 6, 0, 0], dtype=torch.int64)
    w, s, mu = sample.mvs_step(words, s_in, 1e-6, 60.0)
    assert torch.isnan(mu).all() and torch.isnan(s[17])
    assert not bool((w != 0).any())
    assert torch.isnan(mu_model(sample.sort_scores(s), 60.0)).all()


# ---------------------------------------------------------------------
# GOSS's radix select, as the kernel's three passes take it
# ---------------------------------------------------------------------
def order_keys(gh):
    """The kernel's ``order_key``: larger values larger keys, -0 as +0,
    NaN 0."""
    b = gh.view(np.uint32).astype(np.uint64)
    k = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    k = np.where(b == 0x80000000, 0x80000000, k)
    return np.where(np.isnan(gh), 0, k).astype(np.uint64)


def select_model(gh, top_k):
    keys = order_keys(gh)
    prefix, left, above_all = 0, top_k, 0
    pos = 32
    for bits in sample.SELECT_DIGITS:
        pos -= bits
        rows = keys if prefix == 0 and pos == 32 - bits else \
            keys[(keys >> (pos + bits)) == prefix]
        hist = np.bincount(((rows >> pos) & ((1 << bits) - 1)).astype(
            np.int64), minlength=1 << bits)
        at_or_above = np.cumsum(hist[::-1])[::-1]
        above = at_or_above - hist
        (d,) = np.nonzero((above < left) & (left <= at_or_above))
        d = int(d[0])
        above_all += int(above[d])
        left -= int(above[d])
        prefix = (prefix << bits) | d
    n_tie = int(hist[d])
    if prefix == 0:                      # the k-th row is NaN
        thr = gh[np.isnan(gh)][:1]
        n_gt, n_tie = 0, 1
    else:
        u = prefix & 0x7FFFFFFF if prefix >= 0x80000000 else \
            ~prefix & 0xFFFFFFFF
        thr = np.array([u], np.uint32).view(np.float32)
        n_gt = above_all
    p_tie = np.clip(np.float32(top_k - n_gt) / np.float32(n_tie),
                    np.float32(0), np.float32(1))
    return thr, n_gt, n_tie, np.float32(p_tie)


def _gh(case, n, seed=0):
    rng = np.random.RandomState(seed)
    gh = np.abs(rng.randn(n) * rng.rand(n) * 0.25).astype(np.float32)
    if case == "ties":
        gh = (rng.randint(0, 40, n) / 64.0).astype(np.float32)
    elif case == "all tied":
        gh[:] = np.float32(0.125)
    elif case == "zeros":
        gh[:] = 0
    elif case == "nan and inf":
        gh[rng.rand(n) < 0.1] = np.nan
        gh[rng.rand(n) < 0.05] = np.inf
    elif case == "mostly nan":
        gh[rng.rand(n) < 0.9] = np.nan
    return gh


CASES = ("continuous", "ties", "all tied", "zeros", "nan and inf",
         "mostly nan")


@pytest.mark.parametrize("n", (1, 17, 4097, 65537))
@pytest.mark.parametrize("case", CASES)
def test_select_model_is_goss_threshold_and_jax(case, n):
    import jax.numpy as jnp
    gh = _gh(case, n, seed=n)
    for rate in (0.2, 0.5, 1.0):
        top_k = max(int(n * rate), 1)
        thr, n_gt, n_tie, p_tie = select_model(gh, top_k)
        pthr, pgt, ptie, pp = sample.goss_threshold(torch.from_numpy(gh),
                                                    top_k)
        _same(thr, pthr, f"{case} thr, top_k {top_k}")
        assert (n_gt, n_tie) == (int(pgt), int(ptie)), (case, top_k)
        _same([p_tie], pp, f"{case} p_tie")
        # the JAX package's expressions (GOSS._goss_mask_impl)
        jgh = jnp.asarray(gh)
        jthr = -jnp.sort(-jgh)[top_k - 1]
        jgt = jnp.sum(jgh > jthr)
        jtie = jnp.maximum(jnp.sum(jgh == jthr), 1)
        _same(thr, [jthr])
        assert n_gt == int(jgt) and n_tie == int(jtie)
        _same([p_tie], [jnp.clip((top_k - jgt) / jtie, 0.0, 1.0)])
    if case == "mostly nan" and n > 1:
        # fewer non-NaN rows than top_k: the threshold is NaN
        assert np.isnan(select_model(gh, n)[0]).all()


# ---------------------------------------------------------------------
# the steps on the CPU
# ---------------------------------------------------------------------
def test_steps_on_cpu_tensors_are_the_plain_versions():
    gh = torch.from_numpy(_gh("ties", 3000, 4))
    words = torch.tensor([1, 2, 3, 4], dtype=torch.int64)
    before = (dict(sample.LAUNCHES), dict(sample.STEP_LAUNCHES))
    w, thr, n_gt, n_tie, p_tie = sample.goss_step(words, gh, 600, 0.125, 8.0)
    pthr, pgt, ptie, pp = sample.goss_threshold(gh, 600)
    _same(w, sample.goss_weights_plain(words, gh, pthr, pp, 0.125, 8.0))
    _same(thr, pthr)
    _same(p_tie, pp)
    assert (int(n_gt), int(n_tie)) == (int(pgt), int(ptie))
    w, s, mu = sample.mvs_step(words, gh, 1e-6, 1800.0)
    _same(s, sample.mvs_scores(gh, 1e-6))
    _same(mu, sample.mvs_threshold(s, 1800.0))
    _same(w, sample.mvs_weights_plain(words, s, mu))
    assert (dict(sample.LAUNCHES), dict(sample.STEP_LAUNCHES)) == before
    with pytest.raises(ValueError, match="top_k"):
        sample.goss_step(words, gh, 3001, 0.1, 1.0)


def test_select_plan_covers_the_rows():
    assert sample.select_plan(1, 132) == 1
    assert sample.select_plan(2048 * 3 + 1, 132) == 4
    assert sample.select_plan(10_500_000, 132) == 4 * 132


# ---------------------------------------------------------------------
# on the card: the step's kernels against the plain versions
# ---------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (kernel B's sampling step)")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 15, 17, 4097, 65537, 2 ** 20 + 3])
def test_steps_match_plain_on_card(card, n):
    dev = torch.device("cuda")
    words = torch.tensor([11, 12, 13, 14], dtype=torch.int64)
    for case in CASES:
        gh = torch.from_numpy(_gh(case, n, seed=n))
        top_k = max(int(n * 0.2), 1)
        got = sample.goss_step(words.to(dev), gh.to(dev), top_k, 0.1, 4.0)
        want = sample.goss_step(words, gh, top_k, 0.1, 4.0)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(
                np.atleast_1d(a.cpu().numpy()).view(np.uint8),
                np.atleast_1d(b.numpy()).view(np.uint8), case)
        if case in ("continuous", "ties", "zeros"):
            got = sample.mvs_step(words.to(dev), gh.to(dev), 1e-6, 0.6 * n)
            want = sample.mvs_step(words, gh, 1e-6, 0.6 * n)
            for a, b in zip(got, want):
                _same(a.cpu(), b, f"MVS, {case}")
