"""Row sampling draws of the port (``ops/sample.py``, ``utils/prng.py``)
against the JAX package's, on the CPU.

Contract (atol 0 everywhere: every value is the same float32 bits):

- ``prng.uniform_rows(key, n)`` is ``jax.random.uniform(key, (n,))`` at
  n = 1, 17, 4097, 65537 and 300000, from a host key and from its words
  as a tensor;
- a booster's ``sample_weights(it, grad, hess)`` is the JAX booster's
  mask for the same iteration, gradients, labels and seed, at the same
  n: bernoulli and stratified bagging (``_draw_bag_mask_impl``, and the
  ``bagging_freq`` cache of ``_bagging_mask`` iteration by iteration),
  GOSS (``_goss_mask_impl``, on gradients with and without ties at the
  top-set threshold) and MVS (``_mvs_mask``: ``_mvs_mask_impl`` in its
  own compile, which fuses ``gh * gh + var_weight`` into one rounding);
- the thresholds: GOSS's ``thr``, ``n_gt``, ``n_tie`` and ``p_tie``
  against the JAX package's expressions, MVS's ``mu`` against
  ``MVS._threshold_device``, and ``prefix_sum`` of the flipped vector
  against the jitted ``jnp.cumsum(x[::-1])[::-1]``.

The tests marked ``cuda`` hold kernel B against its plain version on the
card and skip here; JAX is imported only by the tests that compare with
it, so on a machine with a card and without JAX they run alone:
``python3 -m pytest --noconftest -m cuda tests/test_torch_sample.py``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu_torch as ltt  # noqa: E402
from lightgbm_tpu_torch.ops import sample  # noqa: E402
from lightgbm_tpu_torch.ops.split import prefix_sum  # noqa: E402
from lightgbm_tpu_torch.utils import prng  # noqa: E402

SIZES = (1, 17, 4097, 65537, 300000)
MODES = {
    "bernoulli": {"bagging_fraction": 0.7, "bagging_freq": 3},
    "stratified": {"pos_bagging_fraction": 0.5,
                   "neg_bagging_fraction": 0.9, "bagging_freq": 1},
    "goss": {"boosting": "goss", "top_rate": 0.3, "other_rate": 0.2},
    "mvs": {"boosting": "mvs", "bagging_fraction": 0.6},
}


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _same(a, b, what=""):
    np.testing.assert_array_equal(_bits(a), _bits(b), what)


def _grads(n, ties, seed=0):
    """float32 gradients and hessians; with ``ties`` |g * h| takes a few
    exact values, so the GOSS threshold falls inside a run of equal
    rows."""
    rng = np.random.RandomState(seed)
    if ties:
        g = (rng.randint(-6, 7, n) / 4.0).astype(np.float32)
        h = np.full(n, 0.25, np.float32)
    else:
        g = rng.randn(n).astype(np.float32)
        h = (rng.rand(n) * 0.25).astype(np.float32)
    return g, h


def _boosters(n, extra, seed=0):
    """A JAX booster and a port booster (CPU) over the same n x 1 data."""
    import lightgbm_tpu as lgb
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 1)
    y = (rng.rand(n) < 0.4).astype(np.float64)
    p = {"objective": "binary", "verbose": -1, "metric": "None",
         "bagging_seed": 11, **extra}
    bj = lgb.Booster(params=p, train_set=lgb.Dataset(X, label=y, params=p))
    pt = dict(p, device_type="cpu")
    bt = ltt.Booster(params=pt, train_set=ltt.Dataset(X, label=y, params=pt))
    return bj._gbdt, bt._gbdt


# ---------------------------------------------------------------------
# the uniform draw
# ---------------------------------------------------------------------
@pytest.mark.parametrize("n", SIZES)
def test_uniform_rows_is_jax_uniform(n):
    import jax
    for seed, it in ((3, 5), (0x7FFFFFFF, 0), (12345, 77)):
        want = jax.random.uniform(
            jax.random.fold_in(jax.random.PRNGKey(seed), it), (n,))
        key = prng.fold_in(prng.prng_key(seed), it)
        _same(prng.uniform_rows(key, n), want)
        words = torch.tensor(key.astype(np.int64))
        _same(prng.uniform_rows(words, n), want)


def test_uniform_rows_split_keys_are_jax_split():
    import jax
    key = jax.random.fold_in(jax.random.PRNGKey(9), 4)
    ku, kt = jax.random.split(key)
    hu, ht = prng.split(prng.fold_in(prng.prng_key(9), 4))
    _same(prng.uniform_rows(hu, 1000), jax.random.uniform(ku, (1000,)))
    _same(prng.uniform_rows(ht, 1000), jax.random.uniform(kt, (1000,)))


# ---------------------------------------------------------------------
# the weight functions of each mode against the JAX booster's
# ---------------------------------------------------------------------
def _jax_weights(gj, name, it, g, h):
    import jax.numpy as jnp
    G, H = jnp.asarray(g[None]), jnp.asarray(h[None])
    if name == "goss":
        out = gj._goss_mask_impl(it, G, H)
        _same(gj._goss_mask(it, G, H), out, "jitted GOSS")
        return out
    if name == "mvs":
        return gj._mvs_mask(it, G, H)          # jax.jit(_mvs_mask_impl)
    gj._ensure_label_pos()
    freq = gj.config.bagging_freq
    out = gj._draw_bag_mask_impl(it - it % freq)
    _same(gj._draw_bag_mask(it - it % freq), out, "jitted bagging draw")
    return out


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", list(MODES))
def test_weights_match_jax(name, n):
    gj, gt = _boosters(n, MODES[name])
    for it, ties in ((0, False), (4, True), (7, False)):
        g, h = _grads(n, ties, seed=it)
        want = _jax_weights(gj, name, it, g, h)
        got = gt.sample_weights(it, torch.from_numpy(g), torch.from_numpy(h))
        assert got.dtype == torch.float32 and got.shape == (n,)
        _same(got, want, f"{name} at iteration {it}")


@pytest.mark.parametrize("name", ["bernoulli", "stratified"])
def test_bagging_cache_is_the_fold_of_the_last_draw(name):
    """The JAX booster's ``bagging_freq`` cache, iteration by iteration,
    is the port's pure draw of ``it - it % bagging_freq``."""
    gj, gt = _boosters(5000, MODES[name])
    g, h = _grads(5000, False)
    for it in range(8):
        gj.iter = it
        want = gj._bagging_mask(g[None], h[None])
        _same(gt.sample_weights(it, torch.from_numpy(g),
                                torch.from_numpy(h)), want, f"iteration {it}")


def test_goss_ties_are_admitted_at_the_jax_rate():
    """A threshold inside a run of equal rows: the ties are admitted by the
    tie key's draw, and the top set's size is near top_k."""
    n = 4097
    gj, gt = _boosters(n, MODES["goss"])
    g, h = _grads(n, True)
    gh = torch.from_numpy(np.abs(g * h))
    top_k = int(n * 0.3)
    thr, n_gt, n_tie, p_tie = sample.goss_threshold(gh, top_k)
    assert 0 < float(p_tie) < 1 and int(n_tie) > 1
    w = gt.sample_weights(2, torch.from_numpy(g), torch.from_numpy(h))
    top = int((w == 1).sum())
    assert abs(top - top_k) < 4 * np.sqrt(int(n_tie))
    _same(w, _jax_weights(gj, "goss", 2, g, h))


# ---------------------------------------------------------------------
# the thresholds
# ---------------------------------------------------------------------
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("ties", [False, True])
def test_goss_threshold_matches_jax(n, ties):
    import jax.numpy as jnp
    g, h = _grads(n, ties)
    gh = np.abs(g * h)
    for rate in (0.2, 0.5):
        top_k = max(int(n * rate), 1)
        thr, n_gt, n_tie, p_tie = sample.goss_threshold(
            torch.from_numpy(gh), top_k)
        jgh = jnp.asarray(gh)
        jthr = -jnp.sort(-jgh)[top_k - 1]
        jgt = jnp.sum(jgh > jthr)
        jtie = jnp.maximum(jnp.sum(jgh == jthr), 1)
        _same(thr, [jthr])
        assert int(n_gt) == int(jgt) and int(n_tie) == int(jtie)
        _same(p_tie, [jnp.clip((top_k - jgt) / jtie, 0.0, 1.0)])


@pytest.mark.parametrize("n", SIZES)
def test_mvs_threshold_matches_jax(n):
    import jax
    from lightgbm_tpu.models.boosting import MVS
    g, h = _grads(n, False)
    s = sample.mvs_scores(torch.from_numpy(np.abs(g * h)), 1e-6)
    jfn = jax.jit(MVS._threshold_device, static_argnums=1)
    for frac in (0.1, 0.6, 0.99):
        _same(sample.mvs_threshold(s, frac * n), [jfn(s.numpy(), frac * n)],
              f"bagging_fraction {frac}")


@pytest.mark.parametrize("n", SIZES)
def test_mvs_scores_fuse_as_the_jax_compile(n):
    """``sqrt(gh * gh + var_weight)`` as ``_mvs_mask_impl``'s compile forms
    it: the product and the add in one rounding."""
    import jax
    import jax.numpy as jnp
    g, h = _grads(n, False, seed=3)
    gh = np.abs(g * h)

    @jax.jit
    def scores(x):
        return jnp.sqrt(x * x + jnp.float32(1e-6))

    _same(sample.mvs_scores(torch.from_numpy(gh), 1e-6), scores(gh))


@pytest.mark.parametrize("n", SIZES)
def test_flipped_prefix_sum_is_jax_suffix_cumsum(n):
    import jax
    import jax.numpy as jnp
    rng = np.random.RandomState(n % 97)
    x = -np.sort(-rng.rand(n).astype(np.float32) * 3.0)
    want = jax.jit(lambda v: jnp.cumsum(v[::-1])[::-1])(x)
    got = prefix_sum(torch.from_numpy(x).flip(0), 0).flip(0)
    _same(got, want)


# ---------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_version():
    words = torch.tensor([1, 2, 3, 4], dtype=torch.int64)
    before = dict(sample.LAUNCHES)
    w = sample.bag_weights(words, 100, 0.5, 1.0, 1.0)
    assert sample.LAUNCHES == before
    _same(w, sample.bag_weights_plain(words, 100, 0.5, 1.0, 1.0, None))


def test_kernel_plan_covers_the_rows():
    assert sample.sample_plan(1, 132) == 1
    assert sample.sample_plan(256 * 5 + 1, 132) == 6
    assert sample.sample_plan(10_500_000, 132) == 8 * 132


# ---------------------------------------------------------------------
# on the card: kernel B against its plain version
# ---------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (kernel B)")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 1025, 300000])
def test_kernel_b_matches_plain_on_card(card, n):
    dev = torch.device("cuda")
    rng = np.random.RandomState(n)
    words = torch.tensor([rng.randint(0, 2 ** 32) for _ in range(4)],
                         dtype=torch.int64)
    g, h = _grads(n, n % 2 == 1)
    gh = torch.from_numpy(np.abs(g * h))
    label_pos = torch.from_numpy((rng.rand(n) < 0.4).astype(np.uint8))
    top_k = max(int(n * 0.3), 1)
    thr, _, _, p_tie = sample.goss_threshold(gh, top_k)
    s = sample.mvs_scores(gh, 1e-6)
    mu = sample.mvs_threshold(s, 0.6 * n)
    cases = {
        "bernoulli": lambda d: sample.bag_weights(
            words.to(d), n, 0.7, 1.0, 1.0),
        "stratified": lambda d: sample.bag_weights(
            words.to(d), n, 1.0, 0.5, 0.9, label_pos.to(d)),
        "goss": lambda d: sample.goss_weights(
            words.to(d), gh.to(d), thr.to(d), p_tie.to(d), 0.2 / 0.7,
            0.7 / 0.2),
        "mvs": lambda d: sample.mvs_weights(words.to(d), s.to(d), mu.to(d)),
    }
    for name, fn in cases.items():
        before = sum(sample.LAUNCHES.values())
        got = fn(dev)
        again = fn(dev)
        torch.cuda.synchronize()
        assert sum(sample.LAUNCHES.values()) == before + 2
        _same(got.cpu(), fn(torch.device("cpu")), name)
        _same(again.cpu(), got.cpu(), f"{name}, repeat launch")
    # the card's thresholds are the CPU's
    _same(sample.mvs_threshold(s.to(dev), 0.6 * n).cpu(), mu)
    for a, b in zip(sample.goss_threshold(gh.to(dev), top_k),
                    sample.goss_threshold(gh, top_k)):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
