"""Fused super-steps (``fused_iters``, ``superstep_pipeline_depth``) of the
port, and the tree phases they run on (``ops/grow.py``'s state and
phases, ``ops/graphs.py``'s runner), on the CPU.

The contract of ``tests/test_superstep.py``, ported: a booster trained
with ``fused_iters=K`` gives the same trees, training scores and
predictions as ``fused_iters=1``, bit for bit (atol 0), at pipeline
depths 0 and 1, on the exact loop, float waves and quantized two-column
waves without and with coarse-to-fine refinement; blocks of K trees after
the unfused ``boost_from_average`` iteration 0, the tail block sized down
to ``num_iterations``, one records fetch a block; feature-fraction masks
drawn in sequential order, quantization keys folded by tree id; a tree
that cannot split ends training with the sequential path's score.

Against the JAX package's ``fused_iters=4`` (``JAX_PLATFORMS=cpu``) the
port's ``fused_iters=4`` holds the contract of
``tests/test_torch_slice.py``: identical split features, thresholds,
decision types, children and counts; raw predictions within 1e-5
(absolute).  The port sums histograms in float64 and rounds once, the
JAX package in float32 in row order.

The tests marked ``cuda`` hold the card's CUDA graphs to its eager
launches and need a card; they skip here.  The file imports JAX only in
the test that compares with it, so on a machine with a card and without
JAX the card tests run alone:
``python3 -m pytest --noconftest -m cuda tests/test_torch_superstep.py``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu_torch as ltt  # noqa: E402
from lightgbm_tpu_torch.ops import graphs, histogram, lookup  # noqa: E402
from lightgbm_tpu_torch.ops import split  # noqa: E402
from lightgbm_tpu_torch.ops.grow import (  # noqa: E402
    GrowParams, GrowState, build_tree, key_words, quantize_gradients,
    row_uniform, serial_steps, tree_head, tree_tail, wave_body, wave_loop)
from lightgbm_tpu_torch.ops.split import SplitParams  # noqa: E402
from lightgbm_tpu_torch.utils import prng  # noqa: E402

ROUNDS = 10
# the four loop kinds: 8 features and 64 bins, but 28 features and 256
# bins for coarse-to-fine (its gate: features x padded bins >= 7000)
CONFIGS = {
    "exact": {"num_leaves": 15},
    "float waves": {"num_leaves": 15, "wave_splits": True,
                    "hist_refinement": False},
    "two-column waves": {"num_leaves": 31, "wave_splits": True,
                         "use_quantized_grad": True, "min_data_in_leaf": 0,
                         "hist_refinement": False},
    "two-column c2f waves": {"num_leaves": 31, "wave_splits": True,
                             "use_quantized_grad": True,
                             "min_data_in_leaf": 0},
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The file's tensors are small: one intra-op thread runs them faster
    than a pool does, and leaves the other test workers' cores alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n, F, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n) < 0.1, 3] = np.nan
    z = X[:, 0] + 0.5 * np.nan_to_num(X[:, 1]) - 0.4 * X[:, 2] * X[:, 4]
    y = (z + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return X, y


DATA = _data(1500, 8)
WIDE = _data(1500, 28)


def _c2f(extra) -> bool:
    return bool(extra.get("wave_splits") and
                extra.get("hist_refinement", True))


def _data_of(extra):
    """``WIDE`` under coarse-to-fine, else ``DATA``."""
    return WIDE if _c2f(extra) else DATA


def _train(extra, fused=1, depth=1, rounds=ROUNDS, data=None,
           device="cpu", eager=False, horizon=None):
    """``rounds`` updates of a booster whose horizon (``num_iterations``,
    what sizes the tail block) is ``horizon``, by default ``rounds``, on
    ``data``, by default :func:`_data_of` ``extra``."""
    X, y = data or _data_of(extra)
    p = {"objective": "binary", "max_bin": 255 if _c2f(extra) else 63,
         "verbose": -1, "device_type": device, "fused_iters": fused,
         "superstep_pipeline_depth": depth, **extra}
    ds = ltt.Dataset(X, label=y, params=p)
    b = ltt.Booster(params=p, train_set=ds, _eager=eager)
    b._gbdt.config.num_iterations = horizon or rounds
    for _ in range(rounds):
        if b.update():
            break
    return b


def _assert_identical(a, b, X):
    """Trees, training scores and predictions on ``X`` bit-identical."""
    assert a.model_to_string() == b.model_to_string()
    for ta, tb in zip(a.models, b.models):
        np.testing.assert_array_equal(ta.leaf_value, tb.leaf_value)
        np.testing.assert_array_equal(ta.split_feature, tb.split_feature)
        np.testing.assert_array_equal(ta.threshold_bin, tb.threshold_bin)
        np.testing.assert_array_equal(ta.decision_type, tb.decision_type)
        np.testing.assert_array_equal(ta.leaf_count, tb.leaf_count)
    np.testing.assert_array_equal(a._gbdt.train_score(),
                                  b._gbdt.train_score())
    np.testing.assert_array_equal(a.predict(X, raw_score=True),
                                  b.predict(X, raw_score=True))


# ---------------------------------------------------------------------
# parity of the super-step with the per-iteration path
# ---------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CONFIGS))
def test_fused_matches_per_iteration(name):
    a = _train(CONFIGS[name], fused=1)
    b = _train(CONFIGS[name], fused=4)
    assert b._gbdt.grow_params.refine_shift == (4 if "c2f" in name else 0)
    assert len(a.models) == len(b.models) == ROUNDS
    assert all(t.num_leaves == CONFIGS[name]["num_leaves"]
               for t in b.models)
    _assert_identical(a, b, _data_of(CONFIGS[name])[0])


@pytest.mark.parametrize("name", ["exact", "two-column c2f waves"])
def test_pipeline_depth_0_and_1_identical(name):
    a = _train(CONFIGS[name], fused=4, depth=0)
    b = _train(CONFIGS[name], fused=4, depth=1)
    _assert_identical(a, b, _data_of(CONFIGS[name])[0])


def test_tail_block_auto_sizes():
    """10 rounds with K=4: the unfused bias iteration, then 4, 4 and 1."""
    b = _train(CONFIGS["exact"], fused=4)
    assert b._gbdt.block_sizes == [1, 4, 4, 1]
    assert b.num_trees() == ROUNDS


@pytest.mark.parametrize("fused,fetches", [(1, ROUNDS), (4, 4), (7, 3)])
def test_one_records_fetch_per_block(fused, fetches):
    b = _train(CONFIGS["float waves"], fused=fused)
    assert b._gbdt.records_fetches == fetches == len(b._gbdt.block_sizes)
    assert sum(b._gbdt.block_sizes) == ROUNDS


def test_no_bias_iteration_fuses_from_the_start():
    extra = dict(CONFIGS["exact"], boost_from_average=False)
    a = _train(extra, fused=1)
    b = _train(extra, fused=4)
    assert b._gbdt.block_sizes == [4, 4, 2]
    _assert_identical(a, b, DATA[0])


def test_feature_fraction_predraws_match_sequential_draws():
    extra = dict(CONFIGS["two-column waves"], feature_fraction=0.5)
    a = _train(extra, fused=1)
    b = _train(extra, fused=4)
    _assert_identical(a, b, DATA[0])
    # the same draws were consumed, in the same order
    sa = a._gbdt._rng_feature.get_state()
    sb = b._gbdt._rng_feature.get_state()
    np.testing.assert_array_equal(sa[1], sb[1])
    assert sa[2] == sb[2]
    used = [set(t.split_feature[:t.num_leaves - 1]) for t in b.models]
    assert all(len(u) <= 4 for u in used)


@pytest.mark.parametrize("fused", [1, 4])
def test_quant_keys_fold_by_tree_id(fused):
    """Each tree's key words are those of ``fold_in(key, tree id)``."""
    X, y = DATA
    p = {"objective": "binary", "max_bin": 255, "verbose": -1,
         "device_type": "cpu", "fused_iters": fused,
         **CONFIGS["two-column waves"]}
    b = ltt.Booster(params=p, train_set=ltt.Dataset(X, label=y, params=p))
    g = b._gbdt
    g.config.num_iterations = ROUNDS
    seen, run = [], g.runner.run

    def spy():
        seen.append(tuple(g._state.key_words.tolist()))
        return run()

    g.runner.run = spy
    for _ in range(ROUNDS):
        b.update()
    key = prng.prng_key(g.config.data_random_seed & 0x7FFFFFFF)
    assert seen == [key_words(prng.fold_in(key, t)) for t in range(ROUNDS)]
    assert g._trees_dispatched == ROUNDS


def _stop_data():
    """A binary feature that separates two label values: with
    learning_rate 1 the first tree fits them exactly, and the second
    cannot split."""
    rng = np.random.RandomState(3)
    X = rng.randn(400, 6)
    X[:, 0] = rng.rand(400) > 0.5
    return X, np.where(X[:, 0] > 0, 2.0, -1.0)


@pytest.mark.parametrize("extra,n_trees", [
    ({}, 1),                                        # stops at iteration 0
    ({"boost_from_average": False, "learning_rate": 1.0}, 2),
], ids=["bias iteration", "mid-block"])
@pytest.mark.parametrize("depth", [0, 1])
def test_stop_parity(extra, n_trees, depth):
    """A tree that cannot split ends training exactly where the
    per-iteration path ends it, with its score: the trees dispatched
    after it are dropped and the score of the trees before it is
    replayed."""
    X, y = _stop_data() if extra else (DATA[0][:400], np.ones(400))
    extra = {"objective": "regression", "num_leaves": 7, **extra}
    a = _train(extra, fused=1, data=(X, y))
    b = _train(extra, fused=4, depth=depth, data=(X, y))
    ga, gb = a._gbdt, b._gbdt
    assert ga._stop_flag and gb._stop_flag
    assert len(ga.models) == len(gb.models) == n_trees
    assert b.models[-1].num_leaves == 1
    _assert_identical(a, b, X)
    assert b.update()                       # stays stopped


@pytest.mark.parametrize("depth", [0, 1])
def test_train_score_mid_block_is_the_served_trees(depth):
    """3 updates of a 10-round booster: the bias tree and 2 of a block of
    4 served, while the device score holds the block's end (and, at depth
    1, the next block's)."""
    a = _train(CONFIGS["exact"], fused=1, rounds=3)
    b = _train(CONFIGS["exact"], fused=4, depth=depth, rounds=3,
               horizon=ROUNDS)
    assert b._gbdt._fused_block["served"] == 2
    assert len(b._gbdt._sq) == depth
    np.testing.assert_array_equal(a._gbdt.train_score(),
                                  b._gbdt.train_score())
    assert a.model_to_string() == b.model_to_string()


# ---------------------------------------------------------------------
# against the JAX package's super-step
# ---------------------------------------------------------------------
@pytest.mark.parametrize("objective,nan", [("binary", True),
                                           ("regression", False)])
def test_fused_matches_jax_fused(objective, nan):
    # imported here: the card's machine runs this file's card tests
    # (``-m cuda --noconftest``) without JAX
    import lightgbm_tpu as lgb
    from test_torch_quant import assert_same_trees
    from test_torch_slice import _data as slice_data
    X, y = slice_data(31 + nan, objective, nan)
    p = {"objective": objective, "num_leaves": 15, "max_bin": 63,
         "verbose": -1, "metric": "None", "fused_iters": 4}
    bj = lgb.train(p, lgb.Dataset(X, label=y, params=p), num_boost_round=5,
                   verbose_eval=False)
    assert bj._gbdt._fused_block is not None        # the JAX side fused
    pt = dict(p, device_type="cpu")
    bt = ltt.train(pt, ltt.Dataset(X, label=y, params=pt), num_boost_round=5)
    assert bt._gbdt.block_sizes == [1, 4]
    assert_same_trees(bj, bt, X, 5)


# ---------------------------------------------------------------------
# the tree's phases over one state
# ---------------------------------------------------------------------
def _phase_inputs(wave, seed):
    rng = np.random.RandomState(seed)
    N, F = 3000, 8
    bins = rng.randint(0, 51, size=(F, N)).astype(np.uint8)
    bins[rng.random_sample((F, N)) < 0.1] = 51
    grad = rng.randn(N).astype(np.float32)
    hess = (rng.rand(N) + 0.5).astype(np.float32)
    fmask = rng.rand(F) < 0.8
    kw = dict(max_bin=64, min_data_in_leaf=0 if wave else 5,
              min_sum_hessian_in_leaf=1e-3, any_missing=True,
              counts_proxy=wave)
    gp = GrowParams(split=SplitParams(**kw), num_leaves=31,
                    quantize=15 if wave else 0, two_col=wave, wave=wave,
                    speculate=21 if wave else 0, refine_shift=3 if wave
                    else 0)
    t = torch.from_numpy
    return (t(bins), t(grad), t(hess), torch.ones(N), t(fmask),
            torch.full((F,), 52, dtype=torch.int32),
            torch.full((F,), 2, dtype=torch.int32), gp)


@pytest.mark.parametrize("wave", [False, True], ids=["exact", "c2f waves"])
def test_phases_over_one_state_match_build_tree(wave):
    """Driving head, steps or wave bodies, and tail by hand over one state
    object reused for three trees gives build_tree's trees."""
    bins, _, _, mask, _, nb, mt, gp = _phase_inputs(wave, 0)
    st = GrowState(bins, mask, nb, mt, gp)
    bodies = set()
    for seed in (1, 2, 3):
        _, grad, hess, _, fmask, _, _, _ = _phase_inputs(wave, seed)
        key = prng.fold_in(prng.prng_key(5), seed)
        want = {k: v.clone() for k, v in build_tree(
            bins, grad, hess, mask, fmask, nb, mt, gp, quant_key=key).items()}
        st.feature_mask.copy_(fmask)
        st.key_words.copy_(torch.tensor(key_words(key)))
        tree_head(st, grad, hess)
        waves = 0
        if wave:
            def body(wide):
                bodies.add(wide)
                wave_body(st, wide)
            waves = wave_loop(st, body)
        else:
            serial_steps(st)
        tree_tail(st)
        got = st.result(waves)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)
        assert int(got["n_leaves"]) == 31
    if wave:
        assert bodies == {False, True}      # both c2f variants ran


def test_row_uniform_tensor_word_matches_host_word():
    for word in (0, 1, 0x9E3779B9, 0xFFFFFFFF):
        np.testing.assert_array_equal(
            row_uniform(5000, torch.tensor(word, dtype=torch.int64),
                        "cpu").numpy(),
            row_uniform(5000, word, "cpu").numpy())


def test_quantize_gradients_from_key_words_matches_key():
    rng = np.random.RandomState(4)
    g = torch.from_numpy(rng.randn(3000).astype(np.float32))
    h = torch.from_numpy(rng.rand(3000).astype(np.float32))
    m = torch.ones(3000)
    key = prng.fold_in(prng.prng_key(11), 7)
    words = torch.tensor(key_words(key), dtype=torch.int64)
    for a, b in zip(quantize_gradients(g, h, m, 15, True, key),
                    quantize_gradients(g, h, m, 15, True, words)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_runner_refuses_graphs_of_cpu_tensors():
    bins, _, _, mask, _, nb, mt, gp = _phase_inputs(False, 0)
    st = GrowState(bins, mask, nb, mt, gp)
    with pytest.raises(ValueError, match="CUDA"):
        graphs.TreeRunner(st, lambda: None, lambda: None, graphs=True)


# ---------------------------------------------------------------------
# on the card: CUDA graphs against eager launches
# ---------------------------------------------------------------------
def _launches():
    return {**histogram.LAUNCHES, **split.LAUNCHES, **lookup.LAUNCHES}


def _reset():
    for d in (histogram.LAUNCHES, split.LAUNCHES, lookup.LAUNCHES,
              graphs.REPLAYS):
        for k in d:
            d[k] = 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs of the kernels)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_graphs_match_eager_on_card(card, name):
    """Graphed trees equal eagerly launched ones, at K = 1 and 4, and the
    launch counters count the same kernel launches executed."""
    runs = {}
    for label, kw in (("eager", dict(eager=True)), ("graphs", {}),
                      ("fused", dict(fused=4))):
        _reset()
        runs[label] = (_train(CONFIGS[name], device="cuda", **kw),
                       _launches(), graphs.REPLAYS["graph_replays"])
    (a, la, ra), (b, lb, rb), (c, lc, _) = (runs[k] for k in
                                            ("eager", "graphs", "fused"))
    X = _data_of(CONFIGS[name])[0]
    _assert_identical(a, b, X)
    _assert_identical(a, c, X)
    assert la == lb == lc
    assert ra == 0 < rb
    assert b._gbdt.runner.info["pool_bytes"] >= 0
