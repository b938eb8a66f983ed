"""The numerical-health check of the port's fused blocks
(``fused_iters`` 4 and 3, ``superstep_pipeline_depth`` 0 and 1), held to
the JAX package's super-step (``JAX_PLATFORMS=cpu``; the port with
``device_type=cpu``).

Each tree's packed record row carries the minimum and maximum of its
gradients, hessians, leaf values and new score row (``GBDT._minmax``,
computed in the tree's graphs on the card).  A fused block follows the JAX
super-step's rule (``lightgbm_tpu/models/gbdt.py:1370-1373``,
:1684-1702): an iteration is bad where its gradients, leaf values or
score are not all finite; at the first bad iteration ``j`` the block, and
every block dispatched after it, is dropped and the error raised at
``i0 + j`` with phase ``"superstep"``, unless a stop tree comes before
``j`` (a finite stop wins: the iterations after it are discarded
anyway).  The booster is then at its served boundary, the block's start:
``current_iteration()``, ``num_trees()``, model text, training score,
tree ids and feature-fraction stream as before the failing ``update()``.
The unfused boost_from_average iteration 0 follows the per-iteration
rule (phase ``"tree"``), in both packages.

Against the JAX package: NaN labels at the bias iteration and in the
first block, labels poisoned after a rewind to a served boundary (the
JAX package's ``test_nonfinite_guard_fused_midstream_exact_rewind``) and
with blocks still queued at depth 1.  The rule's cases that no input
reaches in both packages alike (a bad leaf value or score, a stop before
the bad iteration) are made by writing the health words of one tree as
the block's records land.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as ltt  # noqa: E402
from lightgbm_tpu_torch.models import gbdt as tgbdt  # noqa: E402
from test_torch_health import (_jax_error, _port_error,  # noqa: E402
                               _regression)
from test_torch_stop import _stop_data  # noqa: E402

ROUNDS = 12
# the health words: grad, hess, leaf values, score (a min and a max each)
WORDS = {"grad": 0, "hess": 2, "vals": 4, "score": 6}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _booster(pkg, X, y, fused=4, depth=0, **extra):
    p = {"objective": "regression", "num_leaves": 7, "verbose": -1,
         "metric": "None", "num_iterations": ROUNDS, "fused_iters": fused,
         "superstep_pipeline_depth": depth, **extra}
    if pkg is ltt:
        p["device_type"] = "cpu"
    b = pkg.Booster(params=p, train_set=pkg.Dataset(X, label=y, params=p))
    if pkg is lgb:
        b._gbdt._pipeline_enabled = False
    return b


def _nan_labels(every=None):
    X, y = _regression()
    bad = y.copy()
    bad[::every or len(y)] = np.nan
    return X, y, bad


def _poison(bj, bt, bad):
    """Both objectives' labels anew, the port's in place."""
    g = bj._gbdt
    meta = g.train_set.metadata
    meta.set_label(bad)
    g.objective.init(meta, g.num_data)
    g.objective._gradient_fn_jit = None
    g._superstep_jit = None
    bt._gbdt.objective.label.copy_(torch.from_numpy(bad.astype(np.float32)))


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("bias", [True, False],
                         ids=["bias iteration", "first block"])
def test_nan_label(bias, depth):
    """One NaN label: the unfused bias iteration raises by the
    per-iteration rule, a block from iteration 0 by the super-step's."""
    X, _, bad = _nan_labels()
    kw = dict(depth=depth, boost_from_average=bias)
    want = (0, "tree" if bias else "superstep")
    assert _port_error(_booster(ltt, X, bad, **kw)) == \
        _jax_error(_booster(lgb, X, bad, **kw)) == want


@pytest.mark.parametrize("depth", [0, 1])
def test_midstream_exact_rewind(depth):
    """Four clean updates of blocks of 3, a rewind to the served boundary,
    every label NaN in place: the next block raises at its first
    iteration, and nothing of it (or of a queued block) stays."""
    X, y, _ = _nan_labels()
    bad = np.full_like(y, np.nan)
    bj = _booster(lgb, X, y, fused=3, depth=depth)
    bt = _booster(ltt, X, y, fused=3, depth=depth)
    for _ in range(4):
        bj.update()
        bt.update()
    bj._gbdt._fused_rewind()
    bt._gbdt._fused_rewind()
    it0 = bt.current_iteration()
    _poison(bj, bt, bad)
    assert _port_error(bt) == _jax_error(bj) == (it0, "superstep")
    assert bt._gbdt._sq == [] and bt._gbdt._fused_block is None


def test_midstream_with_queued_blocks():
    """Depth 1, labels poisoned while a clean block is served and the next
    one queued: the trees dispatched before the poisoning are served, and
    the first block dispatched after it raises at its first iteration,
    where the JAX package's does."""
    X, y, _ = _nan_labels()
    bad = y.copy()
    bad[::5] = np.nan
    bj = _booster(lgb, X, y, depth=1)
    bt = _booster(ltt, X, y, depth=1)
    for _ in range(3):
        bj.update()
        bt.update()
    sq = bt._gbdt._sq
    first_bad = sq[-1]["i0"] + sq[-1]["k"]
    _poison(bj, bt, bad)
    assert _port_error(bt, rounds=ROUNDS, queued=True) == \
        _jax_error(bj, rounds=ROUNDS) == (first_bad, "superstep")
    g = bt._gbdt
    assert bt.current_iteration() == g._trees_dispatched == first_bad
    assert g._sq == [] and g._fused_block is None


def _write_words(monkeypatch, t, word, value=np.nan):
    """The health word ``word`` of tree ``t`` of every landing block
    written to ``value`` as the records land."""
    fetch = tgbdt.fetch_records

    def poisoned(rows, layout):
        out = fetch(rows, layout)
        if out["health"].shape[0] > t:
            out["health"][t, WORDS[word]] = value
        return out

    monkeypatch.setattr(tgbdt, "fetch_records", poisoned)


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("word", ["grad", "vals", "score"])
def test_bad_word_raises_at_its_iteration(monkeypatch, word, depth):
    """A non-finite gradient, leaf value or score word at the block's
    tree 1: the error names iteration i0 + 1, and the booster is at the
    block's start, i0 (no tree of the block served)."""
    X, y, _ = _nan_labels()
    bt = _booster(ltt, X, y, depth=depth, boost_from_average=False)
    _write_words(monkeypatch, 1, word)
    assert _port_error(bt) == (1, "superstep")
    assert bt.current_iteration() == bt.num_trees() == 0


def test_hess_word_is_not_the_super_steps(monkeypatch):
    """The super-step's flag reads the gradients, leaf values and score,
    not the hessians (those the per-iteration stop check reads)."""
    X, y, _ = _nan_labels()
    bt = _booster(ltt, X, y, boost_from_average=False)
    _write_words(monkeypatch, 1, "hess")
    for _ in range(6):
        bt.update()
    assert bt.current_iteration() == 6


@pytest.mark.parametrize("bad,raises", [(2, False), (1, True)],
                         ids=["after the stop", "at the stop"])
def test_stop_before_the_bad_iteration_wins(monkeypatch, bad, raises):
    """``_stop_data`` stops at iteration 1 of the first block (learning
    rate 1, no bias): a bad iteration after it is discarded with the
    iterations the stop drops; at the stop it raises."""
    X, y = _stop_data()
    bt = _booster(ltt, X, y, boost_from_average=False, learning_rate=1.0)
    _write_words(monkeypatch, bad, "vals")
    if raises:
        assert _port_error(bt) == (1, "superstep")
        return
    for _ in range(ROUNDS):
        if bt.update():
            break
    assert bt._gbdt._stop_flag
    assert (bt.num_trees(), bt.current_iteration()) == (2, 1)
