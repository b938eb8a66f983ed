"""Bundled features (EFB) on the card: CUDA graphs against eager launches,
against ``fused_iters`` and against the CPU.

``tests/test_efb.py``'s one-hot generator (3,000 rows, 8 blocks of 6
indicator columns; 2,500 to train, 500 to validate), given as a CSR
matrix, bundled into 8 groups at width 7; 15 leaves, ``max_bin=63``, 4
iterations, on the exact loop and on quantized waves (W = 15, routed
outside the pass: kernel M a wave, never R) with and without a
validation set: the graphed, eager and ``fused_iters=4`` runs give the
same model text and training score bit for bit and execute the same
kernel launches; the validation score equals the trees' prediction
within 1e-5 and the eager run's bit for bit; the CPU's trees split on
the same features.  It needs a card and skips without one; it imports
nothing of JAX, so it runs on the card's machine with ``python3 -m
pytest --noconftest -m cuda``.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu_torch as ltt

CONFIGS = {
    "exact": {},
    "waves": {"wave_splits": True, "use_quantized_grad": True},
}


def _data(n=3000):
    rng = np.random.RandomState(0)
    cols, signal = [], np.zeros(n)
    for g in range(8):
        cat = rng.randint(0, 6, size=n)
        block = np.zeros((n, 6))
        block[np.arange(n), cat] = 1.0
        cols.append(block)
        signal += (cat == 0) * (g + 1) * 0.3
    y = signal + 0.05 * rng.randn(n)
    return sp.csr_matrix(np.concatenate(cols, 1)), \
        (y > np.median(y)).astype(float)


def _run(config, dev, X, y, rounds=4, eager=False, valid=False, **kw):
    from lightgbm_tpu_torch.ops import graphs
    p = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
         "min_data_in_leaf": 0, "min_sum_hessian_in_leaf": 1,
         "verbose": -1, "device_type": dev, "metric": "None",
         **CONFIGS[config], **kw}
    ds = ltt.Dataset(X[:2500], label=y[:2500], params=p)
    b = ltt.Booster(params=p, train_set=ds, _eager=eager)
    if valid:
        b.add_valid(ds.create_valid(X[2500:], label=y[2500:]), "v")
    b._gbdt.config.num_iterations = rounds
    before = [dict(c) for c in graphs.LAUNCH_COUNTERS]
    for _ in range(rounds):
        b.update()
    launches = [{k: c[k] - c0[k] for k in c if c[k] != c0[k]}
                for c, c0 in zip(graphs.LAUNCH_COUNTERS, before)]
    return b, launches


@pytest.mark.cuda
@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_bundled_graphs_match_eager_on_card(config, valid):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    X, y = _data()
    g, lg = _run(config, "cuda", X, y, valid=valid)
    e, le = _run(config, "cuda", X, y, eager=True, valid=valid)
    gb = g._gbdt
    assert gb._bundles is not None and gb._bundles.num_groups == 8
    assert gb.max_bin == 7 and gb._xt.shape[0] == 8
    assert gb.runner.graphs is not None
    assert g.model_to_string() == e.model_to_string()
    assert np.array_equal(gb.train_score(), e._gbdt.train_score())
    assert lg == le
    counts = {k: v for d in lg for k, v in d.items()}
    assert counts.get("best_split", 0) > 0
    if config == "waves":
        assert counts.get("routed_histogram", 0) == 0
        assert counts["multi_histogram"] == gb.runner.flag_reads > 4
    else:
        assert counts.get("histogram", 0) > 0
    if valid:
        vs = gb.valid_sets[0]
        assert tuple(vs.xt.shape) == (8, 500)
        np.testing.assert_allclose(vs.score.cpu().numpy(),
                                   g.predict(X[2500:], raw_score=True),
                                   rtol=0, atol=1e-5)
        assert np.array_equal(vs.score.cpu().numpy(),
                              e._gbdt.valid_sets[0].score.cpu().numpy())
        assert counts.get("route", 0) == 4
    else:
        f, lf = _run(config, "cuda", X, y, fused_iters=4)
        assert f.model_to_string() == g.model_to_string()
        assert np.array_equal(f._gbdt.train_score(), gb.train_score())
        assert lf == lg
    c, _ = _run(config, "cpu", X, y, rounds=2)
    for a, b in zip(g.models[:2], c.models):
        assert list(a.split_feature[:a.num_leaves - 1]) == \
            list(b.split_feature[:b.num_leaves - 1])
