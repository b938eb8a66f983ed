"""Categorical features on the card: CUDA graphs against eager launches,
against ``fused_iters`` and against the CPU.

3,000 rows with 4 categorical columns (12 levels, one with 10% NaN), a
3-level one (one-vs-other) and 6 numerical ones, 63 leaves,
``max_bin=63``, 4 iterations, on the exact loop and on quantized waves
(W = 42, routed outside the pass, kernel M a wave) with and without a
validation set: the graphed, eager and ``fused_iters=4`` runs give the
same model text and training score bit for bit and execute the same
kernel launches; the trees hold categorical splits; kernel R is never
launched on the waves and kernel M once a wave plus the root; kernels S
and L run; the validation score equals the trees' prediction within
1e-5.  The CPU's first tree splits on the same features (a later tree's
many-vs-many partition may trade sides: ``tests/
test_torch_categorical_train.py``).  It needs a card and skips without
one; it imports nothing of JAX, so it runs on the card's machine with
``python3 -m pytest --noconftest -m cuda``.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as ltt

CONFIGS = {
    "exact": {"use_quantized_grad": True},
    "waves": {"wave_splits": True, "use_quantized_grad": True,
              "min_data_in_leaf": 1},
}


def _data(n=3000):
    rng = np.random.RandomState(11)
    Xn = rng.randn(n, 6)
    Xc = rng.randint(0, 12, size=(n, 4)).astype(float)
    Xc[rng.rand(n) < 0.1, 1] = np.nan
    Xs = rng.randint(0, 3, size=(n, 1)).astype(float)
    X = np.column_stack([Xn, Xc, Xs])
    logit = Xn[:, 0] + 0.9 * np.isin(Xc[:, 0], [2, 5, 7]) - \
        0.6 * (Xc[:, 1] > 8) + 0.5 * (Xs[:, 0] == 1)
    y = (rng.random_sample(n) < 1 / (1 + np.exp(-logit))).astype(float)
    return X, y


def _params(config, dev, **kw):
    return {"objective": "binary", "num_leaves": 63, "max_bin": 63,
            "verbose": -1, "device_type": dev, "metric": "None",
            "categorical_feature": "6,7,8,9,10", **CONFIGS[config], **kw}


def _run(config, dev, X, y, rounds=4, eager=False, valid=False, **kw):
    from lightgbm_tpu_torch.ops import graphs
    p = _params(config, dev, **kw)
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
def test_categorical_graphs_match_eager_on_card(config, valid):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    X, y = _data()
    g, lg = _run(config, "cuda", X, y, valid=valid)
    e, le = _run(config, "cuda", X, y, eager=True, valid=valid)
    assert g._gbdt.runner.graphs is not None
    assert g.model_to_string() == e.model_to_string()
    assert np.array_equal(g._gbdt.train_score(), e._gbdt.train_score())
    assert lg == le
    assert sum(t.num_cat for t in g.models) > 0
    counts = {k: v for d in lg for k, v in d.items()}
    assert counts.get("best_split", 0) > 0
    if config == "waves":
        # the root's pass and one a wave: a tree's flag reads
        assert counts.get("routed_histogram", 0) == 0
        assert counts["multi_histogram"] == g._gbdt.runner.flag_reads > 4
    if valid:
        vs = g._gbdt.valid_sets[0]
        np.testing.assert_allclose(vs.score.cpu().numpy(),
                                   g.predict(X[2500:], raw_score=True),
                                   rtol=0, atol=1e-5)
        assert np.array_equal(vs.score.cpu().numpy(),
                              e._gbdt.valid_sets[0].score.cpu().numpy())
    else:
        f, lf = _run(config, "cuda", X, y, fused_iters=4)
        assert f.model_to_string() == g.model_to_string()
        assert np.array_equal(f._gbdt.train_score(), g._gbdt.train_score())
        assert lf == lg
    c, _ = _run(config, "cpu", X, y, rounds=1)
    a, b = g.models[0], c.models[0]
    assert list(a.split_feature[:4]) == list(b.split_feature[:4])
