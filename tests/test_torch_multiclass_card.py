"""Multiclass training on the card: CUDA graphs (a head and a tail graph
a class) against eager launches and against the CPU.

Softmax on 2,000 rows x 8 features (28 under coarse-to-fine), 4 classes,
15 leaves, 4 iterations, on the exact loop, quantized two-column waves
and float coarse-to-fine waves: the graphed and eager runs give the same
model text and training score bit for bit and execute the same kernel
launches, class by class; the CPU's trees split alike.  It needs a card
and skips without one; it imports nothing of JAX, so it runs on the
card's machine with ``python3 -m pytest --noconftest -m cuda``.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as ltt

K = 4
CONFIGS = {
    "exact": {},
    "quantized two-column waves": {"wave_splits": True,
                                   "use_quantized_grad": True,
                                   "min_data_in_leaf": 0,
                                   "hist_refinement": False},
    "float c2f waves": {"wave_splits": True, "max_bin": 255},
}


def _data(n, F):
    rng = np.random.RandomState(11)
    X = rng.randn(n, F)
    X[rng.rand(n) < 0.1, 1] = np.nan
    y = np.argmax(np.nan_to_num(X[:, :K]) + 0.5 * rng.randn(n, K), 1)
    return X, y.astype(float)


def _splits(tree):
    n = tree.num_leaves - 1
    return [np.asarray(getattr(tree, k)[:n]).tolist() for k in
            ("split_feature", "threshold_bin", "decision_type",
             "left_child", "right_child")]


@pytest.mark.cuda
@pytest.mark.parametrize("config", list(CONFIGS))
def test_multiclass_graphs_match_eager_and_cpu_on_card(config):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from lightgbm_tpu_torch.ops import graphs
    X, y = _data(2000, 28 if "c2f" in config else 8)
    runs = {}
    for label, dev, kw in (("graphs", "cuda", {}),
                           ("eager", "cuda", {"_eager": True}),
                           ("cpu", "cpu", {})):
        p = {"objective": "multiclass", "num_class": K, "num_leaves": 15,
             "max_bin": 63, "verbose": -1, "device_type": dev,
             **CONFIGS[config]}
        b = ltt.Booster(params=p, train_set=ltt.Dataset(X, label=y,
                                                        params=p), **kw)
        before = [dict(c) for c in graphs.LAUNCH_COUNTERS]
        for _ in range(4):
            b.update()
        runs[label] = (b, [{k: c[k] - c0[k] for k in c}
                           for c, c0 in zip(graphs.LAUNCH_COUNTERS, before)])
    (g, lg), (e, le), (c, _) = (runs[k] for k in ("graphs", "eager", "cpu"))
    assert g._gbdt.runner.graphs is not None
    assert {f"head{k}" if "waves" in config else f"tree{k}"
            for k in range(K)} <= set(g._gbdt.runner.graphs)
    assert g.model_to_string() == e.model_to_string()
    assert np.array_equal(g._gbdt.train_score(), e._gbdt.train_score())
    assert lg == le
    assert g.num_trees() == c.num_trees() == 4 * K
    for a, b in zip(g.models, c.models):
        assert _splits(a) == _splits(b)
        np.testing.assert_allclose(a.leaf_value[:a.num_leaves],
                                   b.leaf_value[:b.num_leaves], rtol=1e-5,
                                   atol=0)
