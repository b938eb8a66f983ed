"""Multiclass training on the card: CUDA graphs (a head and a tail graph
a class) against eager launches and against the CPU.

Softmax on 2,000 rows x 8 features (28 under coarse-to-fine), 4 classes,
15 leaves, 4 iterations, on the exact loop, quantized two-column waves
and float coarse-to-fine waves: the graphed and eager runs give the same
model text and training score bit for bit and execute the same kernel
launches, class by class; the CPU's trees split alike.  At K > 1 under
GOSS, MVS, DART and random forests (softmax and one-vs-all, the exact
loop) the same, with kernel B's class sum and draw once an iteration;
and kernel B's class sum (gh, and MVS's scores of it) bit for bit
against its plain version at K = 2 and 5, 1 to 100,003 rows, on rows of
two strides, with a repeat launch.  It needs a card and skips without
one; it imports nothing of JAX, so it runs on the card's machine with
``python3 -m pytest --noconftest -m cuda``.
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


# ---------------------------------------------------------------------
# GOSS, MVS, DART and random forests at K > 1
# ---------------------------------------------------------------------
BOOSTING = {
    "goss": {"boosting": "goss"},
    "mvs": {"boosting": "mvs", "bagging_fraction": 0.5},
    "dart": {"boosting": "dart", "drop_rate": 0.3, "skip_drop": 0.0},
    "rf": {"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
           "feature_fraction": 0.8},
}


def _bits(t):
    return t.reshape(-1).contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 5])
def test_class_sum_kernel_matches_plain_on_card(k):
    """Kernel B's class sum (gh, and MVS's scores of it in the same launch)
    bit for bit against its plain version on the same CUDA tensors, a
    repeat launch the same bits, one launch a call; at ragged lengths and
    on rows of a padded stride."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from lightgbm_tpu_torch.ops import sample
    g = torch.Generator(device="cuda").manual_seed(k)
    for n in (1, 17, 4097, 100003):
        for pad in (0, 13):
            base = torch.randn((2, k, n + pad), generator=g, device="cuda")
            base[:, :, ::5] = 0.0
            grad, hess = base[0, :, :n], base[1, :, :n].abs()
            words = torch.randint(0, 2 ** 32, (4,), generator=g,
                                  device="cuda", dtype=torch.int64)
            before = sample.STEP_LAUNCHES["class_sum"]
            gh = sample.class_gh(grad, hess)
            assert sample.STEP_LAUNCHES["class_sum"] == before + 1
            assert torch.equal(_bits(gh), _bits(sample.class_gh(grad, hess)))
            assert torch.equal(_bits(gh),
                               _bits(sample.class_gh_plain(grad, hess)))
            got = sample.mvs_class_step(words, grad, hess, 1e-6, 0.5 * n)
            s = sample.mvs_scores(sample.class_gh_plain(grad, hess), 1e-6)
            mu = sample.mvs_threshold(s, 0.5 * n)
            want = (sample.mvs_weights_plain(words, s, mu), s, mu)
            for a, b in zip(got, want):
                assert torch.equal(_bits(a), _bits(b)), n


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
@pytest.mark.parametrize("boosting", list(BOOSTING))
def test_multiclass_boosting_graphs_match_eager_and_cpu_on_card(boosting,
                                                                objective):
    """GOSS, MVS, DART and random forests at K = 4 on the exact loop:
    graphed and eager the same model text and training score bit for bit
    and the same kernel launches (GOSS and MVS: kernel B's class sum once
    an iteration, the draw once an iteration); the CPU's trees split
    alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from lightgbm_tpu_torch.ops import graphs
    X, y = _data(2000, 8)
    runs = {}
    for label, dev, kw in (("graphs", "cuda", {}),
                           ("eager", "cuda", {"_eager": True}),
                           ("cpu", "cpu", {})):
        p = {"objective": objective, "num_class": K, "num_leaves": 15,
             "max_bin": 63, "verbose": -1, "device_type": dev,
             **BOOSTING[boosting]}
        b = ltt.Booster(params=p, train_set=ltt.Dataset(X, label=y,
                                                        params=p), **kw)
        before = [dict(c) for c in graphs.LAUNCH_COUNTERS]
        for _ in range(4):
            b.update()
        runs[label] = (b, [{k: c[k] - c0[k] for k in c}
                           for c, c0 in zip(graphs.LAUNCH_COUNTERS, before)])
    (g, lg), (e, le), (c, _) = (runs[k] for k in ("graphs", "eager", "cpu"))
    assert g._gbdt.runner.graphs is not None
    assert g.model_to_string() == e.model_to_string()
    assert np.array_equal(g._gbdt.train_score(), e._gbdt.train_score())
    assert lg == le
    counts = {k: v for d in lg for k, v in d.items() if v}
    if boosting in ("goss", "mvs"):
        assert counts["class_sum"] == 4
        assert counts[f"sample_{boosting}"] == 4
    assert g.num_trees() == c.num_trees() == 4 * K
    for a, b in zip(g.models, c.models):
        assert _splits(a) == _splits(b)
