"""Kernel U and LambdaRank training on the card.

Kernel U (``ops/rank.py`` ``lambda_gradients``) against its plain version on
the same CUDA tensors: skewed queries of 1 to 3,000 documents (those past a
band of 256 split across blocks, their partials in the layout's float64 scratch
in device memory), all-equal scores, ties, weights, ``lambdamart_norm`` off:
bit for bit, one launch a call, and a repeat launch bit for bit.  Training with
``objective=lambdarank`` on 3,000 rows x 8 features, 15 leaves, 4 iterations,
on the exact loop and quantized two-column waves: graphed and eager runs give
the same model text and training score bit for bit, kernel U runs once a tree,
and the CPU's trees split alike.  A binary booster switching between a numpy
log-loss ``fobj`` and its objective (two trees each way, then ``fobj`` again)
likewise: graphed, eager and the CPU.  It needs a card and skips without one;
it imports nothing of JAX, so it runs on the card's machine with ``python3 -m
pytest --noconftest -m cuda``.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as ltt
from lightgbm_tpu_torch.objectives import default_label_gain
from lightgbm_tpu_torch.ops import rank


def _queries(seed, counts, kind):
    rng = np.random.RandomState(seed)
    n = int(np.sum(counts))
    label = rng.randint(0, 5, n)
    score = {"equal": np.zeros(n), "ties": rng.randint(0, 4, n) * 0.5,
             "random": rng.randn(n)}[kind].astype(np.float32)
    return label, score


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["equal", "ties", "random", "weights",
                                  "no norm", "device memory"])
def test_kernel_u_matches_plain_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    counts = np.array([1, 2, 300, 3000, 17, 1, 256, 257])
    label, score = _queries(1, counts, "ties" if case in
                            ("weights", "device memory") else
                            "random" if case == "no norm" else case)
    qb = np.concatenate([[0], np.cumsum(counts)])
    lay = rank.rank_layout(qb, label, default_label_gain(), 20, dev)
    if case == "device memory":
        # the 300-, 3,000- and 257-document queries are split across
        # blocks, their partials in device memory
        split = lay.items[:, 1][lay.items[:, 0] == rank.PREP].unique()
        assert split.tolist() == [2, 3, 7] and lay.scratch is not None
    w = torch.from_numpy(np.random.RandomState(2).rand(len(label)).astype(
        np.float32) + 0.5).to(dev) if case == "weights" else None
    norm = case != "no norm"
    s = torch.from_numpy(score).to(dev)
    before = rank.LAUNCHES["lambdarank"]
    g, h = (t.clone() for t in rank.lambda_gradients(s, lay, w, 1.0, norm))
    assert rank.LAUNCHES["lambdarank"] == before + 1
    g2, h2 = rank.lambda_gradients(s, lay, w, 1.0, norm)
    gp, hp = rank.lambdarank_plain(s, lay, w, 1.0, norm)
    torch.cuda.synchronize()
    for a, b in ((g, g2), (h, h2), (g, gp), (h, hp)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["exact", "quantized waves"])
def test_lambdarank_graphs_match_eager_and_cpu_on_card(loop):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.RandomState(3)
    counts = rng.randint(5, 120, 50)
    n = int(counts.sum())
    X = rng.randn(n, 8)
    y = np.clip(np.digitize(X[:, 0] + 0.8 * rng.randn(n), [0.3, 0.9, 1.4,
                                                          2.0]), 0, 4)
    p = {"objective": "lambdarank", "num_leaves": 15, "max_bin": 63,
         "verbose": -1, "metric": "None"}
    if loop != "exact":
        p.update(wave_splits=True, use_quantized_grad=True,
                 min_data_in_leaf=0)
    out = {}
    for mode in ("graphs", "eager", "cpu"):
        pm = dict(p, device_type="cpu" if mode == "cpu" else "cuda")
        ds = ltt.Dataset(X, label=y, group=counts, params=pm)
        before = rank.LAUNCHES["lambdarank"]
        b = ltt.Booster(pm, ds, _eager=mode == "eager")
        for _ in range(4):
            b.update()
        if mode != "cpu":
            torch.cuda.synchronize()
            assert rank.LAUNCHES["lambdarank"] - before == 4
        out[mode] = (b.model_to_string(), b._gbdt.train_score())
    assert out["graphs"][0] == out["eager"][0]
    np.testing.assert_array_equal(out["graphs"][1], out["eager"][1])
    assert out["graphs"][0].split("split_feature=")[1:] and [
        t.split("\n")[0] for t in out["graphs"][0].split("split_feature=")] \
        == [t.split("\n")[0] for t in out["cpu"][0].split("split_feature=")]


def _logloss(score, dataset):
    y = dataset.get_label()
    p = 1.0 / (1.0 + np.exp(-score))
    return p - y, p * (1.0 - p)


@pytest.mark.cuda
@pytest.mark.parametrize("loop", ["exact", "quantized waves"])
def test_fobj_graphs_match_eager_and_cpu_on_card(loop):
    """Custom gradients on the graphs: a tree's head reads the static
    buffers the host's gradients were copied to; switching between the
    objective's gradients and ``fobj``'s captures the heads anew."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.RandomState(4)
    X = rng.randn(3000, 8)
    y = (X[:, 0] + 0.5 * rng.randn(3000) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
         "verbose": -1, "metric": "None"}
    if loop != "exact":
        p.update(wave_splits=True, use_quantized_grad=True,
                 min_data_in_leaf=0)
    schedule = (True, True, False, False, True, True)
    out = {}
    for mode in ("graphs", "eager", "cpu"):
        pm = dict(p, device_type="cpu" if mode == "cpu" else "cuda")
        b = ltt.Booster(pm, ltt.Dataset(X, label=y, params=pm),
                        _eager=mode == "eager")
        for custom in schedule:
            b.update(fobj=_logloss if custom else None)
        if mode == "graphs":
            assert b._gbdt.runner.graphs is not None
        out[mode] = (b.model_to_string(), b._gbdt.train_score())
    assert out["graphs"][0] == out["eager"][0]
    np.testing.assert_array_equal(out["graphs"][1], out["eager"][1])
    assert [t.split("\n")[0] for t in out["graphs"][0].split(
        "split_feature=")] == [t.split("\n")[0] for t in out["cpu"][0].split(
            "split_feature=")]
