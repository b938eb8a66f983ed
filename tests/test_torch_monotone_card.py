"""Kernel S's constrained mode on the card, and training under monotone
constraints and the feature penalty on the card.

Kernel S against its plain version on random directions in {-1, 0, 1},
multipliers in [0.5, 1.5] and finite per-lane bounds, at each fusion
site, with missing values and a depth limit: the record (gain,
feature, threshold, default direction, left mask) bit for bit, left
stats equal, one launch a call by kernel S's counter, a repeat launch the
same bits (``chip_smoke.py`` phase 2 counts the CUDA launches).  Then
the exact loop and the two-column quantized waves with the constraints:
graphed, eager and ``fused_iters=4`` give the same model text and
training score bit for bit and the same launches, kernel S runs in its
constrained mode, the constrained features' predictions
never step against their constraint on the exact loop, and the card's
first tree is the CPU's.  It needs a card and skips without one; it
imports nothing of JAX, so it runs on the card's machine with
``python3 -m pytest --noconftest -m cuda``.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as ltt
from lightgbm_tpu_torch.ops import split as ts

MONO = [1, 1, -1, 0, 0, 0]
PEN = [1, 1, 1, 0.5, 1, 1]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _inputs(dev, W, F, B, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    hist = torch.zeros(W, F, B, 3)
    hist[..., 0] = torch.randn(W, F, B, generator=g) * 4
    hist[..., 1] = torch.rand(W, F, B, generator=g) * 8 + 0.5
    hist[..., 2] = torch.randint(1, 40, (W, F, B), generator=g).float()
    parent = hist[:, 0].sum(dim=1)
    nb = torch.randint(B // 2, B + 1, (F,), generator=g).to(torch.int32)
    mt = (torch.arange(F) % 3 == 0).to(torch.int32) * 2
    mono = torch.randint(-1, 2, (F,), generator=g).to(torch.int32)
    pen = torch.rand(F, generator=g) + 0.5
    out = -parent[:, 0] / (parent[:, 1] + 1e-15)
    bounds = torch.stack([out - 0.05, out + 0.05], 1)
    return [t.to(dev).contiguous() for t in
            (hist, parent, nb, mt, mono, pen, bounds)]


@pytest.mark.cuda
@pytest.mark.parametrize("site", [ts.ROOT, ts.LOOP, ts.WAVE])
@pytest.mark.parametrize("W,F,B", [(2, 28, 256), (128, 28, 256),
                                   (5, 652, 25)])
def test_constrained_kernel_matches_plain(W, F, B, site):
    dev = _card()
    hist, parent, nb, mt, mono, pen, bounds = _inputs(dev, W, F, B, W + F)
    p = ts.SplitParams(max_bin=B, min_data_in_leaf=3,
                       min_sum_hessian_in_leaf=1.0, any_missing=True,
                       monotone=tuple(mono.tolist()),
                       penalty=tuple(pen.tolist()))
    fm = torch.ones(F, dtype=torch.bool, device=dev)
    fm[1] = False
    depth = torch.arange(W, dtype=torch.int32, device=dev) % 5
    for cons in ({"penalty": pen}, {"monotone": mono, "bounds": bounds},
                 {"monotone": mono, "penalty": pen, "bounds": bounds}):
        args = (hist, parent, nb, mt, fm, p, depth, 4)
        before = dict(ts.LAUNCHES)
        k = ts.find_best_split(*args, site=site, **cons)
        k2 = ts.find_best_split(*args, site=site, **cons)
        assert ts.LAUNCHES == {"best_split": before["best_split"],
                               "best_split_constrained":
                               before["best_split_constrained"] + 2}
        q = ts.find_best_split_plain(*args, site=site, **cons)
        torch.cuda.synchronize()
        for key in ("gain", "feature", "threshold", "default_left",
                    "left_mask", "left_stats"):
            assert torch.equal(k[key], q[key]), (key, sorted(cons))
            assert torch.equal(k[key], k2[key]), (key, sorted(cons))


def _data(n=3000):
    rng = np.random.RandomState(0)
    X = rng.randn(n, 6)
    X[rng.rand(n, 6) < 0.05] = np.nan
    z = np.nan_to_num(X)
    y = z[:, 0] + 0.5 * z[:, 1] - 0.3 * z[:, 2] + np.sin(3 * z[:, 3]) + \
        0.3 * rng.randn(n)
    return X, (y > np.median(y)).astype(float)


CONFIGS = {
    "exact": {},
    "waves": {"wave_splits": True, "use_quantized_grad": True,
              "hist_refinement": False, "min_data_in_leaf": 0,
              "min_sum_hessian_in_leaf": 1},
}


def _run(config, dev, X, y, rounds=4, eager=False, **kw):
    from lightgbm_tpu_torch.ops import graphs
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "verbose": -1, "device_type": dev, "metric": "None",
         "monotone_constraints": MONO, "feature_contri": PEN,
         **CONFIGS[config], **kw}
    b = ltt.Booster(params=p, train_set=ltt.Dataset(X, label=y, params=p),
                    _eager=eager)
    b._gbdt.config.num_iterations = rounds
    before = [dict(c) for c in graphs.LAUNCH_COUNTERS]
    for _ in range(rounds):
        b.update()
    launches = [{k: c[k] - c0[k] for k in c if c[k] != c0[k]}
                for c, c0 in zip(graphs.LAUNCH_COUNTERS, before)]
    return b, launches


@pytest.mark.cuda
@pytest.mark.parametrize("config", list(CONFIGS))
def test_constrained_training_on_card(config):
    _card()
    X, y = _data()
    g, lg = _run(config, "cuda", X, y)
    e, le = _run(config, "cuda", X, y, eager=True)
    f, lf = _run(config, "cuda", X, y, fused_iters=4)
    assert g._gbdt.runner.graphs is not None
    assert g._gbdt.grow_params.split.has_monotone
    assert g.model_to_string() == e.model_to_string() == f.model_to_string()
    assert np.array_equal(g._gbdt.train_score(), e._gbdt.train_score())
    assert np.array_equal(g._gbdt.train_score(), f._gbdt.train_score())
    assert lg == le == lf
    counts = {k: v for d in lg for k, v in d.items()}
    assert counts.get("best_split_constrained", 0) > 0
    assert counts.get("best_split", 0) == 0
    if config == "exact":
        grid = np.linspace(-3, 3, 40)
        for fcol, s in ((0, 1), (1, 1), (2, -1)):
            M = np.repeat(X[:64], 40, axis=0)
            M[:, fcol] = np.tile(grid, 64)
            step = np.diff(g.predict(M, raw_score=True).reshape(64, 40),
                           axis=1) * s
            assert (step >= -1e-10).all()
    c, _ = _run(config, "cpu", X, y, rounds=1)
    a, b = g.models[0], c.models[0]
    n = a.num_leaves - 1
    assert list(a.split_feature[:n]) == list(b.split_feature[:n])
    assert list(a.threshold_bin[:n]) == list(b.threshold_bin[:n])
