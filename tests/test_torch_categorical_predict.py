"""Prediction with categorical splits: the port's device decision
(``lightgbm_tpu_torch/ops/predict.py``, ``device_type=cpu``) against the
JAX package's host traversal (``predict(..., predict_engine=False)``,
``Tree._decide``; ``JAX_PLATFORMS=cpu``).

Tolerances, and why:

- the decision at a categorical node: equal to ``Tree._decide`` on
  every probe value (NaN, infinities, negative, non-integer, unseen,
  zero, codes inside and past the bitset's words);
- predictions of the same trees: within 1e-9 (float64 sums in both);
- a model saved as text and loaded again predicts the same bits, in the
  port and in the JAX package's loader;
- the validation set's scorer (kernel T's plain version, routing binned
  rows through the split records' bin masks; unseen categories sit in
  bin 0, which never goes left) and the training score against the
  trees' prediction on the raw rows: within 1e-5 (the scores add each
  tree's float32 shrunken leaf values, the prediction its float64 ones),
  when the rows hold integer codes (binning truncates 3.7 to category 3,
  the decision sends a non-integer value right: the JAX package's rule,
  kept).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as ltt  # noqa: E402
from lightgbm_tpu.models.tree import Tree as JTree  # noqa: E402
from lightgbm_tpu.models.tree import cat_bitset as jbitset  # noqa: E402
from lightgbm_tpu_torch.models.tree import Tree, cat_bitset  # noqa: E402
from lightgbm_tpu_torch.ops.predict import flatten_forest  # noqa: E402
from lightgbm_tpu_torch.ops.predict import predict_raw  # noqa: E402

PROBES = np.array([np.nan, np.inf, -np.inf, -1.0, -0.5, -0.0, 0.0, 0.25,
                   1.0, 2.0, 2.5, 3.0, 5.0, 7.0, 31.0, 32.0, 33.0, 63.0,
                   64.0, 65.0, 95.0, 96.0, 1e6, 1e20, 1e300])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trees(cats, missing_type=0):
    """One categorical split on feature 1 into ``cats`` in both packages'
    trees, with a numerical split below its left leaf."""
    out = []
    for cls, bitset in ((JTree, jbitset), (Tree, cat_bitset)):
        t = cls(3)
        t.split_categorical(0, 1, bitset(cats), 1.0, -2.0, 5.0, 6.0, 5, 6,
                            3.0, missing_type)
        t.split(0, 0, 4, 0.5, 0.25, 0.75, 2.0, 3.0, 2, 3, 1.0, 2, True)
        out.append(t)
    return out


@pytest.mark.parametrize("cats", [[0], [1, 3, 5], [2, 31, 32, 64],
                                  [0, 7, 95]])
@pytest.mark.parametrize("missing_type", [0, 2])
def test_categorical_decision_matches_jax(cats, missing_type):
    tj, tt = _trees(cats, missing_type)
    assert tt.cat_threshold == tj.cat_threshold
    assert tt.cat_boundaries == tj.cat_boundaries
    assert tt.to_json(0) == tj.to_json(0)
    X = np.column_stack([np.resize([0.1, 0.9, np.nan], len(PROBES)),
                         PROBES])
    want = tj.predict(X)
    ff = flatten_forest([tt], torch.device("cpu"))
    got = predict_raw(ff, X, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    # the root's decision alone, against ``Tree._decide``
    left = tj._decide(np.zeros(len(PROBES), np.int64), PROBES)
    np.testing.assert_array_equal(np.isin(got, [0.25, 0.75]), left)


def _cat_model(seed=3, n=4000, num_leaves=15):
    rng = np.random.RandomState(seed)
    X = np.column_stack([rng.randn(n), rng.randint(0, 20, n),
                         rng.randint(0, 70, n), rng.randint(0, 3, n),
                         rng.randn(n)]).astype(float)
    X[rng.rand(n) < 0.05, 1] = np.nan
    z = X[:, 0] + np.isin(X[:, 1], [1, 4, 9, 16]) - \
        0.8 * np.isin(X[:, 2], [33, 40, 64, 65]) + (X[:, 3] == 2)
    y = (z + 0.3 * rng.randn(n) > 0.6).astype(float)
    p = {"objective": "binary", "num_leaves": num_leaves, "max_bin": 127,
         "verbose": -1, "metric": "None", "categorical_feature": "1,2,3",
         "min_data_per_group": 20, "cat_smooth": 5.0}
    return X, y, p


def _probe_rows(X, seed=4):
    """The training rows' variants the two packages must route alike:
    unseen codes, negative, non-integer, NaN, infinite and huge values,
    codes past the bitset."""
    rng = np.random.RandomState(seed)
    R = X[:400].copy()
    for c in (1, 2, 3):
        R[:, c] = rng.choice(PROBES, 400)
    return np.vstack([X[:400], R])


def test_trained_categorical_model_predicts_as_jax():
    X, y, p = _cat_model()
    bj = lgb.train(p, lgb.Dataset(X, label=y, params=p), num_boost_round=4,
                   verbose_eval=False)
    pt = dict(p, device_type="cpu")
    bt = ltt.train(pt, ltt.Dataset(X, label=y, params=pt), num_boost_round=4)
    assert sum(t.num_cat for t in bt.models) > 0
    assert any(max(t.cat_list(k)) >= 32 for t in bt.models
               for k in range(t.num_cat))
    R = _probe_rows(X)
    # the JAX package's trees, predicted by the port
    tj = ltt.Booster(model_str=bj.model_to_string(),
                     params={"device_type": "cpu"})
    np.testing.assert_allclose(tj.predict(R, raw_score=True),
                               bj.predict(R, raw_score=True,
                                          predict_engine=False),
                               rtol=0, atol=1e-9)
    # the port's model, saved and loaded, in both packages
    text = bt.model_to_string()
    loaded = ltt.Booster(model_str=text, params={"device_type": "cpu"})
    np.testing.assert_array_equal(loaded.predict(R, raw_score=True),
                                  bt.predict(R, raw_score=True))
    jl = lgb.Booster(model_str=text)
    np.testing.assert_allclose(jl.predict(R, raw_score=True,
                                          predict_engine=False),
                               bt.predict(R, raw_score=True), rtol=0,
                               atol=1e-9)
    assert loaded.dump_model() == jl.dump_model()
    assert bt.dump_model()["tree_info"] == \
        [t.to_json(i) for i, t in enumerate(bt.models)]


def test_valid_scorer_equals_the_prediction():
    """The training score and a validation set's float64 score (the
    scorer routes binned rows by bin masks, kernel T's plain version)
    against the trees' prediction on raw rows with integer codes, unseen
    ones among them (bin 0)."""
    X, y, p = _cat_model(5, n=3000)
    pt = dict(p, device_type="cpu")
    train = ltt.Dataset(X[:2000], label=y[:2000], params=pt)
    V = X[2000:].copy()
    V[::7, 2] = 200.0          # unseen codes
    V[::11, 1] = -3.0          # negative: bin 0, and right at a node
    valid = train.create_valid(V, label=y[2000:])
    bt = ltt.train(pt, train, num_boost_round=5, valid_sets=[valid])
    assert sum(t.num_cat for t in bt.models) > 0
    vs = bt._gbdt.valid_sets[0]
    np.testing.assert_allclose(vs.score.numpy(),
                               bt.predict(V, raw_score=True), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(bt._gbdt.train_score(),
                               bt.predict(X[:2000], raw_score=True),
                               rtol=0, atol=1e-5)
