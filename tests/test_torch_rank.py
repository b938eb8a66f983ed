"""LambdaRank's gradients in the port (``device_type=cpu``: the plain
version of kernel U, ``lightgbm_tpu_torch/ops/rank.py``) against the JAX
package's (``JAX_PLATFORMS=cpu``), on the same float32 scores.

The contract, per document: within ``rtol=1e-5`` of the JAX package's
gradient and hessian, plus ``atol`` equal to 1e-6 times the largest |g|
(|h| for the hessian) of its query.  The port evaluates every pair's
terms in float64 and rounds each document's sums once to float32; the
JAX package evaluates them in float32 (its ``exp``, its discounts) and
sums them in XLA's order, so where a document's terms cancel, its sum
carries the float32 error of the query's largest terms.

Cases: skewed queries of 1 to 2,000 documents, all-equal scores (the
first iteration: the ranks are the rows' order), scores with ties,
``lambdamart_norm`` on and off, a custom ``label_gain``,
``max_position=3``, row weights, labels 0-4 and 0-30.

Kernel U's work split is modelled here as ``test_torch_sample_step.py``
and ``test_torch_route_packed.py`` model kernels B and T: a block a query, a thread a document in turn, each document's terms
summed in index order in float64 (a sequential ``cumsum``) and rounded
once; those bits equal the plain version's ``torch.sum``.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lightgbm_tpu.objectives as jobj  # noqa: E402
import lightgbm_tpu_torch.objectives as tobj  # noqa: E402
from lightgbm_tpu.config import Config as JConfig  # noqa: E402
from lightgbm_tpu.io.dataset import Metadata as JMeta  # noqa: E402
from lightgbm_tpu_torch import LightGBMError  # noqa: E402
from lightgbm_tpu_torch.config import Config as TConfig  # noqa: E402
from lightgbm_tpu_torch.io.dataset import Metadata as TMeta  # noqa: E402
from lightgbm_tpu_torch.ops import rank  # noqa: E402

RTOL = 1e-5
ATOL_OF_QUERY = 1e-6
SKEWED = np.array([1, 1, 2, 5, 17, 40, 90, 200, 600, 2000, 3, 1])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _labels(rng, n, top):
    if top == 4:
        # bench.py's MS-LTR relevances: most documents irrelevant
        rel = rng.randn(n)
        return np.clip(np.digitize(rel, np.percentile(rel, [60, 80, 92, 98])),
                       0, 4).astype(np.float32)
    return rng.randint(0, top + 1, n).astype(np.float32)


def _scores(rng, n, kind):
    if kind == "equal":
        return np.zeros(n, np.float32)
    if kind == "ties":
        return (rng.randint(0, 5, n) * 0.25).astype(np.float32)
    return rng.randn(n).astype(np.float32)


def _pair(counts, label, weight, params):
    n = int(np.sum(counts))
    jm, tm = JMeta(n), TMeta(n)
    for m in (jm, tm):
        m.set_label(label)
        m.set_weight(weight)
        m.set_query(counts)
    oj = jobj.create_objective("lambdarank", JConfig(params))
    oj.init(jm, n)
    ot = tobj.create_objective("lambdarank", TConfig(params))
    ot.init(tm, n, torch.device("cpu"))
    return oj, ot


def assert_within_contract(counts, a, b, what):
    """Port ``a`` against JAX ``b``, per query (module docstring)."""
    qb = np.concatenate([[0], np.cumsum(counts)])
    for q in range(len(counts)):
        sl = slice(qb[q], qb[q + 1])
        atol = ATOL_OF_QUERY * np.abs(b[sl]).max()
        np.testing.assert_allclose(a[sl], b[sl], rtol=RTOL, atol=atol,
                                   err_msg=f"{what}, query {q}")


CASES = {
    "equal scores": ({}, "equal", 4, False),
    "ties": ({}, "ties", 4, False),
    "random": ({}, "random", 4, False),
    "ties, no norm": ({"lambdamart_norm": False}, "ties", 4, False),
    "random, no norm": ({"lambdamart_norm": False}, "random", 4, False),
    "label_gain": ({"label_gain": [0, 1, 3, 5, 11]}, "random", 4, False),
    "max_position 3": ({"max_position": 3}, "random", 4, False),
    "weights": ({}, "ties", 4, True),
    "labels 0-30": ({}, "random", 30, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(case):
    params, kind, top, weighted = CASES[case]
    rng = np.random.RandomState(sorted(CASES).index(case))
    n = int(SKEWED.sum())
    label = _labels(rng, n, top)
    weight = (rng.rand(n) + 0.5).astype(np.float32) if weighted else None
    oj, ot = _pair(SKEWED, label, weight, dict(params,
                                               objective="lambdarank"))
    score = _scores(rng, n, kind)
    gj, hj = (np.asarray(v) for v in oj.get_gradients(jnp.asarray(score)))
    gt, ht = (v.numpy() for v in ot.get_gradients(torch.from_numpy(score)))
    assert gt.dtype == ht.dtype == np.float32
    assert_within_contract(SKEWED, gt, gj, "grad")
    assert_within_contract(SKEWED, ht, hj, "hess")
    # a query of one document has no pairs
    qb = np.concatenate([[0], np.cumsum(SKEWED)])
    for q in np.nonzero(SKEWED == 1)[0]:
        assert gt[qb[q]] == 0.0 and ht[qb[q]] == 0.0


def test_layout_matches_jax():
    """Gains a row and inverse ideal DCGs a query, float32, are the JAX
    package's (``max_position`` truncates the ideal DCG only)."""
    rng = np.random.RandomState(11)
    n = int(SKEWED.sum())
    label = _labels(rng, n, 4)
    for mp in (20, 3, 1):
        oj, ot = _pair(SKEWED, label, None, {"max_position": mp})
        np.testing.assert_array_equal(ot.layout.inv_max.numpy(),
                                      np.asarray(oj._inv_max_dcg))
        valid = np.asarray(oj._doc_valid)
        np.testing.assert_array_equal(
            ot.layout.gain.numpy()[np.asarray(oj._doc_idx)[valid]],
            np.asarray(oj._gain_mat)[valid])
    assert ot.layout.smem_docs == 2000 and ot.layout.scratch is None
    disc = ot.layout.disc.numpy()
    assert disc.dtype == np.float64 and len(disc) == 2000
    np.testing.assert_allclose(disc, 1 / np.log2(2 + np.arange(2000.0)),
                               rtol=1e-15)


def test_rank_tie_rule():
    """The rank is the position in a stable descending order: scores above
    a document, then equal ones before it (``argsort(argsort(-s,
    stable=True))``, the JAX package's); all-equal scores give the rows'
    order."""
    rng = np.random.RandomState(3)
    for s in (np.zeros(9), rng.randint(0, 3, 40) * 0.5, rng.randn(25)):
        s = s.astype(np.float32)
        want = np.argsort(np.argsort(-s, kind="stable"), kind="stable")
        st = torch.from_numpy(s.astype(np.float64))
        j = torch.arange(len(s))
        got = ((st[None, :] > st[:, None]) |
               ((st[None, :] == st[:, None]) & (j[None, :] < j[:, None]))
               ).sum(1).numpy()
        np.testing.assert_array_equal(got, want)


# kernel U's shared bytes a document (csrc/rank.cu: a float64 discount, a
# float32 score and gain, an int32 label), and the most a block may take
DOC_BYTES = 20
SMEM_OPTIN = 232448


def block_plan(counts, smem_docs):
    """Kernel U's launch: a block a query, whether the block stages its
    query in shared memory, and the launch's dynamic shared bytes."""
    counts = np.asarray(counts, np.int64)
    return {"blocks": len(counts), "shared": counts <= smem_docs,
            "smem_bytes": smem_docs * DOC_BYTES}


def _model_kernel(ot, score):
    """Kernel U's decomposition on the CPU: for each block (query) each
    document's terms summed in index order in float64, as the thread that
    owns it sums them, and rounded once (weights after)."""
    lay = ot.layout
    n = lay.num_data
    plan = block_plan(lay.counts, lay.smem_docs)
    assert plan["blocks"] == lay.num_queries
    assert plan["smem_bytes"] <= SMEM_OPTIN
    g_out = np.full(n, np.nan, np.float32)
    h_out = np.full(n, np.nan, np.float32)
    s64 = torch.from_numpy(score.astype(np.float64))
    qb = np.concatenate([[0], np.cumsum(lay.counts)])
    for q in range(lay.num_queries):
        lo, m = int(qb[q]), int(lay.counts[q])
        if m == 0:
            continue
        s = s64[lo:lo + m][None]
        lab = lay.label[lo:lo + m][None]
        gn = lay.gain[lo:lo + m].to(torch.float64)[None]
        j = torch.arange(m)
        rk = ((s[0][None, :] > s[0][:, None]) |
              ((s[0][None, :] == s[0][:, None]) & (j[None, :] < j[:, None]))
              ).sum(1)
        disc = lay.disc[rk][None]
        valid = torch.ones((1, m), dtype=torch.bool)
        inv = lay.inv_max[q:q + 1].to(torch.float64)
        scaled = torch.tensor([bool(s.max() != s.min())])
        gt, ht = rank.pair_terms(s, lab, gn, disc, valid, inv, scaled,
                                 slice(0, m), 2.0 * ot.sigmoid, ot.norm)
        # the thread's loop: g = g + term, j = 0 .. m - 1
        g = torch.cumsum(gt[0], dim=1)[:, -1].to(torch.float32)
        h = torch.cumsum(ht[0], dim=1)[:, -1].to(torch.float32)
        if ot.weight is not None:
            w = ot.weight[lo:lo + m]
            g, h = g * w, h * w
        g_out[lo:lo + m] = g.numpy()
        h_out[lo:lo + m] = h.numpy()
    return g_out, h_out


@pytest.mark.parametrize("case", ["ties", "random, no norm", "weights"])
def test_kernel_decomposition_matches_plain(case):
    params, kind, top, weighted = CASES[case]
    rng = np.random.RandomState(5)
    counts = np.array([1, 3, 260, 33, 700, 2, 257, 1])
    n = int(counts.sum())
    label = _labels(rng, n, top)
    weight = (rng.rand(n) + 0.5).astype(np.float32) if weighted else None
    _, ot = _pair(counts, label, weight, params)
    score = _scores(rng, n, kind)
    gk, hk = _model_kernel(ot, score)
    gp, hp = (v.numpy() for v in ot.get_gradients(torch.from_numpy(score)))
    np.testing.assert_array_equal(gk.view(np.int32), gp.view(np.int32))
    np.testing.assert_array_equal(hk.view(np.int32), hp.view(np.int32))


def test_block_plan_stages_or_walks():
    """A block stages its query in shared memory when it fits
    (``smem_docs``, the largest query that does); a larger query walks
    device memory and keeps its discounts in the float64 scratch row."""
    counts = np.array([5, rank.SMEM_DOCS, rank.SMEM_DOCS + 1, 1])
    lay = rank.rank_layout(np.concatenate([[0], np.cumsum(counts)]),
                           np.zeros(int(counts.sum())),
                           tobj.default_label_gain(), 20, "cpu")
    assert lay.smem_docs == rank.SMEM_DOCS
    assert lay.scratch is not None and lay.scratch.shape == (counts.sum(),)
    plan = block_plan(counts, lay.smem_docs)
    np.testing.assert_array_equal(plan["shared"], [True, True, False, True])
    assert plan["smem_bytes"] == rank.SMEM_DOCS * DOC_BYTES <= SMEM_OPTIN


def test_refusals_match_jax():
    """No groups, and a label past the gain table, are fatal in both;
    ``rank`` is ``lambdarank``; the names the JAX package does not
    register are unknown objectives in both."""
    n = 10
    with pytest.raises(Exception, match="query information"):
        jobj.create_objective("lambdarank", JConfig({})).init(
            _meta(JMeta, n, 3, None), n)
    with pytest.raises(LightGBMError, match="query information"):
        tobj.create_objective("lambdarank", TConfig({})).init(
            _meta(TMeta, n, 3, None), n, torch.device("cpu"))
    gains = {"label_gain": [0, 1, 3]}
    with pytest.raises(Exception, match="exceeds label_gain"):
        jobj.create_objective("lambdarank", JConfig(gains)).init(
            _meta(JMeta, n, 4, [n]), n)
    with pytest.raises(LightGBMError, match="exceeds label_gain"):
        tobj.create_objective("lambdarank", TConfig(gains)).init(
            _meta(TMeta, n, 4, [n]), n, torch.device("cpu"))
    assert tobj._REGISTRY["rank"] is tobj.LambdaRank
    assert jobj._REGISTRY["rank"].name == tobj._REGISTRY["rank"].name
    for name in ("rank_xendcg", "xendcg"):
        with pytest.raises(Exception, match="unknown objective"):
            jobj.create_objective(name, JConfig({}))
        with pytest.raises(LightGBMError, match="unknown objective"):
            tobj.create_objective(name, TConfig({}))


def _meta(cls, n, top, group):
    m = cls(n)
    m.set_label(np.arange(n) % top)
    m.set_query(group)
    return m


def test_query_count_mismatch_is_fatal():
    with pytest.raises(LightGBMError, match="sum of query counts"):
        TMeta(10).set_query([3, 3])
    m = TMeta(10)
    m.set_query([3, 7])
    np.testing.assert_array_equal(m.query_boundaries, [0, 3, 10])
    assert m.num_queries == 2
