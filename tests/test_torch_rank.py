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
first iteration: the ranks are the rows' order), scores with ties, wide
scores (a document far out, so a score range past ``FACTOR_RANGE``: ``p``
not factored; on a 1/64 grid, where the JAX package's float32 ``s_i -
s_j`` is exact: off it, its rounding moves ``p`` by about ``2 coef
ulp(ds)`` relative, 1.5e-5 at ds = 100, whichever form ``p`` takes here),
``lambdamart_norm`` on and off, a custom ``label_gain``,
``max_position=3``, row weights, labels 0-4 and 0-30.  Steep scores
(``|2 sigmoid ds|`` past 60 in many pairs) are held to the plain
version's bits by the decomposition test, not to the JAX package: there
a document's terms come from its nearest ranks, and the JAX package's
float32 discount differences ``|disc_i - disc_j|`` of near ranks lose
about 1e-4 relative (3.5e-4 measured, with ``p`` factored or direct).

Kernel U's work split is modelled here as ``test_torch_sample_step.py``
and ``test_torch_route_packed.py`` model kernels B and T: its plan
(``rank.rank_layout``: the label sort, the items of whole and split
queries) and its order (``rank.replay_sums``, the order
``ops/rank.py``'s docstring states: label-sorted tiles, rounds of each
band pair, a split query's band partials; each sum rounded once).  The
model's bits equal the plain version's ``torch.sum`` on every case here.
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
    # steep and wide scores lie on a 1/64 grid, where the JAX package's
    # float32 differences s_i - s_j are exact (module docstring)
    if kind == "steep":
        # |2 sigmoid ds| past 60 for many pairs, the queries factored
        return (rng.randint(-3840, 3841, n) / 64.0).astype(np.float32)
    if kind == "wide":
        # one document a query far out: score ranges past FACTOR_RANGE,
        # where p is taken directly; the rest near 0
        s = rng.randint(-128, 129, n) / 64.0
        s[rng.rand(n) < 0.05] = 1000.0
        return s.astype(np.float32)
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
    "wide scores": ({}, "wide", 4, False),
    "wide scores, weights": ({}, "wide", 4, True),
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
    # the 600- and 2,000-document queries are split across blocks
    assert ot.layout.n_prep == 3 + 8 and ot.layout.scratch is not None
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


def _model_kernel(ot, score):
    """Kernel U's decomposition on the CPU (``ops/rank.py``'s docstring,
    replayed by ``rank.replay_sums``): the label sort, the skipped tile
    pairs, the rounds of each band pair, a split query's band partials in
    their fixed order; each sum rounded once, weights after."""
    lay = ot.layout
    g, h = rank.replay_sums(torch.from_numpy(score), lay, ot.sigmoid,
                            ot.norm)
    assert not bool(torch.isnan(g).any() or torch.isnan(h).any())
    g, h = g.to(torch.float32), h.to(torch.float32)
    if ot.weight is not None:
        g, h = g * ot.weight, h * ot.weight
    return g.numpy(), h.numpy()


DECOMPOSITION = {
    "ties": (np.array([1, 3, 260, 33, 700, 2, 257, 1]), None),
    "random, no norm": (np.array([1, 3, 260, 33, 700, 2, 257, 1]), None),
    "weights": (np.array([1, 3, 260, 33, 700, 2, 257, 1]), None),
    "random": (np.array([31, 32, 33, 65, 256, 257, 1, 0, 513]), None),
    "equal scores": (np.array([31, 32, 33, 65, 256, 257]), None),
    "labels 0-30": (np.array([65, 300, 33, 1]), None),
    "label_gain": (np.array([40, 257, 7]), None),
    "single label": (np.array([33, 300, 5]), 2),
    "steep scores": (np.array([31, 300, 65]), None),
    "wide scores": (np.array([31, 300, 65, 2]), None),
}


@pytest.mark.parametrize("case", list(DECOMPOSITION))
def test_kernel_decomposition_matches_plain(case):
    """The model of kernel U's order gives the plain version's bits: on the
    skewed cases, at tile edges (31, 32, 33, 65 documents), on a query one
    band holds whole (256) and just above it (257, split in two bands),
    on a single-label query and on labels 0-30 under a custom gain."""
    params, kind, top, weighted = CASES[case if case in CASES else "random"]
    if case == "labels 0-30":
        params = {"label_gain": list(np.arange(31) * 1.5)}
    counts, one_label = DECOMPOSITION[case]
    rng = np.random.RandomState(5)
    n = int(counts.sum())
    label = _labels(rng, n, top) if one_label is None else \
        np.full(n, one_label, np.float32)
    if case == "labels 0-30":
        label = rng.randint(0, 31, n).astype(np.float32)
    weight = (rng.rand(n) + 0.5).astype(np.float32) if weighted else None
    _, ot = _pair(counts, label, weight, params)
    score = _scores(rng, n, kind)
    gk, hk = _model_kernel(ot, score)
    gp, hp = (v.numpy() for v in ot.get_gradients(torch.from_numpy(score)))
    np.testing.assert_array_equal(gk.view(np.int32), gp.view(np.int32))
    np.testing.assert_array_equal(hk.view(np.int32), hp.view(np.int32))
    if one_label is not None:
        assert not gk.any() and not hk.any()


def pair_schedule(layout, q):
    """(m, m) int64: how often kernel U's schedule (``ops/rank.py``'s
    docstring, steps 2-4) adds a term of the pair (i, j) of query q's
    documents (in row order) to document i."""
    qb = layout.qb.cpu().numpy()
    lo, m = int(qb[q]), int(qb[q + 1] - qb[q])
    nb = -(-m // rank.BAND_DOCS)
    B, L, P = rank.BAND_DOCS, rank.TILE_DOCS, nb * rank.BAND_DOCS
    order = layout.perm[lo:lo + m].cpu().numpy().astype(np.int64) - lo
    doc = np.full(P, -1, np.int64)
    doc[P - m:] = order
    lab_doc = layout.label[lo:lo + m].cpu().numpy()
    skip = rank.tile_skips(lab_doc[order], nb)
    out = np.zeros((m, m), np.int64)
    lane = np.repeat(np.arange(L), L)
    for r in range(nb):
        for c in range(r + 1):
            sk = skip[r * rank.BAND_TILES:(r + 1) * rank.BAND_TILES,
                      c * rank.BAND_TILES:(c + 1) * rank.BAND_TILES]
            for a, b in rank.tile_pairs(r == c, sk):
                row_c, col_r = (x.reshape(-1) for x in
                                rank.tile_steps(r == c, a, b))
                rows, cols = r * B + a * L, c * B + b * L
                for mine, step, other in ((rows, row_c, cols),
                                          (cols, col_r, rows)):
                    keep = step >= 0
                    i = doc[mine + lane[keep]]
                    j = doc[other + step[keep]]
                    # a pair counts where both exist and the labels differ
                    ok = (i >= 0) & (j >= 0)
                    i, j = i[ok], j[ok]
                    ok = lab_doc[i] != lab_doc[j]
                    np.add.at(out, (i[ok], j[ok]), 1)
    return out


PLAN_COUNTS = np.array([5, rank.BAND_DOCS, rank.BAND_DOCS + 1, 1, 0, 700,
                        32, 33])


@pytest.mark.parametrize("q", range(len(PLAN_COUNTS)))
def test_block_plan_stages_or_walks(q):
    """Kernel U's plan: each query's rows in a stable label order; a query
    of at most ``BAND_DOCS`` documents one ``WHOLE`` block, a larger one
    split into ``PREP``, ``PAIR`` and ``FIN`` items in ticket order (every
    ``PREP`` before every ``PAIR``, whole queries, then ``FIN``), with its
    band-pair table and float64 partials in the scratch; the schedule
    meets every unordered pair with different labels exactly once from
    each end and no pair of equal labels."""
    counts = PLAN_COUNTS
    rng = np.random.RandomState(17)
    n = int(counts.sum())
    label = rng.randint(0, 3, n)
    qb = np.concatenate([[0], np.cumsum(counts)])
    lay = rank.rank_layout(qb, label, tobj.default_label_gain(), 20, "cpu")
    perm = lay.perm.numpy()
    lo, m = int(qb[q]), int(counts[q])
    rows = perm[lo:lo + m]
    # the label sort: the query's own rows, labels ascending, stable
    assert sorted(rows) == list(range(lo, lo + m))
    np.testing.assert_array_equal(
        rows, lo + np.argsort(label[lo:lo + m], kind="stable"))
    items = lay.items.numpy()
    kinds = items[:, 0]
    # ticket order: PREP, PAIR, WHOLE, FIN
    assert list(kinds) == sorted(kinds, key=[rank.PREP, rank.PAIR,
                                             rank.WHOLE, rank.FIN].index)
    assert lay.n_prep == int((kinds == rank.PREP).sum())
    assert lay.n_pair == int((kinds == rank.PAIR).sum())
    mine = items[items[:, 1] == q]
    if m == 0:
        assert len(mine) == 0
        return
    if m <= rank.BAND_DOCS:
        assert mine.tolist() == [[rank.WHOLE, q, 0, 0]]
    else:
        nb = -(-m // rank.BAND_DOCS)
        d_off, t_off, nbq = lay.qtab[q].tolist()
        assert nbq == nb
        assert sorted(mine[mine[:, 0] == rank.PREP, 2]) == list(range(nb))
        assert sorted(mine[mine[:, 0] == rank.FIN, 2]) == list(range(nb))
        tab = lay.band_item.numpy()[t_off:t_off + nb * nb].reshape(nb, nb)
        soff = lay.soff.numpy()
        for i in np.nonzero((items[:, 0] == rank.PAIR) &
                            (items[:, 1] == q))[0]:
            r, c = items[i, 2], items[i, 3]
            assert r >= c and tab[r, c] == i
            # partials after the query's discounts and score ranges
            assert soff[i] >= d_off + nb * rank.BAND_DOCS + 2 * nb
            assert soff[i] + (2 if r == c else 4) * rank.BAND_DOCS <= \
                lay.scratch.shape[0]
        assert (tab[np.triu_indices(nb, 1)] == -1).all()
    if m > 1:
        # every unordered pair with different labels once from each end
        lab = label[lo:lo + m]
        np.testing.assert_array_equal(
            pair_schedule(lay, q),
            (lab[:, None] != lab[None, :]).astype(np.int64))


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
