"""The parity contract at the main paths' depth: 255 leaves.

The port (``device_type=cpu``) against the JAX package
(``JAX_PLATFORMS=cpu``, run as its own tests run it) on ``bench.py``'s
Higgs-shaped generator (``chip_smoke.make_higgs_shaped``, a copy of
``bench.py:58``), seed 0, 40,000 rows x 28 features, one tree, in three
configurations at ``num_leaves=255``, ``max_bin=255``:

1. ``exact255``: binary, ``min_sum_hessian_in_leaf=100`` (the serial loop);
2. ``wave255`` as it ships: the same with waves, quantized gradients,
   two-column passes and coarse-to-fine (``min_data_in_leaf=0``);
3. ``float_wave255``: waves on float gradients (coarse-to-fine at its
   default), ``min_data_in_leaf=2``, ``min_sum_hessian_in_leaf=1e-3``.

The contract.  Walk both packages' trees, split by split in the order the
splits were made (a split is its leaf, feature, threshold bin and default
direction), to the first split that differs.  Either no split differs,
or all of these hold there (the trees agree before it, so both split the
same leaves of the same rows):

(i) The port's choice is a maximum of a float64 oracle: numpy sums in
    float64 of the same gradients (under quantization the same integers
    and scale) over the leaf's rows, LightGBM's gain, constraints and
    candidate set (under coarse-to-fine: the coarse boundaries and the
    fine thresholds of the window around each feature's best coarse
    boundary).  Its net gain equals the oracle's best to float64 rounding
    (rel 1e-12); where the oracle's best is unique beyond that, the
    port's (feature, threshold, default_left) is the oracle's.
(ii) The reference's choice is explained by float32 accumulation: either
    the constraint it passes fails in float64 by a margin (hessian sum
    against ``min_sum_hessian_in_leaf``) within the float32 bound below,
    or its float64 net gain trails the port's by no more than the two
    candidates' gain bounds.  The float32 bound of a sum of |x| over a
    leaf: ``2^-24 * (2 * sum over the leaf and its ancestors a of n_a *
    sum_a|x| + (B + 2 u + 2) * sum_leaf|x|)``: each histogram on the way
    summed in row order (n_a rows) or by subtraction, the prefix over B
    bins, the u-ulp gradient difference of (iii), the right side as
    parent minus left.  A side's gain G^2/H moves by at most
    ``(|G| + eG)^2 / (H - eH) - G^2 / H`` (and the parent's where the two
    candidates split different leaves), plus 2^-21 of each gain for its
    float32 evaluation.  Quantized sums are exact integers on both sides;
    their one rounding is the scale's.
(iii) The gradients are accounted for: the port's binary gradients are
    computed in float64 and rounded once to float32, the reference's in
    float32 with XLA's ``exp``.  The rows whose float32 gradient or
    hessian differs, and the largest difference in ulps, are asserted;
    under quantization also the rows whose integers differ.

What the data shows (one tree, seed 0; the assertions pin it):
- ``exact255``: split 26 of 28 differs.  Both candidates send 963 of the
  leaf's 2,160 rows left with the same sums: at the first tree the
  gradients take two values and the hessians one, so different row sets
  with the same label counts tie exactly.  Each package breaks the tie by
  the float32 rounding of its own prefix sums.
- ``float_wave255``: split 152 of 254 differs; again an exact tie, the
  two candidates' float64 gains one ulp apart.  Both ties are asserted in
  rational arithmetic.
- ``wave255``: no split differs.  The hessians differ by one ulp in every
  row (the gradients in none), which moves the hess scale by one ulp and
  no integer.

Step (b) of the roadmap's parity item: float32 binary gradients computed
in PyTorch as the reference writes them do not reproduce the reference's
bits, since XLA's CPU ``exp`` is its own polynomial
(``test_float32_binary_gradients_keep_the_ulp``), so the port keeps the
float64 form and (iii) carries the ulp.
"""
import math
import os
import sys
from fractions import Fraction

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as ltt  # noqa: E402
from lightgbm_tpu.objectives import Binary  # noqa: E402
from lightgbm_tpu_torch.io.dataset import Metadata  # noqa: E402
from lightgbm_tpu_torch.objectives import create_objective  # noqa: E402
from lightgbm_tpu_torch.ops.grow import quantize_gradients  # noqa: E402
from lightgbm_tpu_torch.utils import prng  # noqa: E402

U = 2.0 ** -24
EPS = 1e-15                       # the split scan's hessian guard
GAIN_RTOL = 1e-12                 # float64 rounding of a net gain
N_ROWS, N_FEATURES = 40_000, 28

BASE = dict(chip_smoke.TRAIN_PARAMS, metric="None")
CONFIGS = {
    "exact255": BASE,
    "wave255": dict(BASE, **chip_smoke.WAVE255_PARAMS),
    "float_wave255": dict(BASE, wave_splits=True, min_data_in_leaf=2,
                          min_sum_hessian_in_leaf=1e-3),
}
# what the data shows at the first tree: (first differing split or None,
# rows whose gradient / hessian bits differ, their largest ulp difference,
# rows whose quantized gradient / hessian differ)
EXPECTED = {
    "exact255": (26, 0, N_ROWS, 1, None),
    "wave255": (None, 0, N_ROWS, 1, (0, 0)),
    "float_wave255": (152, 0, N_ROWS, 1, None),
}


def records(tree):
    """(leaf, feature, threshold bin, default left) of each split in the
    order made: split k turned leaf ``leaf`` into node k, which keeps the
    leaf's id on its left, so the leaf is node k's leftmost leaf."""
    out = []
    for k in range(tree.num_leaves - 1):
        j = k
        while tree.left_child[j] >= 0:
            j = tree.left_child[j]
        out.append((int(~tree.left_child[j]), int(tree.split_feature[k]),
                    int(tree.threshold_bin[k]),
                    bool(tree.decision_type[k] & 2)))
    return out


def first_difference(a, b):
    for k, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return k
    return None if len(a) == len(b) else min(len(a), len(b))


def replay(bins, recs, k):
    """The leaf of every row after the first ``k`` splits (no feature
    has a missing bin here, so a row goes left when its bin is at most
    the threshold), and the rows at each of those splits' nodes."""
    leaf = np.zeros(bins.shape[1], np.int64)
    at_node = []
    for j, (lf, f, t, _) in enumerate(recs[:k]):
        rows = leaf == lf
        at_node.append(rows)
        leaf[rows & (bins[f] > t)] = j + 1
    return leaf, at_node


def side_gain(g, h):
    """GetLeafSplitGainGivenOutput at the leaf output, in float64 (no L1,
    L2 or max_delta_step), with the scan's hessian guard."""
    hh = h + EPS
    out = -g / (hh + EPS)
    return -(2 * g * out + hh * out * out)


def oracle_candidates(bins, rows, vals, num_bins, sp, shift):
    """Per feature: float64 left/right sums, feasibility and net gain of
    every threshold of the leaf ``rows``; and the candidate mask (every
    threshold, or under coarse-to-fine the coarse boundaries and the
    window around the best coarse boundary)."""
    g, h, c = vals
    G, H, C = (math.fsum(x[rows]) for x in vals)
    shift_gain = side_gain(G, H) + sp.min_gain_to_split
    out = {}
    for f in range(bins.shape[0]):
        nb = int(num_bins[f])
        b = bins[f, rows].astype(np.int64)
        GL, HL, CL = (np.cumsum(np.bincount(b, x[rows], nb))[:nb - 1]
                      for x in vals)
        GR, HR, CR = G - GL, H - HL, C - CL
        if sp.counts_proxy:
            m = max(sp.min_sum_hessian_in_leaf, EPS)
            ok = (HL >= m) & (HR >= m)
        else:
            md = max(sp.min_data_in_leaf, 1)
            ok = (CL >= md) & (CR >= md) & \
                (HL >= sp.min_sum_hessian_in_leaf) & \
                (HR >= sp.min_sum_hessian_in_leaf)
        net = side_gain(GL, HL) + side_gain(GR, HR) - shift_gain
        cand = np.ones(nb - 1, bool)
        if shift:
            bcv = ((sp.max_bin - 1) >> shift) + 1
            thr_c = ((np.arange(bcv) + 1) << shift) - 1
            thr_c = thr_c[thr_c <= nb - 2]
            g_c = np.where(ok[thr_c], net[thr_c], -np.inf)
            lo = min(int(np.argmax(g_c)), max(bcv - 2, 0)) << shift
            cand[:] = False
            cand[thr_c] = True
            cand[lo:lo + (2 << shift)] = True
        out[f] = dict(GL=GL, HL=HL, GR=GR, HR=HR, ok=ok, net=net,
                      cand=cand & ok)
    return dict(G=G, H=H, feats=out)


def oracle_best(cands):
    """The oracle's best net gain and every (feature, threshold) that
    reaches it to float64 rounding."""
    best = max((d["net"][d["cand"]].max() for d in cands["feats"].values()
                if d["cand"].any()), default=-np.inf)
    tol = GAIN_RTOL * abs(best)
    ties = [(f, int(t)) for f, d in cands["feats"].items()
            for t in np.flatnonzero(d["cand"] & (d["net"] >= best - tol))]
    return best, ties


def sum_bounds(bins_rows, at_node, vals, nb, ulps, quantized):
    """Float32 bounds (eG, eH) of a sum over the leaf ``bins_rows`` (see
    the docstring); quantized sums only round once when dequantized."""
    out = []
    for x in vals[:2]:
        a_leaf = math.fsum(np.abs(x[bins_rows]))
        if quantized:
            out.append(U * a_leaf)
            continue
        chain = math.fsum(float(r.sum()) * math.fsum(np.abs(x[r]))
                          for r in at_node if np.all(r[bins_rows]))
        n_leaf = float(bins_rows.sum())
        out.append(U * (2 * (chain + n_leaf * a_leaf) +
                        (nb + 2 * ulps + 2) * a_leaf))
    return out


def gain_moves(G, H, eG, eH):
    """How far float32 sums within (eG, eH) can move G^2 / H."""
    g2h = G * G / H
    if H <= eH:
        return math.inf
    return max((abs(G) + eG) ** 2 / (H - eH) - g2h,
               g2h - max(abs(G) - eG, 0.0) ** 2 / (H + eH))


def candidate_bound(cands, f, t, eG, eH, with_parent):
    d = cands["feats"][f]
    b = gain_moves(d["GL"][t], d["HL"][t], eG, eH) + \
        gain_moves(d["GR"][t], d["HR"][t], eG, eH)
    b += 8 * U * (side_gain(d["GL"][t], d["HL"][t]) +
                  side_gain(d["GR"][t], d["HR"][t]))
    if with_parent:
        b += gain_moves(cands["G"], cands["H"], eG, eH) + \
            8 * U * side_gain(cands["G"], cands["H"])
    return b


def exact_gain(bins, rows, f, t, vals):
    """sum G^2 / H over both sides of a split, in rational arithmetic on
    the float values (exact sums: no rounding anywhere)."""
    g, h = (np.asarray(x) for x in vals[:2])
    out = Fraction(0)
    for side in (rows & (bins[f] <= t), rows & (bins[f] > t)):
        G = sum(Fraction(v) * int(c) for v, c in
                zip(*np.unique(g[side], return_counts=True)))
        H = sum(Fraction(v) * int(c) for v, c in
                zip(*np.unique(h[side], return_counts=True)))
        out += G * G / H
    return out


def ulp_diff(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) -
                  b.view(np.int32).astype(np.int64))


@pytest.fixture(scope="module")
def higgs():
    X, y = chip_smoke.make_higgs_shaped(N_ROWS, N_FEATURES, seed=0)
    return X, y


@pytest.mark.parametrize("name", list(CONFIGS))
def test_parity_contract_at_255_leaves(name, higgs):
    X, y = higgs
    p = CONFIGS[name]
    bj = lgb.train(p, lgb.Dataset(X, label=y, params=p), num_boost_round=1,
                   verbose_eval=False)
    pt = dict(p, device_type="cpu")
    ds = ltt.Dataset(X, label=y, params=pt)
    bt = ltt.train(pt, ds, num_boost_round=1)
    gb = bt._gbdt
    gp, sp = gb.grow_params, gb.grow_params.split
    assert gp.num_leaves == 255 and gp.wave == ("wave" in name)
    assert gp.refine_shift == (4 if "wave" in name else 0)
    assert bool(gp.quantize) == (name == "wave255")
    bins = ds._constructed.binned.numpy()
    num_bins = gb._num_bins.numpy()
    assert not gb._missing_type.numpy().any()      # no missing bin: replay

    # (iii) the first tree's gradients, at the score the boosting starts
    init = gb.objective.boost_from_score()
    assert init == bj._gbdt.objective.boost_from_score()
    score = np.full(N_ROWS, init, np.float32)
    gt, ht = (x.numpy() for x in gb.objective.get_gradients(
        torch.from_numpy(score)))
    gj, hj = (np.asarray(x) for x in bj._gbdt.objective.get_gradients(
        jnp.asarray(score)))
    ug, uh = ulp_diff(gt, gj), ulp_diff(ht, hj)
    k_want, g_rows, h_rows, max_ulp, q_rows = EXPECTED[name]
    assert (int((ug > 0).sum()), int((uh > 0).sum())) == (g_rows, h_rows)
    ulps = int(max(ug.max(), uh.max()))
    assert ulps == max_ulp
    ones = np.ones(N_ROWS)
    vals_port = (gt.astype(np.float64), ht.astype(np.float64), ones)
    vals_ref = (gj.astype(np.float64), hj.astype(np.float64), ones)
    if gp.quantize:
        key = prng.fold_in(gb._quant_key, 0)
        mask = torch.ones(N_ROWS)
        qt, qj = (quantize_gradients(torch.from_numpy(g.copy()),
                                     torch.from_numpy(h.copy()), mask,
                                     gp.quantize, gp.two_col, key)
                  for g, h in ((gt, ht), (gj, hj)))
        assert (int((qt[0] != qj[0]).sum()),
                int((qt[1] != qj[1]).sum())) == q_rows
        vals_port, vals_ref = (
            (q[0].double().numpy() * float(q[2][0]),
             q[1].double().numpy() * float(q[2][1]),
             q[1].double().numpy() * float(q[2][2]) if gp.two_col else ones)
            for q in (qt, qj))

    ref, got = records(bj._gbdt.models[0]), records(bt.models[0])
    k = first_difference(ref, got)
    assert k == k_want
    if k is None:
        assert bt.models[0].num_leaves == bj._gbdt.models[0].num_leaves
        np.testing.assert_array_equal(bt.models[0].leaf_count,
                                      bj._gbdt.models[0].leaf_count)
        return

    leaf, at_node = replay(bins, got, k)
    # (i) the port's choice is a maximum of the float64 oracle
    lp, fp, tp, dlp = got[k]
    rows_p = leaf == lp
    cand_p = oracle_candidates(bins, rows_p, vals_port, num_bins, sp,
                               gp.refine_shift)
    best, ties = oracle_best(cand_p)
    assert cand_p["feats"][fp]["cand"][tp]
    assert cand_p["feats"][fp]["net"][tp] >= best - GAIN_RTOL * abs(best)
    assert (fp, tp) in ties
    assert not dlp                          # no missing bin: default right
    # (ii) the reference's choice, within float32 accumulation
    lr, fr, tr, dlr = ref[k]
    assert not dlr
    rows_r = leaf == lr
    cand_r = cand_p if lr == lp and not gp.quantize else oracle_candidates(
        bins, rows_r, vals_ref if gp.quantize else vals_port, num_bins, sp,
        gp.refine_shift)
    d = cand_r["feats"][fr]
    eg_r, eh_r = sum_bounds(rows_r, at_node, vals_port, sp.max_bin, ulps,
                            bool(gp.quantize))
    margin = min(d["HL"][tr], d["HR"][tr]) - sp.min_sum_hessian_in_leaf
    if not d["ok"][tr]:
        assert -margin <= eh_r, (margin, eh_r)
        return
    eg_p, eh_p = sum_bounds(rows_p, at_node, vals_port, sp.max_bin, ulps,
                            bool(gp.quantize))
    gap = cand_p["feats"][fp]["net"][tp] - d["net"][tr]
    bound = candidate_bound(cand_p, fp, tp, eg_p, eh_p, lr != lp) + \
        candidate_bound(cand_r, fr, tr, eg_r, eh_r, lr != lp)
    assert gap <= bound, (gap, bound)
    # what the data shows: an exact tie, broken by float32 rounding
    assert exact_gain(bins, rows_p, fp, tp, vals_port) == \
        exact_gain(bins, rows_r, fr, tr, vals_port)


def test_float32_binary_gradients_keep_the_ulp():
    """Step (b): binary gradients in float32, as the reference computes
    them (``lightgbm_tpu/objectives.py:469-473``), against the
    reference's jitted bits on scores across [-8, 8] and both labels.
    XLA's CPU ``exp`` is not PyTorch's, so the float32 form differs from
    the reference in some rows too; the port keeps its float64 form,
    whose gradients are within 2 ulps of the reference's."""
    n = 200_001
    score = np.linspace(-8.0, 8.0, n).astype(np.float32)
    sign = np.where(np.arange(n) % 2 == 0, 1.0, -1.0).astype(np.float32)
    ref = jax.jit(lambda s, sl: Binary._grads_impl(
        s, sl, jnp.ones_like(s), None, sigmoid=1.0, weighted=False))
    gj, hj = (np.asarray(x) for x in ref(jnp.asarray(score),
                                         jnp.asarray(sign)))
    t = torch.from_numpy(sign)
    r32 = -t / (1.0 + torch.exp(t * torch.from_numpy(score)))
    assert int((ulp_diff(r32.numpy(), gj) > 0).sum()) > 0
    meta = Metadata(n)
    meta.set_label(sign > 0)
    obj = create_objective("binary", ltt.Config())
    obj.init(meta, n, torch.device("cpu"))
    gt = obj.get_gradients(torch.from_numpy(score))[0].numpy()
    assert int(ulp_diff(gt, gj).max()) <= 2
