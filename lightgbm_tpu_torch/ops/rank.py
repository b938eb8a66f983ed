"""LambdaRank's gradients over query groups: kernel U and its plain version.

Counterpart of ``lightgbm_tpu/objectives.py`` ``LambdaRank._grads_impl``
(:714-776), which the JAX package computes in XLA over queries padded to
(num_queries, max_docs).  Here queries stay contiguous row ranges
(``qb``, the boundaries).  For each query and document i:

- ``g_i = sum_{j: l_i > l_j} lam(i, j) - sum_{j: l_j > l_i} lam(j, i)``;
- ``h_i = sum_{j: l_i > l_j} eta(i, j) + sum_{j: l_j > l_i} eta(j, i)``;

where for a pair (hi, lo) with ``l_hi > l_lo``: ``ds = s_hi - s_lo``,
``delta = (gain_hi - gain_lo) |disc_hi - disc_lo| inv_max_q`` (divided by
``0.01 + |ds|`` under ``lambdamart_norm`` when the query's scores are not
all equal), ``p = 2 / (1 + exp(clip(2 sigmoid ds, -60, 60)))``,
``lam = -delta p``, ``eta = 2 delta p (2 - p)``; ``disc = 1 / log2(2 +
rank)`` with ``rank`` the position in a stable descending order of the
query's scores (``#{j: s_j > s_i} + #{j < i: s_j == s_i}``).  Rows are
then multiplied by their weights.

The terms are float64 (:func:`pair_terms`, one operation order for the kernel
and the plain version) and each document's sums are rounded once to float32.
``p`` is factored: with ``e = exp(2 sigmoid (s - centre))`` once a document
(``centre`` the middle of the query's score range), ``p = 2 e_lo / (e_lo +
e_hi)`` where ``|2 sigmoid ds| < 60``, and p's clipped values at +-60 where it
is not; a query whose ``2 sigmoid (max s - min s)`` exceeds
:data:`FACTOR_RANGE` takes the direct form (:func:`exponentials` decides, for
the kernel and the plain version alike).  So no pair evaluates an ``exp``.  The
plain version (:func:`lambdarank_plain`, the CPU's) sums a document's terms
with ``torch.sum``; kernel U (``csrc/rank.cu``, through
:func:`lambda_gradients`) sums them in the order below, which
:func:`replay_sums` replays.  The two differ only where a float64 sum lands
within a float64 rounding of a float32 rounding boundary: by one float32 ulp.
Both hold the JAX package's float32 chains within ``rtol=1e-5`` and ``atol =
1e-6 * max |g|`` of the query (``tests/test_torch_rank.py``).

Kernel U's decomposition and order (the one statement of it):

1. **Label sort** (static, :func:`rank_layout`).  Each query's rows in a
   stable ascending order of their labels (``perm``), placed at the end
   of ``P = nb * BAND_DOCS`` positions, ``nb = ceil(m / BAND_DOCS)``: the
   first ``P - m`` positions are padding.  Positions fall into tiles of
   ``TILE_DOCS`` (a warp's lanes) and tiles into bands of ``BAND_TILES``
   (a block's warps).  A pair of positions ``x > y`` with different
   labels has ``l_x > l_y``: x is its hi, y its lo.
2. **Tile pairs.**  A tile pair (a, b), tile a at or after tile b, is
   skipped when either tile holds no document or every document of both
   has one label (``min label of b == max label of a``).  Only pairs
   inside a skipped tile pair are equal-labelled, so no needed pair is
   lost.
3. **Items.**  A query of at most ``BAND_DOCS`` documents is one block
   (``WHOLE``: ranks, the band pair (0, 0), its sums rounded).  A larger
   query is split: ``PREP`` items rank a band's documents; a ``PAIR``
   item takes a band pair (R, C), ``R >= C``, that holds a tile pair not
   skipped; ``FIN`` items sum a band's partials.  ``PAIR`` items wait for
   every ``PREP`` item and ``FIN`` items for every ``PAIR`` item, by
   counters in device memory; blocks take their items in ticket order,
   so every item waited on has started (one launch, no deadlock).
4. **A band pair (R, C)** (a block of 8 warps) lists its tile pairs (a,
   b) not skipped, a row tile a of band R and a column tile b of band C
   (``b <= a`` when R == C), a ascending, then b; warp w takes entries
   w, w + 8, w + 16, ...  In a tile pair lane r holds the row document
   at position ``32 a + r`` and takes 32 steps k = 0..31, meeting column
   ``c = (r + k) mod 32``; the pair counts when both documents exist,
   their labels differ and, for a = b in one band, ``r > c``.  The row
   document (hi) adds ``-t`` and ``eta`` to its tile-pair sums, the
   column document (lo) ``t`` and ``eta`` to its own (lane r holds column
   ``(r + k) mod 32``'s at step k: a column's terms come from rows ``(c
   - k) mod 32``, k = 0..31).  Each tile-pair sum starts at 0.0 and runs
   in step order.  Then the row's sums and the column's (in that order)
   are added to the warp's own float64 sums of those positions.
5. **Totals.**  A position's band-pair value is its 8 warps' sums added
   from 0.0 in warp order (band C's positions separately from band R's
   when R > C).  A ``WHOLE`` query's document takes its band pair's
   value; a split query's document of band X the sum from 0.0, in order,
   over the band pairs that exist of (X, 0), ..., (X, X), (X + 1, X),
   ..., (nb - 1, X).  The total is rounded once to float32, then
   multiplied by the row's weight.

No float atomics: every sum has one writer (a warp's sum of position p
has lane ``p mod 32`` of that warp) and the order above, so a repeat
launch gives the same bits.  Each unordered pair with different
labels is evaluated once (``tests/test_torch_rank.py`` counts it).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import kernels

__all__ = ["RankLayout", "rank_layout", "disc_table", "inverse_max_dcg",
           "lambda_gradients", "lambdarank_plain", "pair_terms",
           "replay_sums", "tile_skips", "tile_pairs", "tile_steps",
           "sync_words",
           "exponentials",
           "LAUNCHES", "FACTOR_RANGE",
           "TILE_DOCS", "BAND_TILES", "BAND_DOCS", "WHOLE", "PREP", "PAIR",
           "FIN"]

# a tile: a warp's lanes; a band: a block's warps, each with a row tile.
# BAND_DOCS is the largest query one block takes whole (csrc/rank.cu's
# kBand, which the launch checks); a larger query is split across blocks
TILE_DOCS = 32
BAND_TILES = 8
BAND_DOCS = TILE_DOCS * BAND_TILES
# kinds of kernel U's items (module docstring, step 3)
WHOLE, PREP, PAIR, FIN = 0, 1, 2, 3
# the widest coef (max s - min s) of a query whose per-document
# exponentials exp(coef (s - centre)) stay normal float64 numbers
# (|coef (s - centre)| <= 600 < 708): wider queries take p directly
# (csrc/rank.cu's kFactorRange)
FACTOR_RANGE = 1200.0
# float64 words of a PAIR item's partials: row and column sums, g and h
_SLOT_WORDS = {True: 2 * BAND_DOCS, False: 4 * BAND_DOCS}
# kernel U's sync words a stream: ticket, PREP done, PAIR done, blocks done
SYNC_WORDS = 4

# launches of kernel U through :func:`lambda_gradients`, one a call
LAUNCHES = {"lambdarank": 0}

# elements of a (queries, rows, docs) block of the plain version
_PLAIN_ELEMS = 1 << 22


def disc_table(max_docs: int) -> np.ndarray:
    """``1 / log2(2 + rank)`` for ranks 0 .. max_docs - 1, float64."""
    return 1.0 / np.log2(2.0 + np.arange(max(int(max_docs), 1),
                                         dtype=np.float64))


def inverse_max_dcg(qb: np.ndarray, gains: np.ndarray,
                    max_position: int) -> np.ndarray:
    """Each query's inverse ideal DCG, truncated at ``max_position``, in
    float64, 0 where the ideal DCG is 0 (``lightgbm_tpu/objectives.py``
    ``LambdaRank.init``: only the ideal DCG is truncated, not the pairs)."""
    nq = len(qb) - 1
    out = np.zeros(nq)
    for q in range(nq):
        g = np.sort(gains[qb[q]:qb[q + 1]])[::-1][:max_position]
        dcg = np.sum(g / np.log2(np.arange(len(g)) + 2.0))
        out[q] = 1.0 / dcg if dcg > 0 else 0.0
    return out


def _bands(m: int) -> int:
    return max(1, -(-int(m) // BAND_DOCS))


def tile_skips(lab_sorted: np.ndarray, nb: int) -> np.ndarray:
    """(T, T) bool, ``T = nb * BAND_TILES``: tile pair (a, b) skipped
    (module docstring, step 2), for a query whose labels in sorted order
    are ``lab_sorted``, placed at the end of its ``nb`` bands."""
    lab = np.full(nb * BAND_DOCS, -1, np.int64)
    lab[len(lab) - len(lab_sorted):] = lab_sorted
    tiles = lab.reshape(-1, TILE_DOCS)
    valid = tiles >= 0
    empty = ~valid.any(1)
    lo = np.where(valid, tiles, np.iinfo(np.int64).max).min(1)
    hi = np.where(valid, tiles, -1).max(1)
    return empty[:, None] | empty[None, :] | (lo[None, :] == hi[:, None])


@dataclass
class RankLayout:
    """The static inputs of a ranking dataset, on its device: query
    boundaries ``qb`` (Q + 1,) int64, each row's label (int32) and gain
    (float32), each query's ``inv_max`` (float32), the discount table
    (float64), the host's query counts; kernel U's plan (module
    docstring): ``perm`` (N,) int32, the rows of each query in label
    order; ``items`` (I, 4) int32 (kind, query, R, C) in ticket order;
    ``qtab`` (Q, 3) int64, a split query's discount offset in
    ``scratch``, its band-pair table's offset in ``band_item`` and its
    band count; ``soff`` (I,) int64, a ``PAIR`` item's partials in
    ``scratch``; ``band_item`` int32, a split query's (nb, nb) item ids
    (-1: no item); the counts of ``PREP`` and ``PAIR`` items; ``accw``,
    the positions of a warp's sums (two bands when a ``PAIR`` item takes
    two); the float64 ``scratch`` (None when no query is split); and the
    plain version's
    query groups, which :func:`lambdarank_plain` builds at its first
    call."""
    qb: torch.Tensor
    label: torch.Tensor
    gain: torch.Tensor
    inv_max: torch.Tensor
    disc: torch.Tensor
    counts: np.ndarray
    perm: torch.Tensor
    items: torch.Tensor
    qtab: torch.Tensor
    soff: torch.Tensor
    band_item: torch.Tensor
    n_prep: int
    n_pair: int
    accw: int
    scratch: Optional[torch.Tensor]
    groups: Optional[List[Tuple[int, torch.Tensor]]] = None

    @property
    def num_queries(self) -> int:
        return len(self.counts)

    @property
    def num_data(self) -> int:
        return int(self.counts.sum())


def _plain_groups(qb: np.ndarray, device) -> List[Tuple[int, torch.Tensor]]:
    """Queries in runs of equal padded width for the plain version: sorted
    by size, a run padded to its largest query and cut so that a run's
    (queries, docs, docs) block stays near ``_PLAIN_ELEMS``; each run is
    (width, (G, width) row indices with ``num_data`` as padding)."""
    counts = np.diff(qb)
    n = int(qb[-1])
    order = np.argsort(counts, kind="stable")
    groups, i = [], 0
    while i < len(order):
        j = i + 1
        width = max(int(counts[order[i]]), 1)
        while j < len(order):
            w = max(int(counts[order[j]]), 1)
            if (j - i + 1) * w * w > _PLAIN_ELEMS:
                break
            width = w
            j += 1
        qs = order[i:j]
        idx = np.full((len(qs), width), n, np.int64)
        for r, q in enumerate(qs):
            idx[r, :counts[q]] = np.arange(qb[q], qb[q + 1])
        groups.append((width, torch.from_numpy(idx).to(device)))
        i = j
    return groups


def _plan(qb: np.ndarray, lab: np.ndarray):
    """Kernel U's static plan (module docstring, steps 1-3) -> (perm,
    items, qtab, soff, band_item, n_prep, n_pair, scratch words)."""
    counts = np.diff(qb)
    n, nq = int(qb[-1]), len(counts)
    qid = np.repeat(np.arange(nq), counts)
    perm = np.lexsort((np.arange(n), lab, qid)).astype(np.int32)
    qtab = np.zeros((nq, 3), np.int64)
    prep, pair, whole, fin = [], [], [], []
    band_item, words = [], 0
    pair_bands = []
    for q in np.nonzero(counts > BAND_DOCS)[0]:
        nb = _bands(counts[q])
        skip = tile_skips(lab[perm[qb[q]:qb[q + 1]]], nb)
        # tile pairs at or below the diagonal, by band pair
        need = (~skip & np.tril(np.ones_like(skip))).reshape(
            nb, BAND_TILES, nb, BAND_TILES).any(axis=(1, 3))
        qtab[q] = (words, len(band_item), nb)
        words += nb * BAND_DOCS + 2 * nb
        band_item.extend([-1] * nb * nb)
        prep += [(PREP, q, x, x) for x in range(nb)]
        fin += [(FIN, q, x, x) for x in range(nb)]
        for r in range(nb):
            for c in range(r + 1):
                if need[r, c]:
                    pair.append((PAIR, q, r, c))
                    pair_bands.append(qtab[q, 1] + r * nb + c)
    whole = [(WHOLE, q, 0, 0) for q in np.nonzero((counts > 0) &
                                                    (counts <= BAND_DOCS))[0]]
    items = prep + pair + whole + fin
    soff = np.full(len(items), -1, np.int64)
    band_item = np.asarray(band_item, np.int32)
    for i, (_, _, r, c) in enumerate(pair):
        it = len(prep) + i
        soff[it] = words
        words += _SLOT_WORDS[r == c]
        band_item[pair_bands[i]] = it
    items = np.asarray(items, np.int32).reshape(-1, 4)
    return perm, items, qtab, soff, band_item, len(prep), len(pair), words


def _acc_width(items: np.ndarray) -> int:
    """Positions of a warp's sums in kernel U: two bands when a ``PAIR``
    item takes two, else one."""
    pair = items[items[:, 0] == PAIR]
    return 2 * BAND_DOCS if (pair[:, 2] != pair[:, 3]).any() else BAND_DOCS


def rank_layout(qb: np.ndarray, label: np.ndarray, label_gain: np.ndarray,
                max_position: int, device) -> RankLayout:
    """The :class:`RankLayout` of a dataset with query boundaries ``qb``
    and integer labels ``label`` under the gain table ``label_gain``."""
    qb = np.asarray(qb, np.int64)
    counts = np.diff(qb)
    lab = np.asarray(label).astype(np.int64)
    gains = np.asarray(label_gain, np.float64)[lab]
    inv = inverse_max_dcg(qb, gains, max_position)
    max_docs = int(counts.max()) if len(counts) else 1
    perm, items, qtab, soff, band_item, n_prep, n_pair, words = _plan(qb,
                                                                      lab)
    dev = torch.device(device)
    return RankLayout(
        qb=torch.from_numpy(qb).to(dev),
        label=torch.from_numpy(lab.astype(np.int32)).to(dev),
        gain=torch.from_numpy(gains.astype(np.float32)).to(dev),
        inv_max=torch.from_numpy(inv.astype(np.float32)).to(dev),
        disc=torch.from_numpy(disc_table(max_docs)).to(dev),
        counts=counts, perm=torch.from_numpy(perm).to(dev),
        items=torch.from_numpy(items).to(dev),
        qtab=torch.from_numpy(qtab).to(dev),
        soff=torch.from_numpy(soff).to(dev),
        band_item=torch.from_numpy(band_item).to(dev),
        n_prep=n_prep, n_pair=n_pair, accw=_acc_width(items),
        scratch=torch.empty(words, dtype=torch.float64, device=dev)
        if words else None)


def exponentials(s: torch.Tensor, valid: torch.Tensor, coef: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(scaled (G,): the scores are not all equal; factored (G,): the
    query's ``coef (max s - min s)`` is at most :data:`FACTOR_RANGE`; e
    (G, M): ``exp(coef (s - centre))`` about the range's centre, 1 at
    padding and where the query is not factored) of G padded queries'
    float64 scores (G, M), as kernel U computes them."""
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=s.device)
    smax = torch.where(valid, s, -inf).amax(1)
    smin = torch.where(valid, s, inf).amin(1)
    factored = coef * (smax - smin) <= FACTOR_RANGE
    centre = (smax + smin) * 0.5
    on = valid & factored[:, None]
    e = torch.exp(coef * (torch.where(on, s, centre[:, None]) -
                          centre[:, None]))
    return smax != smin, factored, e


def pair_terms(s: torch.Tensor, lab: torch.Tensor, gn: torch.Tensor,
               disc: torch.Tensor, valid: torch.Tensor, inv: torch.Tensor,
               scaled: torch.Tensor, rows: slice, coef: float, norm: bool,
               factored: torch.Tensor, e: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float64 (G, R, M) terms that rows ``rows`` of a run of G padded
    queries (scores ``s``, labels, gains, discounts (G, M) float64 or
    int, ``valid`` (G, M); ``scaled``, ``factored`` and ``e`` from
    :func:`exponentials`) add to their g and h, each pair's operations
    in kernel U's order; 0 where the labels are equal or a row is
    padding.  ``p = 2 / (1 + exp(clip(coef ds, -60, 60)))`` is taken as
    ``2 e_lo / (e_lo + e_hi)`` where the query is factored and ``|coef
    ds| < 60``, as its values at +-60 where ``|coef ds| >= 60``."""
    si, sj = s[:, rows, None], s[:, None, :]
    li, lj = lab[:, rows, None], lab[:, None, :]
    up = li > lj
    diff = (up | (lj > li)) & valid[:, rows, None] & valid[:, None, :]
    ds = torch.where(up, si - sj, sj - si)
    gi, gj = gn[:, rows, None], gn[:, None, :]
    dg = torch.where(up, gi - gj, gj - gi)
    delta = dg * (disc[:, rows, None] - disc[:, None, :]).abs() * \
        inv[:, None, None]
    if norm:
        delta = torch.where(scaled[:, None, None],
                            delta / (0.01 + ds.abs()), delta)
    x = coef * ds
    den = 1.0 + torch.exp(x.clamp(-60.0, 60.0))
    p = torch.div(torch.full_like(den, 2.0), den)
    ei, ej = e[:, rows, None], e[:, None, :]
    e_lo, e_hi = torch.where(up, ej, ei), torch.where(up, ei, ej)
    edge = torch.tensor([60.0, -60.0], dtype=torch.float64, device=s.device)
    p_hi, p_lo = torch.div(torch.full_like(edge, 2.0), 1.0 + edge.exp())
    fact = torch.where(x.abs() < 60.0, (2.0 * e_lo) / (e_lo + e_hi),
                       torch.where(x > 0.0, p_hi, p_lo))
    p = torch.where(factored[:, None, None], fact, p)
    t = delta * p
    eta = 2.0 * delta * p * (2.0 - p)
    zero = torch.zeros((), dtype=torch.float64, device=s.device)
    return (torch.where(diff, torch.where(up, -t, t), zero),
            torch.where(diff, eta, zero))


def _row_chunks(G: int, M: int):
    step = max(1, _PLAIN_ELEMS // max(G * M, 1))
    return [slice(r, min(r + step, M)) for r in range(0, M, step)]


def lambdarank_plain(score: torch.Tensor, layout: RankLayout,
                     weight: Optional[torch.Tensor], sigmoid: float,
                     norm: bool, out=None) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(grad, hess) (N,) float32 of the score (N,) float32: the plain
    PyTorch version of kernel U, over the layout's runs of padded
    queries, into ``out`` (two (N,) float32 tensors) if given."""
    n = score.shape[0]
    dev = score.device
    grad, hess = out if out is not None else (
        torch.empty(n, dtype=torch.float32, device=dev),
        torch.empty(n, dtype=torch.float32, device=dev))
    coef = 2.0 * float(sigmoid)
    s_pad = torch.cat([score.reshape(-1).to(torch.float64),
                       torch.zeros(1, dtype=torch.float64, device=dev)])
    l_pad = torch.cat([layout.label, torch.full((1,), -1, dtype=torch.int32,
                                                device=dev)])
    g_pad = torch.cat([layout.gain.to(torch.float64),
                       torch.zeros(1, dtype=torch.float64, device=dev)])
    qid = torch.repeat_interleave(
        torch.arange(layout.num_queries, device=dev),
        torch.from_numpy(layout.counts).to(dev))
    inv_rows = torch.cat([layout.inv_max.to(torch.float64)[qid],
                          torch.zeros(1, dtype=torch.float64, device=dev)])
    if layout.groups is None:
        layout.groups = _plain_groups(
            np.concatenate([[0], np.cumsum(layout.counts)]), dev)
    for M, idx in layout.groups:
        G = idx.shape[0]
        valid = idx < n
        s, lab, gn = s_pad[idx], l_pad[idx], g_pad[idx]
        inv = inv_rows[idx[:, 0]]
        chunks = _row_chunks(G, M)
        # each document's rank: scores above it, and equal ones before it
        jpos = torch.arange(M, device=dev)
        rank = torch.empty((G, M), dtype=torch.int64, device=dev)
        for rows in chunks:
            si, sj = s[:, rows, None], s[:, None, :]
            before = jpos[None, :] < jpos[rows, None]
            rank[:, rows] = (((sj > si) | ((sj == si) & before)) &
                             valid[:, None, :]).sum(-1)
        disc = layout.disc[rank.clamp(max=layout.disc.shape[0] - 1)]
        scaled, factored, e = exponentials(s, valid, coef)
        g = torch.empty((G, M), dtype=torch.float64, device=dev)
        h = torch.empty((G, M), dtype=torch.float64, device=dev)
        for rows in chunks:
            gt, ht = pair_terms(s, lab, gn, disc, valid, inv, scaled, rows,
                                coef, norm, factored, e)
            # + 0.0: a sum of zeros is +0, as the kernel's
            g[:, rows] = gt.sum(-1) + 0.0
            h[:, rows] = ht.sum(-1) + 0.0
        rows_out = idx[valid]
        gf, hf = g[valid].to(torch.float32), h[valid].to(torch.float32)
        if weight is not None:
            w = weight[rows_out]
            gf, hf = gf * w, hf * w
        grad[rows_out] = gf
        hess[rows_out] = hf
    return grad, hess


def tile_pairs(same: bool, skip: np.ndarray) -> List[Tuple[int, int]]:
    """A band pair's tile pairs not skipped, in list order (module
    docstring, step 4); ``skip`` (8, 8): its tile pairs skipped."""
    return [(a, b) for a in range(BAND_TILES)
            for b in range(a + 1 if same else BAND_TILES) if not skip[a, b]]


def tile_steps(same: bool, a: int, b: int) -> Tuple[np.ndarray, np.ndarray]:
    """A tile pair's steps: (row, col), each (32, 32) int64 over (lane,
    step): the column lane the row of a lane meets, and the row lane the
    column of a lane meets, -1 where the pair does not count by position
    (a = b in one band)."""
    lane = np.arange(TILE_DOCS)[:, None]
    step = np.arange(TILE_DOCS)[None, :]
    c = (lane + step) % TILE_DOCS
    r = (lane - step) % TILE_DOCS
    if same and a == b:
        return np.where(c < lane, c, -1), np.where(r > lane, r, -1)
    return c, r


def _fold(terms: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """Each row of ``idx`` (positions into the last axis of ``terms``, -1
    for none) summed in float64 from 0.0 in its order, sequentially."""
    t = torch.cat([terms, torch.zeros((terms.shape[0], 1),
                                      dtype=torch.float64)], 1)
    ix = torch.from_numpy(np.where(idx < 0, terms.shape[1], idx))
    seq = torch.cat([torch.zeros((terms.shape[0], 1), dtype=torch.float64),
                     torch.gather(t, 1, ix)], 1)
    # torch.cumsum on the CPU adds in index order
    return torch.cumsum(seq, 1)[:, -1]


def _query_sorted(score: torch.Tensor, layout: RankLayout, q: int):
    """A query's documents in kernel U's positions (module docstring, step
    1): (rows (P,) int64, -1 for padding; score, gain, disc (P,) float64;
    label (P,) int64, -1 for padding; nb)."""
    qb = layout.qb.cpu().numpy()
    lo, m = int(qb[q]), int(qb[q + 1] - qb[q])
    nb = _bands(m)
    P = nb * BAND_DOCS
    s = score[lo:lo + m].cpu().to(torch.float64)
    j = torch.arange(m)
    rank = ((s[None, :] > s[:, None]) |
            ((s[None, :] == s[:, None]) & (j[None, :] < j[:, None]))).sum(1)
    disc = layout.disc.cpu()[rank]
    order = layout.perm[lo:lo + m].cpu().to(torch.int64) - lo
    rows = torch.full((P,), -1, dtype=torch.int64)
    rows[P - m:] = order + lo
    out = []
    for v, fill in ((s, 0.0), (layout.gain[lo:lo + m].cpu().to(
            torch.float64), 0.0), (disc, 0.0)):
        w = torch.full((P,), fill, dtype=torch.float64)
        w[P - m:] = v[order]
        out.append(w)
    lab = torch.full((P,), -1, dtype=torch.int64)
    lab[P - m:] = layout.label[lo:lo + m].cpu().to(torch.int64)[order]
    return rows, out[0], out[1], out[2], lab, nb


def _band_pair(qd: dict, R: int, C: int, coef: float, norm: bool):
    """(g, h) of band R's positions, then of band C's (the same when R ==
    C), each (BAND_DOCS,) float64: the band pair (R, C)'s values in kernel
    U's order; ``qd``: the query in sorted positions (``replay_sums``)."""
    B, L = BAND_DOCS, TILE_DOCS
    same = R == C
    idx = np.arange(R * B, R * B + B)
    if not same:
        idx = np.concatenate([idx, np.arange(C * B, C * B + B)])
    sub = torch.from_numpy(idx)
    s, g, d, lb, e = (qd[k][sub][None] for k in ("s", "g", "d", "l", "e"))
    valid = lb >= 0
    inv_t = torch.tensor([qd["inv"]], dtype=torch.float64)
    off = 0 if same else B
    # terms from the row documents' side (band R against all) and from
    # the column documents' (band C against all); 0 where a pair has
    # equal labels or padding
    rt, ct = ([t[0] for t in pair_terms(
        s, lb, g, d, valid, inv_t, qd["scaled"], rows, coef, norm,
        qd["factored"], e)] for rows in (slice(0, B), slice(off, off + B)))
    acc = [torch.zeros((BAND_TILES, off + B), dtype=torch.float64)
           for _ in range(2)]
    lane = np.arange(L)
    pairs = tile_pairs(same, qd["skip"][R * BAND_TILES:(R + 1) * BAND_TILES,
                                        C * BAND_TILES:(C + 1) * BAND_TILES])
    for i, (a, b) in enumerate(pairs):
        w = i % BAND_TILES
        row_c, col_r = tile_steps(same, a, b)
        for x in range(2):
            # the row's 32 terms against columns off + 32 b + c, the
            # column's against rows 32 a + r; -1 steps add nothing
            rsum = _fold(rt[x][a * L + lane], np.where(
                row_c < 0, -1, off + b * L + row_c))
            csum = _fold(ct[x][b * L + lane], np.where(
                col_r < 0, -1, a * L + col_r))
            acc[x][w, a * L + lane] += rsum
            acc[x][w, off + b * L + lane] += csum
    # the warps' sums, in warp order from 0.0
    tot = [_fold(a_.T.contiguous(), np.tile(np.arange(BAND_TILES),
                                            (a_.shape[1], 1)))
           for a_ in acc]
    return tot[0][:B], tot[1][:B], tot[0][off:off + B], tot[1][off:off + B]


def replay_sums(score: torch.Tensor, layout: RankLayout, sigmoid: float,
                norm: bool, queries=None, band: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel U's float64 (g, h) sums, unrounded and unweighted, replayed
    on the CPU in the module docstring's order: (N,) float64, NaN outside
    ``queries`` (default all) and, when ``band`` is given, outside that
    band of each query.  ``float32(g) * weight`` is the kernel's output."""
    n = layout.num_data
    g_out = torch.full((n,), float("nan"), dtype=torch.float64)
    h_out = torch.full((n,), float("nan"), dtype=torch.float64)
    coef = 2.0 * float(sigmoid)
    counts = layout.counts
    for q in (range(len(counts)) if queries is None else queries):
        m = int(counts[q])
        if m == 0:
            continue
        rows, sd, gd, dd, lab, nb = _query_sorted(score, layout, q)
        scaled, factored, e = exponentials(sd[None], (lab >= 0)[None], coef)
        qd = {"s": sd, "g": gd, "d": dd, "l": lab, "e": e[0],
              "scaled": scaled, "factored": factored,
              "inv": float(layout.inv_max[q]),
              "skip": tile_skips(lab[lab >= 0].numpy(), nb)}
        skip = qd["skip"]
        B = BAND_DOCS
        bands = range(nb) if band is None else [band]
        if nb == 1:
            g, h, _, _ = _band_pair(qd, 0, 0, coef, norm)
        else:
            g = torch.full((nb * B,), float("nan"), dtype=torch.float64)
            h = g.clone()
            need = (~skip & np.tril(np.ones_like(skip))).reshape(
                nb, BAND_TILES, nb, BAND_TILES).any(axis=(1, 3))
            for x in bands:
                tg = torch.zeros(B, dtype=torch.float64)
                th = torch.zeros(B, dtype=torch.float64)
                pairs = [(x, c) for c in range(x + 1)] + \
                    [(r, x) for r in range(x + 1, nb)]
                for r, c in pairs:
                    if not need[r, c]:
                        continue
                    rg, rh, cg, ch = _band_pair(qd, r, c, coef, norm)
                    pg, ph = (rg, rh) if r == x else (cg, ch)
                    tg, th = tg + pg, th + ph
                g[x * B:(x + 1) * B] = tg
                h[x * B:(x + 1) * B] = th
        ok = (rows >= 0) & ~torch.isnan(g)
        g_out[rows[ok]] = g[ok]
        h_out[rows[ok]] = h[ok]
    return g_out, h_out


def sync_words(device, stream: int) -> torch.Tensor:
    """Kernel U's sync words for launches on ``stream`` of ``device`` (the
    ticket, the ``PREP`` and ``PAIR`` counters, the blocks done; left zero
    by each launch that splits a query; ``kernels.sync_words``)."""
    return kernels.sync_words("kernel U", SYNC_WORDS, device, stream)


def lambda_gradients(score: torch.Tensor, layout: RankLayout,
                     weight: Optional[torch.Tensor], sigmoid: float,
                     norm: bool, out=None) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """LambdaRank's (grad, hess) (N,) float32 at ``score`` (N,) float32,
    into ``out`` if given.  A CUDA score goes to kernel U (one launch),
    a CPU score to :func:`lambdarank_plain`.  Reads nothing back to the
    host, so a CUDA graph can hold it; the layout's tensors are static."""
    if score.device.type == "cpu":
        return lambdarank_plain(score, layout, weight, sigmoid, norm, out)
    n = layout.num_data
    score = score.reshape(-1)
    if score.dtype != torch.float32 or score.shape != (n,) or \
            not score.is_contiguous():
        raise ValueError(f"score must be contiguous float32 ({n},)")
    if weight is not None and (weight.dtype != torch.float32 or
                               weight.shape != (n,) or
                               not weight.is_contiguous()):
        raise ValueError(f"weight must be contiguous float32 ({n},)")
    grad, hess = out if out is not None else (
        torch.empty(n, dtype=torch.float32, device=score.device),
        torch.empty(n, dtype=torch.float32, device=score.device))
    for t in (grad, hess):
        if t.dtype != torch.float32 or t.shape != (n,) or \
                not t.is_contiguous():
            raise ValueError(f"out must be two contiguous float32 ({n},)")
    if layout.n_prep and layout.scratch is None:
        raise ValueError("a split query needs the layout's scratch")
    tensors = (layout.qb, layout.label, layout.gain, layout.inv_max,
               layout.disc, layout.perm, layout.items, layout.qtab,
               layout.soff, layout.band_item, grad, hess) + \
        tuple(t for t in (weight, layout.scratch) if t is not None)
    if any(t.device != score.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    lib = kernels.load()
    stream = torch.cuda.current_stream(score.device).cuda_stream
    sync = sync_words(score.device, stream)
    rc = lib.ltt_lambdarank(
        score.data_ptr(), layout.label.data_ptr(), layout.gain.data_ptr(),
        layout.perm.data_ptr(), layout.qb.data_ptr(),
        layout.items.data_ptr(), layout.items.shape[0],
        layout.qtab.data_ptr(), layout.soff.data_ptr(),
        layout.band_item.data_ptr(), layout.inv_max.data_ptr(),
        layout.disc.data_ptr(),
        None if weight is None else weight.data_ptr(), 2.0 * float(sigmoid),
        int(bool(norm)), layout.n_prep, layout.n_pair, BAND_DOCS,
        layout.accw,
        None if layout.scratch is None else layout.scratch.data_ptr(),
        sync.data_ptr(), grad.data_ptr(), hess.data_ptr(), stream)
    kernels.check(rc, "kernel U (ltt_lambdarank)")
    LAUNCHES["lambdarank"] += 1
    return grad, hess
