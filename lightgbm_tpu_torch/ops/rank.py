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

The terms are float64 and each document's sums are rounded once to
float32, on the card (kernel U, ``csrc/rank.cu``, through
:func:`lambda_gradients`: one launch a call, a block a query, each
thread summing its documents' pairs in index order) and on the CPU
(:func:`lambdarank_plain`: the same terms summed with ``torch.sum``).
Both read the discounts from one float64 table (:func:`disc_table`), so
the two differ only where a float64 sum lands within an ulp of a float32
rounding boundary.  They hold the JAX package's float32 chains within
``rtol=1e-5`` and ``atol = 1e-6 * max |g|`` of the query
(``tests/test_torch_rank.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import kernels

__all__ = ["RankLayout", "rank_layout", "disc_table", "inverse_max_dcg",
           "lambda_gradients", "lambdarank_plain", "pair_terms",
           "LAUNCHES", "SMEM_DOCS"]

# the most documents of a query a block of kernel U stages in shared memory:
# 225 KB of the 227 KB a block may take, at csrc/rank.cu's 20 bytes a
# document; a larger query walks device memory
SMEM_DOCS = 11520

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


@dataclass
class RankLayout:
    """The static inputs of a ranking dataset, on its device: query
    boundaries ``qb`` (Q + 1,) int64, each row's label (int32) and gain
    (float32), each query's ``inv_max`` (float32), the discount table
    (float64), the shared-memory documents a block of kernel U stages
    (``smem_docs``: the largest query that fits), the float64 scratch row
    of the queries that do not fit (None when every query fits), the
    host's query counts, and the plain version's query groups, which
    :func:`lambdarank_plain` builds at its first call."""
    qb: torch.Tensor
    label: torch.Tensor
    gain: torch.Tensor
    inv_max: torch.Tensor
    disc: torch.Tensor
    smem_docs: int
    scratch: Optional[torch.Tensor]
    counts: np.ndarray
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
    fits = counts[counts <= SMEM_DOCS]
    smem_docs = int(fits.max()) if len(fits) else 0
    scratch = torch.empty(len(lab), dtype=torch.float64, device=device) \
        if max_docs > SMEM_DOCS else None
    dev = torch.device(device)
    return RankLayout(
        qb=torch.from_numpy(qb).to(dev),
        label=torch.from_numpy(lab.astype(np.int32)).to(dev),
        gain=torch.from_numpy(gains.astype(np.float32)).to(dev),
        inv_max=torch.from_numpy(inv.astype(np.float32)).to(dev),
        disc=torch.from_numpy(disc_table(max_docs)).to(dev),
        smem_docs=smem_docs, scratch=scratch, counts=counts)


def pair_terms(s: torch.Tensor, lab: torch.Tensor, gn: torch.Tensor,
               disc: torch.Tensor, valid: torch.Tensor, inv: torch.Tensor,
               scaled: torch.Tensor, rows: slice, coef: float, norm: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The float64 (G, R, M) terms that rows ``rows`` of a run of G padded
    queries (scores ``s``, labels, gains, discounts (G, M) float64 or
    int, ``valid`` (G, M)) add to their g and h, each pair's operations
    in kernel U's order; 0 where the labels are equal or a row is
    padding."""
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
    x = (coef * ds).clamp(-60.0, 60.0)
    den = 1.0 + torch.exp(x)
    p = torch.div(torch.full_like(den, 2.0), den)
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
        neg = torch.tensor(float("-inf"), dtype=torch.float64, device=dev)
        smax = torch.where(valid, s, neg).amax(1)
        smin = torch.where(valid, s, -neg).amin(1)
        scaled = smax != smin
        g = torch.empty((G, M), dtype=torch.float64, device=dev)
        h = torch.empty((G, M), dtype=torch.float64, device=dev)
        for rows in chunks:
            gt, ht = pair_terms(s, lab, gn, disc, valid, inv, scaled, rows,
                                coef, norm)
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
    if int(layout.counts.max()) > layout.smem_docs and layout.scratch is None:
        raise ValueError("a query larger than shared memory needs scratch")
    tensors = (layout.qb, layout.label, layout.gain, layout.inv_max,
               layout.disc, grad, hess) + \
        tuple(t for t in (weight, layout.scratch) if t is not None)
    if any(t.device != score.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    lib = kernels.load()
    stream = torch.cuda.current_stream(score.device).cuda_stream
    rc = lib.ltt_lambdarank(
        score.data_ptr(), layout.qb.data_ptr(), layout.num_queries,
        layout.label.data_ptr(), layout.gain.data_ptr(),
        layout.inv_max.data_ptr(), layout.disc.data_ptr(),
        None if weight is None else weight.data_ptr(), 2.0 * float(sigmoid),
        int(bool(norm)), layout.smem_docs,
        None if layout.scratch is None else layout.scratch.data_ptr(),
        grad.data_ptr(), hess.data_ptr(), stream)
    kernels.check(rc, "kernel U (ltt_lambdarank)")
    LAUNCHES["lambdarank"] += 1
    return grad, hess
