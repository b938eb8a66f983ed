"""Row sampling on the device: bagging, GOSS and MVS weights.

Counterpart of the JAX package's sampling masks, which it draws in XLA
(no Pallas kernel): bernoulli and stratified bagging
(``_draw_bag_mask_impl``, ``lightgbm_tpu/models/gbdt.py:1110-1125``),
GOSS (``GOSS._goss_mask_impl``, ``lightgbm_tpu/models/boosting.py:78``)
and MVS (``MVS._mvs_mask_impl`` and ``_threshold_device``, :119, :162).
Each gives a float32 weight a row, bit for bit the JAX package's for the
same gradients, labels and keys: 0 leaves the row out of the tree, 1
keeps it, a larger value keeps it upweighted.

Kernel B (``csrc/sample.cu``) is the whole sampling step on the card:
:func:`bag_weights` draws, :func:`goss_step` runs GOSS's radix select
(:func:`goss_select`, 3 launches) and the draw, :func:`mvs_step` MVS's
scores, PyTorch's sort, its scan (2 launches) and the draw, which
computes ``mu``.  With K classes GOSS and MVS sample on ``gh = sum_k |g[k]
* h[k]|`` over the (K, N) gradients (``boosting.py:82``, :165): kernel
B's class sum, :func:`class_gh` (one launch, then GOSS's step on it) and
:func:`mvs_class_step` (the same launch writing MVS's scores, then the
rest of MVS's step); :func:`class_gh_plain` is its plain version.  They
read nothing back to the host, so a CUDA graph of a tree's head holds
them.  A CUDA tensor launches the kernels (or raises); a CPU tensor takes
the plain versions: the thresholds :func:`goss_threshold`,
:func:`mvs_scores` and :func:`mvs_threshold` (PyTorch sorts and scans,
as they are XLA sorts and scans in the JAX package) and the draws
``*_plain`` (on ``prng.uniform_rows``).  :func:`goss_weights` and
:func:`mvs_weights` launch the draw alone, from given thresholds.  The
key words are a (4,) int64 tensor on the device: words 0-1 the draw's
key, 2-3 GOSS's tie key.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.prng import uniform_rows
from . import kernels
from .split import fma32, prefix_sum

__all__ = ["bag_weights", "bag_weights_plain", "class_gh", "class_gh_plain",
           "goss_select", "goss_step",
           "goss_threshold", "goss_weights", "goss_weights_plain",
           "mvs_class_step", "mvs_scores", "mvs_step", "mvs_threshold",
           "mvs_weights",
           "mvs_weights_plain", "sample_plan", "scan_levels", "scan_words",
           "sort_scores", "select_plan", "LAUNCHES", "STEP_LAUNCHES"]

# kernel B's launch constants (csrc/sample.cu): the draw and MVS's scores
SAMPLE_THREADS = 256
SAMPLE_BLOCKS_PER_SM = 8
# GOSS's radix select: 512 threads a block, at most 4 blocks an SM, 4 rows
# a thread in each step of the grid-stride loop; its digits, high to low,
# and its state words (three histograms, counters)
SELECT_THREADS = 512
SELECT_BLOCKS_PER_SM = 4
SELECT_DIGITS = (11, 11, 10)
SELECT_WORDS = 5128
# MVS's scan: a block a tile of 4096 values (256 chunks of 16), the
# chunk of XLA's CPU cumsum (``split.prefix_sum``)
SCAN_THREADS = 256
SCAN_CHUNK = 16
SCAN_TILE = SCAN_THREADS * SCAN_CHUNK
# the C entry point's modes
_BAG, _STRATIFIED, _GOSS, _MVS, _MVS_STEP = 0, 1, 2, 3, 4

# launches of kernel B's draw, one a call, by mode (one a sampled tree)
LAUNCHES = {"sample_bag": 0, "sample_goss": 0, "sample_mvs": 0}
# the step's other launches, by kernel: GOSS's select passes (3 a call),
# MVS's scores (1) and scan (2), and with K classes the class sum (1 a
# call, writing gh or MVS's scores)
STEP_LAUNCHES = {"goss_select": 0, "mvs_scores": 0, "mvs_scan": 0,
                 "class_sum": 0}


def _f32(x: float) -> float:
    """``x`` rounded to float32, as the JAX package's float32 compares and
    products round a Python float."""
    return float(np.float32(x))


def sample_plan(n: int, sms: int) -> int:
    """Kernel B's blocks for the draw and MVS's scores: a thread a row, at
    most 8 blocks of 256 an SM (the rest in the grid-stride loop)."""
    return max(1, min(SAMPLE_BLOCKS_PER_SM * sms,
                      -(-n // SAMPLE_THREADS)))


def select_plan(n: int, sms: int) -> int:
    """GOSS's select passes: 4 rows a thread a step, at most 4 blocks of
    512 an SM."""
    return max(1, min(SELECT_BLOCKS_PER_SM * sms,
                      -(-n // (4 * SELECT_THREADS))))


def scan_levels(n: int) -> list:
    """The lengths of MVS's scan hierarchy: ``n``, then ``ceil(len /
    16)`` until a level of at most 16 values (``prefix_sum``'s
    recursion)."""
    lens = [n]
    while lens[-1] > SCAN_CHUNK:
        lens.append(-(-lens[-1] // SCAN_CHUNK))
    return lens


def scan_words(n: int) -> int:
    """float32 words of the scan's scratch (``scan_layout`` in
    csrc/sample.cu): 4 header words (the packed first ``i``, the
    completion counter), every level's totals above level 0, and the
    prefixes of levels 3 and up."""
    lens = scan_levels(n)
    return 4 + sum(lens[1:]) + sum(lens[3:])


def _launch(mode: int, words: torch.Tensor, inp, sc0, sc1, c0: float,
            c1: float, n: int, counter: str, aux=None) -> torch.Tensor:
    """One launch of kernel B's draw writing a new (n,) float32 weight
    vector."""
    dev = words.device
    if words.dtype != torch.int64 or words.shape != (4,) or \
            not words.is_contiguous():
        raise ValueError("words must be a contiguous (4,) int64 tensor")
    for t in (inp, sc0, sc1, aux):
        if t is not None and t.device != dev:
            raise ValueError("all inputs must be on one device")
    if not 0 < n < 2 ** 32:
        raise ValueError("kernel B draws 1 to 2^32 - 1 rows")
    lib = kernels.load()
    w = torch.empty(n, dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.ltt_sample(mode, words.data_ptr(), ptr(inp), ptr(sc0),
                        ptr(sc1), c0, c1, w.data_ptr(), n,
                        sample_plan(n, kernels.sm_count(dev)), ptr(aux),
                        _stream(dev))
    kernels.check(rc, "kernel B (ltt_sample)")
    LAUNCHES[counter] += 1
    return w


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _rows(t: torch.Tensor, dtype, n: int, what: str) -> None:
    if t.dtype != dtype or t.shape != (n,) or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} ({n},)")


def _scalar(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.float32 or t.numel() != 1:
        raise ValueError(f"{what} must be one float32 value")


# ---- bagging (bernoulli and stratified) -------------------------------

def bag_weights_plain(words: torch.Tensor, n: int, frac: float,
                      pos_frac: float, neg_frac: float,
                      label_pos: Optional[torch.Tensor]) -> torch.Tensor:
    """``u < frac`` as float32, or with ``label_pos`` (uint8, label > 0)
    ``u < pos_frac`` on positive rows and ``u < neg_frac`` on the rest."""
    u = uniform_rows(words[:2], n)
    if label_pos is None:
        return (u < _f32(frac)).to(torch.float32)
    return torch.where(label_pos > 0, u < _f32(pos_frac),
                       u < _f32(neg_frac)).to(torch.float32)


def bag_weights(words: torch.Tensor, n: int, frac: float, pos_frac: float,
                neg_frac: float,
                label_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bagging's (n,) float32 weights on the device of ``words``: kernel
    B on the card, :func:`bag_weights_plain` on the CPU."""
    if words.device.type == "cpu":
        return bag_weights_plain(words, n, frac, pos_frac, neg_frac,
                                 label_pos)
    if label_pos is None:
        return _launch(_BAG, words, None, None, None, _f32(frac), 0.0, n,
                       "sample_bag")
    _rows(label_pos, torch.uint8, n, "label_pos")
    return _launch(_STRATIFIED, words, label_pos, None, None,
                   _f32(pos_frac), _f32(neg_frac), n, "sample_bag")


# ---- K classes: the class sum ------------------------------------------

def class_gh_plain(grad: torch.Tensor, hess: torch.Tensor) -> torch.Tensor:
    """``gh`` (N,) float32 of (K, N) gradients: ``|g[0] * h[0]| + |g[1] *
    h[1]| + ...``, each product rounded, added in class order from 0, as
    the JAX package's CPU reduce sums ``jnp.abs(grad * hess)`` over its
    leading axis."""
    gh = (grad[0] * hess[0]).abs()
    for k in range(1, grad.shape[0]):
        gh = gh + (grad[k] * hess[k]).abs()
    return gh


def _class_sum(grad: torch.Tensor, hess: torch.Tensor, var_weight: float,
               mode: int) -> torch.Tensor:
    """One launch of kernel B's class sum: mode 0 ``gh``, mode 1 MVS's
    scores of it."""
    if grad.dtype != torch.float32 or hess.dtype != torch.float32 or \
            grad.dim() != 2 or grad.shape != hess.shape or \
            grad.stride(1) != 1 or hess.stride(1) != 1:
        raise ValueError("grad and hess must be float32 (K, N) with "
                         "contiguous rows")
    if hess.device != grad.device:
        raise ValueError("all inputs must be on one device")
    K, n = grad.shape
    if not 0 < n < 2 ** 31 or K < 1:
        raise ValueError("kernel B sums 1 to 2^31 - 1 rows of K >= 1 "
                         "classes")
    dev = grad.device
    lib = kernels.load()
    out = torch.empty(n, dtype=torch.float32, device=dev)
    rc = lib.ltt_class_sum(grad.data_ptr(), grad.stride(0), hess.data_ptr(),
                           hess.stride(0), K, _f32(var_weight), mode,
                           out.data_ptr(), n,
                           sample_plan(n, kernels.sm_count(dev)), _stream(dev))
    kernels.check(rc, "kernel B (ltt_class_sum)")
    STEP_LAUNCHES["class_sum"] += 1
    return out


def class_gh(grad: torch.Tensor, hess: torch.Tensor) -> torch.Tensor:
    """``gh`` (N,) of (K, N) float32 gradients and hessians: kernel B's
    class sum on the card, :func:`class_gh_plain` on the CPU."""
    if grad.device.type == "cpu":
        return class_gh_plain(grad, hess)
    return _class_sum(grad, hess, 0.0, 0)


# ---- GOSS --------------------------------------------------------------

def goss_threshold(gh: torch.Tensor, top_k: int) -> tuple:
    """GOSS's top set of ``gh`` (N,) float32 -> (thr, n_gt, n_tie, p_tie),
    device tensors: ``thr`` the ``top_k``-th largest value (1,), the rows
    above it and at it (the latter at least 1), and the rate
    ``clip((top_k - n_gt) / n_tie, 0, 1)`` at which rows at it are
    admitted, an int32 quotient in float32 as the JAX package computes
    it.  ``-sort(-gh)`` is the JAX package's order, NaN last."""
    s_desc = -torch.sort(-gh).values
    thr = s_desc[top_k - 1:top_k]
    n_gt = (gh > thr).sum()
    n_tie = (gh == thr).sum().clamp(min=1)
    p_tie = ((top_k - n_gt).to(torch.float32) /
             n_tie.to(torch.float32)).clamp(0.0, 1.0).reshape(1)
    return thr, n_gt, n_tie, p_tie


def goss_weights_plain(words: torch.Tensor, gh: torch.Tensor,
                       thr: torch.Tensor, p_tie: torch.Tensor,
                       rest_rate: float, amp: float) -> torch.Tensor:
    """1 on the top set (above ``thr``, or at it where the tie key's
    uniform is below ``p_tie``), ``amp`` where the rest's uniform is below
    ``rest_rate``, else 0 (float32)."""
    n = gh.shape[0]
    top = (gh > thr) | ((gh == thr) &
                        (uniform_rows(words[2:], n) < p_tie))
    pick = ~top & (uniform_rows(words[:2], n) < _f32(rest_rate))
    return torch.where(top, torch.ones_like(gh),
                       torch.where(pick, torch.full_like(gh, _f32(amp)),
                                   torch.zeros_like(gh)))


def goss_weights(words: torch.Tensor, gh: torch.Tensor, thr: torch.Tensor,
                 p_tie: torch.Tensor, rest_rate: float,
                 amp: float) -> torch.Tensor:
    """GOSS's (N,) float32 weights: kernel B on the card,
    :func:`goss_weights_plain` on the CPU.  ``thr`` and ``p_tie`` are
    one-element float32 device tensors (:func:`goss_threshold`)."""
    if gh.device.type == "cpu":
        return goss_weights_plain(words, gh, thr, p_tie, rest_rate, amp)
    n = gh.shape[0]
    _rows(gh, torch.float32, n, "gh")
    _scalar(thr, "thr")
    _scalar(p_tie, "p_tie")
    return _launch(_GOSS, words, gh, thr.contiguous(), p_tie.contiguous(),
                   _f32(rest_rate), _f32(amp), n, "sample_goss")


def goss_select(gh: torch.Tensor, top_k: int) -> tuple:
    """GOSS's threshold: :func:`goss_threshold`'s (thr, n_gt, n_tie,
    p_tie), on the card from kernel B's radix select (3 launches), on the
    CPU from :func:`goss_threshold`.  ``gh`` is ``|g * h|``: non-negative
    or NaN."""
    n = gh.shape[0]
    if not 1 <= top_k <= n:
        raise ValueError(f"top_k must be in [1, {n}]")
    if gh.device.type == "cpu":
        return goss_threshold(gh, top_k)
    _rows(gh, torch.float32, n, "gh")
    if n >= 2 ** 32:
        raise ValueError("kernel B selects from at most 2^32 - 1 rows")
    dev = gh.device
    lib = kernels.load()
    state = torch.empty(SELECT_WORDS, dtype=torch.int32, device=dev)
    thr = torch.empty(1, dtype=torch.float32, device=dev)
    p_tie = torch.empty(1, dtype=torch.float32, device=dev)
    counts = torch.empty(2, dtype=torch.int64, device=dev)
    rc = lib.ltt_goss_select(gh.data_ptr(), n, top_k, state.data_ptr(),
                             SELECT_WORDS, thr.data_ptr(), p_tie.data_ptr(),
                             counts.data_ptr(),
                             select_plan(n, kernels.sm_count(dev)),
                             _stream(dev))
    kernels.check(rc, "kernel B (ltt_goss_select)")
    STEP_LAUNCHES["goss_select"] += len(SELECT_DIGITS)
    return thr, counts[0], counts[1], p_tie


def goss_step(words: torch.Tensor, gh: torch.Tensor, top_k: int,
              rest_rate: float, amp: float) -> tuple:
    """GOSS's sampling step on ``gh`` (N,) float32 -> (weights, thr, n_gt,
    n_tie, p_tie): :func:`goss_select`, then :func:`goss_weights` (on the
    card kernel B's select and draw, on the CPU the plain versions)."""
    thr, n_gt, n_tie, p_tie = goss_select(gh, top_k)
    return (goss_weights(words, gh, thr, p_tie, rest_rate, amp), thr, n_gt,
            n_tie, p_tie)


# ---- MVS ---------------------------------------------------------------

def mvs_scores(gh: torch.Tensor, var_weight: float) -> torch.Tensor:
    """``sqrt(gh * gh + var_weight)`` in float32, the product fused into
    the add (one rounding), as the JAX package's CPU compile contracts it
    in ``_mvs_mask_impl``.  The root is taken in float64 and rounded once:
    PyTorch's float32 ``sqrt`` on the CPU is not correctly rounded, and a
    float64 root of a float32 value rounds to the float32 root."""
    sq = fma32(gh, gh, torch.full_like(gh, _f32(var_weight)))
    return torch.sqrt(sq.to(torch.float64)).to(torch.float32)


def mvs_threshold(s: torch.Tensor, target: float) -> torch.Tensor:
    """MVS's threshold ``mu`` (1,) float32 for scores ``s`` (N,) and the
    expected sample size ``target`` (``_threshold_device``): over the
    descending order statistic, ``est = i + suffix_sum[i] / s[i]`` at the
    first ``i`` where it exceeds the target, ``suffix_sum[i] / (target -
    i)``; the smallest score when it never does.  The suffix sums take
    XLA's CPU cumsum order (:func:`prefix_sum` of the reversed vector)."""
    n = s.shape[0]
    tgt = _f32(target)
    s_desc = -torch.sort(-s).values
    suffix = prefix_sum(s_desc.flip(0), 0).flip(0)
    idx = torch.arange(n, dtype=torch.float32, device=s.device)
    est = idx + suffix / s_desc.clamp(min=_f32(1e-35))
    over = est > tgt
    i = over.to(torch.uint8).argmax().reshape(1)
    mu_in = suffix.index_select(0, i) / \
        (tgt - i.to(torch.float32)).clamp(min=_f32(1e-10))
    return torch.where(over.any(), mu_in, s_desc[-1:])


def mvs_weights_plain(words: torch.Tensor, s: torch.Tensor,
                      mu: torch.Tensor) -> torch.Tensor:
    """``p = min(s / max(mu, 1e-35), 1)``; ``1 / max(p, 1e-35)`` where the
    uniform is below ``p``, else 0 (float32)."""
    prob = (s / mu.clamp(min=_f32(1e-35))).clamp(max=1.0)
    keep = uniform_rows(words[:2], s.shape[0]) < prob
    return torch.where(keep, 1.0 / prob.clamp(min=_f32(1e-35)),
                       torch.zeros_like(s))


def mvs_weights(words: torch.Tensor, s: torch.Tensor,
                mu: torch.Tensor) -> torch.Tensor:
    """MVS's (N,) float32 weights: kernel B on the card,
    :func:`mvs_weights_plain` on the CPU.  ``mu`` is a one-element
    float32 device tensor (:func:`mvs_threshold`)."""
    if s.device.type == "cpu":
        return mvs_weights_plain(words, s, mu)
    n = s.shape[0]
    _rows(s, torch.float32, n, "s")
    _scalar(mu, "mu")
    return _launch(_MVS, words, s, mu.contiguous(), None, 0.0, 0.0, n,
                   "sample_mvs")


def sort_scores(s: torch.Tensor) -> torch.Tensor:
    """The scores in ascending order: the plain version's descending order
    ``-sort(-s)`` reversed (the same values; NaN, which that order puts
    last, comes last here too, and the scan then gives ``mu = NaN`` as the
    plain version does).  A score is a square root, non-negative or a NaN
    of positive sign, so its int32 bits order it as its value does: the
    int32 sort gives the float sort's values and was the fastest sort on
    the card (``PERF.md``)."""
    return torch.sort(s.view(torch.int32)).values.view(torch.float32)


def mvs_step(words: torch.Tensor, gh: torch.Tensor, var_weight: float,
             target: float) -> tuple:
    """MVS's sampling step on ``gh`` (N,) float32 -> (weights, s, mu), as
    :func:`mvs_scores`, :func:`mvs_threshold` and
    :func:`mvs_weights_plain` give them: on the card kernel B's scores,
    PyTorch's sort (:func:`sort_scores`), kernel B's scan (2 launches) and
    its draw, whose blocks compute ``mu`` from the scan; on the CPU the
    plain versions."""
    n = gh.shape[0]
    if gh.device.type == "cpu":
        return _mvs_plain(words, mvs_scores(gh, var_weight), target)
    _rows(gh, torch.float32, n, "gh")
    if n >= 2 ** 31:
        raise ValueError("kernel B's scan takes at most 2^31 - 1 rows")
    dev = gh.device
    lib = kernels.load()
    s = torch.empty(n, dtype=torch.float32, device=dev)
    rc = lib.ltt_mvs_scores(gh.data_ptr(), _f32(var_weight), s.data_ptr(),
                            n, sample_plan(n, kernels.sm_count(dev)),
                            _stream(dev))
    kernels.check(rc, "kernel B (ltt_mvs_scores)")
    STEP_LAUNCHES["mvs_scores"] += 1
    return _mvs_rest(words, s, target)


def mvs_class_step(words: torch.Tensor, grad: torch.Tensor,
                   hess: torch.Tensor, var_weight: float,
                   target: float) -> tuple:
    """MVS's sampling step on (K, N) float32 gradients and hessians ->
    (weights, s, mu), :func:`mvs_step`'s on :func:`class_gh_plain`'s gh: on
    the card kernel B's class sum writes the scores (one launch, in place
    of the scores launch), then the sort, the scan and the draw."""
    if grad.device.type == "cpu":
        return _mvs_plain(words, mvs_scores(class_gh_plain(grad, hess),
                                            var_weight), target)
    return _mvs_rest(words, _class_sum(grad, hess, var_weight, 1), target)


def _mvs_plain(words: torch.Tensor, s: torch.Tensor, target: float):
    mu = mvs_threshold(s, target)
    return mvs_weights_plain(words, s, mu), s, mu


def _mvs_rest(words: torch.Tensor, s: torch.Tensor, target: float):
    """MVS's step after its scores ``s`` on the card: PyTorch's sort,
    kernel B's scan (2 launches) and its draw, which computes ``mu``."""
    n = s.shape[0]
    dev = s.device
    lib = kernels.load()
    x = sort_scores(s)
    words_n = scan_words(n)
    scratch = torch.empty(words_n, dtype=torch.float32, device=dev)
    rc = lib.ltt_mvs_scan(x.data_ptr(), n, _f32(target), scratch.data_ptr(),
                          words_n, _stream(dev))
    kernels.check(rc, "kernel B (ltt_mvs_scan)")
    STEP_LAUNCHES["mvs_scan"] += 2
    mu = torch.empty(1, dtype=torch.float32, device=dev)
    w = _launch(_MVS_STEP, words, s, scratch, x, _f32(target), 0.0, n,
                "sample_mvs", aux=mu)
    return w, s, mu
