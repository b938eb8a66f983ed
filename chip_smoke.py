"""Chip smoke test of the PyTorch/CUDA port (``lightgbm_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``lightgbm_tpu_torch/csrc`` and
drives the port only (nothing of JAX or of ``lightgbm_tpu``):

1. prints the card (name and power limit, from nvidia-smi) and builds the
   kernels (one nvcc per source, all started together);
2. holds every kernel against its plain PyTorch version on the same CUDA
   tensors, at the main paths' full-width shapes and at ragged shapes, and
   times kernel, plain version and, where one exists, the one-call PyTorch
   equivalent (``cuda_ms``: one CUDA event pair around a run of
   back-to-back launches): kernel H at leaf densities 1 (the root pass),
   1/8, 1/32 and 1/255 with float, integer and wide-exponent values (each
   also a repeat launch compared bit for bit, and its device time from
   ``torch.profiler``), kernels S and L of the exact path (S at W=2, also
   with max_depth active, gains equal, in one CUDA launch a call counted by
   ``torch.profiler``, with its device time beside the time of back-to-back
   calls; L exact for uint8 and int32 ids and ragged lengths, and in its
   float64 mode, a validation set's score, exact at ragged lengths and over
   500k and 10.5M rows with uint8 and int32 ids, with its device time and
   one CUDA launch a call), and kernels M (its root pass at full
   resolution: one lane, every row, two-column int8, exact, in 2 CUDA
   launches a call; W=64 two-column int8, exact; W=21 float and
   wide-exponent float values within rel 1e-5; each with a repeat launch
   bit for bit), R (W=64, 6-row lane tables, two-column int8 exact and W=21
   float within rel 1e-5, each with a repeat launch bit for bit, its
   launches a call and device time; and every edge table of
   ``ROUTED_EDGE_CASES``, exact), Q (exact at L = 255, 7 and 31 on uint8
   ids and at L = 1000 on int32 ids, wide-exponent grad and hess within rel
   1e-6, each with a repeat launch bit for bit, in 3 CUDA launches a call)
   and S at the wave's 128 children with the counts proxy; and the
   coarse-to-fine kernels: M coarse (the root pass, and W=64, two-column
   int8, shift 4 with the reserved missing slot; W=21 float), R coarse
   (W=64, as R above), V (the root's window: W=1, two-column int8, exact in
   2 CUDA launches a call; float values at W=1 and W=21 and wide-exponent
   ones within rel 1e-5; W=64 through an int32 selector, exact; each with a
   repeat launch bit for bit) and V-lanes (W=64 and a wave's 2W=128
   children in one call on a uint8 leaf vector with dummy lanes and windows
   at both edges, each in 2 CUDA launches a call with its sector floor;
   int32 leaf ids at leaf bound 32768 and ragged lengths; float and
   wide-exponent values), all exact on integers; and kernel B, the
   sampling step, in each mode (bernoulli and stratified bagging's draw;
   GOSS's radix select and draw, with ties at its threshold; MVS's
   scores, scan and draw around PyTorch's sort), its outputs (the
   weights; thr, n_gt, n_tie, p_tie; s, mu) bit for bit against its plain
   version at 1, 15, 16, 17, 4095, 4097, 65537, 2^20 + 3 and 10.5M rows,
   GOSS also with every row tied, all zero, NaN and inf rows and fewer
   non-NaN rows than top_k, MVS with a target no i passes, with a repeat
   launch; at 10.5M its named CUDA launches a call (1 draw; GOSS 3 select
   passes and the draw; MVS scores, 2 scan launches and the draw), its
   time and device time by part, the draw alone, the plain step's time,
   and the draw's bound from its SASS (``tools/sass_ops.py``: the
   bagging loop's integer instructions at 64 lanes an SM and the card's
   maximum clock, beside the old count); and kernel T, the validation
   scorer's route (one launch: one block packs the records into one
   table, every block walks its rows), the table word for word and the
   ids exactly against their plain versions with a repeat launch, on
   random split records (a tenth invalid, the missing bin to a random
   side) at 1, 7, 31, 255 and 1500 leaves, uint8 and int16 bins, uint8
   and int32 ids, ragged lengths, and at 1024, 500k x 28 and 10.5M x 28
   with 255 leaves, one launch a call, with its bound from the sectors
   the rows' walks read; and kernel U, LambdaRank's lambdas (run after
   phase 11, on phase 13's data): against its plain version at the
   MS-LTR shape (9,999 queries of 227 documents, bench.py's labels) on
   the all-equal first iteration and a trained-like score, on its first
   500 queries, and on a skewed set (queries split across blocks, the
   20,000-document one checked to take the split path; queries of 1
   document, at a band's and a tile's edges, of one label; with weights,
   without ``lambdamart_norm``), a repeat launch bit for bit and every
   document within one float32 ulp of the plain version, each one-ulp
   document explained by its float64 sum in kernel U's order
   (``ops/rank.py`` ``replay_sums``; the count printed); at the MS-LTR
   shape its time, device time, CUDA launches a call, the plain version's
   time, and its bound from the float64 operations its pairs need (21 an
   unordered pair with different labels, at 64 float64 lanes an SM and
   the card's maximum clock), its own pair step's SASS beside it as a
   reading; with ``LTT_OLD_U`` naming an earlier checkout's
   ``csrc/rank.cu``, that kernel's times beside the new one's; and
   kernel B's class sum (K > 1: gh = sum_k |g * h|, or MVS's scores of it
   in the same launch) bit for bit against its plain version with a
   repeat launch, and GOSS's and MVS's whole steps on it, at K = 2 and 5
   and 1 to 1M rows; at K = 5, N = 1M its CUDA launches a call, time,
   device time, the plain version's and ``(g * h).abs().sum(0)``'s times
   and its bound by bytes;
3. the exact path: trains the Higgs-shaped configuration at full width
   (10.5M x 28, num_leaves=255, max_bin=255, learning_rate=0.1,
   min_sum_hessian_in_leaf=100) in three modes, 6 trees each, the launch
   counters set to 0 just before and read just after: on CUDA graphs as
   training runs it (the main path: the first tree eager, the graphs
   captured after it, 5 measured trees), with every kernel launched from
   Python ("eager"), and with fused_iters=5 (the bias iteration, then one
   block of 5); the three give the same trees bit for bit and execute the
   same kernel launches.  Seconds per iteration, kernel launches executed,
   graph replays and flag reads per tree, the capture (graphs, host
   seconds, the graph pool's memory), and for the graphed and eager runs
   one more iteration under torch.profiler (device busy time, idle
   share); then it predicts a 500k-row holdout;
4. the wave path: bench.py's wave255 (wave growth, quantized two-column
   passes at W=64, min_data_in_leaf=0) with hist_refinement=false on the
   same data, in the same three modes: waves per tree, launches of M, R,
   Q, S and L, and holdout AUC no more than 0.02 below the exact path's;
5. wave255 as bench.py runs it, coarse-to-fine refinement on
   (refine_shift 4), on the same data, in the same three modes: launches
   of M, V, R, V-lanes (one a wave), Q and L per tree, none of S, and
   holdout AUC no more than 0.02 below the exact path's;
6. trains reduced copies (50k rows with missing values, 6 iterations:
   the exact path at 31 leaves, float waves, quantized two-column waves
   at 127 leaves, and both wave kinds with coarse-to-fine refinement; and
   with row sampling: stratified bagging on float waves, GOSS on the
   two-column coarse-to-fine waves, MVS on the two-column waves, whose
   CPU runs are at fused_iters=1 only; DART on the exact loop at 31
   leaves and a random forest on float waves, which do not fuse and run
   at fused_iters=1 only) on the card and on the CPU, each at fused_iters
   1 and 4, and requires
   identical trees card against CPU, and fused_iters=4 the same bits as
   fused_iters=1 on each device; then the objective zoo (20k rows, 5%
   NaN, 3 iterations): the ten regression and cross-entropy objectives
   on the exact loop at 31 leaves, L1 and MAPE also with bernoulli bagging
   and with GOSS, softmax and one-vs-all on the exact loop, float waves
   and two-column coarse-to-fine waves, identical trees card against CPU,
   and the objectives that do not refit leaves at fused_iters=4 the same
   bits as at 1 on the card; then lambdarank on the MS-LTR generator's
   first 88 queries (19,976 x 136) on the exact loop at 31 leaves and
   two-column waves at 127 without and with coarse-to-fine (fused_iters=4
   the bits of 1 on the card), and a numpy log-loss ``fobj`` on the exact
   loop at 31 leaves (50k rows), identical trees card against CPU;
7. (run before phase 6, on phase 3's data) each of the three paths at
   full width with the 500k-row holdout as a validation set, through
   ``train(valid_sets=..., evals_result=..., early_stopping_rounds=...,
   learning_rates=...)`` with ``metric=auc,binary_logloss`` (exact 3
   trees, waves 6), the launch counters set to 0 just before and read
   just after: the validation scorer (kernel T routing the holdout's rows
   (its pack and walk) and kernel L's float64 add, 3 kernel launches)
   replays as a CUDA graph, once a tree; the holdout score
   within 1e-5 of the served trees' prediction on the raw holdout, and
   every recorded metric within 1e-9 of its numpy formula on the fetched
   score; the same rounds eagerly (the same trees, scores and metrics bit
   for bit) and at fused_iters=5 without the validation set under the
   same learning-rate schedule (the same trees and training score bit for
   bit: the rate is a device scalar, and a block served at another rate
   is rewound).  Seconds an iteration with and without the validation
   set, eval's host milliseconds an iteration, the scorer's replay time,
   device time and CUDA kernels;
8. ``cv`` reduced (50k rows, 3 folds) on the card and on the CPU: the
   same means and deviations (logloss within 1e-6, AUC within 1e-4);
9. (run after phase 5, on phase 3's data) row sampling at full width:
   bench.py's goss255 (wave255 as it ships with boosting=goss), exact255
   with bernoulli bagging (bagging_fraction=0.7, bagging_freq=2) and
   wave255 without coarse-to-fine with MVS (bagging_fraction=0.6), each
   on CUDA graphs and at fused_iters=5 (goss255 also eagerly), the launch
   counters set to 0 just before each run and read just after: the same
   trees bit for bit and the same kernel launches, the sampling step's
   named launches a tree (the draw once; GOSS's select 3, MVS's scores 1
   and scan 2), holdout AUC above 0.6; seconds an iteration beside the
   unsampled path's of phases 3-5, and the step's time and its parts'
   device time (the sort, the scan or select, the draw) on the trained
   booster's gradients;
10. (run after phase 7, on phase 3's data) DART on wave255 without
   coarse-to-fine (drop_rate=0.3, skip_drop=0, 8 trees) and a random
   forest on exact255 (bagging_fraction=0.632, bagging_freq=1,
   feature_fraction=0.8, 6 trees), each with the 500k holdout as a
   validation set, on CUDA graphs and eagerly, the launch counters set to
   0 just before each run and read just after: the same trees, training
   and holdout scores bit for bit, kernel T's pack and walk once a tree
   (the scorer's graph holds them alone: the host tree's values are
   added after the tree lands), the holdout score within 1e-5 and the
   training score within 1e-4 (first 500k rows) of the trees'
   prediction, before and after
   ``rollback_one_iter``, holdout AUC above 0.6; then a gbdt rollback
   inside a fused_iters=5 block.  Seconds an iteration beside the
   unsampled path's, DART's drop and renormalization host ms an
   iteration and the device bytes of its kept leaf ids;
11. (run after phase 12) multiclass at bench.py's shape
   (``bench.py:2333-2343``: RandomState(17), 1M x 28, 5 classes, label
   the argmax of the first five features plus noise, 63 leaves,
   wave255's parameters with coarse-to-fine as it ships): softmax 6
   iterations (30 trees), one-vs-all 4 and softmax on the exact loop 3;
   at K = 5 under the other boosting modes, softmax with GOSS 4
   iterations and with MVS (``bagging_fraction=0.5``) 4 (kernel B's class
   sum, its select or scan and its draw once an iteration), DART
   (``drop_rate=0.3``, ``skip_drop=0``) 4 with the 100k holdout as a
   validation set (kernel T once a class tree; the holdout scores bit for
   bit graphed and eager and within 1e-5 of the trees' prediction) and a
   one-vs-all random forest on the exact loop (``bagging_fraction=0.5``,
   ``bagging_freq=1``) 3; each on CUDA graphs and eagerly (the same trees
   and training score bit for bit, the same kernel launches; counters set
   to 0 just before each run and read just after), the training score
   within 1e-4 of the trees' prediction; the kernels' launches a class
   tree, seconds an iteration and a tree; then softmax through ``train``
   with a 100k-row holdout drawn next from the same generator
   (``metric=multi_logloss,multi_error``): its (K, n) score within 1e-5
   of ``predict(raw_score=True)``, the metrics within 1e-9 of their numpy
   formulas, multi_error below 0.5 (chance is 0.8), kernels T and L's
   float64 mode once a class tree;
12. (run after phase 10, on phase 3's matrix) the regression zoo at full
   width, the label ``z = 0.5 X[:, :6] w + 0.3 X0 X1 + 0.5 noise``
   (RandomState(5)) and MAPE's ``exp(z)``: L1 on exact255 (the unweighted
   renewal on the card), quantile at alpha 0.9 on wave255 without
   coarse-to-fine, MAPE on wave255 (the weighted renewal's host pass), 4
   trees each, graphed and eager the same bits and launches, the
   training score within 1e-4 of the trees' prediction on the first 500k
   rows, the renewal's ms a tree (synchronised), one renewal profiled
   (device ms and share) and the rows whose weights went to the host;
13. (run after phase 12, on phase 3's data) ``higgs-wave255-noc2f-fobj``:
   a numpy binary log loss through ``Booster.update(fobj=)`` on wave255
   without coarse-to-fine, 6 iterations on the graphs (kernels M, R, Q, S
   and L launched, graph replays), seconds an iteration beside the
   built-in binary's of phase 4, the host's fobj ms, the training score's
   fetch and the gradients' copy; then (run after phase 11) bench.py's
   MS-LTR row, ``msltr-lambdarank`` (2,269,773 x 136, 9,999 queries of
   227, lambdarank with ``metric=ndcg``, ``eval_at=[1, 3, 5, 10]``, 255
   leaves, wave255's parameters with coarse-to-fine as it ships): the
   Dataset's construction seconds, 6 iterations graphed, eagerly and at
   fused_iters=5 (the same trees and launches), kernel U once a tree,
   its share of a profiled iteration's device time, the replays a tree,
   NDCG@10 of a 200-query training subset above a constant score's; and
   ``msltr-lambdarank-valid``: ``train`` with a 1,000-query holdout from
   the same generator as a grouped validation set, ndcg@1, 3, 5 and 10
   within 1e-9 of a numpy NDCG of the fetched score, the score within
   1e-5 of the trees' prediction, kernels U, T and L's float64 mode once
   a tree;
14. (run after phase 13's fobj cell, on phase 3's data) bench.py's
   missing + categorical Higgs row (``bench.py:2150-2214``): 10% NaN from
   RandomState(29) in chunks of 1M rows; ``higgs-missing-wave255``
   (numerical, wave255 as it ships, c2f on), then columns 0-3 as
   ``floor(|nan_to_num(x)| * 4) % 12`` named categorical in the parameter
   and the Dataset: ``higgs-missing-cat-wave255`` (bench.py's
   base_params, wave_splits, use_quantized_grad: W=42 three-column waves
   routed outside the pass, no two-column passes, no c2f) and
   ``higgs-missing-cat-exact255`` (the exact loop), each graphed, eagerly
   and at fused_iters=5 (the same trees and launches), its tiers, its
   Dataset's seconds, kernel launches and replays a tree, categorical
   splits (more than none), the training score within 1e-5 of the trees'
   prediction on the first 500k rows and training AUC above 0.6; then
   ``higgs-missing-cat-wave255-valid``, the 500k holdout under the same
   transform as a validation set (phase 7's checks).  Phase 2 holds
   kernel M at that wave's launch (W=42, three int8 columns, an int8
   selector) and the merged split scan (kernel S and the categorical
   scan) of its 84 children against the CPU's, bit for bit.
15. (run after phase 14) bench.py's sparse one-hot row
   (``bench.py:2282-2331``): RandomState(13), 1M rows, 40 columns of 8-24
   levels one-hot encoded into 652 CSR float32 indicator columns, the
   Dataset made from the CSR (its seconds and peak host bytes by
   tracemalloc beside the float64 densify), exclusive feature bundling
   (40 groups, committed width 25, the host's ``find_bundles`` the same
   groups): ``allstate-exact255`` (bench.py's base_params, max_bin=63,
   enable_bundle; the exact loop), ``allstate-wave255`` (+ wave_splits,
   use_quantized_grad: W=42 three-column waves routed outside the pass)
   and ``allstate-exact255-nobundle``, each graphed, eagerly and at
   fused_iters=5, their device matrix bytes, launches a tree, training
   score within 1e-5 of the prediction and training AUC above that of
   the logit the labels are drawn from; ``allstate-wave255-valid`` with a
   100,000-row holdout of the same generator as a validation set (phase
   7's checks: kernel T on records translated onto bundle columns; the
   holdout AUC within 0.01 of the logit's); and the card's trees equal to the
   CPU's on the first 50,000 rows.  Phase 2 holds kernels H (40 x 1M, B =
   25), M (W=42, three int8 columns), S (84 children expanded to 652
   features) and T (translated records, against routing the indicator
   columns) at those shapes and counts ``expand``'s CUDA kernels.
16. (run after phase 14, on phase 3's data) monotone constraints and the
   feature penalty: ``monotone_constraints`` +1 on features 2-4 and -1 on
   5 (the signs of the generator's weights), ``feature_contri`` 0.5 on
   6-9, on ``higgs-mono-exact255`` (exact255's parameters: H, kernel S's
   constrained mode, L), ``higgs-mono-wave255-noc2f`` (M, R, the
   constrained S over 2W children, Q, L) and ``higgs-mono-wave255`` (c2f:
   M and R coarse, V, V-lanes, the plain c2f scans with bounds, Q, L),
   each graphed, eagerly and at fused_iters=5 with the same bits and
   launches: seconds an iteration, idle share and launches a tree beside
   the unconstrained cells' of phases 3-5, training AUC above 0.6, the
   exact cell's predictions monotone over every bin threshold of each
   constrained feature for 64 rows (1e-10), the quantized cells' trees
   before the renewal monotone and the renewed trees' breaks counted, the
   splits on features 6-9 against the unconstrained cells'; then the
   card's trees against the CPU's with the constraints on 50,000 rows (the
   exact loop, float waves, quantized waves without and with c2f,
   categorical waves on phase 14's transform with the constraints on
   features 4-7, phase 15's generator bundled with constraints on its
   first 4 columns, K = 5 softmax).  Phase 2 holds kernel S's
   constrained mode (random directions, multipliers in [0.5, 1.5], finite
   bounds a lane) against its plain version bit for bit at W = 2, 2W =
   128 and the bundled (84, 652, 25, 3), each at the three fusion sites,
   with its times beside the unconstrained rows.
17. (run after phase 16, on phase 3's data) the numerical-health checks:
   on exact255, wave255-noc2f and wave255, graphed, 2 clean iterations,
   then 1 label in 1,000 NaN in place (the binary objective's sign
   labels): ``NumericalHealthError`` at iteration 2 (phase "tree") with
   the iteration, trees, training score and tree ids of before the call;
   the labels restored, 3 more iterations profiled: the health
   reductions' device time a tree (kernels by name) against an
   iteration's busy time;
   wave255 at fused_iters=4, depth 1: a rewind, the poisoned block's error
   at iteration 2 (phase "superstep"), the queued block dropped; an
   infinite label on exact255 at iteration 0 (the bias back out of the
   score); a ``fobj`` whose gradients turn NaN at iteration 1; a no-split
   stop (``min_data_in_leaf`` = N + 1) graphed and fused: 1 tree,
   iteration 0; then H, S, L, M, R, Q, V and V-lanes on NaN-bearing
   inputs at full width against their plain versions
   (``phase_health_kernels``).  Each phase prints its seconds.

Every phase passes or the script exits non-zero.  The last line is
``{"ok": true, "device": {...}}``; the line before it is the per-kernel
JSON record.  Without a card, or without the rest of the repository, it
exits non-zero and prints no result.
"""
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12           # H100 SXM float32 outside tensor cores
DEVICE = "cuda"
# kernel H's two launches (csrc/histogram.cu), by their function names
KERNEL_H_NAMES = ("hist_masked_kernel", "hist_reduce_kernel")
# kernel S's launch (csrc/split.cu) and kernel R's three (routed_hist.cu:
# the routing launch, then the shared body's histogram and reduction,
# whose names carry the calling kernel's tag), M's and V-lanes' two
MULTI_NAMES = ("MultiTag",)
LANES_NAMES = ("LanesTag",)
WINDOW_NAMES = ("WindowTag",)
# kernel Q's launches (csrc/leaf_stats.cu): its bound launch, its sums and
# the shared body's reduction under its tag
LEAF_NAMES = ("leaf_bound_kernel", "leaf_stats_kernel", "LeafTag")
SPLIT_NAMES = ("best_split_kernel",)
LOOKUP_NAMES = ("leaf_add_kernel",)
ROUTED_NAMES = ("route_kernel", "RoutedTag")
# the old count of a draw's 32-bit operations, priced at the float32 peak
# (the 20 Threefry rounds, the key injections and schedule, the output
# xor, the float conversion and the compare), printed beside the bound
# from the SASS
THREEFRY_OPS = 83
N_ROWS = 10_500_000
N_FEATURES = 28
N_HOLDOUT = 500_000
TRAIN_PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
                "learning_rate": 0.1, "min_sum_hessian_in_leaf": 100,
                "verbose": -1}
# bench.py's primary variant wave255 (bench.py:12-15, :1882-1896) as it
# ships (coarse-to-fine refinement on by default), and without it
WAVE255_PARAMS = {"wave_splits": True, "use_quantized_grad": True,
                  "min_data_in_leaf": 0}
WAVE_PARAMS = dict(WAVE255_PARAMS, hist_refinement=False)


def make_higgs_shaped(n_rows, n_features, seed=0):
    """The benchmark's Higgs-shaped generator (bench.py:58), copied."""
    rng = np.random.RandomState(seed)
    # mixture of unit-scale kinematic-like features, chunked to bound
    # peak host memory
    X = np.empty((n_rows, n_features), dtype=np.float32)
    chunk = 1_000_000
    w = rng.randn(n_features).astype(np.float32)
    y = np.empty(n_rows, dtype=np.float32)
    for lo in range(0, n_rows, chunk):
        hi = min(lo + chunk, n_rows)
        Xc = rng.randn(hi - lo, n_features).astype(np.float32)
        Xc[:, ::3] = np.abs(Xc[:, ::3])          # momentum-like positives
        X[lo:hi] = Xc
        logits = Xc @ w * 0.5 + 0.3 * Xc[:, 0] * Xc[:, 1] - 0.1
        p = 1.0 / (1.0 + np.exp(-logits))
        y[lo:hi] = (rng.random_sample(hi - lo) < p).astype(np.float32)
    return X, y


def np_auc(label, score):
    """ROC AUC by rank-sum over sorted scores, one area term per unique
    score (``binary_metric.hpp`` AUCMetric): the numpy formula the
    port's torch metric is held to."""
    order = np.argsort(score, kind="mergesort")
    s, y = score[order], label[order] > 0
    pos = float(np.sum(y))
    neg = len(y) - pos
    if pos <= 0 or neg <= 0:
        return 1.0
    starts = np.concatenate([[0], np.nonzero(np.diff(s))[0] + 1])
    tie_pos = np.add.reduceat(y.astype(np.float64), starts)
    tie_neg = np.add.reduceat((~y).astype(np.float64), starts)
    neg_below = np.cumsum(tie_neg) - tie_neg
    return float(np.sum(tie_pos * (neg_below + tie_neg / 2.0)) /
                 (pos * neg))


def np_logloss(label, prob):
    p = np.clip(prob, 1e-15, 1 - 1e-15)
    return float(np.mean(-(label * np.log(p) + (1 - label) *
                           np.log(1 - p))))


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps, warmup=1):
    """Milliseconds of one call of ``fn``: after ``warmup`` calls, one
    event, ``reps`` calls back to back, one event, a synchronise, and the
    elapsed time over ``reps`` (the host's per-call overhead then hides
    behind the card's queue, as it does in a training loop)."""
    import torch
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def profile_calls(fn, reps, names, warmup=1, tries=5, whole=True):
    """(device milliseconds of one call of ``fn``: the summed durations of
    the CUDA kernels whose names contain one of ``names``; CUDA kernels
    the card ran per call), from ``torch.profiler`` over ``reps`` calls
    after ``warmup``.  Unlike ``cuda_ms`` it leaves out the time the card
    waits on the host.  The profiler now and then drops the kernels
    launched in the first milliseconds after it starts
    (``lightgbm_tpu_torch/tools/prof_window.py`` counts how often), so
    the host waits 20 ms before the first call.  A window with no kernel
    named in ``names``, or (``whole``) whose kernel count is not a
    multiple of ``reps``, is profiled again, up to ``tries`` times.
    Without ``whole`` the window is taken as it comes and the kernels a
    call may be fractional (5 replays of the validation scorer's graph
    showed 7,642 CUDA kernels in every try)."""
    import torch
    for _ in range(warmup):
        fn()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    seen = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(0.02)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(e.time_range.end - e.time_range.start for e in evts
                 if any(k in e.name for k in names))
        if us > 0 and (len(evts) % reps == 0 or not whole):
            return us / 1e3 / reps, len(evts) / reps
        seen.append(len(evts))
    fail(f"the profiler recorded no whole window of {reps} calls of "
         f"{names} in {tries} tries (CUDA kernels a window: {seen})")


def kernels_seen(fn, reps, names):
    """{kernel: [kernels recorded a call, device ms a recorded launch]}
    from one ``torch.profiler`` window of ``reps`` calls of ``fn``, after
    one call and 20 ms; a kernel is keyed by the first of ``names`` its
    name contains, else by its name's first 48 characters.  The profiler
    drops a few of a window's first kernels (``profile_calls``), so a
    short window records fewer kernels a call than were launched; the
    time a recorded launch does not depend on that."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(0.02)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    seen = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = next((k for k in names if k in e.name), e.name[:48])
        row = seen.setdefault(key, [0, 0.0])
        row[0] += 1
        row[1] += (e.time_range.end - e.time_range.start) / 1e3
    return {k: [n / reps, ms / n] for k, (n, ms) in seen.items()}


def card_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        return "nvidia-smi unavailable"
    return smi.stdout.strip().splitlines()[0]


def bound(nbytes, flops):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the float32 operations over the card's peak."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def split_bound(hist, B, constrained=False):
    """Kernel S's bound: reads the histograms, the parents, the depths
    and per-feature descriptors (9 bytes); writes the record.  Per (lane,
    feature, bin): 3 scan adds, and per default direction the right-side
    stats (3), two leaf outputs (4 each) and gains given output (6 each),
    their sum and the gain shift (2): 3 + 2 * 25.  ``constrained``: the
    constrained mode reads a direction and a multiplier a feature (5
    bytes) and two bounds a lane (8 bytes) more."""
    W, F = hist.shape[:2]
    extra = F * 5 + W * 8 if constrained else 0
    return bound(hist.numel() * 4 + W * (3 * 4 + 4) + F * 9 +
                 W * (4 * 3 + 1 + 12 + B) + extra, hist.numel() // 3 * 53)


def constraint_operands(torch, parent, F, seed):
    """Kernel S's constrained operands for ``parent`` (W, 3): random
    directions in {-1, 0, 1} (int32), multipliers in [0.5, 1.5] and finite
    bounds a lane around the lane's own output, which bind on its
    children -> {"monotone", "penalty", "bounds"}."""
    dev = parent.device
    W = parent.shape[0]
    g = torch.Generator(device=dev).manual_seed(seed)
    mono = torch.randint(-1, 2, (F,), generator=g, device=dev,
                         dtype=torch.int32)
    pen = torch.rand(F, generator=g, device=dev) + 0.5
    out = -parent[:, 0] / (parent[:, 1] + 1e-15)
    width = (out.abs() + 1e-3) * (0.2 + torch.rand(W, 2, generator=g,
                                                   device=dev).T)
    bounds = torch.stack([out - width[0], out + width[1]], 1).contiguous()
    return {"monotone": mono, "penalty": pen, "bounds": bounds}


def measure_split_constrained(torch, ts, hist, parent, nb, mt, fm, p, site,
                              ctx, seed, depth=None, max_depth=0):
    """Kernel S's constrained mode against its plain version at one shape:
    the record bit for bit at every fusion site with every operand (the
    penalty alone, the directions with the bounds, all three), a repeat
    launch the same bits; then, with all three at ``site``, one CUDA
    launch a call, its ms back to back, device ms, plain ms and bound
    (:func:`split_bound`)."""
    F = hist.shape[1]
    ops = constraint_operands(torch, parent, F, seed)
    cp = dataclasses.replace(p, monotone=tuple(ops["monotone"].tolist()),
                             penalty=tuple(ops["penalty"].tolist()))
    args = (hist, parent, nb, mt, fm, cp, depth, max_depth)
    for s in (ts.ROOT, ts.LOOP, ts.WAVE):
        for keys in (("penalty",), ("monotone", "bounds"),
                     ("monotone", "penalty", "bounds")):
            cons = {k: ops[k] for k in keys}
            k = ts.find_best_split(*args, site=s, **cons)
            k2 = ts.find_best_split(*args, site=s, **cons)
            q = ts.find_best_split_plain(*args, site=s, **cons)
            torch.cuda.synchronize()
            what = f"{ctx}, constrained ({'+'.join(keys)}, {s})"
            same_record(torch, k, q, what)
            for key in k:
                if not torch.equal(k[key], k2[key]):
                    fail(f"kernel S gave other bits on a repeat launch "
                         f"({what}: {key})")

    def call():
        return ts.find_best_split(*args, site=site, **ops)

    dev_ms, n_launch = profile_calls(call, 20, SPLIT_NAMES)
    if n_launch != 1:
        fail(f"kernel S made {n_launch} CUDA launches in one constrained "
             f"call, not 1 ({ctx})")
    ms = cuda_ms(call, reps=50)
    plain_ms = cuda_ms(lambda: ts.find_best_split_plain(
        *args, site=site, **ops), reps=5)
    b_ms, b_by = split_bound(hist, hist.shape[2], constrained=True)
    W = hist.shape[0]
    print(f"kernel S constrained ({ctx}, site {site}): the plain version's "
          f"records bit for bit at 3 sites x 3 operand sets, repeats the "
          f"same bits; {ms:.4f} ms a call back to back, device "
          f"{dev_ms:.4f} ms, {n_launch:g} launch a call (plain "
          f"{plain_ms:.3f}, bound {b_ms:.6f} by {b_by}) at W={W} F={F} "
          f"B={hist.shape[2]}", flush=True)
    return dict(max_abs_err=0.0, ms=ms, device_ms=dev_ms,
                launches_per_call=n_launch, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, site=site)


def wide_values(torch, g, dev, N):
    """Binary-logloss grad p - y and hess p(1 - p) at logits up to +-16:
    hessians reach about 1e-7, so a bucket's values span many exponents."""
    logit = (torch.rand(N, generator=g, device=dev) * 2 - 1) * 16
    prob = torch.sigmoid(logit)
    y = (torch.rand(N, generator=g, device=dev) < prob).float()
    return prob - y, prob * (1 - prob)


def hist_inputs(torch, dev, F, N, B, parts, values, seed, bin_dtype=None,
                idx_dtype=None):
    """Kernel H's arguments: random bins below ``B - 1``, a leaf vector
    whose ids are drawn uniformly from ``parts`` leaves (1: the root
    pass) with leaf 0 the one histogrammed, so about ``N / parts`` rows
    are in the leaf, in no particular order.  ``values``: "float" (grad
    N(0, 1), hess U(0.05, 1.05)), "integer" (quantized-like integers) or
    "wide" (binary-logloss grad p - y and hess p(1 - p) at logits up to
    +-16, so hessians reach about 1e-7)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bins = torch.randint(0, B - 1, (F, N), generator=g, device=dev,
                         dtype=torch.int32).to(bin_dtype or torch.uint8)
    if values == "integer":
        grad = torch.randint(-8, 9, (N,), generator=g, device=dev).float()
        hess = torch.randint(1, 5, (N,), generator=g, device=dev).float()
    elif values == "wide":
        grad, hess = wide_values(torch, g, dev, N)
    else:
        grad = torch.randn(N, generator=g, device=dev)
        hess = torch.rand(N, generator=g, device=dev) + 0.05
    mask = torch.ones(N, device=dev)
    leaf_idx = torch.randint(0, parts, (N,), generator=g, device=dev,
                             dtype=torch.int32).to(idx_dtype or torch.uint8)
    leaf_id = torch.zeros((), dtype=torch.int32, device=dev)
    return bins, grad, hess, mask, leaf_idx, leaf_id, B


def check_histogram(th, torch, args, ctx, integer):
    """Kernel H vs its plain version, and a repeat launch bit for bit;
    returns (max abs diff, max rel diff)."""
    k = th.masked_histogram(*args)
    k2 = th.masked_histogram(*args)
    p = th.masked_histogram_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(k, k2):
        fail(f"kernel H gave other bits on a repeat launch ({ctx})")
    diff = (k - p).abs()
    rel = diff / p.abs().clamp_min(1e-30)
    rel = torch.where(diff == 0, torch.zeros_like(rel), rel)
    if integer and float(diff.max()) != 0.0:
        fail(f"kernel H is not exact on integer inputs ({ctx}): max diff "
             f"{float(diff.max())}")
    if float(rel.max()) > 1e-5:
        fail(f"kernel H differs from plain ({ctx}): max rel diff "
             f"{float(rel.max())}")
    return float(diff.max()), float(rel.max())


def hist_bound(torch, args):
    """(kernel H's bound, rows in the leaf): every row's leaf id, the
    leaf's bins, grad, hess and mask, the output; per leaf row 2
    multiplies and 3 adds a feature."""
    bins, _, _, _, leaf_idx, leaf_id, B = args
    F, N = bins.shape
    rows = int((leaf_idx.to(torch.int32) == leaf_id).sum())
    return bound(N * leaf_idx.element_size() +
                 rows * (F * bins.element_size() + 12) + F * B * 3 * 4,
                 rows * (2 + 3 * F)), rows


def check_split(torch, ts, hist, parent, nb, mt, fm, p, ctx, depth=None,
                max_depth=0):
    """Kernel S vs its plain version: the same record, gains equal."""
    k = ts.find_best_split(hist, parent, nb, mt, fm, p, depth, max_depth)
    q = ts.find_best_split_plain(hist, parent, nb, mt, fm, p, depth,
                                 max_depth)
    torch.cuda.synchronize()
    return same_record(torch, k, q, ctx)


def check_split_streams(torch, ts, args, ctx):
    """Kernel S launched on two streams at once, 20 times each (each stream
    has its own completion counters): every record as the plain one."""
    q = ts.find_best_split_plain(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    recs = []
    for _ in range(20):
        recs.append(ts.find_best_split(*args))
        with torch.cuda.stream(side):
            recs.append(ts.find_best_split(*args))
    torch.cuda.synchronize()
    for k in recs:
        same_record(torch, k, q, ctx)


def same_record(torch, k, q, ctx):
    """Fails unless kernel S's record ``k`` is the plain record ``q``;
    returns the largest gain difference (0)."""
    for key in ("feature", "threshold", "default_left", "left_mask"):
        if not torch.equal(k[key], q[key]):
            fail(f"kernel S {key} differs from plain ({ctx}): "
                 f"{k[key].tolist() if k[key].dim() < 2 else ''} vs "
                 f"{q[key].tolist() if q[key].dim() < 2 else ''}")
    if not torch.equal(k["gain"], q["gain"]):
        fail(f"kernel S gain differs from plain ({ctx}): "
             f"{k['gain'].tolist()} vs {q['gain'].tolist()}")
    if not torch.allclose(k["left_stats"], q["left_stats"], rtol=1e-6,
                          atol=0):
        fail(f"kernel S left_stats differ from plain ({ctx})")
    return float((k["gain"] - q["gain"]).abs().max())


def check_lookup(torch, tl, dev, N, idx_dtype, seed, score_dtype=None):
    """Kernel L against its plain version, exactly, on a float32 score or
    (``score_dtype``) a float64 one."""
    g = torch.Generator(device=dev).manual_seed(seed)
    vals = torch.randn(255, generator=g, device=dev)
    idx = torch.randint(0, 255, (N,), generator=g, device=dev,
                        dtype=torch.int32).to(idx_dtype)
    score = torch.randn(N, generator=g, device=dev,
                        dtype=score_dtype or torch.float32)
    k = tl.take_small_add(score.clone(), vals, idx)
    q = tl.take_small_add_plain(score.clone(), vals, idx)
    torch.cuda.synchronize()
    if not torch.equal(k, q):
        fail(f"kernel L differs from plain (N={N}, {idx_dtype}, "
             f"{score.dtype})")
    return 0.0, (score, vals, idx)


def measure_lookup_f64(torch, tl, dev):
    """Kernel L's float64 mode (a validation set's score): exact against
    its plain version at ragged lengths and over 500k (the holdout) and
    10.5M rows with uint8 and int32 ids; ms, device ms and the bound (a
    row reads its id and its 8-byte score and writes the score: 17 bytes
    with uint8 ids, 20 with int32 ids) of each full-size case."""
    for seed, (n_, idt) in enumerate(
            [(n_, idt) for n_ in (1, 17, 100_003)
             for idt in (torch.int32, torch.uint8)], start=60):
        check_lookup(torch, tl, dev, n_, idt, seed, torch.float64)
    cases = []
    for n_ in (N_HOLDOUT, N_ROWS):
        for idt in (torch.uint8, torch.int32):
            err, (score, vals, idx) = check_lookup(
                torch, tl, dev, n_, idt, 70 + len(cases), torch.float64)

            def call():
                return tl.take_small_add(score, vals, idx)

            ms = cuda_ms(call, reps=50)
            dev_ms, n_launch = profile_calls(call, 20, LOOKUP_NAMES)
            if n_launch != 1:
                fail(f"kernel L (float64) made {n_launch} CUDA launches a "
                     f"call, not 1")
            plain = cuda_ms(lambda: tl.take_small_add_plain(score, vals,
                                                            idx), reps=10)
            idx64 = idx.to(torch.int64)
            lib = cuda_ms(lambda: vals[idx64], reps=50)
            b_ms, b_by = bound(n_ * (idx.element_size() + 16) +
                               vals.numel() * 4, n_)
            cases.append(dict(rows=n_, ids=str(idt).split(".")[-1],
                              max_abs_err=err, ms=ms, device_ms=dev_ms,
                              launches_per_call=n_launch, plain_ms=plain,
                              bound_ms=b_ms, bound_by=b_by, library_ms=lib))
            print(f"kernel L float64, N={n_} {idt}: exact; {ms:.4f} ms, "
                  f"device {dev_ms:.4f} ms (plain {plain:.3f}, vals[idx] "
                  f"{lib:.3f}, bound {b_ms:.4f} by {b_by})", flush=True)
            del score, idx, idx64
    # the kernels line: the holdout's shape as the valid scorer runs it
    # (uint8 ids from kernel T at 255 leaves), the others beside
    main = next(c for c in cases if c["rows"] == N_HOLDOUT and
                c["ids"] == "uint8")
    return dict(main, cases=cases)


# kernel R's edge tables; tests/test_torch_kernel_plans.py holds the
# plain version against the JAX package on the same cases
ROUTED_EDGE_CASES = ("missing, default left", "missing, default right",
                     "dummy lanes at 256", "a leaf in two lanes",
                     "int32 ids, leaf_bound 32768", "no row selected",
                     "coarse shift 3", "coarse shift 4")


def routed_edge_case(name, n, seed=0, F=5, W=16):
    """Kernel R's arguments for one edge case, as numpy arrays: bins (F,
    n) uint8 in 0..254 (254 is the missing bin of the even features),
    two-column int8 values, a leaf vector (uint8 ids below 40, or int32
    ids below 32768), 6-row lane tables, miss_bin, and the case's
    max_bin, width, leaf_bound and shift."""
    rng = np.random.RandomState(seed)
    miss_bin = np.full(F, -1, np.int32)
    miss_bin[::2] = 254
    bins = rng.randint(0, 255, size=(F, n)).astype(np.uint8)
    vals = np.stack([rng.randint(-120, 121, n), rng.randint(0, 121, n)],
                    -1).astype(np.int8)
    li = rng.randint(0, 40, n).astype(np.uint8)
    ids = rng.choice(40, W, replace=False)
    new = 40 + np.arange(W)
    leaf_bound, shift = 256, 0
    dl = rng.randint(0, 2, W)
    if name == "missing, default left":
        dl[:] = 1
    elif name == "missing, default right":
        dl[:] = 0
    elif name == "dummy lanes at 256":
        ids[-3:] = 256
    elif name == "a leaf in two lanes":
        ids[5] = ids[2]                  # the last lane listing it wins
    elif name == "int32 ids, leaf_bound 32768":
        li = rng.randint(0, 32768, n).astype(np.int32)
        ids = rng.choice(np.unique(li), W, replace=False)
        ids[-2:] = 32768
        new = 30000 + np.arange(W)
        leaf_bound = 32768
    elif name == "no row selected":
        ids[:] = 256
    elif name.startswith("coarse shift"):
        shift = int(name.split()[-1])
    elif name not in ROUTED_EDGE_CASES:
        raise ValueError(name)
    tables = np.stack([ids, rng.randint(0, F, W), rng.randint(0, 253, W),
                       new, rng.randint(0, 2, W), dl]).astype(np.int32)
    max_bin = (254 >> shift) + 2 if shift else 256
    return dict(bins=bins, vals=vals, leaf_idx=li, tables=tables,
                miss_bin=miss_bin, max_bin=max_bin, width=W,
                leaf_bound=leaf_bound, shift=shift)


def check_routed(torch, th, args, kw, exact, ctx):
    """Kernel R vs its plain version: the histogram exact (``exact``) or
    within rel 1e-5, leaf vector and selector exact, and a repeat launch
    bit for bit; returns (max abs, max rel) of the histogram."""
    plain_kw = {k: v for k, v in kw.items()
                if k not in ("want_sel", "leaf_bound")}
    kh, kl, ks = th.routed_histogram(*args, want_sel=True, **kw)
    kh2, kl2, ks2 = th.routed_histogram(*args, want_sel=True, **kw)
    qh, ql, qs = th.routed_histogram_plain(*args, **plain_kw)
    torch.cuda.synchronize()
    if not (torch.equal(kh, kh2) and torch.equal(kl, kl2) and
            torch.equal(ks, ks2)):
        fail(f"kernel R gave other bits on a repeat launch ({ctx})")
    if not (torch.equal(kl, ql) and torch.equal(ks, qs)):
        fail(f"kernel R routes otherwise than plain ({ctx}): leaf ids "
             f"{int((kl != ql).sum())}, sel {int((ks != qs).sum())}")
    diff = (kh - qh).abs()
    rel = torch.where(diff == 0, torch.zeros_like(diff),
                      diff / qh.abs().clamp_min(1e-30))
    if exact and float(diff.max()) != 0.0:
        fail(f"kernel R is not exact on integer values ({ctx}): max diff "
             f"{float(diff.max())}")
    if float(rel.max()) > 1e-5:
        fail(f"kernel R differs from plain ({ctx}): max rel "
             f"{float(rel.max())}")
    return float(diff.max()), float(rel.max())


def check_routed_edges(torch, th, dev):
    """Kernel R on every edge table, at a ragged length (a tail group and
    unaligned feature rows) and at a multiple of 16."""
    for n in (100_003, 65_536):
        for i, name in enumerate(ROUTED_EDGE_CASES):
            c = routed_edge_case(name, n, seed=40 + i)
            t = {k: torch.from_numpy(v).to(dev) for k, v in c.items()
                 if isinstance(v, np.ndarray)}
            args = (t["bins"], t["vals"], t["leaf_idx"], t["tables"],
                    c["max_bin"], c["width"], True)
            check_routed(torch, th, args,
                         dict(miss_bin=t["miss_bin"], shift=c["shift"],
                              leaf_bound=c["leaf_bound"]), True,
                         f"edge table: {name}, N={n}")
    print(f"kernel R edge tables: {len(ROUTED_EDGE_CASES)} cases at N=100003 "
          f"and N=65536, exact, repeat launches bit for bit", flush=True)


def phase_kernels(torch, dev):
    """Phase 2: each kernel against its plain version, and its timings."""
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import lookup as tl
    from lightgbm_tpu_torch.ops import split as ts
    F, N, B = N_FEATURES, N_ROWS, 256
    out = {}

    # ---- kernel H ---------------------------------------------------
    # ragged shapes: both bin types, both leaf-id types
    for i, (bdt, idt, parts, vals) in enumerate((
            (torch.uint8, torch.uint8, 255, "float"),
            (torch.uint8, torch.uint8, 1, "integer"),
            (torch.int16, torch.int32, 8, "integer"),
            (torch.int16, torch.uint8, 3, "wide"))):
        check_histogram(th, torch, hist_inputs(torch, dev, 3, 100_003, 64,
                                               parts, vals, 1 + i, bdt, idt),
                        f"F=3 N=100003 B=64 {bdt} bins {idt} ids 1/{parts} "
                        f"{vals}", vals == "integer")
    # full width at leaf densities 1 (the root pass), 1/8, 1/32 and 1/255,
    # float and integer values; wide-exponent float values at 1 and 1/255
    dens = []
    for parts in (1, 8, 32, 255):
        for vals in ("float", "integer", "wide"):
            if vals == "wide" and parts not in (1, 255):
                continue
            a = hist_inputs(torch, dev, F, N, B, parts, vals, 3 + parts)
            err, rel = check_histogram(th, torch, a,
                                       f"F={F} N={N} B={B} 1/{parts} {vals}",
                                       vals == "integer")
            ms = cuda_ms(lambda: th.masked_histogram(*a), reps=10)
            dev_ms, _ = profile_calls(lambda: th.masked_histogram(*a), 10,
                                      KERNEL_H_NAMES)
            (b_ms, b_by), rows = hist_bound(torch, a)
            dens.append(dict(density=f"1/{parts}", values=vals, rows=rows,
                             ms=ms, device_ms=dev_ms, bound_ms=b_ms,
                             bound_by=b_by, max_abs_err=err,
                             max_rel_err=rel))
            print(f"kernel H 1/{parts} {vals}: {rows} rows; max abs "
                  f"{err:.3g} max rel {rel:.3g}; {ms:.4f} ms, device "
                  f"{dev_ms:.4f} ms (bound {b_ms:.4f} by {b_by})",
                  flush=True)
            if parts == 1 and vals == "float":
                args, err_h, rel_h, ms_h, b_h = a, err, rel, ms, (b_ms, b_by)
                root_dev = dev_ms
            del a
    thin = next(d for d in dens if d["density"] == "1/255" and
                d["values"] == "float")
    bins, grad, hess, mask, leaf_idx, leaf_id, _ = args
    plain_h = cuda_ms(lambda: th.masked_histogram_plain(*args), reps=3)
    flat_ids = (bins.to(torch.int64) +
                torch.arange(F, device=dev)[:, None] * B).reshape(-1)
    flat_vals = torch.stack([grad, hess, mask], -1).repeat(F, 1)
    lib_out = torch.zeros(F * B, 3, device=dev)
    lib_h = cuda_ms(lambda: lib_out.zero_().index_add_(0, flat_ids,
                                                       flat_vals), reps=3)
    del flat_ids, flat_vals, lib_out
    out["histogram"] = dict(max_abs_err=err_h, ms=ms_h, plain_ms=plain_h,
                            bound_ms=b_h[0], bound_by=b_h[1],
                            library_ms=lib_h, by_density=dens)
    print(f"kernel H root pass: max abs {err_h:.3g} max rel {rel_h:.3g}; "
          f"{ms_h:.4f} ms (plain {plain_h:.3f}, index_add_ {lib_h:.3f}, "
          f"bound {b_h[0]:.4f} by {b_h[1]}) at F={F} N={N} B={B}; 1/255 "
          f"float at {thin['ms'] / ms_h:.4f} of the root pass "
          f"({thin['device_ms'] / root_dev:.4f} in device time)", flush=True)

    # ---- kernel S: the two children of a split at full width ---------
    # two leaf histograms of the full-width matrix, as the loop builds
    lidx = torch.randint(0, 2, (N,), device=dev,
                         dtype=torch.int32).to(torch.uint8)
    h0 = th.masked_histogram(bins, grad, hess, mask, lidx,
                             torch.zeros((), dtype=torch.int32, device=dev),
                             B)
    h1 = th.masked_histogram(bins, grad, hess, mask, lidx,
                             torch.ones((), dtype=torch.int32, device=dev),
                             B)
    hist = torch.stack([h0, h1]).contiguous()
    parent = hist[:, 0].sum(dim=1).contiguous()
    nb = torch.full((F,), B - 1, dtype=torch.int32, device=dev)
    mt = torch.zeros(F, dtype=torch.int32, device=dev)
    mt[::4] = 2                   # a missing bin on every fourth feature
    fm = torch.ones(F, dtype=torch.bool, device=dev)
    p = ts.SplitParams(max_bin=B, min_data_in_leaf=20,
                       min_sum_hessian_in_leaf=100.0, any_missing=True)
    err_s = check_split(torch, ts, hist, parent, nb, mt, fm, p, "full")
    # ragged: F=3, B=64, missing values, l1/l2/max_delta
    g = torch.Generator(device=dev).manual_seed(5)
    rb = torch.randint(0, 63, (3, 100_003), generator=g, device=dev,
                       dtype=torch.int32).to(torch.uint8)
    rg = torch.randn(100_003, generator=g, device=dev)
    rh = torch.rand(100_003, generator=g, device=dev) + 0.05
    rl = torch.randint(0, 3, (100_003,), generator=g, device=dev,
                       dtype=torch.int32).to(torch.uint8)
    rhist = torch.stack([
        th.masked_histogram(rb, rg, rh, torch.ones_like(rg), rl,
                            torch.tensor(i, dtype=torch.int32, device=dev),
                            64) for i in range(3)]).contiguous()
    rpar = rhist[:, 0].sum(dim=1).contiguous()
    rp = ts.SplitParams(max_bin=64, min_data_in_leaf=5, lambda_l1=0.1,
                        lambda_l2=1.0, max_delta_step=0.5, any_missing=True)
    check_split(torch, ts, rhist, rpar,
                torch.tensor([64, 40, 63], dtype=torch.int32, device=dev),
                torch.tensor([2, 0, 2], dtype=torch.int32, device=dev),
                torch.ones(3, dtype=torch.bool, device=dev), rp, "ragged")
    # the depth limit, as the growth loop passes it: lane 1 at max_depth
    dep = torch.tensor([3, 4], dtype=torch.int32, device=dev)
    check_split(torch, ts, hist, parent, nb, mt, fm, p, "full, max_depth 4",
                dep, 4)
    check_split(torch, ts, hist, parent, nb, mt, fm, p,
                "full, max_depth 4, one depth for both lanes", dep[1:], 4)
    check_split_streams(torch, ts, (hist, parent, nb, mt, fm, p, dep, 4),
                        "two streams at once")

    def call_s():
        return ts.find_best_split(hist, parent, nb, mt, fm, p, dep, 0)

    dev_s, n_launch = profile_calls(call_s, 50, SPLIT_NAMES)
    if n_launch != 1:
        fail(f"kernel S made {n_launch} CUDA launches in one call, not 1")
    ms_s = cuda_ms(call_s, reps=50)
    plain_s = cuda_ms(lambda: ts.find_best_split_plain(hist, parent, nb, mt,
                                                       fm, p, dep, 0),
                      reps=10)
    b_s = split_bound(hist, B)
    out["best_split"] = dict(max_abs_err=err_s, ms=ms_s, device_ms=dev_s,
                             launches_per_call=n_launch, plain_ms=plain_s,
                             bound_ms=b_s[0], bound_by=b_s[1],
                             library_ms=None)
    print(f"kernel S: gains equal, max_depth applied, two streams at once; "
          f"{ms_s:.4f} ms a call "
          f"back to back, device {dev_s:.4f} ms, {n_launch:g} launch a call "
          f"(plain {plain_s:.3f}, bound {b_s[0]:.6f} by {b_s[1]}) at W=2 "
          f"F={F} B={B}", flush=True)
    # the constrained mode at the exact loop's call, the depth limit on
    out["best_split_constrained"] = measure_split_constrained(
        torch, ts, hist, parent, nb, mt, fm, p, ts.LOOP, "W=2", 61, dep, 4)

    # ---- kernel L ---------------------------------------------------
    # ragged lengths (not multiples of 16, shorter than a warp's tile) and
    # a full-width int32 vector one row short of a multiple of 4
    cases = [(n_, idt) for n_ in (1, 17, 100_003, N - 1)
             for idt in (torch.int32, torch.uint8)]
    for seed, (n_, idt) in enumerate(cases, start=20):
        check_lookup(torch, tl, dev, n_, idt, seed)
    err_l, (score, vals, idx) = check_lookup(torch, tl, dev, N, torch.uint8,
                                             8)
    ms_l = cuda_ms(lambda: tl.take_small_add(score, vals, idx), reps=50)
    plain_l = cuda_ms(lambda: tl.take_small_add_plain(score, vals, idx),
                      reps=10)
    idx64 = idx.to(torch.int64)
    lib_l = cuda_ms(lambda: vals[idx64], reps=50)
    b_l = bound(N * (1 + 4 + 4) + vals.numel() * 4, N)
    out["leaf_lookup"] = dict(max_abs_err=err_l, ms=ms_l, plain_ms=plain_l,
                              bound_ms=b_l[0], bound_by=b_l[1],
                              library_ms=lib_l)
    print(f"kernel L: exact; {ms_l:.4f} ms (plain {plain_l:.3f}, vals[idx] "
          f"{lib_l:.3f}, bound {b_l[0]:.4f} by {b_l[1]}) at N={N}",
          flush=True)
    del score, idx, idx64
    out["leaf_lookup_f64"] = measure_lookup_f64(torch, tl, dev)
    out.update(phase_kernels_wave(torch, dev, th, ts, bins))
    return out


def _index_add_ms(torch, dev, cells, vals, sel, W, nb):
    """One ``index_add_`` over flattened (lane, feature, bin) ids: the
    one-call PyTorch yardstick of kernels M, V and V-lanes.  ``cells``
    (F, N): each row's bin in each feature, ``nb`` where it adds
    nowhere (a slot past the ``nb`` bins, as the plain versions use)."""
    F, N = cells.shape
    keep = torch.nonzero(sel >= 0).squeeze(1)
    s = sel.index_select(0, keep).to(torch.int64)
    ids = ((s[None, :] * F + torch.arange(F, device=dev)[:, None]) *
           (nb + 1) + cells.index_select(1, keep).to(torch.int64)
           ).reshape(-1)
    v = vals.index_select(0, keep).to(torch.float32).repeat(F, 1)
    acc = torch.zeros(W * F * (nb + 1), v.shape[1], device=dev)
    ms = cuda_ms(lambda: acc.zero_().index_add_(0, ids, v), reps=3)
    del ids, v, acc
    return ms


def check_against(torch, kernel, plain, exact, name, ctx):
    """``kernel()`` against ``plain()``: a repeat launch bit for bit, then
    exact (``exact``, integer values) or within rel 1e-5; returns (max
    abs, max rel)."""
    k = kernel()
    k2 = kernel()
    q = plain()
    torch.cuda.synchronize()
    if not torch.equal(k, k2):
        fail(f"kernel {name} gave other bits on a repeat launch ({ctx})")
    diff = (k - q).abs()
    rel = torch.where(diff == 0, torch.zeros_like(diff),
                      diff / q.abs().clamp_min(1e-30))
    if exact and float(diff.max()) != 0.0:
        fail(f"kernel {name} is not exact on integer values ({ctx}): max "
             f"diff {float(diff.max())}")
    if float(rel.max()) > 1e-5:
        fail(f"kernel {name} differs from plain ({ctx}): max rel "
             f"{float(rel.max())}")
    return float(diff.max()), float(rel.max())


def check_multi(torch, th, bins, vals, sel, W, B, two_col, exact, ctx,
                shift=0, miss_bin=None):
    """Kernel M vs its plain version, and a repeat launch bit for bit;
    returns (max abs, max rel)."""
    args = (bins, vals, sel, B, W, two_col, shift, miss_bin)
    return check_against(torch, lambda: th.multi_histogram(*args),
                         lambda: th.multi_histogram_plain(*args), exact, "M",
                         ctx)


def check_launches_a_call(torch, fn, names, want, what):
    """(device ms of one call, CUDA launches a call) from the profiler;
    fails unless the call makes ``want`` launches."""
    dev_ms, n_launch = profile_calls(fn, 10, names)
    if n_launch != want:
        fail(f"kernel {what} made {n_launch} CUDA launches in one call, not "
             f"{want}")
    return dev_ms, n_launch


def measure_multi_root(torch, th, dev, bins, qv, B, shift, miss_bin, mode):
    """Kernel M's root pass as the growth loops launch it (one lane, every
    row in it: ``sel0``, two-column int8), exact against its plain
    version with a repeat launch bit for bit; its time, device time,
    launches a call (2), plain and ``index_add_`` times and bound."""
    F, N = bins.shape
    sel0 = torch.zeros(N, dtype=torch.int8, device=dev)
    args = (bins, qv, sel0, B, 1, True, shift, miss_bin)
    err, _ = check_multi(torch, th, bins, qv, sel0, 1, B, True, True,
                         f"{mode} root pass", shift, miss_bin)

    def call():
        return th.multi_histogram(*args)

    ms = cuda_ms(call, reps=10)
    dev_ms, n_launch = check_launches_a_call(torch, call, MULTI_NAMES, 2,
                                             f"M ({mode} root pass)")
    plain = cuda_ms(lambda: th.multi_histogram_plain(*args), reps=2)
    cells = bins
    if shift:
        b64 = bins.to(torch.int64)
        cells = torch.where(b64 == miss_bin.to(torch.int64)[:, None], B - 1,
                            b64 >> shift)
    lib = _index_add_ms(torch, dev, cells, qv, sel0, 1, B)
    del cells
    # needs: every row's bins, values and selector, the output; one integer
    # add per (row, feature, column)
    b = bound(N * F + N * 2 + N + F * B * 3 * 4, N * F * 2)
    print(f"kernel M {mode} root pass (W=1, two-column int8, shift "
          f"{shift}): exact, repeat launch bit for bit; {ms:.4f} ms, device {dev_ms:.4f} ms, {n_launch:g} launches a "
          f"call (plain {plain:.3f}, index_add_ {lib:.3f}, bound {b[0]:.4f} by "
          f"{b[1]}) at F={F} N={N} B={B}", flush=True)
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                launches_per_call=n_launch, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=lib)


def measure_multi_w42(torch, th, dev, g, bins, B):
    """Kernel M at a categorical wave's launch (phase 14): W = 42 lanes,
    three int8 columns, an int8 selector (the routing outside the pass
    writes it: no narrowing launch), 256 padded bins — exact against its
    plain version with a repeat launch bit for bit; its time, device
    time, launches a call (2), plain and ``index_add_`` times and
    bound."""
    F, N = bins.shape
    qv = torch.stack([
        torch.randint(-120, 121, (N,), generator=g, device=dev,
                      dtype=torch.int32),
        torch.randint(0, 121, (N,), generator=g, device=dev,
                      dtype=torch.int32),
        torch.ones(N, device=dev, dtype=torch.int32)], -1).to(
            torch.int8).contiguous()
    sel = torch.randint(-1, 42, (N,), generator=g, device=dev,
                        dtype=torch.int32).to(torch.int8)
    err, _ = check_multi(torch, th, bins, qv, sel, 42, B, False, True,
                         "W=42 three-column int8, int8 sel")

    def call():
        return th.multi_histogram(bins, qv, sel, B, 42, False)

    ms = cuda_ms(call, reps=10)
    dev_ms, n_launch = check_launches_a_call(torch, call, MULTI_NAMES, 2,
                                             "M (W=42 three-column)")
    plain = cuda_ms(lambda: th.multi_histogram_plain(bins, qv, sel, B, 42,
                                                     False), reps=2)
    lib = _index_add_ms(torch, dev, bins, qv, sel, 42, B)
    n_sel = int((sel >= 0).sum())
    # needs: the bins and values of the selected rows, every selector,
    # the output; one integer add per (selected row, feature, column)
    b = bound(n_sel * F + n_sel * 3 + N + 42 * F * B * 3 * 4,
              n_sel * F * 3)
    print(f"kernel M (W=42 three-column int8, int8 sel): exact, repeat "
          f"launch bit for bit; {ms:.4f} ms, device {dev_ms:.4f} ms, "
          f"{n_launch:g} launches a call (plain {plain:.3f}, index_add_ "
          f"{lib:.3f}, bound {b[0]:.4f} by {b[1]}) at F={F} N={N} B={B}",
          flush=True)
    return dict(w42_3col_max_abs_err=err, w42_3col_ms=ms,
                w42_3col_device_ms=dev_ms, w42_3col_launches_per_call=n_launch,
                w42_3col_plain_ms=plain, w42_3col_index_add_ms=lib,
                w42_3col_bound_ms=b[0], w42_3col_bound_by=b[1])


def measure_categorical_scan(torch, ts, hist, parent, B):
    """The merged scan of a categorical wave's 2W = 84 children (phase
    14's shape; features 0-3 categorical with 12 value bins and no missing
    bin, the rest numerical with a missing bin): kernel S on the
    numerical features, the plain categorical scan on the rest, one merge
    — the record of the plain merged scan on the CPU copies (feature,
    kind, left mask and gain bit for bit), over every feature and over
    the categorical ones alone; the merged call's time and the CUDA
    kernels of one call (kernel S one of them)."""
    dev = hist.device
    F = hist.shape[1]
    is_cat = torch.zeros(F, dtype=torch.bool, device=dev)
    is_cat[:4] = True
    nb = torch.where(is_cat, 12, B - 1).to(torch.int32)
    mt = torch.where(is_cat, 0, 2).to(torch.int32)
    p = ts.SplitParams(max_bin=B, min_data_in_leaf=0,
                       min_sum_hessian_in_leaf=100.0, any_missing=True,
                       any_cat=True)
    hist = hist.contiguous()
    parent = parent.contiguous()
    n_cat = {}
    for what, fm in (("every feature", torch.ones_like(is_cat)),
                     ("categorical features", is_cat.clone())):
        k = ts.find_best_split(hist, parent, nb, mt, fm, p, None, 0, is_cat)
        q = ts.find_best_split_plain(
            *(t.cpu() for t in (hist, parent, nb, mt, fm)), p,
            is_cat=is_cat.cpu())
        torch.cuda.synchronize()
        for key in ("feature", "is_cat", "default_left", "left_mask",
                    "gain"):
            if not torch.equal(k[key].cpu(), q[key]):
                fail(f"the merged scan's {key} on the card differs from "
                     f"the CPU's ({what})")
        n_cat[what] = int((k["is_cat"] & (k["gain"] > 0)).sum())
    if n_cat["categorical features"] == 0:
        fail("the categorical scan found no split on its test histograms")
    fm = torch.ones_like(is_cat)

    def call():
        return ts.find_best_split(hist, parent, nb, mt, fm, p, None, 0,
                                  is_cat)

    ms = cuda_ms(call, reps=20)
    dev_s, n_launch = profile_calls(call, 20, SPLIT_NAMES, whole=False)
    print(f"merged scan (2W=84 children, 4 categorical features): the CPU's "
          f"records bit for bit (categorical splits {n_cat}); {ms:.4f} ms a "
          f"call (kernel S's device time {dev_s:.4f} ms, {n_launch:g} CUDA "
          f"kernels a call)", flush=True)
    return dict(ms=ms, kernel_s_device_ms=dev_s,
                cuda_kernels_per_call=n_launch, categorical_splits=n_cat)


def check_multi_float(torch, th, g, dev, bins, B, shift, miss_bin, mode):
    """Kernel M at W=21 on float values: N(0, 1) and U(0.05, 1.05), then
    wide-exponent ones, within rel 1e-5 of plain with a repeat launch bit
    for bit; returns (ms, max rel, wide max rel)."""
    F, N = bins.shape
    fv = torch.stack([torch.randn(N, generator=g, device=dev),
                      torch.rand(N, generator=g, device=dev) + 0.05,
                      torch.ones(N, device=dev)], -1).contiguous()
    fsel = torch.randint(-1, 21, (N,), generator=g, device=dev,
                         dtype=torch.int32)
    _, rel = check_multi(torch, th, bins, fv, fsel, 21, B, False, False,
                         f"{mode} W=21 float", shift, miss_bin)
    ms = cuda_ms(lambda: th.multi_histogram(bins, fv, fsel, B, 21, False,
                                            shift, miss_bin), reps=5)
    fv[:, 0], fv[:, 1] = wide_values(torch, g, dev, N)
    _, rel_w = check_multi(torch, th, bins, fv, fsel, 21, B, False, False,
                           f"{mode} W=21 wide-exponent float", shift,
                           miss_bin)
    return ms, rel, rel_w


def measure_routed(torch, th, dev, g, bins, qv, li, tbl, miss_bin, B,
                   shift, mode):
    """Kernel R at a W=64 wave (two-column int8, exact) and at W=21 with
    float values (the wave's first 21 lanes, rel 1e-5; N(0, 1) and U(0.05,
    1.05) values, and wide-exponent ones), each against its plain version
    with a repeat launch bit for bit; times, device time, launches a call
    and the bound of the W=64 wave."""
    F, N = bins.shape
    W = tbl.shape[1]
    kw = dict(miss_bin=miss_bin, shift=shift)
    args = (bins, qv, li, tbl, B, W, True)
    err, _ = check_routed(torch, th, args, kw, True,
                          f"{mode}, W={W} two-column int8")
    fv = torch.stack([torch.randn(N, generator=g, device=dev),
                      torch.rand(N, generator=g, device=dev) + 0.05,
                      torch.ones(N, device=dev)], -1).contiguous()
    fargs = (bins, fv, li, tbl[:, :21].contiguous(), B, 21, False)
    _, rel_f = check_routed(torch, th, fargs, kw, False,
                            f"{mode}, W=21 float")
    ms_f = cuda_ms(lambda: th.routed_histogram(*fargs, **kw), reps=5)
    fv[:, 0], fv[:, 1] = wide_values(torch, g, dev, N)
    _, rel_w = check_routed(torch, th, fargs, kw, False,
                            f"{mode}, W=21 wide-exponent float")
    del fv, fargs

    def call_r():
        return th.routed_histogram(*args, **kw)

    dev_ms, n_launch = profile_calls(call_r, 10, ROUTED_NAMES)
    if n_launch != 3:
        fail(f"kernel R made {n_launch} CUDA launches in one call, not 3")
    ms = cuda_ms(call_r, reps=10)
    plain = cuda_ms(lambda: th.routed_histogram_plain(*args, **kw), reps=2)
    sel = th.routed_histogram(*args, want_sel=True, **kw)[2]
    n_wave = int(torch.isin(li.to(torch.int32), tbl[0]).sum())
    n_sel = int((sel >= 0).sum())
    # needs: the leaf ids, one split bin per row of the wave, the bins and
    # values of the selected rows; writes the leaf ids and the histogram
    b = bound(N + n_wave + N + n_sel * F + n_sel * 2 + W * F * B * 3 * 4,
              n_sel * F * 2)
    # what the feature-major bins let a pass read at best: every 32-byte
    # sector of bins (and of values) that holds a selected row
    full = N // 32 * 32
    sect = int((sel[:full].reshape(-1, 32) >= 0).any(1).sum()) + \
        int(bool((sel[full:] >= 0).any()))
    floor_ms = bound(N + n_wave + N + sect * 32 * F + n_sel * 2 +
                     W * F * B * 3 * 4, 0)[0]
    print(f"kernel R {mode} (W={W}, 6-row tables, shift {shift}): hist, leaf "
          f"ids and sel exact, repeat launch bit for bit; W=21 float max rel "
          f"{rel_f:.3g}, {ms_f:.4f} ms, wide-exponent float max rel "
          f"{rel_w:.3g}; {ms:.4f} ms, device {dev_ms:.4f} ms, "
          f"{n_launch:g} launches a call (plain {plain:.3f}, bound {b[0]:.4f} "
          f"by {b[1]}, sector floor {floor_ms:.4f}) at F={F} N={N} B={B} "
          f"selected {n_sel}", flush=True)
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                launches_per_call=n_launch, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=None,
                float_w21_ms=ms_f, float_w21_max_rel_err=rel_f,
                float_w21_wide_max_rel_err=rel_w)


def check_leaf(torch, th, args, exact, ctx):
    """Kernel Q vs its plain version: a repeat launch bit for bit, then
    exact (``exact``) or within rel 1e-6; returns (max abs, max rel)."""
    k = th.leaf_stats(*args)
    k2 = th.leaf_stats(*args)
    q = th.leaf_stats_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(k, k2):
        fail(f"kernel Q gave other bits on a repeat launch ({ctx})")
    diff = (k - q).abs()
    rel = torch.where(diff == 0, torch.zeros_like(diff),
                      diff / q.abs().clamp_min(1e-30))
    if exact and float(diff.max()) != 0.0:
        fail(f"kernel Q differs from plain ({ctx}): max diff "
             f"{float(diff.max())}")
    if float(rel.max()) > 1e-6:
        fail(f"kernel Q differs from plain ({ctx}): max rel "
             f"{float(rel.max())}")
    return float(diff.max()), float(rel.max())


def measure_leaf_stats(torch, th, dev, g, N):
    """Kernel Q over N rows: exact against its plain version at L = 255, 7
    and 31 on uint8 ids and at L = 1000 on int32 ids (grad N(0, 1), hess
    U(0, 1), a 0/1 mask), wide-exponent grad and hess within rel 1e-6,
    each with a repeat launch bit for bit; its time, device time, CUDA
    launches a call, plain and ``index_add_`` times and bound at L=255."""
    lq = torch.randint(0, 255, (N,), generator=g, device=dev,
                       dtype=torch.int32).to(torch.uint8)
    gq = torch.randn(N, generator=g, device=dev)
    hq = torch.rand(N, generator=g, device=dev)
    mq = (torch.rand(N, generator=g, device=dev) < 0.9).float()
    for L_ in (255, 7, 31):
        lidx = lq if L_ == 255 else (lq % L_).contiguous()
        check_leaf(torch, th, (lidx, gq, hq, mq, L_), True,
                   f"L={L_} uint8 ids")
    l32 = torch.randint(0, 1000, (N,), generator=g, device=dev,
                        dtype=torch.int32)
    check_leaf(torch, th, (l32, gq, hq, mq, 1000), True, "L=1000 int32 ids")
    del l32
    wg, wh = wide_values(torch, g, dev, N)
    _, rel_w = check_leaf(torch, th, (lq, wg, wh, mq, 255), False,
                          "L=255 wide-exponent grad and hess")
    del wg, wh

    def call():
        return th.leaf_stats(lq, gq, hq, mq, 255)

    ms = cuda_ms(call, reps=20)
    dev_ms, n_launch = check_launches_a_call(torch, call, LEAF_NAMES, 3,
                                             "Q (L=255)")
    sum_ms, _ = profile_calls(call, 10, ("leaf_stats_kernel",))
    bound_launch_ms, _ = profile_calls(call, 10, ("leaf_bound_kernel",))
    plain = cuda_ms(lambda: th.leaf_stats_plain(lq, gq, hq, mq, 255),
                    reps=5)
    lq64 = lq.to(torch.int64)
    vq = torch.stack([gq * mq, hq * mq, mq], -1)
    acc = torch.zeros(255, 3, device=dev)
    lib = cuda_ms(lambda: acc.zero_().index_add_(0, lq64, vq), reps=10)
    # needs: each row's leaf id, grad, hess and mask, the output; two
    # multiplies and three adds a row
    b = bound(N * (1 + 4 * 3) + 255 * 3 * 4, N * 5)
    print(f"kernel Q: exact at L=255, 7, 31 (uint8 ids) and L=1000 (int32 "
          f"ids), wide-exponent max rel {rel_w:.3g}, repeat launches bit "
          f"for bit; {ms:.4f} ms, device {dev_ms:.4f} ms (sums "
          f"{sum_ms:.4f}, bounds {bound_launch_ms:.4f}), {n_launch:g} "
          f"launches a call (plain {plain:.3f}, index_add_ {lib:.3f}, bound "
          f"{b[0]:.4f} by {b[1]}) at N={N} L=255", flush=True)
    del lq, gq, hq, mq, lq64, vq, acc
    return dict(max_abs_err=0.0, ms=ms, device_ms=dev_ms,
                launches_per_call=n_launch, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=lib, wide_max_rel_err=rel_w,
                sum_launch_device_ms=sum_ms,
                bound_launch_device_ms=bound_launch_ms)


def phase_kernels_wave(torch, dev, th, ts, bins):
    """Phase 2, wave-growth kernels M, R, Q (and S at the wave's 2W
    children) against their plain versions at full width."""
    F, N = bins.shape
    B = 256
    out = {}
    g = torch.Generator(device=dev).manual_seed(11)

    # ---- kernel M ---------------------------------------------------
    # ragged: 3 features x 100,003 rows, int16 bins, both selector types
    rb = torch.randint(0, 63, (3, 100_003), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int16)
    rv = torch.randint(-120, 121, (100_003, 3), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int8)
    rs = torch.randint(-1, 42, (100_003,), generator=g, device=dev,
                       dtype=torch.int32)
    check_multi(torch, th, rb, rv, rs, 42, 64, False, True, "ragged int16")
    check_multi(torch, th, rb, rv[:, :2].contiguous(), rs.to(torch.int8), 42,
                64, True, True, "ragged int8 sel")
    # full width, quantized two-column, W = 64 (a wave's width)
    qv = torch.stack([
        torch.randint(-120, 121, (N,), generator=g, device=dev,
                      dtype=torch.int32),
        torch.randint(0, 121, (N,), generator=g, device=dev,
                      dtype=torch.int32)], -1).to(torch.int8).contiguous()
    sel = torch.randint(-1, 64, (N,), generator=g, device=dev,
                        dtype=torch.int32)
    check_multi(torch, th, bins, qv, sel, 64, B, True, True,
                "W=64 two-column int8")
    ms_w = cuda_ms(lambda: th.multi_histogram(bins, qv, sel, B, 64, True),
                   reps=10)
    plain_w = cuda_ms(lambda: th.multi_histogram_plain(bins, qv, sel, B, 64,
                                                       True), reps=2)
    lib_w = _index_add_ms(torch, dev, bins, qv, sel, 64, B)
    n_sel = int((sel >= 0).sum())
    # needs: the bins and values of the selected rows, every selector,
    # the output; one integer add per (selected row, feature, column)
    b_w = bound(n_sel * F + n_sel * 2 + N * 4 + 64 * F * B * 3 * 4,
                n_sel * F * 2)
    print(f"kernel M (W=64 two-column int8, int32 sel): exact; {ms_w:.4f} ms "
          f"(plain {plain_w:.3f}, index_add_ {lib_w:.3f}, bound "
          f"{b_w[0]:.4f} by {b_w[1]}) at F={F} N={N} B={B}", flush=True)
    # the root pass at full resolution: the no-c2f path's launch of M
    out["multi_histogram"] = measure_multi_root(torch, th, dev, bins, qv, B,
                                                0, None, "full")
    out["multi_histogram"].update(w64_ms=ms_w, w64_plain_ms=plain_w,
                                  w64_index_add_ms=lib_w,
                                  w64_bound_ms=b_w[0])
    out["multi_histogram"].update(measure_multi_w42(torch, th, dev, g,
                                                    bins, B))
    ms_f, rel_f, rel_fw = check_multi_float(torch, th, g, dev, bins, B, 0,
                                            None, "full")
    out["multi_histogram"].update(float_w21_ms=ms_f,
                                  float_w21_max_rel_err=rel_f,
                                  float_w21_wide_max_rel_err=rel_fw)
    print(f"kernel M (W=21 float): max rel {rel_f:.3g}, wide-exponent "
          f"{rel_fw:.3g}, repeat launches bit for bit; {ms_f:.4f} ms",
          flush=True)

    # ---- kernel R: a wave of 64 splits with missing-value routing -----
    li = torch.randint(0, 127, (N,), generator=g, device=dev,
                       dtype=torch.int32).to(torch.uint8)
    ids = torch.randperm(127, generator=g, device=dev)[:64].to(torch.int32)
    ids[60:] = 127                                  # dummy lanes
    miss_bin = torch.full((F,), -1, dtype=torch.int32, device=dev)
    miss_bin[::4] = B - 2                           # bin 254 is missing
    tbl = torch.stack([
        ids,
        torch.randint(0, F, (64,), generator=g, device=dev,
                      dtype=torch.int32),
        torch.randint(0, B - 3, (64,), generator=g, device=dev,
                      dtype=torch.int32),
        torch.arange(127, 191, device=dev, dtype=torch.int32),
        torch.randint(0, 2, (64,), generator=g, device=dev,
                      dtype=torch.int32),
        torch.randint(0, 2, (64,), generator=g, device=dev,
                      dtype=torch.int32)]).contiguous()
    out["routed_histogram"] = measure_routed(
        torch, th, dev, g, bins, qv, li, tbl, miss_bin, B, 0, "full")
    check_routed_edges(torch, th, dev)

    # ---- kernel S at the wave's 2W = 128 children, counts proxy -------
    ch = th.multi_histogram(bins, qv, sel, B, 64, True)
    ch = torch.cat([ch, ch.flip(0)]).contiguous() * 0.01
    par = ch[:, 0].sum(dim=1).contiguous()
    nb = torch.full((F,), B - 1, dtype=torch.int32, device=dev)
    mt = torch.zeros(F, dtype=torch.int32, device=dev)
    mt[::4] = 2
    fm = torch.ones(F, dtype=torch.bool, device=dev)
    pw = ts.SplitParams(max_bin=B, min_data_in_leaf=0,
                        min_sum_hessian_in_leaf=100.0, any_missing=True,
                        counts_proxy=True)
    dep = torch.ones(128, dtype=torch.int32, device=dev)
    check_split(torch, ts, ch, par, nb, mt, fm, pw, "W=128 counts proxy")

    def call_s():
        return ts.find_best_split(ch, par, nb, mt, fm, pw, dep, 0)

    ms_s = cuda_ms(call_s, reps=20)
    dev_s, n_launch = profile_calls(call_s, 20, SPLIT_NAMES)
    b_s = split_bound(ch, B)
    if n_launch != 1:
        fail(f"kernel S made {n_launch} CUDA launches in one call, not 1")
    out["best_split_2w"] = dict(ms=ms_s, device_ms=dev_s,
                                launches_per_call=n_launch, bound_ms=b_s[0],
                                bound_by=b_s[1])
    print(f"kernel S (2W=128 children, counts proxy): identical to plain; "
          f"{ms_s:.4f} ms, device {dev_s:.4f} ms, {n_launch:g} launch a call "
          f"(bound {b_s[0]:.5f} by {b_s[1]})", flush=True)
    out["best_split_constrained_2w"] = measure_split_constrained(
        torch, ts, ch, par, nb, mt, fm, pw, ts.WAVE, "2W=128 counts proxy",
        62, dep, 6)
    out["categorical_scan"] = measure_categorical_scan(torch, ts, ch[:84],
                                                       par[:84], B)
    del ch

    # ---- kernel Q ---------------------------------------------------
    out["leaf_stats"] = measure_leaf_stats(torch, th, dev, g, N)
    out.update(phase_kernels_c2f(torch, dev, th, bins, qv, g))
    return out


def _lanes_windows(torch, g, dev, W, F, Bc, shift):
    """(W, F) window starts on coarse boundaries, features 0 and 1 at the
    two edges (the first window, and the last one below the missing
    slot)."""
    lo = (torch.randint(0, Bc - 2, (W, F), generator=g, device=dev,
                        dtype=torch.int32) << shift).contiguous()
    lo[:, 0] = 0
    lo[:, 1] = (Bc - 3) << shift
    return lo


def measure_lanes(torch, th, dev, bins, qv, leaf, lane_ids, is_miss,
                  miss_bin, Bc, shift, R, g, b64):
    """Kernel V-lanes over ``lane_ids`` (W = 64: a window group; 128: a
    wave's 2W children in one call) on a uint8 leaf vector: exact against
    its plain version with a repeat launch bit for bit, launches a call
    (2), times, bound and sector floor."""
    F, N = bins.shape
    W = lane_ids.shape[0]
    lo = _lanes_windows(torch, g, dev, W, F, Bc, shift)
    args = (bins, qv, leaf, lane_ids, lo, R, W, True, miss_bin)
    check_against(torch, lambda: th.lanes_window_histogram(*args),
                  lambda: th.lanes_window_histogram_plain(*args), True,
                  "V-lanes", f"W={W} uint8 leaf vector")

    def call():
        return th.lanes_window_histogram(*args)

    ms = cuda_ms(call, reps=10)
    dev_ms, n_launch = check_launches_a_call(torch, call, LANES_NAMES, 2,
                                             f"V-lanes (W={W})")
    plain = cuda_ms(lambda: th.lanes_window_histogram_plain(*args), reps=2)
    lane = th._lanes_of(leaf, lane_ids, W)
    safe = lane.clamp(min=0)
    rb = b64 - lo.to(torch.int64).t()[:, safe]      # (F, N)
    in_win = (rb >= 0) & (rb < R) & ~is_miss & (lane >= 0)[None, :]
    lib = _index_add_ms(torch, dev, torch.where(in_win, rb, R), qv, lane, W,
                        R)
    n_lane = int((lane >= 0).sum())
    # needs: every row's leaf id, the lanes' rows' bins and values, the
    # lane ids and window starts, the output; an add per in-window value
    b = bound(N + n_lane * F + n_lane * 2 + W * 4 * (F + 1) +
              W * F * R * 3 * 4, int(in_win.sum()) * 2)
    # what the feature-major bins let a pass read at best: every 32-byte
    # sector of bins that holds a lane row
    full = N // 32 * 32
    sect = int((lane[:full].reshape(-1, 32) >= 0).any(1).sum()) + \
        int(bool((lane[full:] >= 0).any()))
    floor_ms = bound(N + sect * 32 * F + n_lane * 2 + W * 4 * (F + 1) +
                     W * F * R * 3 * 4, 0)[0]
    print(f"kernel V-lanes (W={W}, uint8 leaf vector, 4 dummy lanes, "
          f"windows at both edges): exact, repeat launch bit for bit; "
          f"{ms:.4f} ms, device {dev_ms:.4f} ms, {n_launch:g} launches a call "
          f"(plain {plain:.3f}, index_add_ {lib:.3f}, bound {b[0]:.4f} by "
          f"{b[1]}, sector floor {floor_ms:.4f}) at F={F} N={N} rows in lanes "
          f"{n_lane}", flush=True)
    del rb, in_win, lane, safe
    return dict(max_abs_err=0.0, ms=ms, device_ms=dev_ms,
                launches_per_call=n_launch, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=lib, sector_floor_ms=floor_ms,
                rows_in_lanes=n_lane)


def check_lanes_edges(torch, th, dev, g, Bc, shift, R):
    """Kernel V-lanes at a ragged length: int32 leaf ids at leaf bound
    32768 (a lane on leaf 32767, dummies at 32768) and uint8 ids with
    dummies at 256, 64 and 128 lanes, two-column int8 exact; and float
    values (W=21, three columns, then wide-exponent ones) within rel 1e-5,
    each with a repeat launch bit for bit."""
    F, N = 5, 100_003
    bins = torch.randint(0, 255, (F, N), generator=g, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    miss_bin = torch.tensor([254, -1, 254, -1, -1], dtype=torch.int32,
                            device=dev)
    qv = torch.randint(-120, 121, (N, 2), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int8)
    for W in (64, 128):
        for idx, bound_ in ((torch.int32, 32768), (torch.uint8, 256)):
            leaf = torch.randint(0, bound_, (N,), generator=g, device=dev,
                                 dtype=torch.int32)
            ids = torch.randperm(bound_, generator=g, device=dev)[:W].to(
                torch.int32)
            ids[0] = bound_ - 1
            leaf[::7] = bound_ - 1
            ids[-3:] = bound_                        # dummy lanes
            pick = torch.randint(0, W - 3, (N,), generator=g, device=dev)
            hit = torch.rand(N, generator=g, device=dev) < 0.3
            leaf = torch.where(hit, ids[pick], leaf).to(idx).contiguous()
            lo = _lanes_windows(torch, g, dev, W, F, Bc, shift)
            args = (bins, qv, leaf, ids, lo, R, W, True, miss_bin)
            check_against(
                torch,
                lambda: th.lanes_window_histogram(*args,
                                                  leaf_bound=bound_),
                lambda: th.lanes_window_histogram_plain(*args), True,
                "V-lanes", f"W={W}, {idx} leaf ids, bound {bound_}, N={N}")
    W = 21
    leaf = torch.randint(0, 255, (N,), generator=g, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    ids = torch.randperm(255, generator=g, device=dev)[:W].to(torch.int32)
    lo = _lanes_windows(torch, g, dev, W, F, Bc, shift)
    fv = torch.stack([torch.randn(N, generator=g, device=dev),
                      torch.rand(N, generator=g, device=dev) + 0.05,
                      torch.ones(N, device=dev)], -1).contiguous()
    rels = []
    for kind in ("float", "wide-exponent float"):
        if kind != "float":
            fv[:, 0], fv[:, 1] = wide_values(torch, g, dev, N)
        args = (bins, fv, leaf, ids, lo, R, W, False, miss_bin)
        rels.append(check_against(
            torch, lambda: th.lanes_window_histogram(*args),
            lambda: th.lanes_window_histogram_plain(*args), False, "V-lanes",
            f"W={W} {kind}")[1])
    print(f"kernel V-lanes edges: int32 ids at bound 32768 and uint8 ids, "
          f"W=64 and 128, N={N}: exact; W=21 float max rel {rels[0]:.3g}, "
          f"wide-exponent {rels[1]:.3g}; repeat launches bit for bit",
          flush=True)


def measure_window(torch, th, dev, g, bins, qv, sel0, is_miss, miss_bin, Bc,
                   shift, R, b64):
    """Kernel V at the root's window as the c2f loop launches it (W = 1,
    every row in lane 0: the int8 ``sel0``, two-column int8 values,
    windows at both edges): exact against its plain version with a repeat
    launch bit for bit, its time, device time, launches a call (2), plain
    and ``index_add_`` times, bound and sector floor.  Beside it: float
    values at W = 1 (3 launches a call) and W = 21, then wide-exponent
    ones, within rel 1e-5 and repeated bit for bit; two-column int8 at
    W = 64 through an int32 selector, exact (3 launches a call: the
    narrowing first)."""
    F, N = bins.shape
    lo0 = _lanes_windows(torch, g, dev, 1, F, Bc, shift)
    args = (bins, qv, sel0, lo0, R, 1, True, miss_bin)
    check_against(torch, lambda: th.window_histogram(*args),
                  lambda: th.window_histogram_plain(*args), True, "V",
                  "the root's window, W=1 two-column int8")

    def call():
        return th.window_histogram(*args)

    ms = cuda_ms(call, reps=10)
    dev_ms, n_launch = check_launches_a_call(torch, call, WINDOW_NAMES, 2,
                                             "V (the root's window)")
    plain = cuda_ms(lambda: th.window_histogram_plain(*args), reps=2)
    rb = b64 - lo0[0].to(torch.int64)[:, None]
    in_win = (rb >= 0) & (rb < R) & ~is_miss
    lib = _index_add_ms(torch, dev, torch.where(in_win, rb, R), qv, sel0, 1,
                        R)
    # every row's bin is read to place it; values and selector of every
    # row; one add per (in-window row, feature, column).  Every row is in
    # the lane, so every 32-byte sector of bins is needed: the sector
    # floor is the bound.
    b = bound(N * F + N * 2 + N + F * 4 + F * R * 3 * 4,
              int(in_win.sum()) * 2)
    del rb, in_win
    fv = torch.stack([torch.randn(N, generator=g, device=dev),
                      torch.rand(N, generator=g, device=dev) + 0.05,
                      torch.ones(N, device=dev)], -1).contiguous()
    fargs = (bins, fv, sel0, lo0, R, 1, False, miss_bin)
    _, rel_f1 = check_against(torch, lambda: th.window_histogram(*fargs),
                              lambda: th.window_histogram_plain(*fargs),
                              False, "V", "W=1 float")
    ms_f1 = cuda_ms(lambda: th.window_histogram(*fargs), reps=5)
    check_launches_a_call(torch, lambda: th.window_histogram(*fargs),
                          WINDOW_NAMES, 3, "V (W=1 float)")
    sel21 = torch.randint(-1, 21, (N,), generator=g, device=dev,
                          dtype=torch.int32).to(torch.int8)
    lo21 = _lanes_windows(torch, g, dev, 21, F, Bc, shift)
    rels = []
    for kind in ("float", "wide-exponent float"):
        if kind != "float":
            fv[:, 0], fv[:, 1] = wide_values(torch, g, dev, N)
        wargs = (bins, fv, sel21, lo21, R, 21, False, miss_bin)
        rels.append(check_against(
            torch, lambda: th.window_histogram(*wargs),
            lambda: th.window_histogram_plain(*wargs), False, "V",
            f"W=21 {kind}")[1])
    ms_f21 = cuda_ms(lambda: th.window_histogram(*wargs), reps=5)
    del fv, fargs, wargs, sel21
    sel64 = torch.randint(-1, 64, (N,), generator=g, device=dev,
                          dtype=torch.int32)
    lo64 = _lanes_windows(torch, g, dev, 64, F, Bc, shift)
    args64 = (bins, qv, sel64, lo64, R, 64, True, miss_bin)
    check_against(torch, lambda: th.window_histogram(*args64),
                  lambda: th.window_histogram_plain(*args64), True, "V",
                  "W=64 two-column int8, int32 selector")
    ms_64 = cuda_ms(lambda: th.window_histogram(*args64), reps=5)
    check_launches_a_call(torch, lambda: th.window_histogram(*args64),
                          WINDOW_NAMES, 3, "V (W=64, int32 selector)")
    del sel64
    print(f"kernel V (the root's window, R={R}): exact, repeat launch bit for "
          f"bit; {ms:.4f} ms, device {dev_ms:.4f} ms, {n_launch:g} launches a "
          f"call (plain {plain:.3f}, index_add_ {lib:.3f}, bound "
          f"{b[0]:.4f} by {b[1]} = sector floor) at F={F} N={N}; W=1 float "
          f"max rel {rel_f1:.3g}, {ms_f1:.4f} ms, 3 launches a call; W=21 "
          f"float max rel {rels[0]:.3g}, wide-exponent {rels[1]:.3g}, "
          f"{ms_f21:.4f} ms; W=64 int32 selector exact, {ms_64:.4f} ms, 3 "
          f"launches a call", flush=True)
    return dict(max_abs_err=0.0, ms=ms, device_ms=dev_ms,
                launches_per_call=n_launch, plain_ms=plain, bound_ms=b[0],
                bound_by=b[1], library_ms=lib, sector_floor_ms=b[0],
                float_w1_ms=ms_f1, float_w1_max_rel_err=rel_f1,
                float_w21_ms=ms_f21, float_w21_max_rel_err=rels[0],
                float_w21_wide_max_rel_err=rels[1], w64_int32_sel_ms=ms_64)


def phase_kernels_c2f(torch, dev, th, bins, qv, g):
    """Phase 2, the coarse-to-fine kernels at wave255's shapes (shift 4,
    Bc = 17 with the reserved missing slot, R = 32): M and R coarse, V
    and V-lanes, against their plain versions (exact on integers), with
    their times, bounds and one-call yardsticks.  The rows' numbers are
    those of the shapes the c2f path gives each kernel: M the root pass
    (one live lane), V the root's window, R and V-lanes a W=64 wave."""
    F, N = bins.shape
    B, shift, W = 256, 4, 64
    Bc = ((B - 1) >> shift) + 2
    R = 2 << shift
    out = {}
    miss_bin = torch.full((F,), -1, dtype=torch.int32, device=dev)
    miss_bin[::4] = B - 2                           # bin 254 is missing
    b64 = bins.to(torch.int64)
    is_miss = b64 == miss_bin.to(torch.int64)[:, None]

    # ---- kernel M, coarse ---------------------------------------------
    sel0 = torch.zeros(N, dtype=torch.int8, device=dev)
    out["multi_histogram"] = measure_multi_root(torch, th, dev, bins, qv, Bc,
                                                shift, miss_bin, "coarse")
    sel = torch.randint(-1, W, (N,), generator=g, device=dev,
                        dtype=torch.int32)
    check_multi(torch, th, bins, qv, sel, W, Bc, True, True,
                "coarse W=64 two-column int8", shift, miss_bin)
    ms_w = cuda_ms(lambda: th.multi_histogram(bins, qv, sel, Bc, W, True,
                                              shift, miss_bin), reps=5)
    ms_f, rel_f, rel_fw = check_multi_float(torch, th, g, dev, bins, Bc,
                                            shift, miss_bin, "coarse")
    out["multi_histogram"].update(w64_ms=ms_w, float_w21_ms=ms_f,
                                  float_w21_max_rel_err=rel_f,
                                  float_w21_wide_max_rel_err=rel_fw)
    print(f"kernel M coarse W=64 two-column int8: exact, {ms_w:.4f} ms; "
          f"W=21 float: max rel {rel_f:.3g}, wide-exponent {rel_fw:.3g}, "
          f"{ms_f:.4f} ms", flush=True)
    del sel

    # ---- kernel R, coarse: a wave of 64 splits ------------------------
    li = torch.randint(0, 127, (N,), generator=g, device=dev,
                       dtype=torch.int32).to(torch.uint8)
    ids = torch.randperm(127, generator=g, device=dev)[:W].to(torch.int32)
    ids[60:] = 256                                  # dummy lanes
    tbl = torch.stack([
        ids,
        torch.randint(0, F, (W,), generator=g, device=dev,
                      dtype=torch.int32),
        torch.randint(0, B - 3, (W,), generator=g, device=dev,
                      dtype=torch.int32),
        torch.arange(127, 127 + W, device=dev, dtype=torch.int32),
        torch.randint(0, 2, (W,), generator=g, device=dev,
                      dtype=torch.int32),
        torch.randint(0, 2, (W,), generator=g, device=dev,
                      dtype=torch.int32)]).contiguous()
    out["routed_histogram"] = measure_routed(
        torch, th, dev, g, bins, qv, li, tbl, miss_bin, Bc, shift, "coarse")
    kl = th.routed_histogram(bins, qv, li, tbl, Bc, W, True, miss_bin,
                             shift=shift)[1]

    # ---- kernel V: the root's window ----------------------------------
    out["window_histogram"] = measure_window(
        torch, th, dev, g, bins, qv, sel0, is_miss, miss_bin, Bc, shift, R,
        b64)

    # ---- kernel V-lanes: a wave's window group, and its 2W children ------
    # kl is the leaf vector after kernel R's routing; lanes are child ids,
    # four of them dummies (256, past every uint8 leaf id)
    dummies = torch.full((4,), 256, dtype=torch.int32, device=dev)
    lane64 = torch.cat([tbl[0, :30], tbl[3, :30], dummies]).contiguous()
    # a wave's 2W children interleaved [l0, r0, l1, r1, ...] as the c2f
    # loop passes them: 60 live lanes, 4 dead ones
    lane128 = torch.stack([tbl[0], tbl[3]], 1).reshape(-1).contiguous()
    lane128[120:] = 256
    out["lanes_window_histogram"] = measure_lanes(
        torch, th, dev, bins, qv, kl, lane64, is_miss, miss_bin, Bc, shift,
        R, g, b64)
    out["lanes_window_histogram"]["at_2w128"] = measure_lanes(
        torch, th, dev, bins, qv, kl, lane128, is_miss, miss_bin, Bc, shift,
        R, g, b64)
    check_lanes_edges(torch, th, dev, g, Bc, shift, R)
    return {f"c2f_{k}": v for k, v in out.items()}


# ---- kernel B: the sampling step --------------------------------------
SAMPLE_MODES = ("bernoulli", "stratified", "goss", "mvs")
# GOSS at bench.py's goss255 rates (the defaults), MVS at 0.6
GOSS_TOP, GOSS_OTHER, MVS_FRACTION, MVS_VAR_WEIGHT = 0.2, 0.1, 0.6, 1e-6
# the step's launches by kernel name (csrc/sample.cu), a call of each mode
STEP_NAMES = {"bernoulli": {"sample_kernel": 1},
              "stratified": {"sample_kernel": 1},
              "goss": {"goss_select_kernel": 3, "sample_kernel": 1},
              "mvs": {"mvs_scores_kernel": 1, "scan_up_kernel": 1,
                      "scan_down_kernel": 1, "sample_kernel": 1}}
STEP_SIZES = (1, 15, 16, 17, 4095, 4097, 65537, 2 ** 20 + 3)
# every named kernel of the steps, launches a call
STEP_WANT = {k: v for d in STEP_NAMES.values() for k, v in d.items()}
# the launch counters' increase a call of each mode's step
# (``sample.LAUNCHES``): the draw's by mode, GOSS's select, MVS's scores
# and scan
STEP_COUNTERS = {"bernoulli": {"sample_bag": 1},
                 "stratified": {"sample_bag": 1},
                 "goss": {"goss_select": 3, "sample_goss": 1},
                 "mvs": {"mvs_scores": 1, "mvs_scan": 2, "sample_mvs": 1}}
# GOSS's and MVS's edge inputs, checked at these sizes
GOSS_CASES = ("every row tied", "all zero", "NaN and inf rows",
              "fewer non-NaN rows than top_k")
# MVS's edge: every score equal and a target of 1.25 n, which no est (at
# most about n) passes
EDGE_SIZES = (4097, 65537)


def step_gh(torch, dev, n, g, case="ties"):
    """|g * h| of a test case: 40 exact values / 64 (GOSS's threshold
    inside a run of ties) or one of ``GOSS_CASES``."""
    gh = torch.randint(0, 40, (n,), generator=g, device=dev).float() / 64
    if case == "every row tied":
        gh.fill_(0.125)
    elif case == "all zero":
        gh.zero_()
    elif case == "NaN and inf rows":
        u = torch.rand(n, generator=g, device=dev)
        gh[u < 0.1] = float("nan")
        gh[u > 0.95] = float("inf")
    elif case == "fewer non-NaN rows than top_k":
        gh[torch.rand(n, generator=g, device=dev) < 0.9] = float("nan")
    return gh


def step_calls(torch, ts, dev, n, mode, seed, case="ties", frac=None):
    """(kernel call, plain call, inputs) of one mode of kernel B's step at
    ``n`` rows: random key words, ``step_gh``'s |g * h|, label signs at a
    0.4 rate.  Each call returns the step's outputs: the weights; GOSS's
    thr, n_gt, n_tie and p_tie; MVS's s and mu.  The plain call is the
    plain versions of ``ops/sample.py`` on the same CUDA tensors."""
    g = torch.Generator(device=dev).manual_seed(seed)
    words = torch.randint(0, 2 ** 32, (4,), generator=g, device=dev,
                          dtype=torch.int64)
    gh = step_gh(torch, dev, n, g, case)
    inp = {"words": words, "gh": gh}
    if mode in ("bernoulli", "stratified"):
        pos = None
        if mode == "stratified":
            pos = (torch.rand(n, generator=g, device=dev) < 0.4).to(
                torch.uint8)
        inp["label_pos"] = pos
        args = (words, n, 0.7 if pos is None else 1.0, 0.5, 0.9, pos)
        return (lambda: (ts.bag_weights(*args),),
                lambda: (ts.bag_weights_plain(*args),), inp)
    if mode == "goss":
        top_k = max(int(n * GOSS_TOP), 1)
        other_k = int(n * GOSS_OTHER)
        rr, amp = other_k / max(n - top_k, 1), \
            (n - top_k) / float(max(other_k, 1))
        inp.update(top_k=top_k, rest=(rr, amp))

        def plain():
            thr, n_gt, n_tie, p_tie = ts.goss_threshold(gh, top_k)
            return (ts.goss_weights_plain(words, gh, thr, p_tie, rr, amp),
                    thr, n_gt, n_tie, p_tie)
        return (lambda: ts.goss_step(words, gh, top_k, rr, amp), plain, inp)
    target = (MVS_FRACTION if frac is None else frac) * n
    inp["target"] = target

    def plain():
        s = ts.mvs_scores(gh, MVS_VAR_WEIGHT)
        mu = ts.mvs_threshold(s, target)
        return ts.mvs_weights_plain(words, s, mu), s, mu
    return (lambda: ts.mvs_step(words, gh, MVS_VAR_WEIGHT, target), plain,
            inp)


def _as_bytes(torch, t):
    return t.reshape(-1).contiguous().view(torch.uint8)


# the step's thresholds, where a NaN may carry another payload in the
# plain version: where ``-sort(-gh)`` meets a NaN, the plain version's
# negations on the card give another NaN than the row's own, which the
# kernel keeps (the first NaN row's), as the CPU and the JAX package do
NAN_ANY_PAYLOAD = ("thr", "mu")


def _step_same(torch, a, b, nan_any=False):
    """The same bytes; with ``nan_any``, two NaNs of any payloads count as
    equal."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if torch.equal(_as_bytes(torch, a), _as_bytes(torch, b)):
        return True
    if not nan_any or a.dtype != torch.float32:
        return False
    return bool(((a.view(torch.int32) == b.view(torch.int32)) |
                 (torch.isnan(a) & torch.isnan(b))).all())


def check_step(torch, kernel, plain, ctx):
    """Kernel B's step against a repeat launch bit for bit, and against
    its plain version bit for bit but for the payload of a NaN threshold
    (``NAN_ANY_PAYLOAD``); returns the kernel's outputs."""
    k = kernel()
    k2 = kernel()
    q = plain()
    torch.cuda.synchronize()
    names = ("weights", "thr", "n_gt", "n_tie", "p_tie") if len(k) == 5 \
        else ("weights", "s", "mu")
    for other, what in ((k2, "a repeat launch"), (q, "its plain version")):
        for name, a, b in zip(names, k, other):
            if not _step_same(torch, a, b, nan_any=other is q and
                              name in NAN_ANY_PAYLOAD):
                fail(f"kernel B's step: {name} differs from {what} ({ctx}): "
                     f"{a.flatten()[:4].tolist()} vs "
                     f"{b.flatten()[:4].tolist()}")
    return k


def named_profile(torch, fn, reps, want, counters, what, tries=5):
    """({kernel: [launches recorded a call, device ms a launch]},
    {counter: its increase over one call}) for ``fn``.  The first from a
    profiler window of ``reps`` calls (``kernels_seen``), in which every
    kernel named in ``want`` ({name: launches a call}) was recorded: the
    profiler drops a few of a window's first kernels, so a name may read
    up to a fifth short, and a window that reads otherwise is taken again,
    up to ``tries`` times.  The second from the launch counters over one
    more call, which must be ``counters`` ({counter: launches a call}),
    every other counter unmoved."""
    for _ in range(tries):
        seen = kernels_seen(fn, reps, tuple(want))
        # at most a fifth short (4 v <= 5 seen: 0.8 * 3 rounds above 2.4)
        if all(4 * v <= 5 * seen.get(k, [0])[0] + 1e-9 and
               seen.get(k, [0])[0] <= v + 1e-9 for k, v in want.items()):
            break
    else:
        fail(f"{what}: the profiler saw {_seen(seen)} a call, not {want}")
    before = read_counts()
    fn()
    launched = {k: v - before[k] for k, v in read_counts().items()
                if v != before[k]}
    if launched != counters:
        fail(f"{what}: the launch counters rose by {launched} over a call, "
             f"not {counters}")
    return seen, launched


def step_profile(torch, fn, reps, mode):
    """``named_profile`` of a call of kernel B's step in ``mode`` (the
    step's named kernels, and the sort's under their own names)."""
    return named_profile(torch, fn, reps, STEP_NAMES[mode],
                         STEP_COUNTERS[mode], f"kernel B's {mode} step")


def clocks_line():
    """(the SM clock now, the card's maximum SM clock) in MHz."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    now, top = (float(v) for v in smi.stdout.split(",")[:2])
    return now, top


def draw_ops(torch):
    """A draw's instructions, by pipe: the body of the grid-stride loop of
    kernel B's bagging draw at one row a thread (``tools/sass_ops.py``),
    which is one draw, its compare and its row's store."""
    from lightgbm_tpu_torch.tools import sass_ops
    counts = sass_ops.kernel_counts("sample.cu")
    bag = [c["loop"] for k, c in counts.items()
           if "sample_kernel" in k and "ILi0ELi1E" in k]
    if len(bag) != 1 or bag[0] is None or bag[0]["draws"] != 1:
        fail(f"the SASS of kernel B's bagging draw: {bag}")
    return bag[0]


def ops_bound_ms(per_draw, draws, clock_mhz, sms):
    """(ms, the limiting pipe): ``draws`` draws of ``per_draw``
    instructions at the issue rate of each pipe a clock: every
    instruction at 4 schedulers x 32 lanes an SM, the integer ALU's at 64
    lanes an SM, IMAD's (the FMA pipe's heavy half) at 64."""
    per_clock = {"issue": per_draw["total"] / 128.0,
                 "alu": per_draw["alu"] / 64.0,
                 "imad": per_draw["imad"] / 64.0}
    pipe = max(per_clock, key=per_clock.get)
    return draws * per_clock[pipe] / (sms * clock_mhz * 1e6) * 1e3, pipe


def step_work(torch, mode, n, inp, out):
    """(bytes, draws) this run's data needs: a row's weight written, its
    label byte (stratified) or |g * h| read (GOSS, MVS); a draw a row,
    GOSS a second one at each tie its first draw left out and none above
    the threshold."""
    nbytes = 4 * n + 32
    if mode == "stratified":
        nbytes += n
    elif mode in ("goss", "mvs"):
        nbytes += 4 * n
    draws = n
    if mode == "goss":
        w, thr = out[0], out[1]
        gh = inp["gh"]
        n_gt = int((gh > thr).sum())
        left_out = int(((gh == thr) & (w != 1)).sum())
        draws = n - n_gt + left_out
    return nbytes, draws


def mvs_part_calls(torch, gh, s, target):
    """(MVS's scores launch, its scan's two launches): each alone through
    kernel B's entry points, on the step's inputs (its scores ``s``
    sorted for the scan), to time them by events."""
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.ops import sample as ts
    lib = kernels.load()
    n = gh.shape[0]
    out = torch.empty_like(gh)
    x = ts.sort_scores(s)
    words = ts.scan_words(n)
    scratch = torch.empty(words, dtype=torch.float32, device=gh.device)
    blocks = ts.sample_plan(n, kernels.sm_count(gh.device))
    stream = torch.cuda.current_stream().cuda_stream

    def scores():
        kernels.check(lib.ltt_mvs_scores(
            gh.data_ptr(), ts._f32(MVS_VAR_WEIGHT), out.data_ptr(), n,
            blocks, stream), "kernel B's scores")

    def scan():
        kernels.check(lib.ltt_mvs_scan(
            x.data_ptr(), n, ts._f32(target), scratch.data_ptr(), words,
            stream), "kernel B's scan")
    return scores, scan


def phase_kernels_sample(torch, dev):
    """Kernel B's sampling step in each mode against its plain version,
    bit for bit (the weights; GOSS's thr, n_gt, n_tie and p_tie; MVS's s
    and mu), with a repeat launch: at ``STEP_SIZES`` and 10.5M rows, and
    GOSS on ``GOSS_CASES`` and MVS where no i passes the target at
    ``EDGE_SIZES``.  At 10.5M rows: the step's named CUDA launches a call
    (the profiler), its time, device time by part, the draw alone, the
    plain version's time, and bounds (the draw's from its SASS at the
    card's maximum clock)."""
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.ops import sample as ts
    sms = kernels.sm_count(dev)
    clock_now, clock_max = clocks_line()
    per_draw = draw_ops(torch)
    print(f"kernel B's draw from its SASS: {per_draw['total']} "
          f"instructions a draw and its row ({per_draw['alu']} integer "
          f"ALU, {per_draw['imad']} IMAD, {per_draw['fma'] - per_draw['imad']}"
          f" float); SM clock {clock_now:g} MHz now, {clock_max:g} max",
          flush=True)
    out = {}
    for mode in SAMPLE_MODES:
        for seed, n_ in enumerate(STEP_SIZES, start=90):
            kernel, plain, _ = step_calls(torch, ts, dev, n_, mode, seed)
            check_step(torch, kernel, plain, f"{mode}, N={n_}")
        if mode in ("goss", "mvs"):
            for seed, n_ in enumerate(EDGE_SIZES, start=120):
                cases = GOSS_CASES if mode == "goss" else \
                    ("every row tied",)
                for case in cases:
                    kernel, plain, _ = step_calls(
                        torch, ts, dev, n_, mode, seed, case,
                        frac=1.25 if mode == "mvs" else None)
                    k = check_step(torch, kernel, plain,
                                   f"{mode}, {case}, N={n_}")
                    if mode == "mvs" and not torch.equal(k[2], k[1][:1]):
                        fail("MVS with a target above n: mu is not the "
                             "smallest score")
        kernel, plain, inp = step_calls(torch, ts, dev, N_ROWS, mode, 99)
        k = check_step(torch, kernel, plain, f"{mode}, N={N_ROWS}")
        ms = cuda_ms(kernel, reps=20)
        seen, launched = step_profile(torch, kernel, 10, mode)
        draw_counter = next(c for c in launched if c.startswith("sample_"))
        parts = {name: c * seen[name][1]
                 for name, c in STEP_NAMES[mode].items()}
        other = {name: c * t for name, (c, t) in seen.items()
                 if name not in STEP_NAMES[mode]}
        # the draw alone and its plain version, from the step's thresholds
        if mode == "goss":
            args = (inp["words"], inp["gh"], k[1], k[4], *inp["rest"])
            draw = lambda: ts.goss_weights(*args)  # noqa: E731
            draw_plain = lambda: ts.goss_weights_plain(*args)  # noqa: E731
        elif mode == "mvs":
            draw = lambda: ts.mvs_weights(inp["words"], k[1], k[2])  # noqa
            draw_plain = lambda: ts.mvs_weights_plain(  # noqa: E731
                inp["words"], k[1], k[2])
        else:
            draw, draw_plain = kernel, plain
        draw_ms = cuda_ms(draw, reps=20)
        plain_ms = cuda_ms(plain, reps=3)
        draw_plain_ms = plain_ms if draw is kernel else cuda_ms(draw_plain,
                                                                 reps=3)
        nbytes, draws = step_work(torch, mode, N_ROWS, inp, k)
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops, pipe = ops_bound_ms(per_draw, draws, clock_max, sms)
        old_ops = draws * THREEFRY_OPS / FP32_FLOPS_PER_S * 1e3
        b_ms, b_by = (by_ops, "operations") if by_ops > by_bytes else \
            (by_bytes, "bytes")
        row = dict(max_abs_err=0.0, ms=draw_ms, device_ms=parts[
            "sample_kernel"], launches_per_call=launched[draw_counter],
            plain_ms=draw_plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None, bytes=nbytes,
            draws=draws, bound_bytes_ms=by_bytes, bound_ops_ms=by_ops,
            bound_ops_pipe=pipe, bound_ops_old_ms=old_ops,
            sm_clock_mhz=clock_max, step_ms=ms,
            step_device_ms=sum(parts.values()) + sum(other.values()),
            step_parts_device_ms={**parts, **other},
            step_plain_ms=plain_ms, kept_share=float((k[0] > 0).float()
                                                     .mean()))
        out[mode] = row
        if mode == "goss":
            sel = lambda: ts.goss_select(inp["gh"], inp["top_k"])  # noqa
            out["goss_select"] = dict(
                max_abs_err=0.0, ms=cuda_ms(sel, reps=20),
                device_ms=parts["goss_select_kernel"],
                launches_per_call=launched["goss_select"],
                plain_ms=cuda_ms(lambda: ts.goss_threshold(
                    inp["gh"], inp["top_k"]), reps=3),
                bound_ms=4 * N_ROWS / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes", library_ms=cuda_ms(lambda: torch.kthvalue(
                    inp["gh"], N_ROWS - inp["top_k"] + 1), reps=3))
        if mode == "mvs":
            s = k[1]
            scores, scan = mvs_part_calls(torch, inp["gh"], s,
                                          inp["target"])
            out["mvs_scores"] = dict(
                max_abs_err=0.0, ms=cuda_ms(scores, reps=20),
                device_ms=parts["mvs_scores_kernel"],
                launches_per_call=launched["mvs_scores"],
                plain_ms=cuda_ms(lambda: ts.mvs_scores(inp["gh"],
                                                       MVS_VAR_WEIGHT),
                                 reps=3),
                bound_ms=8 * N_ROWS / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes", library_ms=None)
            out["mvs_scan"] = dict(
                max_abs_err=0.0, ms=cuda_ms(scan, reps=20),
                device_ms=parts["scan_up_kernel"] + parts["scan_down_kernel"],
                launches_per_call=launched["mvs_scan"],
                plain_ms=cuda_ms(lambda: ts.mvs_threshold(s, inp["target"]),
                                 reps=3),
                bound_ms=4 * N_ROWS / HBM_BYTES_PER_S * 1e3,
                bound_by="bytes", library_ms=cuda_ms(
                    lambda: torch.cumsum(s, 0), reps=3),
                sort_ms=cuda_ms(lambda: ts.sort_scores(s), reps=5),
                sort_device_ms=sum(other.values()))
        print(f"kernel B {mode}: the step bit for bit (N = "
              f"{', '.join(map(str, STEP_SIZES))}, {N_ROWS}"
              + (f"; {', '.join(GOSS_CASES)} at {EDGE_SIZES}" if mode ==
                 "goss" else "") + (f"; no i passing at {EDGE_SIZES}" if
                                    mode == "mvs" else "")
              + f"; repeat launches); at N={N_ROWS} the step {ms:.4f} ms "
              f"(device {row['step_device_ms']:.4f}: "
              + ", ".join(f"{k_} {v:.4f}" for k_, v in
                          row["step_parts_device_ms"].items())
              + f"), {STEP_NAMES[mode]} a call, counted {launched}; the "
              f"draw alone "
              f"{draw_ms:.4f} ms; plain step {plain_ms:.3f} ms; the draw's "
              f"bound {b_ms:.4f} ms by {b_by} ({draws} draws: "
              f"{by_ops:.4f} by the {pipe} pipe, {by_bytes:.4f} by bytes; "
              f"old count {old_ops:.4f})", flush=True)
        del kernel, plain, inp, k
    torch.cuda.empty_cache()
    return out


# ---- kernel B's class sum: GOSS and MVS at K > 1 classes -----------------
# at phase 11's shape (bench.py's multiclass row): 5 classes of 1M rows;
# ragged sizes first
CLASS_SUM_K, CLASS_SUM_N = 5, 1_000_000
CLASS_SUM_SIZES = (1, 17, 4097, 65537)


def class_sum_inputs(torch, dev, k, n, seed):
    """Random key words and (K, N) float32 gradients and hessians, every
    fifth row's products 0: the gradients rows of a padded buffer, the
    hessians contiguous (two row strides, which the kernel honours)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.randn((2, k, n + 3), generator=g, device=dev)
    buf[:, :, ::5] = 0.0
    words = torch.randint(0, 2 ** 32, (4,), generator=g, device=dev,
                          dtype=torch.int64)
    return words, buf[0, :, :n], buf[1, :, :n].abs()


def class_sum_steps(torch, ts, words, grad, hess):
    """(kernel, plain) pairs of GOSS's and MVS's whole steps on the class
    sum, the step outputs as ``check_step`` reads them."""
    n = grad.shape[1]
    top_k = max(int(n * GOSS_TOP), 1)
    other_k = int(n * GOSS_OTHER)
    rr, amp = other_k / max(n - top_k, 1), \
        (n - top_k) / float(max(other_k, 1))
    target = MVS_FRACTION * n

    def goss_plain():
        gh = ts.class_gh_plain(grad, hess)
        thr, n_gt, n_tie, p_tie = ts.goss_threshold(gh, top_k)
        return (ts.goss_weights_plain(words, gh, thr, p_tie, rr, amp), thr,
                n_gt, n_tie, p_tie)

    def mvs_plain():
        s = ts.mvs_scores(ts.class_gh_plain(grad, hess), MVS_VAR_WEIGHT)
        mu = ts.mvs_threshold(s, target)
        return ts.mvs_weights_plain(words, s, mu), s, mu
    return ((lambda: ts.goss_step(words, ts.class_gh(grad, hess), top_k,
                                  rr, amp), goss_plain),
            (lambda: ts.mvs_class_step(words, grad, hess, MVS_VAR_WEIGHT,
                                       target), mvs_plain))


def phase_kernels_class_sum(torch, dev):
    """Kernel B's class sum (``ltt_class_sum``, K > 1): gh against its
    plain version bit for bit and a repeat launch the same bits, and
    GOSS's and MVS's whole steps on it (MVS's scores written by the same
    launch) bit for bit, at ``CLASS_SUM_SIZES`` and 1M rows, K = 2 and 5.
    At K = 5, N = 1M: its CUDA launches a call (the profiler and the
    counters), ms, device ms, the scores mode's ms, the plain version's
    and the library call's ``(g * h).abs().sum(0)`` ms, its bound."""
    from lightgbm_tpu_torch.ops import sample as ts
    sizes = CLASS_SUM_SIZES + (CLASS_SUM_N,)
    for seed, n in enumerate(sizes, start=140):
        for k in (2, CLASS_SUM_K):
            words, grad, hess = class_sum_inputs(torch, dev, k, n, seed)
            ctx = f"K={k}, N={n}"
            gh = ts.class_gh(grad, hess)
            for other, what in ((ts.class_gh(grad, hess), "a repeat launch"),
                                (ts.class_gh_plain(grad, hess),
                                 "its plain version")):
                if not _step_same(torch, gh, other):
                    fail(f"kernel B's class sum differs from {what} ({ctx})")
            for kernel, plain in class_sum_steps(torch, ts, words, grad,
                                                 hess):
                check_step(torch, kernel, plain, f"class sum, {ctx}")
    K, N = CLASS_SUM_K, CLASS_SUM_N
    words, grad, hess = class_sum_inputs(torch, dev, K, N, 99)
    call = lambda: ts.class_gh(grad, hess)  # noqa: E731
    gh, plain = call(), ts.class_gh_plain(grad, hess)
    err = float((gh - plain).abs().max())
    ms = cuda_ms(call, reps=50)
    seen, launched = named_profile(torch, call, 10, {"class_sum_kernel": 1},
                                   {"class_sum": 1}, "kernel B's class sum")
    scores_ms = cuda_ms(lambda: ts._class_sum(grad, hess, MVS_VAR_WEIGHT, 1),
                        reps=50)
    nbytes = (2 * K + 1) * 4 * N
    b_ms, b_by = bound(nbytes, (2 * K - 1) * N)
    row = dict(max_abs_err=err, ms=ms,
               device_ms=seen["class_sum_kernel"][1],
               launches_per_call=launched["class_sum"],
               plain_ms=cuda_ms(lambda: ts.class_gh_plain(grad, hess),
                                reps=10),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=cuda_ms(lambda: (grad * hess).abs().sum(0),
                                  reps=10),
               bytes=nbytes, classes=K, rows=N, mvs_scores_mode_ms=scores_ms)
    print(f"kernel B class sum: gh and GOSS's and MVS's steps on it bit for "
          f"bit (K = 2, {K}; N = {', '.join(map(str, sizes))}; repeat "
          f"launches); at K={K}, N={N} {ms:.4f} ms (device "
          f"{row['device_ms']:.4f}, {launched} a call), the scores mode "
          f"{scores_ms:.4f}, plain {row['plain_ms']:.4f}, (g * h).abs()"
          f".sum(0) {row['library_ms']:.4f}; bound {b_ms:.4f} ms by {b_by}",
          flush=True)
    del grad, hess, gh, plain
    torch.cuda.empty_cache()
    return row


# ---- kernel T: the validation scorer's route ---------------------------
# its one launch: the pack of the records by one block, the walk of the
# rows by all
ROUTE_NAMES = ("tree_walk_kernel",)


def route_records(torch, dev, L, B, F, seed, n_bins=None):
    """A tree's ``L - 1`` split records as the growth loops write them:
    split t splits one of the leaves 0..t on a random feature at a random
    bin (the bins at or below it go left, the missing bin, the last of
    ``n_bins``, to a random side); a tenth, at least one, are invalid with
    garbage leaves, as a stopped tree or a wave's dummy lanes leave them."""
    g = np.random.RandomState(seed)
    S, nb = L - 1, n_bins or B
    leaf = g.randint(0, np.arange(S) + 1)
    feat = g.randint(0, F, S)
    left = np.arange(B)[None, :] <= g.randint(0, nb - 1, S)[:, None]
    left[:, nb - 1] = g.rand(S) < 0.5
    valid = g.rand(S) >= 0.1
    valid[g.randint(S)] = False
    leaf[~valid] = g.randint(0, 2 * L, int((~valid).sum()))
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
    return (as_t(leaf, torch.int32), as_t(feat, torch.int32),
            as_t(left, torch.bool), as_t(valid, torch.bool))


def route_bins(torch, dev, F, N, n_bins, seed, dtype=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, n_bins, (F, N), generator=g, device=dev,
                         dtype=torch.int32).to(dtype or torch.uint8)


def check_route(torch, tr, xt, rec, L, out_dtype, ctx):
    """Kernel T against its plain version and a repeat launch, exactly:
    the table its launch packs word for word against ``route_pack_plain``
    (the padding aside), the ids against ``route_rows_plain``."""
    n = xt.shape[1]
    B = rec[2].shape[1]
    S = L - 1
    table = torch.full((tr.route_table_words(S, B),), -7, dtype=torch.int32,
                       device=xt.device)
    want = tr.route_pack_plain(*rec, L)
    used = 4 * S + 4 + S * (-(-B // 32))
    k = tr.route_rows(xt, *rec, L, out=torch.empty(n, dtype=out_dtype,
                                                    device=xt.device),
                      table=table)
    k2 = tr.route_rows(xt, *rec, L, out=torch.full_like(k, 7))
    q = tr.route_rows_plain(xt, *rec, L,
                            out=torch.empty_like(k))
    torch.cuda.synchronize()
    if not torch.equal(table[:used], want[:used]):
        fail(f"kernel T's pack differs from its plain version ({ctx}): "
             f"{int((table[:used] != want[:used]).sum())} words")
    if not torch.equal(k, k2):
        fail(f"kernel T gave other ids on a repeat launch ({ctx})")
    if not torch.equal(k, q):
        fail(f"kernel T differs from its plain version ({ctx}): "
             f"{int((k != q).sum())} rows")
    return k


def route_sectors(torch, xt, rec, L):
    """(the distinct 32-byte sectors of ``xt`` the rows' walks read, the
    mean walk length): a row reads feature f at each valid split on f
    that finds it in the split's leaf."""
    leaf, feat, left_mask, valid = rec
    F, N = xt.shape
    per = 32 // xt.element_size()
    pad = -(-N // per) * per
    touched = torch.zeros((F, pad), dtype=torch.bool, device=xt.device)
    li = torch.zeros(N, dtype=torch.int32, device=xt.device)
    right = ~left_mask & valid[:, None]
    steps = torch.zeros((), dtype=torch.int64, device=xt.device)
    feats, valids = feat.tolist(), valid.tolist()
    for t in range(L - 1):
        if not valids[t]:
            continue
        mine = li == leaf[t]
        steps += mine.sum()
        touched[feats[t], :N] |= mine
        col = xt[feats[t]].to(torch.int64)
        li.masked_fill_(right[t][col] & mine, t + 1)
    sectors = int(touched.view(F, pad // per, per).any(2).sum())
    return sectors, float(steps) / N


def route_profile(torch, call, reps=10):
    """``named_profile`` of a call of kernel T: one launch."""
    return named_profile(torch, call, reps, {k: 1 for k in ROUTE_NAMES},
                         {"route": 1}, "kernel T")


def phase_kernels_route(torch, dev):
    """Kernel T against its plain version, exactly, with a repeat launch:
    the table its launch packs word for word, the ids at 1, 7, 31, 255 and
    1500 leaves (1500: the staged table needs more than 48 KB of shared
    memory), uint8 and int16 bins, uint8 and int32 ids, ragged lengths; at
    1024 rows (one block: the pack, its copy, 1024 walks), 500k x 28 (the
    holdout) and 10.5M x 28 with 255 leaves, its time, device time, CUDA
    launches a call, bound (the sectors the rows' walks touch, the ids
    written, the records) and the plain version's time."""
    from lightgbm_tpu_torch.ops import route as tr
    F = N_FEATURES
    seed = 200
    for L, B, bdt in ((1, 64, torch.uint8), (7, 64, torch.uint8),
                      (31, 256, torch.uint8), (255, 256, torch.uint8),
                      (255, 512, torch.int16), (1500, 256, torch.uint8)):
        for n_ in (1, 31, 1025, 100_003):
            for odt in (torch.uint8, torch.int32):
                if odt == torch.uint8 and L > 256:
                    continue
                seed += 1
                if L == 1:
                    rec = (torch.zeros(1, dtype=torch.int32, device=dev),
                           torch.zeros(1, dtype=torch.int32, device=dev),
                           torch.zeros((1, B), dtype=torch.bool, device=dev),
                           torch.zeros(1, dtype=torch.bool, device=dev))
                else:
                    rec = route_records(torch, dev, L, B, F, seed,
                                        n_bins=B - 3)
                xt = route_bins(torch, dev, F, n_, B - 3, seed, bdt)
                check_route(torch, tr, xt, rec, L, odt,
                            f"L={L} B={B} {bdt} bins, N={n_}, {odt} ids")
    out = {}
    for n_ in (1024, N_HOLDOUT, N_ROWS):
        rec = route_records(torch, dev, 255, 256, F, 300, n_bins=255)
        xt = route_bins(torch, dev, F, n_, 255, 301)
        for odt in (torch.int32, torch.uint8):
            k = check_route(torch, tr, xt, rec, 255, odt,
                            f"L=255, N={n_}, {odt} ids")
        call = lambda: tr.route_rows(xt, *rec, 255, out=k)  # noqa: E731
        ms = cuda_ms(call, reps=20)
        seen, launched = route_profile(torch, call)
        dev_ms = seen[ROUTE_NAMES[0]][1]
        plain_ms = cuda_ms(lambda: tr.route_rows_plain(xt, *rec, 255,
                                                       out=k), reps=2)
        sectors, depth = route_sectors(torch, xt, rec, 255)
        rec_bytes = 254 * (256 + 9)
        b_ms, b_by = bound(sectors * 32 + n_ + rec_bytes, 0)
        whole_ms = bound(xt.numel() + n_ + rec_bytes, 0)[0]
        out[n_] = dict(max_abs_err=0.0, ms=ms, device_ms=dev_ms,
                       launches_per_call=launched["route"],
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None, sectors=sectors, mean_walk=depth,
                       whole_matrix_bound_ms=whole_ms, rows=n_)
        print(f"kernel T, N={n_}: exact, the table word for word (and at "
              f"1-1500 leaves, ragged lengths, int16 bins, repeat launches);"
              f" {ms:.4f} ms, device {dev_ms:.4f} ms, counted {launched} a "
              f"call (plain {plain_ms:.3f} ms; bound {b_ms:.4f} ms: "
              f"{sectors} sectors of the walks, {depth:.2f} splits a row, "
              f"the records read once; the whole matrix {whole_ms:.4f})",
              flush=True)
        del xt, k
    torch.cuda.empty_cache()
    # the kernels line: the holdout's shape, as the scorer runs it
    return dict(out[N_HOLDOUT], at_10_5m=out[N_ROWS], at_1024=out[1024])


def reset_counts():
    from lightgbm_tpu_torch.ops import graphs
    for counter in graphs.LAUNCH_COUNTERS + (graphs.REPLAYS,):
        for k in counter:
            counter[k] = 0


def read_counts():
    from lightgbm_tpu_torch.ops import graphs
    out = {}
    for counter in graphs.LAUNCH_COUNTERS:
        out.update(counter)
    return out


# phases 3-5: 1 warm-up + 5 measured trees a run; the fused run trains
# the boost_from_average iteration (unfused) and one block of FUSED_K
N_TREES = 6
FUSED_K = 5
MODES = ("graphs", "eager", "fused")


def run_path(torch, ltt, ds, params, mode):
    """``N_TREES`` trees of one configuration: ``mode`` "graphs" (the main
    path as training runs it: the first tree eager, the rest replays of
    CUDA graphs, captured after it), "eager" (every kernel launched from
    Python, the launch sequence before the graphs) or "fused"
    (``fused_iters=5``: the bias iteration, then one block of 5 trees on
    the graphs).  The launch counters are set to 0 just before the first
    tree and read just after the last.  Returns the booster, seconds per
    measured iteration (the fused block's time over 5), the warm-up tree's
    seconds, the capture, the kernel launches executed, graph replays,
    flag reads per tree and waves per tree."""
    from lightgbm_tpu_torch.ops import graphs
    fused = mode == "fused"
    p = dict(params, fused_iters=FUSED_K if fused else 1,
             num_iterations=N_TREES)
    booster = ltt.Booster(params=p, train_set=ds, _eager=mode == "eager")
    g = booster._gbdt
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    booster.update()                      # warm-up: the first tree, eager
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if g.runner.use_graphs:
        g.runner.capture()
    waves = [g.last_waves]
    iter_s = []
    for _ in range(1 if fused else N_TREES - 1):
        t0 = time.perf_counter()
        for _ in range(FUSED_K if fused else 1):
            if booster.update():
                fail(f"{mode} training stopped early")
            waves.append(g.last_waves)
        torch.cuda.synchronize()
        iter_s.append((time.perf_counter() - t0) / (FUSED_K if fused else 1))
    counts = read_counts()
    if booster.num_trees() != N_TREES:
        fail(f"{mode} run trained {booster.num_trees()} trees, not {N_TREES}")
    return {"booster": booster, "iter_s": iter_s, "warm_s": warm_s,
            "capture": g.runner.info, "counts": counts,
            "replays": graphs.REPLAYS["graph_replays"],
            "flag_reads_per_tree": g.runner.flag_reads / N_TREES,
            "waves": waves}


def _check_launches(counts, names, path):
    for name in names:
        if counts.get(name, 0) <= 0:
            fail(f"kernel {name} was not launched on the {path} path")


def profile_iteration(torch, booster):
    """One more iteration under ``torch.profiler`` -> its wall seconds,
    the device's busy seconds and idle share, the kernels the profiler
    saw, and the kernel launches executed and graph replays (the
    counters)."""
    from lightgbm_tpu_torch.tools.prof_iteration import (counters,
                                                         profile_window)
    own0, replays0 = counters()
    wall_s, busy_us, seen, _ = profile_window(torch, booster.update)
    own1, replays1 = counters()
    return {"profiled_iteration_s": wall_s,
            "device_busy_s": busy_us / 1e6 if seen else None,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall_s
            if seen else None,
            "profiler_kernels": seen, "kernel_launches": own1 - own0,
            "graph_replays": replays1 - replays0}


def feature_splits(booster):
    """The splits on each feature over the booster's trees."""
    counts = np.zeros(N_FEATURES, np.int64)
    for t in booster.models:
        np.add.at(counts, np.asarray(t.split_feature[:t.num_leaves - 1]), 1)
    return counts.tolist()


def _identical_trees(a, b, what):
    """The first ``N_TREES`` trees of two boosters the same bits (their
    model text prints every value in full), or fail."""
    for i in range(N_TREES):
        if a.models[i].to_string(i) != b.models[i].to_string(i):
            fail(f"{what}: tree {i} differs")


def run_paths(torch, ltt, ds, params, path):
    """One configuration in the three modes of :func:`run_path`; fails
    unless the eager and fused trees equal the graphed ones bit for bit
    and the three runs executed the same kernel launches.  Returns the
    runs (the eager and fused boosters freed)."""
    runs = {}
    for mode in MODES:
        r = runs[mode] = run_path(torch, ltt, ds, params, mode)
        if mode != "fused":
            r["profile"] = profile_iteration(torch, r["booster"])
        n_launch = sum(r["counts"].values())
        print(f"{path} [{mode}]: seconds per iteration "
              f"{statistics.median(r['iter_s']):.4f} (runs "
              f"{[round(s, 4) for s in r['iter_s']]}), warm-up tree "
              f"{r['warm_s']:.3f} s, kernel launches executed "
              f"{n_launch} ({n_launch / N_TREES:.1f} a tree), graph "
              f"replays {r['replays']} ({r['replays'] / N_TREES:.1f} a "
              f"tree), flag reads a tree {r['flag_reads_per_tree']:.2f}, "
              f"waves {r['waves']}", flush=True)
        if r["capture"] is not None:
            print(f"{path} [{mode}] capture: {r['capture']}", flush=True)
        if "profile" in r:
            prof = r["profile"]
            if prof["device_busy_s"] is not None:
                prof["idle_share_of_iteration"] = 1.0 - \
                    prof["device_busy_s"] / statistics.median(r["iter_s"])
            print(f"{path} [{mode}] profiled iteration: {prof}", flush=True)
    main = runs["graphs"]
    if main["booster"]._gbdt.runner.use_graphs and (
            main["replays"] == 0 or runs["eager"]["replays"] != 0):
        fail(f"{path}: graph replays {main['replays']} (graphs), "
             f"{runs['eager']['replays']} (eager)")
    for mode in ("eager", "fused"):
        _identical_trees(main["booster"], runs[mode]["booster"],
                         f"{path}: graphs vs {mode}")
        if runs[mode]["counts"] != main["counts"]:
            fail(f"{path}: kernel launches executed differ between graphs "
                 f"{main['counts']} and {mode} {runs[mode]['counts']}")
        del runs[mode]["booster"]
    torch.cuda.empty_cache()
    print(f"{path}: graphed, eager and fused_iters={FUSED_K} trees "
          f"identical, the same kernel launches executed", flush=True)
    return runs


def _summary(runs):
    """The numbers of each mode for the JSON line."""
    out = {}
    for mode, r in runs.items():
        out[mode] = {"seconds_per_iteration": statistics.median(r["iter_s"]),
                     "iteration_seconds": r["iter_s"],
                     "warmup_seconds": r["warm_s"], "capture": r["capture"],
                     "kernel_launches_per_tree":
                     sum(r["counts"].values()) / N_TREES,
                     "graph_replays_per_tree": r["replays"] / N_TREES,
                     "flag_reads_per_tree": r["flag_reads_per_tree"],
                     "waves_per_tree": r["waves"],
                     **r.get("profile", {})}
    return out


def phase_full_width(torch, ltt):
    """Phase 3: the serial (exact) path end to end at the Higgs shape.
    Returns the data for the next phase and this path's numbers."""
    t0 = time.perf_counter()
    X, y = make_higgs_shaped(N_ROWS + N_HOLDOUT, N_FEATURES, seed=0)
    Xh, yh = X[N_ROWS:], y[N_ROWS:]
    X, y = X[:N_ROWS], y[:N_ROWS]
    print(f"data generation: {time.perf_counter() - t0:.1f} s", flush=True)
    params = dict(TRAIN_PARAMS, device_type=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = ltt.Dataset(X, label=y, params=params).construct()
    torch.cuda.synchronize()
    ds_s = time.perf_counter() - t0
    print(f"Dataset construction: {ds_s:.2f} s "
          f"(binned {tuple(ds._constructed.binned.shape)} "
          f"{ds._constructed.binned.dtype})", flush=True)

    runs = run_paths(torch, ltt, ds, params, "exact")
    main = runs["graphs"]
    booster, counts = main["booster"], main["counts"]
    t0 = time.perf_counter()
    prob = booster.predict(Xh)
    predict_s = time.perf_counter() - t0
    if prob.shape != (N_HOLDOUT,) or not np.all(np.isfinite(prob)):
        fail("holdout predictions are not finite of the expected shape")
    score = np_auc(yh, prob)
    print(f"exact path: holdout predict {predict_s:.3f} s, holdout AUC "
          f"{score:.5f}, trees {booster.num_trees()} x "
          f"{[t.num_leaves for t in booster.models]} leaves", flush=True)
    print(f"launches on the exact path: {counts} (per tree: "
          f"{ {k: v / N_TREES for k, v in counts.items()} })", flush=True)
    _check_launches(counts, ("histogram", "best_split", "leaf_lookup"),
                    "exact")
    if not 0.6 < score <= 1.0:
        fail(f"holdout AUC {score} is not that of a trained model")
    splits = feature_splits(booster)
    del booster, main["booster"]
    return (ds, Xh, yh), counts, dict(
        seconds_per_iteration=statistics.median(main["iter_s"]),
        modes=_summary(runs), dataset_seconds=ds_s,
        predict_seconds=predict_s, holdout_auc=score,
        splits_by_feature=splits)


def _wave_phase(torch, ltt, data, exact_auc, params, path, names, tier):
    """Phases 4 and 5: a wave configuration in the three modes, the tiers
    it resolved to as ``tier`` describes them (a test of the growth
    parameters, and its text), holdout AUC no more than 0.02 below the
    exact path's."""
    ds, Xh, yh = data
    runs = run_paths(torch, ltt, ds, params, path)
    main = runs["graphs"]
    booster, counts, waves = main["booster"], main["counts"], main["waves"]
    gp = booster._gbdt.grow_params
    if not tier[0](gp):
        fail(f"{path}: wave255 did not resolve to {tier[1]}: {gp}")
    prob = booster.predict(Xh)
    if prob.shape != (N_HOLDOUT,) or not np.all(np.isfinite(prob)):
        fail(f"{path} holdout predictions are not finite of the expected "
             f"shape")
    score = np_auc(yh, prob)
    print(f"{path}: holdout AUC {score:.5f} (exact path {exact_auc:.5f}), "
          f"trees {booster.num_trees()} x "
          f"{[t.num_leaves for t in booster.models]} leaves", flush=True)
    print(f"launches on the {path} path: {counts} (per tree: "
          f"{ {k: v / N_TREES for k, v in counts.items()} })", flush=True)
    _check_launches(counts, names, path)
    if score < exact_auc - 0.02:
        fail(f"{path} holdout AUC {score} is more than 0.02 below the exact "
             f"path's {exact_auc}")
    splits = feature_splits(booster)
    del booster, main["booster"]
    return counts, waves, dict(
        seconds_per_iteration=statistics.median(main["iter_s"]),
        waves_per_tree=waves, modes=_summary(runs), holdout_auc=score,
        splits_by_feature=splits)


def phase_wave(torch, ltt, data, exact_auc):
    """Phase 4: bench.py's wave255 configuration (wave growth, quantized
    two-column passes, min_data_in_leaf=0) without coarse-to-fine, on the
    same data."""
    params = dict(TRAIN_PARAMS, **WAVE_PARAMS, device_type=DEVICE)
    counts, _, e2e = _wave_phase(
        torch, ltt, data, exact_auc, params, "wave",
        ("multi_histogram", "routed_histogram", "leaf_stats", "best_split",
         "leaf_lookup"),
        (lambda gp: gp.wave and gp.two_col and gp.speculate == 64 and
         gp.quantize and not gp.refine_shift, "two-column W=64 waves"))
    return counts, e2e


def phase_c2f(torch, ltt, data, exact_auc):
    """Phase 5: wave255 as bench.py runs it (hist_refinement at its
    default: coarse-to-fine refinement at shift 4) on the same data."""
    params = dict(TRAIN_PARAMS, **WAVE255_PARAMS, device_type=DEVICE)
    counts, waves, e2e = _wave_phase(
        torch, ltt, data, exact_auc, params, "c2f",
        ("multi_histogram", "window_histogram", "routed_histogram",
         "lanes_window_histogram", "leaf_stats", "leaf_lookup"),
        (lambda gp: gp.refine_shift == 4 and gp.wave and gp.two_col and
         gp.speculate == 64 and gp.quantize,
         "c2f two-column W=64 waves at shift 4"))
    if counts["lanes_window_histogram"] != sum(waves):
        fail(f"kernel V-lanes ran {counts['lanes_window_histogram']} times "
             f"in {sum(waves)} waves: it runs once a wave")
    if counts["best_split"] != 0:
        fail(f"kernel S ran {counts['best_split']} times on the c2f path, "
             f"whose scans are plain tensor code")
    return counts, e2e


def out_step_device(seen):
    """Device ms a call of a step's ``named_profile`` record: its named
    kernels at their launches a call, the others as recorded."""
    return sum(t * STEP_WANT.get(k, c) for k, (c, t) in seen.items())


# phase 9: the sampled configurations at full width on phase 3's data:
# (params, the unsampled path whose seconds an iteration they stand
# beside, the modes of run_path, kernel B's mode: ``STEP_COUNTERS``)
SAMPLED = {
    # bench.py's goss255 (bench.py:2088-2100): wave255 as it ships, GOSS
    "goss255": (dict(TRAIN_PARAMS, **WAVE255_PARAMS, boosting="goss"),
                "c2f", ("graphs", "eager", "fused"), "goss"),
    # tests/test_pipeline.py:100's bernoulli row on exact255
    "exact255-bagging": (dict(TRAIN_PARAMS, bagging_fraction=0.7,
                              bagging_freq=2),
                         "exact", ("graphs", "fused"), "bernoulli"),
    # that file's MVS row on wave255 without c2f
    "wave255-noc2f-mvs": (dict(TRAIN_PARAMS, **WAVE_PARAMS, boosting="mvs",
                               bagging_fraction=MVS_FRACTION),
                          "wave", ("graphs", "fused"), "mvs"),
}


def sampling_step(torch, booster):
    """The sampled booster's sampling step on its current gradients, or
    None for bagging: (ms back to back, {kernel: [launches a call, device
    ms a launch]}: GOSS's select and draw, MVS's scores, sort, scan and
    draw)."""
    from lightgbm_tpu_torch.ops import sample as ts
    g = booster._gbdt
    cfg, n = g.config, g.num_data
    grad, hess = g.objective.get_gradients(g._score)
    gh = (grad * hess).abs()
    words = g._bag_words
    if cfg.boosting == "goss":
        top_k = max(int(n * cfg.top_rate), 1)
        other_k = int(n * cfg.other_rate)

        def fn():
            return ts.goss_step(words, gh, top_k, other_k / max(n - top_k, 1),
                                (n - top_k) / float(max(other_k, 1)))
        mode = "goss"
    elif cfg.boosting == "mvs":
        def fn():
            return ts.mvs_step(words, gh, cfg.var_weight,
                               cfg.bagging_fraction * n)
        mode = "mvs"
    else:
        return None
    return cuda_ms(fn, reps=10), step_profile(torch, fn, 5, mode)[0]


def phase_sampled(torch, ltt, data, unsampled_s):
    """Phase 9: each configuration of ``SAMPLED`` at full width, on CUDA
    graphs (the main path), at fused_iters=5 and (goss255) eagerly: the
    same trees bit for bit and the same kernel launches, kernel B's step's
    launches a tree by counter (``STEP_COUNTERS``), holdout AUC above 0.6;
    seconds an iteration beside the unsampled path's from phases 3-5, the
    step's time by part."""
    ds, Xh, yh = data
    out, counts_by = {}, {}
    for name, (params, path, modes, mode) in SAMPLED.items():
        p = dict(params, device_type=DEVICE)
        runs = {m: run_path(torch, ltt, ds, p, m) for m in modes}
        main = runs["graphs"]
        b = main["booster"]
        for m in modes[1:]:
            _identical_trees(b, runs[m]["booster"], f"{name}: graphs vs {m}")
            if runs[m]["counts"] != main["counts"]:
                fail(f"{name}: kernel launches executed differ between "
                     f"graphs {main['counts']} and {m} {runs[m]['counts']}")
            del runs[m]["booster"]
        counts = main["counts"]
        step = STEP_COUNTERS[mode]
        for k, v in step.items():
            if counts[k] != v * N_TREES:
                fail(f"{name}: kernel B's {k} ran {counts[k]} times in "
                     f"{N_TREES} trees, not {v} a tree")
        if main["replays"] <= 0:
            fail(f"{name}: no graph replays on the main path")
        prob = b.predict(Xh)
        if prob.shape != (N_HOLDOUT,) or not np.all(np.isfinite(prob)):
            fail(f"{name}: holdout predictions are not finite of the "
                 f"expected shape")
        auc = np_auc(yh, prob)
        if not 0.6 < auc <= 1.0:
            fail(f"{name}: holdout AUC {auc} is not that of a trained model")
        thr = sampling_step(torch, b)
        e2e = {m: statistics.median(r["iter_s"]) for m, r in runs.items()}
        out[name] = dict(
            seconds_per_iteration=e2e["graphs"], modes=_summary(runs),
            unsampled_seconds_per_iteration=unsampled_s[path],
            kernel_b_launches_per_tree={k: counts[k] / N_TREES
                                        for k in step},
            step_ms=None if thr is None else thr[0],
            step_device_ms=None if thr is None else out_step_device(
                thr[1]),
            step_kernels=None if thr is None else thr[1],
            holdout_auc=auc, launches=counts)
        counts_by[name] = counts
        thr_text = "the draw alone" if thr is None else (
            f"the step {thr[0]:.3f} ms (device "
            f"{out_step_device(thr[1]):.4f} ms: {_seen(thr[1])})")
        print(f"{name}: seconds per iteration "
              f"{ {m: round(v, 4) for m, v in e2e.items()} } (unsampled "
              f"{path} {unsampled_s[path]:.4f}), kernel B "
              f"{ {k: counts[k] / N_TREES for k in step} } a tree, "
              f"{thr_text}, holdout "
              f"AUC {auc:.5f}; {', '.join(modes)} trees identical, the "
              f"same kernel launches executed", flush=True)
        del b, main["booster"]
        torch.cuda.empty_cache()
    return counts_by, out


def _same_trees(a, b, what, n_trees):
    """Two lists of trees: identical splits and leaf values within rtol
    1e-5, or fail."""
    if len(a) != len(b) or len(a) != n_trees:
        fail(f"{what}: tree counts differ: {len(a)} vs {len(b)}")
    worst = 0.0
    for i, (ta, tb) in enumerate(zip(a, b)):
        n = ta.num_leaves - 1
        if ta.num_leaves != tb.num_leaves:
            fail(f"{what}: tree {i}: {ta.num_leaves} vs {tb.num_leaves} "
                 f"leaves")
        for k in ("split_feature", "threshold_bin", "decision_type",
                  "left_child", "right_child", "leaf_count"):
            if not np.array_equal(getattr(ta, k)[:n + 1],
                                  getattr(tb, k)[:n + 1]):
                fail(f"{what}: tree {i}: {k} differs between cuda and cpu")
        va, vb = ta.leaf_value[:n + 1], tb.leaf_value[:n + 1]
        if not np.allclose(va, vb, rtol=1e-5, atol=0):
            fail(f"{what}: tree {i}: leaf values differ beyond rtol 1e-5")
        worst = max(worst, float(np.max(np.abs(va - vb))))
    return worst


def _train_reduced(job):
    """One reduced training: ``(X, y, params, rounds, {"group": query
    counts or None, "fobj": a custom objective or None})`` -> its trees, raw
    and converted predictions on ``X``, model text, training score, the
    trees of each landed block and the coarse-to-fine shift.  The CPU's
    runs of phase 6 run it in a pool of spawned processes, one thread
    each, while the card trains."""
    X, y, params, rounds, extra = job
    import torch
    if params["device_type"] == "cpu":
        torch.set_num_threads(1)
    import lightgbm_tpu_torch as ltt
    b = ltt.train(params, ltt.Dataset(X, label=y, group=extra.get("group"),
                                      params=params),
                  num_boost_round=rounds, fobj=extra.get("fobj"))
    g = b._gbdt
    return {"models": list(b.models), "raw": b.predict(X, raw_score=True),
            "pred": b.predict(X), "text": b.model_to_string(),
            "score": g.train_score(), "blocks": list(g.block_sizes),
            "refine_shift": g.grow_params.refine_shift,
            "k": b.num_tree_per_iteration}


def reduced_cells():
    """Phase 6's cells: {what: (X, y, params, rounds, the card's
    fused_iters, the CPU's, refine_shift wanted or None, blocks at
    fused_iters=4 or None, {"group": ..., "fobj": ...} or {})}."""
    X, y = make_higgs_shaped(50_000, N_FEATURES, seed=1)
    rng = np.random.RandomState(2)
    X[rng.rand(len(X)) < 0.05, 5] = np.nan      # exercise missing values
    float_waves = {"num_leaves": 31, "wave_splits": True,
                   "hist_refinement": False}
    # (params, the card's fused_iters, the CPU's: the sampled cells'
    # fused CPU runs are held to its per-iteration runs by
    # tests/test_torch_boosting_fused.py; DART and RF do not fuse)
    base = {
        "exact": ({"num_leaves": 31}, (1, 4), (1, 4)),
        "float waves": (float_waves, (1, 4), (1, 4)),
        "quantized two-column waves": (dict(WAVE_PARAMS, num_leaves=127),
                                       (1, 4), (1, 4)),
        "float c2f waves": ({"num_leaves": 31, "wave_splits": True},
                            (1, 4), (1, 4)),
        "quantized two-column c2f waves": (dict(WAVE255_PARAMS,
                                                num_leaves=127),
                                           (1, 4), (1, 4)),
        "float waves, stratified bagging": (dict(
            float_waves, pos_bagging_fraction=0.5, neg_bagging_fraction=0.9,
            bagging_freq=1), (1, 4), (1,)),
        "quantized two-column c2f waves, GOSS": (dict(
            WAVE255_PARAMS, num_leaves=127, boosting="goss"), (1, 4), (1,)),
        "quantized two-column waves, MVS": (dict(
            WAVE_PARAMS, num_leaves=127, boosting="mvs",
            bagging_fraction=MVS_FRACTION), (1, 4), (1,)),
        "exact, DART": ({"num_leaves": 31, "boosting": "dart",
                         "drop_rate": 0.3, "skip_drop": 0.0}, (1,), (1,)),
        "float waves, random forest": (dict(
            float_waves, boosting="rf", bagging_fraction=0.632,
            bagging_freq=1, feature_fraction=0.8), (1,), (1,)),
    }
    cells = {what: (X, y, dict(TRAIN_PARAMS, **extra), REDUCED_ITERS, card,
                    cpu, 4 if "c2f" in what else 0, [1, 4, 1], {})
             for what, (extra, card, cpu) in base.items()}
    # a custom objective (a numpy log loss) on the exact loop
    cells["exact, fobj"] = (X, y, dict(TRAIN_PARAMS, num_leaves=31,
                                       objective="none"), REDUCED_ITERS,
                            (1,), (1,),
                            None, None, {"fobj": logloss_fobj})
    # the objective zoo: 20k rows, 5% NaN, ZOO_ITERS iterations
    Xz, _ = make_higgs_shaped(ZOO_ROWS, N_FEATURES, seed=1)
    z = regression_label(Xz)
    Xm, ym, _, _ = make_multiclass(ZOO_ROWS, 0)
    Xz[rng.rand(len(Xz)) < 0.05, 5] = np.nan
    Xm[rng.rand(len(Xm)) < 0.05, 5] = np.nan
    exact = dict(TRAIN_PARAMS, num_leaves=31)
    labels = {}
    for name in ZOO_OBJECTIVES:
        labels[name] = zoo_label(name, z, np.random.RandomState(3))
        fuse = name not in ZOO_RENEW
        cells[name] = (Xz, labels[name], dict(exact, objective=name),
                       ZOO_ITERS, (1, 4) if fuse else (1,), (1,), None,
                       [1, ZOO_ITERS - 1] if fuse else None, {})
    for name in ("regression_l1", "mape"):
        for what, extra in (("bagging", {"bagging_fraction": 0.7,
                                         "bagging_freq": 1}),
                            ("GOSS", {"boosting": "goss"})):
            cells[f"{name}, {what}"] = (Xz, labels[name], dict(
                exact, objective=name, **extra), ZOO_ITERS, (1,), (1,),
                None, None, {})
    for obj in ("multiclass", "multiclassova"):
        for loop, extra in (("exact", {"num_leaves": 31}),
                            ("float waves", {"num_leaves": 31,
                                             "wave_splits": True,
                                             "hist_refinement": False}),
                            ("two-column c2f waves",
                             dict(WAVE255_PARAMS, num_leaves=127))):
            cells[f"{obj}, {loop}"] = (Xm, ym, dict(
                TRAIN_PARAMS, **extra, objective=obj,
                num_class=MC_CLASSES), ZOO_ITERS, (1,), (1,),
                4 if "c2f" in loop else None, None, {})
    # lambdarank: the MS-LTR generator's first 88 queries (19,976 rows x
    # 136 features), on three loops, K=4 the bits of K=1 on the card
    Xr, yr, cr, _, _, _ = make_msltr(ZOO_ROWS // RANK_DOCS, RANK_DOCS,
                                     RANK_FEATURES)
    for loop, extra in (("exact", {"num_leaves": 31}),
                        ("two-column waves", dict(WAVE_PARAMS,
                                                  num_leaves=127)),
                        ("two-column c2f waves", dict(WAVE255_PARAMS,
                                                      num_leaves=127))):
        cells[f"lambdarank, {loop}"] = (Xr, yr, dict(
            TRAIN_PARAMS, **extra, objective="lambdarank", metric="None"),
            ZOO_ITERS, (1, 4), (1,), 4 if "c2f" in loop else None,
            [1, ZOO_ITERS - 1], {"group": cr})
    return cells


def phase_device_vs_cpu(ltt, cells=None, phase="phase 6"):
    """Phase 6: reduced configurations on the card and on the CPU
    (``reduced_cells``): the exact path at 31 leaves, float waves, and
    quantized two-column waves at 127 leaves (W = 64), each wave kind
    without and with coarse-to-fine refinement (28 x 256 bins passes its
    gate); stratified bagging on float waves, GOSS on quantized two-column
    coarse-to-fine waves, MVS on quantized two-column waves; DART on the
    exact loop at 31 leaves and a random forest on float waves, which do
    not fuse; then the objective zoo (the ten regression and
    cross-entropy objectives, L1 and MAPE bagged and under GOSS, softmax
    and one-vs-all on three loops).  Identical trees card against CPU
    (the CPU's runs in a pool of spawned processes while the card
    trains), and fused_iters=4 the same bits as fused_iters=1 on the card
    and, for the five unsampled cells, on the CPU.  ``cells``: another set
    of cells in ``reduced_cells``' form, for ``phase``."""
    import multiprocessing
    cells = reduced_cells() if cells is None else cells
    workers = max(1, min(6, (os.cpu_count() or 2) - 2))
    ctx = multiprocessing.get_context("spawn")
    t_start = time.perf_counter()
    with ctx.Pool(workers) as pool:
        jobs = {(what, f): pool.apply_async(_train_reduced, ((
            X, y, dict(p, device_type="cpu", fused_iters=f), rounds, ex),))
            for what, (X, y, p, rounds, _, cpu_fused, _, _, ex)
            in cells.items() for f in cpu_fused}
        for what, (X, y, p, rounds, fused, cpu_fused, shift,
                   blocks4, ex) in cells.items():
            t0 = time.perf_counter()
            card = {f: _train_reduced((X, y, dict(p, device_type=DEVICE,
                                                  fused_iters=f), rounds,
                                       ex))
                    for f in fused}
            card_s = time.perf_counter() - t0
            cpu = {f: jobs[what, f].get() for f in cpu_fused}
            c = cpu[1]
            a = card[1]
            for r, label in ((a, "card"), (c, "cpu")):
                if shift is not None and r["refine_shift"] != shift:
                    fail(f"{what}: refine_shift is not {shift} on the "
                         f"{label}")
                if r["blocks"] != [1] * rounds:
                    fail(f"{what}: blocks of {r['blocks']} trees at "
                         f"fused_iters=1 on the {label}")
            k = a["k"]
            worst = _same_trees(a["models"], c["models"], what, rounds * k)
            # within 1e-5 of the larger of 1 and the largest value
            reach = max(1.0, float(np.max(np.abs(c["raw"]))))
            preach = max(1.0, float(np.max(np.abs(c["pred"]))))
            rdiff = float(np.max(np.abs(a["raw"] - c["raw"])))
            pdiff = float(np.max(np.abs(a["pred"] - c["pred"])))
            if rdiff > 1e-5 * reach or pdiff > 1e-5 * preach:
                fail(f"{what}: predictions differ between cuda and cpu by "
                     f"{rdiff} (raw), {pdiff}")
            note = ""
            for label, runs in (("card", card), ("cpu", cpu)):
                if 4 not in runs:
                    continue
                f4, f1 = runs[4], runs[1]
                if (blocks4 is not None and f4["blocks"] != blocks4) or \
                        f4["text"] != f1["text"] or \
                        not np.array_equal(f4["score"], f1["score"]):
                    fail(f"{what}: fused_iters=4 is not the bits of 1 on the "
                         f"{label} (blocks {f4['blocks']})")
                note += f"; fused_iters=4 the same bits as 1 on the {label}"
            print(f"device vs cpu, {what}: {rounds * k} trees identical, "
                  f"max leaf value diff {worst:.3g}, max prediction diff "
                  f"{pdiff:.3g} (raw {rdiff:.3g}){note}; the card's runs "
                  f"{card_s:.2f} s", flush=True)
    print(f"{phase}: {len(cells)} cells in "
          f"{time.perf_counter() - t_start:.1f} s ({workers} CPU workers)",
          flush=True)


# phase 6's depth (cut from 10 and 5 iterations when phase 14 came, and
# the zoo's from 4 when phase 15 came, to keep the script's time): the
# 50k-row cells, and the objective zoo's cells (20k rows, 5% NaN; at
# fused_iters=4 the bias iteration and one block)
REDUCED_ITERS = 6
ZOO_ROWS, ZOO_ITERS = 20_000, 3
ZOO_OBJECTIVES = ("regression_l1", "quantile", "huber", "fair", "poisson",
                  "mape", "gamma", "tweedie", "cross_entropy",
                  "cross_entropy_lambda")
ZOO_RENEW = ("regression_l1", "quantile", "mape")


def zoo_label(name, z, rng):
    """A label for ``name`` from the continuous ``z``."""
    if name == "poisson":
        return rng.poisson(np.exp(0.3 * z)).astype(np.float32)
    if name in ("gamma", "tweedie"):
        return (np.exp(0.5 * z) * rng.gamma(2.0, 0.5, len(z))).astype(
            np.float32)
    if name == "mape":
        return np.exp(z).astype(np.float32)
    if name.startswith("cross_entropy"):
        return (1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    return z


# phase 7: each path with the holdout as a validation set; trees a run
VALID_TREES = {"exact": 3, "wave": 6, "c2f": 6, "cat-wave": 6,
               "allstate-wave": 6}
VALID_METRICS = ("auc", "binary_logloss")


def lr_schedule(n):
    """A per-iteration learning-rate schedule of ``n`` rounds."""
    return [0.1 * 0.95 ** i for i in range(n)]


class _Clock:
    """A callback that stamps the start of every iteration after the
    card has finished the previous one."""
    order = 0
    before_iteration = True

    def __init__(self, torch):
        self.torch, self.t = torch, []

    def __call__(self, env):
        self.torch.cuda.synchronize()
        self.t.append(time.perf_counter())


def _iteration_s(stamps, end):
    """Seconds of each iteration after the warm-up tree and the capture
    (iterations 2 on)."""
    t = stamps + [end]
    return [b - a for a, b in zip(t[2:-1], t[3:])]


def _check_valid_score(b, Xh, yh, res, what, i=-1, score=None):
    """The holdout's score against the served trees' prediction on the raw
    holdout (1e-5), and each recorded metric of iteration ``i`` against
    the numpy formula on the fetched score (1e-9)."""
    if score is None:
        score = b._gbdt.valid_sets[0].score.cpu().numpy()
        want = b.predict(Xh, raw_score=True, num_iteration=-1)
        if score.shape != (len(yh),) or not np.all(np.isfinite(score)):
            fail(f"{what}: the holdout score is not finite of its shape")
        diff = float(np.max(np.abs(score - want)))
        if diff > 1e-5:
            fail(f"{what}: the holdout score is {diff} from the served "
                 f"trees' prediction")
    prob = 1.0 / (1.0 + np.exp(-score))
    for name, value in (("auc", np_auc(yh, prob)),
                        ("binary_logloss", np_logloss(yh, prob))):
        got = res["holdout"][name][i]
        if abs(got - value) > 1e-9 * max(1.0, abs(value)):
            fail(f"{what}: recorded {name} {got} at iteration {i} is not "
                 f"the numpy formula's {value}")


def scorer_parts_ms(torch, scorer):
    """(kernel T's, kernel L's float64 add's) milliseconds a call, each
    launched alone on the scorer's own inputs (the last tree's records,
    the holdout's bins, ids and score) and timed by CUDA events."""
    from lightgbm_tpu_torch.ops import lookup, route
    rec, nl = scorer.st.rec, scorer.st.params.num_leaves
    feature, left_mask = rec["feature"], rec["left_mask"]
    if scorer.bundles is not None:
        # the records as the scorer hands them over: on bundle columns
        feature, left_mask = scorer.bundles.translate(feature, left_mask)
    t_ms = cuda_ms(lambda: route.route_rows(
        scorer.xt, rec["leaf"], feature, left_mask, rec["valid"], nl,
        out=scorer.li), reps=20)
    score = scorer.score.clone()
    l_ms = cuda_ms(lambda: lookup.take_small_add(score, scorer.vals,
                                                 scorer.li), reps=20)
    return t_ms, l_ms


def _seen(seen):
    """``kernels_seen``'s result as text."""
    return ", ".join(f"{k} {n:g} ({ms:.4f} ms a launch)"
                     for k, (n, ms) in seen.items()) or "no kernel"


def run_valid(torch, ltt, ds, Xh, yh, params, n_trees, path):
    """The main path of this phase: ``n_trees`` rounds of ``ltt.train``
    with the holdout as a validation set, ``metric=auc,binary_logloss``,
    early stopping, ``evals_result`` and a learning-rate schedule, on
    CUDA graphs; the launch counters set to 0 just before and read just
    after.  Returns the booster, its records and timings."""
    from lightgbm_tpu_torch.ops import graphs
    p = dict(params, metric=",".join(VALID_METRICS))
    clock, res = _Clock(torch), {}
    valid = ds.create_valid(Xh, label=yh).construct()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b = ltt.train(p, ds, num_boost_round=n_trees, valid_sets=[valid],
                  valid_names=["holdout"], evals_result=res,
                  early_stopping_rounds=n_trees,
                  learning_rates=lr_schedule(n_trees), callbacks=[clock],
                  verbose_eval=False)
    torch.cuda.synchronize()
    end = time.perf_counter()
    counts = read_counts()
    replays = graphs.REPLAYS["graph_replays"]
    if b.num_trees() != n_trees:
        fail(f"{path} with a validation set trained {b.num_trees()} trees")
    return b, res, counts, replays, _iteration_s(clock.t, end), end - t0


def run_valid_eager(torch, ltt, ds, Xh, yh, params, n_trees):
    """The same rounds with every kernel launched from Python: the
    per-iteration API (update, the schedule's rate, eval_set), each
    iteration's holdout score fetched."""
    p = dict(params, metric=",".join(VALID_METRICS))
    b = ltt.Booster(p, ds, _eager=True)
    b.add_valid(ds.create_valid(Xh, label=yh), "holdout")
    res, scores = {"holdout": {m: [] for m in VALID_METRICS}}, []
    for i, lr in enumerate(lr_schedule(n_trees)):
        b._gbdt.shrinkage_rate = lr
        b.update()
        for _, name, value, _ in b.eval_valid():
            res["holdout"][name].append(value)
        scores.append(b._gbdt.valid_sets[0].score.cpu().numpy().copy())
    return b, res, scores


def _same_bits(a, b, what):
    """Two boosters' trees (their model text prints every value in full)
    and training scores the same bits, or fail."""
    if a.num_trees() != b.num_trees():
        fail(f"{what}: {a.num_trees()} vs {b.num_trees()} trees")
    for i in range(a.num_trees()):
        if a.models[i].to_string(i) != b.models[i].to_string(i):
            fail(f"{what}: tree {i} differs")
    if not np.array_equal(a._gbdt.train_score(), b._gbdt.train_score()):
        fail(f"{what}: the training scores differ")


def phase_valid(torch, ltt, data, path, params, names, no_valid_s):
    """Phase 7, one path: the holdout as a validation set at full width
    (the main path, on graphs), checked against the served trees'
    prediction and the metrics' numpy formulas; the same rounds eagerly
    (holdout scores and metrics the same bits) and at fused_iters=5
    without the validation set (fusion on, rewound at every rate change):
    the same trees and training scores bit for bit."""
    ds, Xh, yh = data
    n = VALID_TREES[path]
    p = dict(params, device_type=DEVICE)
    b, res, counts, replays, iter_s, total_s = run_valid(
        torch, ltt, ds, Xh, yh, p, n, path)
    scorer_names = ("route", "leaf_lookup_f64")
    _check_launches(counts, names + scorer_names, f"{path} valid")
    if replays <= 0:
        fail(f"{path} with a validation set made no graph replays")
    scorer = b._gbdt.valid_sets[0].scorer
    if scorer.graph is None:
        fail(f"{path}: the validation scorer was not captured")
    for name in scorer_names:
        if counts[name] != n:
            fail(f"{path}: kernel {name} ran {counts[name]} times in {n} "
                 f"trees, not once a tree")
    if scorer.graph.kernel_launches() != 2:
        fail(f"{path}: the scorer's graph holds "
             f"{scorer.graph.launches} kernel launches, not kernels T and "
             f"L")
    _check_valid_score(b, Xh, yh, res, f"{path} (graphs)")
    b_score = b._gbdt.valid_sets[0].score.cpu().numpy().copy()
    # eval's host time, and the scorer's replay on the card (which adds
    # into the holdout's score: its bits are kept above)
    eval_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        b.eval_set()
        eval_ms.append((time.perf_counter() - t0) * 1e3)
    run = scorer.graph.replay
    scorer_ms = cuda_ms(run, reps=10)
    # the replay's kernels as the profiler records them, against the same
    # two launched eagerly, and each alone timed by CUDA events on this
    # tree's records; the device time of a replay is the sum of its
    # kernels' times a launch
    names = ROUTE_NAMES + LOOKUP_NAMES
    seen_graph = kernels_seen(run, 20, names)
    seen_eager = kernels_seen(scorer._score, 20, names)
    if not all(k in seen_graph for k in names):
        fail(f"{path}: the profiler saw {_seen(seen_graph)} in the "
             f"scorer's replays, not kernels T and L")
    scorer_dev_ms = sum(seen_graph[k][1] for k in names)
    t_ms, l_ms = scorer_parts_ms(torch, scorer)

    e, res_e, scores_e = run_valid_eager(torch, ltt, ds, Xh, yh, p, n)
    _same_bits(b, e, f"{path}: graphs vs eager, with a validation set")
    for i, sc in enumerate(scores_e):
        _check_valid_score(e, Xh, yh, res_e, f"{path} (eager)", i, sc)
    if not np.array_equal(scores_e[-1], b_score):
        fail(f"{path}: the holdout scores differ between graphs and eager")
    for m in VALID_METRICS:
        if res_e["holdout"][m] != res["holdout"][m]:
            fail(f"{path}: recorded {m} differs between graphs and eager")
    del e
    pf = dict(p, fused_iters=FUSED_K)
    f = ltt.train(pf, ds, num_boost_round=n, learning_rates=lr_schedule(n),
                  verbose_eval=False)
    _same_bits(b, f, f"{path}: graphs vs fused_iters={FUSED_K} under a "
                     f"learning-rate schedule")
    blocks = f._gbdt.block_sizes
    del f
    out = dict(
        trees=n, seconds_per_iteration=statistics.median(iter_s),
        iteration_seconds=iter_s, total_seconds=total_s,
        seconds_per_iteration_without_valid=no_valid_s,
        eval_host_ms=statistics.median(eval_ms), eval_host_ms_runs=eval_ms,
        scorer_ms=scorer_ms, scorer_device_ms=scorer_dev_ms,
        scorer_graph_launches=scorer.graph.kernel_launches(),
        scorer_seen_in_replay=seen_graph, scorer_seen_eager=seen_eager,
        kernel_t_ms=t_ms, kernel_l_f64_ms=l_ms,
        kernel_launches_per_tree={k: v / n for k, v in counts.items()},
        graph_replays_per_tree=replays / n, fused_blocks=blocks,
        best_iteration=b.best_iteration, holdout=res["holdout"])
    print(f"{path} with a {len(yh)}-row validation set: "
          f"{out['seconds_per_iteration']:.4f} s an iteration (without it "
          f"{no_valid_s:.4f}; runs {[round(x, 4) for x in iter_s]}), eval "
          f"{out['eval_host_ms']:.2f} ms of host time an iteration, the "
          f"scorer {scorer_ms:.3f} ms a replay (device {scorer_dev_ms:.4f} "
          f"ms; kernels T and L float64 {counts['route'] / n:g} and "
          f"{counts['leaf_lookup_f64'] / n:g} a tree; the profiler saw "
          f"{_seen(seen_graph)} a replay, {_seen(seen_eager)} a call "
          f"eagerly; T {t_ms:.4f} ms and L {l_ms:.4f} ms launched alone, by "
          f"events); AUC "
          f"{res['holdout']['auc'][-1]:.5f}; graphs, eager and "
          f"fused_iters={FUSED_K} (blocks {blocks}) under the schedule the "
          f"same bits", flush=True)
    del b
    torch.cuda.empty_cache()
    return counts, out


# phase 10: DART and random forests at full width on phase 3's data with
# the holdout as a validation set, and rollback_one_iter on each and
# inside a fused gbdt block
DART_TREES, RF_TREES = 8, 6
TRAIN_SLICE = 500_000
BOOSTING = {
    # wave255 without c2f, DART (dart.hpp's defaults but for drop_rate,
    # and no skipped drops, so every iteration drops)
    "dart-wave255-noc2f": (dict(TRAIN_PARAMS, **WAVE_PARAMS,
                                boosting="dart", drop_rate=0.3,
                                skip_drop=0.0), DART_TREES, "wave",
                           ("multi_histogram", "routed_histogram",
                            "leaf_stats", "best_split", "leaf_lookup")),
    # exact255 as a random forest: bagging at 1 - 1/e, as bootstrap
    # samples keep, and feature_fraction 0.8
    "rf-exact255": (dict(TRAIN_PARAMS, boosting="rf", bagging_fraction=0.632,
                         bagging_freq=1, feature_fraction=0.8), RF_TREES,
                    "exact", ("histogram", "best_split", "leaf_lookup",
                              "leaf_lookup_f64", "sample_bag")),
}


def run_boosting(torch, ltt, ds, Xh, yh, params, n_trees, eager):
    """``n_trees`` updates with the holdout as a validation set, graphed
    (the main path) or eager, the launch counters set to 0 just before the
    first and read just after the last.  Returns the booster, the
    counters, graph replays, seconds of each iteration after the warm-up
    tree and the capture, and DART's host milliseconds an iteration of
    its drops and of its renormalization and the trees it dropped."""
    from lightgbm_tpu_torch.ops import graphs
    p = dict(params, device_type=DEVICE)
    b = ltt.Booster(p, ds, _eager=eager)
    b.add_valid(ds.create_valid(Xh, label=yh), "holdout")
    g = b._gbdt
    host = {"drop": [], "normalize": [], "dropped": []}
    for name in ("drop", "normalize") if hasattr(g, "_drop") else ():
        fn = getattr(g, "_" + name)

        def timed(fn=fn, name=name):
            t0 = time.perf_counter()
            out = fn()
            host[name].append((time.perf_counter() - t0) * 1e3)
            if name == "drop":
                host["dropped"].append(len(g._drop_index))
            return out

        setattr(g, "_" + name, timed)
    reset_counts()
    stamps = []
    for _ in range(n_trees):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if b.update():
            fail(f"{p['boosting']} training stopped early")
    torch.cuda.synchronize()
    end = time.perf_counter()
    return (b, read_counts(), graphs.REPLAYS["graph_replays"],
            _iteration_s(stamps, end), host)


def _check_boosting_scores(b, X, Xh, what):
    """The holdout score within 1e-5 of the served trees' prediction, the
    training score within 1e-4 of it on the first ``TRAIN_SLICE`` rows;
    returns both differences."""
    g = b._gbdt
    score = g.valid_sets[0].score.cpu().numpy()
    if score.shape != (N_HOLDOUT,) or not np.all(np.isfinite(score)):
        fail(f"{what}: the holdout score is not finite of its shape")
    dv = float(np.max(np.abs(score - b.predict(Xh, raw_score=True))))
    dt = float(np.max(np.abs(g.train_score()[:TRAIN_SLICE] - b.predict(
        X[:TRAIN_SLICE], raw_score=True))))
    if dv > 1e-5 or dt > 1e-4:
        fail(f"{what}: scores {dv} (holdout) and {dt} (training) from the "
             f"served trees' prediction")
    return dv, dt


def phase_boosting(torch, ltt, data, unsampled_s):
    """Phase 10: DART on wave255 without c2f and a random forest on
    exact255 at full width, with the holdout as a validation set: on CUDA
    graphs (the main path) and eagerly, the same trees, training and
    holdout scores bit for bit; kernel T once a tree in the scorer's graph
    (which routes only: the host tree's values are added after it lands);
    the scores against the trees' prediction, before and after
    ``rollback_one_iter``; the random forest's holdout AUC.  Then
    ``rollback_one_iter`` inside a ``fused_iters=5`` gbdt block.  Seconds
    an iteration beside the unsampled path's of phases 3-5, DART's host
    milliseconds, the device bytes of its kept leaf ids."""
    ds, Xh, yh = data
    X = ds.data
    out, counts_by = {}, {}
    for name, (params, n, path, names) in BOOSTING.items():
        b, counts, replays, iter_s, host = run_boosting(
            torch, ltt, ds, Xh, yh, params, n, eager=False)
        e = run_boosting(torch, ltt, ds, Xh, yh, params, n, eager=True)[0]
        g = b._gbdt
        _check_launches(counts, names + ("route",), name)
        if counts["route"] != n or replays <= 0:
            fail(f"{name}: kernel T ran {counts['route']} times in {n} "
                 f"trees, {replays} graph replays")
        scorer = g.valid_sets[0].scorer
        if scorer.graph is None or scorer.graph.kernel_launches() != 1:
            fail(f"{name}: the scorer's graph does not hold kernel T alone")
        _same_bits(b, e, f"{name}: graphs vs eager")
        if not np.array_equal(g.valid_sets[0].score.cpu().numpy(),
                              e._gbdt.valid_sets[0].score.cpu().numpy()):
            fail(f"{name}: the holdout scores differ between graphs and "
                 f"eager")
        del e
        dv, dt = _check_boosting_scores(b, X, Xh, name)
        auc = np_auc(yh, b.predict(Xh))
        if not 0.6 < auc <= 1.0:
            fail(f"{name}: holdout AUC {auc} is not that of a trained model")
        kept = g.leaf_idx_bytes() if hasattr(g, "leaf_idx_bytes") else 0
        seen = kernels_seen(scorer.graph.replay, 20, ROUTE_NAMES)
        if not all(k in seen for k in ROUTE_NAMES) or \
                LOOKUP_NAMES[0] in seen:
            fail(f"{name}: the profiler saw {_seen(seen)} in the scorer's "
                 f"replays, not kernel T alone")
        b.rollback_one_iter()
        if b.num_trees() != n - 1:
            fail(f"{name}: {b.num_trees()} trees after a rollback of {n}")
        rv, rt = _check_boosting_scores(b, X, Xh, f"{name} rolled back")
        row = dict(seconds_per_iteration=statistics.median(iter_s),
                   iteration_seconds=iter_s,
                   unsampled_seconds_per_iteration=unsampled_s[path],
                   holdout_auc=auc, holdout_score_diff=dv,
                   train_score_diff=dt, after_rollback=[rv, rt],
                   kernel_t_per_tree=counts["route"] / n,
                   scorer_graph_launches=scorer.graph.kernel_launches(),
                   scorer_seen_in_replay=seen, launches=counts)
        if host["drop"]:
            row.update(drop_host_ms=statistics.median(host["drop"]),
                       normalize_host_ms=statistics.median(
                           host["normalize"]),
                       dropped=host["dropped"],
                       kept_leaf_id_bytes=kept,
                       kept_bytes_per_tree=kept / n)
        out[name], counts_by[name] = row, counts
        print(f"{name}: {row['seconds_per_iteration']:.4f} s an iteration "
              f"(runs {[round(x, 4) for x in iter_s]}; unsampled {path} "
              f"{unsampled_s[path]:.4f}), kernel T {counts['route'] / n:g} "
              f"a tree, the scorer's graph {row['scorer_graph_launches']} "
              f"launch (the profiler saw {_seen(seen)} a replay); holdout "
              f"AUC {auc:.5f}; scores from the prediction "
              f"{dv:.3g} / {dt:.3g}, after a rollback {rv:.3g} / {rt:.3g}; "
              f"graphs and eager the same bits"
              + (f"; drops {row['drop_host_ms']:.2f} ms and normalize "
                 f"{row['normalize_host_ms']:.2f} ms of host time an "
                 f"iteration, kept leaf ids {kept / 2 ** 20:.1f} MiB "
                 f"({kept / n / 2 ** 20:.2f} a tree)" if host["drop"]
                 else ""), flush=True)
        del b, g, scorer
        torch.cuda.empty_cache()
    # rollback inside a fused block: the bias iteration, then 3 trees of a
    # block of 5 served
    p = dict(TRAIN_PARAMS, **WAVE_PARAMS, device_type=DEVICE,
             fused_iters=FUSED_K, num_iterations=N_TREES)
    b = ltt.Booster(p, ds)
    for _ in range(4):
        b.update()
    b.rollback_one_iter()
    dt = float(np.max(np.abs(b._gbdt.train_score()[:TRAIN_SLICE] - b.predict(
        X[:TRAIN_SLICE], raw_score=True))))
    if b.num_trees() != 3 or dt > 1e-4:
        fail(f"gbdt rollback inside a fused block: {b.num_trees()} trees, "
             f"training score {dt} from the prediction")
    for _ in range(3):
        b.update()
    if b._gbdt.block_sizes != [1, FUSED_K, FUSED_K - 2]:
        fail(f"gbdt after a rollback inside a fused block: blocks "
             f"{b._gbdt.block_sizes}")
    out["fused-rollback"] = dict(train_score_diff=dt,
                                 block_sizes=b._gbdt.block_sizes)
    print(f"gbdt rollback inside a fused_iters={FUSED_K} block: training "
          f"score {dt:.3g} from the prediction, blocks after it "
          f"{b._gbdt.block_sizes}", flush=True)
    del b
    torch.cuda.empty_cache()
    return counts_by, out


CV_ROUNDS = 4


def phase_cv(torch, ltt):
    """Phase 8: ``cv`` reduced (50k rows, 3 folds, 4 rounds, exact at 31
    leaves) on the card and on the CPU: the same fold rows, logloss means
    and deviations within 1e-6, AUC within 1e-4 (card and CPU leaf values
    may differ by an ulp, and rows that close may swap)."""
    X, y = make_higgs_shaped(50_000, N_FEATURES, seed=3)
    out = {}
    for dev in (DEVICE, "cpu"):
        p = dict(TRAIN_PARAMS, num_leaves=31, device_type=dev,
                 metric="auc,binary_logloss")
        t0 = time.perf_counter()
        out[dev] = ltt.cv(p, ltt.Dataset(X, label=y, params=p),
                          num_boost_round=CV_ROUNDS, nfold=3, seed=1)
        print(f"cv on {dev}: {time.perf_counter() - t0:.2f} s", flush=True)
    worst = {}
    for k, v in out["cpu"].items():
        a = np.asarray(out[DEVICE][k])
        if a.shape != (CV_ROUNDS,) or not np.all(np.isfinite(a)):
            fail(f"cv {k}: {a}")
        worst[k] = float(np.max(np.abs(a - np.asarray(v))))
        if worst[k] > (1e-4 if "auc" in k else 1e-6):
            fail(f"cv {k} differs between the card and the CPU by "
                 f"{worst[k]}")
    if out[DEVICE]["valid auc-mean"][-1] < 0.6:
        fail("cv AUC is not that of a trained model")
    print(f"cv: 3 folds on the card as on the CPU, max differences "
          f"{worst}", flush=True)
    return {k: v for k, v in out[DEVICE].items()}


# phase 11: bench.py's multiclass shape (bench.py:2333-2343): 1M x 28, 5
# classes, 63 leaves, wave255's params (base_params with wave_splits and
# use_quantized_grad; coarse-to-fine at its default); a 100k-row holdout
# drawn next from the same generator
MC_ROWS, MC_HOLDOUT, MC_CLASSES = 1_000_000, 100_000, 5
MC_PARAMS = {"objective": "multiclass", "num_class": MC_CLASSES,
             "num_leaves": 63, "max_bin": 255, "learning_rate": 0.1,
             "min_sum_hessian_in_leaf": 100.0, "min_data_in_leaf": 0,
             "verbose": -1, "metric": "None", "wave_splits": True,
             "use_quantized_grad": True}
MC_WAVE_NAMES = ("multi_histogram", "window_histogram", "routed_histogram",
                 "lanes_window_histogram", "leaf_stats", "leaf_lookup")
MC_EXACT_PARAMS = {k: v for k, v in MC_PARAMS.items()
                   if k not in ("wave_splits", "use_quantized_grad")}
# (params, iterations, names of the kernels the run must launch, whether
# the 100k holdout is a validation set); the last four: K > 1 under GOSS,
# MVS, DART and a random forest
MC_CELLS = {
    "multiclass-wave255": (MC_PARAMS, 6, MC_WAVE_NAMES, False),
    "multiclassova-wave255": (dict(MC_PARAMS, objective="multiclassova"), 4,
                              MC_WAVE_NAMES, False),
    "multiclass-exact": (MC_EXACT_PARAMS, 3,
                         ("histogram", "best_split", "leaf_lookup"), False),
    "multiclass-goss-wave255": (dict(MC_PARAMS, boosting="goss"), 4,
                                MC_WAVE_NAMES + ("class_sum", "goss_select",
                                                 "sample_goss"), False),
    "multiclass-mvs-wave255": (dict(MC_PARAMS, boosting="mvs",
                                    bagging_fraction=0.5), 4,
                               MC_WAVE_NAMES + ("class_sum", "mvs_scan",
                                                "sample_mvs"), False),
    "multiclass-dart-wave255": (dict(MC_PARAMS, boosting="dart",
                                     drop_rate=0.3, skip_drop=0.0), 4,
                                MC_WAVE_NAMES + ("route",), True),
    "multiclassova-rf-exact": (dict(MC_EXACT_PARAMS, objective="multiclassova",
                                    boosting="rf", bagging_fraction=0.5,
                                    bagging_freq=1), 3,
                               ("histogram", "best_split", "leaf_lookup",
                                "sample_bag"), False),
}
# the class sum's launches: the GOSS and MVS cells'
MC_SAMPLED = ("multiclass-goss-wave255", "multiclass-mvs-wave255")
MC_METRICS = ("multi_logloss", "multi_error")


def make_multiclass(n_rows, n_holdout, n_features=28, k=MC_CLASSES):
    """bench.py's multiclass generator (bench.py:2337-2341), copied, then
    the holdout from the same stream."""
    rng = np.random.RandomState(17)
    X = rng.randn(n_rows, n_features).astype(np.float32)
    y = (X[:, :k] + 0.5 * rng.randn(n_rows, k)).argmax(axis=1)
    Xh = rng.randn(n_holdout, n_features).astype(np.float32)
    yh = (Xh[:, :k] + 0.5 * rng.randn(n_holdout, k)).argmax(axis=1)
    return X, y.astype(np.float32), Xh, yh.astype(np.float32)


def run_cell(torch, ltt, ds, params, n_iter, eager, what, valid=None):
    """``n_iter`` iterations through ``Booster.update`` on the graphs (the
    first tree eager, the graphs captured at the second) or eagerly, with
    ``valid`` (a Dataset) as a validation set where given, the launch
    counters set to 0 just before and read just after; a refitting
    objective's renewals timed (host ms, synchronised).  Returns the
    booster, seconds of each iteration after the first, the kernel
    launches executed, graph replays and the renewals' ms."""
    from lightgbm_tpu_torch import objectives as tobj
    from lightgbm_tpu_torch.ops import graphs
    b = ltt.Booster(params=dict(params, num_iterations=n_iter),
                    train_set=ds, _eager=eager)
    if valid is not None:
        b.add_valid(valid, "holdout")
    obj = b._gbdt.objective
    renew_ms = []
    if obj.renews:
        inner = obj.renew_tree_output

        def timed(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inner(*a)
            torch.cuda.synchronize()
            renew_ms.append((time.perf_counter() - t0) * 1e3)
        obj.renew_tree_output = timed
    for k in tobj.RENEW_STATS:
        tobj.RENEW_STATS[k] = 0
    reset_counts()
    torch.cuda.synchronize()
    stamps = [time.perf_counter()]
    for _ in range(n_iter):
        if b.update():
            fail(f"{what}: training stopped early")
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    counts = read_counts()
    if b.num_trees() != n_iter * b.num_tree_per_iteration:
        fail(f"{what}: {b.num_trees()} trees after {n_iter} iterations")
    return {"booster": b, "iter_s": list(np.diff(stamps)[1:]),
            "counts": counts, "replays": graphs.REPLAYS["graph_replays"],
            "renew_ms": renew_ms, "renew_stats": dict(tobj.RENEW_STATS)}


def graphed_and_eager(torch, ltt, ds, params, n_iter, names, what,
                      valid=None):
    """One cell graphed and eager: the same trees and training score bit
    for bit (and validation score, with ``valid``), the same kernel
    launches executed, each kernel of ``names`` launched; returns the
    graphed run (the eager booster freed)."""
    g = run_cell(torch, ltt, ds, params, n_iter, False, what, valid)
    e = run_cell(torch, ltt, ds, params, n_iter, True, f"{what} eager",
                 valid)
    _same_bits(g["booster"], e["booster"], f"{what}: graphs vs eager")
    if valid is not None and not torch.equal(
            g["booster"]._gbdt.valid_sets[0].score,
            e["booster"]._gbdt.valid_sets[0].score):
        fail(f"{what}: the holdout scores differ between graphs and eager")
    if g["counts"] != e["counts"]:
        fail(f"{what}: kernel launches executed differ between graphs "
             f"{g['counts']} and eager {e['counts']}")
    if g["booster"]._gbdt.runner.use_graphs and g["replays"] == 0:
        fail(f"{what}: no graph replays on the graphed run")
    _check_launches(g["counts"], names, what)
    g["eager_iter_s"] = e["iter_s"]
    del e["booster"]
    return g


def _train_score_vs_prediction(b, X, what, rows=TRAIN_SLICE, atol=1e-4):
    """The training score of the first ``rows`` rows within ``atol`` of
    the trees' prediction (float32 score against float64 sums)."""
    score = b._gbdt.train_score()
    score = score[..., :rows]
    pred = b.predict(X[:rows], raw_score=True)
    if score.ndim == 2:
        pred = pred.T
    diff = float(np.max(np.abs(score - pred)))
    if not diff <= atol:
        fail(f"{what}: training score {diff} from the trees' prediction")
    return diff


def phase_multiclass(torch, ltt):
    """Phase 11: bench.py's multiclass shape at full width, each cell of
    ``MC_CELLS`` graphed and eager (the same bits and launches; the DART
    cell with the 100k holdout as a validation set, its holdout scores the
    same bits and within 1e-5 of the trees' prediction), the training
    score within 1e-4 of the trees' prediction; then the softmax cell
    through ``train`` with the holdout as a validation set
    (``metric=multi_logloss,multi_error``): its score within 1e-5 of
    ``predict(raw_score=True)``, the metrics within 1e-9 of their numpy
    formulas, multi_error below 0.5.  Seconds an iteration and a tree,
    the kernels' launches a class tree."""
    t0 = time.perf_counter()
    X, y, Xh, yh = make_multiclass(MC_ROWS, MC_HOLDOUT)
    print(f"multiclass data generation: {time.perf_counter() - t0:.1f} s",
          flush=True)
    out, counts_by = {}, {}
    ds = ltt.Dataset(X, label=y, params=dict(
        MC_PARAMS, device_type=DEVICE)).construct()
    valid = ds.create_valid(Xh, label=yh).construct()
    for cell, (params, n_iter, names, holdout) in MC_CELLS.items():
        p = dict(params, device_type=DEVICE)
        r = graphed_and_eager(torch, ltt, ds, p, n_iter, names, cell,
                              valid if holdout else None)
        b = r["booster"]
        K = b.num_tree_per_iteration
        diff = _train_score_vs_prediction(b, X, cell, atol=1e-4)
        it_s = statistics.median(r["iter_s"])
        per_tree = {k: v / (n_iter * K) for k, v in r["counts"].items()
                    if v}
        out[cell] = {"seconds_per_iteration": it_s,
                     "seconds_per_tree": it_s / K,
                     "iteration_seconds": r["iter_s"],
                     "eager_seconds_per_iteration":
                     statistics.median(r["eager_iter_s"]),
                     "launches_per_class_tree": per_tree,
                     "graph_replays_per_tree": r["replays"] / (n_iter * K),
                     "refine_shift": b._gbdt.grow_params.refine_shift,
                     "train_score_vs_prediction": diff}
        if holdout:
            score = b._gbdt.valid_sets[0].score.cpu().numpy().T
            sdiff = float(np.max(np.abs(score - b.predict(
                Xh, raw_score=True))))
            if not sdiff <= 1e-5:
                fail(f"{cell}: the holdout score is {sdiff} from the trees' "
                     f"prediction")
            out[cell]["holdout_score_vs_prediction"] = sdiff
        if p.get("boosting") == "dart":
            out[cell]["kept_leaf_id_bytes"] = b._gbdt.leaf_idx_bytes()
        counts_by[cell] = r["counts"]
        eager_s = out[cell]["eager_seconds_per_iteration"]
        print(f"{cell}: {n_iter} iterations x {K} trees, graphs and eager "
              f"the same bits and launches; s/iteration {it_s:.4f} (a tree "
              f"{it_s / K:.4f}; eager {eager_s:.4f}), launches a class tree "
              f"{per_tree}", flush=True)
        del b, r
    # the softmax cell with the holdout as a validation set
    params, n_iter, names, _ = MC_CELLS["multiclass-wave255"]
    p = dict(params, device_type=DEVICE, metric=",".join(MC_METRICS))
    res, clock = {}, _Clock(torch)
    reset_counts()
    torch.cuda.synchronize()
    b = ltt.train(p, ds, num_boost_round=n_iter, valid_sets=[valid],
                  valid_names=["holdout"], evals_result=res,
                  callbacks=[clock], verbose_eval=False)
    torch.cuda.synchronize()
    # iterations after the first (its warm-up tree and the capture)
    stamps = clock.t + [time.perf_counter()]
    valid_iter_s = list(np.diff(stamps)[1:])
    valid_s = statistics.median(valid_iter_s)
    counts = read_counts()
    score = b._gbdt.valid_sets[0].score.cpu().numpy().T
    pred = b.predict(Xh, raw_score=True)
    sdiff = float(np.max(np.abs(score - pred)))
    if score.shape != (MC_HOLDOUT, MC_CLASSES) or not sdiff <= 1e-5:
        fail(f"multiclass holdout score {score.shape} is {sdiff} from the "
             f"trees' prediction")
    e = np.exp(score - score.max(axis=1, keepdims=True))
    prob = e / e.sum(axis=1, keepdims=True)
    rows = np.arange(MC_HOLDOUT)
    want = {"multi_logloss": float(np.mean(-np.log(np.clip(
                prob[rows, yh.astype(np.int64)], 1e-15, 1.0)))),
            "multi_error": float(np.mean(prob.argmax(axis=1) != yh))}
    for m in MC_METRICS:
        got = res["holdout"][m][-1]
        if not abs(got - want[m]) <= 1e-9:
            fail(f"multiclass holdout {m} {got} vs numpy {want[m]}")
    if not want["multi_error"] < 0.5:
        fail(f"multiclass holdout multi_error {want['multi_error']} is not "
             f"that of a trained model (chance is 0.8)")
    if counts.get("leaf_lookup_f64", 0) != n_iter * MC_CLASSES or \
            counts.get("route", 0) != n_iter * MC_CLASSES:
        fail(f"multiclass holdout scorer: {counts} (kernels T and L's "
             f"float64 mode once a class tree)")
    out["multiclass-wave255-valid"] = {
        "seconds_per_iteration": valid_s, "iteration_seconds": valid_iter_s,
        "holdout": want,
        "score_vs_prediction": sdiff,
        "launches_per_class_tree": {k: v / (n_iter * MC_CLASSES)
                                    for k, v in counts.items() if v}}
    counts_by["multiclass-wave255-valid"] = counts
    print(f"multiclass with the 100k holdout: {want}, score vs prediction "
          f"{sdiff:.3g}, s/iteration {valid_s:.4f} (launches {counts})",
          flush=True)
    del b, ds, valid
    torch.cuda.empty_cache()
    return counts_by, out


# phase 12: the regression zoo at the Higgs width on phase 3's matrix.
# The label: z = 0.5 * X[:, :6] @ w + 0.3 * X0 * X1 + 0.5 * noise (w and
# the noise from RandomState(5)); MAPE's positive label is exp(z)
REG_CELLS = {
    "l1-exact255": ({"objective": "regression_l1"}, ("histogram",
                                                     "best_split",
                                                     "leaf_lookup")),
    "quantile-wave255-noc2f": (dict(WAVE_PARAMS, objective="quantile",
                                    alpha=0.9),
                               ("multi_histogram", "routed_histogram",
                                "leaf_stats", "best_split", "leaf_lookup")),
    "mape-wave255": (dict(WAVE255_PARAMS, objective="mape"),
                     ("multi_histogram", "window_histogram",
                      "routed_histogram", "lanes_window_histogram",
                      "leaf_stats", "leaf_lookup")),
}
REG_TREES = 4


def regression_label(X):
    rng = np.random.RandomState(5)
    w = rng.randn(6).astype(np.float32)
    z = 0.5 * (X[:, :6] @ w) + 0.3 * X[:, 0] * X[:, 1]
    return (z + 0.5 * rng.randn(len(X)).astype(np.float32)).astype(
        np.float32)


def renew_profile(torch, b):
    """One renewal of the last tree again under ``torch.profiler``: wall
    ms, device busy ms and its share."""
    import copy

    from lightgbm_tpu_torch.tools.prof_iteration import profile_window
    g = b._gbdt
    tree = copy.deepcopy(g.models[-1])
    slot = g._fused_block["slot"]
    obj = g.objective
    fn = type(obj).renew_tree_output

    def call():
        fn(obj, tree, slot["start"], slot["leaf_idx"][0, :g.num_data],
           g._mask)
    wall_s, busy_us, seen, _ = profile_window(torch, call)
    return {"wall_ms": wall_s * 1e3,
            "device_ms": busy_us / 1e3 if seen else None,
            "device_share": busy_us / 1e6 / wall_s if seen else None}


def phase_regression(torch, ltt, data):
    """Phase 12: L1 on exact255 (unweighted renewal), quantile at alpha
    0.9 on wave255 without c2f, MAPE on wave255 with c2f (weighted
    renewal: the host pass of the sequential float32 sums), 4 trees each,
    graphed and eager (the same bits and launches); the training score
    within 1e-4 of the trees' prediction on the first 500k rows; the
    renewal's ms a tree, its device share and the rows its weights sent
    to the host."""
    ds0 = data[0]
    X = ds0.raw_mat
    t0 = time.perf_counter()
    z = regression_label(X)
    labels = {"l1-exact255": z, "quantile-wave255-noc2f": z,
              "mape-wave255": np.exp(z)}
    print(f"regression labels: {time.perf_counter() - t0:.1f} s",
          flush=True)
    out, counts_by = {}, {}
    for cell, (extra, names) in REG_CELLS.items():
        p = dict(TRAIN_PARAMS, **extra, device_type=DEVICE)
        ds = ltt.Dataset(X, label=labels[cell], reference=ds0,
                         params=p).construct()
        r = graphed_and_eager(torch, ltt, ds, p, REG_TREES, names, cell)
        b = r["booster"]
        diff = _train_score_vs_prediction(b, X, cell)
        prof = renew_profile(torch, b)
        it_s = statistics.median(r["iter_s"])
        out[cell] = {"seconds_per_iteration": it_s,
                     "iteration_seconds": r["iter_s"],
                     "eager_seconds_per_iteration":
                     statistics.median(r["eager_iter_s"]),
                     "renew_ms_per_tree": r["renew_ms"],
                     "renew_profile": prof,
                     "host_rows_per_tree": r["renew_stats"]["host_rows"] /
                     REG_TREES,
                     "row_order_leaves": r["renew_stats"][
                         "row_order_leaves"],
                     "launches_per_tree": {k: v / REG_TREES for k, v in
                                           r["counts"].items() if v},
                     "train_score_vs_prediction": diff}
        counts_by[cell] = r["counts"]
        print(f"{cell}: {REG_TREES} trees graphed and eager the same bits "
              f"and launches; s/iteration {it_s:.4f} (eager "
              f"{out[cell]['eager_seconds_per_iteration']:.4f}), renewal "
              f"ms a tree {[round(v, 2) for v in r['renew_ms']]}, profiled "
              f"{prof}, rows to the host a tree "
              f"{out[cell]['host_rows_per_tree']:.0f}, training score vs "
              f"prediction {diff:.3g}", flush=True)
        del b, r, ds
        torch.cuda.empty_cache()
    return counts_by, out


# phase 2's kernel U and phase 13: bench.py's MS-LTR row (bench.py:2231-2279:
# RandomState(11), 9,999 queries of 227 documents, 136 features; relevance
# X0 + 0.5 X1 + 0.8 noise cut at its 60/80/92/98th percentiles into labels
# 0-4), wave255's parameters as bench.py runs the row; a 1,000-query holdout
# drawn next from the same generator (the training set's cut points)
RANK_QUERIES, RANK_DOCS, RANK_FEATURES = 9_999, 227, 136
RANK_HOLDOUT_QUERIES = 1_000
RANK_EVAL_AT = [1, 3, 5, 10]
RANK_PARAMS = {"objective": "lambdarank", "num_leaves": 255, "max_bin": 255,
               "learning_rate": 0.1, "min_sum_hessian_in_leaf": 100.0,
               "min_data_in_leaf": 0, "verbose": -1, "metric": "ndcg",
               "eval_at": RANK_EVAL_AT, "wave_splits": True,
               "use_quantized_grad": True}
RANK_NAMES = ("lambdarank", "multi_histogram", "window_histogram",
              "routed_histogram", "lanes_window_histogram", "leaf_stats",
              "leaf_lookup")
# the subset whose NDCG shows that ranking was learned (bench.py:2264)
RANK_SUBSET_QUERIES = 200
# the skewed set of kernel U's checks: queries split across blocks (20,000
# documents, 11,520, 3,000; 257 just above a block's band of 256),
# queries of one document, sizes around a band and a tile's edges (31, 32,
# 33, 65), and a query whose documents share one label (SKEWED_ONE_LABEL)
SKEWED_COUNTS = (1, 20_000, 1, 2, 255, 256, 257, 1, 3000, 1, 11_520, 17, 31,
                 32, 33, 65, 300)
SKEWED_ONE_LABEL = 16
# the card's float64 rate outside the tensor cores: 64 FMA lanes an SM a
# clock, 2 operations each (33.4 TFLOP/s at 132 SMs and 1980 MHz)
FP64_LANES = 64
# the float64 operations one unordered pair of documents with different
# labels needs (ops/rank.py's formula): the score, gain and discount
# differences (3), delta's two products, the clip's two bounds, the scale
# by 2 sigmoid, exp, 1 + exp, 2 / that, delta p, 2 - p and eta's two
# products (12 together), and each document's g and h sums (4); an exp and
# a division count as one operation each
PAIR_FP64_OPS = 19
# lambdamart_norm's 0.01 + |ds| and its division, when a query's scores
# are not all equal
NORM_FP64_OPS = 2


def make_msltr(n_queries, docs, n_features, n_holdout_queries=0):
    """bench.py's MS-LTR generator (bench.py:2239-2246), copied, then a
    holdout of ``n_holdout_queries`` from the same stream cut at the
    training set's percentiles -> (X, y, counts, Xh, yh, counts_h)."""
    rng = np.random.RandomState(11)
    n = n_queries * docs
    X = rng.randn(n, n_features).astype(np.float32)
    rel = X[:, 0] + 0.5 * X[:, 1] + 0.8 * rng.randn(n)
    cuts = np.percentile(rel, [60, 80, 92, 98])
    y = np.clip(np.digitize(rel, cuts), 0, 4).astype(np.float32)
    nh = n_holdout_queries * docs
    Xh = rng.randn(nh, n_features).astype(np.float32)
    relh = Xh[:, 0] + 0.5 * Xh[:, 1] + 0.8 * rng.randn(nh)
    yh = np.clip(np.digitize(relh, cuts), 0, 4).astype(np.float32)
    return (X, y, np.full(n_queries, docs, np.int64), Xh, yh,
            np.full(n_holdout_queries, docs, np.int64))


def np_ndcg(label, score, counts, k, gains):
    """Mean NDCG@k over queries of ``counts`` rows, in numpy: a stable
    descending order of the score, gains ``gains[label]``, a query with
    no relevant row counting 1 (the reference's convention)."""
    out = []
    lo = 0
    for m in counts:
        g = gains[label[lo:lo + m].astype(np.int64)]
        s = score[lo:lo + m]
        lo += m
        if g.sum() <= 0:
            out.append(1.0)
            continue
        top = g[np.argsort(-s, kind="stable")[:k]]
        ideal = np.sort(g)[::-1][:k]
        disc = 1.0 / np.log2(np.arange(2, k + 2, dtype=np.float64))
        out.append(np.sum(top * disc[:len(top)]) /
                   np.sum(ideal * disc[:len(ideal)]))
    return float(np.mean(out))


def _ulps(torch, a, b):
    """|a - b| in float32 ulps (by the integer order of the bits)."""
    def key(t):
        i = t.view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (key(a) - key(b)).abs()


def _explain_ulp(torch, tr, lay, score, weight, doc, which, k_val, norm):
    """True when document ``doc``'s one-ulp difference in its gradient
    (``which`` 0) or hessian (1) is the order of its float64 sum: its
    terms summed in kernel U's order (``ops/rank.py``'s docstring,
    replayed by ``replay_sums`` for the document's query and band) round
    to the kernel's float32 value, and their exact sum (``math.fsum``)
    lies within 1e-12 of a float32 rounding boundary, where another
    float64 order (the plain version's ``torch.sum``) may round to the
    other side."""
    import math
    qb = lay.qb.cpu().numpy()
    q = int(np.searchsorted(qb, doc, side="right") - 1)
    lo, m = int(qb[q]), int(qb[q + 1] - qb[q])
    # the document's band: its position in the query's label order
    pos = int(np.nonzero(lay.perm[lo:lo + m].cpu().numpy() == doc)[0][0])
    bands = -(-m // tr.BAND_DOCS)
    band = (bands * tr.BAND_DOCS - m + pos) // tr.BAND_DOCS
    model = tr.replay_sums(score.cpu(), lay, 1.0, norm, queries=[q],
                           band=band)[which][doc]
    s = score[lo:lo + m].to(torch.float64)[None]
    lab = lay.label[lo:lo + m][None]
    gn = lay.gain[lo:lo + m].to(torch.float64)[None]
    j = torch.arange(m, device=s.device)
    rk = ((s[0][None, :] > s[0][:, None]) |
          ((s[0][None, :] == s[0][:, None]) & (j[None, :] < j[:, None]))
          ).sum(1)
    disc = lay.disc[rk][None]
    valid = torch.ones((1, m), dtype=torch.bool, device=s.device)
    inv = lay.inv_max[q:q + 1].to(torch.float64)
    scaled, factored, e = tr.exponentials(s, valid, 2.0)
    i = doc - lo
    row = tr.pair_terms(s, lab, gn, disc, valid, inv, scaled,
                        slice(i, i + 1), 2.0, norm, factored,
                        e)[which][0, 0].cpu()
    seq = model.to(torch.float32)
    w = torch.ones(()) if weight is None else weight[doc].cpu()
    exact = math.fsum(row.tolist())
    f = np.float32(exact)
    nb = np.nextafter(f, np.float32(np.inf if exact > f else -np.inf))
    mid = (float(f) + float(nb)) / 2
    return bool(seq * w == k_val.cpu()) and \
        abs(exact - mid) <= 1e-12 * abs(mid)


def check_rank(torch, tr, lay, score, ctx, weight=None, norm=True):
    """Kernel U against its plain version on the same CUDA tensors and a
    repeat launch: the repeat bit for bit; each document within one
    float32 ulp of the plain version, and every one-ulp document explained
    by its float64 sum's order (``_explain_ulp``).  Returns (the count of
    one-ulp documents, the largest |U - plain| over grad and hess)."""
    g, h = (t.clone() for t in tr.lambda_gradients(score, lay, weight, 1.0,
                                                    norm))
    g2, h2 = (t.clone() for t in tr.lambda_gradients(score, lay, weight,
                                                      1.0, norm))
    gp, hp = tr.lambdarank_plain(score, lay, weight, 1.0, norm)
    torch.cuda.synchronize()
    if not (torch.equal(g.view(torch.int32), g2.view(torch.int32)) and
            torch.equal(h.view(torch.int32), h2.view(torch.int32))):
        fail(f"kernel U gave other bits on a repeat launch ({ctx})")
    ulp1, err = 0, 0.0
    for which, (k, p, what) in enumerate(((g, gp, "grad"),
                                          (h, hp, "hess"))):
        if not bool(torch.isfinite(k).all()):
            fail(f"kernel U's {what} is not finite ({ctx})")
        err = max(err, float((k.double() - p.double()).abs().max()))
        d = _ulps(torch, k, p)
        if int(d.max()) > 1:
            fail(f"kernel U's {what} is {int(d.max())} ulp from its plain "
                 f"version ({ctx})")
        docs = torch.nonzero(d == 1).flatten().tolist()
        ulp1 += len(docs)
        for doc in docs[:20]:
            if not _explain_ulp(torch, tr, lay, score, weight, doc, which,
                                k[doc], norm):
                fail(f"kernel U's {what} of document {doc} is one ulp from "
                     f"its plain version and not by its sum's order ({ctx})")
    return ulp1, err


def event_ms(fn, reps):
    """Device milliseconds of one call of ``fn``, each call alone between
    its own CUDA event pair after a synchronise (no queue to hide the
    host's launch), the mean over ``reps`` after one warm-up call."""
    import torch
    fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def rank_launches(call):
    """The launch counters' rise over one call of ``call``: kernel U once,
    and no other kernel."""
    before = read_counts()
    call()
    launched = {k: v - before[k] for k, v in read_counts().items()
                if v != before[k]}
    if launched != {"lambdarank": 1}:
        fail(f"kernel U: the launch counters rose by {launched} over a "
             f"call, not one launch")
    return launched


def rank_pairs(lay):
    """Unordered pairs of documents with different labels, summed over
    queries: the pairs the lambdas need (each adds to both documents)."""
    lab = lay.label.cpu().numpy().astype(np.int64)
    qb = np.concatenate([[0], np.cumsum(lay.counts)])
    q = np.repeat(np.arange(len(lay.counts)), lay.counts)
    per = np.zeros((len(lay.counts), int(lab.max()) + 1), np.int64)
    np.add.at(per, (q, lab), 1)
    same = (per * (per - 1) // 2).sum()
    m = np.diff(qb)
    return int((m * (m - 1) // 2).sum() - same)


def pair_ops():
    """The kernel's own instructions a step of its pair loop, by pipe
    (``tools/sass_ops.py``'s ``fp64_loops``: a step of a tile pair is one
    unordered pair, each lane's, with its column sums' shuffles; the
    factored and the direct version): a reading of the kernel's overhead
    beside the bound, not the bound."""
    from lightgbm_tpu_torch.tools import sass_ops
    counts = sass_ops.kernel_counts("rank.cu")
    loops = [c["fp64_loops"] for k, c in counts.items()
             if "lambda_kernel" in k]
    # the pair loop's versions (masks; p factored or direct) all divide
    steps = [x for x in loops[0] if x["mufu"] >= 1] if len(loops) == 1 \
        else []
    if not steps:
        fail(f"the SASS of kernel U's pair loop: {counts}")
    # the factored step (no exp: the fewest float64 instructions), the
    # direct one (the most) beside it
    fewest = min(steps, key=lambda x: (x["fp64"], x["total"]))
    most = max(steps, key=lambda x: (x["fp64"], x["total"]))
    return dict(fewest, direct_total=most["total"], direct_fp64=most["fp64"],
                versions=len(steps),
                opcodes={"factored": fewest["opcodes"],
                         "direct": most["opcodes"]})


def rank_bound_ms(pairs, ops_per_pair, clock_mhz, sms):
    """The float64 pipe's least time for ``pairs`` unordered pairs of
    ``ops_per_pair`` float64 operations each: 2 operations a lane a clock
    (an FMA), ``FP64_LANES`` lanes an SM."""
    peak = 2 * FP64_LANES * sms * clock_mhz * 1e6
    return pairs * ops_per_pair / peak * 1e3


def split_path_taken(torch, tr, lay, score, q):
    """Whether kernel U took the split path for query ``q`` at run time:
    every float64 partial of its ``PAIR`` items, NaN before the launch, is
    written by it, and the launch leaves its sync words zero."""
    items = lay.items.cpu().numpy()
    mine = np.nonzero((items[:, 0] == tr.PAIR) & (items[:, 1] == q))[0]
    if not len(mine) or not (items[items[:, 1] == q, 0] == tr.PREP).any():
        return False
    lay.scratch.fill_(float("nan"))
    tr.lambda_gradients(score, lay, None, 1.0, True)
    torch.cuda.synchronize()
    soff = lay.soff.cpu().numpy()
    for i in mine:
        words = (2 if items[i, 2] == items[i, 3] else 4) * tr.BAND_DOCS
        if not bool(torch.isfinite(lay.scratch[soff[i]:soff[i] + words])
                    .all()):
            return False
    stream = torch.cuda.current_stream(score.device).cuda_stream
    return not bool(tr.sync_words(score.device, stream).any())


# kernel U before its redesign (one block a query, each thread walking
# every pair of its documents; an earlier checkout's csrc/rank.cu): its C
# interface, and the shared-memory limit its wrapper used
OLD_U_ARGS = ("P", "P", "I", "P", "P", "P", "P", "P", "D", "I", "I", "P",
              "P", "P", "P")
OLD_U_SMEM_DOCS = 11520


def old_u(torch, dev, shapes, new_calls):
    """Kernel U before its redesign, built from the source that the
    environment's ``LTT_OLD_U`` names, beside the new kernel in one run:
    for each shape (name -> (score, layout)), ms of old, new, new, old
    back to back (``cuda_ms``), and the largest float32 ulp distance of
    the old kernel's output from the new one's.  None without
    ``LTT_OLD_U``."""
    import ctypes
    src = os.environ.get("LTT_OLD_U")
    if not src:
        return None
    from lightgbm_tpu_torch.ops import kernels
    lib_path = os.path.splitext(src)[0] + ".so"
    build = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                            "-o", lib_path, src], capture_output=True,
                           text=True)
    if build.returncode != 0:
        fail(f"the old kernel U did not build: {build.stdout}"
             f"{build.stderr}")
    fn = ctypes.CDLL(lib_path).ltt_lambdarank
    types = {"P": ctypes.c_void_p, "I": ctypes.c_int, "D": ctypes.c_double}
    fn.argtypes = [types[a] for a in OLD_U_ARGS]
    fn.restype = ctypes.c_int
    out = {}
    for name, (score, lay) in shapes.items():
        n, counts = lay.num_data, lay.counts
        fits = counts[counts <= OLD_U_SMEM_DOCS]
        smem_docs = int(fits.max()) if len(fits) else 0
        scratch = torch.empty(n, dtype=torch.float64, device=dev) \
            if counts.max() > OLD_U_SMEM_DOCS else None
        gh = [torch.empty(n, dtype=torch.float32, device=dev)
              for _ in range(2)]
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call():
            rc = fn(score.data_ptr(), lay.qb.data_ptr(), lay.num_queries,
                    lay.label.data_ptr(), lay.gain.data_ptr(),
                    lay.inv_max.data_ptr(), lay.disc.data_ptr(), None, 2.0,
                    1, smem_docs, None if scratch is None else
                    scratch.data_ptr(), gh[0].data_ptr(), gh[1].data_ptr(),
                    stream)
            if rc != 0:
                fail(f"the old kernel U did not launch: {rc}")
        reps = 2 if counts.max() > OLD_U_SMEM_DOCS else 10
        times = [cuda_ms(call, reps), cuda_ms(new_calls[name], reps),
                 cuda_ms(new_calls[name], reps), cuda_ms(call, reps)]
        g, h = new_calls[name]()
        torch.cuda.synchronize()
        ulps = max(int(_ulps(torch, gh[0], g).max()),
                   int(_ulps(torch, gh[1], h).max()))
        out[name] = {"old_ms": [times[0], times[3]],
                     "new_ms": [times[1], times[2]],
                     "max_ulps_old_vs_new": ulps}
    print(f"kernel U, old (LTT_OLD_U) against new in one run, ms old, new, "
          f"new, old: {out}", flush=True)
    return out


def phase_kernels_rank(torch, dev, X, y, counts):
    """Phase 2's kernel U: against its plain version (``check_rank``) at
    the MS-LTR shape (the all-equal first iteration and a trained-like
    score), its first 500 queries, and the skewed set (queries split
    across blocks, the 20,000-document one checked to take the split path;
    queries of one document, at tile edges and of one label), with weights
    and without ``lambdamart_norm`` too; at the MS-LTR shape its time,
    device time and CUDA launches a call, its bound from the float64
    operations its pairs need, its own pair step's SASS as a reading, the
    plain version's time; the kernel before its redesign beside it when
    ``LTT_OLD_U`` names its source."""
    from lightgbm_tpu_torch.objectives import default_label_gain
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.ops import rank as tr
    gains = default_label_gain()
    n = len(y)
    qb = np.concatenate([[0], np.cumsum(counts)])
    lay = tr.rank_layout(qb, y, gains, 20, dev)
    g = torch.Generator(device=dev).manual_seed(12)
    trained = (torch.from_numpy(0.3 * X[:, 0] + 0.15 * X[:, 1]).to(dev) +
               0.05 * torch.randn(n, generator=g, device=dev)).float()
    equal = torch.zeros(n, dtype=torch.float32, device=dev)
    ulp1, errs = {}, {}
    for name, score in (("all equal", equal), ("trained", trained)):
        ctx = f"msltr, {name}"
        ulp1[ctx], errs[ctx] = check_rank(torch, tr, lay, score,
                                          f"MS-LTR shape, {name}")
    n500 = 500 * RANK_DOCS
    lay500 = tr.rank_layout(qb[:501], y[:n500], gains, 20, dev)
    ulp1["500 queries"], errs["500 queries"] = check_rank(
        torch, tr, lay500, trained[:n500], "500 queries")
    sk = np.asarray(SKEWED_COUNTS, np.int64)
    ns = int(sk.sum())
    ys = (y[:ns] if ns <= n else np.resize(y, ns)).copy()
    qbs = np.concatenate([[0], np.cumsum(sk)])
    ys[qbs[SKEWED_ONE_LABEL]:qbs[SKEWED_ONE_LABEL + 1]] = 2
    lays = tr.rank_layout(qbs, ys, gains, 20, dev)
    ss = trained[:ns] if ns <= n else trained.repeat(-(-ns // n))[:ns]
    if not split_path_taken(torch, tr, lays, ss, 1):
        fail("kernel U did not take its split path for the skewed set's "
             "20,000-document query")
    w = (torch.rand(ns, generator=g, device=dev) + 0.5).float()
    for ctx, kw in (("skewed", {}), ("skewed, weights", {"weight": w}),
                    ("skewed, no norm", {"norm": False}),
                    ("skewed, all equal", {})):
        score = torch.zeros_like(ss) if "equal" in ctx else ss
        ulp1[ctx], errs[ctx] = check_rank(torch, tr, lays, score, ctx, **kw)
    err = max(errs.values())
    print(f"kernel U: bit for bit on repeat launches; documents one ulp from "
          f"the plain version (each explained by its float64 sum's order): "
          f"{ulp1}; largest |U - plain| {errs}", flush=True)
    # readings at the MS-LTR shape, on the trained-like score
    call = lambda: tr.lambda_gradients(trained, lay, None, 1.0, True)  # noqa
    ms = cuda_ms(call, reps=10)
    dev_ms = event_ms(call, reps=10)
    launched = rank_launches(call)
    plain_ms = cuda_ms(lambda: tr.lambdarank_plain(trained, lay, None, 1.0,
                                                   True), reps=2)
    ms500 = cuda_ms(lambda: tr.lambda_gradients(trained[:n500], lay500, None,
                                                1.0, True), reps=10)
    ms_sk = cuda_ms(lambda: tr.lambda_gradients(ss, lays, None, 1.0, True),
                    reps=10)
    old = old_u(torch, dev, {"msltr": (trained, lay),
                             "500 queries": (trained[:n500], lay500),
                             "skewed": (ss, lays)},
                {"msltr": call,
                 "500 queries": lambda: tr.lambda_gradients(
                     trained[:n500], lay500, None, 1.0, True),
                 "skewed": lambda: tr.lambda_gradients(ss, lays, None, 1.0,
                                                       True)})
    per_pair = pair_ops()
    pairs = rank_pairs(lay)
    _, clock_top = clocks_line()
    sms = kernels.sm_count(dev)
    # every query of the trained-like score has scores that differ, so
    # lambdamart_norm divides each pair
    ops = PAIR_FP64_OPS + NORM_FP64_OPS
    ops_ms = rank_bound_ms(pairs, ops, clock_top, sms)
    # bytes: score, label, gain read; grad, hess written; the query table
    nbytes = 4 * n * 5 + 12 * len(counts)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    b_ms, b_by = (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")
    print(f"kernel U at the MS-LTR shape ({len(counts)} queries of "
          f"{RANK_DOCS}): {ms:.4f} ms, device {dev_ms:.4f} ms a launch alone "
          f"(events), counted {launched} a call (plain {plain_ms:.3f} ms); "
          f"bound {b_ms:.4f} ms by {b_by} ({pairs} unordered pairs with "
          f"different labels x {ops} float64 operations at 2 x "
          f"{FP64_LANES} an SM a clock, {clock_top:.0f} MHz x {sms} SMs; "
          f"bytes {bytes_ms:.4f} ms); the kernel's own pair step "
          f"{per_pair['total']} instructions ({per_pair['fp64']} float64, "
          f"{per_pair['mufu']} MUFU) with p factored, "
          f"{per_pair['direct_total']} ({per_pair['direct_fp64']} float64) "
          f"direct, a step an unordered pair ({per_pair['versions']} "
          f"versions; opcodes {per_pair['opcodes']}); 500 queries "
          f"{ms500:.4f} ms; skewed set {ms_sk:.3f} ms", flush=True)
    return dict(max_abs_err=err, ms=ms, device_ms=dev_ms,
                launches_per_call=launched["lambdarank"], plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                pairs=pairs, pair_fp64_ops=ops,
                pair_step_instructions=per_pair["total"],
                pair_step_fp64=per_pair["fp64"],
                pair_step_mufu=per_pair["mufu"],
                pair_step_direct_instructions=per_pair["direct_total"],
                pair_step_direct_fp64=per_pair["direct_fp64"],
                bytes_bound_ms=bytes_ms,
                ulp1_documents=ulp1, max_abs_err_by_shape=errs,
                ms_500_queries=ms500, ms_skewed=ms_sk, queries=len(counts),
                docs=RANK_DOCS, old_kernel=old)


def rank_share(torch, booster, iters=3):
    """Kernel U's device ms and its share of an iteration's time on the
    card, both by CUDA events: ``iters`` graphed iterations between one
    event pair (idle gaps, where the card waits on the host, included),
    and U launched alone ``iters`` times on the booster's own score and
    layout (``event_ms``)."""
    gbdt = booster._gbdt
    obj = gbdt.objective
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        booster.update()
    b.record()
    b.synchronize()
    iter_ms = a.elapsed_time(b) / iters
    u_ms = event_ms(lambda: obj.get_gradients(gbdt._score), iters)
    return {"iteration_ms": iter_ms, "kernel_u_ms": u_ms,
            "kernel_u_share": u_ms / iter_ms}


def _subset_ndcg(b, X, y, counts):
    """NDCG@{1,3,5,10} of the first ``RANK_SUBSET_QUERIES`` queries, the
    model's against a constant score's (the rows in their order)."""
    from lightgbm_tpu_torch.objectives import default_label_gain
    gains = default_label_gain()
    nq = RANK_SUBSET_QUERIES
    n = int(np.sum(counts[:nq]))
    pred = b.predict(X[:n], raw_score=True)
    model = {k: np_ndcg(y[:n], pred, counts[:nq], k, gains)
             for k in RANK_EVAL_AT}
    const = {k: np_ndcg(y[:n], np.zeros(n), counts[:nq], k, gains)
             for k in RANK_EVAL_AT}
    return model, const


def phase_ranking(torch, ltt, X, y, counts, Xh, yh, ch):
    """Phase 13: bench.py's MS-LTR row at full width (``msltr-lambdarank``:
    the Dataset's construction seconds; 6 iterations graphed, eager and at
    fused_iters=5, the same bits and launches; kernel U once a tree; its
    share of an iteration's device time; NDCG@10 of a 200-query training
    subset above a constant score's), then ``msltr-lambdarank-valid``
    (``train`` with the 1,000-query holdout as a grouped validation set:
    ndcg@1,3,5,10 within 1e-9 of a numpy NDCG of the fetched score, the
    score within 1e-5 of the trees' prediction)."""
    from lightgbm_tpu_torch.objectives import default_label_gain
    p = dict(RANK_PARAMS, device_type=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = ltt.Dataset(X, label=y, group=counts, params=p).construct()
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    print(f"msltr-lambdarank: Dataset construction {construct_s:.1f} s "
          f"({len(y)} x {X.shape[1]}, {len(counts)} queries)", flush=True)
    runs = run_paths(torch, ltt, ds, p, "msltr-lambdarank")
    main = runs["graphs"]
    _check_launches(main["counts"], RANK_NAMES, "msltr-lambdarank")
    if main["counts"]["lambdarank"] != N_TREES:
        fail(f"msltr-lambdarank: kernel U ran {main['counts']['lambdarank']}"
             f" times in {N_TREES} trees")
    b = main["booster"]
    share = rank_share(torch, b)
    model, const = _subset_ndcg(b, X, y, counts)
    if not model[10] > const[10]:
        fail(f"msltr-lambdarank: NDCG@10 {model[10]} of the subset is not "
             f"above a constant score's {const[10]}")
    it_s = statistics.median(main["iter_s"])
    out = {"msltr-lambdarank": dict(
        _summary(runs), construct_s=construct_s,
        kernel_u_per_tree=main["counts"]["lambdarank"] / N_TREES,
        replays_per_tree=main["replays"] / N_TREES, kernel_u=share,
        subset_ndcg=model, constant_ndcg=const)}
    counts_by = {"msltr-lambdarank": main["counts"]}
    print(f"msltr-lambdarank: s/iteration {it_s:.4f}, kernel U "
          f"{main['counts']['lambdarank'] / N_TREES:.0f} a tree, "
          f"{share['kernel_u_ms']:.4f} ms a launch of an iteration's "
          f"{share['iteration_ms']:.3f} ms on the card (share "
          f"{share['kernel_u_share']:.4f}; CUDA events), replays a tree "
          f"{main['replays'] / N_TREES:.1f}; subset NDCG {model} against a "
          f"constant score's {const}", flush=True)
    del b, runs, main
    torch.cuda.empty_cache()
    # with the holdout as a grouped validation set
    valid = ds.create_valid(Xh, label=yh, group=ch).construct()
    res, clock = {}, _Clock(torch)
    reset_counts()
    torch.cuda.synchronize()
    b = ltt.train(p, ds, num_boost_round=N_TREES, valid_sets=[valid],
                  valid_names=["holdout"], evals_result=res,
                  callbacks=[clock], verbose_eval=False)
    torch.cuda.synchronize()
    stamps = clock.t + [time.perf_counter()]
    valid_iter_s = list(np.diff(stamps)[1:])
    counts_v = read_counts()
    score = b._gbdt.valid_sets[0].score.cpu().numpy()
    pred = b.predict(Xh, raw_score=True)
    sdiff = float(np.max(np.abs(score - pred)))
    if not sdiff <= 1e-5:
        fail(f"msltr holdout score is {sdiff} from the trees' prediction")
    gains = default_label_gain()
    got = {}
    for k in RANK_EVAL_AT:
        want = np_ndcg(yh, score, ch, k, gains)
        got[k] = res["holdout"][f"ndcg@{k}"][-1]
        if not abs(got[k] - want) <= 1e-9:
            fail(f"msltr holdout ndcg@{k} {got[k]} vs numpy {want}")
    if counts_v.get("route", 0) != N_TREES or \
            counts_v.get("leaf_lookup_f64", 0) != N_TREES or \
            counts_v.get("lambdarank", 0) != N_TREES:
        fail(f"msltr holdout: {counts_v} (kernel U, T and L's float64 mode "
             f"once a tree)")
    valid_s = statistics.median(valid_iter_s)
    out["msltr-lambdarank-valid"] = {
        "seconds_per_iteration": valid_s, "iteration_seconds": valid_iter_s,
        "holdout_ndcg": got, "score_vs_prediction": sdiff,
        "launches_per_tree": {k: v / N_TREES for k, v in counts_v.items()
                              if v}}
    counts_by["msltr-lambdarank-valid"] = counts_v
    print(f"msltr-lambdarank-valid: s/iteration {valid_s:.4f}, holdout "
          f"ndcg {got} (numpy within 1e-9), score vs prediction "
          f"{sdiff:.3g}", flush=True)
    del b, ds, valid
    torch.cuda.empty_cache()
    return counts_by, out


def logloss_fobj(score, dataset):
    """A numpy binary log loss: the custom objective of the fobj cells."""
    y = dataset.get_label()
    p = 1.0 / (1.0 + np.exp(-score))
    return p - y, p * (1.0 - p)


FOBJ_NAMES = ("multi_histogram", "routed_histogram", "leaf_stats",
              "best_split", "leaf_lookup")


def phase_fobj(torch, ltt, data, builtin_s):
    """Phase 13's ``higgs-wave255-noc2f-fobj``: wave255 without c2f on
    phase 3's data with ``logloss_fobj`` through ``Booster.update(fobj=)``,
    6 iterations on the graphs: seconds an iteration beside the built-in
    ``binary``'s (phase 4), the host's fobj ms, the training score's
    fetch and the gradients' copy to the card (each synchronised), the
    kernels of the path launched, holdout AUC above 0.6."""
    ds, Xh, yh = data
    p = dict(TRAIN_PARAMS, **WAVE_PARAMS, device_type=DEVICE, metric="None")
    p.pop("objective")
    b = ltt.Booster(params=dict(p, objective="none"), train_set=ds)
    g = b._gbdt
    times = {"fobj": [], "fetch": [], "copy": []}

    def timed(key, fn):
        def inner(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a)
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t0) * 1e3)
            return r
        return inner
    g.train_score = timed("fetch", g.train_score)
    g._load_gradients = timed("copy", g._load_gradients)
    fobj = timed("fobj", logloss_fobj)
    reset_counts()
    torch.cuda.synchronize()
    stamps = [time.perf_counter()]
    for _ in range(N_TREES):
        if b.update(fobj=fobj):
            fail("higgs-wave255-noc2f-fobj: training stopped early")
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    counts = read_counts()
    _check_launches(counts, FOBJ_NAMES, "higgs-wave255-noc2f-fobj")
    from lightgbm_tpu_torch.ops import graphs
    if g.runner.use_graphs and graphs.REPLAYS["graph_replays"] == 0:
        fail("higgs-wave255-noc2f-fobj: no graph replays")
    auc = np_auc(yh, b.predict(Xh, raw_score=True))
    if not auc > 0.6:
        fail(f"higgs-wave255-noc2f-fobj: holdout AUC {auc}")
    iter_s = list(np.diff(stamps)[1:])
    it_s = statistics.median(iter_s)
    med = {k: statistics.median(v[1:]) for k, v in times.items()}
    out = {"seconds_per_iteration": it_s, "iteration_seconds": iter_s,
           "builtin_binary_seconds_per_iteration": builtin_s,
           "fobj_ms": med["fobj"], "score_fetch_ms": med["fetch"],
           "gradient_copy_ms": med["copy"], "holdout_auc": auc,
           "launches_per_tree": {k: v / N_TREES for k, v in counts.items()
                                 if v},
           "graph_replays_per_tree": graphs.REPLAYS["graph_replays"] /
           N_TREES}
    print(f"higgs-wave255-noc2f-fobj: s/iteration {it_s:.4f} (built-in "
          f"binary {builtin_s:.4f}); fobj {med['fobj']:.2f} ms, score fetch "
          f"{med['fetch']:.2f} ms, gradient copy {med['copy']:.2f} ms an "
          f"iteration; holdout AUC {auc:.4f}", flush=True)
    del b, g
    torch.cuda.empty_cache()
    return counts, out


# phase 14: bench.py's missing + categorical Higgs row (bench.py:2150-2214)
# on phase 3's data: 10% NaN from RandomState(29), injected in chunks of 1M
# rows; for the categorical cells columns 0-3 become
# floor(|nan_to_num(x)| * 4) % 12, named in the parameter and the Dataset
# as bench.py passes both.  bench.py's base_params + wave_splits +
# use_quantized_grad, and the same data on the exact loop
MISSING_PARAMS = dict(TRAIN_PARAMS, **WAVE255_PARAMS, metric="None")
CAT_COLUMNS = [0, 1, 2, 3]
CAT_PARAMS = dict(MISSING_PARAMS, categorical_feature="0,1,2,3")
CAT_EXACT_PARAMS = dict(TRAIN_PARAMS, min_data_in_leaf=0, metric="None",
                        categorical_feature="0,1,2,3")
CAT_CELLS = {
    "higgs-missing-wave255": (
        MISSING_PARAMS, False,
        ("multi_histogram", "window_histogram", "routed_histogram",
         "lanes_window_histogram", "leaf_stats", "leaf_lookup"),
        (lambda gp: gp.wave and gp.two_col and gp.refine_shift == 4 and
         gp.quantize > 0 and not gp.split.any_cat,
         "two-column W=64 c2f waves")),
    "higgs-missing-cat-wave255": (
        CAT_PARAMS, True,
        ("multi_histogram", "leaf_stats", "best_split", "leaf_lookup"),
        (lambda gp: gp.wave and gp.quantize > 0 and not gp.two_col and
         gp.refine_shift == 0 and gp.split.any_cat and gp.speculate == 42,
         "three-column W=42 waves routed outside the pass")),
    "higgs-missing-cat-exact255": (
        CAT_EXACT_PARAMS, True, ("histogram", "best_split", "leaf_lookup"),
        (lambda gp: not gp.wave and gp.split.any_cat,
         "the exact loop with categorical scans")),
}


def missing_transform(X):
    """bench.py's NaN injection, on a copy."""
    rng = np.random.RandomState(29)
    X = X.copy()
    for lo in range(0, X.shape[0], 1_000_000):
        hi = min(lo + 1_000_000, X.shape[0])
        blk = rng.random_sample((hi - lo, X.shape[1]))
        X[lo:hi][blk < 0.10] = np.nan
    return X


def categorical_transform(X):
    """bench.py's categorical columns, in place: -> ``X``."""
    for c in CAT_COLUMNS:
        X[:, c] = np.floor(np.abs(np.nan_to_num(X[:, c])) * 4) % 12
    return X


def phase_categorical(torch, ltt, data, wave_s):
    """Phase 14: the missing + categorical row.  Each cell in the three
    modes of :func:`run_paths` (the same bits and kernel launches), its
    tiers, its Dataset's construction seconds, its kernels' launches and
    graph replays a tree, its trees' categorical splits (more than none on
    the categorical cells), the training score within 1e-5 of the trees'
    prediction on the first 500k rows and a training AUC above 0.6; then
    the categorical wave cell with the holdout, under the same transform,
    as a validation set (phase 7's checks)."""
    ds0, Xh0, yh = data
    y = ds0.get_label()
    counts, e2e = {}, {}
    t0 = time.perf_counter()
    X = missing_transform(ds0.raw_mat)
    gen_s = time.perf_counter() - t0
    ds = built = None
    for cell, (params, cat, names, tier) in CAT_CELLS.items():
        if built != cat:
            ds = built = None
            if cat:
                # the categorical cells: the NaN'd columns 0-3 remapped
                t0 = time.perf_counter()
                categorical_transform(X)
                gen_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ds = ltt.Dataset(X, label=y,
                             params=dict(params, device_type=DEVICE),
                             categorical_feature=CAT_COLUMNS if cat
                             else "auto").construct()
            torch.cuda.synchronize()
            ds_s = time.perf_counter() - t0
            built = cat
            torch.cuda.empty_cache()
        cats = [i for i, m in enumerate(ds._constructed.mappers)
                if m.bin_type]
        print(f"{cell}: transform {gen_s:.2f} s, Dataset construction "
              f"{ds_s:.2f} s (binned {tuple(ds._constructed.binned.shape)} "
              f"{ds._constructed.binned.dtype}, categorical {cats})",
              flush=True)
        runs = run_paths(torch, ltt, ds, dict(params, device_type=DEVICE),
                         cell)
        main = runs["graphs"]
        b, c = main["booster"], main["counts"]
        gp = b._gbdt.grow_params
        if not tier[0](gp):
            fail(f"{cell} did not resolve to {tier[1]}: {gp}")
        _check_launches(c, names, cell)
        if cat and gp.wave and c.get("routed_histogram", 0):
            fail(f"{cell}: kernel R ran on a categorical wave")
        n_cat = sum(t.num_cat for t in b.models)
        if cat and n_cat <= 0:
            fail(f"{cell}: no categorical split in {b.num_trees()} trees")
        diff = _train_score_vs_prediction(b, X, cell, atol=1e-5)
        train_auc = np_auc(y[:TRAIN_SLICE],
                           b._gbdt.train_score()[:TRAIN_SLICE])
        if not 0.6 < train_auc <= 1.0:
            fail(f"{cell}: training AUC {train_auc} is not that of a "
                 f"trained model")
        per_tree = {k: v / N_TREES for k, v in c.items() if v}
        print(f"{cell}: tiers {tier[1]}; kernel launches a tree "
              f"{per_tree}, graph replays a tree "
              f"{main['replays'] / N_TREES:.1f}; categorical splits "
              f"{n_cat} in {b.num_trees()} trees "
              f"({[t.num_cat for t in b.models]}); training score within "
              f"{diff:.3g} of the trees' prediction, training AUC "
              f"{train_auc:.5f} on the first {TRAIN_SLICE} rows", flush=True)
        counts[cell] = c
        e2e[cell] = dict(
            seconds_per_iteration=statistics.median(main["iter_s"]),
            dataset_seconds=ds_s, transform_seconds=gen_s,
            kernel_launches_per_tree=per_tree,
            graph_replays_per_tree=main["replays"] / N_TREES,
            categorical_splits=n_cat, train_auc=train_auc,
            train_score_vs_prediction=diff, modes=_summary(runs))
        del b, main["booster"]
        torch.cuda.empty_cache()
    Xh = categorical_transform(missing_transform(Xh0))
    cell = "higgs-missing-cat-wave255-valid"
    counts[cell], e2e[cell] = phase_valid(
        torch, ltt, (ds, Xh, yh), "cat-wave", CAT_PARAMS,
        CAT_CELLS["higgs-missing-cat-wave255"][2],
        e2e["higgs-missing-cat-wave255"]["seconds_per_iteration"])
    e2e["wave255_seconds_per_iteration"] = wave_s
    del ds, X
    torch.cuda.empty_cache()
    return counts, e2e


# phase 15: bench.py's sparse one-hot row (bench.py:2282-2331, "Allstate
# shape"): RandomState(13), 1M rows, 40 categorical columns of 8-24
# levels one-hot encoded into 652 indicator columns, CSR float32, the label
# from the first 40 indicator columns; bench.py's base_params
# (:1882-1891) with max_bin=63 and enable_bundle=True, the Dataset made
# from the CSR.  The row as it ships is the exact loop; -wave255 adds
# bench.py's `fast` (:1895-1896)
ALLSTATE_ROWS = 1_000_000
ALLSTATE_HOLDOUT = 100_000
ALLSTATE_CATS = 40
ALLSTATE_CUT, ALLSTATE_CUT_TREES = 50_000, 3
ALLSTATE_PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 63,
                   "learning_rate": 0.1, "min_sum_hessian_in_leaf": 100.0,
                   "min_data_in_leaf": 0, "verbose": -1, "metric": "None",
                   "enable_bundle": True}
ALLSTATE_WAVE = dict(ALLSTATE_PARAMS, wave_splits=True,
                     use_quantized_grad=True)
ALLSTATE_CELLS = {
    "allstate-exact255": (
        ALLSTATE_PARAMS, ("histogram", "best_split", "leaf_lookup"),
        (lambda g: not g.grow_params.wave and g._bundles is not None,
         "the exact loop on the bundle matrix")),
    "allstate-wave255": (
        ALLSTATE_WAVE,
        ("multi_histogram", "best_split", "leaf_stats", "leaf_lookup"),
        (lambda g: g._bundles is not None and g.grow_params.wave and
         g.grow_params.quantize > 0 and not g.grow_params.two_col and
         g.grow_params.refine_shift == 0 and g.grow_params.speculate == 42,
         "three-column W=42 waves on the bundle matrix, routed outside "
         "the pass")),
    "allstate-exact255-nobundle": (
        dict(ALLSTATE_PARAMS, enable_bundle=False),
        ("histogram", "best_split", "leaf_lookup"),
        (lambda g: not g.grow_params.wave and g._bundles is None,
         "the exact loop on the 652 indicator columns")),
}
# the passes a bundled run must not launch (EFB turns them off)
ALLSTATE_OFF_NAMES = ("routed_histogram", "window_histogram",
                          "lanes_window_histogram")


def allstate_levels():
    """The 40 columns' level counts, bench.py's first draw."""
    return np.random.RandomState(13).randint(8, 25, size=ALLSTATE_CATS)


def make_allstate(n_rows, seed=13):
    """bench.py's generator (bench.py:2291-2312), copied: ``seed`` 13
    gives bench.py's rows; another seed draws other rows over the same
    40 columns (their levels are seed 13's first draw) -> (CSR, label)."""
    import scipy.sparse as sp_mod
    rng = np.random.RandomState(13)
    levels = rng.randint(8, 25, size=ALLSTATE_CATS)
    if seed != 13:
        rng = np.random.RandomState(seed)
    cols, col0 = [], 0
    for L in levels:
        cols.append(col0 + rng.randint(0, L, size=n_rows))
        col0 += L
    ridx = np.tile(np.arange(n_rows), len(levels))
    X = sp_mod.csr_matrix(
        (np.ones(ridx.size, np.float32), (ridx, np.concatenate(cols))),
        shape=(n_rows, int(col0)))
    y = (rng.random_sample(n_rows) <
         1 / (1 + np.exp(-(X[:, :40].toarray().sum(1).ravel() - 1)))
         ).astype(np.float32)
    return X, y


def allstate_logit(X):
    """The logit bench.py draws the row's label from (before its -1)."""
    return np.asarray(X[:, :40].sum(1)).ravel()


def allstate_bundles(torch, dev):
    """The bundles EFB finds on the row (every column's indicators one
    group, in column order): the layout, its device maps at the committed
    width, and the width."""
    from lightgbm_tpu_torch.io.bundle import FeatureBundles
    levels = allstate_levels()
    F, G = int(levels.sum()), len(levels)
    group_id = np.repeat(np.arange(G), levels).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(levels)[:-1]])
    offsets = (1 + np.arange(F) - np.repeat(starts, levels)).astype(np.int32)
    fb = FeatureBundles(
        groups=[list(range(s, s + L)) for s, L in zip(starts, levels)],
        group_id=group_id, offsets=offsets,
        default_bin=np.zeros(F, np.int32),
        group_num_bins=(levels + 1).astype(np.int32),
        is_singleton=np.zeros(G, bool))
    B = int(levels.max()) + 1
    nb = np.full(F, 2, np.int32)
    return fb, fb.device_maps(B, nb, dev), B


def phase_kernels_efb(torch, dev):
    """Phase 2, the kernels at phase 15's bundled shapes against their plain
    versions: H on the (40, 1M) bundle matrix at B = 25 (float values at
    the root and at 1/255 of the rows, integer values exact), M at W = 42
    three int8 columns, S on the 2W = 84 children expanded to (84, 652,
    25, 3), T on a tree's records translated onto bundle columns (its ids
    equal to routing the 652 indicator columns with the records as they
    are); and ``expand``'s time and CUDA kernels a call at the exact
    loop's 2 children and the wave's 84 (a layer metric)."""
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import route as tr
    from lightgbm_tpu_torch.ops import split as ts
    from lightgbm_tpu_torch.ops.grow import expand
    fb, maps, B = allstate_bundles(torch, dev)
    G, F, N = fb.num_groups, len(fb.group_id), ALLSTATE_ROWS
    g = torch.Generator(device=dev).manual_seed(19)
    levels = torch.as_tensor(allstate_levels(), device=dev)
    # each row one level a column: bundle bin 1 + level
    bins = (1 + (torch.rand((G, N), generator=g, device=dev) *
                 levels[:, None]).floor()).to(torch.uint8)
    out = {}

    # ---- kernel H -----------------------------------------------------
    def h_args(parts, values, seed):
        a = hist_inputs(torch, dev, G, N, B, parts, values, seed)
        return (bins,) + a[1:]

    for parts, vals in ((1, "integer"), (255, "float"), (255, "integer")):
        check_histogram(th, torch, h_args(parts, vals, 40 + parts),
                        f"bundled G={G} N={N} B={B} 1/{parts} {vals}",
                        vals == "integer")
    a = h_args(1, "float", 41)
    err_h, rel_h = check_histogram(th, torch, a,
                                   f"bundled G={G} N={N} B={B} root float",
                                   False)
    ms_h = cuda_ms(lambda: th.masked_histogram(*a), reps=10)
    dev_h, _ = profile_calls(lambda: th.masked_histogram(*a), 10,
                             KERNEL_H_NAMES)
    (b_h, by_h), rows = hist_bound(torch, a)
    plain_h = cuda_ms(lambda: th.masked_histogram_plain(*a), reps=3)
    _, grad, hess, mask = a[:4]
    flat_ids = (bins.to(torch.int64) +
                torch.arange(G, device=dev)[:, None] * B).reshape(-1)
    flat_vals = torch.stack([grad, hess, mask], -1).repeat(G, 1)
    lib_out = torch.zeros(G * B, 3, device=dev)
    lib_h = cuda_ms(lambda: lib_out.zero_().index_add_(0, flat_ids,
                                                       flat_vals), reps=3)
    del flat_ids, flat_vals, lib_out
    out["histogram"] = dict(max_abs_err=err_h, ms=ms_h, device_ms=dev_h,
                            plain_ms=plain_h, bound_ms=b_h, bound_by=by_h,
                            library_ms=lib_h, rows=rows)
    print(f"kernel H bundled root pass: max abs {err_h:.3g} max rel "
          f"{rel_h:.3g}; {ms_h:.4f} ms, device {dev_h:.4f} ms (plain "
          f"{plain_h:.3f}, index_add_ {lib_h:.3f}, bound {b_h:.4f} by "
          f"{by_h}) at G={G} N={N} B={B}", flush=True)

    # ---- kernel M: W = 42, three int8 columns -------------------------
    m = measure_multi_w42(torch, th, dev, g, bins, B)
    out["multi_histogram"] = {k[len("w42_3col_"):]: v for k, v in m.items()}
    out["multi_histogram"]["library_ms"] = out["multi_histogram"].pop(
        "index_add_ms")

    # ---- kernel S on the 2W = 84 children, expanded -------------------
    qv = torch.stack([
        torch.randint(-120, 121, (N,), generator=g, device=dev,
                      dtype=torch.int32),
        torch.randint(0, 121, (N,), generator=g, device=dev,
                      dtype=torch.int32),
        torch.ones(N, device=dev, dtype=torch.int32)], -1).to(
            torch.int8).contiguous()
    halves = []
    for _ in range(2):
        sel = torch.randint(-1, 42, (N,), generator=g, device=dev,
                            dtype=torch.int32).to(torch.int8)
        halves.append(th.multi_histogram(bins, qv, sel, B, 42, False))
    hist_b = torch.cat(halves).contiguous()                 # (84, G, B, 3)
    stats = hist_b[:, 0].sum(dim=1).contiguous()            # each row once
    hist = expand(hist_b, stats, maps).contiguous()         # (84, F, B, 3)
    nb = torch.full((F,), 2, dtype=torch.int32, device=dev)
    mt = torch.zeros(F, dtype=torch.int32, device=dev)
    fm = torch.ones(F, dtype=torch.bool, device=dev)
    p = ts.SplitParams(max_bin=B, min_data_in_leaf=0,
                       min_sum_hessian_in_leaf=100.0)
    err_s = check_split(torch, ts, hist, stats, nb, mt, fm, p,
                        f"bundled 2W=84 F={F} B={B}")

    def call_s():
        return ts.find_best_split(hist, stats, nb, mt, fm, p)

    dev_s, n_s = profile_calls(call_s, 20, SPLIT_NAMES)
    if n_s != 1:
        fail(f"kernel S made {n_s} CUDA launches in one call, not 1")
    ms_s = cuda_ms(call_s, reps=20)
    plain_s = cuda_ms(lambda: ts.find_best_split_plain(hist, stats, nb, mt,
                                                       fm, p), reps=3)
    b_s = split_bound(hist, B)
    out["best_split"] = dict(max_abs_err=err_s, ms=ms_s, device_ms=dev_s,
                             launches_per_call=n_s, plain_ms=plain_s,
                             bound_ms=b_s[0], bound_by=b_s[1],
                             library_ms=None)
    print(f"kernel S bundled (84, {F}, {B}, 3): gains equal; {ms_s:.4f} ms, "
          f"device {dev_s:.4f} ms, {n_s:g} launch a call (plain "
          f"{plain_s:.3f}, bound {b_s[0]:.6f} by {b_s[1]})", flush=True)
    out["best_split_constrained"] = measure_split_constrained(
        torch, ts, hist, stats, nb, mt, fm, p, ts.WAVE,
        f"bundled (84, {F}, {B}, 3)", 63)

    # ---- expand, the layer metric -------------------------------------
    for W in (2, 84):
        hb, st = hist_b[:W].contiguous(), stats[:W].contiguous()
        call = lambda: expand(hb, st, maps)  # noqa: E731
        e_ms = cuda_ms(call, reps=20)
        e_dev, e_n = profile_calls(call, 20, ("",), whole=False)
        out[f"expand_w{W}"] = dict(ms=e_ms, device_ms=e_dev,
                                   cuda_kernels_per_call=e_n)
        print(f"expand at W={W} (G={G} -> F={F}, B={B}): {e_ms:.4f} ms a "
              f"call, device {e_dev:.4f} ms, {e_n:g} CUDA kernels a call",
              flush=True)
    del hist, hist_b, halves, qv

    # ---- kernel T on translated records --------------------------------
    nh = ALLSTATE_HOLDOUT
    rec = route_records(torch, dev, 255, B, F, 302, n_bins=2)
    feat, mask = maps.translate(rec[1], rec[2])
    xb = bins[:, :nh].contiguous()
    # the indicator columns of those rows: feature f's bin from its bundle
    xf = torch.gather(maps.from_bundle, 1, xb.index_select(
        0, maps.group).to(torch.int64)).to(torch.uint8)
    trec = (rec[0], feat, mask.contiguous(), rec[3])
    k = check_route(torch, tr, xb, trec, 255, torch.uint8,
                    f"translated records, G={G} N={nh}")
    want = tr.route_rows_plain(xf, *rec, 255,
                               out=torch.empty_like(k))
    if not torch.equal(k, want):
        fail(f"kernel T on translated records differs from routing the "
             f"{F} indicator columns: {int((k != want).sum())} rows")
    print(f"kernel T on records translated onto bundle columns: exact, the "
          f"ids of the {F} indicator columns' routing", flush=True)
    del bins, xb, xf
    torch.cuda.empty_cache()
    return out


def _cut_jobs(pool, X, y):
    """The CPU's trainings of the row's first ``ALLSTATE_CUT`` rows (exact
    and waves), started in ``pool`` while the card trains."""
    Xc, yc = X[:ALLSTATE_CUT], y[:ALLSTATE_CUT]
    return {what: pool.apply_async(_train_reduced, ((
        Xc, yc, dict(p, device_type="cpu"), ALLSTATE_CUT_TREES, {}),))
        for what, p in (("exact", ALLSTATE_PARAMS),
                        ("wave", ALLSTATE_WAVE))}


def phase_allstate(torch, ltt):
    """Phase 15: the row's Dataset from the CSR (seconds, peak host bytes
    by ``tracemalloc`` beside the float64 densify it no longer makes, the
    binned matrix's device bytes); each cell of ``ALLSTATE_CELLS`` in the
    three modes of :func:`run_paths` (the same bits and kernel launches),
    its tiers, bundles (the groups the host's ``find_bundles`` finds on
    the same sample, 40 of them, committed width 25), the bundle matrix's
    device bytes, its kernels' launches and graph replays a tree, the
    training score within 1e-5 of the trees' prediction and a training AUC
    above that of the logit the labels were drawn from (0.556: bench.py's
    label is noisy); then the wave cell with a 100,000-row holdout of the
    same generator (another seed) as a validation set (phase 7's checks:
    kernel T on translated records, L's float64 mode; the holdout AUC
    within 0.01 of the logit's); and the card's trees against the CPU's
    on the first 50,000 rows."""
    import multiprocessing
    import tracemalloc
    from lightgbm_tpu_torch.io.bundle import find_bundles
    t0 = time.perf_counter()
    X, y = make_allstate(ALLSTATE_ROWS)
    Xh, yh = make_allstate(ALLSTATE_HOLDOUT, seed=14)
    gen_s = time.perf_counter() - t0
    F = X.shape[1]
    levels = allstate_levels()
    if F != int(levels.sum()):
        fail(f"the row has {F} columns, not {int(levels.sum())}")
    # the AUC of the logit the labels were drawn from: bench.py's label is
    # noisy (the first 40 indicator columns), so a trained model's
    # training AUC must pass this, not a fixed 0.6
    signal_auc = np_auc(y[:TRAIN_SLICE], allstate_logit(X[:TRAIN_SLICE]))
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool(2)
    jobs = _cut_jobs(pool, X, y)
    torch.cuda.synchronize()
    tracemalloc.start()
    t0 = time.perf_counter()
    ds = ltt.Dataset(X, label=y, params=dict(ALLSTATE_PARAMS,
                                             device_type=DEVICE)).construct()
    torch.cuda.synchronize()
    ds_s = time.perf_counter() - t0
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    dense = X.shape[0] * F * 8
    binned = ds._constructed.binned
    plain_bytes = binned.numel() * binned.element_size()
    if tuple(binned.shape) != (F, ALLSTATE_ROWS) or not \
            isinstance(ds.raw_mat, type(X)):
        fail(f"the CSR Dataset holds {tuple(binned.shape)} bins and a "
             f"{type(ds.raw_mat).__name__} raw matrix")
    print(f"allstate: generation {gen_s:.2f} s; Dataset from the CSR "
          f"({X.nnz} non-zeros) {ds_s:.2f} s, peak host bytes "
          f"{peak} by tracemalloc (the float64 densify: {dense}); binned "
          f"{tuple(binned.shape)} {binned.dtype}, {plain_bytes} device "
          f"bytes", flush=True)
    counts, e2e = {}, {"generation_seconds": gen_s, "dataset_seconds": ds_s,
                       "dataset_peak_host_bytes": peak,
                       "float64_densify_bytes": dense,
                       "unbundled_device_bytes": plain_bytes}
    for cell, (params, names, tier) in ALLSTATE_CELLS.items():
        runs = run_paths(torch, ltt, ds, dict(params, device_type=DEVICE),
                         cell)
        main = runs["graphs"]
        b, c = main["booster"], main["counts"]
        g = b._gbdt
        if not tier[0](g):
            fail(f"{cell} did not resolve to {tier[1]}: {g.grow_params}")
        _check_launches(c, names, cell)
        if any(c.get(k, 0) for k in ALLSTATE_OFF_NAMES):
            fail(f"{cell}: a routed or windowed pass ran: {c}")
        info = {}
        if g._bundles is not None:
            fb = g._bundles
            nb = np.asarray([m.num_bin for m in ds._constructed.mappers],
                            np.int32)
            host = find_bundles(ds._constructed.binned.T.cpu().numpy(), nb,
                                np.zeros(F, np.int32), 0.0, 63,
                                seed=g.config.data_random_seed)
            if host.groups != fb.groups or fb.num_groups != ALLSTATE_CATS \
                    or g.max_bin != int(levels.max()) + 1:
                fail(f"{cell}: {fb.num_groups} groups at width {g.max_bin} "
                     f"(the host's find_bundles: {host.num_groups}; want "
                     f"{ALLSTATE_CATS} at {int(levels.max()) + 1})")
            info = dict(groups=fb.num_groups, width=g.max_bin,
                        bundled_device_bytes=g._xt.numel() *
                        g._xt.element_size())
        diff = _train_score_vs_prediction(b, X, cell, atol=1e-5)
        auc = np_auc(y[:TRAIN_SLICE], g.train_score()[:TRAIN_SLICE])
        if not signal_auc < auc <= 1.0:
            fail(f"{cell}: training AUC {auc} is not above the label's own "
                 f"logit's {signal_auc}")
        per_tree = {k: v / N_TREES for k, v in c.items() if v}
        print(f"{cell}: tiers {tier[1]}; bundles {info or 'none'}; kernel "
              f"launches a tree {per_tree}, graph replays a tree "
              f"{main['replays'] / N_TREES:.1f}; training score within "
              f"{diff:.3g} of the trees' prediction, training AUC "
              f"{auc:.5f} on the first {TRAIN_SLICE} rows", flush=True)
        counts[cell] = c
        e2e[cell] = dict(
            seconds_per_iteration=statistics.median(main["iter_s"]),
            kernel_launches_per_tree=per_tree,
            graph_replays_per_tree=main["replays"] / N_TREES,
            train_auc=auc, train_score_vs_prediction=diff,
            modes=_summary(runs), **info)
        del b, g, main["booster"]
        torch.cuda.empty_cache()
    cell = "allstate-wave255-valid"
    counts[cell], e2e[cell] = phase_valid(
        torch, ltt, (ds, Xh, yh), "allstate-wave", ALLSTATE_WAVE,
        ALLSTATE_CELLS["allstate-wave255"][1],
        e2e["allstate-wave255"]["seconds_per_iteration"])
    hold_auc = e2e[cell]["holdout"]["auc"][-1]
    hold_signal = np_auc(yh, allstate_logit(Xh))
    if not hold_auc > hold_signal - 0.01:
        fail(f"{cell}: holdout AUC {hold_auc} is not within 0.01 of the "
             f"label's own logit's {hold_signal}")
    e2e[cell].update(signal_auc_holdout=hold_signal)
    e2e["signal_auc_train"] = signal_auc
    del ds
    torch.cuda.empty_cache()
    # the card against the CPU on the first rows
    Xc, yc = X[:ALLSTATE_CUT], y[:ALLSTATE_CUT]
    for what, p in (("exact", ALLSTATE_PARAMS), ("wave", ALLSTATE_WAVE)):
        card = _train_reduced((Xc, yc, dict(p, device_type=DEVICE),
                               ALLSTATE_CUT_TREES, {}))
        cpu = jobs[what].get()
        worst = _same_trees(card["models"], cpu["models"],
                            f"allstate {what}, first {ALLSTATE_CUT} rows",
                            ALLSTATE_CUT_TREES)
        pdiff = float(np.max(np.abs(card["raw"] - cpu["raw"])))
        if pdiff > 1e-5 * max(1.0, float(np.max(np.abs(cpu["raw"])))):
            fail(f"allstate {what}: predictions differ between cuda and cpu "
                 f"by {pdiff}")
        print(f"allstate {what}, first {ALLSTATE_CUT} rows: "
              f"{ALLSTATE_CUT_TREES} trees identical on the card and the "
              f"CPU, max leaf value diff {worst:.3g}, max prediction diff "
              f"{pdiff:.3g}", flush=True)
    pool.close()
    pool.join()
    ratio = {k: e2e[k]["seconds_per_iteration"] for k in ALLSTATE_CELLS}
    print(f"allstate seconds an iteration (graphed): {ratio}", flush=True)
    return counts, e2e


# ---- phase 16: monotone constraints and the feature penalty ------------
# +1 on features 2-4 and -1 on 5, the signs of the generator's weights
# RandomState(0).randn(28) there (features 0-1 carry the interaction term
# and stay free); the penalty 0.5 on features 6-9
MONO_SIGNS = {2: 1, 3: 1, 4: 1, 5: -1}
MONO_PARAMS = {
    "monotone_constraints": [MONO_SIGNS.get(f, 0) for f in range(N_FEATURES)],
    "feature_contri": [0.5 if 6 <= f <= 9 else 1.0
                       for f in range(N_FEATURES)]}
# (the unconstrained path it stands beside, params, the kernels it must
# launch)
MONO_CELLS = {
    "higgs-mono-exact255": (
        "exact", dict(TRAIN_PARAMS, **MONO_PARAMS),
        ("histogram", "best_split_constrained", "leaf_lookup")),
    "higgs-mono-wave255-noc2f": (
        "wave", dict(TRAIN_PARAMS, **WAVE_PARAMS, **MONO_PARAMS),
        ("multi_histogram", "routed_histogram", "leaf_stats",
         "best_split_constrained", "leaf_lookup")),
    "higgs-mono-wave255": (
        "c2f", dict(TRAIN_PARAMS, **WAVE255_PARAMS, **MONO_PARAMS),
        ("multi_histogram", "window_histogram", "routed_histogram",
         "lanes_window_histogram", "leaf_stats", "leaf_lookup")),
}
MONO_SWEEP_ROWS = 64


def monotone_sweep(ds, X, predict):
    """(steps that break a constraint, the largest break) of ``predict``
    (rows -> raw scores) when each feature of ``MONO_SIGNS`` sweeps its
    bin thresholds (its bins' finite upper bounds, and one value past the
    last) with the other features of ``MONO_SWEEP_ROWS`` rows of ``X``
    fixed."""
    mappers = ds._constructed.mappers
    base = X[:MONO_SWEEP_ROWS]
    bad, worst = 0, 0.0
    for f, sign in MONO_SIGNS.items():
        ub = np.asarray(mappers[f].bin_upper_bound, np.float64)
        ub = ub[np.isfinite(ub)]
        grid = np.concatenate([ub, [ub.max() + 1.0]]).astype(np.float32)
        M = np.repeat(base, len(grid), axis=0)
        M[:, f] = np.tile(grid, len(base))
        pred = np.asarray(predict(M)).reshape(len(base), len(grid))
        step = np.diff(pred.astype(np.float64), axis=1) * sign
        bad += int(np.sum(step < -1e-10))
        worst = max(worst, float(max(0.0, -step.min())))
    return bad, worst


def _pre_renewal_trees(booster, recs):
    """The trees of ``recs`` (a run's fetched records) with the loop's
    clipped leaf values, before the quantized renewal."""
    from lightgbm_tpu_torch.models import gbdt as tg
    g = booster._gbdt
    return [tg.records_to_tree({k: v for k, v in r.items()
                                if k != "leaf_stats_exact"}, g.config,
                               g.train_set)
            for r in recs]


def phase_monotone(torch, ltt, data, unconstrained):
    """Phase 16 on phase 3's data: ``MONO_CELLS`` in the three modes of
    :func:`run_paths`, each beside the unconstrained path's numbers
    ``unconstrained[path]`` (phases 3-5, this run), then the card against
    the CPU on the reduced cells (:func:`monotone_reduced_cells`).  ->
    (launches of each cell's graphed run, its numbers)."""
    from lightgbm_tpu_torch.models import gbdt as tg
    from lightgbm_tpu_torch.ops.predict import flatten_forest, predict_raw
    ds, Xh, _ = data
    y = ds._constructed.label.cpu().numpy()
    dev = torch.device(DEVICE, 0)
    counts_by_cell, e2e = {}, {}
    for cell, (path, params, names) in MONO_CELLS.items():
        recs = []
        make_tree = tg.records_to_tree

        def keep(rec, *a, **k):
            recs.append(rec)
            return make_tree(rec, *a, **k)

        tg.records_to_tree = keep
        try:
            runs = run_paths(torch, ltt, ds, dict(params, device_type=DEVICE),
                             cell)
        finally:
            tg.records_to_tree = make_tree
        main = runs["graphs"]
        booster, counts = main["booster"], main["counts"]
        sp = booster._gbdt.grow_params.split
        if not (sp.has_monotone and sp.has_penalty):
            fail(f"{cell}: the constraints did not reach the split scans")
        _check_launches(counts, names, cell)
        if counts.get("best_split", 0):
            fail(f"{cell}: kernel S ran {counts['best_split']} times "
                 f"unconstrained")
        if path == "c2f" and counts.get("best_split_constrained", 0):
            fail(f"{cell}: kernel S ran on the c2f path, whose scans are "
                 f"plain tensor code")
        score = booster._gbdt.train_score()
        if score.shape != y.shape or not np.all(np.isfinite(score)):
            fail(f"{cell}: the training score is not finite of the "
                 f"expected shape")
        auc = np_auc(y, score)
        if not 0.6 < auc <= 1.0:
            fail(f"{cell}: training AUC {auc} is not that of a trained model")
        served = monotone_sweep(ds, Xh, lambda M: booster.predict(
            M, raw_score=True))
        gp = booster._gbdt.grow_params
        pre = None
        if gp.quantize:
            trees = _pre_renewal_trees(booster, recs[:N_TREES])
            ff = flatten_forest(trees, dev)
            pre = monotone_sweep(ds, Xh, lambda M: predict_raw(
                ff, M, dev, 1).cpu().numpy())
            if pre[0]:
                fail(f"{cell}: the trees before the renewal break the "
                     f"constraints in {pre[0]} steps (largest {pre[1]:.3g})")
        elif served[0]:
            fail(f"{cell}: predictions break the constraints in "
                 f"{served[0]} steps (largest {served[1]:.3g})")
        free = unconstrained[path]
        splits = feature_splits(booster)
        pen_splits = sum(splits[6:10])
        free_pen = sum(free["splits_by_feature"][6:10])
        summ = _summary(runs)
        g_free = free["modes"]["graphs"]
        print(f"{cell}: {statistics.median(main['iter_s']):.4f} s an "
              f"iteration graphed (unconstrained {path} "
              f"{free['seconds_per_iteration']:.4f}), idle share "
              f"{summ['graphs'].get('idle_share_of_iteration')} (unconstrained "
              f"{g_free.get('idle_share_of_iteration')}), kernel launches a "
              f"tree {summ['graphs']['kernel_launches_per_tree']:.1f} "
              f"(unconstrained {g_free['kernel_launches_per_tree']:.1f}); "
              f"training AUC {auc:.5f}; splits on features 6-9 "
              f"{pen_splits} (unconstrained {free_pen}) of "
              f"{sum(splits)}", flush=True)
        if pre is None:
            print(f"{cell}: predictions monotone over every bin threshold of "
                  f"features {sorted(MONO_SIGNS)} for {MONO_SWEEP_ROWS} rows "
                  f"(1e-10)", flush=True)
        else:
            print(f"{cell}: the trees before the renewal monotone over every "
                  f"bin threshold for {MONO_SWEEP_ROWS} rows (1e-10); the "
                  f"renewed trees break {served[0]} steps, the largest by "
                  f"{served[1]:.3g}", flush=True)
        counts_by_cell[cell] = counts
        e2e[cell] = dict(seconds_per_iteration=statistics.median(
            main["iter_s"]), modes=summ, training_auc=auc,
            launches_per_tree={k: v / N_TREES for k, v in counts.items()},
            splits_on_penalized=pen_splits,
            splits_on_penalized_unconstrained=free_pen,
            renewed_breaks=served if pre is not None else None,
            unconstrained_seconds_per_iteration=free[
                "seconds_per_iteration"])
        del booster, main["booster"], recs
        torch.cuda.empty_cache()
    phase_device_vs_cpu(ltt, monotone_reduced_cells(), "phase 16 card vs cpu")
    return counts_by_cell, e2e


def monotone_reduced_cells():
    """Phase 16's card-against-CPU cells in ``reduced_cells``' form: phase
    6's 50,000 rows with the constraints on the exact loop, float waves,
    quantized two-column waves without and with c2f; categorical waves on
    phase 14's transform of columns 0-3 with the constraints moved to
    features 4-7; phase 15's generator at 50,000 rows, bundled, with
    constraints on its first 4 columns; softmax at K = 5 on phase 11's
    generator (3 iterations)."""
    X, y = make_higgs_shaped(50_000, N_FEATURES, seed=1)
    rng = np.random.RandomState(2)
    X[rng.rand(len(X)) < 0.05, 5] = np.nan
    exact = dict(TRAIN_PARAMS, num_leaves=31, **MONO_PARAMS)
    cells = {
        "monotone, exact": (X, y, exact, REDUCED_ITERS, (1, 4), (1,), 0,
                            [1, 4, 1], {}),
        "monotone, float waves": (X, y, dict(
            exact, wave_splits=True, hist_refinement=False), REDUCED_ITERS,
            (1,), (1,), 0, None, {}),
        "monotone, quantized two-column waves": (X, y, dict(
            TRAIN_PARAMS, **WAVE_PARAMS, **MONO_PARAMS, num_leaves=127),
            REDUCED_ITERS, (1,), (1,), 0, None, {}),
        "monotone, quantized two-column c2f waves": (X, y, dict(
            TRAIN_PARAMS, **WAVE255_PARAMS, **MONO_PARAMS, num_leaves=127),
            REDUCED_ITERS, (1,), (1,), 4, None, {})}
    Xc = categorical_transform(X.copy())
    cat_mono = dict(MONO_PARAMS, monotone_constraints=[
        0, 0, 0, 0, 1, -1, 1, -1] + [0] * (N_FEATURES - 8))
    cells["monotone, categorical waves"] = (Xc, y, dict(
        TRAIN_PARAMS, **WAVE255_PARAMS, **cat_mono, num_leaves=127,
        categorical_feature="0,1,2,3"), REDUCED_ITERS, (1,), (1,), 0, None,
        {})
    Xa, ya = make_allstate(ALLSTATE_CUT)
    cells["monotone, bundled exact"] = (Xa, ya, dict(
        ALLSTATE_PARAMS, monotone_constraints=[1, -1, 1, -1],
        feature_contri=[1.0, 1.0, 0.5, 1.0]), ALLSTATE_CUT_TREES, (1,), (1,),
        None, None, {})
    Xm, ym, _, _ = make_multiclass(ALLSTATE_CUT, 0)
    cells["monotone, softmax K=5"] = (Xm, ym, dict(MC_PARAMS, **MONO_PARAMS),
                                      ZOO_ITERS, (1,), (1,), None, None, {})
    return cells


# ---- phase 17: the numerical-health checks at full width ---------------
# phase 3's data and the three paths' parameters; the fused cell is wave255
# at fused_iters 4, pipeline depth 1
HEALTH_CELLS = {
    "exact255": TRAIN_PARAMS,
    "wave255-noc2f": dict(TRAIN_PARAMS, **WAVE_PARAMS),
    "wave255": dict(TRAIN_PARAMS, **WAVE255_PARAMS),
}
HEALTH_EVERY = 1000          # 1 label in 1,000 NaN
HEALTH_FUSED = 4
# the health words' reduction (torch.aminmax) by its CUDA kernel's name
HEALTH_NAMES = ("MinMaxOps",)


def _health_state(torch, booster):
    g = booster._gbdt
    return (booster.current_iteration(), booster.num_trees(),
            g.train_score_tensor().clone(), g._trees_dispatched)


def expect_health_error(torch, booster, step, want, what, queued=False):
    """``step()`` must raise ``NumericalHealthError`` at ``want``
    (iteration, phase) and leave the booster at its served boundary: the
    iteration, the trees and the training score (bit for bit) of before
    the call, and the tree ids unless blocks were ``queued`` ahead.  ->
    the failing call's seconds."""
    from lightgbm_tpu_torch.utils.health import NumericalHealthError
    before = _health_state(torch, booster)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        step()
    except NumericalHealthError as e:
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if (e.iteration, e.phase) != want:
            fail(f"{what}: NumericalHealthError at iteration {e.iteration} "
                 f"({e.phase}), not {want}")
    else:
        fail(f"{what}: trained on non-finite state without an error")
    after = _health_state(torch, booster)
    if after[:2] != before[:2] or not torch.equal(after[2], before[2]) or (
            not queued and after[3] != before[3]):
        fail(f"{what}: the booster is not at its served boundary after the "
             f"error: iteration, trees {after[:2]} against {before[:2]}, "
             f"tree ids {after[3]} against {before[3]}")
    return secs


def poison_labels(torch, booster, value=float("nan"), every=HEALTH_EVERY,
                  rows=None):
    """The binary objective's sign labels, which its gradients read, set
    to ``value`` in place (1 row in ``every``, or ``rows``); -> the
    labels before."""
    lab = booster._gbdt.objective.sign_label
    saved = lab.clone()
    lab[rows if rows is not None else slice(None, None, every)] = value
    return saved


def health_profile(torch, booster, want=4, iters=3, tries=5):
    """``iters`` more iterations under ``torch.profiler``: the device time
    of the health words' reductions a tree (kernels named
    ``HEALTH_NAMES``, ``want`` a tree) and the busy device time an
    iteration.  The profiler can drop a window's first kernels
    (:func:`profile_calls`; in a long process it dropped the first
    tree's first 2 reductions of every window), so the time a tree is
    taken over the last whole trees' reductions, and a window that
    recorded fewer than ``iters - 1`` trees' worth is profiled again, up
    to ``tries`` times."""
    from lightgbm_tpu_torch.tools.prof_iteration import kernel_table
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    seen = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(0.02)
            for _ in range(iters):
                booster.update()
            torch.cuda.synchronize()
        spans = sorted(
            (e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and any(
                k in e.name for k in HEALTH_NAMES))
        busy_us, launches, _ = kernel_table(prof, torch)
        trees = min(len(spans) // want, iters)
        if trees >= iters - 1 and len(spans) <= want * iters and busy_us:
            us = sum(e - s for s, e in spans[len(spans) - trees * want:])
            return {"flags_device_ms": us / 1e3 / trees,
                    "flags_kernels": want, "flags_recorded": len(spans),
                    "busy_device_ms": busy_us / 1e3 / iters,
                    "cuda_kernels": launches / iters,
                    "flags_share": us / trees / (busy_us / iters),
                    "profiled_iterations": iters}
        seen.append(len(spans))
    fail(f"phase 17: no profiled window of {iters} iterations recorded "
         f"{want} health reductions a tree in {tries} tries (seen: {seen})")


def phase_health(torch, ltt, data):
    """Phase 17 on phase 3's data (10.5M x 28, 255 leaves): the
    numerical-health checks on the card.  Each path of ``HEALTH_CELLS``
    on the graphs: 2 clean iterations, 1 label in 1,000 NaN in place, the
    error at iteration 2 (phase "tree") with the booster at its served
    boundary; the labels restored, 3 more iterations profiled: the
    health reductions' device time a tree against an iteration's busy
    time.
    wave255 at ``fused_iters`` 4, depth 1: 2 clean iterations, a rewind
    to the served boundary, the poisoned block's error at iteration 2
    (phase "superstep"), the queued block dropped.  An infinite label on
    the exact loop at iteration 0 (the bias taken back out of the score);
    a ``fobj`` whose gradients turn NaN at iteration 1; a no-split stop
    (``min_data_in_leaf`` = N + 1) graphed and fused: 1 tree, iteration
    0.  Then each kernel of the paths on NaN-bearing inputs
    (:func:`phase_health_kernels`)."""
    from lightgbm_tpu_torch.ops import graphs
    ds = data[0]
    e2e = {"card": card_line()}
    nan = float("nan")
    for cell, params in HEALTH_CELLS.items():
        b = ltt.Booster(params=dict(params, device_type=DEVICE,
                                    num_iterations=100), train_set=ds)
        for _ in range(2):
            b.update()
        saved = poison_labels(torch, b)
        replays = graphs.REPLAYS["graph_replays"]
        secs = expect_health_error(torch, b, b.update, (2, "tree"), cell)
        if graphs.REPLAYS["graph_replays"] == replays:
            fail(f"{cell}: the failing tree did not run on the graphs")
        b._gbdt.objective.sign_label.copy_(saved)
        prof = health_profile(torch, b)
        if b.current_iteration() < 5 or not np.all(np.isfinite(
                b._gbdt.train_score())):
            fail(f"{cell}: the booster did not train on from its boundary")
        prof["failing_update_s"] = secs
        print(f"phase 17 {cell}: NumericalHealthError at iteration 2 "
              f"(tree) in {secs:.3f} s, the booster at its boundary, then "
              f"iterations 2-4 on clean labels, profiled; health reductions "
              f"{prof['flags_kernels']} a tree ({prof['flags_recorded']} "
              f"recorded in the window), "
              f"{prof['flags_device_ms']:.4f} device ms of the iteration's "
              f"{prof['busy_device_ms']:.3f} busy ms (share "
              f"{prof['flags_share']:.5f}); {e2e['card']}",
              flush=True)
        e2e[cell] = prof
        del b
    # the fused cell: a rewind, then a poisoned block and a queued one
    b = ltt.Booster(params=dict(HEALTH_CELLS["wave255"], device_type=DEVICE,
                                num_iterations=100, fused_iters=HEALTH_FUSED,
                                superstep_pipeline_depth=1), train_set=ds)
    for _ in range(2):
        b.update()
    g = b._gbdt
    g._fused_rewind()
    poison_labels(torch, b)
    secs = expect_health_error(torch, b, b.update, (2, "superstep"),
                               "wave255 fused_iters=4 depth 1")
    if g._sq or g._fused_block is not None or len(g.block_sizes) < 3:
        fail("wave255 fused: the poisoned block and the queued one were not "
             "dropped")
    print(f"phase 17 wave255 fused_iters={HEALTH_FUSED} depth 1: "
          f"NumericalHealthError at iteration 2 (superstep) in {secs:.3f} s, "
          f"blocks dropped, the booster at its boundary", flush=True)
    e2e["wave255-fused"] = {"failing_update_s": secs}
    del b, g
    # an infinite label at iteration 0: the bias goes back out
    b = ltt.Booster(params=dict(TRAIN_PARAMS, device_type=DEVICE),
                    train_set=ds)
    poison_labels(torch, b, float("inf"), rows=[7])
    expect_health_error(torch, b, b.update, (0, "tree"), "exact255 inf label")
    if float(b._gbdt.train_score_tensor().abs().max()) != 0.0:
        fail("exact255 inf label: the bias stayed in the training score")
    print("phase 17 exact255: an infinite label raises at iteration 0 "
          "(tree), the score back at 0", flush=True)
    del b
    # fobj: NaN gradients from iteration 1
    p = dict(TRAIN_PARAMS, **WAVE_PARAMS, device_type=DEVICE, metric="None")
    p["objective"] = "none"
    b = ltt.Booster(params=p, train_set=ds)

    def fobj(score, dataset):
        gr, he = logloss_fobj(score, dataset)
        if b.current_iteration() >= 1:
            gr[::HEALTH_EVERY] = nan
        return gr, he

    b.update(fobj=fobj)
    secs = expect_health_error(torch, b, lambda: b.update(fobj=fobj),
                               (1, "tree"), "wave255-noc2f fobj")
    print(f"phase 17 wave255-noc2f fobj: NaN gradients raise at iteration 1 "
          f"(tree) in {secs:.3f} s", flush=True)
    del b
    # a no-split stop at full width, graphed and fused
    stop = dict(TRAIN_PARAMS, device_type=DEVICE, num_iterations=8,
                min_data_in_leaf=N_ROWS + 1)
    for what, extra in (("graphed", {}), ("fused", {
            "fused_iters": HEALTH_FUSED, "superstep_pipeline_depth": 1,
            "boost_from_average": False})):
        b = ltt.Booster(params=dict(stop, **extra), train_set=ds)
        for _ in range(3):
            if b.update():
                break
        if (b.num_trees(), b.current_iteration()) != (1, 0) or \
                not b._gbdt._stop_flag:
            fail(f"no-split stop {what}: {b.num_trees()} trees, iteration "
                 f"{b.current_iteration()}, not 1 and 0")
        print(f"phase 17 no-split stop ({what}): 1 tree, iteration 0",
              flush=True)
        del b
    torch.cuda.empty_cache()
    e2e["kernels"] = phase_health_kernels(torch, ds)
    return e2e


def _nan_same(torch, k, q, rel, name, ctx):
    """``k`` against ``q``: NaN at the same places, the same infinities,
    finite values equal (``rel`` 0) or within ``rel``.  -> NaN count."""
    k, q = k.double(), q.double()
    if not torch.equal(torch.isnan(k), torch.isnan(q)):
        fail(f"kernel {name} ({ctx}): NaN at {int(torch.isnan(k).sum())} "
             f"places, plain at {int(torch.isnan(q).sum())}, not the same")
    fin = ~torch.isnan(k)
    kf, qf = k[fin], q[fin]
    if not torch.equal(torch.isinf(kf), torch.isinf(qf)) or not torch.equal(
            kf[torch.isinf(kf)], qf[torch.isinf(qf)]):
        fail(f"kernel {name} ({ctx}): infinities differ from plain")
    both = torch.isfinite(kf)
    diff = (kf[both] - qf[both]).abs()
    worst = float((diff / qf[both].abs().clamp_min(1e-30)).max()) \
        if diff.numel() else 0.0
    if (rel == 0 and diff.numel() and float(diff.max()) != 0.0) or \
            worst > rel:
        fail(f"kernel {name} ({ctx}): finite values differ from plain "
             f"(max rel {worst})")
    return int(torch.isnan(k).sum())


def _same_record(torch, k, q, ctx):
    """Kernel S's record against the plain scan's, NaN for NaN."""
    for key in ("feature", "threshold", "default_left", "left_mask"):
        if not torch.equal(k[key].to(q[key].dtype), q[key]):
            fail(f"kernel S ({ctx}): {key} {k[key].tolist()[:4]} against "
                 f"plain {q[key].tolist()[:4]}")
    _nan_same(torch, k["gain"], q["gain"], 0, "S", ctx + ", gain")
    _nan_same(torch, k["left_stats"], q["left_stats"], 0, "S",
              ctx + ", left stats")


def phase_health_kernels(torch, ds):
    """Phase 17: every kernel of the three paths on NaN-bearing inputs at
    full width (the dataset's 28 x 10.5M bins), one launch against its
    plain version.  Float kernels (H; L; Q's grad column) must give NaN at
    the same places and the same finite values; kernel S the same record
    NaN for NaN; the quantized passes (M, R, V, V-lanes) get the int8
    operand of NaN gradients (its scale NaN: the integers a NaN rounds to
    are never an index) and must be exact.  Where a fixed-point float sum
    (Q; M on float values, the float waves' root pass) takes a NaN, every
    cell of that column is NaN, where the plain sum has NaN only in the
    cells holding the row: the phase checks that, the other columns, and
    that the scans choose no split on either output (a tree whose
    gradients hold a NaN splits nowhere, so nothing reads the column
    beyond)."""
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import lookup as tl
    from lightgbm_tpu_torch.ops import split as ts
    from types import SimpleNamespace
    from lightgbm_tpu_torch.ops.grow import _value_operand, quantize_gradients
    from lightgbm_tpu_torch.utils import prng
    dev = torch.device(DEVICE, 0)
    bins = ds._constructed.binned.to(dev)
    F, N = bins.shape
    B = 256
    out = {}
    g = torch.Generator(device=dev).manual_seed(17)
    grad = torch.randn(N, generator=g, device=dev)
    hess = torch.rand(N, generator=g, device=dev) + 0.05
    mask = torch.ones(N, device=dev)
    nan_rows = grad.clone()
    nan_rows[::HEALTH_EVERY] = float("nan")
    one_row = grad.clone()
    one_row[7] = float("nan")
    one_row[11] = float("inf")
    lid0 = torch.zeros(N, dtype=torch.uint8, device=dev)
    leaf0 = torch.zeros((), dtype=torch.int32, device=dev)

    # H: the root pass
    for ctx, gv in (("1 row in 1,000 NaN", nan_rows),
                    ("one NaN and one inf row", one_row)):
        args = (bins, gv, hess, mask, lid0, leaf0, B)
        k = th.masked_histogram(*args)
        q = th.masked_histogram_plain(*args)
        out[f"H, {ctx}"] = _nan_same(torch, k, q, 1e-5, "H", ctx)
    # S: lane 0 the NaN row's root (its parent NaN), lane 1 a clean leaf
    # with one NaN cell (its parent finite)
    clean = th.masked_histogram(bins, grad, hess, mask, lid0, leaf0, B)
    hist = torch.stack([k, clean]).contiguous()
    parent = hist[:, 0].sum(dim=1).contiguous()
    hist[1, 3, 10, 0] = float("nan")
    nb = torch.full((F,), B - 1, dtype=torch.int32, device=dev)
    mt = torch.zeros(F, dtype=torch.int32, device=dev)
    mt[::4] = 2
    fm = torch.ones(F, dtype=torch.bool, device=dev)
    p = ts.SplitParams(max_bin=B, min_data_in_leaf=20,
                       min_sum_hessian_in_leaf=100.0, any_missing=True)
    kr = ts.find_best_split(hist, parent, nb, mt, fm, p)
    kr = {key: v.clone() for key, v in kr.items()}
    qr = ts.find_best_split_plain(hist, parent, nb, mt, fm, p)
    _same_record(torch, kr, qr, "W=2, a NaN root and a NaN cell")
    if bool((kr["gain"] > 0).any()):
        fail("kernel S splits a leaf with a NaN histogram cell")
    out["S"] = {"gain": kr["gain"].tolist(), "feature": kr["feature"].tolist()}
    # L: NaN and infinite leaf values
    score = torch.randn(N, generator=g, device=dev)
    vals = torch.randn(255, generator=g, device=dev)
    vals[3], vals[5], vals[6] = float("nan"), float("inf"), -float("inf")
    idx = torch.randint(0, 255, (N,), generator=g, device=dev,
                        dtype=torch.int32).to(torch.uint8)
    ks, qs = score.clone(), score.clone()
    tl.take_small_add(ks, vals, idx)
    tl.take_small_add_plain(qs, vals, idx)
    out["L"] = _nan_same(torch, ks, qs, 0, "L", "NaN and inf leaf values")
    del ks, qs, score

    # the quantized operand of NaN gradients
    gp = SimpleNamespace(quantize=120, two_col=True)   # wave255's
    gq, hq, scale = quantize_gradients(nan_rows, hess, mask, 120, True,
                                       prng.prng_key(0))
    qv = _value_operand(gq, hq, mask, gp)
    cpu_q = _value_operand(gq.cpu(), hq.cpu(), mask.cpu(), gp)
    at_nan = qv[::HEALTH_EVERY, 0]
    out["quantized"] = {
        "scale": scale.tolist(),
        "int8_at_nan_rows": torch.unique(at_nan).tolist(),
        "int8_at_nan_rows_cpu": torch.unique(cpu_q[::HEALTH_EVERY, 0])
        .tolist(),
        "int8_elsewhere": torch.unique(qv[1:HEALTH_EVERY, 0]).tolist()}
    if not bool(torch.isnan(scale[0])):
        fail("the quantization scale of NaN gradients is finite")
    # M, full and coarse root passes; R a wave; V the root's window;
    # V-lanes the wave's children: int8 values, exact
    sel0 = torch.zeros(N, dtype=torch.int8, device=dev)
    check_multi(torch, th, bins, qv, sel0, 1, B, True, True,
                "NaN gradients' int8 operand, root")
    shift = 4
    Bc = ((B - 1) >> shift) + 2
    R = 2 << shift
    miss_bin = torch.full((F,), -1, dtype=torch.int32, device=dev)
    miss_bin[::4] = B - 2
    check_multi(torch, th, bins, qv, sel0, 1, Bc, True, True,
                "NaN gradients' int8 operand, coarse root", shift, miss_bin)
    W = 64
    li = torch.randint(0, 127, (N,), generator=g, device=dev,
                       dtype=torch.int32).to(torch.uint8)
    ids = torch.randperm(127, generator=g, device=dev)[:W].to(torch.int32)
    ids[60:] = 127
    tbl = torch.stack([
        ids,
        torch.randint(0, F, (W,), generator=g, device=dev, dtype=torch.int32),
        torch.randint(0, B - 3, (W,), generator=g, device=dev,
                      dtype=torch.int32),
        torch.arange(127, 127 + W, device=dev, dtype=torch.int32),
        torch.randint(0, 2, (W,), generator=g, device=dev, dtype=torch.int32),
        torch.randint(0, 2, (W,), generator=g, device=dev,
                      dtype=torch.int32)]).contiguous()
    check_routed(torch, th, (bins, qv, li, tbl, B, W, True),
                 {"miss_bin": miss_bin, "shift": 0},
                 True, "NaN gradients' int8 operand, W=64")
    kl = th.routed_histogram(bins, qv, li, tbl, Bc, W, True, miss_bin,
                             shift=shift)[1]
    lo0 = _lanes_windows(torch, g, dev, 1, F, Bc, shift)
    args = (bins, qv, sel0, lo0, R, 1, True, miss_bin)
    check_against(torch, lambda: th.window_histogram(*args),
                  lambda: th.window_histogram_plain(*args), True, "V",
                  "NaN gradients' int8 operand, the root's window")
    lanes = torch.cat([tbl[0, :30], tbl[3, :30],
                       torch.full((4,), 256, dtype=torch.int32,
                                  device=dev)]).contiguous()
    lo = _lanes_windows(torch, g, dev, W, F, Bc, shift)
    args = (bins, qv, kl, lanes, lo, R, W, True, miss_bin)
    check_against(torch, lambda: th.lanes_window_histogram(*args),
                  lambda: th.lanes_window_histogram_plain(*args), True,
                  "V-lanes", "NaN gradients' int8 operand, W=64")
    del li, kl
    # Q and M on float values: a NaN column is NaN in every cell
    lq = torch.randint(0, 255, (N,), generator=g, device=dev,
                       dtype=torch.int32).to(torch.uint8)
    for ctx, gv in (("1 row in 1,000 NaN", nan_rows),
                    ("one NaN and one inf row", one_row)):
        kq = th.leaf_stats(lq, gv, hess, mask, 255)
        pq = th.leaf_stats_plain(lq, gv, hess, mask, 255)
        _nan_same(torch, kq[:, 1:], pq[:, 1:], 1e-6, "Q", ctx + ", hess, count")
        if kq.is_cuda and not bool(torch.isnan(kq[:, 0]).all()):
            fail(f"kernel Q ({ctx}): a NaN-bearing grad column is not NaN "
                 f"in every leaf")
        out[f"Q, {ctx}"] = {
            "plain_nan_leaves": int(torch.isnan(pq[:, 0]).sum()),
            "kernel_nan_leaves": int(torch.isnan(kq[:, 0]).sum())}
        fv = torch.stack([gv, hess, mask], -1).contiguous()
        km = th.multi_histogram(bins, fv, sel0, B, 1, False)
        pm = th.multi_histogram_plain(bins, fv, sel0, B, 1, False)
        _nan_same(torch, km[..., 1:], pm[..., 1:], 1e-5, "M",
                  ctx + ", float values, hess and count")
        if km.is_cuda and not bool(torch.isnan(km[..., 0]).all()):
            fail(f"kernel M ({ctx}): a NaN-bearing float column is not NaN "
                 f"in every cell")
        for which, h in (("kernel", km[0]), ("plain", pm[0])):
            r = ts.find_best_split_plain(h[None].contiguous(),
                                         h[0].sum(0)[None].contiguous(),
                                         nb, mt, fm, p)
            if bool((r["gain"] > 0).any()):
                fail(f"M float ({ctx}): the scan splits the {which} "
                     f"histogram")
        out[f"M float, {ctx}"] = {
            "plain_nan_cells": int(torch.isnan(pm[..., 0]).sum()),
            "kernel_nan_cells": int(torch.isnan(km[..., 0]).sum())}
    print(f"phase 17 kernels on NaN input: H, S, L as plain NaN for NaN; "
          f"M, R, V, V-lanes exact on the int8 operand of NaN gradients "
          f"(scale {out['quantized']['scale']}, int8 at NaN rows "
          f"{out['quantized']['int8_at_nan_rows']} on the card, "
          f"{out['quantized']['int8_at_nan_rows_cpu']} on the CPU); Q and "
          f"float M NaN in the whole column, no split either way: {out}",
          flush=True)
    return out


def _phase_done(name, t0):
    """Print a phase's seconds; the clock for the next."""
    print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return time.perf_counter()


def main():
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import torch
    except ImportError:
        fail("torch is not importable")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    try:
        import lightgbm_tpu_torch as ltt
        from lightgbm_tpu_torch.ops import kernels
    except ImportError as e:
        fail(f"the lightgbm_tpu_torch package is not beside this script: {e}")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: build ----------------------------------------------
    kernels.load()
    info = kernels.build_info()
    print(f"kernel build: {info['seconds']:.1f} s "
          f"(built={info['built']}) -> {info['path']}", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("---"):
            print("  " + line.strip(), flush=True)

    # ---- phase 2: kernels vs plain -----------------------------------
    t_phase = time.perf_counter()
    stats = phase_kernels(torch, dev)
    b_stats = phase_kernels_sample(torch, dev)
    stats["sample_bag"] = dict(b_stats["bernoulli"],
                               stratified=b_stats["stratified"])
    for k in ("goss", "mvs"):
        stats[f"sample_{k}"] = b_stats[k]
    for k in ("goss_select", "mvs_scores", "mvs_scan"):
        stats[k] = b_stats[k]
    stats["class_sum"] = phase_kernels_class_sum(torch, dev)
    stats["route"] = phase_kernels_route(torch, dev)
    stats["efb"] = phase_kernels_efb(torch, dev)
    t_phase = _phase_done("phase 2 (kernels H-T)", t_phase)
    # ---- phase 3: the exact path end to end at full width ------------
    data, exact_counts, e2e = phase_full_width(torch, ltt)
    t_phase = _phase_done("phase 3", t_phase)
    # ---- phase 4: wave255 without coarse-to-fine at full width -------
    wave_counts, e2e_wave = phase_wave(torch, ltt, data,
                                       e2e["holdout_auc"])
    t_phase = _phase_done("phase 4", t_phase)
    # ---- phase 5: wave255 as it ships, with coarse-to-fine -----------
    c2f_counts, e2e_c2f = phase_c2f(torch, ltt, data, e2e["holdout_auc"])
    t_phase = _phase_done("phase 5", t_phase)
    # ---- phase 9: bagging, GOSS and MVS at full width -----------------
    sampled_counts, e2e_sampled = phase_sampled(
        torch, ltt, data, {"exact": e2e["seconds_per_iteration"],
                           "wave": e2e_wave["seconds_per_iteration"],
                           "c2f": e2e_c2f["seconds_per_iteration"]})
    t_phase = _phase_done("phase 9", t_phase)
    # ---- phase 7: each path with the holdout as a validation set -----
    valid_counts, e2e_valid = {}, {}
    for path, params, names, e in (
            ("exact", TRAIN_PARAMS, ("histogram", "best_split",
                                     "leaf_lookup"), e2e),
            ("wave", dict(TRAIN_PARAMS, **WAVE_PARAMS),
             ("multi_histogram", "routed_histogram", "leaf_stats",
              "best_split", "leaf_lookup"), e2e_wave),
            ("c2f", dict(TRAIN_PARAMS, **WAVE255_PARAMS),
             ("multi_histogram", "window_histogram", "routed_histogram",
              "lanes_window_histogram", "leaf_stats", "leaf_lookup"),
             e2e_c2f)):
        valid_counts[path], e2e_valid[path] = phase_valid(
            torch, ltt, data, path, params, names,
            e["seconds_per_iteration"])
    t_phase = _phase_done("phase 7", t_phase)
    # ---- phase 10: DART, random forests, rollback_one_iter -----------
    boosting_counts, e2e_boosting = phase_boosting(
        torch, ltt, data, {"exact": e2e["seconds_per_iteration"],
                           "wave": e2e_wave["seconds_per_iteration"]})
    t_phase = _phase_done("phase 10", t_phase)
    # ---- phase 12: the regression zoo at full width ------------------
    reg_counts, e2e_regression = phase_regression(torch, ltt, data)
    t_phase = _phase_done("phase 12", t_phase)
    # ---- phase 13: a custom objective at the Higgs shape -------------
    fobj_counts, e2e_fobj = phase_fobj(torch, ltt, data,
                                       e2e_wave["seconds_per_iteration"])
    t_phase = _phase_done("phase 13 (higgs-wave255-noc2f-fobj)", t_phase)
    # ---- phase 14: bench.py's missing + categorical Higgs row ---------
    cat_counts, e2e_categorical = phase_categorical(
        torch, ltt, data, e2e_c2f["seconds_per_iteration"])
    t_phase = _phase_done("phase 14 (missing + categorical)", t_phase)
    # ---- phase 16: monotone constraints and the feature penalty --------
    mono_counts, e2e_monotone = phase_monotone(
        torch, ltt, data, {"exact": e2e, "wave": e2e_wave, "c2f": e2e_c2f})
    t_phase = _phase_done("phase 16 (monotone constraints, penalty)",
                          t_phase)
    # ---- phase 17: the numerical-health checks ------------------------
    e2e_health = phase_health(torch, ltt, data)
    t_phase = _phase_done("phase 17 (numerical health)", t_phase)
    del data
    torch.cuda.empty_cache()
    # ---- phase 15: bench.py's sparse one-hot row, bundled -------------
    efb_counts, e2e_allstate = phase_allstate(torch, ltt)
    t_phase = _phase_done("phase 15 (allstate, EFB)", t_phase)
    # ---- phase 11: multiclass at bench.py's shape --------------------
    mc_counts, e2e_multiclass = phase_multiclass(torch, ltt)
    t_phase = _phase_done("phase 11", t_phase)
    # ---- phase 2's kernel U, phase 13: MS-LTR lambdarank -------------
    Xr, yr, cr, Xrh, yrh, crh = make_msltr(
        RANK_QUERIES, RANK_DOCS, RANK_FEATURES, RANK_HOLDOUT_QUERIES)
    t_phase = _phase_done("MS-LTR data generation", t_phase)
    stats["lambdarank"] = phase_kernels_rank(torch, dev, Xr, yr, cr)
    t_phase = _phase_done("phase 2 (kernel U)", t_phase)
    rank_counts, e2e_ranking = phase_ranking(torch, ltt, Xr, yr, cr, Xrh,
                                             yrh, crh)
    del Xr, yr, Xrh, yrh
    t_phase = _phase_done("phase 13 (msltr-lambdarank, -valid)", t_phase)
    # ---- phase 6: device vs cpu --------------------------------------
    phase_device_vs_cpu(ltt)
    t_phase = _phase_done("phase 6", t_phase)
    # ---- phase 8: cv on the card -------------------------------------
    cv_result = phase_cv(torch, ltt)
    t_phase = _phase_done("phase 8", t_phase)

    # (route, source, the TPU kernel it replaces, the path whose run
    # gives its launches and whose shapes its numbers are taken at:
    # kernel H runs on the exact path only and kernel S on the paths
    # without c2f; M and R report their coarse mode on the c2f path, with
    # their full-resolution numbers from the wave path beside them)
    meta = {
        "histogram": ("lightgbm_tpu_torch/csrc/histogram.cu",
                      "lightgbm_tpu/ops/histogram.py:238", exact_counts),
        "best_split": ("lightgbm_tpu_torch/csrc/split.cu",
                       "lightgbm_tpu/ops/split.py:899", wave_counts),
        # its constrained mode (the TPU kernel's mono, pen and lane bounds),
        # on phase 16's exact and no-c2f cells
        "best_split_constrained": (
            "lightgbm_tpu_torch/csrc/split.cu",
            "lightgbm_tpu/ops/split.py:899",
            {"best_split_constrained": sum(
                c.get("best_split_constrained", 0)
                for c in mono_counts.values())}),
        "leaf_lookup": ("lightgbm_tpu_torch/csrc/lookup.cu",
                        "lightgbm_tpu/ops/lookup.py:35", c2f_counts),
        # the valid scorer's add (lightgbm_tpu/models/gbdt.py:2629)
        "leaf_lookup_f64": ("lightgbm_tpu_torch/csrc/lookup.cu",
                            "lightgbm_tpu/ops/lookup.py:35",
                            valid_counts["c2f"]),
        "multi_histogram": ("lightgbm_tpu_torch/csrc/multi_hist.cu",
                            "lightgbm_tpu/ops/histogram.py:396",
                            c2f_counts),
        "routed_histogram": ("lightgbm_tpu_torch/csrc/routed_hist.cu",
                             "lightgbm_tpu/ops/histogram.py:872",
                             c2f_counts),
        "leaf_stats": ("lightgbm_tpu_torch/csrc/leaf_stats.cu",
                       "lightgbm_tpu/ops/histogram.py:1239", c2f_counts),
        "window_histogram": ("lightgbm_tpu_torch/csrc/window_hist.cu",
                             "lightgbm_tpu/ops/histogram.py:628",
                             c2f_counts),
        "lanes_window_histogram": ("lightgbm_tpu_torch/csrc/window_hist.cu",
                                   "lightgbm_tpu/ops/histogram.py:1113",
                                   c2f_counts),
        # kernel B replaces no Pallas kernel: the JAX package draws its
        # masks in XLA at these lines
        "sample_bag": ("lightgbm_tpu_torch/csrc/sample.cu",
                       "lightgbm_tpu/models/gbdt.py:1110",
                       sampled_counts["exact255-bagging"]),
        "sample_goss": ("lightgbm_tpu_torch/csrc/sample.cu",
                        "lightgbm_tpu/models/boosting.py:78",
                        sampled_counts["goss255"]),
        "sample_mvs": ("lightgbm_tpu_torch/csrc/sample.cu",
                       "lightgbm_tpu/models/boosting.py:162",
                       sampled_counts["wave255-noc2f-mvs"]),
        # the step's thresholds: GOSS's top-set order statistic (:86),
        # MVS's scores (:168) and mu (`_threshold_device`, :119)
        "goss_select": ("lightgbm_tpu_torch/csrc/sample.cu",
                        "lightgbm_tpu/models/boosting.py:86",
                        sampled_counts["goss255"]),
        "mvs_scores": ("lightgbm_tpu_torch/csrc/sample.cu",
                       "lightgbm_tpu/models/boosting.py:168",
                       sampled_counts["wave255-noc2f-mvs"]),
        "mvs_scan": ("lightgbm_tpu_torch/csrc/sample.cu",
                     "lightgbm_tpu/models/boosting.py:119",
                     sampled_counts["wave255-noc2f-mvs"]),
        # the class sum over K classes (:82, :165), on phase 11's GOSS and
        # MVS cells
        "class_sum": ("lightgbm_tpu_torch/csrc/sample.cu",
                      "lightgbm_tpu/models/boosting.py:82",
                      {"class_sum": sum(mc_counts[c]["class_sum"]
                                        for c in MC_SAMPLED)}),
        # kernel T replaces no Pallas kernel: the JAX package routes a
        # validation set's rows in XLA
        "route": ("lightgbm_tpu_torch/csrc/route.cu",
                  "lightgbm_tpu/ops/grow.py:1833", valid_counts["c2f"]),
        # kernel U replaces no Pallas kernel: the JAX package computes
        # LambdaRank's lambdas in XLA (LambdaRank._grads_impl)
        "lambdarank": ("lightgbm_tpu_torch/csrc/rank.cu",
                       "lightgbm_tpu/objectives.py:714",
                       rank_counts["msltr-lambdarank"]),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    rows = []
    for name, (src, repl, counts) in meta.items():
        s = stats.get(f"c2f_{name}", stats.get(name))
        # the contract's keys first, then the kernel's own figures
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": repl, "launches": counts[name],
               **{k: s[k] for k in keys},
               **{k: v for k, v in s.items() if k not in keys}}
        if f"c2f_{name}" in stats and name in stats:
            row["full_resolution"] = {"launches": wave_counts[name],
                                      **stats[name]}
        if name == "best_split":
            row["at_2w128"] = stats["best_split_2w"]
        if name == "best_split_constrained":
            row["at_2w128"] = stats["best_split_constrained_2w"]
            row["launches_by_cell"] = {
                k: v.get(name, 0) for k, v in mono_counts.items()}
        if name == "leaf_lookup_f64":
            row["launches_by_path"] = {k: v[name]
                                       for k, v in valid_counts.items()}
        if meta[name][0].endswith(("sample.cu", "route.cu", "rank.cu")):
            row["replaces_pallas_kernel"] = False
        if name.startswith("route"):
            row["launches_by_path"] = {
                **{k: v[name] for k, v in valid_counts.items()},
                **{k: v[name] for k, v in boosting_counts.items()}}
        # this slice's paths: phase 11's and 12's graphed runs
        more = {k: v[name] for k, v in {**mc_counts, **reg_counts}.items()
                if v.get(name)}
        if more:
            row["launches_objective_zoo"] = more
        # this slice's paths: phase 13's runs
        more = {k: v[name] for k, v in {**rank_counts,
                                        "higgs-wave255-noc2f-fobj":
                                        fobj_counts}.items()
                if v.get(name)}
        if more:
            row["launches_ranking_fobj"] = more
        # phase 14's runs: launches a tree
        more = {k: v[name] / (VALID_TREES["cat-wave"] if
                              k.endswith("valid") else N_TREES)
                for k, v in cat_counts.items() if v.get(name)}
        if more:
            row["launches_per_tree_categorical"] = more
        # phase 15's runs: launches a tree, and the kernel at the bundled
        # shapes (phase 2)
        more = {k: v[name] / (VALID_TREES["allstate-wave"] if
                              k.endswith("valid") else N_TREES)
                for k, v in efb_counts.items() if v.get(name)}
        if more:
            row["launches_per_tree_allstate"] = more
        if name in stats["efb"]:
            row["at_allstate_bundles"] = stats["efb"][name]
        rows.append(row)
    print(json.dumps({"card": card, "e2e_exact": e2e, "e2e_wave": e2e_wave,
                      "e2e_c2f": e2e_c2f, "launches_exact": exact_counts,
                      "launches_wave": wave_counts,
                      "launches_c2f": c2f_counts,
                      "e2e_sampled": e2e_sampled, "e2e_valid": e2e_valid,
                      "e2e_boosting": e2e_boosting,
                      "launches_valid": valid_counts, "cv": cv_result,
                      "e2e_multiclass": e2e_multiclass,
                      "e2e_regression": e2e_regression,
                      "e2e_ranking": e2e_ranking, "e2e_fobj": e2e_fobj,
                      "e2e_categorical": e2e_categorical,
                      "e2e_allstate": e2e_allstate,
                      "e2e_monotone": e2e_monotone,
                      "e2e_health": e2e_health,
                      "expand": {k: v for k, v in stats["efb"].items()
                                 if k.startswith("expand")},
                      "categorical_scan": stats["categorical_scan"]}),
          flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
