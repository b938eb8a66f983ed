"""Where one boosting iteration's time goes, at the Higgs shape on the card.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 -m lightgbm_tpu_torch.tools.prof_iteration [--rows N]
        [--wave [--no-c2f]] [--fused K] [--eager]

It trains the configuration ``chip_smoke.py`` drives at full width
(10.5M x 28, num_leaves=255, max_bin=255; data from the same generator):
the exact path, or with ``--wave`` bench.py's wave255 as it ships (wave
growth with quantized two-column passes and coarse-to-fine refinement),
with ``--wave --no-c2f`` the same with hist_refinement=false.  Trees run
on CUDA graphs, as training runs them; ``--eager`` launches every kernel
from Python instead (the launch sequence before the graphs), and
``--fused K`` trains with ``fused_iters=K`` (blocks of K trees, one
records fetch a block).  After the warm-up (the first tree, eager, and
the graphs' capture, timed apart) it reports:

- ``iteration_s``: host clock around ``Booster.update()`` ending in a
  synchronise, median of 3; with ``--fused K``, around one block's K
  updates, divided by K (``block_s`` is the block's time);
- ``enqueue_s`` / ``tree_s``: one tree run on the booster's runner, timed
  on the host before and after a synchronise — when the two are close,
  the host (Python and launch overhead) sets the pace and the card waits;
- ``host_trees_s`` / ``host_land_s``: of the timed iterations, the host
  seconds an iteration spent running trees (the wave loop's flag reads
  wait on the card) and landing blocks (waiting for a block's records,
  making its trees on the host);
- from ``torch.profiler`` over one more iteration (one more block with
  ``--fused``): the device's busy time (the union of kernel intervals),
  its idle share of the window's wall time (``device_idle_share``; the
  profiler slows the host, more so around a graph's many kernels) and of
  the unprofiled iteration (``idle_share_of_iteration``), the kernels it
  saw (``kernel_launches``, per iteration) and device time by kernel name
  (the histogram body shared by kernels R, M, V and V-lanes, and the
  reduction kernel Q shares with it, by kernel), and the device time and
  calls of kernels H, S, R, M, V, V-lanes, Q and U (``kernel_h``: its
  histogram launch and its reduction; ``kernel_s``: its one launch;
  ``kernel_r``: its routing, histogram and reduction launches;
  ``kernel_m``, ``kernel_v`` and ``kernel_vl``: their histogram and
  reduction launches, and the exponent launch of float values;
  ``kernel_q``: its sum, bound and reduction launches; ``kernel_u``:
  LambdaRank's lambdas, one launch; the count is that of the first, one
  per call);
- per tree over the same window: the wrappers' kernel launches executed
  (``own_launches_per_tree``, graph replays included), graph replays
  (``graph_replays_per_tree``) and the wave loop's flag reads
  (``flag_reads_per_tree``); and the capture (``capture``: graphs and
  their kernel launches, host seconds, the graph pool's memory).

The JSON is the last line of standard output.  Without a card it exits
non-zero.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# kernels of this package, by the name of their __global__ function
OWN_KERNELS = ("hist_masked_kernel", "hist_reduce_kernel", "best_split_kernel",
               "leaf_add_kernel", "route_kernel", "group_hist_kernel",
               "group_reduce_kernel", "exp_max_kernel", "leaf_bound_kernel",
               "leaf_stats_kernel", "tree_walk_kernel", "lambda_kernel")
# the shared body's launches, by the tag of their kernel (group_hist.cuh)
GROUP_TAGS = (("RoutedTag", "R"), ("MultiTag", "M"), ("LanesTag", "V-lanes"),
              ("WindowTag", "V"), ("LeafTag", "Q"))
# each kernel's rows; the first counts its calls
BY_KERNEL = {
    "kernel_h": ("hist_masked_kernel", "hist_reduce_kernel"),
    "kernel_s": ("best_split_kernel",),
    "kernel_r": ("route_kernel", "group_hist_kernel [R]",
                 "group_reduce_kernel [R]"),
    "kernel_m": ("group_hist_kernel [M]", "group_reduce_kernel [M]",
                 "exp_max_kernel [M]"),
    "kernel_v": ("group_hist_kernel [V]", "group_reduce_kernel [V]",
                 "exp_max_kernel [V]"),
    "kernel_vl": ("group_hist_kernel [V-lanes]",
                  "group_reduce_kernel [V-lanes]",
                  "exp_max_kernel [V-lanes]"),
    "kernel_q": ("leaf_stats_kernel", "leaf_bound_kernel",
                 "group_reduce_kernel [Q]"),
    "kernel_u": ("lambda_kernel",),
}


def _key(name: str):
    """(row name, one of this package's kernels)."""
    own = next((k for k in OWN_KERNELS if k in name), None)
    if own is None:
        return name[:80], False
    tag = next((v for k, v in GROUP_TAGS if k in name), None)
    if tag is not None:
        return f"{own} [{tag}]", True
    return own, True


def kernel_table(prof, torch):
    """Kernel intervals from the profiler -> (busy us, launches, rows)."""
    spans, by_name = [], {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        key, own = _key(evt.name)
        row = by_name.setdefault(key, {"name": key, "own": own,
                                       "launches": 0, "us": 0.0})
        row["launches"] += 1
        row["us"] += end - start
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    rows = sorted(by_name.values(), key=lambda r: -r["us"])
    return busy, len(spans), rows


def counters():
    """(kernel launches executed through the wrappers, graph replays)."""
    from lightgbm_tpu_torch.ops import graphs
    return (sum(sum(c.values()) for c in graphs.LAUNCH_COUNTERS),
            graphs.REPLAYS["graph_replays"])


def profile_window(torch, fn):
    """``fn()`` under ``torch.profiler`` -> (wall s, busy us, kernels seen,
    kernel rows)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(0.02)    # see chip_smoke.profile_calls
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    return (wall_s,) + kernel_table(prof, torch)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--wave", action="store_true",
                    help="profile the wave path (wave255 as it ships)")
    ap.add_argument("--no-c2f", action="store_true",
                    help="with --wave: hist_refinement=false")
    ap.add_argument("--fused", type=int, default=1, metavar="K",
                    help="fused_iters: K trees a block")
    ap.add_argument("--eager", action="store_true",
                    help="launch every kernel from Python, no CUDA graphs")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("prof_iteration: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import lightgbm_tpu_torch as ltt

    card = chip_smoke.card_line()
    print(card, flush=True)
    X, y = chip_smoke.make_higgs_shaped(args.rows, chip_smoke.N_FEATURES,
                                        seed=0)
    K = args.fused
    params = dict(chip_smoke.TRAIN_PARAMS, device_type="cuda",
                  fused_iters=K, num_iterations=1000)
    if args.wave:
        params.update(chip_smoke.WAVE_PARAMS if args.no_c2f
                      else chip_smoke.WAVE255_PARAMS)
    booster = ltt.Booster(params=params,
                          train_set=ltt.Dataset(X, label=y, params=params),
                          _eager=args.eager)
    del X
    g = booster._gbdt
    runner = g.runner
    sync = torch.cuda.synchronize
    booster.update()          # the eager warm-up tree (the bias iteration)
    sync()
    capture = None
    if not args.eager:
        runner.capture()
        capture = runner.info
        print(f"capture: {capture}", flush=True)

    def block():
        for _ in range(K):
            booster.update()

    # host seconds inside the booster's tree runs (flag-read waits
    # included) and inside landing blocks (the fetch's wait, making the
    # trees); the rest of an iteration is the booster's own bookkeeping
    host = {"trees": 0.0, "land": 0.0}

    def timed(fn, key):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host[key] += time.perf_counter() - t0
        return call

    block()                   # the first block after the warm-up
    sync()
    runner.run = timed(runner.run, "trees")
    g._land_block = timed(g._land_block, "land")
    iters = []
    for _ in range(3):
        t0 = time.perf_counter()
        block()
        sync()
        iters.append(time.perf_counter() - t0)
    host_split = {f"host_{k}_s": v / (3 * K) for k, v in host.items()}

    own0, replays0 = counters()
    reads0, trees0 = runner.flag_reads, runner.trees
    wall_s, busy_us, launches, rows = profile_window(torch, block)
    own1, replays1 = counters()
    trees = runner.trees - trees0
    per_tree = {
        "own_launches_per_tree": (own1 - own0) / trees,
        "graph_replays_per_tree": (replays1 - replays0) / trees,
        "flag_reads_per_tree": (runner.flag_reads - reads0) / trees,
    }
    sync()
    t0 = time.perf_counter()
    runner.run()
    enqueue_s = time.perf_counter() - t0
    sync()
    tree_s = time.perf_counter() - t0

    own_us = sum(r["us"] for r in rows if r["own"])
    # kernels H, S, R, M, V, V-lanes and Q: device time of all their
    # launches, and the count of the first (one a call), per iteration
    by_kernel = {}
    for key, names in BY_KERNEL.items():
        k_rows = [r for r in rows if r["name"] in names]
        by_kernel[key] = {"ms": sum(r["us"] for r in k_rows) / 1e3 / K,
                          "launches": sum(r["launches"] for r in k_rows
                                          if r["name"] == names[0]) / K}
    out = {
        "card": card, "rows": args.rows,
        "path": ("wave-noc2f" if args.no_c2f else "wave-c2f")
        if args.wave else "exact",
        "fused_iters": K, "eager": args.eager,
        "pipeline_depth": int(g.config.superstep_pipeline_depth)
        if K > 1 else 0,
        "refine_shift": g.grow_params.refine_shift,
        "iteration_s": statistics.median(iters) / K,
        "block_s": statistics.median(iters), "block_runs_s": iters,
        "enqueue_s": enqueue_s, "tree_s": tree_s, **host_split,
        "profiled_iteration_s": wall_s / K,
        "device_busy_s": busy_us / 1e6 / K if launches else None,
        "device_idle_share": (1.0 - busy_us / 1e6 / wall_s)
        if launches else None,
        "idle_share_of_iteration":
        1.0 - busy_us / 1e6 / statistics.median(iters) if launches else None,
        "kernel_launches": launches / K,
        "own_kernels_s": own_us / 1e6 / K if launches else None,
        **per_tree,
        "capture": capture,
        **{k: v if launches else None for k, v in by_kernel.items()},
        "kernels": rows[:20],
    }
    print(f"{per_tree}", flush=True)
    if not launches:
        print("profiler recorded no device events: device time not measured",
              flush=True)
    else:
        print(f"iteration {out['iteration_s']:.4f} s; one tree enqueued in "
              f"{enqueue_s:.4f} s, done in {tree_s:.4f} s; profiled "
              f"iteration {wall_s / K:.4f} s, device busy "
              f"{busy_us / 1e6 / K:.4f} s (idle share "
              f"{out['device_idle_share']:.3f}), {launches / K:.0f} kernel "
              f"launches an iteration", flush=True)
        for key, v in by_kernel.items():
            print(f"{key}: {v['ms']:.3f} ms of device time in "
                  f"{v['launches']:.1f} calls an iteration", flush=True)
        for r in rows[:20]:
            print(f"  {r['us'] / 1e3:9.3f} ms {r['launches']:6d}x "
                  f"{'*' if r['own'] else ' '} {r['name']}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
