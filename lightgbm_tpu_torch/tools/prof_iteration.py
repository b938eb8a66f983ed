"""Where one boosting iteration's time goes, at the Higgs shape on the card.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 -m lightgbm_tpu_torch.tools.prof_iteration [--rows N]
        [--wave [--no-c2f]]

It trains the configuration ``chip_smoke.py`` drives at full width
(10.5M x 28, num_leaves=255, max_bin=255; data from the same generator):
the exact path, or with ``--wave`` bench.py's wave255 as it ships (wave
growth with quantized two-column passes and coarse-to-fine refinement),
with ``--wave --no-c2f`` the same with hist_refinement=false, and
reports, after one warm-up iteration:

- ``iteration_s``: host clock around ``Booster.update()`` ending in a
  synchronise (median of 3);
- ``enqueue_s`` / ``tree_s``: one tree's ``build_tree`` call timed on the
  host before and after a synchronise — when the two are close, the host
  (Python and launch overhead) sets the pace and the card waits;
- from ``torch.profiler`` over one more iteration: the device's busy time
  (the union of kernel intervals), its idle share of the iteration's
  wall time, kernel launches, and device time by kernel name (the
  histogram body shared by kernels R, M, V and V-lanes, and the reduction
  kernel Q shares with it, by kernel), and the device time and calls of
  kernels H, S, R, M, V, V-lanes and Q (``kernel_h``: its histogram
  launch and its reduction; ``kernel_s``: its one launch; ``kernel_r``:
  its routing, histogram and reduction launches; ``kernel_m``,
  ``kernel_v`` and ``kernel_vl``: their histogram and reduction launches,
  and the exponent launch of float values; ``kernel_q``: its sum, bound
  and reduction launches; the count is that of the first, one per call).

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
               "leaf_stats_kernel")
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


def _kernel_table(prof, torch):
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--wave", action="store_true",
                    help="profile the wave path (wave255 as it ships)")
    ap.add_argument("--no-c2f", action="store_true",
                    help="with --wave: hist_refinement=false")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("prof_iteration: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import lightgbm_tpu_torch as ltt
    from lightgbm_tpu_torch.ops.grow import build_tree

    card = chip_smoke.card_line()
    print(card, flush=True)
    X, y = chip_smoke.make_higgs_shaped(args.rows, chip_smoke.N_FEATURES,
                                        seed=0)
    params = dict(chip_smoke.TRAIN_PARAMS, device_type="cuda")
    if args.wave:
        params.update(chip_smoke.WAVE_PARAMS if args.no_c2f
                      else chip_smoke.WAVE255_PARAMS)
    booster = ltt.Booster(params=params,
                          train_set=ltt.Dataset(X, label=y, params=params))
    del X
    sync = torch.cuda.synchronize
    booster.update()                                     # warm-up
    sync()
    iters = []
    for _ in range(3):
        t0 = time.perf_counter()
        booster.update()
        sync()
        iters.append(time.perf_counter() - t0)

    g = booster._gbdt
    grad, hess = g.objective.get_gradients(g._score)
    sync()
    t0 = time.perf_counter()
    build_tree(g._xt, grad, hess, g._mask, g._feature_fraction_mask(),
               g._num_bins, g._missing_type, g.grow_params)
    enqueue_s = time.perf_counter() - t0
    sync()
    tree_s = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(0.02)    # see chip_smoke.profile_calls
        t0 = time.perf_counter()
        booster.update()
        sync()
        prof_wall_s = time.perf_counter() - t0
    busy_us, launches, rows = _kernel_table(prof, torch)
    own_us = sum(r["us"] for r in rows if r["own"])
    # kernels H, S, R, M, V, V-lanes and Q: device time of all their
    # launches, and the count of the first (one a call)
    by_kernel = {}
    for key, names in BY_KERNEL.items():
        k_rows = [r for r in rows if r["name"] in names]
        by_kernel[key] = {"ms": sum(r["us"] for r in k_rows) / 1e3,
                          "launches": sum(r["launches"] for r in k_rows
                                          if r["name"] == names[0])}
    out = {
        "card": card, "rows": args.rows,
        "path": ("wave-noc2f" if args.no_c2f else "wave-c2f")
        if args.wave else "exact",
        "refine_shift": g.grow_params.refine_shift,
        "iteration_s": statistics.median(iters), "iteration_runs_s": iters,
        "enqueue_s": enqueue_s, "tree_s": tree_s,
        "profiled_iteration_s": prof_wall_s,
        "device_busy_s": busy_us / 1e6 if launches else None,
        "device_idle_share": (1.0 - busy_us / 1e6 / prof_wall_s)
        if launches else None,
        "kernel_launches": launches,
        "own_kernels_s": own_us / 1e6 if launches else None,
        **{k: v if launches else None for k, v in by_kernel.items()},
        "kernels": rows[:20],
    }
    if not launches:
        print("profiler recorded no device events: device time not measured",
              flush=True)
    else:
        print(f"iteration {out['iteration_s']:.3f} s; one tree enqueued in "
              f"{enqueue_s:.3f} s, done in {tree_s:.3f} s; profiled "
              f"iteration {prof_wall_s:.3f} s, device busy "
              f"{busy_us / 1e6:.3f} s (idle share "
              f"{out['device_idle_share']:.3f}), {launches} kernel launches",
              flush=True)
        for key, v in by_kernel.items():
            print(f"{key}: {v['ms']:.3f} ms of device time in "
                  f"{v['launches']} calls", flush=True)
        for r in rows[:20]:
            print(f"  {r['us'] / 1e3:9.3f} ms {r['launches']:6d}x "
                  f"{'*' if r['own'] else ' '} {r['name']}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
