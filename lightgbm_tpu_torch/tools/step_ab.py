"""Kernel B's sampling step and kernel T at full width, and the cells that
run them, in one checkout: for before/after comparisons on one card.

Run on a machine with one NVIDIA card, from the root of a checkout:

    python3 lightgbm_tpu_torch/tools/step_ab.py [--root DIR] [--cells
        [--reps K]] [--no-kernels]

``--root`` imports ``lightgbm_tpu_torch`` and ``chip_smoke`` from the
checkout at DIR (build each checkout's kernels into a directory of its own
with ``LTT_BUILD_DIR``), so that two trees are compared in one call, in
turns (parent, change, change, parent).  Every call goes through what the
trainer calls, so either tree's internals are timed as they are: GOSS's
and MVS's step through the boosters' ``_sample_weights`` (the threshold
and the draw of a tree's head), bagging through ``sample.bag_weights``,
kernel T through ``route.route_rows``.

At 10.5M rows, on |g * h| of two kinds ("continuous": |N(0,1) x U(0,
0.25)|; "ties": 40 values / 64, chip_smoke.py's phase-2 input): GOSS's
step (top_rate 0.2, other_rate 0.1), MVS's (fraction 0.6) and bagging's
draw (0.7).  Each: ms a call by CUDA events over back-to-back calls, and
device ms by kernel from ``torch.profiler`` (the select, the scores, the
sort, the scan, the draw, ...).  The sorts that give MVS's scores'
ascending values, each call twice in turn.  Kernel T at 1024, 65536,
500k and 10.5M rows x 28 with 255 leaves on chip_smoke.py's random
records, the same two ways.  ``--cells``: seconds an iteration of the
sampled cells (goss255, exact255 with bagging, wave255 without c2f with
MVS; graphed and ``fused_iters=5``) and the three paths with the 500k
holdout as a validation set, as chip_smoke.py's phases 9 and 7 run them,
``--reps`` times each (the median over their pooled iterations).  The
JSON is the last line of standard output.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

N = 10_500_000


def _device_ms(torch, fn, reps):
    """{kernel name (first 40 characters): device ms a call} from one
    profiler window of ``reps`` calls after a warm-up and 20 ms."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(0.02)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        k = e.name[:40]
        out[k] = out.get(k, 0.0) + (e.time_range.end -
                                    e.time_range.start) / 1e3 / reps
    return out


def _time(torch, cs, fn, reps=20):
    ms = cs.cuda_ms(fn, reps=reps)
    dev = _device_ms(torch, fn, reps)
    return {"ms": ms, "device_ms": sum(dev.values()), "kernels": dev}


def kernels_part(torch, cs, tr, ts):
    from types import SimpleNamespace
    from lightgbm_tpu_torch.models.boosting import GOSS, MVS
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    words = torch.randint(0, 2 ** 31, (4,), generator=g, device=dev,
                          dtype=torch.int64)
    inputs = {
        "continuous": (torch.randn(N, generator=g, device=dev) *
                       torch.rand(N, generator=g, device=dev) * 0.25).abs(),
        "ties": torch.randint(0, 40, (N,), generator=g,
                              device=dev).float() / 64,
    }
    ones = torch.ones(N, device=dev)
    # the boosters' fields that ``_sample_weights`` reads
    booster = SimpleNamespace(num_data=N, config=SimpleNamespace(
        top_rate=0.2, other_rate=0.1, var_weight=1e-6,
        bagging_fraction=0.6))
    res = {}
    for kind, gh in inputs.items():
        res[f"goss_{kind}"] = _time(torch, cs, lambda: GOSS._sample_weights(
            booster, words, gh, ones))
        res[f"mvs_{kind}"] = _time(torch, cs, lambda: MVS._sample_weights(
            booster, words, gh, ones))
    res["bag"] = _time(torch, cs, lambda: ts.bag_weights(words, N, 0.7, 1.0,
                                                         1.0))
    s = ts.mvs_scores(inputs["continuous"], 1e-6)
    sorts = {
        "sort": lambda: torch.sort(s).values,
        "sort_stable": lambda: torch.sort(s, stable=True).values,
        "sort_int32_view": lambda: torch.sort(
            s.view(torch.int32)).values.view(torch.float32),
        "msort": lambda: torch.msort(s),
    }
    want = sorts["sort"]()
    for name in list(sorts) + list(sorts)[::-1]:
        fn = sorts[name]
        if not torch.equal(fn().view(torch.int32), want.view(torch.int32)):
            res[name] = "other values"
            continue
        res.setdefault(name, []).append(_time(torch, cs, fn, reps=10))
    del s, want, inputs, ones
    torch.cuda.empty_cache()
    for n in (1024, 65536, cs.N_HOLDOUT, N):
        rec = cs.route_records(torch, dev, 255, 256, cs.N_FEATURES, 300,
                               n_bins=255)
        xt = cs.route_bins(torch, dev, cs.N_FEATURES, n, 255, 301)
        out = torch.empty(n, dtype=torch.uint8, device=dev)
        want = tr.route_rows_plain(xt, *rec, 255, out=torch.empty_like(out))
        call = lambda: tr.route_rows(xt, *rec, 255, out=out)   # noqa: E731
        call()
        if not torch.equal(out, want):
            raise SystemExit("step_ab: kernel T differs from its plain "
                             "version")
        res[f"route_{n}"] = _time(torch, cs, call)
        del xt, out, want
        torch.cuda.empty_cache()
    return res


def cells_part(torch, cs, ltt, reps):
    X, y = cs.make_higgs_shaped(cs.N_ROWS + cs.N_HOLDOUT, cs.N_FEATURES,
                                seed=0)
    Xh, yh = X[cs.N_ROWS:], y[cs.N_ROWS:]
    X, y = X[:cs.N_ROWS], y[:cs.N_ROWS]
    ds = ltt.Dataset(X, label=y, params=dict(
        cs.TRAIN_PARAMS, device_type="cuda")).construct()
    runs = {}
    for _ in range(reps):
        for name, (params, _, _, _) in cs.SAMPLED.items():
            p = dict(params, device_type="cuda")
            for mode in ("graphs", "fused"):
                r = cs.run_path(torch, ltt, ds, p, mode)
                runs.setdefault(f"{name}_{mode}", []).extend(r["iter_s"])
                del r
                torch.cuda.empty_cache()
        for path, params in (("exact", cs.TRAIN_PARAMS),
                             ("wave", dict(cs.TRAIN_PARAMS,
                                           **cs.WAVE_PARAMS)),
                             ("c2f", dict(cs.TRAIN_PARAMS,
                                          **cs.WAVE255_PARAMS))):
            p = dict(params, device_type="cuda")
            b, _, _, _, iter_s, _ = cs.run_valid(torch, ltt, ds, Xh, yh, p,
                                                 cs.VALID_TREES[path], path)
            runs.setdefault(f"{path}_valid", []).extend(iter_s)
            del b
            torch.cuda.empty_cache()
    return {k: {"seconds_per_iteration": statistics.median(v), "iter_s": v}
            for k, v in runs.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="import the package and chip_smoke from here")
    ap.add_argument("--cells", action="store_true")
    ap.add_argument("--reps", type=int, default=1,
                    help="runs of each cell (their iterations pooled)")
    ap.add_argument("--no-kernels", action="store_true")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, args.root)
    import torch
    if not torch.cuda.is_available():
        print("step_ab: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import lightgbm_tpu_torch as ltt
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.ops import route as tr
    from lightgbm_tpu_torch.ops import sample as ts
    kernels.load()
    res = {"root": args.root or ".", "card": cs.card_line()}
    if not args.no_kernels:
        res["kernels"] = kernels_part(torch, cs, tr, ts)
    if args.cells:
        res["cells"] = cells_part(torch, cs, ltt, args.reps)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
