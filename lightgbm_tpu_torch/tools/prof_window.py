"""How often ``torch.profiler`` returns a window without all its kernels.

Run on a machine with one NVIDIA card:

    python3 -m lightgbm_tpu_torch.tools.prof_window [--windows 200]

At the shape and tables of ``chip_smoke.py``'s kernel R check (10.5M x
28, uint8 bins, a W=64 wave of two-column int8 values, full resolution),
it profiles ``--windows`` windows of 10 kernel R calls (3 CUDA kernels a
call) in each of two ways, alternating: the calls start as soon as the
profiler has started (``wait_0ms``), or after the host has waited 20 ms
(``wait_20ms``, as ``chip_smoke.py``'s ``profile_calls`` does).  For each
way it reports how many windows held all 30 kernels (``whole``), how many
did not (``short``), and the kernel counts of the short ones.  The JSON
is the last line of standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=200,
                    help="windows profiled in each way")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("prof_window: no CUDA card", file=sys.stderr)
        return 1
    from lightgbm_tpu_torch.ops import histogram as th

    dev = "cuda"
    F, N, B, reps = 28, 10_500_000, 256, 10
    g = torch.Generator(device=dev).manual_seed(3)

    def ints(hi, n):
        return torch.randint(0, hi, (n,), generator=g, device=dev,
                             dtype=torch.int32)

    bins = ints(B - 1, F * N).to(torch.uint8).view(F, N)
    li = ints(127, N).to(torch.uint8)
    ids = torch.randperm(127, generator=g, device=dev)[:64].to(torch.int32)
    ids[60:] = 127                                  # dummy lanes
    miss = torch.full((F,), -1, dtype=torch.int32, device=dev)
    miss[::4] = B - 2
    tbl = torch.stack([ids, ints(F, 64), ints(B - 3, 64),
                       torch.arange(127, 191, device=dev, dtype=torch.int32),
                       ints(2, 64), ints(2, 64)]).contiguous()
    qv = torch.stack([ints(241, N) - 120, ints(121, N)],
                     -1).to(torch.int8).contiguous()

    def call():
        th.routed_histogram(bins, qv, li, tbl, B, 64, True, miss_bin=miss)

    call()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for w in range(2 * args.windows):
        wait = 0.02 * (w % 2)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(wait)
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        n = sum(e.device_type == torch.autograd.DeviceType.CUDA
                for e in prof.events())
        o = out.setdefault(f"wait_{round(wait * 1e3)}ms",
                           {"whole": 0, "short": 0, "short_counts": []})
        if n == 3 * reps:
            o["whole"] += 1
        else:
            o["short"] += 1
            o["short_counts"].append(n)
    smi = card_line()
    print(json.dumps({"card": smi, "kernels_a_window": 3 * reps, **out}))
    return 0


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    import subprocess
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip() or "nvidia-smi unavailable"


if __name__ == "__main__":
    sys.exit(main())
