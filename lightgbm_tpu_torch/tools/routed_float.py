"""Kernel R's float passes at the chip-smoke wave, on the card.

Run on a machine with one NVIDIA card:

    python3 -m lightgbm_tpu_torch.tools.routed_float
    python3 lightgbm_tpu_torch/tools/routed_float.py --root DIR

``--root`` imports ``lightgbm_tpu_torch`` from the checkout at DIR (build
each checkout's kernels into a directory of its own with
``LTT_BUILD_DIR``), so that two trees can be compared in one run.
At the shape and tables of ``chip_smoke.py``'s kernel R check (10.5M x
28, uint8 bins, W=21 of a 64-lane wave, miss bins, full resolution and
coarse shift 4) and with two kinds of float values, N(0, 1) / U(0.05,
1.05) and binary-logloss p - y / p(1 - p) at logits up to +-16
("wide": hessians down to about 1e-7), it reports for each:

- ``*_rel``: the largest relative difference from the plain version;
- ``*_other_bits``: of 10 repeat launches, how many gave other bits
  than the first;
- ``*_ms``: milliseconds a call, 10 calls back to back between one
  CUDA event pair after a warm-up;

and the two-column int8 pass at W=64 (``*_int8_ms``) beside them.  The
JSON is the last line of standard output.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="import lightgbm_tpu_torch from this checkout")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, args.root)
    import torch
    if not torch.cuda.is_available():
        print("routed_float: no CUDA card", file=sys.stderr)
        return 1
    from lightgbm_tpu_torch.ops import histogram as th

    dev = "cuda"
    F, N, B = 28, 10_500_000, 256
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
    ones = torch.ones(N, device=dev)
    narrow = torch.stack([torch.randn(N, generator=g, device=dev),
                          torch.rand(N, generator=g, device=dev) + 0.05,
                          ones], -1).contiguous()
    prob = torch.sigmoid((torch.rand(N, generator=g, device=dev) * 2 - 1)
                         * 16)
    y = (torch.rand(N, generator=g, device=dev) < prob).float()
    wide = torch.stack([prob - y, prob * (1 - prob), ones], -1).contiguous()

    def ms(fn, reps=10):
        fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    out = {}
    t21 = tbl[:, :21].contiguous()
    for shift in (0, 4):
        mode = "coarse" if shift else "full"
        nb = (254 >> shift) + 2 if shift else B
        kw = dict(miss_bin=miss, shift=shift)
        for name, v in (("narrow", narrow), ("wide", wide)):
            a = (bins, v, li, t21, nb, 21, False)
            first = th.routed_histogram(*a, **kw)[0]
            plain = th.routed_histogram_plain(*a, **kw)[0]
            diff = (first - plain).abs()
            rel = torch.where(diff == 0, torch.zeros_like(diff),
                              diff / plain.abs().clamp_min(1e-30))
            out[f"{mode}_{name}_rel"] = float(rel.max())
            out[f"{mode}_{name}_other_bits"] = sum(
                not torch.equal(th.routed_histogram(*a, **kw)[0], first)
                for _ in range(10))
            out[f"{mode}_{name}_ms"] = ms(
                lambda: th.routed_histogram(*a, **kw))
        out[f"{mode}_int8_ms"] = ms(lambda: th.routed_histogram(
            bins, qv, li, tbl, nb, 64, True, **kw))
    print(json.dumps({"card": torch.cuda.get_device_name(0), **out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
