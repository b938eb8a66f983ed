"""Kernel S's builds side by side at the paths' shapes, on the card.

Run on a machine with one NVIDIA card, from the root of a checkout:

    python3 -m lightgbm_tpu_torch.tools.split_ab [VARIANT.cu ...]

Each ``VARIANT.cu`` is another version of ``csrc/split.cu`` with the same
C interface (``ltt_best_split``), for example the parent commit's (``git
show PARENT:lightgbm_tpu_torch/csrc/split.cu``); it is built with the
checkout's ``nvcc`` flags into a library beside it and called through the
checkout's wrapper (``ops/split.py`` ``find_best_split``), so every build
gets the same arguments.  At ``chip_smoke.py``'s shapes, W = 2 (the exact
loop's two children of a full-width split) and 2W = 128 (a wave's
children, counts proxy), on finite histograms and on histograms with NaN
cells (``phase_health_kernels``' lanes), it reports for each build:

- whether its records are the checkout's, field for field, NaN for NaN;
- ``device_ms``: a call's device milliseconds from ``torch.profiler`` over
  50 calls (``chip_smoke.profile_calls``), three times in turns
  (forward, backward, forward), so that the card's drift falls on every
  build.

The JSON is the last line of standard output.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help="other versions of split.cu")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.ops import split as ts
    if not torch.cuda.is_available():
        raise SystemExit("split_ab needs an NVIDIA card")
    checkout = kernels.load()
    libs = {"checkout": checkout}
    for src in args.variants:
        so = os.path.splitext(src)[0] + ".so"
        b = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                            "-o", so, src], capture_output=True, text=True)
        if b.returncode != 0:
            raise SystemExit(f"{src} did not build:\n{b.stdout}{b.stderr}")
        fn = ctypes.CDLL(so).ltt_best_split
        fn.argtypes = kernels._SIGNATURES["ltt_best_split"]
        fn.restype = ctypes.c_int
        libs[src] = type("Variant", (), {"ltt_best_split": staticmethod(fn)})

    dev = torch.device("cuda")
    F, N, B = cs.N_FEATURES, cs.N_ROWS, 256
    bins, grad, hess, mask, _, _, _ = cs.hist_inputs(torch, dev, F, N, B,
                                                     1, "float", 3)
    g = torch.Generator(device=dev).manual_seed(5)
    lidx = torch.randint(0, 2, (N,), generator=g, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    two = torch.stack([th.masked_histogram(
        bins, grad, hess, mask, lidx,
        torch.tensor(i, dtype=torch.int32, device=dev), B)
        for i in range(2)]).contiguous()
    qv = torch.stack([
        torch.randint(-120, 121, (N,), generator=g, device=dev,
                      dtype=torch.int32),
        torch.randint(0, 121, (N,), generator=g, device=dev,
                      dtype=torch.int32)], -1).to(torch.int8).contiguous()
    sel = torch.randint(-1, 64, (N,), generator=g, device=dev,
                        dtype=torch.int32)
    ch = th.multi_histogram(bins, qv, sel, B, 64, True)
    wave = (torch.cat([ch, ch.flip(0)]) * 0.01).contiguous()
    del bins, grad, hess, mask, lidx, qv, sel, ch
    nb = torch.full((F,), B - 1, dtype=torch.int32, device=dev)
    mt = torch.zeros(F, dtype=torch.int32, device=dev)
    mt[::4] = 2
    fm = torch.ones(F, dtype=torch.bool, device=dev)
    p2 = ts.SplitParams(max_bin=B, min_data_in_leaf=20,
                        min_sum_hessian_in_leaf=100.0, any_missing=True)
    pw = ts.SplitParams(max_bin=B, min_data_in_leaf=0,
                        min_sum_hessian_in_leaf=100.0, any_missing=True,
                        counts_proxy=True)

    def nan_lanes(h):
        """Lane 0 with a NaN cell in every feature (its parent too), lane
        1 with one NaN cell in feature 3 (its parent finite)."""
        h = h.clone()
        parent = h[:, 0].sum(dim=1).contiguous()
        h[0, :, 5, 0] = float("nan")
        parent[0, 0] = float("nan")
        h[1, 3, 10, 0] = float("nan")
        return h, parent

    shapes = {}
    for name, h, p in (("W=2", two, p2), ("2W=128", wave, pw)):
        shapes[name] = (h, h[:, 0].sum(dim=1).contiguous(), p)
        shapes[name + " NaN"] = nan_lanes(h) + (p,)

    def call(lib, h, parent, p):
        real = kernels.load
        kernels.load = lambda: lib
        try:
            return ts.find_best_split(h, parent, nb, mt, fm, p)
        finally:
            kernels.load = real

    def run(lib, *a):
        return {k: v.clone() for k, v in call(lib, *a).items()}

    def same(a, b):
        for k in a:
            x, y = a[k], b[k]
            if x.dtype.is_floating_point:
                if not torch.equal(torch.isnan(x), torch.isnan(y)) or \
                        not torch.equal(torch.nan_to_num(x),
                                        torch.nan_to_num(y)):
                    return False
            elif not torch.equal(x, y):
                return False
        return True

    out = {"card": cs.card_line(), "builds": {}}
    for build, lib in libs.items():
        out["builds"][build] = {
            name: {"same_record": same(run(lib, *a), run(checkout, *a)),
                   "device_ms": []} for name, a in shapes.items()}
    order = list(libs)
    for turn in (order, order[::-1], order):
        for build in turn:
            for name, a in shapes.items():
                ms, _ = cs.profile_calls(
                    lambda lib=libs[build], a=a: call(lib, *a), 50,
                    ("best_split_kernel",))
                out["builds"][build][name]["device_ms"].append(ms)
    for build in out["builds"].values():
        for row in build.values():
            row["median_device_ms"] = statistics.median(row["device_ms"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
