"""Kernel U's builds side by side at the MS-LTR shape, on the card.

Run on a machine with one NVIDIA card, from the root of a checkout:

    python3 -m lightgbm_tpu_torch.tools.rank_ab [VARIANT.cu ...]

Each ``VARIANT.cu`` is an edited copy of ``csrc/rank.cu`` with the same C
interface (``ltt_lambdarank``); it is built with the checkout's ``nvcc``
flags into a library beside it.  At ``chip_smoke.py``'s MS-LTR shape
(9,999 queries of 227 documents, bench.py's labels, its trained-like
score) it reports, for the checkout's kernel and each variant:

- whether the variant's gradients and hessians are the checkout's bits;
- ``ms``: a call's milliseconds, 20 calls back to back between one CUDA
  event pair (``chip_smoke.cuda_ms``), three times in turns (forward,
  backward, forward), so that the card's drift falls on every build;

and, for the checkout's kernel, each version of its pair loop from the
SASS (``tools/sass_ops.py``'s ``fp64_loops``: masked or not, ``p``
factored or direct): its instructions, float64 and MUFU counts and
opcodes.  The JSON is the last line of standard output.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", help="edited copies of rank.cu")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from lightgbm_tpu_torch.objectives import default_label_gain
    from lightgbm_tpu_torch.ops import kernels
    from lightgbm_tpu_torch.ops import rank as tr
    from lightgbm_tpu_torch.tools import sass_ops
    if not torch.cuda.is_available():
        raise SystemExit("rank_ab needs an NVIDIA card")
    kernels.load()
    loops = [{k: c[k] for k in ("total", "fp64", "mufu", "opcodes")}
             for name, v in sass_ops.kernel_counts("rank.cu").items()
             if "lambda_kernel" in name for c in v["fp64_loops"]]
    dev = torch.device("cuda")
    X, y, counts, _, _, _ = cs.make_msltr(cs.RANK_QUERIES, cs.RANK_DOCS, 2)
    n = len(y)
    qb = np.concatenate([[0], np.cumsum(counts)])
    lay = tr.rank_layout(qb, y, default_label_gain(), 20, dev)
    g = torch.Generator(device=dev).manual_seed(12)
    score = (torch.from_numpy(0.3 * X[:, 0] + 0.15 * X[:, 1]).to(dev) +
             0.05 * torch.randn(n, generator=g, device=dev)).float()
    ref = [t.clone() for t in tr.lambda_gradients(score, lay, None, 1.0,
                                                   True)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    sync = tr.sync_words(dev, stream)
    calls = {"checkout": lambda: tr.lambda_gradients(score, lay, None, 1.0,
                                                     True)}
    same = {}
    for src in args.variants:
        lib = os.path.splitext(src)[0] + ".so"
        b = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared",
                            "-o", lib, src], capture_output=True, text=True)
        if b.returncode != 0:
            raise SystemExit(f"{src} did not build:\n{b.stdout}{b.stderr}")
        fn = ctypes.CDLL(lib).ltt_lambdarank
        fn.argtypes = kernels._SIGNATURES["ltt_lambdarank"]
        fn.restype = ctypes.c_int
        out = [torch.empty(n, dtype=torch.float32, device=dev)
               for _ in range(2)]

        def call(fn=fn, out=out, src=src):
            rc = fn(score.data_ptr(), lay.label.data_ptr(),
                    lay.gain.data_ptr(), lay.perm.data_ptr(),
                    lay.qb.data_ptr(), lay.items.data_ptr(),
                    lay.items.shape[0], lay.qtab.data_ptr(),
                    lay.soff.data_ptr(), lay.band_item.data_ptr(),
                    lay.inv_max.data_ptr(), lay.disc.data_ptr(), None, 2.0,
                    1, lay.n_prep, lay.n_pair, tr.BAND_DOCS, lay.accw, None,
                    sync.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                    stream)
            if rc != 0:
                raise SystemExit(f"{src} did not launch: {rc}")
            return out
        call()
        torch.cuda.synchronize()
        same[src] = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(ref, out))
        calls[src] = call
    ms = {k: [] for k in calls}
    for turn in range(3):
        for k in (list(calls) if turn % 2 == 0 else list(calls)[::-1]):
            ms[k].append(cs.cuda_ms(calls[k], 20))
    res = {"card": cs.card_line(), "ms": ms, "same_bits": same,
           "pair_loops": loops}
    for k, v in ms.items():
        print(f"{k}: {v} ms" + ("" if k == "checkout" else
                                f", the checkout's bits {same[k]}"),
              flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
