"""Whether two builds of a kernel source compile to the same instructions.

Run on a machine with the CUDA toolkit:

    python3 -m lightgbm_tpu_torch.tools.sass_same OTHER.cu \\
        --source split.cu --kernel best_split_kernel --instance ILi0ELi0E \\
        [--other-instance ILi0ELi0E]

It compiles ``csrc/SOURCE`` of the checkout and ``OTHER.cu`` (another
version of it, for example the parent commit's, ``git show
PARENT:lightgbm_tpu_torch/csrc/split.cu``) to cubins with the kernels'
flags (``ops/kernels.py``), dumps their SASS with ``cuobjdump -sass`` and
compares the instruction sequences of the functions whose names hold
``--kernel`` (and, in the checkout's build, ``--instance``: one template
instance; in the other build ``--other-instance``, where it holds several),
without addresses, encodings, branch-target labels or the
offsets of the kernel's parameters in constant bank 0 (a parameter added
to the signature moves the ones after it).  The JSON on the last line of
standard output names the functions, their instruction counts, whether
the sequences are the same, and the first difference.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from ..ops.kernels import CSRC, NVCC_FLAGS, _nvcc
from .sass_ops import _cuobjdump

_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def _sass(nvcc: str, src: Path, out: Path) -> dict:
    """{function name: [instruction text]} of ``src``'s cubin."""
    flags = [f for f in NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    subprocess.run([nvcc, *flags, "-cubin", str(src), "-o", str(out)],
                   check=True, capture_output=True, text=True)
    dump = subprocess.run([_cuobjdump(), "-sass", str(out)], check=True,
                          capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for line in dump.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            # branch targets differ by where the function lies, parameter
            # offsets by the signature
            insn = re.sub(r"`\(\.L_x_\d+\)", "LABEL", m.group(1))
            cur.append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "PARAM", insn))
    return funcs


def _pick(funcs: dict, kernel: str, instance: str) -> str:
    names = [n for n in funcs if kernel in n and instance in n]
    if len(names) != 1:
        raise SystemExit(f"{len(names)} functions match {kernel!r} "
                         f"{instance!r}: {sorted(funcs)}")
    return names[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--source", default="split.cu")
    ap.add_argument("--kernel", default="best_split_kernel")
    ap.add_argument("--instance", default="")
    ap.add_argument("--other-instance", default="")
    args = ap.parse_args(argv)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        new = _sass(nvcc, CSRC / args.source, Path(tmp) / "new.cubin")
        old = _sass(nvcc, args.other, Path(tmp) / "old.cubin")
    fn_new = _pick(new, args.kernel, args.instance)
    fn_old = _pick(old, args.kernel, args.other_instance)
    a, b = old[fn_old], new[fn_new]
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 None if len(a) == len(b) else min(len(a), len(b)))
    out = {"other": fn_old, "checkout": fn_new, "instructions_other": len(a),
           "instructions_checkout": len(b), "same": first is None,
           "first_difference": None if first is None else
           {"at": first, "other": a[first] if first < len(a) else None,
            "checkout": b[first] if first < len(b) else None}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
