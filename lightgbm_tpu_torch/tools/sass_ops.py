"""Instruction counts of the port's kernels from their SASS, by pipe.

Run on a machine with the CUDA toolkit, after the kernels are built:

    python3 -m lightgbm_tpu_torch.tools.sass_ops [--source sample.cu]

It runs ``cuobjdump -sass`` on each source's object in the kernel build
(``kernels.load()`` builds it if needed) and counts the static
instructions of every kernel by the pipe that issues them on Hopper, a
sub-partition (one scheduler, 32 lanes) issuing one warp instruction a
clock:

- ``alu``: integer and logic operations (IADD3, LOP3, SHF, LEA, ISETP,
  SEL, PRMT, ...), 16 lanes a sub-partition (64 an SM a clock);
- ``fma``: float multiply-adds and IMAD, 16 lanes (the heavy half) for
  IMAD, 32 for the float ones;
- ``fp64``: float64 adds, multiplies, fused multiply-adds, compares and
  min/max (DADD, DMUL, DFMA, DSETP, DMNMX), 64 lanes an SM a clock on
  the H100 SXM (its 67 TFLOP/s of float64 is 64 FMAs an SM a clock);
- ``mufu``: the special-function unit (MUFU: reciprocals, the float64
  division's first guess), 16 lanes an SM a clock;
- ``mem``: loads, stores, atomics; ``other``: branches, barriers, moves.

``draws`` is the number of Threefry draws in the kernel's code (20 funnel-shift
rotations, SHF.L.W, a draw), so that a per-draw count is a kernel's counts over
it.  ``loop`` holds the same counts over the body of the kernel's outermost
loop (from the target of its first backward branch to that branch): what a step
of a grid-stride loop issues, without the prologue.  ``fp64_loop`` holds them
over the innermost loop (one with no other loop inside its range) that issues
the most float64 instructions (kernel U's pair loop, one pair of documents a
step: its version with the ``lambdamart_norm`` division and ``exp``, where the
compiler keeps several), and ``fp64_loops`` every innermost loop that issues
float64 instructions, in code order (kernel U's versions of its pair loop: with
and without masks, with ``p`` factored or direct).  The counts are static: a
slow path inside the range (a division's, an ``exp``'s special cases) counts as
if it ran.  The JSON is the last line of standard output.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ALU = {"IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "LEA", "ISETP",
       "SEL", "PRMT", "IMNMX", "IABS", "FLO", "POPC", "BMSK", "BREV",
       "SGXT", "PLOP3", "P2R", "R2P", "FSETP", "FSEL", "FMNMX", "VIADD",
       "VIMNMX", "I2FP", "F2FP"}
FMA = {"FFMA", "FADD", "FMUL", "IMAD", "IMUL", "HFMA2", "HADD2", "HMUL2"}
FP64 = {"DADD", "DMUL", "DFMA", "DSETP", "DMNMX"}
MEM = {"LDG", "STG", "LDS", "STS", "LD", "ST", "LDC", "ATOM", "ATOMS",
       "ATOMG", "RED", "LDSM", "ULDC"}
_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)(.*)")
_LABEL = re.compile(r"^\s*\.(L_x_\d+):")
_TARGET = re.compile(r"`\(\.(L_x_\d+)\)|\b(0x[0-9a-f]+)\b")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "cuobjdump"
    if cand.exists():
        return str(cand)
    raise RuntimeError("cuobjdump not found")


def _classes(ops) -> dict:
    c = {"alu": 0, "fma": 0, "imad": 0, "fp64": 0, "mufu": 0, "mem": 0,
         "other": 0, "total": 0, "rotations": 0, "opcodes": {}}
    for op in ops:
        base = op.split(".")[0]
        c["total"] += 1
        c["opcodes"][base] = c["opcodes"].get(base, 0) + 1
        if base in ALU:
            c["alu"] += 1
        elif base in FMA:
            c["fma"] += 1
            if base in ("IMAD", "IMUL"):
                c["imad"] += 1
        elif base in FP64:
            c["fp64"] += 1
        elif base == "MUFU":
            c["mufu"] += 1
        elif base in MEM:
            c["mem"] += 1
        else:
            c["other"] += 1
        if base == "SHF" and ".W" in op:
            c["rotations"] += 1
    c["draws"] = c["rotations"] / 20
    return c


def count(sass: str) -> dict:
    """{kernel: counts (``alu``, ``fma``, ``imad``, ``mem``, ``other``,
    ``total``, ``draws``, ``opcodes``), with ``loop``: the same over the
    outermost loop's body} from ``cuobjdump -sass`` text."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), {"insns": [], "labels": {}})
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            cur["labels"][m.group(1)] = len(cur["insns"])
            continue
        m = _INSN.search(line)
        if m and m.group(2).split(".")[0] != "NOP":
            cur["insns"].append((int(m.group(1), 16), m.group(2),
                                 m.group(3)))
    out = {}
    for name, f in funcs.items():
        insns = f["insns"]
        at = {addr: i for i, (addr, _, _) in enumerate(insns)}
        loop, loops = None, []
        for i, (_, op, rest) in enumerate(insns):
            if not op.startswith("BRA"):
                continue
            m = _TARGET.search(rest)
            if not m:
                continue
            j = f["labels"].get(m.group(1)) if m.group(1) else \
                at.get(int(m.group(2), 16))
            if j is not None and j <= i:
                loops.append((j, i))
                if loop is None or j < loop[0]:
                    loop = (j, i)

        def over(lo, hi):
            return _classes(op for _, op, _ in insns[lo:hi + 1])
        c = _classes(op for _, op, _ in insns)
        c["loop"] = None if loop is None else over(*loop)
        c["fp64_loop"] = None
        # innermost loops: no other loop's range inside theirs
        inner = [r for r in loops if not any(
            o != r and r[0] <= o[0] and o[1] <= r[1] for o in loops)]
        best = max(inner, default=None, key=lambda r: over(*r)["fp64"])
        if best is not None and over(*best)["fp64"]:
            c["fp64_loop"] = over(*best)
        # every innermost loop that issues float64, in code order
        c["fp64_loops"] = [x for x in (over(*r) for r in sorted(inner))
                           if x["fp64"]]
        out[name] = c
    return out


def kernel_counts(source: str, raw: str = None) -> dict:
    """The counts of every kernel in ``csrc/<source>``'s object (its SASS
    written to the file ``raw`` if given)."""
    from lightgbm_tpu_torch.ops import kernels
    kernels.load()
    so = Path(kernels.build_info()["path"])
    obj = so.parent / (so.stem + ".obj") / (Path(source).stem + ".o")
    sass = subprocess.run([_cuobjdump(), "-sass", str(obj)],
                          capture_output=True, text=True, check=True).stdout
    if raw:
        Path(raw).write_text(sass)
    return count(sass)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default="sample.cu")
    ap.add_argument("--sass", default=None, help="write the SASS here")
    args = ap.parse_args(argv)
    res = kernel_counts(args.source, args.sass)
    for name, c in res.items():
        lp = c["loop"] or {}
        print(f"{name}: total {c['total']} alu {c['alu']} fma {c['fma']} "
              f"(imad {c['imad']}) mem {c['mem']} other {c['other']} "
              f"draws {c['draws']:g}; loop total {lp.get('total')} alu "
              f"{lp.get('alu')} imad {lp.get('imad')} draws "
              f"{lp.get('draws')}; fp64 {c['fp64']} mufu {c['mufu']}",
              flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
