"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

The kernels have a plain C interface and are bound with ``ctypes``:
each source compiles with its own ``nvcc`` process, all started
together, into an object for ``sm_90a``; the objects link into one
shared library.  The build runs at first use, never at import (the CPU
tests import every module of the package), into ``build/torch_kernels/``
at the root of the checkout (``LTT_BUILD_DIR`` overrides it).  The
library file is keyed by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads what is already there.

``-fmad=false`` keeps ``nvcc`` from contracting a multiply and an add
into one rounding: the split kernel's gains then match the plain
PyTorch expression bit for bit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

__all__ = ["load", "build_info", "sm_count", "sync_words", "SOURCES",
           "HEADERS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("histogram.cu", "split.cu", "lookup.cu", "multi_hist.cu",
           "routed_hist.cu", "leaf_stats.cu", "window_hist.cu", "sample.cu",
           "route.cu", "rank.cu")
# included by the sources above; part of the library's hash
HEADERS = ("group_hist.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIB: Optional[ctypes.CDLL] = None
_INFO: dict = {}
_SMS: dict = {}
_SYNC: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
_D = ctypes.c_double

_SIGNATURES = {
    "ltt_hist_masked": [_P, _I, _P, _P, _P, _P, _I, _P, _I64, _I, _I, _I,
                        _I, _I64, _I, _P, _P, _P],
    "ltt_hist_active_clusters": [_I, _I, _I],
    "ltt_best_split": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I,
                       _I, _I, _F, _F, _F, _F, _F, _F, _I, _I, _P, _P, _P,
                       _P, _P, _P, _P, _P, _P],
    "ltt_leaf_add": [_P, _I, _P, _I, _P, _I, _I64, _I, _I64, _P],
    "ltt_multi_hist": [_P, _I, _P, _P, _I, _I, _I64, _I, _I, _I, _I, _P,
                       _I, _I, _I64, _I, _P, _P, _P, _P],
    "ltt_multi_active_blocks": [_I, _I, _I, _I],
    "ltt_routed_hist": [_P, _I, _P, _I, _I, _P, _I, _P, _I, _P, _I, _I64,
                        _I, _I, _I, _I, _I, _I, _I, _I64, _P, _P, _P, _P,
                        _P, _P, _P],
    "ltt_routed_active_blocks": [_I, _I, _I, _I],
    "ltt_leaf_stats": [_P, _I, _P, _P, _P, _I64, _I, _I, _I64, _I, _P, _P,
                       _P, _P],
    "ltt_leaf_active_blocks": [_I, _I],
    "ltt_window_hist": [_P, _I, _P, _P, _I, _I, _P, _P, _I64, _I, _I, _I,
                        _I, _I, _I64, _I, _P, _P, _P, _P],
    "ltt_window_active_blocks": [_I, _I, _I, _I],
    "ltt_lanes_window_hist": [_P, _I, _P, _I, _P, _I, _P, _I, _I, _P, _P,
                              _I64, _I, _I, _I, _I, _I, _I64, _I, _P, _P,
                              _P, _P],
    "ltt_lanes_active_blocks": [_I, _I, _I, _I, _I],
    "ltt_sample": [_I, _P, _P, _P, _P, _F, _F, _P, _I64, _I, _P, _P],
    "ltt_goss_select": [_P, _I64, _I64, _P, _I64, _P, _P, _P, _I, _P],
    "ltt_mvs_scores": [_P, _F, _P, _I64, _I, _P],
    "ltt_class_sum": [_P, _I64, _P, _I64, _I, _F, _I, _P, _I64, _I, _P],
    "ltt_mvs_scan": [_P, _I64, _F, _P, _I64, _P],
    "ltt_route": [_P, _I, _I64, _P, _P, _P, _P, _I, _I, _P, _I64, _P, _P,
                  _I, _I, _P],
    "ltt_lambdarank": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                       _D, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
}


def _build_dir() -> Path:
    env = os.environ.get("LTT_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "lightgbm_tpu_torch are built with nvcc at first use "
                       "(set device_type=cpu to run without a card)")


def _build(out: Path) -> str:
    nvcc = _nvcc()
    obj_dir = out.parent / (out.stem + ".obj")
    obj_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in SOURCES:
        obj = obj_dir / (Path(src).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"--- {src}\n{text}")
        if proc.returncode != 0:
            failed.append(src)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = out.with_suffix(".tmp.so")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)
    return log


def load() -> ctypes.CDLL:
    """The kernel library, built on first use.  Raises when it cannot be
    built or loaded; there is no fallback."""
    global _LIB
    if _LIB is not None:
        return _LIB
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update((CSRC / src).read_bytes())
    out = _build_dir() / f"libltt_kernels_{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    built = not out.exists()
    if built:
        out.parent.mkdir(parents=True, exist_ok=True)
        log = _build(out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _INFO.update(path=str(out), built=built,
                 seconds=time.perf_counter() - t0, log=log)
    _LIB = lib
    return lib


def build_info() -> dict:
    """Path, whether this process built it, seconds and the nvcc log
    (with ``-Xptxas -v``: registers, shared memory and spills)."""
    return dict(_INFO)


def sm_count(device) -> int:
    """The card's multiprocessor count, read once per device."""
    import torch
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def sync_words(kernel: str, words: int, device, stream: int):
    """A kernel's sync words for launches on ``stream`` of ``device``:
    ``words`` int32 words, zeroed once, which each launch leaves zero
    again.  Each stream has its own, so launches on two streams cannot mix
    them.  A graph capture makes its stream's words first
    (``ops/graphs.py`` ``prepare``): made inside a capture, their zeroing
    would be captured, not run, and a launch would wait on a counter no
    block sets."""
    import torch
    key = (kernel, torch.device(device).index, stream)
    sync = _SYNC.get(key)
    if sync is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{kernel}'s sync words must be made before "
                               f"a CUDA graph captures its launch")
        sync = _SYNC[key] = torch.zeros(words, dtype=torch.int32,
                                        device=device)
    return sync


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if rc != 0:
        import torch
        name = torch.cuda.get_device_name() if torch.cuda.is_available() \
            else "no device"
        raise RuntimeError(f"{what}: CUDA error {rc} on {name}")
