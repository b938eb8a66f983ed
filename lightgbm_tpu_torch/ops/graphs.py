"""CUDA graphs of a tree: the port's counterpart of the JAX package's jit
boundary.

The JAX package compiles a tree's growth into one dispatch
(``build_tree``), and K trees into one under ``fused_iters``.  The port
launches its kernels from Python: an exact tree at the Higgs shape makes
about 21,700 launches and a wave about 100, so the host, not the card,
set the pace.  Here each phase of a tree (``ops/grow.py``) is captured
once as a ``torch.cuda.CUDAGraph`` and replayed for every later tree:

- the exact (non-speculative) loop: one graph, the whole tree;
- the wave loops: ``head`` (gradients, quantization, the root, the first
  wave's flags), ``body`` (one wave after its flag read; under
  coarse-to-fine also ``body_wide``, the variant with more than W/2 live
  lanes, chosen from the flag read) and ``tail`` (leaf values, the
  renewal, the score add and the packed records).  A wave costs one flag
  read and one replay.

:class:`TreeRunner` runs a booster's first tree eagerly, the warm-up that
builds the kernels and asks the card for their launch plans, and
captures its graphs at the second, after :func:`prepare`.  A validation
set's scorer (:class:`ValidScorer`: kernel T routing its rows through the
tree's records, then kernel L's float64 add) is one more graph, captured
into the same pool the first time it runs after the tree's graphs exist.
On the CPU, or when asked, it launches every phase eagerly; the graphs
replay the same launches, so the trees are the same bits.  A failed capture or
replay raises: nothing falls back to eager launches.

Launch counters: the wrappers count a launch where they enqueue it, so a
capture would count its kernels once and a replay not at all.
:class:`Graph` takes back what its capture counted and adds it again at
every replay, so the counters keep meaning kernel launches executed;
``REPLAYS`` counts the replays.
"""
from __future__ import annotations

import gc
import time

import torch

from . import histogram, kernels, lookup, rank, route, sample, split
from .grow import GrowState, serial_steps, wave_body, wave_loop
from .route import route_rows

__all__ = ["Graph", "TreeRunner", "ValidScorer", "prepare", "REPLAYS"]

LAUNCH_COUNTERS = (histogram.LAUNCHES, split.LAUNCHES, lookup.LAUNCHES,
                   sample.LAUNCHES, sample.STEP_LAUNCHES, route.LAUNCHES,
                   rank.LAUNCHES)
REPLAYS = {"graph_replays": 0}


def _counts() -> list:
    return [dict(c) for c in LAUNCH_COUNTERS]


class Graph:
    """``fn`` captured once on ``stream`` into a memory pool shared with
    ``pool``'s other graphs; :meth:`replay` runs it on the current stream.
    ``launches`` holds the kernel launches of the capture, by counter;
    ``capture_s`` the host time of tracing ``fn``, ``instantiate_s`` that
    of ending the capture (instantiating the graph)."""

    def __init__(self, fn, stream: torch.cuda.Stream, pool):
        before = _counts()
        self.graph = torch.cuda.CUDAGraph()
        # Python's cycle collector must not run inside a capture: a booster
        # it collects frees pinned host buffers, and the host allocator's
        # event calls on another stream can invalidate the capture
        gc.collect()
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            t0 = time.perf_counter()
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                fn()
                t1 = time.perf_counter()
            self.instantiate_s = time.perf_counter() - t1
            self.capture_s = t1 - t0
        finally:
            if gc_was_on:
                gc.enable()
            after = _counts()
            for counter, b in zip(LAUNCH_COUNTERS, before):
                counter.update(b)
        self.launches = [{k: a[k] - b[k] for k in a if a[k] != b[k]}
                         for a, b in zip(after, before)]

    def replay(self) -> None:
        self.graph.replay()
        for counter, add in zip(LAUNCH_COUNTERS, self.launches):
            for k, v in add.items():
                counter[k] += v
        REPLAYS["graph_replays"] += 1

    def kernel_launches(self) -> int:
        return sum(sum(d.values()) for d in self.launches)


def prepare(st: GrowState, stream: torch.cuda.Stream) -> None:
    """What a capture must not do for the first time: build or load the
    kernels, read the card's SM count, ask the card for the launch plans
    the phases need that the warm-up tree may not have asked for (kernel
    H's active clusters on the exact loop, kernel V-lanes' blocks an SM at
    both widths of a coarse-to-fine wave) and make kernel S's completion
    counters and kernels T's and U's sync words for the capture stream."""
    dev = st.xt.device
    p = st.params
    kernels.load()
    kernels.sm_count(dev)
    split.done_counters(1, dev, stream.cuda_stream)
    route.sync_words(dev, stream.cuda_stream)
    rank.sync_words(dev, stream.cuda_stream)
    if not st.wave:
        histogram.masked_histogram_plan(st.xt, st.leaf_idx, p.split.max_bin)
    elif p.refine_shift:
        for width in (st.width, 2 * st.width):
            histogram.lanes_window_plan(st.xt, st.leaf_idx, st.kvals, st.R,
                                        width, p.two_col, st.leaf_bound)


class TreeRunner:
    """Runs a booster's trees over its :class:`GrowState`.

    ``head(k)`` computes class k's gradients and runs ``grow.tree_head``;
    ``tail(k)`` runs ``grow.tree_tail`` and whatever the booster does with
    the tree on the device (the score add into class k's row, the packed
    records).  With ``graphs`` (CUDA tensors only) the first tree runs
    eagerly and the second captures the phases of every class, which
    every later tree replays.
    ``flag_reads`` counts the wave loop's host reads, ``info`` describes
    the capture (graphs, their kernel launches, host seconds, the pool's
    memory)."""

    def __init__(self, st: GrowState, head, tail, graphs: bool,
                 classes: int = 1):
        if graphs and st.xt.device.type != "cuda":
            raise ValueError("CUDA graphs need CUDA tensors")
        self.st = st
        self.use_graphs = graphs
        # one head and tail (the whole tree on the exact loop) a class of
        # a multiclass booster, each reading its class's row: the phases
        # of class k carry the suffix k, a single class none
        self.suffix = [""] if classes == 1 else \
            [str(k) for k in range(classes)]
        self.phases = {}
        for k, sfx in enumerate(self.suffix):
            if st.wave:
                self.phases["head" + sfx] = lambda k=k: head(k)
            else:
                def tree(k=k):
                    head(k)
                    serial_steps(st)
                    tail(k)
                self.phases["tree" + sfx] = tree
        if st.wave:
            self.phases["body"] = lambda: wave_body(st, False)
            if st.params.refine_shift:
                self.phases["body_wide"] = lambda: wave_body(st, True)
            for k, sfx in enumerate(self.suffix):
                self.phases["tail" + sfx] = lambda k=k: tail(k)
        self.graphs = None
        self.stream = self.pool = None
        self.trees = 0
        self.flag_reads = 0
        self.info = None

    def _run(self, name: str) -> None:
        if self.graphs is None:
            self.phases[name]()
        else:
            self.graphs[name].replay()

    def run(self, k: int = 0) -> int:
        """One tree (class ``k``'s) -> its number of waves (0 on the
        exact loop)."""
        if self.use_graphs and self.graphs is None and self.trees:
            self.capture()
        self.trees += 1
        sfx = self.suffix[k]
        if not self.st.wave:
            self._run("tree" + sfx)
            return 0
        self._run("head" + sfx)
        waves = wave_loop(self.st, lambda wide: self._run(
            "body_wide" if wide else "body"))
        self._run("tail" + sfx)
        self.flag_reads += waves + 1
        return waves

    def capture(self) -> None:
        """Capture every phase on a side stream into one memory pool."""
        dev = self.st.xt.device
        stream = torch.cuda.Stream(dev)
        prepare(self.st, stream)
        # collect dead cycles now, so the memory they free is not counted
        # against the pool (each Graph collects again before capturing)
        gc.collect()
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        pool = torch.cuda.graph_pool_handle()
        graphs = {name: Graph(fn, stream, pool)
                  for name, fn in self.phases.items()}
        self.stream, self.pool = stream, pool
        torch.cuda.empty_cache()
        self.info = {
            "graphs": {name: g.kernel_launches()
                       for name, g in graphs.items()},
            "capture_s": sum(g.capture_s for g in graphs.values()),
            "instantiate_s": sum(g.instantiate_s for g in graphs.values()),
            "pool_bytes": torch.cuda.memory_reserved(dev) - reserved,
        }
        self.graphs = graphs


class ValidScorer:
    """A validation set's score update after each tree: the rows of ``xt``
    (F, N) routed through the split records in ``st`` (``route_rows``:
    kernel T on the card) into the static leaf-id buffer ``li`` (uint8 up
    to 256 leaves, else int32; (K, N) for K classes, class k's tree routed
    into row k, each row 16-byte aligned), then ``score += vals[li]``
    (``score`` (N,) float64, or (K, N) with class k's tree added into row
    k; ``vals`` the booster's shrunken float32 leaf values: kernel L's
    float64 mode on the card).  With ``vals=None`` it only routes: the
    booster adds the host trees' values once an iteration lands (DART,
    random forests, leaf renewal), from each class's row of ``li``
    (:meth:`leaf_ids`).  With ``bundles`` (``io/bundle.py`` ``BundleMaps``)
    ``xt`` is the (G, N) bundle matrix, and the records' features and left
    masks are translated onto bundle columns and bins before the route
    (``lightgbm_tpu/ops/grow.py:1850-1860``), inside the graph.  It reads
    only device buffers, so it runs eagerly until ``runner`` holds its tree
    graphs and from then on as replays of one graph a class."""

    def __init__(self, st: GrowState, xt: torch.Tensor, vals, score,
                 bundles=None):
        self.st, self.xt, self.vals, self.score = st, xt, vals, score
        self.bundles = bundles
        n = xt.shape[1]
        if score.dim() == 1:
            self.li = torch.zeros(n, dtype=st.li_dtype, device=xt.device)
        else:
            size = torch.empty((), dtype=st.li_dtype).element_size()
            n16 = -(-n * size // 16) * 16 // size
            self.li = torch.zeros((score.shape[0], n16), dtype=st.li_dtype,
                                  device=xt.device)[:, :n]
        self.graphs = {}

    def leaf_ids(self, k: int = 0) -> torch.Tensor:
        """Class k's leaf ids of the last tree routed for it."""
        return self.li if self.li.dim() == 1 else self.li[k]

    @property
    def graph(self):
        """Class 0's graph (the only one of a single-class booster)."""
        return self.graphs.get(0)

    def _score(self, k: int = 0) -> None:
        rec = self.st.rec
        li = self.leaf_ids(k)
        feature, left_mask = rec["feature"], rec["left_mask"]
        if self.bundles is not None:
            feature, left_mask = self.bundles.translate(feature, left_mask)
        route_rows(self.xt, rec["leaf"], feature, left_mask, rec["valid"],
                   self.st.params.num_leaves, out=li)
        if self.vals is not None:
            row = self.score if self.score.dim() == 1 else self.score[k]
            lookup.take_small_add(row, self.vals, li)

    def run(self, runner: TreeRunner, k: int = 0) -> None:
        if runner.graphs is None:
            self._score(k)
            return
        if k not in self.graphs:
            self.graphs[k] = Graph(lambda: self._score(k), runner.stream,
                                   runner.pool)
        self.graphs[k].replay()
