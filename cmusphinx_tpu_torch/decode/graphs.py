"""The block runner: a search's frame loop in blocks of frames, each block
on the card a replay of a captured CUDA graph.

The counterpart of the reference's `jit`-compiled `lax.scan` frame loops
(`ngram_search.py`, `fsg_search.py`, `phone_loop.py`, `align.py`).  A
search hands `BlockRunner.scan` its block function

    block(carry, inputs, t, rows) -> carry

which runs frames t .. t+K-1: `carry` is the search's state (a tuple of
tensors), `inputs` the block's slices of the per-frame inputs (a tuple;
None entries pass through), `t` the first frame index as a 0-d int64
tensor, and `rows` views of the block's K rows of each output tape, which
the block writes.  Nothing in a block may read a device value on the host
or build a tensor from host data: on the card the same function is
recorded once into a `torch.cuda.CUDAGraph` and replayed block after
block, with the inputs and the frame index copied into its buffers.  On
the CPU, or with graphs off, the blocks run eagerly.

A graph is keyed by the shapes and types of the carry, the block's inputs
and its tape rows, so a search whose carry has a fixed shape takes one
graph per block length, whatever the utterance's length.  State that is
the same for every block of a call (the aligner's transition matrix)
rides in the carry: it is copied into a graph once a call and the block
returns it unchanged.

Under a profiler, `scan` is a `frame_loop` span (`utils/profile.span`),
and each capture inside it a `frame_loop.capture` span; a replay has none
of its own.  A search exposes the runner's counters `stats` as its
`graph_stats`.
"""

from __future__ import annotations

import time
from collections import Counter, OrderedDict
from typing import Callable, Iterable, Optional, Sequence

import torch

from ..utils.profile import span

# Captured blocks a search keeps (least recently used dropped first).  16
# holds an N-gram search serving three batch sizes at five side-table
# sizes and a stream; a 20,000-word tree graph holds ~80 MB of the card
# (PERF.md §5).
GRAPH_CACHE = 16


def pad_frames(x: torch.Tensor, n: int) -> torch.Tensor:
    """x [T, ...] with zero rows appended to n frames: a search pads its
    per-frame inputs to whole blocks (or its bucket) and masks the padded
    frames, so that every length replays the same graphs."""
    T = x.shape[0]
    return torch.cat([x, x.new_zeros((n - T,) + x.shape[1:])]) if n > T \
        else x


class BlockGraph:
    """One block captured as a CUDA graph, with the static buffers it reads
    and writes, all its own: the carry, the block's inputs, the first frame
    index `t` and the block's K tape rows.  Its intermediates live in the
    runner's shared pool.  `counts` is what one block adds to the runner's
    host counters (which a replay does not run), recorded at capture."""

    def __init__(self, runner: "BlockRunner", block: Callable, carry,
                 inputs, t0: int, rows):
        self.carry = tuple(c.clone() for c in carry)
        self.inputs = tuple(None if x is None else x.clone() for x in inputs)
        dev = self.carry[0].device
        self.t = torch.full((), t0, dtype=torch.int64, device=dev)
        self.rows = tuple(r.new_empty(r.shape) for r in rows)
        before = [Counter(c) for c in runner.counters]
        # Warm up once on a side stream (torch.cuda.graph's rule), on the
        # caller's values: the warm-up runs the kernels for real, so
        # payloads that index must be real ones.
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._run(block)
        torch.cuda.current_stream(dev).wait_stream(side)
        warm = [Counter(c) for c in runner.counters]
        # A host read inside the block fails the capture, and the error
        # propagates: there is no eager fallback.  Thread-local capture
        # lets other threads (NCCL's watchdog) query the card meanwhile.
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=runner.pool,
                              capture_error_mode="thread_local"):
            self._run(block)
        self.counts = [c - w for c, w in zip(runner.counters, warm)]
        for c, b in zip(runner.counters, before):
            c.clear()
            c.update(b)

    def _run(self, block: Callable) -> None:
        out = block(self.carry, self.inputs, self.t, self.rows)
        for a, b in zip(self.carry, out):
            if b is not a:
                a.copy_(b)

    def replay(self, runner: "BlockRunner", inputs, t0: int) -> None:
        for dst, src in zip(self.inputs, inputs):
            if src is not None:
                dst.copy_(src)
        self.t.fill_(t0)
        self.graph.replay()
        for c, n in zip(runner.counters, self.counts):
            c.update(n)


class BlockRunner:
    """A search's frame loop in blocks (`scan`), and its captured graphs:
    one memory pool, at most GRAPH_CACHE graphs, and the counters
    `stats` (captures, their seconds, replays).  `axis` is the frame axis
    of the per-frame inputs and of the tapes; `counters` are host
    `Counter`s that a block updates (the N-gram search's LM calls): a
    capture records one block's updates and each replay adds them.
    `graphs = False` runs the blocks eagerly on the card too, to compare
    the two."""

    def __init__(self, axis: int = 0, counters: Iterable[Counter] = ()):
        self.graphs = True
        self.axis = axis
        self.counters = tuple(counters)
        self.cache: OrderedDict = OrderedDict()
        self.pool = None
        self.stats = {"captures": 0, "capture_s": 0.0, "replays": 0}

    def release(self) -> None:
        """Drop every captured graph and the pool."""
        self.cache.clear()
        self.pool = None

    def scan(self, block: Callable, carry: tuple, inputs: Sequence,
             tape: Sequence[torch.Tensor], t0: int, K: int,
             row0: Optional[int] = None) -> tuple:
        """Frames t0 .. t0+n-1 (n: the inputs' length along `axis`) in
        blocks of K frames (the last one shorter where K does not divide
        n); each block writes its rows of the tape, from row `row0`
        (default t0).  Returns the carry.  With `graphs` on and the inputs
        on the card, each block is a replay of a captured graph
        (`_graphed`); else it runs eagerly, writing views of the tape."""
        with span("frame_loop"):
            ax = self.axis
            x0 = next(x for x in inputs if x is not None)
            n = x0.shape[ax]
            row0 = t0 if row0 is None else row0
            if n == 0:
                return carry
            if self.graphs and x0.is_cuda:
                return self._graphed(block, carry, inputs, tape, t0, K,
                                     row0, n)
            dev = carry[0].device
            for k0 in range(0, n, K):
                m = min(K, n - k0)
                t = torch.full((), t0 + k0, dtype=torch.int64, device=dev)
                carry = block(carry, self._slice(inputs, k0, m), t,
                              tuple(a.narrow(ax, row0 + k0, m)
                                    for a in tape))
            return carry

    def _slice(self, inputs, k0: int, m: int) -> tuple:
        return tuple(None if x is None else x.narrow(self.axis, k0, m)
                     for x in inputs)

    def _graphed(self, block, carry, inputs, tape, t0, K, row0, n) -> tuple:
        """`scan` through captured blocks.  The carry goes into the block's
        graph once, stays in its buffers from replay to replay, and comes
        out as a copy; after each replay the graph's K tape rows are copied
        into the caller's tape.  Neither the returned carry nor the tape
        shares memory with the graph, so calls and interleaved streams do
        not disturb one another."""
        ax = self.axis
        cur = None
        with torch.cuda.device(carry[0].device), torch.inference_mode():
            for k0 in range(0, n, K):
                m = min(K, n - k0)
                blk = self._slice(inputs, k0, m)
                rows = tuple(a.narrow(ax, row0 + k0, m) for a in tape)
                g = self._graph(block, carry, blk, t0 + k0, rows)
                if g is not cur:
                    if cur is not None:
                        carry = cur.carry
                    for a, b in zip(g.carry, carry):
                        a.copy_(b)
                    cur = g
                g.replay(self, blk, t0 + k0)
                self.stats["replays"] += 1
                for a, b in zip(rows, g.rows):
                    a.copy_(b)
            return tuple(c.clone() for c in cur.carry)

    def _graph(self, block, carry, blk, t0: int, rows) -> BlockGraph:
        """The captured block for these shapes, captured now on these
        values if the cache has none.  A search's graphs share one memory
        pool: they replay one at a time, and each keeps what outlives a
        replay in buffers of its own."""
        key = tuple(None if x is None else (tuple(x.shape), x.dtype)
                    for x in (*carry, *blk, *rows))
        g = self.cache.pop(key, None)
        if g is None:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            t_start = time.perf_counter()
            with span("frame_loop.capture"):
                g = BlockGraph(self, block, carry, blk, t0, rows)
            self.stats["captures"] += 1
            self.stats["capture_s"] += time.perf_counter() - t_start
            while len(self.cache) >= GRAPH_CACHE:
                self.cache.popitem(last=False)
        self.cache[key] = g
        return g
