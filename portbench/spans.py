"""The program's own spans and counters in one traced run of a batch cell:
the frame loop's device time and idle share, the readout's wait, and the
readout's host reads.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on a machine with an NVIDIA card.  It makes
one traced run of the cell (`harness.run_cell` with `--trace 1`), keeps
the profiler's events, which the harness reduces and deletes, and prints
as the last line of standard output one JSON object: the numbers below,
the traced batches' wall against the same batches decoded again with no
profiler (what tracing costs), and the harness's own result line.

The numbers read the program's spans (`cmusphinx_tpu_torch/utils/
profile.span`) and the N-gram search's `host_reads` counter:

- `frame_loop_ms_per_frame.batch`: device busy ms of the intervals
  launched inside `frame_loop` spans (a kernel of a graph replay shares
  its `cudaGraphLaunch`'s correlation id), per padded frame step of the
  traced batches;
- `frame_loop_idle_pct.batch`: the share of the frame loop's device extent
  (its first interval's start to its last's end, each batch) with no
  device work;
- `readout_ms.batch`: per traced batch, from the end of the frame loop's
  last device interval to the end of the `ngram.hyps` span;
- `host_reads_per_batch.batch`: `host_reads` added over the window's
  batches, per batch.

The benchmark does not report them yet: its trace reduction keeps no
launch times and its window no program counters (PERF.md, section 7).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .trace import DEVICE_CATS, LAUNCH_CATS, union_s

FRAME_LOOP = "frame_loop"
HYPS = "ngram.hyps"
SLICE = "portbench.slice"


@dataclass
class Launched:
    """Device intervals with the host time of their launch, and the host
    spans (`user_annotation` events), in seconds."""
    device: List[Tuple[float, float, Optional[float]]] = field(
        default_factory=list)
    spans: List[Tuple[float, float, str]] = field(default_factory=list)

    def named(self, name: str) -> List[Tuple[float, float]]:
        return sorted((a, b) for a, b, n in self.spans if n == name)

    def launched_in(self, t0: float, t1: float) -> List[Tuple[float, float]]:
        """The device intervals launched in [t0, t1]."""
        return [(a, b) for a, b, t in self.device
                if t is not None and t0 <= t <= t1]


def reduce(events: List[dict]) -> Launched:
    """Chrome trace events -> Launched (times in seconds)."""
    launch: Dict[int, float] = {}
    dev = []
    out = Launched()
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"]) * 1e-6
        b = a + float(e["dur"]) * 1e-6
        cat = e.get("cat")
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            dev.append((a, b, corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launch[corr] = a
        elif cat == "user_annotation":
            out.spans.append((a, b, str(e.get("name"))))
    out.device = [(a, b, launch.get(c)) for a, b, c in dev]
    return out


def _loops(tr: Launched) -> List[Tuple[Tuple[float, float], list]]:
    """Each `frame_loop` span inside the traced slice, with the device
    intervals launched in it (spans that launched none left out)."""
    sl = tr.named(SLICE)
    t0, t1 = sl[0] if sl else (float("-inf"), float("inf"))
    out = []
    for a, b in tr.named(FRAME_LOOP):
        if t0 <= a and b <= t1:
            iv = tr.launched_in(a, b)
            if iv:
                out.append(((a, b), iv))
    return out


def frame_loop_ms_per_frame(tr: Launched, steps: int) -> Optional[float]:
    loops = _loops(tr)
    if not loops or steps <= 0:
        return None
    return 1e3 * sum(union_s(iv) for _, iv in loops) / steps


def frame_loop_idle_pct(tr: Launched) -> Optional[float]:
    loops = _loops(tr)
    extent = busy = 0.0
    for _, iv in loops:
        e0, e1 = min(a for a, _ in iv), max(b for _, b in iv)
        extent += e1 - e0
        busy += union_s([(max(a, e0), min(b, e1)) for a, b, _ in tr.device
                         if b > e0 and a < e1])
    if extent <= 0:
        return None
    return 100.0 * (1.0 - busy / extent)


def readout_ms(tr: Launched) -> Optional[float]:
    hyps = tr.named(HYPS)
    starts = [a for a, _ in hyps]
    waits = []
    for (a, b), iv in _loops(tr):
        i = bisect.bisect_left(starts, b)
        if i < len(hyps):
            waits.append(hyps[i][1] - max(e for _, e in iv))
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)


def host_reads_per_batch(reads: List[int], batches: int) -> Optional[float]:
    """`reads`: the counter's increase in each decode call, the window's
    calls last."""
    if batches <= 0 or len(reads) < batches:
        return None
    return sum(reads[-batches:]) / batches


# ----------------------------------------------------------------------
class _Watch:
    """Wraps the search's `decode_batch_cep` on the instance: each call's
    `host_reads` increase, and the calls made under the profiler with
    their padded frames and wall."""

    def __init__(self):
        self.search = None
        self.reads: List[int] = []
        self.traced: List[Tuple[list, object, int, float]] = []

    def __call__(self, decoder) -> None:
        import torch

        s = self.search = decoder.search
        inner = s.decode_batch_cep
        counter = s.profile.counter("host_reads")

        def decode(ceps, fp, *a, **k):
            on = torch.autograd._profiler_enabled()
            n0, t0 = counter.count, time.perf_counter()
            out = inner(ceps, fp, *a, **k)
            if on:
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                b = s.FRAME_BUCKET
                steps = -(-max(map(len, ceps)) // b) * b
                self.traced.append((list(ceps), fp, steps, wall))
            self.reads.append(counter.count - n0)
            return out

        s.decode_batch_cep = decode


def measure(bench: str, cell: str, seed: int, seconds: float) -> dict:
    import torch

    from . import harness
    from . import trace as trace_mod

    watch, kept = _Watch(), {}
    load = trace_mod.load

    def keep(path):
        with open(path) as fh:
            data = json.load(fh)
        kept["tr"] = reduce(data["traceEvents"] if isinstance(data, dict)
                            else data)
        return load(path)

    trace_mod.load = keep
    try:
        res = harness.run_cell(bench, cell, seed, seconds, True, patch=watch)
    finally:
        trace_mod.load = load
    tr = kept["tr"]
    batches = res.line["attempted"] // len(watch.traced[0][0])
    steps = sum(t[2] for t in watch.traced)
    out = {"frame_loop_ms_per_frame.batch": frame_loop_ms_per_frame(tr, steps),
           "frame_loop_idle_pct.batch": frame_loop_idle_pct(tr),
           "readout_ms.batch": readout_ms(tr),
           "host_reads_per_batch.batch": host_reads_per_batch(watch.reads,
                                                              batches)}
    # The traced batches again, with no profiler: the cost of tracing.
    s = watch.search
    again = []
    for ceps, fp, _, _ in watch.traced:
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.decode_batch_cep(ceps, fp)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        again.append(min(walls))
    out["traced_wall_s"] = [t[3] for t in watch.traced]
    out["untraced_wall_s"] = again
    out["harness"] = res.line
    return out


def main(argv=None) -> int:
    from . import run  # noqa: F401 (the benchmark's build caches)

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    a = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    print(json.dumps(measure(os.path.join(root, "BENCHMARK.json"),
                             a.workload, a.seed, a.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
