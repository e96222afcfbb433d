"""Reduction of a profiler trace (Chrome trace JSON, as
`torch.profiler.profile.export_chrome_trace` writes it) to what the
per-layer readers take.

- device work: events of category `kernel`, `gpu_memcpy` and
  `gpu_memset`; the device is busy over the union of their intervals;
- the scorer's kernels: those whose launch (the `cuda_runtime` or
  `cuda_driver` event of the same correlation id) lies inside a
  `portbench.score` span, a `record_function` range the harness opens
  around the search's scorer call;
- host spans: `user_annotation` and `cpu_op` events, which name what the
  host was doing in each idle gap of the device.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

SCORE_SPAN = "portbench.score"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("user_annotation", "cpu_op")


def union_s(iv: List[Tuple[float, float]]) -> float:
    """Length of the union of intervals (seconds)."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(iv):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def merged(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclass
class Trace:
    """Device intervals (seconds) with their names, the scorer's among
    them, and the host spans, of one profiled slice."""
    device: List[Tuple[float, float, str]] = field(default_factory=list)
    score: List[Tuple[float, float]] = field(default_factory=list)
    host: List[Tuple[float, float, str]] = field(default_factory=list)

    def span(self, name: str) -> Tuple[float, float]:
        """(start, end) of the first host span of that name."""
        return next((a, b) for a, b, n in self.host if n == name)

    def busy_s(self, t0: float, t1: float) -> float:
        """Seconds of [t0, t1] in which the device ran anything."""
        return union_s([(max(a, t0), min(b, t1)) for a, b, _ in self.device
                        if b > t0 and a < t1])

    def score_busy_s(self, t0: float, t1: float) -> float:
        """The same, of the scorer's kernels."""
        return union_s([(max(a, t0), min(b, t1)) for a, b in self.score
                        if b > t0 and a < t1])

    def top_ops(self, n: int = 10, width: int = 96) -> List[List]:
        """The n device operations that took most time, seconds summed by
        name (names cut to `width` characters)."""
        tot: Dict[str, float] = defaultdict(float)
        for a, b, name in self.device:
            tot[name[:width]] += b - a
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, t0: float, t1: float, n: int = 10) -> List[List]:
        """The device's idle time in [t0, t1] by what the host was doing:
        each gap named by the innermost host span over its middle, the
        seconds summed by name, the largest n."""
        busy = merged([(a, b) for a, b, _ in self.device])
        gaps, prev = [], t0
        for a, b in busy:
            if a > prev:
                gaps.append((prev, min(a, t1)))
            prev = max(prev, b)
        if t1 > prev:
            gaps.append((prev, t1))
        host = sorted(self.host)
        starts = [h[0] for h in host]
        tot: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            name = "no host span"
            # Spans nest: the covering span that starts last is innermost.
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if host[i][1] >= mid:
                    name = host[i][2]
                    break
            tot[name] += b - a
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def reduce(events: List[dict]) -> Trace:
    """Chrome trace events -> Trace (times in seconds, from the trace's
    microseconds)."""
    launch: Dict[int, float] = {}
    spans: List[Tuple[float, float]] = []
    tr = Trace()
    dev = []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"]) * 1e-6
        b = a + float(e["dur"]) * 1e-6
        if cat in DEVICE_CATS:
            dev.append((a, b, str(e.get("name")),
                        (e.get("args") or {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launch[c] = a
        elif cat in HOST_CATS:
            tr.host.append((a, b, str(e.get("name"))))
            if e.get("name") == SCORE_SPAN:
                spans.append((a, b))
    spans.sort()
    starts = [s[0] for s in spans]
    for a, b, name, c in dev:
        tr.device.append((a, b, name))
        t = launch.get(c)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            tr.score.append((a, b))
    return tr


def load(path: str) -> Trace:
    with open(path) as fh:
        data = json.load(fh)
    return reduce(data["traceEvents"] if isinstance(data, dict) else data)
