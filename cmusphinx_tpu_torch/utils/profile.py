"""Timers and counters — profile.h capability parity.

Reference: sphinxbase/include/sphinxbase/profile.h:95-205 — `ptmr_t`
(wall + CPU timers with start/stop/reset, accumulating across intervals,
used for xRT reporting in batch.c:759-777) and `pctr_t` named counters
(active senones/HMMs/words per frame, ngram_search.h:182 stats).

A copy of `cmusphinx_tpu/utils/profile.py`.  Timers optionally
synchronize the device (`Timer.stop(sync=torch.cuda.synchronize)`) so
device work is attributed to the interval that launched it.

`span(name)` names a stretch of the program in a `torch.profiler` trace:
while a profiler records, it is a `record_function` range, which the
trace holds as a `user_annotation` event on the clock of the device's
kernel, memcpy and memset records; otherwise it is one shared no-op
context, and costs one flag check.  The spans live only in the
profiler's own events: whoever runs the profiler exports its trace.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch.profiler import record_function

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A `record_function` range named `name` while a profiler records,
    else the shared no-op context."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _NO_SPAN


@dataclass
class Timer:
    """ptmr_t: accumulating wall + CPU timer."""
    name: str = ""
    t_elapsed: float = 0.0       # accumulated wall seconds
    t_cpu: float = 0.0           # accumulated CPU seconds
    _w0: Optional[float] = None
    _c0: Optional[float] = None

    def start(self) -> "Timer":
        self._w0 = time.perf_counter()
        self._c0 = time.process_time()
        return self

    def stop(self, sync=None) -> float:
        """Stop the interval; `sync` is an optional callable that waits for
        the device (`torch.cuda.synchronize`) so device time is included."""
        if sync is not None:
            sync()
        if self._w0 is None:
            return 0.0
        dw = time.perf_counter() - self._w0
        self.t_elapsed += dw
        self.t_cpu += time.process_time() - self._c0
        self._w0 = self._c0 = None
        return dw

    def reset(self) -> None:
        self.t_elapsed = self.t_cpu = 0.0
        self._w0 = self._c0 = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


@dataclass
class Counter:
    """pctr_t: named event counter."""
    name: str = ""
    count: int = 0

    def increment(self, n: int = 1) -> None:
        self.count += int(n)

    def reset(self) -> None:
        self.count = 0


class Profile:
    """A registry of timers and counters with a one-line report
    (the decoders' per-utterance and corpus-summary stats)."""

    def __init__(self):
        self.timers: Dict[str, Timer] = {}
        self.counters: Dict[str, Counter] = {}

    def timer(self, name: str) -> Timer:
        if name not in self.timers:
            self.timers[name] = Timer(name)
        return self.timers[name]

    def counter(self, name: str) -> Counter:
        if name not in self.counters:
            self.counters[name] = Counter(name)
        return self.counters[name]

    def reset(self) -> None:
        for t in self.timers.values():
            t.reset()
        for c in self.counters.values():
            c.reset()

    def report(self, audio_seconds: Optional[float] = None) -> str:
        """profile.h ptmr report + batch.c xRT semantics: per timer,
        `name: wall cpu [xRT]`; counters appended as `name=N`."""
        parts = []
        for t in self.timers.values():
            s = f"{t.name}: {t.t_elapsed:.3f}s wall {t.t_cpu:.3f}s cpu"
            if audio_seconds:
                s += f" {t.t_elapsed / audio_seconds:.3f} xRT"
            parts.append(s)
        parts += [f"{c.name}={c.count}" for c in self.counters.values()]
        return "; ".join(parts)
