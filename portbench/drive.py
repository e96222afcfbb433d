"""The measured window: the port driven through its own entry, by the mix.

`Tap` wraps the search's scorer on the instance: a `portbench.score`
span (`torch.profiler.record_function`) around each call, the call's
input shape, and the outputs of the calls the check will read (kept on the
device, no copy, no sync).

`BatchWindow` is the closed loop of `batch` mixes: batches of pool
utterances through `search.decode_batch_cep(ceps, decoder.fp)` back to
back, until the window's seconds have passed (the window closes at the end
of the batch that crosses them, and not before the batches that every run
decodes, `traffic.decoded`).  No user entry of the program batches
utterances yet (a corpus run decodes one at a time): the mix measures the
batched search that such an entry would call.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import ProfilerActivity, profile, record_function

from . import traffic
from .trace import SCORE_SPAN

SLICE_SPAN = "portbench.slice"


class Tap(nn.Module):
    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner
        self.calls: List[Tuple[int, ...]] = []
        self.keep: Optional[object] = None       # label of a call to keep
        self.kept: List[Tuple[object, torch.Tensor]] = []

    def score(self, feats: torch.Tensor) -> torch.Tensor:
        with record_function(SCORE_SPAN):
            out = self.inner.score(feats)
        self.calls.append(tuple(feats.shape))
        if self.keep is not None:
            self.kept.append((self.keep, out))
        return out

    forward = score


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Profiled:
    """The traced slice: torch.profiler over it, a `portbench.slice` span
    around it, the trace exported to `path`."""

    def __init__(self, path: str, device):
        self.path, self.device = path, device
        self.prof = None
        self.span = None

    @staticmethod
    def warm(device) -> None:
        """Start the profiler once in set-up: its first start is slow."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device=device).add_(1)
            sync(device)

    def start(self) -> None:
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.span = record_function(SLICE_SPAN)
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, w: "Window", calls) -> None:
        """End the slice: its wall and the frames (rows) of the scorer
        calls made in it go to the window `w`."""
        sync(self.device)
        w.slice_wall_s = time.perf_counter() - self.t0
        w.slice_calls = [int(np.prod(c[:-1])) for c in calls]
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)
        self.prof = None


@dataclass
class Window:
    """What a window did: the harness's own counts and host times."""
    seconds: float = 0.0
    audio_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    captures: int = 0            # graph captures added in the window
    # The profiled slice (traced runs): its wall, frame steps, real frames
    # and the frames (rows) of each scorer call in it.
    slice_wall_s: float = 0.0
    slice_steps: int = 0
    slice_real: int = 0
    slice_calls: List[int] = field(default_factory=list)
    # The batches outside the profiled slice: their decode calls' summed
    # wall and real frames (the profiler's own host work left out).
    free_wall_s: float = 0.0
    free_real: int = 0
    # (batch index, pool index, hypothesis) of each utterance a batch
    # decoded.
    answers: list = field(default_factory=list)
    errors: List[str] = field(default_factory=list)


def _captures(search) -> int:
    return int(search._graph_stats["captures"])


def _pad(n: int, bucket: int) -> int:
    return -(-n // bucket) * bucket


class BatchWindow:
    def __init__(self, decoder, tap: Tap, mix: dict, seed: int, ceps,
                 device):
        self.dec, self.tap, self.mix, self.ceps = decoder, tap, mix, ceps
        self.device = device
        self.plan = traffic.batch_plan(mix, seed, 4096)
        self.checked = traffic.check_batches(mix, seed, self.plan)
        self.bucket = decoder.search.FRAME_BUCKET

    def _decode(self, idx):
        with record_function("portbench.decode"):
            return self.dec.search.decode_batch_cep(
                [self.ceps[i] for i in idx], self.dec.fp)

    def warm(self) -> int:
        """One batch of every padded length the plan holds, then batches
        until one captures nothing.  Returns the captures made."""
        s = self.dec.search
        c0 = _captures(s)
        seen = {}
        for idx in self.plan:
            seen.setdefault(_pad(max(len(self.ceps[i]) for i in idx),
                                 self.bucket), idx)
        for idx in seen.values():
            self._decode(idx)
        for idx in self.plan[:8]:
            c = _captures(s)
            self._decode(idx)
            if _captures(s) == c:
                break
        sync(self.device)
        return _captures(s) - c0

    def run(self, seconds: float, prof: Optional[Profiled]) -> Window:
        w = Window()
        s = self.dec.search
        c0 = _captures(s)
        first = traffic.PROFILE_FROM
        last = traffic.decoded(self.mix) - 1
        sync(self.device)
        t0 = time.perf_counter()
        i = 0
        while True:
            idx = self.plan[i]
            lens = [len(self.ceps[j]) for j in idx]
            steps = _pad(max(lens), self.bucket)
            if prof is not None and i == first:
                prof.start()
                n_calls = len(self.tap.calls)
            self.tap.keep = i if i in self.checked else None
            w.attempted += len(idx)
            t_b = time.perf_counter()
            try:
                hyps = self._decode(idx)
            except Exception as e:  # a request that fails is counted
                w.errors.append(f"batch {i}: {type(e).__name__}: {e}")
                hyps = [None] * len(idx)
            if prof is None or not first <= i <= last:
                w.free_wall_s += time.perf_counter() - t_b
                w.free_real += sum(lens)
            self.tap.keep = None
            if len(hyps) != len(idx):
                w.errors.append(f"batch {i}: {len(hyps)} answers for "
                                f"{len(idx)} utterances")
                hyps = (list(hyps) + [None] * len(idx))[: len(idx)]
            for j, h in zip(idx, hyps):
                ok = h is not None and len(h.segments) > 0
                w.failed += not ok
                w.answers.append((i, j, h))
            w.audio_s += sum(lens) * traffic.FRAME_S
            if prof is not None and i == last:
                prof.stop(w, self.tap.calls[n_calls:])
            if prof is not None and first <= i <= last:
                w.slice_steps += steps
                w.slice_real += sum(lens)
            i += 1
            if time.perf_counter() - t0 >= seconds and i > last:
                break
        sync(self.device)
        w.seconds = time.perf_counter() - t0
        w.captures = _captures(s) - c0
        return w
