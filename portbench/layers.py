"""What the per-layer readers (`metrics/<name>.py`) share: each layer's
number from a run's window, counters and traced slice.  Every function
returns None where the run holds nothing to read."""

from __future__ import annotations

from typing import Optional

from . import counters


def mfu_pct(run) -> Optional[float]:
    """Model FLOPs (the senone scoring of every real frame) of the traced
    run's batches outside the profiled slice, over the seconds of their
    decode calls, as a share of the bf16 dense peak."""
    w = run.window
    if not w.free_real or w.free_wall_s <= 0:
        return None
    flops = counters.score_flops(run.shape, w.free_real)
    return 100.0 * flops / (w.free_wall_s * counters.PEAK_BF16)


def _traced(run) -> bool:
    """The run was traced and its trace saw the device work."""
    return run.trace is not None and bool(run.trace.device)


def score_roofline_pct(run) -> Optional[float]:
    """The scorer calls' least time (from their shapes) over the device
    time of the kernels they launched, in the traced slice."""
    if not _traced(run) or not run.window.slice_calls:
        return None
    busy = run.trace.score_busy_s(*run.slice)
    if busy <= 0:
        return None
    least = sum(counters.score_least_s(run.shape, T)
                for T in run.window.slice_calls)
    return 100.0 * least / busy


def search_ms_per_frame(run) -> Optional[float]:
    """Device busy ms outside the scorer's kernels (features, padding, the
    frame loop, the backtrace, copies), per frame step of the search in
    the traced slice."""
    if not _traced(run) or not run.window.slice_steps:
        return None
    busy = run.trace.busy_s(*run.slice) - run.trace.score_busy_s(*run.slice)
    return 1e3 * busy / run.window.slice_steps


def device_idle_pct(run) -> Optional[float]:
    """Share of the traced slice's wall with no device work running."""
    if not _traced(run):
        return None
    t0, t1 = run.slice
    if t1 <= t0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s(t0, t1) / (t1 - t0))


def graph_captures(run) -> Optional[float]:
    """Frame-loop graphs captured in the window: shapes the warm-up missed."""
    return float(run.window.captures)
