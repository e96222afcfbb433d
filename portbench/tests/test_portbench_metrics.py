"""Each reader on a hand-made trace and window, with the values worked
out by hand."""

import pytest

from portbench import counters, drive, harness, kinds
from portbench import trace as trace_mod

CONT = {"kind": "cont", "S": 6144, "K": 8, "D": 39}


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def hand_trace():
    """A 1,000 µs slice: a scorer span launching two kernels (correlation 1,
    2: 90 µs and 50 µs, overlapping by 10), a graph launch (3) whose two
    kernels run 300 µs and 100 µs, and a memcpy of 50 µs; the device idle
    for the rest, the host in `aten::copy_` over the last gap."""
    return trace_mod.reduce([
        ev("user_annotation", drive.SLICE_SPAN, 0, 1000),
        ev("user_annotation", trace_mod.SCORE_SPAN, 10, 30),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 2, 1),
        ev("cuda_runtime", "cudaLaunchKernel", 20, 2, 2),
        ev("kernel", "k1", 100, 90, 1),
        ev("kernel", "epilogue", 180, 50, 2),
        ev("cuda_runtime", "cudaGraphLaunch", 300, 5, 3),
        ev("kernel", "step_a", 400, 300, 3),
        ev("kernel", "step_b", 700, 100, 3),
        ev("gpu_memcpy", "Memcpy DtoH", 850, 50, 4),
        ev("cpu_op", "aten::copy_", 890, 110),
    ])


def run_of(tr, **window):
    w = drive.Window(**window)
    return harness.Run(cell={}, config={}, mix={}, shape=CONT,
                       setup_s=12.5, window=w, trace=tr,
                       slice=tr.span(drive.SLICE_SPAN) if tr else (0, 0))


def read(name, run):
    return harness.reader(name)(run)


def test_trace_reduction():
    tr = hand_trace()
    # Busy: [100, 230] + [400, 800] + [850, 900] = 130 + 400 + 50 µs.
    assert tr.busy_s(0.0, 1e-3) == pytest.approx(580e-6)
    assert tr.score_busy_s(0.0, 1e-3) == pytest.approx(130e-6)
    assert tr.top_ops(2) == [["step_a", pytest.approx(300e-6)],
                             ["step_b", pytest.approx(100e-6)]]
    gaps = dict(tr.idle_gaps(0.0, 1e-3))
    # Gaps: [0, 100] in the slice span, [230, 400] in the slice span,
    # [800, 850] and [900, 1000]: the last under aten::copy_.
    assert gaps["aten::copy_"] == pytest.approx(100e-6)
    assert gaps[drive.SLICE_SPAN] == pytest.approx(320e-6)


def test_device_readers():
    tr = hand_trace()
    run = run_of(tr, slice_steps=10, slice_calls=[9600],
                 seconds=2.0, slice_wall_s=0.5, slice_real=1000,
                 free_wall_s=2.0, free_real=4000, captures=3, audio_s=40.0)
    least = counters.score_least_s(CONT, 9600)
    assert read("score_roofline.batch", run) == pytest.approx(
        100 * least / 130e-6)
    assert read("search_ms_per_frame.batch", run) == pytest.approx(
        1e3 * (580e-6 - 130e-6) / 10)
    assert read("device_idle_pct.batch", run) == pytest.approx(42.0)
    # Over the batches outside the profiled slice alone.
    assert read("mfu.batch", run) == pytest.approx(
        100 * kinds.load("cont").continuous_gmm_flops(4000, 6144, 8, 39)
        / (2.0 * counters.PEAK_BF16))
    assert read("graph_captures.batch", run) == 3.0
    assert read("batch_xrt", run) == 20.0
    assert read("setup_s", run) == 12.5


def test_readers_find_nothing_without_a_device_trace():
    run = run_of(None, slice_steps=10, slice_calls=[100])
    run.trace, run.slice = trace_mod.Trace(), (0.0, 1.0)
    for name in ("score_roofline.batch", "search_ms_per_frame.batch",
                 "device_idle_pct.batch"):
        assert read(name, run) is None
