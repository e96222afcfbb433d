"""`portbench/spans.py` on a hand-made trace, with the values worked out
by hand; None where the trace holds no frame loop."""

import pytest

from portbench import spans


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def hand_trace(loop=True):
    """A 2,000 µs slice: a scorer kernel launched eagerly before the frame
    loop; inside `frame_loop` (50-300 µs) an input copy, two graph
    launches (correlation 3: kernels 210-500 and 520-700 µs; 4: 750-900
    µs) and the carry's copy (900-950 µs); the chase's kernel and its copy
    to the host launched in `ngram.backtrace`; `ngram.hyps` ends at
    1,400 µs."""
    evs = [
        ev("user_annotation", spans.SLICE, 0, 2000),
        ev("user_annotation", "ngram.score", 10, 30),
        ev("cuda_runtime", "cudaLaunchKernel", 20, 2, 1),
        ev("kernel", "k1", 100, 90, 1),
        ev("cuda_runtime", "cudaMemcpyAsync", 60, 2, 2),
        ev("gpu_memcpy", "Memcpy DtoD", 200, 10, 2),
        ev("cuda_runtime", "cudaGraphLaunch", 70, 5, 3),
        ev("kernel", "step_a", 210, 290, 3),
        ev("kernel", "step_b", 520, 180, 3),
        ev("cuda_runtime", "cudaGraphLaunch", 120, 5, 4),
        ev("kernel", "step_a", 750, 150, 4),
        ev("cuda_runtime", "cudaLaunchKernel", 280, 2, 5),
        ev("kernel", "clone", 900, 50, 5),
        ev("user_annotation", "ngram.backtrace", 310, 890),
        ev("cuda_runtime", "cudaLaunchKernel", 320, 2, 6),
        ev("kernel", "gather", 960, 40, 6),
        ev("cuda_runtime", "cudaMemcpyAsync", 1100, 50, 7),
        ev("gpu_memcpy", "Memcpy DtoH", 1100, 50, 7),
        ev("user_annotation", "ngram.hyps", 1210, 190),
    ]
    if loop:
        evs.append(ev("user_annotation", spans.FRAME_LOOP, 50, 250))
    return spans.reduce(evs)


def test_frame_loop_readers():
    tr = hand_trace()
    # Launched in the loop: 200-210, 210-500, 520-700, 750-900, 900-950:
    # 680 µs busy over 100 frame steps.
    assert spans.frame_loop_ms_per_frame(tr, 100) == pytest.approx(0.0068)
    # Its extent 200-950 µs (750) holds 70 µs with nothing running.
    assert spans.frame_loop_idle_pct(tr) == pytest.approx(100 * 70 / 750)
    # The loop's last interval ends at 950 µs, `ngram.hyps` at 1,400.
    assert spans.readout_ms(tr) == pytest.approx(0.45)


def test_readers_find_nothing_without_a_frame_loop():
    for tr in (spans.reduce([]), hand_trace(loop=False)):
        assert spans.frame_loop_ms_per_frame(tr, 100) is None
        assert spans.frame_loop_idle_pct(tr) is None
        assert spans.readout_ms(tr) is None
    assert spans.frame_loop_ms_per_frame(hand_trace(), 0) is None


def test_host_reads_per_batch():
    # The warm-up's calls first, then the window's two batches.
    assert spans.host_reads_per_batch([9, 3, 3, 4, 2], 2) == 3.0
    assert spans.host_reads_per_batch([3], 2) is None
    assert spans.host_reads_per_batch([], 0) is None
