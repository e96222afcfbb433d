"""The N-gram search's spans and counters on the CPU.

- `utils/profile.span`: with no profiler recording it is the one shared
  no-op context and makes no `record_function` call; under a profiler it
  is a `record_function` range of its name.
- A profiled batch decode (`decode_batch_cep`, with and without the
  phone-loop lookahead, and the one-utterance `decode` of a corpus run)
  holds the search's spans in the order the decode runs them, one after
  another, each inside the caller's span, as the trace's
  `user_annotation` events.
- `host_reads` counts the chase's early-exit tests and its copy to the
  host, and with bestpath the batch's six host tapes.

The card's half (the frame loop's kernels attributed to its span through
the launches' correlation ids) is in tests/test_torch_cuda.py.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.frontend import FeatPipeline
from cmusphinx_tpu_torch.utils import profile as prof_mod
from test_torch_graph import _search

BATCH_SPANS = ["ngram.pad", "ngram.features", "ngram.score", "frame_loop",
               "ngram.backtrace", "ngram.hyps"]


@pytest.fixture(scope="module")
def small():
    return fixture.build(0, size=fixture.SMALL)


def _spans(run, path):
    """The user annotations of a profiled `run()` inside a `caller` span,
    as (start, end, name) sorted by start."""
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with record_function("caller"):
            run()
    p.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") == "user_annotation")


def test_span_is_a_shared_noop_without_a_profiler(monkeypatch):
    calls = []
    monkeypatch.setattr(prof_mod, "record_function",
                        lambda name: calls.append(name))
    assert not torch.autograd._profiler_enabled()
    a, b = prof_mod.span("ngram.pad"), prof_mod.span("frame_loop")
    assert a is b
    with a:
        with b:
            pass
    assert calls == []


def test_span_is_a_record_function_under_a_profiler(monkeypatch):
    calls = []

    def fake(name):
        calls.append(name)
        return record_function(name)

    monkeypatch.setattr(prof_mod, "record_function", fake)
    with profile(activities=[ProfilerActivity.CPU]):
        with prof_mod.span("frame_loop"):
            pass
    assert calls == ["frame_loop"]
    assert prof_mod.span("frame_loop") is prof_mod.span("ngram.pad")


@pytest.mark.parametrize("entry", ["batch_cep", "batch_cep_lookahead",
                                   "one_utterance"])
def test_decode_spans_tile_the_decode(entry, small, tmp_path):
    fx = small
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    if entry == "one_utterance":
        s = _search(fx, {})
        feats = fp.compute(fx.ceps[0])
        run, want = lambda: s.decode(feats), [
            n for n in BATCH_SPANS if n != "ngram.features"]
    else:
        s = _search(fx, {"pl_window": 3} if entry.endswith("lookahead")
                    else {})
        run, want = lambda: s.decode_batch_cep(fx.ceps, fp), list(BATCH_SPANS)
        if s.pl_window:
            want.insert(want.index("frame_loop"), "ngram.lookahead")
    spans = _spans(run, tmp_path / "trace.json")
    assert spans[0][2] == "caller"
    c0, c1, _ = spans[0]
    inner = spans[1:]
    assert [n for _, _, n in inner] == want
    assert all(c0 <= a <= b <= c1 for a, b, _ in inner)
    # One after another: none overlaps the next.
    assert all(b <= a2 for (_, b, _), (a2, _, _) in zip(inner, inner[1:]))


@pytest.mark.parametrize("bestpath", [False, True])
def test_host_reads_count_the_chase_tests_and_its_copy(bestpath, small):
    fx = small
    s = _search(fx, {})
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    reads = s.profile.counter("host_reads")
    assert reads.count == 0
    hyps = s.decode_batch_cep(fx.ceps, fp, bestpath=False)
    # The chase takes as many steps as the longest path has words (n); it
    # tests for the end before steps 0, 8, 16, ... and stops at the first
    # test at or after step n.
    n = max(len(h.segments) for h in hyps)
    assert n > 0
    tests = -(-n // 8) + 1
    assert reads.count == tests + 1
    reads.reset()
    s.decode_batch_cep(fx.ceps, fp, bestpath=bestpath)
    assert reads.count == tests + 1 + (6 if bestpath else 0)
    assert f"host_reads={reads.count}" in s.profile.report()
