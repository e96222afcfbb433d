"""The grammar, phone-loop and alignment searches' block runners on the
CPU: what makes a block of frames capturable as a CUDA graph on the card,
and the searches run block by block against the JAX package.

- Every aten op of two consecutive blocks of `FsgSearch._block` (unpruned
  and pruned), `PhoneLoopSearch._block` and `AlignSearch._block`,
  recorded by a `TorchDispatchMode` (tests/test_torch_graph.py's
  recorder): none reads a device value on the host or makes a tensor
  from host data, and both blocks run the same ops with the same shapes,
  types and scalar arguments (the second block holds padded frames: the
  `valid` mask changes no op).
- The runners with blocks of 37 frames (no divisor of the 100-frame
  bucket nor of the 50-frame chunk, so a batch ends in a shorter block and
  a stream chunk is 37 + 13) against the JAX package on the same senone
  scores (an identity scorer): the FSG batch and stream exit tapes and
  hypotheses for a JSGF and an FSG grammar, pruned and not; alignment
  states, segments and score; the phone loop's `best` and per-phone
  rows.  Integers equal, floats within rtol 1e-5 (as in
  tests/test_torch_grammar.py and test_torch_align.py).
- The aligner's state bucket: `_viterbi` with the states padded to a
  multiple of 128 and of 64 is bit-equal to the unpadded run.
- On the CPU nothing is captured.
- Each search's `graph_stats` is its runner's counters (the N-gram
  search's `_graph_stats` the same).

The card's half (graphed against eager, bit-equal) is in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from cmusphinx_tpu.decode.align import AlignSearch as JaxAlign
from cmusphinx_tpu.decode.phone_loop import PhoneLoopSearch as JaxLoop
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.api import Decoder
from cmusphinx_tpu_torch.decode.align import AlignSearch
from cmusphinx_tpu_torch.decode.phone_loop import PhoneLoopSearch
from test_torch_align import _same_alignment
from test_torch_graph import _host_reads, _Record, _search
from test_torch_grammar import (Identity, _same, _scored, _searches,
                                assert_exits_match)

K_DISPATCH, K_RUNNER = 6, 37


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops a frame: intra-op threads only contend with the
    other test workers.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    return _scored(fixture.build(0, size=fixture.SMALL))


@pytest.fixture(scope="module")
def medium():
    return _scored(fixture.build(0, size=fixture.MEDIUM))


def _two_blocks(block, carry, inputs, rows, K=K_DISPATCH):
    """The aten ops of blocks 0 and 1 of K frames (frames 0 .. 2K-1)."""
    records = []
    with torch.inference_mode():
        for k0 in (0, K):
            sl = slice(k0, k0 + K)
            blk = (tuple(x[sl] for x in inputs),
                   torch.full((), k0, dtype=torch.int64),
                   tuple(r[sl] for r in rows))
            with _Record() as rec:
                carry = block(carry, *blk)
            records.append(rec.ops)
    return records


def _valid(K=K_DISPATCH):
    """Frames of two blocks, the second block's last three padding."""
    return torch.arange(2 * K) < 2 * K - 3


def _fsg_dispatch(fx, scores, tmp, **kw):
    s = _searches(fx, "jsgf", tmp, **kw)[0]
    sc = torch.as_tensor(scores[0][: 2 * K_DISPATCH])
    n, L, Vr = sc.shape[0], s.n_link, s.graph.n_rcvar
    rows = (torch.empty((n, L)), torch.empty((n, L), dtype=torch.int64),
            torch.empty((n, L)), torch.empty((n, L, Vr)))
    return s._block, s._init_carry(), (sc, _valid()), rows


def _loop_dispatch(fx, scores, tmp):
    s = PhoneLoopSearch(fx.mdef, fx.tmat, Identity(), device="cpu")
    alpha = torch.full((s.n_ci, s._n_state), -1e30)
    alpha[:, 0] = 0.0
    n = 2 * K_DISPATCH
    rows = (torch.empty(n), torch.empty((n, s.n_ci)))
    return (s._block, (alpha,),
            (torch.as_tensor(scores[0][:n]), _valid()), rows)


def _align_dispatch(fx, scores, tmp):
    s = AlignSearch(fx.dict, fx.mdef, fx.tmat, Identity(), device="cpu")
    sen, _, _, _, M, entry_lp = s._build(fx.transcripts[0])[:6]
    S = len(sen)
    Sp = -(-S // s.STATE_BUCKET) * s.STATE_BUCKET
    Mp = torch.full((Sp, Sp), -1e30)
    Mp[:S, :S] = torch.as_tensor(M)
    n = 2 * K_DISPATCH
    ll = torch.full((n, Sp), -1e30)
    ll[:, :S] = torch.as_tensor(scores[0][:n])[:, torch.as_tensor(sen).long()]
    a = torch.full((Sp,), -1e30)
    a[:S] = torch.as_tensor(entry_lp)
    return (s._block, (a, Mp), (ll, _valid()),
            (torch.empty((n, Sp), dtype=torch.int64),))


DISPATCH = {
    "fsg": lambda fx, sc, tmp: _fsg_dispatch(fx, sc, tmp),
    "fsg_pruned": lambda fx, sc, tmp: _fsg_dispatch(fx, sc, tmp, prune=True,
                                                    beam=1e-30),
    "phone_loop": _loop_dispatch,
    "align": _align_dispatch,
}


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_block_reads_nothing_on_the_host(case, small, tmp_path):
    fx, scores = small
    first, second = _two_blocks(*DISPATCH[case](fx, scores, str(tmp_path)))
    assert len(first) > 5 * K_DISPATCH
    assert _host_reads(first) == [] and _host_reads(second) == []
    assert [op[0] for op in first] == [op[0] for op in second]
    assert first == second
    # Every frame writes its rows of the block's tapes.
    assert sum(op[0] == "aten::copy_" for op in first) >= K_DISPATCH


# ---- the runners against the JAX package -----------------------------------

@pytest.mark.parametrize("kind,size,kw", [
    ("jsgf", "small", {}), ("fsg", "small", {}),
    ("jsgf", "small", {"prune": True, "beam": 1e-30}), ("fsg", "medium", {})])
def test_fsg_blocks_match_reference(kind, size, kw, request, tmp_path):
    """The batch decode (scores padded to the 100-frame bucket, blocks of
    37: the last one shorter) against the reference's scan."""
    fx, scores = request.getfixturevalue(size)
    ts, js = _searches(fx, kind, str(tmp_path), **kw)
    ts.BLOCK = K_RUNNER
    lens = []
    scan = ts._runner.scan
    ts._runner.scan = lambda *a, **k: lens.append(a[2][0].shape[0]) or \
        scan(*a, **k)
    for i, sc in enumerate(scores[:2] if size == "medium" else scores):
        h = ts.decode(torch.as_tensor(sc))
        _same(h, js.decode(sc))
        assert_exits_match(ts._last, js._last)
        assert h.words == fx.transcripts[i]
        assert lens[-1] % 100 == 0 and lens[-1] % K_RUNNER
    assert not ts._runner.cache and ts.graph_stats["captures"] == 0


@pytest.mark.parametrize("kind", ["jsgf", "fsg"])
def test_fsg_stream_blocks_match_reference(kind, small, tmp_path):
    """Partials after every 37-frame push, the final hypothesis and the
    exit tapes, each 50-frame chunk run as blocks of 37 and 13 and the
    flush's chunk padded."""
    fx, scores = small
    ts, js = _searches(fx, kind, str(tmp_path))
    ts.BLOCK = K_RUNNER
    for sc in scores:
        tst, jst = ts.stream_start(), js.stream_start()
        for k in range(0, len(sc), K_RUNNER):
            ts.stream_push(tst, sc[k: k + K_RUNNER])
            js.stream_push(jst, sc[k: k + K_RUNNER])
            _same(ts.stream_partial(tst), js.stream_partial(jst))
        assert len(sc) % ts.CHUNK
        _same(ts.stream_end(tst), js.stream_end(jst))
        assert_exits_match(ts._last, js._last)
        assert tst["t"] == jst["t"] == len(sc)
    assert not ts._runner.cache


def test_phone_loop_blocks_match_reference(small):
    fx, scores = small
    tl = PhoneLoopSearch(fx.mdef, fx.tmat, Identity(), device="cpu")
    jl = JaxLoop(fx.mdef, fx.tmat, Identity())
    tl.BLOCK = K_RUNNER
    for sc in scores:
        assert len(sc) % K_RUNNER
        best, phones = tl._run(torch.as_tensor(sc))
        jbest, jphones = (np.asarray(a) for a in jl._run(sc))
        assert best.shape == (len(sc),)
        np.testing.assert_allclose(best, jbest, rtol=1e-5, atol=0)
        np.testing.assert_allclose(phones, jphones, rtol=1e-5, atol=0)
    assert not tl._runner.cache


def test_align_blocks_match_reference(small):
    fx, scores = small
    ta = AlignSearch(fx.dict, fx.mdef, fx.tmat, Identity(), device="cpu")
    ja = JaxAlign(fx.dict, fx.mdef, fx.tmat, Identity())
    ta.BLOCK = K_RUNNER
    for i, sc in enumerate(scores):
        assert (len(sc) - 1) % K_RUNNER
        for words in (fx.transcripts[i],
                      fx.transcripts[i] + fx.transcripts[i][-1:]):
            _same_alignment(ta.align(torch.as_tensor(sc), words),
                            ja.align(sc, words))
    assert not ta._runner.cache


@pytest.mark.parametrize("bucket", [128, 64])
def test_state_bucket_changes_no_alignment_output(bucket, small):
    """`_viterbi` with the sentence HMM padded to a multiple of `bucket`
    states against the unpadded run (a bucket of 1): final scores and
    backpointers bit-equal, and so the states, segments and score."""
    fx, scores = small
    ta = AlignSearch(fx.dict, fx.mdef, fx.tmat, Identity(), device="cpu")
    for i, sc in enumerate(scores):
        for words in (fx.transcripts[i], fx.transcripts[i] * 2):
            b = ta._build(words)
            S = len(b[0])
            assert S % bucket
            args = (torch.as_tensor(sc), b[0], b[1], b[4], b[5], b[6])
            out = {}
            for B in (1, bucket):
                ta.STATE_BUCKET = B
                out[B] = ta._viterbi(*args) + (ta.align(sc, words),)
            (f1, p1, a1), (fb, pb, ab) = out[1], out[bucket]
            assert f1.shape == fb.shape == (S,)
            assert p1.shape == pb.shape == (len(sc) - 1, S)
            np.testing.assert_array_equal(fb, f1)
            np.testing.assert_array_equal(pb, p1)
            _same_alignment(ab, a1)
            assert ab[3] == a1[3]


def test_decoder_keeps_one_aligner(small, tmp_path):
    """`Decoder.align` reuses its aligner (and so its graphs) from call to
    call, and builds another when the scorer is replaced."""
    fx, _ = small
    d = Decoder(device="cpu", **fixture.write_model_dir(fx, str(tmp_path)))
    feats = [d.fp.compute(c) for c in fx.ceps[:2]]
    d.align(feats[0], fx.transcripts[0])
    al = d._aligner
    got = d.align(feats[1], fx.transcripts[1])
    assert d._aligner is al
    assert [w.word for w in got[0]] == fx.transcripts[1]
    d.scorer = Identity()
    d.align(al.scorer.score(torch.as_tensor(feats[1])).numpy(),
            fx.transcripts[1])
    assert d._aligner is not al and d._aligner.scorer is d.scorer


@pytest.mark.parametrize("kind", ["ngram", "fsg", "align", "phone_loop"])
def test_graph_stats_are_the_runners_counters(kind, small, tmp_path):
    fx, scores = small
    if kind == "ngram":
        s = _search(fx, {})
    elif kind == "fsg":
        s = _searches(fx, "jsgf", str(tmp_path))[0]
    elif kind == "align":
        s = AlignSearch(fx.dict, fx.mdef, fx.tmat, Identity(), device="cpu")
    else:
        s = PhoneLoopSearch(fx.mdef, fx.tmat, Identity(), device="cpu")
    st = s.graph_stats
    assert st is s._runner.stats
    assert set(st) == {"captures", "capture_s", "replays"}
    if kind == "ngram":
        assert s._graph_stats is st
