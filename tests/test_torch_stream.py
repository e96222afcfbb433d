"""Port parity for the streaming path: the live feature normalization
(`FeatPipeline.normalize_live` / `compute_live`), the streaming waveform
frontend (`FrontendStream`) and the streaming N-gram decode
(`NgramSearch.stream_start` / `stream_push` / `stream_partial` /
`stream_end`) against the JAX package on the same inputs.

Tolerances:
- the live features are host numpy and float32 subtractions on both sides:
  equal;
- the streaming frontend within tests/test_torch_fe.py's bound (1e-4 per
  log-mel value, carried through |dct| and the lifter);
- the stream on three graphs (mpx fanout on SMALL; flat composite and
  prefix tree with bigram lookahead on MEDIUM), fed the same features in
  37-frame pushes: integer tapes equal, float tapes within rtol 1e-5 (the
  scorers' f32 sums in another order), every partial and the final
  hypothesis equal in words and segments, scores within rtol 1e-5, each
  partial but its last word a prefix of the final hypothesis; one
  stream per graph starts with max_frames=100, so its tape grows.
- the port's stream against the port's batch decode of the same features:
  integer tapes equal, float tapes within rtol 1e-5 over the T*E slots
  (with the phone-loop lookahead of W frames, over the frames before the
  last W - 1, whose lookahead differs: padding in the batch, the repeated
  last frame in the stream).
- the graphs also run with the lookahead (`pl_window`) and with two and
  three tree copies (`nlextree`).
"""

import numpy as np
import pytest
import torch

from cmusphinx_tpu.decode.ngram_search import NgramSearch as JaxSearch
from cmusphinx_tpu.frontend.fe import FE_ARGS as JAX_FE_ARGS
from cmusphinx_tpu.frontend.fe import Frontend as JaxFrontend
from cmusphinx_tpu.frontend.fe import FrontendStream as JaxFrontendStream
from cmusphinx_tpu.frontend.feat import FEAT_ARGS as JAX_FEAT_ARGS
from cmusphinx_tpu.frontend.feat import FeatPipeline as JaxFeat
from cmusphinx_tpu.ops.gmm import ContinuousScorer as JaxScorer
from cmusphinx_tpu.utils.config import Config as JaxConfig
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.decode import NgramSearch
from cmusphinx_tpu_torch.frontend import FeatPipeline, Frontend, FrontendStream
from cmusphinx_tpu_torch.frontend.fe import FE_ARGS
from cmusphinx_tpu_torch.frontend.feat import FEAT_ARGS
from cmusphinx_tpu_torch.ops import ContinuousScorer
from cmusphinx_tpu_torch.utils.config import Config
from test_torch_fe import bound
from test_torch_ngram_search import TAPES, _first_diff

PUSH = 37


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The decode is many small ops a frame: intra-op threads only contend
    with the other test workers.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("params", [
    {"cmn": "prior", "agc": "emax"},
    {"cmn": "prior", "agc": "none", "cmninit": "40,3,-1"},
    {"cmn": "none", "agc": "max", "feat": "s2_4x"},
])
def test_live_features_match_reference(params):
    """A sequence of blocks that crosses the 800-frame refresh and ends two
    utterances (the AGC and CMN state carries across them)."""
    jfp = JaxFeat(JaxConfig(JAX_FEAT_ARGS), **params)
    tfp = FeatPipeline(Config(FEAT_ARGS), device="cpu", **params)
    rng = np.random.RandomState(3)
    blocks = [(300, False), (350, False), (251, True), (7, False),
              (420, False), (500, True), (90, True)]
    for n, end in blocks:
        cep = (rng.randn(n, 13) * 4 + np.r_[30.0, np.zeros(12)]).astype(
            np.float32)
        want = np.asarray(jfp.compute_live(cep, False, end))
        got = tfp.compute_live(cep, False, end)
        assert got.shape == want.shape == (n, jfp.dim)
        np.testing.assert_array_equal(got, want)
        for name in ("_cmn_mean", "_cmn_sum", "_agc_max", "_agc_obs_sum"):
            np.testing.assert_array_equal(getattr(tfp, name),
                                          getattr(jfp, name))
        assert (tfp._cmn_nframe, tfp._agc_obs_utt) == (jfp._cmn_nframe,
                                                        jfp._agc_obs_utt)
    assert tfp.compute_live(np.zeros((0, 13), np.float32), False,
                            False).shape == (0, jfp.dim)


def test_frontend_stream_matches_reference():
    """Uneven pieces of seeded speech-like PCM, through both packages'
    FrontendStream, and against one batch `process` of the whole audio."""
    x = fixture.synthetic_pcm(2, 1.3).astype(np.float32)
    for params in ({}, {"transform": "dct", "lifter": 22, "remove_dc": True}):
        jfe = JaxFrontend(JaxConfig(JAX_FE_ARGS), **params)
        tfe = Frontend(Config(FE_ARGS), device="cpu", **params)
        b = bound(tfe)
        js, ts = JaxFrontendStream(jfe), tfe.start_utt()
        assert isinstance(ts, FrontendStream)
        rng = np.random.RandomState(1)
        cuts = np.sort(rng.choice(len(x), 12, replace=False))
        got, want = [], []
        for piece in np.split(x, cuts):
            got.append(ts.process(piece))
            want.append(np.asarray(js.process(piece)))
            assert got[-1].shape == want[-1].shape
        got.append(ts.end_utt())
        want.append(np.asarray(js.end_utt()))
        got, want = np.concatenate(got), np.concatenate(want)
        assert got.shape == want.shape == (tfe.n_frames(len(x)), 13)
        assert np.all(np.abs(got.astype(np.float64) - want) <= b)
        assert np.all(np.abs(got.astype(np.float64) - tfe.process(x)) <= b)


@pytest.fixture(scope="module")
def small():
    return fixture.build(0, size=fixture.SMALL)


@pytest.fixture(scope="module")
def medium():
    return fixture.build(0, size=fixture.MEDIUM)


GRAPHS = {
    "mpx_fanout": ("small", {}),
    "flat_composite": ("medium", {"lexmode": "flat"}),
    "tree_bg": ("medium", {"lexmode": "tree", "treela": "bg"}),
    "mpx_lookahead": ("small", {"pl_window": 5, "pl_weight": 2.0}),
    "tree_copies": ("medium", {"lexmode": "tree", "nlextree": 2}),
    "tree_copies_lookahead": ("medium", {"lexmode": "tree", "nlextree": 3,
                                         "pl_window": 3}),
}
WANT_GRAPH = {"mpx_fanout": ("fanout", "mpx", "flat"),
              "flat_composite": ("composite", "composite", "flat"),
              "tree_bg": ("composite", "composite", "tree"),
              "mpx_lookahead": ("fanout", "mpx", "flat"),
              "tree_copies": ("composite", "composite", "tree"),
              "tree_copies_lookahead": ("composite", "composite", "tree")}


def _same(h, j):
    assert h.words == j.words
    assert [(s.word, s.start_frame, s.end_frame) for s in h.segments] == \
        [(s.word, s.start_frame, s.end_frame) for s in j.segments]
    assert h.score == pytest.approx(j.score, rel=1e-5)


def assert_flat_tapes_match(got, want, E):
    """Flat tapes [n_slots(, Vr)]: integer tapes equal, float tapes within
    rtol 1e-5; a failure names the first frame and slot that differ."""
    for name, a, b in zip(TAPES, got, want):
        a, b = np.asarray(a)[None], np.asarray(b)[None]
        assert a.shape == b.shape, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0,
                                       err_msg=f"{name} {_first_diff(a, b, E)}")
        else:
            assert np.array_equal(a, b), f"{name} {_first_diff(a, b, E)}"


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_stream_matches_reference_and_batch(graph, request):
    size, kw = GRAPHS[graph]
    fx = request.getfixturevalue(size)
    js = JaxSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                   JaxScorer(fx.gauden, fx.ln_mixw, use_pallas=False), **kw)
    ts = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                     ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu"),
                     device="cpu", **kw)
    g = ts.graph
    assert (g.rc_mode, g.lc_mode, g.lex_mode) == WANT_GRAPH[graph]
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    E = ts.E
    for u, max_frames in ((1, 100), (2, 1000)):
        feats = fp.compute(fx.ceps[u])
        T = feats.shape[0]
        jst = js.stream_start(max_frames=max_frames)
        tst = ts.stream_start(max_frames=max_frames)
        partials = []
        for i in range(0, T, PUSH):
            js.stream_push(jst, feats[i: i + PUSH])
            ts.stream_push(tst, feats[i: i + PUSH])
            assert tst["t"] == jst["t"]
            assert tst["pending"].shape == jst["pending"].shape
            p = ts.stream_partial(tst)
            _same(p, js.stream_partial(jst))
            partials.append(p.words)
        final = ts.stream_end(tst)
        _same(final, js.stream_end(jst))
        W = ts.pl_window
        # Three copies with the lookahead insert fillers at this size, in
        # both packages alike (their partials and finals are held equal).
        recognized = graph != "tree_copies_lookahead"
        if recognized:
            assert final.words == fx.transcripts[u]
        assert tst["t"] == T and tst["max_frames"] == jst["max_frames"]
        if max_frames == 100:
            assert tst["max_frames"] > 100          # the tape grew
        # The whole tape, grown rows and the last chunk's padded rows
        # included, against the reference's.
        F = tst["max_frames"]
        assert_flat_tapes_match(
            [a[0].reshape((F * E,) + tuple(a.shape[3:])).numpy()
             for a in tst["tape"]],
            [np.asarray(a) for a in jst["carry"][-1]], E)
        stream_tape = ts._last[:6]
        assert_flat_tapes_match(stream_tape, [a[: T * E]
                                              for a in js._last[:6]], E)
        # A partial's last word may still change as the word under way
        # ends; the words before it stand.
        assert any(partials) or not recognized
        for words in partials:
            assert final.words[: max(len(words) - 1, 0)] == words[:-1]
        # The port's stream against the port's batch decode.  With the
        # lookahead, the batch's last W - 1 frames look ahead into its
        # zero-feature padding and the stream's into its repeated last
        # frame: the frames before them are equal.
        batch = ts.decode(feats)
        n = (T - max(W - 1, 0)) * E
        if not W:
            _same(final, batch)
        assert_flat_tapes_match([a[:n] for a in stream_tape],
                                [a[0, :n].numpy()
                                 for a in ts._last_batch[0]], E)


def test_stream_filling_its_tape_to_the_last_frame(small):
    """An utterance exactly as long as a tape that is not a multiple of
    CHUNK: the last chunk's padded rows run past the tape.  The port grows
    the tape to hold them, so the stream equals the one from a roomy tape
    (and the reference's stream from one) and the port's batch decode.  The
    reference's stream from the short tape clamps those rows onto the last
    real frame and ends its last word early."""
    fx = small
    ts = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                     ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu"),
                     device="cpu")
    js = JaxSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                   JaxScorer(fx.gauden, fx.ln_mixw, use_pallas=False))
    feats = FeatPipeline(fx.feat_config(), device="cpu").compute(
        fx.ceps[2])[:120]
    jst = js.stream_start(max_frames=1000)
    for i in range(0, 120, PUSH):
        js.stream_push(jst, feats[i: i + PUSH])
    want = js.stream_end(jst)
    for max_frames in (120, 1000):
        st = ts.stream_start(max_frames=max_frames)
        for i in range(0, 120, PUSH):
            ts.stream_push(st, feats[i: i + PUSH])
        h = ts.stream_end(st)
        _same(h, want)
        assert h.segments[-1].end_frame == 119
        stream_tape = ts._last[:6]
        batch = ts.decode(feats)
        _same(h, batch)
        assert_flat_tapes_match(stream_tape, [a[0, : 120 * ts.E].numpy()
                                              for a in ts._last_batch[0]],
                                ts.E)


def test_stream_edges(small):
    """Pushes of nothing and of less than a chunk, a partial before any
    frame, and a stream shorter than one chunk."""
    fx = small
    ts = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                     ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu"),
                     device="cpu")
    feats = FeatPipeline(fx.feat_config(), device="cpu").compute(fx.ceps[0])
    st = ts.stream_start(max_frames=50)
    ts.stream_push(st, feats[:0])
    assert ts.stream_partial(st).score == float("-inf")
    ts.stream_push(st, feats[:30])
    assert st["t"] == 0 and st["pending"].shape[0] == 30
    h = ts.stream_end(st)
    assert st["t"] == 30 and st["pending"].shape[0] == 0
    _same(h, ts.decode(feats[:30]))
