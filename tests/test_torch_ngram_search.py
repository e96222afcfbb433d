"""Port parity for the slice as a whole: `NgramSearch.decode_batch_cep`
(cmusphinx_tpu_torch.decode) against the reference's, with the reference
scoring through `ContinuousScorer(use_pallas=False)`, on the small seeded
fixture (cmusphinx_tpu_torch.fixture).

Integer tapes, chase arrays and hypotheses must be equal.  Float tapes
(`tsc`, `trc`) are held within rtol 1e-5: XLA and torch sum the float32
senone scores in another order, which moves path scores by an ulp or so
(measured: 1e-7 relative); a tie flipped by that would show up in the
integer tapes, which are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmusphinx_tpu.decode.ngram_search import NgramSearch as JaxSearch
from cmusphinx_tpu.frontend.feat import FeatPipeline as JaxFeat
from cmusphinx_tpu.ops.gmm import ContinuousScorer as JaxScorer
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.decode import NgramSearch
from cmusphinx_tpu_torch.frontend import FeatPipeline
from cmusphinx_tpu_torch.ops import ContinuousScorer

TAPES = ("tw", "tsc", "tprev", "th2", "th1", "trc")


@pytest.fixture(scope="module")
def fx():
    return fixture.build(0, size=fixture.SMALL)


@pytest.fixture(scope="module")
def port(fx):
    sc = ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu")
    return (NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, sc, device="cpu"),
            FeatPipeline(fx.feat_config(), device="cpu"))


@pytest.fixture(scope="module")
def decoded(fx, port):
    js = JaxSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                   JaxScorer(fx.gauden, fx.ln_mixw, use_pallas=False))
    jfp = JaxFeat(fx.feat_config())
    jhyps = js.decode_batch_cep(fx.ceps, jfp)
    jtapes = [np.asarray(a) for a in js._last_batch[0]]
    Ts = [len(c) for c in fx.ceps]
    cpad = np.zeros((len(Ts), jtapes[0].shape[1] // js.E, 13), np.float32)
    for i, c in enumerate(fx.ceps):
        cpad[i, : len(c)] = c
    _, jchase = js._batch_cep_fn(jnp.asarray(cpad),
                                 jnp.asarray(Ts, dtype=jnp.int32))
    s, fp = port
    hyps = s.decode_batch_cep(fx.ceps, fp)
    tapes = [a.numpy() for a in s._last_batch[0]]
    T = torch.as_tensor(Ts)
    chase = s.device_backtrace(s._last_batch[0], T).numpy()
    return dict(js=js, jhyps=jhyps, jtapes=jtapes, jchase=np.asarray(jchase),
                hyps=hyps, tapes=tapes, chase=chase)


def test_graph_exercises_fanout_and_mpx(port):
    s, _ = port
    g = s.graph
    assert (g.rc_mode, g.lc_mode, g.lex_mode) == ("fanout", "mpx", "flat")
    assert g.n_rcvar > 1
    assert len(np.unique(g.lcmap[g.lc_row[g.is_entry]])) > 1


def _first_diff(a, b, E):
    bad = np.argwhere(a != b) if a.dtype.kind != "f" else np.argwhere(
        ~np.isclose(a, b, rtol=1e-5, atol=0))
    if not len(bad):
        return None
    u, slot = int(bad[0][0]), int(bad[0][1])
    return f"utt {u} frame {slot // E} slot {slot % E}"


def assert_tapes_match(got, want, E):
    """Tapes [B, n_slots(, Vr)] of the port against the reference's:
    integer tapes equal, float tapes within rtol 1e-5; a failure names the
    first utterance, frame and slot that differ."""
    for name, a, b in zip(TAPES, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0,
                                       err_msg=f"{name} {_first_diff(a, b, E)}")
        else:
            assert np.array_equal(a, b), f"{name} {_first_diff(a, b, E)}"


def assert_hyps_match(got, want):
    for h, j in zip(got, want, strict=True):
        assert h.words == j.words
        assert [(s.word, s.start_frame, s.end_frame) for s in h.segments] == \
            [(s.word, s.start_frame, s.end_frame) for s in j.segments]
        assert h.score == pytest.approx(j.score, rel=1e-5)


def assert_search_matches_reference(fx, js, ts, jfp, fp, single=1):
    """Both packages' searches over the same fixture: `decode_batch_cep`
    against the reference's batched program, and `decode` of utterance
    `single` against the reference's unbatched `decode`: tapes, chase
    arrays and hypotheses.  Returns the batched hypotheses and tapes."""
    E = js.E
    jhyps = js.decode_batch_cep(fx.ceps, jfp)
    jtapes = [np.asarray(a) for a in js._last_batch[0]]
    Ts = [len(c) for c in fx.ceps]
    cpad = np.zeros((len(Ts), jtapes[0].shape[1] // E, fx.ceps[0].shape[1]),
                    np.float32)
    for i, c in enumerate(fx.ceps):
        cpad[i, : len(c)] = c
    _, jchase = js._batch_cep_fn(jnp.asarray(cpad),
                                 jnp.asarray(Ts, dtype=jnp.int32))
    hyps = ts.decode_batch_cep(fx.ceps, fp)
    tapes = [a.numpy() for a in ts._last_batch[0]]
    assert_tapes_match(tapes, jtapes, E)
    chase = ts.device_backtrace(ts._last_batch[0], torch.as_tensor(Ts))
    np.testing.assert_allclose(chase.numpy(), np.asarray(jchase), rtol=1e-5,
                               atol=0)
    np.testing.assert_array_equal(chase[:, :3].numpy(),
                                  np.asarray(jchase)[:, :3])
    assert_hyps_match(hyps, jhyps)

    feats = np.asarray(fp.compute(fx.ceps[single]))
    jh = js.decode(feats)
    h = ts.decode(feats)
    assert_tapes_match(ts._last_batch[0], [a[None] for a in js._last[:6]], E)
    T = js._last[6]
    fpad = np.zeros((-(-T // 100) * 100, feats.shape[1]), np.float32)
    fpad[:T] = feats
    _, jc = js._single_fn(jnp.asarray(fpad), jnp.arange(len(fpad)) < T,
                          jnp.int32(T))
    c = ts.device_backtrace(ts._last_batch[0], torch.as_tensor([T]))
    np.testing.assert_allclose(c[0].numpy(), np.asarray(jc), rtol=1e-5,
                               atol=0)
    assert_hyps_match([h], [jh])
    return hyps, tapes


@pytest.mark.parametrize("name", TAPES)
def test_tapes_match_reference(decoded, name):
    k = TAPES.index(name)
    a, b = decoded["tapes"][k], decoded["jtapes"][k]
    E = decoded["js"].E
    assert a.shape == b.shape
    if name in ("tsc", "trc"):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=0,
                                   err_msg=str(_first_diff(a, b, E)))
    else:
        assert a.dtype == np.int32
        assert np.array_equal(a, b), _first_diff(a, b, E)


def test_chase_and_hypotheses_match_reference(decoded, fx):
    np.testing.assert_allclose(decoded["chase"], decoded["jchase"],
                               rtol=1e-5, atol=0)
    np.testing.assert_array_equal(decoded["chase"][:, :3],
                                  decoded["jchase"][:, :3])
    for h, j in zip(decoded["hyps"], decoded["jhyps"]):
        assert h.words == j.words
        assert [(s.word, s.start_frame, s.end_frame) for s in h.segments] == \
            [(s.word, s.start_frame, s.end_frame) for s in j.segments]
        assert h.score == pytest.approx(j.score, rel=1e-5)
    assert [h.words for h in decoded["hyps"]] == fx.transcripts


def test_decode_batch_and_decode_agree_with_batch_cep(decoded, fx, port):
    s, fp = port
    feats = fp.compute_batch(fx.ceps)
    hyps = s.decode_batch(feats)
    assert [h.words for h in hyps] == [h.words for h in decoded["hyps"]]
    # Other padded lengths reorder the float32 sums (CMN mean, GEMM
    # blocking): integer tapes equal, float tapes within rtol 1e-5.
    for a, b in zip(s._last_batch[0], decoded["tapes"]):
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=0)
        else:
            np.testing.assert_array_equal(a.numpy(), b)
    one = s.decode(feats[1])
    assert one.words == decoded["hyps"][1].words
    assert one.score == pytest.approx(decoded["hyps"][1].score, rel=1e-5)
    assert s.decode(feats[1][:0]).words == []
    assert s.decode_batch_cep([], fp) == []


@pytest.mark.parametrize("kw", [
    {"pl_window": 5, "pl_weight": 2.0},
    {"rcmode": "composite", "lcmode": "composite", "lexmode": "tree",
     "nlextree": 2},
    {"rcmode": "composite", "lcmode": "composite", "lexmode": "tree",
     "nlextree": 3, "pl_window": 3}])
def test_unported_options_raise(fx, port, kw):
    """The options that raised before they were ported (`nlextree > 1`,
    the N-copy tree; `pl_window`, the phone-loop lookahead) now decode
    as the reference's do: tapes, chase arrays and hypotheses, batched
    and one utterance."""
    s, fp = port
    js = JaxSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                   JaxScorer(fx.gauden, fx.ln_mixw, use_pallas=False), **kw)
    ts = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, s.scorer,
                     device="cpu", **kw)
    assert ts.pl_window == js.pl_window and ts.nlextree == js.nlextree
    if "pl_window" in kw:
        # The lookahead is real: some phones fall far below the best.
        la = ts._lookahead(ts.scorer.score(torch.as_tensor(
            fp.compute(fx.ceps[0])))[None], 50)
        assert la.shape == (1, 50, fx.mdef.n_ciphone) and (la < -1.0).any()
    hyps, _ = assert_search_matches_reference(
        fx, js, ts, JaxFeat(fx.feat_config()), fp)
    # Three tree copies with the lookahead at this size insert words (in
    # both packages alike); the others recognize every transcript.
    if kw.get("nlextree") != 3:
        assert [h.words for h in hyps] == fx.transcripts
    # Bestpath rescoring is ported (test_torch_lattice holds it to the
    # reference).
    assert [h.words for h in s.decode_batch_cep(fx.ceps, fp, bestpath=True)
            ] == fx.transcripts


def test_decode_empty_utterance_matches_reference(decoded, port):
    s, fp = port
    feats = np.zeros((0, 39), np.float32)
    want = decoded["js"].decode(feats)
    got = s.decode(feats)
    assert (got.words, got.score, got.segments) == \
        (want.words, want.score, want.segments) == ([], float("-inf"), [])


@pytest.mark.parametrize("model", ["semi", "s2_4x"])
def test_semicontinuous_slice_matches_reference(model):
    """The slice with the bit-faithful semi-continuous scorer: 8-bit
    weights over 3x13 svspec streams, and 4-bit weights over s2_4x.  Senone
    scores agree bit for bit on these inputs (see test_torch_semicont), so
    integer tapes and hypotheses are equal and float tapes within rtol
    1e-5."""
    from cmusphinx_tpu.ops.gmm import PsParityScorer as JaxPs
    from cmusphinx_tpu_torch.ops import PsParityScorer
    fx = fixture.build(0, model=model, size=fixture.SMALL)
    raw, meta = fixture.sendump_bytes(fx)
    sl = fx.stream_slices()
    wrap = meta["n_bits"] == 4
    assert wrap == (model == "s2_4x")
    js = JaxSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                   JaxPs(fx.gauden, raw, sl, topn=4, wrap_uint8=wrap))
    jhyps = js.decode_batch_cep(fx.ceps, JaxFeat(fx.feat_config()))
    s = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                    PsParityScorer(fx.gauden, raw, sl, topn=4,
                                   wrap_uint8=wrap, device="cpu"),
                    device="cpu")
    hyps = s.decode_batch_cep(fx.ceps, FeatPipeline(fx.feat_config(),
                                                    device="cpu"))
    E = js.E
    for a, b in zip(s._last_batch[0], js._last_batch[0]):
        a, b = a.numpy(), np.asarray(b)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
        else:
            assert np.array_equal(a, b), _first_diff(a, b, E)
    assert [h.words for h in hyps] == [h.words for h in jhyps]
    assert [h.words for h in hyps] == fx.transcripts


class _ScoresAsFeatures(torch.nn.Module):
    """A scorer whose features are the senone scores themselves, so that
    both packages' searches run on one set of scores."""

    def score(self, feats):
        return feats


def test_lookahead_at_weight_3_on_the_full_fixture_matches_reference():
    """`pl_window=5, pl_weight=3.0`, the setting `chip_smoke.py` runs on
    the card, over the hub4-class fixture's own graph (`fixture.build(0)`:
    S=5150, 300 words), both packages fed the same senone scores of its
    first utterances (the port's plain scorer on the CPU): integer tapes
    and hypotheses equal, float tapes within rtol 1e-5, as at weight 2.0 on
    SMALL.  At this weight the lookahead prunes words of the transcripts
    in both packages alike."""
    fx = fixture.build(0)
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    sc = ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu")
    with torch.inference_mode():
        scores = [sc.score(torch.as_tensor(np.asarray(fp.compute(c)))).numpy()
                  for c in fx.ceps[:3]]
    kw = {"pl_window": 5, "pl_weight": 3.0}
    js = JaxSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, _ScoresAsFeatures(), **kw)
    ts = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, _ScoresAsFeatures(),
                     device="cpu", **kw)
    jhyps = js.decode_batch(scores)
    hyps = ts.decode_batch(scores)
    assert_tapes_match([a.numpy() for a in ts._last_batch[0]],
                       [np.asarray(a) for a in js._last_batch[0]], js.E)
    assert_hyps_match(hyps, jhyps)
    errs = [fixture.word_errors(r, h.words)
            for r, h in zip(fx.transcripts, hyps)]
    assert sum(errs) > 0, errs
