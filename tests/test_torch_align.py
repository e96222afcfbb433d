"""Port parity for forced alignment (`AlignSearch`, `Decoder.align`), the
allphone search (`allphone_search`, `make_phone_dict`, `uniform_phone_lm`,
`Decoder(allphone=...)`) and the phone loop (`PhoneLoopSearch`) against
the JAX package on the seeded SMALL fixture.

Tolerances: fed the same senone scores (an identity scorer), the
alignment's state sequence and its word and phone segments are equal and
its score within rtol 1e-5 (the same float32 additions; equal in
practice); through each package's own scorer (`Decoder.align`), states and
segments equal and the score within rtol 1e-5 (the scorers' float32 sums
in another order).  The allphone search's tapes as in
test_torch_ngram_search; the phone loop's scores within 1e-4 absolute
(float32 renormalized per frame) and its mask equal.
"""

import numpy as np
import pytest
import torch

from cmusphinx_tpu.api import Decoder as JaxDecoder
from cmusphinx_tpu.decode.align import AlignSearch as JaxAlign
from cmusphinx_tpu.decode.align import allphone_search as jax_allphone
from cmusphinx_tpu.decode.align import uniform_phone_lm as jax_uniform_lm
from cmusphinx_tpu.decode.phone_loop import PhoneLoopSearch as JaxLoop
from cmusphinx_tpu.models.ngram import NgramModel as JaxNgram
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.api import Decoder
from cmusphinx_tpu_torch.decode.align import (AlignSearch, allphone_search,
                                              make_phone_dict,
                                              uniform_phone_lm)
from cmusphinx_tpu_torch.decode.phone_loop import PhoneLoopSearch
from cmusphinx_tpu_torch.frontend import FeatPipeline
from cmusphinx_tpu_torch.lm.estimate import train_lm
from cmusphinx_tpu_torch.models.ngram import NgramModel
from cmusphinx_tpu_torch.models.ngram_device import DeviceNgram
from cmusphinx_tpu_torch.ops import ContinuousScorer
from cmusphinx_tpu_torch.utils.bio import write_mfc
from test_torch_grammar import Identity
from test_torch_host import assert_same
from test_torch_ngram_search import assert_hyps_match, assert_tapes_match


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    fx = fixture.build(0, size=fixture.SMALL)
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    sc = ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu")
    feats = [fp.compute(c) for c in fx.ceps]
    scores = [sc.score(torch.as_tensor(f)).numpy() for f in feats]
    return fx, feats, scores, sc


def _same_alignment(got, want):
    (ws, ps, st, sc), (jws, jps, jst, jsc) = got, want
    assert st == jst
    assert [(w.word, w.start_frame, w.end_frame) for w in ws] == \
        [(w.word, w.start_frame, w.end_frame) for w in jws]
    assert [(p.phone, p.start_frame, p.end_frame, p.word, p.word_idx)
            for p in ps] == [(p.phone, p.start_frame, p.end_frame, p.word,
                              p.word_idx) for p in jps]
    assert sc == pytest.approx(jsc, rel=1e-5)


def test_align_matches_reference(small):
    fx, _, scores, _ = small
    ta = AlignSearch(fx.dict, fx.mdef, fx.tmat, Identity(), device="cpu")
    ja = JaxAlign(fx.dict, fx.mdef, fx.tmat, Identity())
    for i, sc in enumerate(scores):
        words = fx.transcripts[i]
        got = ta.align(torch.as_tensor(sc), words)
        _same_alignment(got, ja.align(sc, words))
        ws, ps, st, _ = got
        assert [w.word for w in ws] == words and len(st) == len(sc)
        assert ps[0].start_frame == 0 and ps[-1].end_frame == len(sc) - 1
        # A word said twice, as a transcript with a repeat.
        twice = words + words[-1:]
        _same_alignment(ta.align(torch.as_tensor(sc), twice),
                        ja.align(sc, twice))
    # The sentence HMM itself.
    for a, b in zip(ta._build(fx.transcripts[0]), ja._build(fx.transcripts[0])):
        assert_same(b, a)
    with pytest.raises(KeyError):
        ta.align(torch.as_tensor(scores[0]), ["zzz"])


def test_decoder_align_matches_reference(small, tmp_path):
    fx, feats, _, _ = small
    kw = fixture.write_model_dir(fx, str(tmp_path))
    td, jd = Decoder(device="cpu", **kw), JaxDecoder(**kw)
    for f, words in zip(feats, fx.transcripts):
        _same_alignment(td.align(f, words), jd.align(f, words))
    pcm = fixture.synthetic_pcm(4, 0.8)
    _same_alignment(td.align(pcm, fx.transcripts[0], raw=True),
                    jd.align(pcm, fx.transcripts[0], raw=True))


def test_uniform_phone_lm_and_its_device_tables(small):
    fx = small[0]
    lm, jlm = uniform_phone_lm(fx.mdef), jax_uniform_lm(fx.mdef)
    assert_same(jlm, lm)
    assert lm.n == 1 and lm.n_words == fx.mdef.n_ciphone + 1
    d = make_phone_dict(fx.mdef)
    assert d.n_word == fx.mdef.n_ciphone - 1 + 3
    dlm = DeviceNgram(lm, device="cpu")
    w = torch.arange(lm.n_words)
    want = np.asarray([lm.tg_score(-1, -1, int(x)) for x in w])
    np.testing.assert_allclose(
        dlm.score_tg(torch.full_like(w, -1), torch.full_like(w, -1), w).numpy(),
        want, rtol=1e-6)


@pytest.mark.parametrize("plm", ["uniform", "bigram"])
def test_allphone_matches_reference(small, plm, tmp_path):
    """The allphone search, with the uniform phone LM and with a phone
    bigram LM trained on the transcripts' phones."""
    fx, feats, scores, sc = small
    lm = jlm = None
    if plm == "bigram":
        sents = [[fx.mdef.ciname[p] for w in t
                  for p in fx.dict.pron[fx.dict.wordid(w)]]
                 for t in fx.transcripts * 20]
        path = str(tmp_path / "phones.arpa")
        train_lm(sents, n=2).write_arpa(path)
        lm, jlm = NgramModel.read(path), JaxNgram.read(path)
    ts = allphone_search(fx.mdef, fx.tmat, Identity(), lm=lm, device="cpu",
                         lw=3.0)
    js = jax_allphone(fx.mdef, fx.tmat, Identity(), lm=jlm, lw=3.0)
    assert ts.vocab.word_str == js.vocab.word_str
    for sc_ in scores:
        h, jh = ts.decode(sc_), js.decode(sc_)
        assert_hyps_match([h], [jh])
        assert_tapes_match(ts._last_batch[0], [a[None] for a in js._last[:6]],
                           ts.E)
        assert len(h.words) >= 3


def test_decoder_allphone_matches_reference(small, tmp_path):
    fx, feats, _, _ = small
    kw = fixture.write_model_dir(fx, str(tmp_path))
    ap = {"hmm": kw["hmm"], "allphone": "uniform", "lw": 3.0}
    td, jd = Decoder(device="cpu", **ap), JaxDecoder(**ap)
    for c in fx.ceps:
        path = str(tmp_path / "u.mfc")
        write_mfc(path, c)
        assert_hyps_match([td.decode_cep_file(path)],
                          [jd.decode_cep_file(path)])


def test_phone_loop_matches_reference(small):
    fx, _, scores, _ = small
    tl = PhoneLoopSearch(fx.mdef, fx.tmat, Identity(), device="cpu",
                         pl_weight=2.0)
    jl = JaxLoop(fx.mdef, fx.tmat, Identity(), pl_weight=2.0)
    for sc in scores:
        x = torch.as_tensor(sc)
        ph, jph = tl.phone_scores(x), jl.phone_scores(sc)
        assert ph.shape == (len(sc), fx.mdef.n_ciphone)
        np.testing.assert_allclose(ph, jph, rtol=0, atol=1e-4)
        np.testing.assert_allclose(tl.heuristic(x, 5), jl.heuristic(sc, 5),
                                   rtol=1e-5, atol=1e-3)
        for beam in (1e-10, 1e-2):
            m = tl.lookahead_mask(x, 5, beam)
            np.testing.assert_array_equal(m, jl.lookahead_mask(sc, 5, beam))
            assert m.any(1).all()
        assert not m.all()                 # the tight beam masks phones
