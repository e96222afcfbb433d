"""Port parity for the entry point: `cmusphinx_tpu_torch.api.Decoder`
against `cmusphinx_tpu.api.Decoder`, both loading the same model
directories written by `fixture.write_model_dir` (small fixtures).

Both decoders must pick the same scorer class and give the same words and
segments for every utterance, through `decode_cep_file` (cepstra written
with `write_mfc`) and through `decode_raw` (seeded 16-bit PCM through the
waveform frontend).  Scores agree within rtol 1e-5: the scorers and the
frontend differ by float32 summation order only (see the tolerances in
test_torch_gmm, test_torch_semicont and test_torch_fe).
"""

import dataclasses
import inspect
import os

import numpy as np
import pytest
import torch

from cmusphinx_tpu.api import DECODER_ARGS as JAX_DECODER_ARGS
from cmusphinx_tpu.api import Decoder as JaxDecoder
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.models.mllr import MllrTransform
from cmusphinx_tpu_torch.utils.bio import write_mfc
from cmusphinx_tpu_torch.api import DECODER_ARGS, Decoder
from cmusphinx_tpu_torch.decode.results import Hypothesis

# (fixture model, mixture-weight file, extra Decoder arguments) -> scorer
CASES = {
    "cont": ("cont", None, {}, "ContinuousScorer"),
    "semi_8bit": ("semi", None, {}, "PsParityScorer"),
    "s2_4x_4bit": ("s2_4x", None, {}, "PsParityScorer"),
    "semi_noparity": ("semi", None, {"parity": False}, "SemiContinuousScorer"),
    "semi_mixw": ("semi", "mixture_weights", {}, "SemiContinuousScorer"),
    "ptm": ("ptm", None, {}, "PTMScorer"),
    "cont_lambda": ("cont", None, {"lambda": True}, "InterpolatedScorer"),
}


def _table(args):
    """An argument table's values (the port's `Arg` is its own class)."""
    return [dataclasses.astuple(a) for a in args]


def _same(h, j):
    assert h.words == j.words
    assert [(s.word, s.start_frame, s.end_frame) for s in h.segments] == \
        [(s.word, s.start_frame, s.end_frame) for s in j.segments]
    assert h.score == pytest.approx(j.score, rel=1e-5)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    out = {}
    for name, (model, kind, extra, _) in CASES.items():
        fx = fixture.build(0, model=model, size=fixture.SMALL)
        root = str(tmp_path_factory.mktemp(name))
        kw = fixture.write_model_dir(fx, root, kind)
        extra = dict(extra)
        if extra.pop("lambda", False):
            lam = np.random.RandomState(5).uniform(0.2, 0.9, fx.mdef.n_sen)
            path = os.path.join(root, "lambda.txt")
            np.savetxt(path, lam)
            extra["lambda"] = path
        kw.update(extra)
        mfcs = []
        for i, c in enumerate(fx.ceps):
            mfcs.append(os.path.join(root, f"utt{i}.mfc"))
            write_mfc(mfcs[-1], c)
        out[name] = (fx, kw, mfcs, root)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_decoder_matches_reference(model_dirs, name):
    fx, kw, mfcs, root = model_dirs[name]
    jd = JaxDecoder(**kw)
    td = Decoder(device="cpu", **kw)
    want_cls = CASES[name][3]
    assert type(td.scorer).__name__ == type(jd.scorer).__name__ == want_cls
    for path, words in zip(mfcs, fx.transcripts):
        got, want = td.decode_cep_file(path), jd.decode_cep_file(path)
        _same(got, want)
        assert got.words == words
        assert td.hyp() is got and td.seg() == got.segments
    raw = os.path.join(root, "speech.raw")
    fixture.synthetic_pcm(sorted(CASES).index(name), 1.2).tofile(raw)
    got, want = td.decode_raw(raw), jd.decode_raw(raw)
    _same(got, want)
    assert td.fe.n_frames(os.path.getsize(raw) // 2) > 100


def test_feat_params_layering(model_dirs):
    fx, kw, _, _ = model_dirs["semi_8bit"]
    d = Decoder(device="cpu", **kw)
    # From the model's feat.params (hub4wsj_sc_8k's values).
    assert d.config["transform"] == "dct" and d.config["nfilt"] == 20
    assert d.config["cmninit"] == "56,-3,1"
    assert d.config["svspec"] == "0-12/13-25/26-38"
    assert [len(s) for s in d.fp.stream_slices()] == [13, 13, 13]
    # Explicit arguments win over feat.params.
    d2 = Decoder(device="cpu", transform="htk", nfilt=24, **kw)
    j2 = JaxDecoder(transform="htk", nfilt=24, **kw)
    assert (d2.config["transform"], d2.config["nfilt"]) == ("htk", 24)
    assert d2.config.asdict() == {k: v for k, v in j2.config.asdict().items()
                                  if k in d2.config}
    np.testing.assert_array_equal(d2.fe.dct.numpy(),
                                  j2.fe.dct.astype(np.float32))


def test_empty_utterances_match_reference(model_dirs):
    fx, kw, _, root = model_dirs["cont"]
    td, jd = Decoder(device="cpu", **kw), JaxDecoder(**kw)
    for d in (td, jd):
        d.start_utt()
        assert d.end_utt().score == float("-inf")        # nothing pushed
        d.start_utt()
        d.process_raw(np.zeros(0, np.int16))              # zero samples
        h = d.end_utt()
        assert (h.words, h.score, h.segments) == ([], float("-inf"), [])
        d.start_utt()
        d.process_cep(np.zeros((0, 13), np.float32))
        assert d.end_utt().score == float("-inf")
    assert td.hyp() == Hypothesis([], float("-inf"), [])


def test_utterance_state_and_unported_parts(model_dirs):
    fx, kw, mfcs, _ = model_dirs["cont"]
    d = Decoder(device="cpu", **kw)
    with pytest.raises(RuntimeError):
        d.end_utt()
    with pytest.raises(RuntimeError):
        d.process_raw(np.zeros(10))
    d.start_utt()
    with pytest.raises(RuntimeError):
        d.start_utt()
    d.abort_utt()
    assert d.hyp() is None and d.seg() == []
    # Streaming and the lattice results are ported: before any utterance
    # there is no lattice (the reference raises the same).
    for method in ("nbest", "get_lattice", "get_prob"):
        with pytest.raises(RuntimeError, match="no utterance"):
            getattr(d, method)()
    d.start_utt(streaming=True)
    with pytest.raises(RuntimeError):
        d.start_utt(streaming=True)
    d.abort_utt()
    # The alignment, grammar and allphone searches are ported
    # (test_torch_align and test_torch_grammar hold them to the
    # reference): align answers, and each search reads its file.
    ws, ps, states, score = d.align(d.fp.compute(fx.ceps[0]),
                                    fx.transcripts[0])
    assert [w.word for w in ws] == fx.transcripts[0] and np.isfinite(score)
    for key in ("fsg", "jsgf", "srgs", "cfg", "allphone"):
        with pytest.raises(OSError):
            Decoder(device="cpu", **{key: "x"}, **kw)
    with pytest.raises(ValueError):
        Decoder(device="cpu", lm=kw["lm"], dict=kw["dict"])
    # Without `device` it runs on the card, and never falls back to the CPU.
    assert inspect.signature(Decoder).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            Decoder(**kw)
    assert _table(DECODER_ARGS) == _table(JAX_DECODER_ARGS)


def test_cep_chunks_lmctl_mllr_and_add_word(model_dirs, tmp_path):
    fx, kw, mfcs, root = model_dirs["cont"]
    # Cepstra pushed in chunks decode as the whole utterance.
    d = Decoder(device="cpu", **kw)
    whole = d.decode_cep_file(mfcs[1])
    d.start_utt()
    for part in np.array_split(fx.ceps[1], 3):
        d.process_cep(part)
    _same(d.end_utt(), whole)
    # -lmctl / -lmname and set_lm.
    ctl = tmp_path / "lm.ctl"
    ctl.write_text(f"{kw['lm']} first\n{kw['lm']} second\n")
    base = {k: v for k, v in kw.items() if k != "lm"}
    lmd = Decoder(device="cpu", lmctl=str(ctl), lmname="second", **base)
    jlmd = JaxDecoder(lmctl=str(ctl), lmname="second", **base)
    assert lmd.lmset.current == jlmd.lmset.current == "second"
    lmd.set_lm("first")
    assert lmd.lmset.current == "first"
    _same(lmd.decode_cep_file(mfcs[1]), jlmd.decode_cep_file(mfcs[1]))
    # -mllr: a small shift of the static means, applied on load.
    D = fx.gauden.veclen[0]
    A = np.eye(D, dtype=np.float32)[None]
    b = np.full((1, D), 0.01, np.float32)
    mllr = str(tmp_path / "mllr")
    MllrTransform(A=[A], b=[b], h=[np.ones((1, D), np.float32)]).write(mllr)
    md, jmd = Decoder(device="cpu", mllr=mllr, **kw), JaxDecoder(mllr=mllr, **kw)
    _same(md.decode_cep_file(mfcs[0]), jmd.decode_cep_file(mfcs[0]))
    # add_word reaches the dictionary.
    n = md.dict.n_word
    md.add_word("newword", ["AA", "AE"])
    assert md.dict.n_word == n + 1 and md.dict.wordid("newword") >= 0
