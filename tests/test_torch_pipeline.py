"""Port parity for the front doors over the streaming path: the `Decoder`
streaming API, the VAD (`ContAD`), the push pipeline (`SpeechPipeline`),
the audio sources, and the two CLIs (`cli.batch`, `cli.continuous`),
against the JAX package on the same model directories (SMALL fixtures
written by `fixture.write_model_dir`) and the same audio.

Tolerances: words and segment frames equal; scores within rtol 1e-5 (the
scorers and the frontend differ by float32 summation order only, see
test_torch_api); the VAD, the sources and the logging and timing helpers
are host numpy and Python on both sides: equal.
"""

import os
import re

import numpy as np
import pytest
import torch

from cmusphinx_tpu.api import Decoder as JaxDecoder
from cmusphinx_tpu.cli import batch as jax_batch
from cmusphinx_tpu.cli import continuous as jax_continuous
from cmusphinx_tpu.frontend import source as jax_source
from cmusphinx_tpu.frontend import vad as jax_vad
from cmusphinx_tpu.parallel.hosts import partition_ctl as jax_partition_ctl
from cmusphinx_tpu.pipeline import SpeechPipeline as JaxPipeline
from cmusphinx_tpu.utils import log as jax_log
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.api import Decoder
from cmusphinx_tpu_torch.cli import batch, continuous
from cmusphinx_tpu_torch.frontend import source, vad
from cmusphinx_tpu_torch.pipeline import SpeechPipeline
from cmusphinx_tpu_torch.utils import log
from cmusphinx_tpu_torch.utils.bio import write_mfc
from cmusphinx_tpu_torch.utils.profile import Profile

NUM = re.compile(r"-?\d+(?:\.\d+)?")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    out = {}
    for model in ("cont", "semi"):
        fx = fixture.build(0, model=model, size=fixture.SMALL)
        root = tmp_path_factory.mktemp(model)
        kw = fixture.write_model_dir(fx, str(root))
        out[model] = (fx, kw, root)
    return out


def _same(h, j):
    assert h.words == j.words
    assert [(s.word, s.start_frame, s.end_frame) for s in h.segments] == \
        [(s.word, s.start_frame, s.end_frame) for s in j.segments]
    assert h.score == pytest.approx(j.score, rel=1e-5)


def _speech_with_gaps(seed: int = 0) -> np.ndarray:
    """Seeded PCM: low noise, a burst of speech-like sound, a pause longer
    than the VAD's offset, another burst, low noise."""
    rng = np.random.RandomState(seed)

    def quiet(s):
        return (rng.randn(int(s * 16000)) * 3).astype(np.int16)
    return np.concatenate([quiet(0.6), fixture.synthetic_pcm(seed, 1.1),
                           quiet(0.9), fixture.synthetic_pcm(seed + 1, 0.8),
                           quiet(0.7)])


@pytest.mark.parametrize("model", ["cont", "semi"])
def test_decoder_streaming_matches_reference(model_dirs, model):
    """Cepstra in 25-frame pieces (three utterances in a row: the live CMN
    and AGC state carries across them) and raw PCM in 0.25-s pieces:
    every partial and every final hypothesis as the JAX Decoder's."""
    fx, kw, _ = model_dirs[model]
    td, jd = Decoder(device="cpu", **kw), JaxDecoder(**kw)
    inputs = [("cep", c) for c in fx.ceps] + [
        ("raw", fixture.synthetic_pcm(5, 1.2).astype(np.float32))]
    for kind, data in inputs:
        step = 25 if kind == "cep" else 4000
        partials = []
        for d in (td, jd):
            d.start_utt(streaming=True)
            got = []
            for i in range(0, len(data), step):
                getattr(d, f"process_{kind}")(data[i: i + step])
                got.append(d.hyp())
            d.end_utt()
            partials.append(got)
        for h, j in zip(*partials, strict=True):
            _same(h, j)
        _same(td.hyp(), jd.hyp())
        assert td.seg() == td.hyp().segments
    # The live CMN mean, refreshed at each utterance's end (the raw
    # utterance's cepstra carry the frontend's tolerance).
    np.testing.assert_allclose(td.fp._cmn_mean, jd.fp._cmn_mean, rtol=1e-5,
                               atol=1e-6)
    # A stream can be abandoned and another started.
    td.start_utt(streaming=True)
    td.process_cep(fx.ceps[0][:60])
    td.abort_utt()
    td.start_utt(streaming=True)
    td.end_utt()
    assert td.hyp().words == [] and td.hyp().score == float("-inf")


def test_vad_and_sources_match_reference(tmp_path):
    pcm = _speech_with_gaps()
    segs = vad.segment_file(pcm.astype(np.float32))
    want = jax_vad.segment_file(pcm.astype(np.float32))
    assert len(segs) == len(want) == 2
    for a, b in zip(segs, want):
        assert (a.start_sample, a.end_sample) == (b.start_sample, b.end_sample)
        np.testing.assert_array_equal(a.data, b.data)
    # Streaming in uneven pieces gives the same segments.
    ad = vad.ContAD()
    got = []
    for piece in np.array_split(pcm.astype(np.float32), 13):
        got += ad.process(piece)
    got += ad.end_stream()
    assert [(s.start_sample, s.end_sample) for s in got] == \
        [(s.start_sample, s.end_sample) for s in segs]
    # The sources: raw, wav and pushed buffers read the same blocks.
    raw = tmp_path / "a.raw"
    pcm.tofile(raw)
    import wave
    wav = tmp_path / "a.wav"
    with wave.open(str(wav), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    for mk in (lambda m: m.RawFileSource(str(raw)),
               lambda m: m.WavFileSource(str(wav))):
        a, b = mk(source), mk(jax_source)
        assert a.sample_rate == b.sample_rate == 16000.0
        for n in (1000, 4000, 7):
            x, y = a.read(n), b.read(n)
            np.testing.assert_array_equal(x, y)
        assert np.array_equal(np.concatenate(list(a)), np.concatenate(list(b)))
        a.close(), b.close()
    buf = source.BufferSource()
    buf.push(pcm[:5000])
    assert buf.read(3000).shape == (3000,) and buf.read(3000).shape == (2000,)
    assert buf.read(10).shape == (0,)
    buf.end()
    assert buf.read(10) is None


@pytest.mark.parametrize("model", ["cont", "semi"])
def test_pipeline_matches_reference(model_dirs, model):
    fx, kw, _ = model_dirs[model]
    pcm = _speech_with_gaps(1).astype(np.float32)
    events = []
    for dec, Pipe, src in ((Decoder(device="cpu", **kw), SpeechPipeline,
                            source), (JaxDecoder(**kw), JaxPipeline,
                                      jax_source)):
        ev = []
        pipe = Pipe(dec, on_partial=lambda text, t: ev.append(("p", text, t)),
                    on_result=lambda h, t0, t1: ev.append(
                        ("r", h.words, h.score, t0, t1)))
        b = src.BufferSource()
        for piece in np.array_split(pcm, 7):
            b.push(piece)
        b.end()
        pipe.run(b)
        events.append(ev)
    got, want = events
    assert sum(e[0] == "r" for e in got) == 2
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a[:2] == b[:2]
        assert a[-2:] == b[-2:]
        if a[0] == "r":
            assert a[2] == pytest.approx(b[2], rel=1e-5)
    with pytest.raises(ValueError):
        SpeechPipeline(Decoder(device="cpu", **kw), sample_rate=8000)


def _read_outputs(d):
    """Every file the batch CLI wrote under `d`: name -> (the words, the
    numbers) of each line."""
    out = {}
    for root, _, files in os.walk(d):
        for f in sorted(files):
            rel = os.path.relpath(os.path.join(root, f), d)
            lines = open(os.path.join(root, f)).read().splitlines()
            out[rel] = [([w for w in ln.split() if not NUM.fullmatch(
                w.strip("()"))], [float(x) for x in NUM.findall(ln)])
                for ln in lines]
    return out


def test_batch_cli_matches_reference(model_dirs, tmp_path, capsys):
    fx, kw, root = model_dirs["cont"]
    ceps = tmp_path / "ceps"
    ceps.mkdir()
    for i, c in enumerate(fx.ceps):
        write_mfc(str(ceps / f"u{i}.mfc"), c)
    (ceps / "bad.mfc").write_bytes(b"\x10\x00\x00\x00garbage")
    ctl = tmp_path / "utts.ctl"
    ctl.write_text("u0\nbad\nu1\nu2\n")
    results = {}
    for name, main in (("port", batch.main), ("jax", jax_batch.main)):
        out = tmp_path / name
        (out / "lat").mkdir(parents=True)
        (out / "nbest").mkdir()
        argv = ["-hmm", kw["hmm"], "-lm", kw["lm"], "-dict", kw["dict"],
                "-ctl", str(ctl), "-cepdir", str(ceps), "-platform", "cpu",
                "-hyp", str(out / "hyp.txt"), "-hypseg", str(out / "seg.txt"),
                "-outlatdir", str(out / "lat"), "-nbest", "5",
                "-nbestdir", str(out / "nbest"), "-bestpath", "yes",
                "-beam", "1e-80", "-wbeam", "1e-60"]
        assert main(argv) == 0
        stdout = capsys.readouterr().out
        assert "SKIPPED 1: bad" in stdout
        results[name] = _read_outputs(out)
    got, want = results["port"], results["jax"]
    assert sorted(got) == sorted(want)
    assert "lat/u1.lat" in got and "nbest/u2.nbest" in got
    assert "lat/bad.lat" not in got
    for name in want:
        assert len(got[name]) == len(want[name]), name
        for (gw, gn), (ww, wn) in zip(got[name], want[name]):
            assert gw == ww, name
            # Frames and counts equal; scores (and link scores, in
            # logbase units) within rtol 1e-5.
            np.testing.assert_allclose(gn, wn, rtol=1e-5, atol=1.0,
                                       err_msg=name)
    hyps = [ln[0] for ln in got["hyp.txt"]]
    assert [h[:-1] for h in hyps] == [t for t in (fx.transcripts[0],
                                                  fx.transcripts[1],
                                                  fx.transcripts[2])]


def test_batch_cli_partitions(model_dirs, tmp_path, capsys, monkeypatch):
    items = [f"u{i}" for i in range(11)]
    for npart in (1, 3, 4):
        parts = [batch.partition_ctl(items, p, npart)
                 for p in range(1, npart + 1)]
        assert parts == [jax_partition_ctl(items, p, npart)
                         for p in range(1, npart + 1)]
        assert sum(parts, []) == items
    with pytest.raises(ValueError):
        batch.partition_ctl(items, 0, 3)
    assert batch.parse_argv(["-a", "1", "-b", "-c", "-5", "-d"]) == \
        jax_batch.parse_argv(["-a", "1", "-b", "-c", "-5", "-d"])
    fx, kw, _ = model_dirs["cont"]
    write_mfc(str(tmp_path / "u0.mfc"), fx.ceps[0])
    write_mfc(str(tmp_path / "u1.mfc"), fx.ceps[1])
    (tmp_path / "c.ctl").write_text("u0\nu1\n")
    argv = ["-hmm", kw["hmm"], "-lm", kw["lm"], "-dict", kw["dict"],
            "-ctl", str(tmp_path / "c.ctl"), "-cepdir", str(tmp_path),
            "-platform", "cpu"]
    assert batch.main(argv + ["-part", "2", "-npart", "2"]) == 0
    out = capsys.readouterr().out
    assert "u1: " in out and "u0: " not in out
    # One process and -npart without -part: the whole file, as the
    # reference decodes it on one host; several processes pick their part
    # (tests/test_torch_parallel.py runs two), and need a coordinator.
    assert batch.main(argv + ["-npart", "2"]) == 0
    out = capsys.readouterr().out
    assert "u0: " in out and "u1: " in out
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="coordinator"):
        batch.main(argv + ["-npart", "2"])
    assert batch.device_of({"platform": ""}) == "cuda"
    assert batch.device_of({"platform": "cpu"}) == "cpu"


def test_continuous_cli_matches_reference(model_dirs, tmp_path, capsys):
    fx, kw, _ = model_dirs["semi"]
    raw = tmp_path / "speech.raw"
    _speech_with_gaps(2).tofile(raw)
    outs = []
    for main in (continuous.main, jax_continuous.main):
        assert main(["-hmm", kw["hmm"], "-lm", kw["lm"], "-dict", kw["dict"],
                     "-infile", str(raw), "-partials", "yes",
                     "-platform", "cpu"]) == 0
        outs.append(capsys.readouterr().out.splitlines())
    assert outs[0] == outs[1]
    assert sum(ln.startswith("[") for ln in outs[0]) == 2


def test_log_and_profile_match_reference(tmp_path):
    for mod in (log, jax_log):
        path = tmp_path / f"{mod.__name__}.log"
        mod.err_set_logfile(str(path))
        old = mod.err_set_debug_level(2)
        mod.E_INFO("loaded %d senones", 5150)
        mod.E_DEBUG(1, "shown")
        mod.E_DEBUG(3, "hidden")
        mod.E_WARN("careful")
        mod.E_INFOCONT("more\n")
        with pytest.raises(mod.FatalError):
            mod.E_FATAL("stop %s", "now")
        mod.err_set_debug_level(old)
        mod.err_set_logfile(None)
    texts = [re.sub(r"line \d+", "line N", (tmp_path / f"{m.__name__}.log")
                    .read_text()) for m in (log, jax_log)]
    assert texts[0] == texts[1] and "hidden" not in texts[0]
    p = Profile()
    calls = []
    with p.timer("a"):
        pass
    t = p.timer("b").start()
    assert t.stop(sync=lambda: calls.append(1)) >= 0.0 and calls == [1]
    p.counter("utts").increment(3)
    rep = p.report(audio_seconds=2.0)
    assert rep.startswith("a: ") and "b: " in rep and rep.endswith("utts=3")
