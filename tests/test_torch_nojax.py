"""The port runs on a machine without JAX: it imports none, and nothing of
the reference package either."""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

_DECODE_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["cmusphinx_tpu"] = None  # and any of the reference package
import numpy as np
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.decode import NgramSearch
from cmusphinx_tpu_torch.frontend import FeatPipeline
from cmusphinx_tpu_torch.ops import ContinuousScorer
fx = fixture.build(0, size=fixture.SMALL)
sc = ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu")
s = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, sc, device="cpu")
hyps = s.decode_batch_cep(fx.ceps, FeatPipeline(fx.feat_config(), device="cpu"))
ok = [[h.words for h in hyps] == fx.transcripts]
# The large-vocabulary searches: static-senone flat and prefix tree over
# the hashed and row LM backends.
m = fixture.build(0, size=fixture.MEDIUM)
msc = ContinuousScorer(m.gauden, m.ln_mixw, device="cpu")
mfp = FeatPipeline(m.feat_config(), device="cpu")
for lex in ("flat", "tree"):
    ms = NgramSearch(m.lm, m.dict, m.mdef, m.tmat, msc, device="cpu",
                     lexmode=lex)
    ok.append([h.words for h in ms.decode_batch_cep(m.ceps, mfp)]
              == m.transcripts)
assert not any(m.split(".")[0] in ("jax", "cmusphinx_tpu")
               for m in sys.modules if sys.modules[m] is not None)
print("WORDS", ok)
"""


def test_decodes_with_jax_blocked():
    # One intra-op thread: the decode is many small ops a frame, and more
    # threads only contend with the other test workers.
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _DECODE_WITHOUT_JAX], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "WORDS [True, True, True]" in r.stdout


_DECODER_WITHOUT_JAX = r"""
import sys, tempfile
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["cmusphinx_tpu"] = None  # and any of the reference package
import numpy as np
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.utils.bio import write_mfc
from cmusphinx_tpu_torch.api import Decoder
ok = []
for model in ("cont", "semi"):
    fx = fixture.build(0, model=model, size=fixture.SMALL)
    with tempfile.TemporaryDirectory() as tmp:
        d = Decoder(device="cpu", **fixture.write_model_dir(fx, tmp))
        write_mfc(tmp + "/u.mfc", fx.ceps[0])
        ok.append(d.decode_cep_file(tmp + "/u.mfc").words == fx.transcripts[0])
        np.zeros(4000, np.int16).tofile(tmp + "/s.raw")
        d.decode_raw(tmp + "/s.raw")
        ok.append(type(d.scorer).__name__)
assert not any(m.split(".")[0] in ("jax", "cmusphinx_tpu")
               for m in sys.modules if sys.modules[m] is not None)
print("DECODER", ok)
"""


def test_decoder_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _DECODER_WITHOUT_JAX], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "DECODER [True, 'ContinuousScorer', True, 'PsParityScorer']" \
        in r.stdout


_STREAM_WITHOUT_JAX = r"""
import sys, tempfile
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["cmusphinx_tpu"] = None  # and any of the reference package
import numpy as np
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.api import Decoder
from cmusphinx_tpu_torch.cli import batch, continuous
from cmusphinx_tpu_torch.pipeline import SpeechPipeline
from cmusphinx_tpu_torch.utils import native
from cmusphinx_tpu_torch.utils.bio import write_mfc
fx = fixture.build(0, size=fixture.SMALL)
ok = []
with tempfile.TemporaryDirectory() as tmp:
    kw = fixture.write_model_dir(fx, tmp)
    d = Decoder(device="cpu", bestpath=True, **kw)
    d.start_utt(streaming=True)
    for part in np.array_split(fx.ceps[0], 5):
        d.process_cep(part)
        d.hyp()
    ok.append(len(d.end_utt().words) > 0)
    ok.append(len(d.nbest(3)) >= 1 and 0.0 < d.get_prob() <= 1.0)
    write_mfc(tmp + "/u.mfc", fx.ceps[1])
    open(tmp + "/c.ctl", "w").write("u\n")
    ok.append(batch.main(["-hmm", kw["hmm"], "-lm", kw["lm"], "-dict",
                          kw["dict"], "-ctl", tmp + "/c.ctl", "-cepdir", tmp,
                          "-outlatdir", tmp, "-platform", "cpu"]) == 0)
    fixture.synthetic_pcm(0, 1.0).tofile(tmp + "/s.raw")
    ok.append(continuous.main(["-hmm", kw["hmm"], "-lm", kw["lm"], "-dict",
                               kw["dict"], "-infile", tmp + "/s.raw",
                               "-platform", "cpu"]) == 0)
    ok.append(native.loaded())
assert not any(m.split(".")[0] in ("jax", "cmusphinx_tpu")
               for m in sys.modules if sys.modules[m] is not None)
print("STREAM", ok)
"""


def test_stream_results_and_clis_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _STREAM_WITHOUT_JAX], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "STREAM [True, True, True, True, True]" in r.stdout


def test_no_source_file_imports_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    files = sorted((ROOT / "cmusphinx_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_profile.py"]
    assert len(files) > 10
    bad = [str(f) for f in files if pat.search(f.read_text())]
    assert not bad, bad


_SEARCHES_WITHOUT_JAX = r"""
import sys, tempfile
sys.modules["jax"] = None          # any import of jax now raises
sys.modules["cmusphinx_tpu"] = None  # and any of the reference package
import numpy as np
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.api import Decoder
from cmusphinx_tpu_torch.decode.phone_loop import PhoneLoopSearch
from cmusphinx_tpu_torch.utils.bio import write_mfc
fx = fixture.build(0, size=fixture.SMALL)
ok = []
with tempfile.TemporaryDirectory() as tmp:
    kw = fixture.write_model_dir(fx, tmp)
    write_mfc(tmp + "/u.mfc", fx.ceps[0])
    for key in ("jsgf", "fsg"):
        d = Decoder(device="cpu", hmm=kw["hmm"], dict=kw["dict"],
                    **{key: tmp + "/grammar." + key})
        h = d.decode_cep_file(tmp + "/u.mfc")
        ok.append(h.words == fx.transcripts[0]
                  == d.get_lattice().bestpath().words)
        st = d.search.stream_start()
        d.search.stream_push(st, d.fp.compute(fx.ceps[0]))
        ok.append(d.search.stream_end(st).words == fx.transcripts[0])
    d = Decoder(device="cpu", **kw)
    ws, *_ = d.align(d.fp.compute(fx.ceps[0]), fx.transcripts[0])
    ok.append([w.word for w in ws] == fx.transcripts[0])
    a = Decoder(device="cpu", hmm=kw["hmm"], allphone="uniform", lw=3.0)
    ok.append(len(a.decode_cep_file(tmp + "/u.mfc").words) > 0)
    pl = PhoneLoopSearch(d.mdef, d.tmat, d.scorer, device="cpu")
    ok.append(bool(pl.lookahead_mask(d.fp.compute(fx.ceps[0])).any(1).all()))
assert not any(m.split(".")[0] in ("jax", "cmusphinx_tpu")
               for m in sys.modules if sys.modules[m] is not None)
print("SEARCHES", ok)
"""


def test_grammar_align_allphone_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _SEARCHES_WITHOUT_JAX], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "SEARCHES [True, True, True, True, True, True, True]" in r.stdout
