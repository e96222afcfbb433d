"""The port's host tools against the JAX package's, on the same in-repo
inputs (the seeded fixtures of `cmusphinx_tpu_torch.fixture` and seeded
numpy): `utils/huff.py`, `models/lts.py` (also through
`Dictionary.set_lts`), `models/fst.py`, `models/htk.py`,
`models/phoenix.py`, `lm/idngram.py`, `lm/server.py`, `utils/mfu.py` (the
counters equal, the peaks the H100's) and every subcommand of
`cli/tools.py` and `cli/lmtool.py` run through both packages with
`-platform cpu`: the same exit code, the same standard output and the
same files, byte for byte.  The one exception is `tools fe`, whose
cepstra come from two frameworks' float32 frontends: they are held within
the frontend's bound (1e-4 on each log-mel value carried through |dct|
and the lifter, as in tests/test_torch_fe.py) and everything else it
prints and writes is equal."""

import io
import math
import os
import pathlib

import numpy as np
import pytest

from cmusphinx_tpu.cli import lmtool as j_lmtool
from cmusphinx_tpu.cli import tools as j_tools
from cmusphinx_tpu.lm import estimate as j_estimate
from cmusphinx_tpu.lm import idngram as j_idngram
from cmusphinx_tpu.lm import server as j_server
from cmusphinx_tpu.models import dict as j_dict
from cmusphinx_tpu.models import fsg as j_fsg
from cmusphinx_tpu.models import fst as j_fst
from cmusphinx_tpu.models import htk as j_htk
from cmusphinx_tpu.models import lts as j_lts
from cmusphinx_tpu.models import mdef as j_mdef
from cmusphinx_tpu.models import ngram as j_ngram
from cmusphinx_tpu.models import phoenix as j_phoenix
from cmusphinx_tpu.models import tmat as j_tmat
from cmusphinx_tpu.models.cfg import cfg_to_ngram as j_cfg_to_ngram
from cmusphinx_tpu.utils import huff as j_huff
from cmusphinx_tpu.utils import mfu as j_mfu
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.cli import lmtool as t_lmtool
from cmusphinx_tpu_torch.cli import tools as t_tools
from cmusphinx_tpu_torch.decode import NgramSearch
from cmusphinx_tpu_torch.frontend import FeatPipeline, Frontend
from cmusphinx_tpu_torch.frontend.fe import FE_ARGS
from cmusphinx_tpu_torch.lm import estimate as t_estimate
from cmusphinx_tpu_torch.lm import idngram as t_idngram
from cmusphinx_tpu_torch.lm import server as t_server
from cmusphinx_tpu_torch.models import dict as t_dict
from cmusphinx_tpu_torch.models import fsg as t_fsg
from cmusphinx_tpu_torch.models import fst as t_fst
from cmusphinx_tpu_torch.models import htk as t_htk
from cmusphinx_tpu_torch.models import lts as t_lts
from cmusphinx_tpu_torch.models import mdef as t_mdef
from cmusphinx_tpu_torch.models import ngram as t_ngram
from cmusphinx_tpu_torch.models import phoenix as t_phoenix
from cmusphinx_tpu_torch.models import tmat as t_tmat
from cmusphinx_tpu_torch.models.cfg import cfg_to_ngram as t_cfg_to_ngram
from cmusphinx_tpu_torch.ops import ContinuousScorer
from cmusphinx_tpu_torch.utils import huff as t_huff
from cmusphinx_tpu_torch.utils import mfu as t_mfu
from cmusphinx_tpu_torch.utils.bio import write_mfc
from cmusphinx_tpu_torch.utils.config import Config

J = {"dict": j_dict, "fsg": j_fsg, "fst": j_fst, "htk": j_htk,
     "idngram": j_idngram, "lts": j_lts, "mdef": j_mdef, "ngram": j_ngram,
     "phoenix": j_phoenix, "tmat": j_tmat, "estimate": j_estimate,
     "cfg_to_ngram": j_cfg_to_ngram, "huff": j_huff, "server": j_server,
     "tools": j_tools, "lmtool": j_lmtool}
T = {"dict": t_dict, "fsg": t_fsg, "fst": t_fst, "htk": t_htk,
     "idngram": t_idngram, "lts": t_lts, "mdef": t_mdef, "ngram": t_ngram,
     "phoenix": t_phoenix, "tmat": t_tmat, "estimate": t_estimate,
     "cfg_to_ngram": t_cfg_to_ngram, "huff": t_huff, "server": t_server,
     "tools": t_tools, "lmtool": t_lmtool}
PACKAGES = {"jax": J, "torch": T}

# A Phoenix task grammar in the phoenix_v0 format: nets, a net-local
# macro, optional (*) and repeated (+) tokens, a net reference.
GRA = """[Request]
 ( *please GOTO [Place] )
 ( take me to [Place] *now )
GOTO
 ( go to )
 ( head +over to )
;

[Place]
 ( the station )
 ( the *main library )
 ( home )
;
"""
FORMS = "FUNCTION: Request\nNETS:\n    [Request]\n;\n"
LOGMEL_TOL = 1e-4
# The lattice tools' wide beams (tests/test_torch_lattice.py).
WIDE = {"beam": 1e-120, "wbeam": 1e-100, "lw": 2.0}


def sentences(fx, n: int = 120, seed: int = 0):
    """The fixture's transcripts and n seeded sentences over its words."""
    vocab = [fx.dict.word_str(w) for w in range(fx.dict.n_word)
             if not fx.dict.is_filler(w)]
    rng = np.random.RandomState(seed)
    out = [list(t) for t in fx.transcripts]
    for _ in range(n):
        out.append([vocab[i] for i in rng.randint(len(vocab),
                                                  size=rng.randint(2, 8))])
    return out


def spelled(fx):
    """The fixture's dictionary as letter words: each pronunciation
    spelled by its phone names (so LTS has letters to learn from)."""
    out = {}
    for w in range(fx.dict.n_word):
        if fx.dict.is_filler(w):
            continue
        phones = [fx.mdef.ciname[p] for p in fx.dict.pron[w]]
        out.setdefault("".join(phones), phones)
    return sorted(out.items())


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Every tool's input files, under one directory `in/` that both
    packages' runs reach by the same relative path."""
    root = tmp_path_factory.mktemp("tools")
    d = root / "in"
    d.mkdir()
    fx = fixture.build(0, size=fixture.SMALL)
    kw = fixture.write_model_dir(fx, str(d / "model"))
    sents = sentences(fx)
    (d / "corpus.txt").write_text("".join(" ".join(s) + "\n"
                                          for s in sents))
    (d / "test.txt").write_text("".join(" ".join(s) + "\n"
                                        for s in sents[:20]))
    fx.lm.write_dmp(str(d / "lm.DMP"))
    t_estimate.train_lm([s[::-1] for s in sents], n=3).write_arpa(
        str(d / "b.arpa"))
    (d / "task.gra").write_text(GRA)
    (d / "task.forms").write_text(FORMS)
    (d / "task.cfg").write_text(
        "1.0 $START 2 $WHO $VERB\n0.5 $WHO 1 alice\n0.5 $WHO 2 bob too\n"
        "0.7 $VERB 1 runs\n0.3 $VERB 2 $VERB again\n")
    # Cepstra, PCM and its control file.
    write_mfc(str(d / "u0.mfc"), fx.ceps[0])
    (d / "pcm").mkdir()
    for i in range(3):
        fixture.synthetic_pcm(i, seconds=0.7 + 0.3 * i).tofile(
            str(d / "pcm" / f"p{i}.raw"))
    (d / "pcm.ctl").write_text("p0\np1\np2\n")
    # An id-3-gram file of the corpus, and an HTK MMF of the model.
    paths, _ = t_idngram.count_ngrams_disk(
        sents, sorted({w for s in sents for w in s}), n=3,
        max_ram_ngrams=100, tmpdir=str(root))
    os.replace(paths[2], d / "c.idngram")
    g = fx.gauden
    t_htk.write_mmf(str(d / "model.mmf"), fx.mdef, g,
                    np.exp(fx.ln_mixw.astype(np.float64)),
                    np.exp(fx.tmat.log_tp.astype(np.float64)))
    # Lattices of utterance 0 (sphinx and HTK SLF), from a CPU decode.
    sc = ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu")
    s = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, sc, device="cpu",
                    **WIDE)
    s.decode_batch_cep(fx.ceps[:1], FeatPipeline(fx.feat_config(),
                                                 device="cpu"))
    lat = s.get_lattice()
    lat.write(str(d / "u0.lat"), uttid="u0")
    lat.write_htk(str(d / "u0.slf"), uttid="u0")
    return root, fx, kw, sents


def run_both(cli: str, argv, root, monkeypatch, capsys) -> dict:
    """`cli` ("tools" or "lmtool") of each package on argv, from its own
    directory beside `in/`: (exit code, stdout, {file: bytes})."""
    out = {}
    for name, mods in PACKAGES.items():
        work = root / f"run_{name}"
        work.mkdir(exist_ok=True)
        for f in work.iterdir():
            f.unlink()
        monkeypatch.chdir(work)
        rc = mods[cli].main(list(argv))
        out[name] = (rc, capsys.readouterr().out,
                     {f.name: f.read_bytes() for f in sorted(work.iterdir())})
    return out


# ----------------------------------------------------------------------
def test_huff_matches_reference():
    rng = np.random.RandomState(0)
    ints = [int(s) for s in rng.zipf(1.5, 2000) % 50]
    words = [f"w{int(i)}" for i in rng.zipf(1.3, 500) % 40]
    for syms in (ints, words):
        freqs = {}
        for s in syms:
            freqs[s] = freqs.get(s, 0) + 1
        codes = []
        for mods in (J, T):
            hc = mods["huff"].HuffCode.build(freqs)
            data, nbits = hc.encode(syms)
            assert hc.decode(data, nbits) == syms
            fh = io.StringIO()
            hc.write(fh)
            again = mods["huff"].HuffCode.read(io.StringIO(fh.getvalue()))
            assert again.codes == hc.codes
            codes.append((hc.codes, data, nbits, fh.getvalue()))
        assert codes[0] == codes[1]


def test_lts_matches_reference_and_serves_the_dictionary(tmp_path):
    """Rules learnt from the MEDIUM fixture's 1,200 pronunciations (the
    SMALL one's 20 teach nothing), the same predictions, and words outside
    the dictionary added through its LTS fallback."""
    fx = fixture.build(0, size=fixture.MEDIUM)
    kw = fixture.write_model_dir(fx, str(tmp_path / "model"))
    entries = spelled(fx)
    held = entries[::7]
    train = [e for i, e in enumerate(entries) if i % 7]
    models = [mods["lts"].LtsModel.train(train, k=2) for mods in (J, T)]
    assert models[0].rules == models[1].rules and models[1].rules
    predicted = [models[1].predict(w) for w, _ in held]
    assert predicted == [models[0].predict(w) for w, _ in held]
    assert sum(p == want for p, (_, want) in zip(predicted, held)) > \
        len(held) // 2
    got = []
    for mods, lts in zip((J, T), models):
        mdef = mods["mdef"].Mdef.read(os.path.join(kw["hmm"], "mdef"))
        d = mods["dict"].Dictionary.read(kw["dict"], mdef)
        d.set_lts(lts)
        n = d.n_word
        wids = [d.wordid_or_lts(w) for w, _ in held]
        got.append((n, wids, [[int(p) for p in d.pron[w]] for w in wids]))
    assert got[0] == got[1]
    n, wids, prons = got[1]
    assert wids == list(range(n, n + len(held)))
    assert prons == [[fx.mdef.ciphone_id[p] for p in q] for q in predicted]
    # Saved, the rules are the same file, and load back.
    for name, m in (("j", models[0]), ("t", models[1])):
        m.save(str(tmp_path / f"lts_{name}.txt"))
    assert (tmp_path / "lts_j.txt").read_bytes() == \
        (tmp_path / "lts_t.txt").read_bytes()
    assert t_lts.LtsModel.load(str(tmp_path / "lts_t.txt")).rules == \
        models[1].rules


@pytest.mark.parametrize("what", ["fsg", "dict", "am", "lm"])
def test_fst_exports_match_reference(what, inputs, tmp_path):
    _, fx, kw, _ = inputs
    base = os.path.dirname(kw["hmm"])
    files = []
    for name, mods in PACKAGES.items():
        out = tmp_path / name
        out.mkdir()
        p, s1, s2 = str(out / "g.fst"), str(out / "a.sym"), str(out / "b.sym")
        if what == "fsg":
            g = mods["fsg"].FsgModel.read(os.path.join(base, "grammar.fsg"))
            mods["fst"].write_fsg_fst(g, p, symfile=s1)
        elif what == "dict":
            mdef = mods["mdef"].Mdef.read(os.path.join(kw["hmm"], "mdef"))
            d = mods["dict"].Dictionary.read(kw["dict"], mdef)
            mods["fst"].write_dict_fst(d, p, isymfile=s1, osymfile=s2)
        elif what == "am":
            mdef = mods["mdef"].Mdef.read(os.path.join(kw["hmm"], "mdef"))
            tmat = mods["tmat"].TransitionMatrices.read(
                os.path.join(kw["hmm"], "transition_matrices"))
            mods["fst"].write_am_fst(mdef, tmat, p, isymfile=s1,
                                     osymfile=s2, triphones=True)
        else:
            lm = mods["ngram"].NgramModel.read(kw["lm"])
            mods["fst"].write_lm_fst(lm, p, symfile=s1)
        files.append({f.name: f.read_bytes() for f in sorted(out.iterdir())})
        arcs, finals = mods["fst"].read_fst(p)
        assert arcs and finals
    assert files[0] == files[1]


def test_htk_round_trip_matches_reference(inputs, tmp_path):
    root, fx, _, _ = inputs
    g = fx.gauden
    mixw = np.exp(fx.ln_mixw.astype(np.float64))
    tp = np.exp(fx.tmat.log_tp.astype(np.float64))
    dirs, mdefs = [], []
    for name, mods in PACKAGES.items():
        mmf = tmp_path / f"{name}.mmf"
        mods["htk"].write_mmf(str(mmf), fx.mdef, g, mixw, tp)
        assert mmf.read_bytes() == (root / "in" / "model.mmf").read_bytes()
        out = tmp_path / f"{name}_s3"
        mdefs.append(mods["htk"].convert_htk(str(mmf), str(out)))
        dirs.append({f.name: f.read_bytes() for f in sorted(out.iterdir())})
    assert dirs[0] == dirs[1] and "mdef" in dirs[1]
    a, b = mdefs
    assert (a.n_ciphone, a.n_phone, a.n_sen, a.n_tmat) == \
        (b.n_ciphone, b.n_phone, b.n_sen, b.n_tmat)
    # The round trip keeps the CI phones (HTK's `lc-base+rc` names carry
    # no word position, so triphones of several positions merge).
    assert b.ciname == fx.mdef.ciname


def test_phoenix_matches_reference(tmp_path):
    out = []
    for name, mods in PACKAGES.items():
        g = mods["phoenix"].PhoenixGrammar.parse(GRA)
        (tmp_path / "f.forms").write_text(FORMS)
        forms = mods["phoenix"].read_forms(str(tmp_path / "f.forms"))
        cfg = g.to_cfg(forms)
        lm = mods["cfg_to_ngram"](cfg, samples=300, seed=0)
        lm.write_arpa(str(tmp_path / f"{name}.arpa"))
        fh = io.StringIO()
        cfg.to_fsg(max_expansion=2).write(fh)
        out.append((g.nets, g.macros, g.net_order, forms,
                    [(r.lhs, r.score, r.rhs) for r in cfg.rules],
                    (tmp_path / f"{name}.arpa").read_text(), fh.getvalue()))
    assert out[0] == out[1]
    assert out[1][3] == ["Request"] and "go" in out[1][5]


def test_idngram_matches_reference_and_memory_counts(inputs, tmp_path):
    _, _, _, sents = inputs
    vocab = sorted({w for s in sents for w in s})
    mem, mem_words = t_estimate.count_ngrams(sents, vocab, n=3)
    res = []
    for name, mods in PACKAGES.items():
        work = tmp_path / name
        work.mkdir()
        paths, words = mods["idngram"].count_ngrams_disk(
            sents, vocab, n=3, max_ram_ngrams=50, tmpdir=str(work))
        counts = mods["idngram"].load_idngram_counts(paths)
        assert words == mem_words and counts == mem
        two = str(work / "c.2gram")
        nd = mods["idngram"].ngram_to_mgram(paths[2], two, n=3, m=2)
        stats = mods["idngram"].idngram_stats(paths[2], n=3, fof_size=10)
        lm = mods["idngram"].train_lm_disk(sents, vocab, n=3,
                                           max_ram_ngrams=50,
                                           tmpdir=str(work))
        lm.write_arpa(str(work / "lm.arpa"))
        res.append(([pathlib.Path(p).read_bytes() for p in paths], nd,
                    pathlib.Path(two).read_bytes(), stats[:2],
                    stats[2].tolist(), (work / "lm.arpa").read_text(),
                    mods["idngram"].text_to_wngram(sents, n=3,
                                                   sent_markers=True)))
    assert res[0] == res[1]
    # The 2-grams of the 3-gram file sum its counts by prefix.
    assert sum(c for _, c in t_idngram.read_idngram(
        str(tmp_path / "torch" / "c.2gram"), 2)) == res[1][3][1]


def test_lm_server_protocol_matches_reference(inputs):
    _, fx, kw, sents = inputs
    lms = {name: mods["ngram"].NgramModel.read(kw["lm"])
           for name, mods in PACKAGES.items()}
    servers = {name: PACKAGES[name]["server"].LmServer(lms[name], port=0)
               for name in PACKAGES}
    for srv in servers.values():
        srv.start()
    clients = []
    try:
        queries = [s[-k:] for s in sents[:30] for k in (1, 2, 3)
                   if len(s) >= k] + [["nosuchword"], [sents[0][0], "zz"]]
        answers = {}
        for name, srv in servers.items():
            for cname, mods in PACKAGES.items():
                c = mods["server"].NetworkLm("127.0.0.1", srv.port)
                clients.append(c)
                answers[(name, cname)] = [c.log10_prob(q) for q in queries]
                assert c.log10_prob(queries[0]) == answers[(name, cname)][0]
            assert [srv.score_log10(q) for q in queries] == [
                servers["jax"].score_log10(q) for q in queries]
        first = answers[("jax", "jax")]
        assert all(a == first for a in answers.values())
        assert first[-2] == t_server.NetworkLm.LOG_ZERO
        i = next(i for i, q in enumerate(queries) if len(q) == 3)
        ids = [lms["torch"].word_id(w) for w in queries[i]]
        assert first[i] == pytest.approx(
            lms["torch"].tg_score(*ids) / math.log(10.0), abs=1e-6)
    finally:
        for c in clients:
            c.close()
        for srv in servers.values():
            srv.stop()


def test_mfu_counters_match_reference_and_peaks_are_the_h100s():
    for T_, S, K, D in ((2000, 5150, 32, 39), (50, 96, 4, 39),
                        (9600, 5150, 32, 64)):
        assert t_mfu.continuous_gmm_flops(T_, S, K, D) == \
            j_mfu.continuous_gmm_flops(T_, S, K, D)
        for fused in (False, True):
            assert t_mfu.continuous_gmm_bytes(T_, S, K, D, fused) == \
                j_mfu.continuous_gmm_bytes(T_, S, K, D, fused)
        assert t_mfu.psparity_flops(T_, 3, 256, [13, 13, 13], S, 4) == \
            j_mfu.psparity_flops(T_, 3, 256, [13, 13, 13], S, 4)
        assert t_mfu.viterbi_scan_bytes(T_, 300, 3, B=16) == \
            j_mfu.viterbi_scan_bytes(T_, 300, 3, B=16)
        assert t_mfu.onehot_scan_flops(T_, 1e6, B=4) == \
            j_mfu.onehot_scan_flops(T_, 1e6, B=4)
    assert (t_mfu.H100_PEAK_BF16, t_mfu.H100_PEAK_TF32, t_mfu.H100_PEAK_F32,
            t_mfu.H100_HBM_BW) == (989e12, 495e12, 67e12, 3.35e12)
    assert not [n for n in dir(t_mfu) if "V5E" in n or "TPU" in n]
    assert t_mfu.PEAK_FLOPS[t_mfu.K1_PRECISION["highest"]] == 495e12 / 3
    st = t_mfu.Stage("K1", 2.919e-3, t_mfu.continuous_gmm_flops(
        9600, 5150, 32, 39), t_mfu.continuous_gmm_bytes(9600, 5150, 32, 39,
                                                        True), "x",
        "3xtf32")
    assert st.adjusted_mfu == pytest.approx(3 * st.mfu * 989 / 495)
    rep = t_mfu.report([st])
    assert "| K1 | 2.919 |" in rep and "3xtf32" in rep


# ----------------------------------------------------------------------
# The command-line tools through both packages.  Paths are relative to
# the run's directory: the inputs are under ../in.
M = "../in/model"
TOOLS = {
    "cepview": ["cepview", "-f", "../in/u0.mfc", "-d", "13"],
    "jsgf2fsg": ["jsgf2fsg", "-jsgf", f"{M}/grammar.jsgf", "-fsg", "g.fsg"],
    "pitch": ["pitch", "-i", "../in/pcm/p1.raw", "-o", "p.f0"],
    "htk2s3": ["htk2s3", "-i", "../in/model.mmf", "-o", "."],
    "cfg2fsg": ["cfg2fsg", "-cfg", "../in/task.cfg", "-fsg", "c.fsg"],
    "mdef_convert_bin": ["mdef_convert", "-i", f"{M}/hmm/mdef",
                         "-o", "mdef.bin"],
    "mdef_convert_text": ["mdef_convert", "-i", f"{M}/hmm/mdef",
                          "-o", "mdef.txt", "-text", "yes"],
    "lm_convert_dmp": ["lm_convert", "-i", f"{M}/lm.arpa", "-o", "lm.DMP"],
    "lm_convert_arpa": ["lm_convert", "-i", "../in/lm.DMP", "-o", "b.lm",
                        "-ofmt", "arpa"],
    "lm_eval": ["lm_eval", "-lm", f"{M}/lm.arpa", "-text",
                "../in/test.txt"],
    "lm2fst": ["lm2fst", "-i", f"{M}/lm.arpa", "-o", "lm.fst",
               "-syms", "lm.syms"],
    "am2fst": ["am2fst", "-mdef", f"{M}/hmm/mdef", "-tmat",
               f"{M}/hmm/transition_matrices", "-fst", "am.fst", "-isym",
               "am.isym", "-osym", "am.osym"],
    "fsg2fst": ["fsg2fst", "-i", f"{M}/grammar.fsg", "-o", "g.fst",
                "-syms", "g.syms"],
    "compile_gra": ["compile_gra", "-gra", "../in/task.gra", "-forms",
                    "../in/task.forms", "-corpus", "c.txt", "-n", "40",
                    "-lm", "g.arpa", "-samples", "300", "-fsg", "g.fsg"],
    "dag": ["dag", "-lat", "../in/u0.lat", "-lm", f"{M}/lm.arpa",
            "-lw", "2.0"],
    "astar": ["astar", "-lat", "../in/u0.lat", "-lm", f"{M}/lm.arpa",
              "-lw", "2.0", "-n", "5"],
    "conf": ["conf", "-lat", "../in/u0.lat", "-lm", f"{M}/lm.arpa",
             "-lw", "2.0"],
    "dag_slf": ["dag", "-lat", "../in/u0.slf"],
    "astar_slf": ["astar", "-lat", "../in/u0.slf", "-lm", f"{M}/lm.arpa",
                  "-n", "3"],
}
LMTOOL = {
    "train": ["train", "-text", "../in/corpus.txt", "-lm", "t.arpa",
              "-n", "3"],
    "train_wb": ["train", "-text", "../in/corpus.txt", "-lm", "t.DMP",
                 "-n", "2", "-discount", "witten_bell", "-cutoffs", "0,1"],
    "convert": ["convert", "-i", f"{M}/lm.arpa", "-o", "c.DMP"],
    "eval": ["eval", "-lm", f"{M}/lm.arpa", "-text", "../in/test.txt"],
    "text2wngram": ["text2wngram", "-text", "../in/corpus.txt", "-o",
                    "w.wngram", "-n", "2"],
    "ngram2mgram": ["ngram2mgram", "-i", "../in/c.idngram", "-o",
                    "c.2gram", "-n", "3", "-m", "2"],
    "idngram2stats": ["idngram2stats", "-i", "../in/c.idngram", "-n", "3",
                      "-fof_size", "10"],
    "arpa2binlm": ["arpa2binlm", "-arpa", f"{M}/lm.arpa", "-binary",
                   "x.DMP"],
    "binlm2arpa": ["binlm2arpa", "-binary", "../in/lm.DMP", "-arpa",
                   "y.arpa"],
    "interpolate": ["interpolate", "-lms", f"{M}/lm.arpa,../in/b.arpa",
                    "-weights", "0.6,0.4", "-lm", "i.arpa"],
}


@pytest.mark.parametrize("cli,case", [("tools", c) for c in TOOLS]
                         + [("lmtool", c) for c in LMTOOL])
def test_cli_matches_reference(cli, case, inputs, monkeypatch, capsys):
    argv = (TOOLS if cli == "tools" else LMTOOL)[case] + ["-platform", "cpu"]
    if cli == "lmtool":
        argv = argv[:-2]           # lmtool takes no -platform
    out = run_both(cli, argv, inputs[0], monkeypatch, capsys)
    assert out["torch"][0] == 0
    assert out["torch"] == out["jax"]
    assert out["torch"][1].strip()


def test_tools_fe_matches_reference(inputs, monkeypatch, capsys):
    """`fe` over a control file and on one file: the same lines printed,
    the same files written, the cepstra within the frontend's bound."""
    root = inputs[0]
    fe = Frontend(Config(FE_ARGS), device="cpu")
    b = np.full(fe.nfilt, LOGMEL_TOL) @ np.abs(fe.dct.numpy().astype(
        np.float64))
    if fe.lifter is not None:
        b = b * np.abs(fe.lifter.numpy())
    for argv in (["fe", "-c", "../in/pcm.ctl", "-di", "../in/pcm", "-do",
                  ".", "-ei", "raw", "-eo", "mfc", "-platform", "cpu"],
                 ["fe", "-i", "../in/pcm/p2.raw", "-o", "one.mfc",
                  "-platform", "cpu"]):
        out = run_both("tools", argv, root, monkeypatch, capsys)
        (jrc, jout, jfiles), (trc, tout, tfiles) = out["jax"], out["torch"]
        assert (trc, tout, sorted(tfiles)) == (jrc, jout, sorted(jfiles))
        assert trc == 0 and tfiles
        for name in tfiles:
            want = np.frombuffer(jfiles[name][4:], "<f4").reshape(-1, 13)
            got = np.frombuffer(tfiles[name][4:], "<f4").reshape(-1, 13)
            assert jfiles[name][:4] == tfiles[name][:4]
            assert got.shape == want.shape and len(got)
            err = np.abs(got.astype(np.float64) - want)
            assert np.all(err <= b), (name, float(err.max()))
