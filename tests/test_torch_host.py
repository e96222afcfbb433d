"""The port's own copies of the host modules (model readers and writers,
the grammar models, binary I/O, configuration, the LM estimator, the
lexicon-graph builder, the frontend's pitch tracker and CDCN, and the
trainer's numpy code: sentence HMMs, model export, decision trees and the
copied functions of the pipeline, the transforms, semi-continuous training
and MMIE)
read and build exactly what the reference package's originals do, no
file of the port imports JAX, optax or the reference package, and the port
has a counterpart of every module of the reference package."""

import ast
import dataclasses
import io
import os
import pathlib

import numpy as np
import pytest

from cmusphinx_tpu.decode import lexgraph as j_lexgraph
from cmusphinx_tpu.frontend import cdcn as j_cdcn
from cmusphinx_tpu.frontend import pitch as j_pitch
from cmusphinx_tpu.lm import estimate as j_estimate
from cmusphinx_tpu.models import cfg as j_cfg
from cmusphinx_tpu.models import dict as j_dict
from cmusphinx_tpu.models import dict2pid as j_dict2pid
from cmusphinx_tpu.models import fsg as j_fsg
from cmusphinx_tpu.models import gauden as j_gauden
from cmusphinx_tpu.models import jsgf as j_jsgf
from cmusphinx_tpu.models import lmset as j_lmset
from cmusphinx_tpu.models import mdef as j_mdef
from cmusphinx_tpu.models import mllr as j_mllr
from cmusphinx_tpu.models import ngram as j_ngram
from cmusphinx_tpu.models import sendump as j_sendump
from cmusphinx_tpu.models import tmat as j_tmat
from cmusphinx_tpu.train import dtree as j_dtree
from cmusphinx_tpu.train import mmie as j_mmie
from cmusphinx_tpu.train import model_io as j_model_io
from cmusphinx_tpu.train import pipeline as j_pipeline
from cmusphinx_tpu.train import semicont as j_semicont
from cmusphinx_tpu.train import sentence_hmm as j_sentence_hmm
from cmusphinx_tpu.train import trainer as j_trainer
from cmusphinx_tpu.train import transform as j_transform
from cmusphinx_tpu.utils import bio as j_bio
from cmusphinx_tpu.utils import config as j_config
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.decode import lexgraph as t_lexgraph
from cmusphinx_tpu_torch.decode.ngram_search import NgramVocab
from cmusphinx_tpu_torch.frontend import cdcn as t_cdcn
from cmusphinx_tpu_torch.frontend import pitch as t_pitch
from cmusphinx_tpu_torch.frontend.feat import FEAT_ARGS
from cmusphinx_tpu_torch.lm import estimate as t_estimate
from cmusphinx_tpu_torch.models import cfg as t_cfg
from cmusphinx_tpu_torch.models import dict as t_dict
from cmusphinx_tpu_torch.models import dict2pid as t_dict2pid
from cmusphinx_tpu_torch.models import fsg as t_fsg
from cmusphinx_tpu_torch.models import gauden as t_gauden
from cmusphinx_tpu_torch.models import jsgf as t_jsgf
from cmusphinx_tpu_torch.models import lmset as t_lmset
from cmusphinx_tpu_torch.models import mdef as t_mdef
from cmusphinx_tpu_torch.models import mllr as t_mllr
from cmusphinx_tpu_torch.models import ngram as t_ngram
from cmusphinx_tpu_torch.models import sendump as t_sendump
from cmusphinx_tpu_torch.models import tmat as t_tmat
from cmusphinx_tpu_torch.train import dtree as t_dtree
from cmusphinx_tpu_torch.train import mmie as t_mmie
from cmusphinx_tpu_torch.train import model_io as t_model_io
from cmusphinx_tpu_torch.train import pipeline as t_pipeline
from cmusphinx_tpu_torch.train import semicont as t_semicont
from cmusphinx_tpu_torch.train import sentence_hmm as t_sentence_hmm
from cmusphinx_tpu_torch.train import trainer as t_trainer
from cmusphinx_tpu_torch.train import transform as t_transform
from cmusphinx_tpu_torch.utils import bio as t_bio
from cmusphinx_tpu_torch.utils import config as t_config

ROOT = pathlib.Path(__file__).resolve().parent.parent


def assert_same(a, b, path="obj", seen=None):
    """a (the reference's object) and b (the port's) hold equal values:
    arrays of one dtype and shape with equal elements, and objects of
    classes of one name with equal attributes, recursively."""
    seen = set() if seen is None else seen
    if (id(a), id(b)) in seen:
        return
    seen.add((id(a), id(b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]", seen)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]", seen)
    elif isinstance(a, type):
        assert a.__name__ == b.__name__, path
    elif hasattr(a, "__dict__") and not callable(a):
        assert type(a).__name__ == type(b).__name__, path
        assert type(b).__module__.startswith("cmusphinx_tpu_torch."), path
        assert_same(vars(a), vars(b), path, seen)
    elif isinstance(a, float) and a != a:
        assert b != b, path
    else:
        assert type(a) is type(b) and a == b, f"{path}: {a!r} != {b!r}"


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """The SMALL continuous, semi-continuous (8-bit sendump) and s2_4x
    (4-bit sendump) fixtures written as model directories."""
    root = tmp_path_factory.mktemp("host")
    out = {}
    for model in ("cont", "semi", "s2_4x"):
        fx = fixture.build(0, model=model, size=fixture.SMALL)
        out[model] = (fx, fixture.write_model_dir(fx, str(root / model)))
    return out


def _lmset_files(fx, base):
    """An lmctl naming two LMs, one of them with a word expanded into a
    class from a probdef file."""
    other = t_estimate.train_lm([s[::-1] for s in fx.transcripts], n=3)
    fx.lm.write_arpa(os.path.join(base, "a.arpa"))
    other.write_arpa(os.path.join(base, "b.arpa"))
    tag = fx.transcripts[0][0]
    with open(os.path.join(base, "cls.probdef"), "w") as fh:
        fh.write(f"LMCLASS {tag}\nalpha 0.25\nbeta\ngamma\nEND {tag}\n")
    with open(os.path.join(base, "set.lmctl"), "w") as fh:
        fh.write("{ cls.probdef }\na.arpa first { " + tag + " }\n"
                 "b.arpa second\n")
    return os.path.join(base, "set.lmctl")


def _read(case, mods, model_dirs, tmp):
    """What one module of one package (mods: the reference's or the
    port's modules by short name) reads from the fixture files."""
    fx, kw = model_dirs["semi" if case.startswith("sendump") else "cont"]
    hmm = kw["hmm"]
    if case == "mdef":
        text = mods["mdef"].Mdef.read(os.path.join(hmm, "mdef"))
        binary = os.path.join(tmp, f"mdef.{mods['tag']}.bin")
        text.write_binary(binary)
        return text, mods["mdef"].Mdef.read(binary), open(binary, "rb").read()
    if case == "dict":
        mdef = mods["mdef"].Mdef.read(os.path.join(hmm, "mdef"))
        return mods["dict"].Dictionary.read(kw["dict"], mdef)
    if case == "dict2pid":
        mdef = mods["mdef"].Mdef.read(os.path.join(hmm, "mdef"))
        d = mods["dict"].Dictionary.read(kw["dict"], mdef)
        return mods["dict2pid"].Dict2Pid(mdef, d)
    if case == "tmat":
        return mods["tmat"].TransitionMatrices.read(
            os.path.join(hmm, "transition_matrices"))
    if case == "gauden":
        return mods["gauden"].read_gauden(os.path.join(hmm, "means"),
                                       os.path.join(hmm, "variances"))
    if case == "mixture_weights":
        return mods["sendump"].read_mixture_weights(
            os.path.join(hmm, "mixture_weights"))
    if case in ("sendump8", "sendump4"):
        fx, kw = model_dirs["semi" if case == "sendump8" else "s2_4x"]
        path = os.path.join(kw["hmm"], "sendump")
        again = os.path.join(tmp, f"sendump.{mods['tag']}")
        mods["sendump"].write_sendump(again, fx.ln_mixw, n_bits=fx.sendump_bits)
        return (mods["sendump"].read_sendump(path),
                mods["sendump"].read_sendump(path, return_raw=True),
                open(again, "rb").read())
    if case == "ngram":
        arpa = mods["ngram"].NgramModel.read(kw["lm"])
        dmp = os.path.join(tmp, f"lm.{mods['tag']}.dmp")
        arpa.write_dmp(dmp)
        return arpa, mods["ngram"].NgramModel.read(dmp), open(dmp, "rb").read()
    if case == "lmset":
        path = _lmset_files(fx, tmp)
        return mods["lmset"].NgramModelSet.read_lmctl(path, basedir=tmp)
    if case == "mllr":
        rng = np.random.RandomState(3)
        path = os.path.join(tmp, f"mllr.{mods['tag']}")
        mods["mllr"].MllrTransform(
            A=[rng.randn(2, 13, 13).astype(np.float32)],
            b=[rng.randn(2, 13).astype(np.float32)],
            h=[np.ones((2, 13), np.float32)]).write(path)
        return mods["mllr"].MllrTransform.read(path), open(path, "rb").read()
    if case == "config":
        arg = mods["config"].Arg
        table = [arg(*dataclasses.astuple(a)) for a in FEAT_ARGS]
        cfg = mods["config"].Config(table, cmn="prior")
        cfg.update_from_file(os.path.join(hmm, "feat.params"))
        return cfg
    if case == "bio":
        path = os.path.join(tmp, f"u.{mods['tag']}.mfc")
        mods["bio"].write_mfc(path, fx.ceps[0])
        s3 = mods["bio"].S3File.open(os.path.join(hmm, "means"))
        with s3.fh:
            head = (s3.hdr, s3.swap, s3.read_int32(4), s3.read_float32(8))
        return mods["bio"].read_mfc(path), head, open(path, "rb").read()
    base = os.path.dirname(kw["lm"])
    if case == "fsg":
        fsg = mods["fsg"].FsgModel.read(os.path.join(base, "grammar.fsg"))
        buf = io.StringIO()
        fsg.write(buf)
        fsg.add_silence("<sil>", -1, 0.005)
        fsg.add_alt(fx.transcripts[0][0], "alt(2)")
        return fsg, fsg.null_closure(), buf.getvalue(), fsg.accept(
            fx.transcripts[1])
    if case == "jsgf":
        path = os.path.join(base, "grammar.jsgf")
        gram = mods["jsgf"].JsgfGrammar.parse_file(path)
        return (gram, gram.build_fsg(), mods["jsgf"].jsgf_read_file(path),
                mods["jsgf"].JsgfGrammar.parse(_JSGF_RULES).build_fsg())
    if case in ("cfg", "srgs"):
        cfg_mod = mods["cfg"]
        if case == "cfg":
            path = os.path.join(tmp, f"g.{mods['tag']}.cfg")
            with open(path, "w") as fh:
                fh.write(_CFG_TEXT)
            g = cfg_mod.Cfg.read_simple(path)
        else:
            g = cfg_mod.Cfg.parse_srgs(_SRGS_TEXT)
        return (g, g.to_fsg(max_expansion=3),
                cfg_mod.sample_sentences(g, 25, seed=4),
                cfg_mod.cfg_to_ngram(g, n=2, samples=300, seed=1))
    raise AssertionError(case)


# Grammars with recursion, repeats, optional items, weights and tags.
_JSGF_RULES = """#JSGF V1.0;
grammar cmd;
public <cmd> = [please] <act> (<obj> | /2/ <num>+) [now] {done};
<act> = /0.7/ open | close | go;
<obj> = the <thing> | a <thing> <obj>;
<thing> = door | window;
<num> = one | two | three;
"""
_CFG_TEXT = """1.0 $START 1 $S
0.6 $S 2 $A $S
0.4 $S 1 $B
0.5 $A 1 hello
0.5 $A 2 hi there
1.0 $B 1 world
"""
_SRGS_TEXT = """<?xml version="1.0"?>
<grammar xmlns="http://www.w3.org/2001/06/grammar" version="1.0" root="r">
  <rule id="r" scope="public">go <ruleref uri="#d"/>
    <item repeat="1-3"><one-of><item weight="2">one</item><item>two</item>
    </one-of></item><item repeat="0-1">meters</item></rule>
  <rule id="d"><one-of><item>forward</item><item>back</item></one-of></rule>
</grammar>
"""

_JAX = {"tag": "jax", "mdef": j_mdef, "dict": j_dict, "dict2pid": j_dict2pid,
        "tmat": j_tmat, "gauden": j_gauden, "sendump": j_sendump,
        "ngram": j_ngram, "lmset": j_lmset, "mllr": j_mllr,
        "config": j_config, "bio": j_bio, "fsg": j_fsg, "jsgf": j_jsgf,
        "cfg": j_cfg}
_PORT = {"tag": "port", "mdef": t_mdef, "dict": t_dict,
         "dict2pid": t_dict2pid, "tmat": t_tmat, "gauden": t_gauden,
         "sendump": t_sendump, "ngram": t_ngram, "lmset": t_lmset,
         "mllr": t_mllr, "config": t_config, "bio": t_bio, "fsg": t_fsg,
         "jsgf": t_jsgf, "cfg": t_cfg}


@pytest.mark.parametrize("case", [
    "mdef", "dict", "dict2pid", "tmat", "gauden", "mixture_weights",
    "sendump8", "sendump4", "ngram", "lmset", "mllr", "config", "bio",
    "fsg", "jsgf", "cfg", "srgs"])
def test_readers_match_reference(case, model_dirs, tmp_path):
    assert_same(_read(case, _JAX, model_dirs, str(tmp_path)),
                _read(case, _PORT, model_dirs, str(tmp_path)))


@pytest.fixture(scope="module")
def medium():
    return fixture.build(0, size=fixture.MEDIUM)


@pytest.mark.parametrize("modes", [("fanout", "mpx", "flat"),
                                   ("composite", "composite", "flat"),
                                   ("composite", "composite", "tree")])
def test_word_graph_matches_reference(modes, medium):
    fx = medium
    v = NgramVocab(fx.lm, fx.dict)
    rc, lc, lex = modes
    ugla = None
    if lex == "tree":
        ugla = np.where(v.is_filler, 0.0,
                        np.asarray(fx.lm.ug_prob)[np.maximum(v.lmwid, 0)])
    graphs = [mod.build_word_graph(v.dict_wid, fx.dict, fx.mdef,
                                   d2p.Dict2Pid(fx.mdef, fx.dict),
                                   rc_mode=rc, lc_mode=lc, lex_mode=lex,
                                   ug_lookahead=ugla)
              for mod, d2p in ((j_lexgraph, j_dict2pid),
                               (t_lexgraph, t_dict2pid))]
    assert graphs[1].lex_mode == lex and graphs[1].n_chan > 0
    assert_same(*graphs)


def test_train_lm_matches_reference():
    rng = np.random.RandomState(7)
    words = [f"v{i}" for i in range(40)]
    sents = [[words[k] for k in rng.randint(40, size=rng.randint(1, 7))]
             for _ in range(500)]
    for kw in ({}, {"n": 2, "discount": "witten_bell"},
               {"cutoffs": [0, 0, 1], "use_unk": True, "top": 30}):
        assert_same(j_estimate.train_lm(sents, **kw),
                    t_estimate.train_lm(sents, **kw))


_TRAIN_PRON = {"ab": ["A", "B"], "ba": ["B", "A"], "cab": ["C", "A", "B"],
               "c": ["C"]}
_TRAIN_TEXTS = [["ab"], ["ba", "c"], ["cab", "ab"], ["c", "ba", "cab"]]


def _params(mods, S, K, D, seed):
    """Seeded HmmParams of one package's class."""
    rng = np.random.RandomState(seed)
    model = mods["sentence_hmm"].FlatModel.create(["SIL", "A", "B", "C"])
    return mods["trainer"].HmmParams(
        means=rng.randn(S, K, D).astype(np.float32),
        var=(rng.rand(S, K, D) + 0.2).astype(np.float32),
        lnw=np.log(rng.dirichlet(np.ones(K), S)).astype(np.float32),
        tp=model.init_tmat().astype(np.float32))


def _train(case, mods, tmp):
    """What one copied trainer module of one package (mods: the
    reference's or the port's by short name) builds from seeded inputs."""
    sh = mods["sentence_hmm"]
    model = sh.FlatModel.create(["SIL", "A", "B", "C"])
    if case == "sentence_hmm":
        return (model, model.init_tmat(),
                [sh.build_sentence_hmm(t, _TRAIN_PRON, model)
                 for t in _TRAIN_TEXTS],
                sh.build_sentence_hmm(["cab"], _TRAIN_PRON, model,
                                      optional_sil=False))
    pl = mods["pipeline"]
    inv = pl.TriphoneInventory.from_corpus(model, _TRAIN_PRON, _TRAIN_TEXTS)
    occ = np.random.RandomState(5).rand(inv.n_sen, 2) * 10
    ci = _params(mods, model.n_sen, 2, 3, 1)
    cd = pl.init_cd_params(ci, model, inv)
    if case == "pipeline":
        view = inv.make_cd_model()
        rp = view.resolve_pron(_TRAIN_PRON)
        return (inv, rp, [pl.cd_sentence_hmm(t, rp, view)
                          for t in _TRAIN_TEXTS], cd,
                pl.tie_states(inv, cd, occ, max_senones_per_group=2),
                pl.split_gaussians(ci))
    if case == "dtree":
        return mods["dtree"].tie_states_dtree(inv, cd, occ,
                                              total_leaves=10)
    if case == "model_io":
        out = os.path.join(tmp, mods["tag"])
        mods["model_io"].export_model(os.path.join(out, "ci"), model, ci)
        smap, tied = pl.tie_states(inv, cd, occ, max_senones_per_group=2)
        pl.export_cd_model(os.path.join(out, "cd"), inv, smap, tied,
                           feat="1s_c")
        return {f"{d}/{n}": open(os.path.join(out, d, n), "rb").read()
                for d in ("ci", "cd")
                for n in sorted(os.listdir(os.path.join(out, d)))}
    tf = mods["transform"]
    rng = np.random.RandomState(6)
    if case == "transform":
        feats = rng.randn(300, 4).astype(np.float32)
        labels = rng.randint(0, 3, 300)
        stats = tf.class_scatter_stats(feats, labels, 3)
        acc = {"mixw": rng.rand(12, 2) * 5, "mean": rng.randn(12, 2, 3)}
        blocks = [rng.rand(12, 2) * 9 for _ in range(3)]
        return (stats, tf.estimate_lda(*stats), tf.estimate_lda(*stats, 2),
                tf.apply_mllt_to_model(rng.randn(3, 3), ci.means, ci.var),
                tf.map_adapt(ci, acc), tf.map_adapt(ci, acc, 2.0, False),
                tf.deleted_interpolation(blocks, blocks[::-1],
                                         np.arange(12) % 4),
                tf.mixw_interp(blocks[0], blocks[1], 0.25))
    if case == "semicont":
        X = [rng.randn(400, 3) * 2, rng.randn(100, 3) + 4]
        return (mods["semicont"].kmeans_init(X, 5, seed=2),
                mods["semicont"].kmeans_init(X, 4, seed=1, max_obs=250))
    if case == "mmie":
        num = {"mixw": rng.rand(12, 2) * 9, "mean": rng.randn(12, 2, 3) * 9,
               "var": rng.rand(12, 2, 3) * 30 + 9,
               "tmat": rng.rand(4, 3, 4)}
        den = {k: 0.5 * v for k, v in num.items()}
        return mods["mmie"].ebw_update(ci, num, den)
    raise AssertionError(case)


_JAX_TRAIN = {"tag": "jax", "sentence_hmm": j_sentence_hmm,
              "pipeline": j_pipeline, "dtree": j_dtree,
              "model_io": j_model_io, "transform": j_transform,
              "semicont": j_semicont, "mmie": j_mmie, "trainer": j_trainer}
_PORT_TRAIN = {"tag": "port", "sentence_hmm": t_sentence_hmm,
               "pipeline": t_pipeline, "dtree": t_dtree,
               "model_io": t_model_io, "transform": t_transform,
               "semicont": t_semicont, "mmie": t_mmie, "trainer": t_trainer}


@pytest.mark.parametrize("case", ["sentence_hmm", "pipeline", "dtree",
                                  "model_io", "transform", "semicont",
                                  "mmie"])
def test_train_copies_match_reference(case, tmp_path):
    assert_same(_train(case, _JAX_TRAIN, str(tmp_path)),
                _train(case, _PORT_TRAIN, str(tmp_path)))


def _frontend(case, mods):
    """What one package's pitch tracker or CDCN computes from seeded
    inputs (the reference tests' signals)."""
    rng = np.random.RandomState(4)
    if case == "pitch":
        t = np.arange(8000) / 16000.0
        voiced = np.sin(2 * np.pi * 150.0 * t) + 0.3 * np.sin(
            2 * np.pi * 300.0 * t)
        x = np.concatenate([voiced, rng.randn(4000) * 0.3, voiced * 0.5])
        return (mods["pitch"].yin_pitch(x),
                mods["pitch"].yin_pitch(x, 8000.0, fmin=80.0, threshold=0.2),
                mods["pitch"].yin_pitch(x[:100]))
    cd = mods["cdcn"]
    means = rng.randn(6, 13) * 2.0
    means[:, 0] = np.linspace(4.0, 10.0, 6)
    x = means[rng.randint(0, 6, 300)] + rng.randn(300, 13) * 0.15
    tilt = np.zeros(13)
    tilt[:3] = [1.5, -0.8, 0.4]
    noise = np.zeros(13)
    noise[0] = 2.5
    z = x + tilt + cd._softplus_spec(noise[None] - tilt[None] - x)
    model = cd.train_cdcn([x], n_codes=8, n_iter=8)
    return model, model.norm(z, n_iter=4), cd._cosine_matrix()


@pytest.mark.parametrize("case", ["pitch", "cdcn"])
def test_frontend_copies_match_reference(case):
    assert_same(_frontend(case, {"pitch": j_pitch, "cdcn": j_cdcn}),
                _frontend(case, {"pitch": t_pitch, "cdcn": t_cdcn}))


def _imports(path):
    """Absolute module names that a file imports."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module)
    return out


def test_no_port_file_imports_jax_or_the_reference():
    files = sorted((ROOT / "cmusphinx_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_profile.py"]
    assert len(files) > 20
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {f"cmusphinx_tpu_torch/{m}.py" for m in (
        "decode/lattice", "frontend/source", "frontend/vad", "pipeline",
        "utils/log", "utils/profile", "utils/native", "cli/batch",
        "cli/continuous", "models/fsg", "models/jsgf", "models/cfg",
        "decode/fsg_search", "decode/align", "decode/phone_loop",
        "train/__init__", "train/bw", "train/trainer", "train/sentence_hmm",
        "train/model_io", "train/pipeline", "train/dtree", "train/semicont",
        "train/mmie", "train/transform", "train/vtln", "frontend/ep",
        "frontend/pitch", "frontend/cdcn", "ops/approx", "ops/subvq",
        "utils/senfh", "decode/align_tp", "parallel/hosts",
        "parallel/dryrun", "parallel/senone_shard", "utils/huff",
        "utils/mfu", "models/lts", "models/fst", "models/htk",
        "models/phoenix", "lm/idngram", "lm/server", "cli/lmtool",
        "cli/tools")} <= names
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "optax",
                                     "cmusphinx_tpu")]
    assert not bad, bad


def _modules(package: str) -> set:
    root = ROOT / package
    return {str(f.relative_to(root).with_suffix(""))
            for f in root.rglob("*.py")}


def test_port_has_every_module_of_the_reference():
    """The two packages' module lists differ only by the port's own
    additions and the Pallas kernel's module, whose port is
    `ops/fused_gmm` with its CUDA source."""
    ref, port = _modules("cmusphinx_tpu"), _modules("cmusphinx_tpu_torch")
    assert ref - port == {"ops/pallas_gmm"}
    assert port - ref == {"convert", "fixture", "decode/graphs",
                          "decode/results", "ops/fused_gmm",
                          "parallel/dryrun", "parallel/senone_shard"}
