"""Seeded recognition tasks with a known answer, and their model directories.

`build(seed, model, size)` makes, with numpy and the port's host readers
and constructors (`models/`, `lm/estimate.py`), everything the N-gram
decode path needs:

- a phone set of CI phones plus SIL, 3 emitting states each;
- a text mdef (the `Mdef.write_text` format) whose triphones cover the
  dictionary's word-internal contexts and its cross-word begin/end
  contexts, so that the right-context fan-out (`rssid`, n_rcvar > 1) and
  the multiplexed left contexts (`lcmap`) are exercised; every triphone
  state is tied to a senone of its (phone, state) group;
- Bakis transition matrices with one skip, one per CI phone;
- a dictionary of multi-phone words (plus the fillers `Dictionary.read`
  adds) and a trigram LM from `lm.estimate.train_lm` on seeded sentences;
- an acoustic model of one of four kinds (`model`):
  - `cont`: continuous, one codebook of K Gaussians per senone over the
    39-dim `1s_c_d_dd` features: prec = 0.5/var, variances in a range
    typical of trained models, small delta means;
  - `semi`: semi-continuous at the width of hub4wsj_sc_8k, one shared
    codebook of 256 Gaussians per stream, 3 streams of 13 dimensions
    (`-feat 1s_c_d_dd -svspec 0-12/13-25/26-38`, the model's feat.params
    quoted in SURVEY.md), 8-bit sendump weights;
  - `s2_4x`: semi-continuous over the 4-stream `s2_4x` features (12/24/3/12
    dimensions, as the tidigits model), 4-bit sendump weights;
  - `ptm`: phonetically tied mixtures, one codebook per CI phone;
- cepstra synthesized along transcripts drawn from those sentences: each
  state of the transcript's triphone sequence is held 3-8 frames, and each
  frame's static cepstra lie near a Gaussian that the senone weights
  heavily.

The structure (phones, triphones, dictionary, LM, transitions) depends on
the seed and size only, so every model kind shares it.

Sizes (`Size`):

- `FULL` (the default): S=5150 senones with the hub4-class widths: K=32
  Gaussians per senone for `cont`, K=256 per stream for `semi`; 300 words
  keep the LM on the dense [V+1, V+1, V] table and the graph on the flat
  fanout/mpx path.
- `SMALL`: the CPU test size, 20 words.
- `MEDIUM`: SMALL's acoustic widths with 1,200 words, enough that `auto`
  picks composite contexts and the LM leaves the dense table for the
  sparse backends (hashed point lookups); the CPU test size of the
  large-vocabulary paths.
- `LARGE`: FULL's widths with 20,000 words (60,000 LM sentences), where
  `auto` picks the prefix-tree lexicon.
- `LARGE_5K`: LARGE cut to 5,000 words (15,000 sentences), where `auto`
  picks composite contexts on the flat lexicon.

`build(..., ncep=26)` widens a continuous fixture's cepstra (26 instead
of 13, so `1s_c_d_dd` gives D = 78): the wide-feature model that K1's
depth loop serves.

`grammar_jsgf(fx)` and `grammar_fsg(fx)` are the fixture's grammar, as
JSGF text and as an `FsgModel`: its public rule accepts every transcript
(a weighted alternative of the sentences) and also any sequence of the
vocabulary's words (a word loop).

`write_model_dir` writes a fixture as a model directory (mdef, means,
variances, transition_matrices, sendump or mixture_weights, feat.params,
noisedict) with an ARPA LM, a dictionary and the grammar (`grammar.jsgf`,
`grammar.fsg`) beside it, which the `Decoder` of either package loads by
`hmm=`.
"""

from __future__ import annotations

import math
import os
import tempfile
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .frontend.feat import FEAT_ARGS, FeatPipeline
from .lm.estimate import train_lm
from .models.dict import Dictionary
from .models.dict2pid import Dict2Pid
from .models.fsg import FsgModel
from .models.gauden import GaussianParams
from .models.mdef import Mdef
from .models.ngram import NgramModel
from .models.sendump import read_sendump, write_sendump
from .models.tmat import TransitionMatrices
from .utils.bio import write_s3_header
from .utils.config import Config
from .utils.logmath import LOG_ZERO

CMU_PHONES = ("AA AE AH AO AW AY B CH D DH EH ER EY F G HH IH IY JH K L M N "
              "NG OW OY P R S SH T TH UH UW V W Y Z ZH").split()

N_STATE = 3
NCEP = 13


@dataclass(frozen=True)
class Size:
    n_phone: int          # CI phones besides SIL
    n_sen: int            # senones (S)
    n_density: int        # Gaussians per senone (K), continuous model
    n_density_semi: int   # Gaussians per stream, semi-continuous models
    n_density_ptm: int    # Gaussians per CI phone, PTM model
    n_word: int
    pron_len: Tuple[int, int]      # phones per word, inclusive
    n_utt: int
    frames: Tuple[int, int]        # utterance length, inclusive
    n_sent: int                    # LM training sentences
    sent_len: Tuple[int, int]      # words per sentence, inclusive


FULL = Size(n_phone=39, n_sen=5150, n_density=32, n_density_semi=256,
            n_density_ptm=32, n_word=300, pron_len=(2, 8), n_utt=16,
            frames=(200, 600), n_sent=3000, sent_len=(2, 6))
SMALL = Size(n_phone=10, n_sen=96, n_density=4, n_density_semi=32,
             n_density_ptm=8, n_word=20, pron_len=(2, 4), n_utt=3,
             frames=(80, 200), n_sent=200, sent_len=(2, 3))
MEDIUM = replace(SMALL, n_word=1200, pron_len=(2, 5), n_sent=6000)
LARGE = replace(FULL, n_word=20000, n_sent=60000)
LARGE_5K = replace(LARGE, n_word=5000, n_sent=15000)

_BASE_FEAT = {"ceplen": NCEP, "cmn": "current", "agc": "none"}
# The feature parameters each model kind carries in its feat.params.
FEAT_PARAMS: Dict[str, Dict[str, object]] = {
    "cont": {"feat": "1s_c_d_dd", **_BASE_FEAT},
    "ptm": {"feat": "1s_c_d_dd", **_BASE_FEAT},
    "semi": {"feat": "1s_c_d_dd", "svspec": "0-12/13-25/26-38",
             **_BASE_FEAT},
    "s2_4x": {"feat": "s2_4x", **_BASE_FEAT},
}
# Frontend parameters of the semi-continuous model's feat.params, after
# hub4wsj_sc_8k's (SURVEY.md: -nfilt 20 -lowerf 1 -upperf 4000 -transform
# dct -cmninit 56,-3,1).
SEMI_FE_PARAMS = {"nfilt": 20, "lowerf": 1, "upperf": 4000,
                  "transform": "dct", "cmninit": "56,-3,1"}


@dataclass
class Fixture:
    size: Size
    model: str
    mdef: Mdef
    dict: Dictionary
    tmat: TransitionMatrices
    gauden: GaussianParams
    # ln mixture weights: [S, K] for cont and ptm; [n_feat, K, S] for the
    # semi-continuous kinds (the layout `read_sendump` returns).
    ln_mixw: np.ndarray
    lm: NgramModel
    ceps: List[np.ndarray]               # [T_i, 13] cepstra
    transcripts: List[List[str]]         # words per utterance (no fillers)
    feat_params: Dict[str, object] = field(
        default_factory=lambda: dict(FEAT_PARAMS["cont"]))
    sendump_bits: Optional[int] = None   # 8 or 4 for semi-continuous kinds

    def feat_config(self) -> Config:
        cfg = Config(FEAT_ARGS)
        cfg.update(**self.feat_params)
        return cfg

    def stream_slices(self) -> List[np.ndarray]:
        """Index arrays of each feature stream (FeatPipeline's)."""
        return _stream_slices(self.feat_params)

    @property
    def audio_seconds(self) -> float:
        return sum(len(c) for c in self.ceps) / 100.0


def _stream_slices(feat_params) -> List[np.ndarray]:
    cfg = Config(FEAT_ARGS)
    cfg.update(**feat_params)
    return FeatPipeline(cfg, device="cpu").stream_slices()


def build(seed: int = 0, model: str = "cont", size: Size = FULL,
          ncep: int = NCEP) -> Fixture:
    if model not in _ACOUSTIC:
        raise ValueError(f"model must be one of {sorted(_ACOUSTIC)}, "
                         f"got {model!r}")
    if ncep != NCEP and model != "cont":
        raise ValueError("only the continuous fixture takes other cepstra "
                         "than 13")
    rng = np.random.RandomState(seed)
    phones = CMU_PHONES[: size.n_phone]
    ci_names = phones + ["SIL"]
    n_ci = len(ci_names)
    sil = n_ci - 1

    # ---- words and LM sentences ----
    prons: List[Tuple[int, ...]] = []
    seen = set()
    while len(prons) < size.n_word:
        n = rng.randint(size.pron_len[0], size.pron_len[1] + 1)
        p = tuple(int(x) for x in rng.randint(0, size.n_phone, n))
        if p not in seen:
            seen.add(p)
            prons.append(p)
    words = [f"w{i:03d}" for i in range(size.n_word)]
    # A sparse random bigram chain gives the LM real structure; one seed
    # sentence per word keeps every word in the LM vocabulary.
    succ = rng.randint(0, size.n_word, (size.n_word, 6))
    sents: List[List[str]] = []
    for i in range(size.n_sent):
        n = rng.randint(size.sent_len[0], size.sent_len[1] + 1)
        w = i if i < size.n_word else rng.randint(size.n_word)
        s = [w]
        for _ in range(n - 1):
            w = int(succ[w, rng.randint(6)])
            s.append(w)
        sents.append([words[k] for k in s])
    lm = train_lm(sents, n=3)

    # ---- triphones ----
    first = {p[0] for p in prons} | {sil}
    last = {p[-1] for p in prons} | {sil}
    tri: Dict[Tuple[int, int, int, str], None] = {}
    for p in prons:
        for lc in sorted(last):
            tri[(p[0], lc, p[1], "b")] = None
        for i in range(1, len(p) - 1):
            tri[(p[i], p[i - 1], p[i + 1], "i")] = None
        for rc in sorted(first):
            tri[(p[-1], p[-2], rc, "e")] = None
    n_ci_sen = n_ci * N_STATE
    groups = size.n_phone * N_STATE
    if size.n_sen < n_ci_sen + groups:
        raise ValueError("too few senones for the phone set")
    # Senone ids of group (phone b, state j): n_ci_sen + g + groups * i.
    per_group = [np.arange(n_ci_sen + g, size.n_sen, groups)
                 for g in range(groups)]
    lines = ["0.3", f"{n_ci} n_base", f"{len(tri)} n_tri",
             f"{(n_ci + len(tri)) * (N_STATE + 1)} n_state_map",
             f"{size.n_sen} n_tied_state", f"{n_ci_sen} n_tied_ci_state",
             f"{n_ci} n_tied_tmat"]
    for b, name in enumerate(ci_names):
        attr = "filler" if b == sil else "n/a"
        st = " ".join(str(b * N_STATE + j) for j in range(N_STATE))
        lines.append(f"{name} - - - {attr} {b} {st} N")
    for (b, lc, rc, wp) in tri:
        st = " ".join(str(int(rng.choice(per_group[b * N_STATE + j])))
                      for j in range(N_STATE))
        lines.append(f"{ci_names[b]} {ci_names[lc]} {ci_names[rc]} {wp} "
                     f"n/a {b} {st} N")

    with tempfile.TemporaryDirectory() as tmp:
        mdef_path = os.path.join(tmp, "mdef")
        with open(mdef_path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        dict_path = os.path.join(tmp, "dict")
        with open(dict_path, "w") as fh:
            for w, p in zip(words, prons):
                fh.write(w + " " + " ".join(phones[x] for x in p) + "\n")
        mdef = Mdef.read_text(mdef_path)
        d = Dictionary.read(dict_path, mdef)

    # ---- transitions: Bakis, one skip ----
    tp = np.zeros((n_ci, N_STATE, N_STATE + 1))
    for t in range(n_ci):
        for j in range(N_STATE):
            stay = rng.uniform(0.6, 0.8)
            skip = 0.05 if j < N_STATE - 1 else 0.0
            tp[t, j, j] = stay
            tp[t, j, j + 1] = 1.0 - stay - skip
            if skip:
                tp[t, j, j + 2] = skip
    log_tp = np.where(tp > 0, np.log(np.maximum(tp, 1e-37)), LOG_ZERO)
    tmat = TransitionMatrices(log_tp=log_tp.astype(np.float32),
                              n_tmat=n_ci, n_state=N_STATE)

    # ---- acoustic model and audio ----
    am = (_continuous(rng, size, mdef, ncep) if model == "cont"
          else _ACOUSTIC[model](rng, size, mdef))
    d2p = Dict2Pid(mdef, d)
    wid = {w: d.wordid(w) for w in words}
    ceps, transcripts = [], []
    while len(ceps) < size.n_utt:
        sent = sents[rng.randint(len(sents))]
        pids = [sil]
        for i, w in enumerate(sent):
            lc = prons[words.index(sent[i - 1])][-1] if i else sil
            rc = (prons[words.index(sent[i + 1])][0]
                  if i + 1 < len(sent) else sil)
            pids.extend(d2p.word_pids(wid[w], lc, rc))
        pids.append(sil)
        frames = []
        for pid in pids:
            ssid = mdef.phone_ssid[pid]
            for j in range(N_STATE):
                s = int(mdef.sseq[ssid, j])
                n = rng.randint(3, 9)
                frames.append(am.emit(rng, s, n))
        cep = np.concatenate(frames).astype(np.float32)
        if size.frames[0] <= len(cep) <= size.frames[1]:
            ceps.append(cep)
            transcripts.append(list(sent))
    return Fixture(size=size, model=model, mdef=mdef, dict=d, tmat=tmat,
                   gauden=am.gauden, ln_mixw=am.ln_mixw, lm=lm, ceps=ceps,
                   transcripts=transcripts,
                   feat_params={**FEAT_PARAMS[model], "ceplen": ncep},
                   sendump_bits=am.sendump_bits)


# ----------------------------------------------------------------------
# Acoustic models.  Each returns the model and `emit(rng, s, n)`, which
# draws n frames of 13 static cepstra from senone s.

@dataclass
class _Acoustic:
    gauden: GaussianParams
    ln_mixw: np.ndarray
    emit: Callable[[np.random.RandomState, int, int], np.ndarray]
    sendump_bits: Optional[int] = None


def _gaussians(means: np.ndarray, var: np.ndarray, veclen: List[int]
               ) -> GaussianParams:
    """GaussianParams from means/variances [n_mgau, n_feat, K, maxlen],
    with the precomputation of `read_gauden` (f32 arithmetic), so a model
    written by `write_model_dir` loads back bit-identical."""
    n_mgau, n_feat, K, _ = means.shape
    var = np.maximum(var.astype(np.float32), 1e-4).astype(np.float32)
    prec = np.zeros_like(var)
    lrd = np.zeros((n_mgau, n_feat, K), np.float32)
    for f, ln in enumerate(veclen):
        v = var[:, f, :, :ln]
        prec[:, f, :, :ln] = 1.0 / (2.0 * v)
        lrd[:, f] = -0.5 * (np.log(v).sum(axis=-1)
                            + ln * math.log(2.0 * math.pi))
    return GaussianParams(means=means.astype(np.float32), var=var, prec=prec,
                          lrd=lrd, veclen=list(veclen), n_mgau=n_mgau,
                          n_feat=n_feat, n_density=K)


def _ln_weights(w: np.ndarray) -> np.ndarray:
    """ln of weights [..., K] as `read_mixture_weights` computes them from
    the float32 values a mixture_weights file holds."""
    w = w.astype(np.float32).astype(np.float64)
    w = np.maximum(w / w.sum(-1, keepdims=True), 1e-7)
    return np.log(w).astype(np.float32)


def _continuous(rng, size: Size, mdef: Mdef, ncep: int = NCEP) -> _Acoustic:
    """One codebook of K Gaussians per senone over the 3 * ncep-dim
    features (39 at the default 13 cepstra)."""
    S, K, D = size.n_sen, size.n_density, 3 * ncep
    center = rng.normal(0.0, 1.5, (S, ncep))
    means = np.empty((S, 1, K, D), np.float32)
    means[:, 0, :, :ncep] = center[:, None, :] + rng.normal(0, 0.3, (S, K, ncep))
    means[:, 0, :, ncep:] = rng.normal(0.0, 0.1, (S, K, 2 * ncep))
    var = np.empty((S, 1, K, D), np.float32)
    var[..., :ncep] = rng.uniform(0.2, 0.6, (S, 1, K, ncep))
    var[..., ncep:2 * ncep] = rng.uniform(1.0, 3.0, (S, 1, K, ncep))
    var[..., 2 * ncep:] = rng.uniform(2.0, 6.0, (S, 1, K, ncep))
    mixw = rng.dirichlet(np.full(K, 2.0), size=S)

    def emit(rng, s, n):
        k = rng.choice(K, size=n, p=mixw[s])
        return means[s, 0, k, :ncep] + rng.normal(0.0, 0.25, (n, ncep))

    return _Acoustic(_gaussians(means, var, [D]), _ln_weights(mixw), emit)


def _peaked(rng, n_sen: int, K: int, pick: int) -> np.ndarray:
    """Weights [n_sen, K]: each row puts 0.999 of its mass on `pick`
    codewords (Dirichlet(2) among them) and spreads the rest evenly."""
    w = np.full((n_sen, K), 0.001 / K)
    for s in range(n_sen):
        ks = rng.choice(K, size=pick, replace=False)
        w[s, ks] += 0.999 * rng.dirichlet(np.full(pick, 2.0))
    return w


def _semi(model: str, static: List[int], bits: int):
    """One shared codebook per stream (n_mgau = 1).  Stream 0 holds the
    static cepstra `static`; each senone's stream-0 weights concentrate on
    3 codewords, and its frames are drawn from them.  The other streams
    (deltas, power) get generic codebooks and near-uniform weights."""

    def make(rng, size: Size, mdef: Mdef) -> _Acoustic:
        S, K = size.n_sen, size.n_density_semi
        lens = [len(x) for x in _stream_slices(FEAT_PARAMS[model])]
        L = max(lens)
        words = rng.normal(0.0, 1.5, (K, NCEP))        # codeword cepstra
        means = np.zeros((1, len(lens), K, L), np.float32)
        var = np.zeros_like(means)
        means[0, 0, :, :lens[0]] = words[:, static]
        var[0, 0, :, :lens[0]] = rng.uniform(0.2, 0.6, (K, lens[0]))
        for f, ln in enumerate(lens[1:], 1):
            means[0, f, :, :ln] = rng.normal(0.0, 2.0, (K, ln))
            var[0, f, :, :ln] = rng.uniform(1.0, 4.0, (K, ln))
        w0 = _peaked(rng, S, K, 3)
        ws = [w0] + [rng.dirichlet(np.full(K, 50.0), size=S)
                     for _ in lens[1:]]
        ln_mixw = np.log(np.stack(ws)).transpose(0, 2, 1)   # [F, K, S]
        p0 = w0 / w0.sum(-1, keepdims=True)

        def emit(rng, s, n):
            k = rng.choice(K, size=n, p=p0[s])
            return words[k] + rng.normal(0.0, 0.25, (n, NCEP))

        return _Acoustic(_gaussians(means, var, lens),
                         np.ascontiguousarray(ln_mixw, np.float32), emit,
                         sendump_bits=bits)

    return make


def _ptm(rng, size: Size, mdef: Mdef) -> _Acoustic:
    """Phonetically tied mixtures: one codebook of K Gaussians per CI phone
    (39-dim), each senone mixing 2 codewords of its phone's codebook
    (`mdef.sen2cimap`)."""
    C, S, K, D = mdef.n_ciphone, size.n_sen, size.n_density_ptm, 3 * NCEP
    means = np.empty((C, 1, K, D), np.float32)
    means[:, 0, :, :NCEP] = rng.normal(0.0, 1.5, (C, K, NCEP))
    means[:, 0, :, NCEP:] = rng.normal(0.0, 0.1, (C, K, 2 * NCEP))
    var = np.empty((C, 1, K, D), np.float32)
    var[..., :NCEP] = rng.uniform(0.2, 0.6, (C, 1, K, NCEP))
    var[..., NCEP:] = rng.uniform(1.0, 6.0, (C, 1, K, 2 * NCEP))
    mixw = _peaked(rng, S, K, 2)
    cb = np.maximum(np.asarray(mdef.sen2cimap, np.int64), 0)

    def emit(rng, s, n):
        k = rng.choice(K, size=n, p=mixw[s] / mixw[s].sum())
        return means[cb[s], 0, k, :NCEP] + rng.normal(0.0, 0.25, (n, NCEP))

    return _Acoustic(_gaussians(means, var, [D]), _ln_weights(mixw), emit)


_ACOUSTIC = {"cont": _continuous, "ptm": _ptm,
             "semi": _semi("semi", static=list(range(NCEP)), bits=8),
             "s2_4x": _semi("s2_4x", static=list(range(1, NCEP)), bits=4)}


def sendump_bytes(fx: Fixture):
    """The raw mixture-weight bytes [n_feat, K, S] and meta of the sendump
    that `write_model_dir` writes for a semi-continuous fixture (quantized
    by `write_sendump`, read back by `read_sendump(return_raw=True)`)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sendump")
        write_sendump(path, fx.ln_mixw, n_bits=fx.sendump_bits)
        return read_sendump(path, return_raw=True)


def _write_gauden(path: str, a: np.ndarray, veclen: List[int]) -> None:
    """s3 gauden file: [n_mgau][n_feat][K][veclen_f], stream-major inside
    each codebook (the layout `read_gauden` unpacks)."""
    n_mgau, n_feat, K, _ = a.shape
    data = np.concatenate([a[:, f, :, :ln].reshape(n_mgau, -1)
                           for f, ln in enumerate(veclen)], axis=1)
    with open(path, "wb") as fh:
        write_s3_header(fh, "1.0")
        fh.write(np.asarray([n_mgau, n_feat, K, *veclen, data.size],
                            "<i4").tobytes())
        fh.write(data.astype("<f4").tobytes())


def _write_s3_array(path: str, dims: List[int], data: np.ndarray) -> None:
    """s3 file of int32 dims, an int32 count and float32 data."""
    with open(path, "wb") as fh:
        write_s3_header(fh, "1.0")
        fh.write(np.asarray([*dims, data.size], "<i4").tobytes())
        fh.write(np.ascontiguousarray(data).astype("<f4").tobytes())


def write_model_dir(fx: Fixture, path: str, kind: Optional[str] = None
                    ) -> Dict[str, str]:
    """Write `fx` under `path`: the model directory `path/hmm` and, beside
    it, `path/lm.arpa` and `path/words.dict`.  Returns the `Decoder` keyword
    arguments {"hmm", "lm", "dict"}.

    `kind` names the mixture-weight file: "sendump" (the default for the
    semi-continuous kinds, 8- or 4-bit as `fx.sendump_bits`) or
    "mixture_weights" (s3 float weights; the default for cont and ptm)."""
    semi = fx.sendump_bits is not None
    kind = kind or ("sendump" if semi else "mixture_weights")
    if kind == "sendump" and not semi:
        raise ValueError("only semi-continuous fixtures have a sendump")
    hmm = os.path.join(path, "hmm")
    os.makedirs(hmm, exist_ok=True)
    fx.mdef.write_text(os.path.join(hmm, "mdef"))
    g = fx.gauden
    _write_gauden(os.path.join(hmm, "means"), g.means, g.veclen)
    _write_gauden(os.path.join(hmm, "variances"), g.var, g.veclen)
    tp = np.where(fx.tmat.log_tp > LOG_ZERO / 2, np.exp(fx.tmat.log_tp), 0.0)
    _write_s3_array(os.path.join(hmm, "transition_matrices"),
                    list(tp.shape), tp)
    if kind == "sendump":
        write_sendump(os.path.join(hmm, "sendump"), fx.ln_mixw,
                      n_bits=fx.sendump_bits)
    elif kind == "mixture_weights":
        # File layout [n_sen][n_feat][K].
        w = np.exp(fx.ln_mixw.astype(np.float64))
        w = w.transpose(2, 0, 1) if semi else w[:, None, :]
        _write_s3_array(os.path.join(hmm, "mixture_weights"),
                        list(w.shape), w)
    else:
        raise ValueError(f"unknown mixture-weight kind {kind!r}")
    params = dict(fx.feat_params)
    if fx.model == "semi":
        params.update(SEMI_FE_PARAMS)
    with open(os.path.join(hmm, "feat.params"), "w") as fh:
        fh.writelines(f"-{k} {v}\n" for k, v in params.items())
    with open(os.path.join(hmm, "noisedict"), "w") as fh:
        fh.write("<s> SIL\n</s> SIL\n<sil> SIL\n")
    lm = os.path.join(path, "lm.arpa")
    fx.lm.write_arpa(lm)
    dic = os.path.join(path, "words.dict")
    with open(dic, "w") as fh:
        for w in range(fx.dict.n_word):
            if not fx.dict.is_filler(w):
                phones = " ".join(fx.mdef.ciname[p] for p in fx.dict.pron[w])
                fh.write(f"{fx.dict.word_str(w)} {phones}\n")
    with open(os.path.join(path, "grammar.jsgf"), "w") as fh:
        fh.write(grammar_jsgf(fx))
    with open(os.path.join(path, "grammar.fsg"), "w") as fh:
        grammar_fsg(fx).write(fh)
    return {"hmm": hmm, "lm": lm, "dict": dic}


# ----------------------------------------------------------------------
# The fixture's grammar: a weighted alternative of its transcripts (0.9)
# and a loop over its whole vocabulary (0.1).

SENT_WEIGHT, LOOP_WEIGHT = 0.9, 0.1


def grammar_parts(fx: Fixture) -> Tuple[List[List[str]], List[str]]:
    """The distinct transcripts, in order, and the vocabulary (the
    dictionary's non-filler words)."""
    sents: List[List[str]] = []
    for t in fx.transcripts:
        if t not in sents:
            sents.append(list(t))
    vocab = [fx.dict.word_str(w) for w in range(fx.dict.n_word)
             if not fx.dict.is_filler(w)]
    return sents, vocab


def grammar_jsgf(fx: Fixture) -> str:
    """The grammar as JSGF: public <utt> = /0.9/ <sent> | /0.1/ <word>+."""
    sents, vocab = grammar_parts(fx)
    return ("#JSGF V1.0;\ngrammar fixture;\n\n"
            f"public <utt> = /{SENT_WEIGHT}/ <sent> | /{LOOP_WEIGHT}/ <word>+;\n"
            "<sent> = " + " | ".join(" ".join(s) for s in sents) + ";\n"
            "<word> = " + " | ".join(vocab) + ";\n")


def grammar_fsg(fx: Fixture) -> FsgModel:
    """The grammar as a compact FSG: state 0 starts, 1 is final; each
    transcript is a chain from 0 to 1 (0.9 shared among them); the loop
    enters state 2 (0.1), every word goes 2 -> 3, and 3 returns to 2 or
    ends (0.5 each)."""
    sents, vocab = grammar_parts(fx)
    fsg = FsgModel(name="fixture", start_state=0, final_state=1)
    n = 4
    for sent in sents:
        lp = math.log(SENT_WEIGHT / len(sents))
        cur = 0
        for i, w in enumerate(sent):
            nxt = 1 if i == len(sent) - 1 else n
            n += nxt == n
            fsg.add_link(cur, nxt, lp if i == 0 else 0.0, w)
            cur = nxt
    fsg.add_link(0, 2, math.log(LOOP_WEIGHT), None)
    for w in vocab:
        fsg.add_link(2, 3, -math.log(len(vocab)), w)
    fsg.add_link(3, 2, math.log(0.5), None)
    fsg.add_link(3, 1, math.log(0.5), None)
    fsg.n_state = n
    return fsg


def train_corpus(fx: Fixture) -> Tuple[List[str], Dict[str, List[str]]]:
    """The fixture as a training corpus for `train.FlatModel`: its CI phone
    names (SIL last) and each word's pronunciation in them."""
    phones = [fx.mdef.ciname[p] for p in range(fx.mdef.n_ciphone)]
    pron = {fx.dict.word_str(w): [fx.mdef.ciname[p] for p in fx.dict.pron[w]]
            for w in range(fx.dict.n_word) if not fx.dict.is_filler(w)}
    return phones, pron


def synthetic_pcm(seed: int, seconds: float = 2.0, sr: int = 16000
                  ) -> np.ndarray:
    """Seeded 16-bit PCM for driving the waveform frontend: gliding tones
    in bursts over low noise."""
    rng = np.random.RandomState(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f = 300 + 200 * np.sin(2 * np.pi * 1.3 * t) + rng.randint(0, 400)
    env = (np.sin(2 * np.pi * 2.1 * t) > -0.3).astype(np.float64)
    x = (4000 * env * np.sin(2 * np.pi * np.cumsum(f) / sr)
         + 1500 * env * np.sin(2 * np.pi * 3 * np.cumsum(f) / sr)
         + rng.randn(n) * 60)
    return np.clip(x, -32768, 32767).astype(np.int16)


def word_errors(ref: List[str], hyp: List[str]) -> int:
    """Levenshtein distance between two word lists (case-insensitive)."""
    r = [w.lower() for w in ref]
    h = [w.lower() for w in hyp]
    prev = list(range(len(h) + 1))
    for i, rw in enumerate(r, 1):
        cur = [i] + [0] * len(h)
        for j, hw in enumerate(h, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (rw != hw))
        prev = cur
    return prev[-1]
