"""Seeded recognition tasks and their Sphinx model directories.

A frozen copy, in numpy and the standard library alone, of what the
port's task generator (`cmusphinx_tpu_torch.fixture`: `build` and
`write_model_dir`) does, so that the benchmark's inputs stay put when the
program changes:

- a phone set of CI phones plus SIL, 3 emitting states each; a text mdef
  whose triphones cover the dictionary's word-internal and cross-word
  contexts, every triphone state tied to a senone of its (phone, state)
  group; Bakis transition matrices with one skip;
- a dictionary of multi-phone words and a trigram LM estimated on seeded
  sentences of a sparse bigram chain (`lm.py`);
- the acoustic model, which the configuration's kind draws and writes
  (`kinds/<model>.py`);
- a pool of utterances along sentences of the LM: each state of the
  sentence's triphone sequence (silence at both ends) held 3-8 frames, each
  frame's static cepstra near a Gaussian that the senone weights heavily.

A configuration fixes `structure_seed`: its lexicon, LM and senone ties
are then the same for every run, as a deployment's are, and the run's seed
draws the acoustic weights and the speech.

For a seed, the model files are byte-identical to the program's generator
at the same size.  The pool differs on purpose: its utterance lengths are
given (`lengths`), so that every seed decodes the same set of sizes in
another order; a sentence is drawn until its states fit the length, and
the length is spread over its states.
"""

from __future__ import annotations

import dataclasses
import math
import os
import struct
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import kinds
from .lm import ArpaLM, train_lm

CMU_PHONES = ("AA AE AH AO AW AY B CH D DH EH ER EY F G HH IH IY JH K L M N "
              "NG OW OY P R S SH T TH UH UW V W Y Z ZH").split()
N_STATE = 3
NCEP = 13
LOG_ZERO = -1.0e30
SENSCR_SHIFT = 10
# The feat.params lines every kind shares.
BASE_FEAT = {"ceplen": NCEP, "cmn": "current", "agc": "none"}


@dataclass(frozen=True)
class Size:
    """The structure's sizes, which every kind shares, and in `own` the
    kind's own keys of the configuration's `size` (its `SIZE_KEYS`)."""
    n_phone: int          # CI phones besides SIL
    n_sen: int            # senones (S)
    n_word: int
    pron_len: Tuple[int, int]      # phones a word, inclusive
    n_sent: int                    # LM training sentences
    sent_len: Tuple[int, int]      # words a sentence, inclusive
    own: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "Size":
        d = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        shared = {f.name for f in dataclasses.fields(cls)} - {"own"}
        return cls(**{k: v for k, v in d.items() if k in shared},
                   own={k: v for k, v in d.items() if k not in shared})


@dataclass
class Acoustic:
    means: np.ndarray     # [n_mgau, n_feat, K, maxlen] float32
    var: np.ndarray       # the same, floored at 1e-4
    veclen: List[int]
    ln_mixw: np.ndarray   # float32, in the layout of the kind's writer
    emit: Callable[[np.random.RandomState, int, int], np.ndarray]


@dataclass
class Task:
    model: str                        # the kind's name
    size: Size
    phones: List[str]                 # CI phone names, SIL last
    mdef_lines: List[str]
    words: List[str]
    prons: List[Tuple[int, ...]]
    tp: np.ndarray                    # [n_ci, N_STATE, N_STATE + 1]
    am: Optional[Acoustic]           # None in a structure alone
    lm: ArpaLM
    sents: List[List[str]]
    tri: Dict[Tuple[int, int, int, str], Tuple[int, ...]]   # -> senones
    ceps: List[np.ndarray]            # the pool's cepstra [T_i, 13]
    transcripts: List[List[str]]

    def __post_init__(self):
        self.index = {w: i for i, w in enumerate(self.words)}


def build(seed: int, model: str, size: Size, lengths: Sequence[int],
          structure_seed: Optional[int] = None) -> Task:
    """The task of `seed`: the model at `size` and a pool of utterances of
    the given lengths (frames).  With `structure_seed`, the structure (the
    words and their pronunciations, the LM, the triphones' senones, the
    transitions) comes from that seed and the acoustic weights and the
    pool from `seed`, so that every seed decodes the same lexicon and LM,
    the same work; without it, everything comes from `seed` in one stream
    of draws, as the program's generator does."""
    if structure_seed is not None:
        return with_seed(structure(model, size, structure_seed), seed, lengths)
    rng = np.random.RandomState(seed)
    return _acoustic(_structure(rng, model, size), rng, lengths)


def structure(model: str, size: Size, structure_seed: int) -> Task:
    """The structure of `structure_seed` alone: a task without acoustic
    weights or pool, for `with_seed`."""
    return _structure(np.random.RandomState(structure_seed), model, size)


def with_seed(struct: Task, seed: int, lengths: Sequence[int]) -> Task:
    """The task of `seed` on a structure of `structure`: its acoustic
    weights and its pool drawn from `seed`."""
    return _acoustic(struct, np.random.RandomState(seed), lengths)


def _acoustic(struct: Task, rng: np.random.RandomState,
              lengths: Sequence[int]) -> Task:
    kind = _kind(struct.model, struct.size)
    am = kind.acoustic(rng, struct.size, struct)
    task = dataclasses.replace(struct, am=am, ceps=[], transcripts=[])
    _pool(task, rng, lengths)
    return task


def _kind(model: str, size: Size):
    """The kind `model`, whose own size keys `size` has to hold: all of
    them and no other."""
    kind = kinds.load(model)
    missing = [k for k in kind.SIZE_KEYS if k not in size.own]
    other = sorted(set(size.own) - set(kind.SIZE_KEYS))
    if missing or other:
        raise ValueError(f"the {model} kind's size keys are "
                         f"{list(kind.SIZE_KEYS)}: missing {missing}, "
                         f"not its own {other}")
    return kind


def _structure(rng: np.random.RandomState, model: str, size: Size) -> Task:
    _kind(model, size)
    phones = CMU_PHONES[: size.n_phone]
    ci_names = phones + ["SIL"]
    n_ci = len(ci_names)
    sil = n_ci - 1

    prons: List[Tuple[int, ...]] = []
    seen = set()
    while len(prons) < size.n_word:
        n = rng.randint(size.pron_len[0], size.pron_len[1] + 1)
        p = tuple(int(x) for x in rng.randint(0, size.n_phone, n))
        if p not in seen:
            seen.add(p)
            prons.append(p)
    words = [f"w{i:03d}" for i in range(size.n_word)]
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

    first = {p[0] for p in prons} | {sil}
    last = {p[-1] for p in prons} | {sil}
    keys: Dict[Tuple[int, int, int, str], None] = {}
    for p in prons:
        for lc in sorted(last):
            keys[(p[0], lc, p[1], "b")] = None
        for i in range(1, len(p) - 1):
            keys[(p[i], p[i - 1], p[i + 1], "i")] = None
        for rc in sorted(first):
            keys[(p[-1], p[-2], rc, "e")] = None
    n_ci_sen = n_ci * N_STATE
    groups = size.n_phone * N_STATE
    if size.n_sen < n_ci_sen + groups:
        raise ValueError("too few senones for the phone set")
    per_group = [np.arange(n_ci_sen + g, size.n_sen, groups)
                 for g in range(groups)]
    lines = ["0.3", f"{n_ci} n_base", f"{len(keys)} n_tri",
             f"{(n_ci + len(keys)) * (N_STATE + 1)} n_state_map",
             f"{size.n_sen} n_tied_state", f"{n_ci_sen} n_tied_ci_state",
             f"{n_ci} n_tied_tmat", "#", "# Columns definitions",
             "#%4s %3s %3s %1s %6s %4s %s" % ("base", "lft", "rt", "p",
                                              "attrib", "tmat",
                                              "     ... state id's ...")]
    for b, name in enumerate(ci_names):
        st = " ".join(str(b * N_STATE + j) for j in range(N_STATE))
        lines.append("%5s %3s %3s %1s %6s %4d %s N" % (
            name, "-", "-", "-", "filler" if b == sil else "n/a", b, st))
    tri: Dict[Tuple[int, int, int, str], Tuple[int, ...]] = {}
    for (b, lc, rc, wp) in keys:
        st = tuple(int(rng.choice(per_group[b * N_STATE + j]))
                   for j in range(N_STATE))
        tri[(b, lc, rc, wp)] = st
        lines.append("%5s %3s %3s %1s %6s %4d %s N" % (
            ci_names[b], ci_names[lc], ci_names[rc], wp, "n/a", b,
            " ".join(map(str, st))))

    tp = np.zeros((n_ci, N_STATE, N_STATE + 1))
    for t in range(n_ci):
        for j in range(N_STATE):
            stay = rng.uniform(0.6, 0.8)
            skip = 0.05 if j < N_STATE - 1 else 0.0
            tp[t, j, j] = stay
            tp[t, j, j + 1] = 1.0 - stay - skip
            if skip:
                tp[t, j, j + 2] = skip

    return Task(model, size, ci_names, lines, words, prons, tp, None, lm,
                sents, tri, [], [])


def _sentence_senones(task: Task, sent: List[str]) -> List[int]:
    """Senones of the sentence's states in order, silence at both ends,
    cross-word contexts from the neighbouring words."""
    sil = len(task.phones) - 1
    index = task.index
    sen = [sil * N_STATE + j for j in range(N_STATE)]
    for i, w in enumerate(sent):
        p = task.prons[index[w]]
        lc = task.prons[index[sent[i - 1]]][-1] if i else sil
        rc = task.prons[index[sent[i + 1]]][0] if i + 1 < len(sent) else sil
        keys = ([(p[0], lc, p[1], "b")]
                + [(p[k], p[k - 1], p[k + 1], "i") for k in range(1, len(p) - 1)]
                + [(p[-1], p[-2], rc, "e")])
        for key in keys:
            sen.extend(task.tri[key])
    sen.extend(sil * N_STATE + j for j in range(N_STATE))
    return sen


def _pool(task: Task, rng: np.random.RandomState, lengths: Sequence[int]
          ) -> None:
    """Utterances of the given lengths: per length, sentences are drawn
    until one's states fit (3 to 8 frames each), then the frames beyond 3
    a state are spread over the states at random, at most 5 more each."""
    for L in lengths:
        while True:
            sent = task.sents[rng.randint(len(task.sents))]
            sen = _sentence_senones(task, sent)
            n = len(sen)
            if 3 * n <= L <= 8 * n:
                break
        slots = rng.permutation(5 * n)[: L - 3 * n] // 5
        dur = 3 + np.bincount(slots, minlength=n)
        cep = np.concatenate([task.am.emit(rng, s, int(k))
                              for s, k in zip(sen, dur)]).astype(np.float32)
        task.ceps.append(cep)
        task.transcripts.append(list(sent))


# ----------------------------------------------------------------------
# What the kinds' acoustic models share.  A model's `emit(rng, s, n)` draws
# n frames of 13 static cepstra from senone s.

def floored(var: np.ndarray) -> np.ndarray:
    return np.maximum(var.astype(np.float32), 1e-4).astype(np.float32)


def ln_weights(w: np.ndarray) -> np.ndarray:
    """ln of weights [..., K] as a reader computes them from the float32
    values a mixture_weights file holds."""
    w = w.astype(np.float32).astype(np.float64)
    w = np.maximum(w / w.sum(-1, keepdims=True), 1e-7)
    return np.log(w).astype(np.float32)


def peaked(rng, n_sen: int, K: int, pick: int) -> np.ndarray:
    """Weights [n_sen, K]: each row puts 0.999 of its mass on `pick`
    codewords (Dirichlet(2) among them) and spreads the rest evenly."""
    w = np.full((n_sen, K), 0.001 / K)
    for s in range(n_sen):
        ks = rng.choice(K, size=pick, replace=False)
        w[s, ks] += 0.999 * rng.dirichlet(np.full(pick, 2.0))
    return w


# ----------------------------------------------------------------------
# Writers of the Sphinx formats.

def _s3_header(fh) -> None:
    fh.write(b"s3\nversion 1.0\nendhdr\n")
    fh.write(np.array([0x11223344], dtype="<u4").tobytes())


def write_gauden(path: str, a: np.ndarray, veclen: List[int]) -> None:
    n_mgau, n_feat, K, _ = a.shape
    data = np.concatenate([a[:, f, :, :ln].reshape(n_mgau, -1)
                           for f, ln in enumerate(veclen)], axis=1)
    with open(path, "wb") as fh:
        _s3_header(fh)
        fh.write(np.asarray([n_mgau, n_feat, K, *veclen, data.size],
                            "<i4").tobytes())
        fh.write(data.astype("<f4").tobytes())


def write_s3_array(path: str, dims: List[int], data: np.ndarray) -> None:
    with open(path, "wb") as fh:
        _s3_header(fh)
        fh.write(np.asarray([*dims, data.size], "<i4").tobytes())
        fh.write(np.ascontiguousarray(data).astype("<f4").tobytes())


def write_sendump8(path: str, ln_mixw: np.ndarray,
                    logbase: float = 1.0001) -> None:
    """8-bit sendump of ln weights [n_feat, K, S]: bytes (-log_b w) >> 10,
    clamped to 159 (the reference's MAX_NEG_MIXW)."""
    ln_mixw = np.asarray(ln_mixw, np.float64)
    n_feat, n_density, n_sen = ln_mixw.shape
    scale = float((1 << SENSCR_SHIFT) * math.log(logbase))
    q = np.clip(np.round(-ln_mixw / scale), 0, 159).astype(np.uint8)

    def wstr(fh, s: str) -> None:
        b = s.encode() + b"\0"
        fh.write(struct.pack("<i", len(b)))
        fh.write(b)

    with open(path, "wb") as fh:
        for s in ("cmusphinx_tpu sendump", "1.0", f"feature_count {n_feat}",
                  f"mixture_count {n_density}", f"model_count {n_sen}",
                  f"logbase {logbase:.6f}", f"mixw_shift {SENSCR_SHIFT}",
                  "cluster_count 0"):
            wstr(fh, s)
        fh.write(struct.pack("<i", 0))
        fh.write(struct.pack("<ii", n_density, n_sen))
        fh.write(q.tobytes())


# The files of a model directory that the structure alone fixes.
STRUCTURE_FILES = ("hmm/mdef", "hmm/transition_matrices", "hmm/feat.params",
                   "hmm/noisedict", "lm.arpa", "words.dict")


def write_model_dir(task: Task, path: str) -> Dict[str, str]:
    """Write the task's model directory `path/hmm` (mdef, means, variances,
    transition_matrices, the kind's weight files, feat.params, noisedict),
    `path/lm.arpa` and `path/words.dict`.  Returns the Decoder's keyword
    arguments {"hmm", "lm", "dict"}."""
    write_structure(task, path)
    return write_weights(task, path)


def write_weights(task: Task, path: str) -> Dict[str, str]:
    """The seed's files of the model directory: means, variances and the
    kind's weight files.  Returns the Decoder's keyword arguments."""
    hmm = os.path.join(path, "hmm")
    os.makedirs(hmm, exist_ok=True)
    am = task.am
    write_gauden(os.path.join(hmm, "means"), am.means, am.veclen)
    write_gauden(os.path.join(hmm, "variances"), am.var, am.veclen)
    kinds.load(task.model).write_weights(am, hmm)
    return {"hmm": hmm, "lm": os.path.join(path, "lm.arpa"),
            "dict": os.path.join(path, "words.dict")}


def write_structure(task: Task, path: str) -> None:
    """The structure's files of the model directory (`STRUCTURE_FILES`)."""
    hmm = os.path.join(path, "hmm")
    os.makedirs(hmm, exist_ok=True)
    with open(os.path.join(hmm, "mdef"), "w") as fh:
        fh.write("\n".join(task.mdef_lines) + "\n")
    log_tp = np.where(task.tp > 0, np.log(np.maximum(task.tp, 1e-37)),
                      LOG_ZERO).astype(np.float32)
    tp = np.where(log_tp > LOG_ZERO / 2, np.exp(log_tp), 0.0)
    write_s3_array(os.path.join(hmm, "transition_matrices"),
                    list(tp.shape), tp)
    params = kinds.load(task.model).FEAT_PARAMS
    with open(os.path.join(hmm, "feat.params"), "w") as fh:
        fh.writelines(f"-{k} {v}\n" for k, v in params.items())
    with open(os.path.join(hmm, "noisedict"), "w") as fh:
        fh.write("<s> SIL\n</s> SIL\n<sil> SIL\n")
    lm = os.path.join(path, "lm.arpa")
    task.lm.write_arpa(lm)
    dic = os.path.join(path, "words.dict")
    with open(dic, "w") as fh:
        for w, p in zip(task.words, task.prons):
            fh.write(f"{w} " + " ".join(task.phones[x] for x in p) + "\n")
