"""Readers of a generated model directory for the plain reference.

Written from the Sphinx formats themselves (text mdef, s3 gauden and
array files, the 8-bit sendump, feat.params, the dictionary, ARPA), in
numpy and the standard library; they share no code with the program.
Each kind's weight files are read by its `kinds/<model>.py`.
"""

from __future__ import annotations

import math
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .. import kinds

LOG10 = math.log(10.0)


def _s3_body(path: str) -> bytes:
    """The bytes after an s3 header ("s3", key/value lines, "endhdr", the
    little-endian byte-order magic)."""
    data = open(path, "rb").read()
    end = data.index(b"endhdr\n") + len(b"endhdr\n")
    if struct.unpack_from("<I", data, end)[0] != 0x11223344:
        raise ValueError(f"{path}: not a little-endian s3 file")
    return data[end + 4:]


def read_gauden(path: str) -> Tuple[List[np.ndarray], List[int]]:
    """means or variances -> per stream [n_mgau, K, veclen_f] float64."""
    body = _s3_body(path)
    n_mgau, n_feat, K = struct.unpack_from("<3i", body, 0)
    veclen = list(struct.unpack_from(f"<{n_feat}i", body, 12))
    off = 12 + 4 * n_feat + 4
    data = np.frombuffer(body, "<f4", n_mgau * K * sum(veclen), off)
    data = data.reshape(n_mgau, K * sum(veclen)).astype(np.float64)
    out, pos = [], 0
    for ln in veclen:
        out.append(data[:, pos: pos + K * ln].reshape(n_mgau, K, ln))
        pos += K * ln
    return out, veclen


def read_s3_array(path: str, ndim: int) -> np.ndarray:
    body = _s3_body(path)
    dims = struct.unpack_from(f"<{ndim}i", body, 0)
    n = struct.unpack_from("<i", body, 4 * ndim)[0]
    return np.frombuffer(body, "<f4", n, 4 * ndim + 4).reshape(dims).astype(
        np.float64)


def read_sendump8(path: str) -> np.ndarray:
    """8-bit sendump -> raw bytes [n_feat, K, S] (int64)."""
    data = open(path, "rb").read()
    pos, info = 0, {}
    while True:
        (k,) = struct.unpack_from("<i", data, pos)
        pos += 4
        if k == 0:
            break
        s = data[pos: pos + k - 1].decode()
        pos += k
        key, _, val = s.partition(" ")
        info[key] = val
    if int(info.get("cluster_count", "0")) != 0:
        raise ValueError(f"{path}: only 8-bit sendumps are read here")
    K, S = struct.unpack_from("<ii", data, pos)
    pos += 8
    F = int(info["feature_count"])
    raw = np.frombuffer(data, np.uint8, F * K * S, pos).reshape(F, K, S)
    return raw.astype(np.int64)


@dataclass
class Mdef:
    ci: List[str]
    sil: int
    ci_states: np.ndarray                       # [n_ci, 3]
    ci_tmat: np.ndarray                         # [n_ci]
    # (base, left, right, position) -> (tmat, senones of its 3 states)
    tri: Dict[Tuple[int, int, int, str], Tuple[int, Tuple[int, ...]]]
    n_sen: int


def read_mdef(path: str) -> Mdef:
    rows, counts = [], {}
    for ln in open(path):
        ln = ln.strip()
        if not ln or ln.startswith("#") or ln == "0.3":
            continue
        parts = ln.split()
        if len(parts) == 2 and parts[1].startswith("n_"):
            counts[parts[1]] = int(parts[0])
        else:
            rows.append(parts)
    ci = [p[0] for p in rows if p[1] == "-"]
    cid = {n: i for i, n in enumerate(ci)}
    ci_states = np.zeros((len(ci), 3), np.int64)
    ci_tmat = np.zeros(len(ci), np.int64)
    tri = {}
    for p in rows:
        states = tuple(int(s) for s in p[6:-1])
        if p[1] == "-":
            ci_states[cid[p[0]]] = states
            ci_tmat[cid[p[0]]] = int(p[5])
        else:
            tri[(cid[p[0]], cid[p[1]], cid[p[2]], p[3])] = (int(p[5]), states)
    sil = cid.get("SIL", -1)
    return Mdef(ci, sil, ci_states, ci_tmat, tri, counts["n_tied_state"])


def read_dict(path: str) -> Dict[str, List[str]]:
    out = {}
    for ln in open(path):
        parts = ln.split()
        if parts:
            out[parts[0]] = parts[1:]
    return out


def read_feat_params(path: str) -> Dict[str, str]:
    out = {}
    for ln in open(path):
        parts = ln.split()
        if len(parts) == 2 and parts[0].startswith("-"):
            out[parts[0][1:]] = parts[1]
    return out


@dataclass
class Arpa:
    """A backoff trigram LM in natural logs: unigrams and their backoffs
    [V], bigram and trigram successor lists by history."""
    words: List[str]
    wid: Dict[str, int]
    ug: np.ndarray
    ug_bo: np.ndarray
    bg: Dict[int, Tuple[np.ndarray, np.ndarray]] = field(default_factory=dict)
    bg_bo: Dict[Tuple[int, int], float] = field(default_factory=dict)
    tg: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = field(
        default_factory=dict)

    def scores(self, h2: int, h1: int) -> np.ndarray:
        """ln P(w | h2 h1) for every word w (h2 < 0: a bigram history;
        h1 < 0: unigrams), by the backoff rules."""
        if h1 < 0:
            return self.ug.copy()
        p = self.ug_bo[h1] + self.ug
        if h1 in self.bg:
            ids, lp = self.bg[h1]
            p[ids] = lp
        if h2 >= 0 and (h2, h1) in self.bg_bo:
            p = p + self.bg_bo[(h2, h1)]
            if (h2, h1) in self.tg:
                ids, lp = self.tg[(h2, h1)]
                p[ids] = lp
        return p


def read_arpa(path: str) -> Arpa:
    order, uni, bi, tri = 0, [], [], []
    for ln in open(path):
        ln = ln.strip()
        if not ln or ln.startswith("ngram ") or ln == "\\data\\":
            continue
        if ln.startswith("\\") and ln.endswith("-grams:"):
            order = int(ln[1])
            continue
        if ln == "\\end\\":
            break
        parts = ln.split()
        (uni, bi, tri)[order - 1].append(parts)
    words = [p[1] for p in uni]
    wid = {w: i for i, w in enumerate(words)}
    ug = np.asarray([float(p[0]) for p in uni]) * LOG10
    ug_bo = np.asarray([float(p[2]) if len(p) > 2 else 0.0 for p in uni]) * LOG10
    lm = Arpa(words, wid, ug, ug_bo)
    succ: Dict[int, List[Tuple[int, float]]] = {}
    for p in bi:
        a, b = wid[p[1]], wid[p[2]]
        succ.setdefault(a, []).append((b, float(p[0]) * LOG10))
        lm.bg_bo[(a, b)] = float(p[3]) * LOG10 if len(p) > 3 else 0.0
    lm.bg = {a: (np.asarray([x[0] for x in v]), np.asarray([x[1] for x in v]))
             for a, v in succ.items()}
    tsucc: Dict[Tuple[int, int], List[Tuple[int, float]]] = {}
    for p in tri:
        key = (wid[p[1]], wid[p[2]])
        tsucc.setdefault(key, []).append((wid[p[3]], float(p[0]) * LOG10))
    lm.tg = {k: (np.asarray([x[0] for x in v]), np.asarray([x[1] for x in v]))
             for k, v in tsucc.items()}
    return lm


@dataclass
class Model:
    """What the reference needs of a model directory."""
    kind: str                        # the configuration's kind (`kinds/`)
    mdef: Mdef
    means: List[np.ndarray]          # per stream [n_mgau, K, d]
    var: List[np.ndarray]
    veclen: List[int]
    log_tp: np.ndarray               # [n_tmat, 3, 4] natural log
    feat_params: Dict[str, str]
    weights: dict = None             # the kind's `read_weights`
    words: Dict[str, List[str]] = None
    lm: Arpa = None


def read_model(hmm: str, lm: str, dic: str, kind: str,
               varfloor: float = 1e-4) -> Model:
    """The model directory as the configuration's kind reads it: the kind
    comes from the configuration, never from which files exist."""
    mdef = read_mdef(os.path.join(hmm, "mdef"))
    means, veclen = read_gauden(os.path.join(hmm, "means"))
    var, _ = read_gauden(os.path.join(hmm, "variances"))
    var = [np.maximum(v, varfloor) for v in var]
    tp = read_s3_array(os.path.join(hmm, "transition_matrices"), 3)
    with np.errstate(divide="ignore"):
        log_tp = np.where(tp > 0, np.log(np.maximum(tp, 1e-300)), -np.inf)
    m = Model(kind=kind, mdef=mdef, means=means, var=var, veclen=veclen,
              log_tp=log_tp,
              feat_params=read_feat_params(os.path.join(hmm, "feat.params")),
              words=read_dict(dic), lm=read_arpa(lm))
    m.weights = kinds.load(kind).read_weights(hmm, m)
    return m
