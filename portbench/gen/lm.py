"""Trigram LM estimation and its ARPA file, for the generated tasks.

A frozen copy of the estimation the port's task generator runs
(`cmusphinx_tpu_torch.lm.estimate.train_lm` with its defaults: closed
vocabulary, Good-Turing discounts, no cutoffs; then
`NgramModel._build_csr` and `write_arpa`), in numpy and the standard
library alone, so that the benchmark's inputs do not move when the program
changes.  The arithmetic is the original's, float32 roundings included, so
the ARPA file is byte-identical to the one the program's generator writes.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

LOG10 = math.log(10.0)
BOS, EOS = "<s>", "</s>"


def _good_turing_discounts(cofc: Counter, k: int = 7) -> Dict[int, float]:
    n = {r: cofc.get(r, 0) for r in range(1, k + 2)}
    if n[1] == 0 or n.get(k + 1, 0) == 0:
        k = max((r for r in n if n[r] > 0 and n.get(r + 1, 0) > 0), default=0)
    if k < 1:
        return {}
    A = (k + 1) * n.get(k + 1, 0) / n[1] if n[1] else 0.0
    if A >= 1.0:
        return {}
    d = {}
    for r in range(1, k + 1):
        if n.get(r, 0) == 0 or n.get(r + 1, 0) == 0:
            d[r] = 1.0
            continue
        rstar = (r + 1) * n[r + 1] / n[r]
        dr = (rstar / r - A) / (1.0 - A)
        d[r] = dr if 0.0 < dr <= 1.0 else 1.0
    return d


def _count(sentences: Sequence[Sequence[str]], n: int):
    wfreq: Counter = Counter()
    for sent in sentences:
        wfreq.update(sent)
    vocab = [w for w, _ in sorted(wfreq.items(), key=lambda kv: (-kv[1], kv[0]))]
    words = list(dict.fromkeys([BOS, EOS] + vocab))
    wid = {w: i for i, w in enumerate(words)}
    counts: List[Dict[Tuple[int, ...], int]] = [defaultdict(int)
                                                for _ in range(n)]
    for sent in sentences:
        ids = [wid[BOS]] + [wid[w] for w in sent] + [wid[EOS]]
        for k in range(1, n + 1):
            for i in range(len(ids) - k + 1):
                counts[k - 1][tuple(ids[i: i + k])] += 1
    return counts, words


class ArpaLM:
    """The estimated LM as CSR arrays (natural log, float32), as the
    program's `NgramModel` holds them, with its ARPA writer."""

    def __init__(self, words, ug_prob, ug_bo, bgs, tgs):
        self.words = words
        self.wid = {w: i for i, w in enumerate(words)}
        self.ug_prob, self.ug_bo = ug_prob, ug_bo
        V = len(words)
        brows = sorted((self.wid[a], self.wid[b], p * LOG10, bo * LOG10)
                       for p, (a, b), bo in bgs)
        self.bg_ptr = np.zeros(V + 1, np.int64)
        self.bg_wid = np.asarray([b[1] for b in brows], np.int32)
        self.bg_prob = np.asarray([b[2] for b in brows], np.float32)
        self.bg_bo = np.asarray([b[3] for b in brows], np.float32)
        np.add.at(self.bg_ptr, [b[0] + 1 for b in brows], 1)
        self.bg_ptr = np.cumsum(self.bg_ptr)
        bindex = {(b[0], b[1]): i for i, b in enumerate(brows)}
        trows = sorted((bindex[(self.wid[a], self.wid[b])], self.wid[c],
                        p * LOG10) for p, (a, b, c), _ in tgs)
        self.tg_ptr = np.zeros(len(brows) + 1, np.int64)
        self.tg_wid = np.asarray([t[1] for t in trows], np.int32)
        self.tg_prob = np.asarray([t[2] for t in trows], np.float32)
        np.add.at(self.tg_ptr, [t[0] + 1 for t in trows], 1)
        self.tg_ptr = np.cumsum(self.tg_ptr)

    def write_arpa(self, path: str) -> None:
        w = self.words
        with open(path, "w") as fh:
            fh.write("\\data\\\n")
            for i, c in enumerate((len(self.ug_prob), len(self.bg_wid),
                                   len(self.tg_wid))):
                fh.write(f"ngram {i + 1}={c}\n")
            fh.write("\n\\1-grams:\n")
            for k in range(len(w)):
                fh.write(f"{self.ug_prob[k] / LOG10:.4f}\t{w[k]}\t"
                         f"{self.ug_bo[k] / LOG10:.4f}\n")
            fh.write("\n\\2-grams:\n")
            for w1 in range(len(w)):
                for b in range(int(self.bg_ptr[w1]), int(self.bg_ptr[w1 + 1])):
                    fh.write(f"{self.bg_prob[b] / LOG10:.4f}\t{w[w1]} "
                             f"{w[int(self.bg_wid[b])]}\t"
                             f"{self.bg_bo[b] / LOG10:.4f}\n")
            fh.write("\n\\3-grams:\n")
            for w1 in range(len(w)):
                for b in range(int(self.bg_ptr[w1]), int(self.bg_ptr[w1 + 1])):
                    w2 = w[int(self.bg_wid[b])]
                    for t in range(int(self.tg_ptr[b]), int(self.tg_ptr[b + 1])):
                        fh.write(f"{self.tg_prob[t] / LOG10:.4f}\t{w[w1]} {w2} "
                                 f"{w[int(self.tg_wid[t])]}\n")
            fh.write("\n\\end\\\n")


def train_lm(sentences: Sequence[Sequence[str]], n: int = 3) -> ArpaLM:
    """Sentences -> a Katz backoff trigram LM (Good-Turing discounts)."""
    counts, words = _count(sentences, n)
    wid = {w: i for i, w in enumerate(words)}
    V = len(words)
    bos = wid[BOS]
    probs: List[Dict[Tuple[int, ...], float]] = []
    for k in range(n):
        grams = dict(counts[k])
        d = _good_turing_discounts(Counter(grams.values()))
        p: Dict[Tuple[int, ...], float] = {}
        if k == 0:
            total = sum(c for g, c in grams.items() if g[0] != bos)
            for g, c in grams.items():
                p[g] = 1e-99 if g[0] == bos else d.get(c, 1.0) * c / total
        else:
            ctx_tot: Dict[Tuple[int, ...], int] = defaultdict(int)
            for g, c in grams.items():
                ctx_tot[g[:-1]] += c
            for g, c in grams.items():
                p[g] = d.get(c, 1.0) * c / ctx_tot[g[:-1]]
        probs.append(p)

    uni = probs[0]
    mass = sum(uni.values())
    unseen = [w for w in range(V) if (w,) not in uni]
    if unseen:
        share = max(max(1.0 - mass, 0.0), 1e-12) / len(unseen)
        for w in unseen:
            uni[(w,)] = share
    else:
        for g in uni:
            uni[g] = uni[g] / mass if mass > 0 else 1.0 / V

    bo: List[Dict[Tuple[int, ...], float]] = [dict() for _ in range(n)]
    for k in range(1, n):
        succ: Dict[Tuple[int, ...], List[Tuple[int, float]]] = defaultdict(list)
        for g, pv in probs[k].items():
            succ[g[:-1]].append((g[-1], pv))
        for h, lst in succ.items():
            num = max(1.0 - sum(pv for _, pv in lst), 1e-12)
            den = max(1.0 - sum(probs[len(h) - 1].get(h[1:] + (w,), 0.0)
                                for w, _ in lst), 1e-12)
            bo[k - 1][h] = num / den

    ug_prob = np.full(V, -99.0 * LOG10, np.float32)
    ug_bo = np.zeros(V, np.float32)
    for (w,), pv in probs[0].items():
        ug_prob[w] = math.log(max(pv, 1e-99))
    for (w,), a in bo[0].items():
        ug_bo[w] = math.log(max(a, 1e-12))
    bgs = [(math.log(max(pv, 1e-99)) / LOG10, (words[g[0]], words[g[1]]),
            math.log(max(bo[1].get(g, 1.0), 1e-12)) / LOG10)
           for g, pv in probs[1].items()]
    tgs = [(math.log(max(pv, 1e-99)) / LOG10, tuple(words[x] for x in g), 0.0)
           for g, pv in probs[2].items()]
    return ArpaLM(words, ug_prob, ug_bo, bgs, tgs)
