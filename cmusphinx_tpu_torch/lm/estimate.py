"""N-gram LM estimation: counting, discounting, backoff — cmuclmtk parity.

Reference: cmuclmtk/src (SURVEY.md §2.5) — the text2wfreq -> wfreq2vocab ->
text2idngram -> idngram2lm pipeline with Good-Turing / Witten-Bell /
absolute / linear discounting (liblmest/disc_meth_*.c, back-off computation
compute_back_off.c), evallm perplexity (perplexity.c), lm_combine /
lm_interpolate static interpolation.

The toolkit is host-side numpy (LM estimation is an offline counting
problem, not an accelerator workload); output is an `NgramModel`, which
writes ARPA and DMP and ships to the device for decoding via DeviceNgram.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..models.ngram import LOG10, NgramModel

BOS, EOS, UNK = "<s>", "</s>", "<UNK>"


# ----------------------------------------------------------------------
def text2wfreq(sentences: Iterable[Sequence[str]]) -> Counter:
    """Word frequency counting (text2wfreq)."""
    c: Counter = Counter()
    for sent in sentences:
        c.update(sent)
    return c


def wfreq2vocab(wfreq: Counter, top: int = 0, cutoff: int = 0) -> List[str]:
    """Vocabulary selection (wfreq2vocab -top / -gt thresholds)."""
    items = sorted(wfreq.items(), key=lambda kv: (-kv[1], kv[0]))
    if cutoff:
        items = [kv for kv in items if kv[1] > cutoff]
    if top:
        items = items[:top]
    return [w for w, _ in items]


def count_ngrams(sentences: Iterable[Sequence[str]], vocab: Sequence[str],
                 n: int = 3, use_unk: bool = False
                 ) -> Tuple[List[Dict[Tuple[int, ...], int]], List[str]]:
    """text2idngram: id n-gram counting with <s>/</s> wrapping.

    Returns ([counts_1, ..., counts_n], wordlist) where counts_k maps
    id-tuples to counts.  OOV words map to <UNK> (open vocab) or are
    context breaks (closed vocab, cmuclmtk default).
    """
    words = list(dict.fromkeys([UNK, BOS, EOS] + list(vocab))) if use_unk \
        else list(dict.fromkeys([BOS, EOS] + list(vocab)))
    wid = {w: i for i, w in enumerate(words)}
    counts: List[Dict[Tuple[int, ...], int]] = [defaultdict(int)
                                                for _ in range(n)]
    for sent in sentences:
        ids: List[Optional[int]] = [wid[BOS]]
        for w in sent:
            if w in wid:
                ids.append(wid[w])
            elif use_unk:
                ids.append(wid[UNK])
            else:
                ids.append(None)  # context break
        ids.append(wid[EOS])
        for k in range(1, n + 1):
            for i in range(len(ids) - k + 1):
                gram = ids[i : i + k]
                if any(g is None for g in gram):
                    continue
                if k == 1 and gram[0] == wid[BOS]:
                    pass  # <s> gets a unigram entry but prob mass ~0
                counts[k - 1][tuple(gram)] += 1
    return counts, words


# ----------------------------------------------------------------------
def _good_turing_discounts(cofc: Counter, k: int = 7) -> Dict[int, float]:
    """Katz/Good-Turing discount ratios d_r for r in 1..k
    (disc_meth_good_turing.c semantics; falls back to no discounting when
    count-of-count statistics are degenerate)."""
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
        # Out-of-range ratios disable discounting for that count (the
        # reference's disc_meth sanity checks) — tiny-corpus count-of-count
        # statistics are unstable.
        d[r] = dr if 0.0 < dr <= 1.0 else 1.0
    return d


def estimate_lm(counts: List[Dict[Tuple[int, ...], int]], words: List[str],
                discount: str = "good_turing", absolute_d: float = 0.5,
                cutoffs: Optional[Sequence[int]] = None) -> NgramModel:
    """idngram2lm: counts -> backoff LM (Katz / Witten-Bell / absolute).

    cutoffs[k] drops k+1-grams with count <= cutoffs[k] (idngram2lm -cutoffs).
    """
    n = len(counts)
    cutoffs = list(cutoffs or [0] * n)
    wid = {w: i for i, w in enumerate(words)}
    V = len(words)
    bos = wid[BOS]

    # Apply cutoffs (never to unigrams' vocabulary membership).
    kept: List[Dict[Tuple[int, ...], int]] = [dict(counts[0])]
    for k in range(1, n):
        kept.append({g: c for g, c in counts[k].items()
                     if c > cutoffs[k]})

    # Probabilities per order with discounting.
    probs: List[Dict[Tuple[int, ...], float]] = []
    for k in range(n):
        grams = kept[k]
        if discount == "good_turing":
            d = _good_turing_discounts(Counter(grams.values()))
        p: Dict[Tuple[int, ...], float] = {}
        if k == 0:
            total = sum(c for g, c in grams.items() if g[0] != bos)
            for g, c in grams.items():
                if g[0] == bos:
                    p[g] = 1e-99
                    continue
                if discount == "good_turing":
                    disc = d.get(c, 1.0)
                    p[g] = disc * c / total
                elif discount == "witten_bell":
                    p[g] = c / total   # WB discounts via context stats below
                elif discount == "absolute":
                    p[g] = max(c - absolute_d, 0.01) / total
                elif discount == "linear":
                    p[g] = c / total * (1 - 1.0 / (total + 1))
                else:
                    raise ValueError(discount)
            # leave unigram leftover mass implicit (normalized below)
        else:
            # context totals
            ctx_tot: Dict[Tuple[int, ...], int] = defaultdict(int)
            ctx_types: Dict[Tuple[int, ...], int] = defaultdict(int)
            for g, c in grams.items():
                ctx_tot[g[:-1]] += c
                ctx_types[g[:-1]] += 1
            for g, c in grams.items():
                tot = ctx_tot[g[:-1]]
                if discount == "good_turing":
                    p[g] = d.get(c, 1.0) * c / tot
                elif discount == "witten_bell":
                    t = ctx_types[g[:-1]]
                    p[g] = c / (tot + t)
                elif discount == "absolute":
                    p[g] = max(c - absolute_d, 1e-9) / tot
                elif discount == "linear":
                    p[g] = c / tot * (1 - 1.0 / (tot + 1))
        probs.append(p)

    # Unigram normalization with leftover mass spread over unseen words
    # (compute_unigram.c zeroton handling).
    uni = probs[0]
    mass = sum(uni.values())
    unseen = [w for w in range(V) if (w,) not in uni]
    leftover = max(1.0 - mass, 0.0)
    if unseen:
        share = max(leftover, 1e-12) / len(unseen)
        for w in unseen:
            uni[(w,)] = share
    else:
        for g in uni:
            uni[g] = uni[g] / mass if mass > 0 else 1.0 / V

    # Backoff weights (compute_back_off.c): alpha(h) = (1 - sum p(w|h)) /
    # (1 - sum p_lower(w|h')).
    bo: List[Dict[Tuple[int, ...], float]] = [dict() for _ in range(n)]
    for k in range(1, n):
        succ: Dict[Tuple[int, ...], List[Tuple[int, float]]] = defaultdict(list)
        for g, pv in probs[k].items():
            succ[g[:-1]].append((g[-1], pv))
        for h, lst in succ.items():
            num = 1.0 - sum(pv for _, pv in lst)
            den = 1.0 - sum(_lookup_prob(probs, h[1:] + (w,)) for w, _ in lst)
            num = max(num, 1e-12)
            den = max(den, 1e-12)
            bo[k - 1][h] = num / den

    # Assemble the NgramModel.
    m = NgramModel()
    m.n = n
    m.words = list(words)
    m.wid = dict(wid)
    m.ug_prob = np.full(V, -99.0 * LOG10, np.float32)
    m.ug_bo = np.zeros(V, np.float32)
    for (w,), pv in probs[0].items():
        m.ug_prob[w] = math.log(max(pv, 1e-99))
    for (w,), a in bo[0].items() if n > 1 else []:
        m.ug_bo[w] = math.log(max(a, 1e-12))
    if n > 1:
        bgs = [(math.log(max(pv, 1e-99)) / LOG10,
                (words[g[0]], words[g[1]]),
                math.log(max(bo[1].get(g, 1.0), 1e-12)) / LOG10
                if n > 2 else 0.0)
               for g, pv in probs[1].items()]
        tgs = []
        if n > 2:
            tgs = [(math.log(max(pv, 1e-99)) / LOG10,
                    tuple(words[x] for x in g), 0.0)
                   for g, pv in probs[2].items()]
        m._build_csr(bgs, tgs)
    return m


def _lookup_prob(probs, gram: Tuple[int, ...]) -> float:
    """Probability of `gram` at its own order (no backoff), for alpha dens."""
    k = len(gram) - 1
    if k == 0:
        return probs[0].get(gram, 0.0)
    return probs[k].get(gram, 0.0)


# ----------------------------------------------------------------------
def interpolate(models: Sequence[NgramModel],
                weights: Sequence[float]) -> NgramModel:
    """Static interpolation (lm_combine / lm_interpolate capability):
    P = sum_i w_i P_i over the union vocabulary, re-backed-off.

    Exact interpolation of backoff models needs all contexts; we
    interpolate at each model's explicitly-stored n-grams (union) and
    recompute backoff weights — the same approximation lm_combine makes.
    """
    assert len(models) == len(weights) and abs(sum(weights) - 1.0) < 1e-6
    vocab = list(dict.fromkeys(w for m in models for w in m.words))
    n = max(m.n for m in models)
    wid = {w: i for i, w in enumerate(vocab)}
    probs: List[Dict[Tuple[int, ...], float]] = [dict() for _ in range(n)]

    # Union of stored n-grams per order.
    def grams_of(m: NgramModel, k: int):
        if k == 0:
            for w in range(m.n_words):
                yield (m.words[w],)
        elif k == 1:
            for w1 in range(m.n_words):
                for b in range(int(m.bg_ptr[w1]), int(m.bg_ptr[w1 + 1])):
                    yield (m.words[w1], m.words[int(m.bg_wid[b])])
        elif k == 2:
            for w1 in range(m.n_words):
                for b in range(int(m.bg_ptr[w1]), int(m.bg_ptr[w1 + 1])):
                    w2 = m.words[int(m.bg_wid[b])]
                    for t in range(int(m.tg_ptr[b]), int(m.tg_ptr[b + 1])):
                        yield (m.words[w1], w2, m.words[int(m.tg_wid[t])])

    for k in range(n):
        seen = set()
        for m in models:
            if m.n <= k:
                continue
            for g in grams_of(m, k):
                if g in seen:
                    continue
                seen.add(g)
                p = 0.0
                for mm, wt in zip(models, weights):
                    ids = [mm.word_id(x) for x in g]
                    if any(i < 0 for i in ids):
                        continue
                    p += wt * math.exp(mm.score(ids[-1],
                                                ids[-2] if k >= 1 else -1,
                                                ids[-3] if k >= 2 else -1))
                probs[k][tuple(wid[x] for x in g)] = p

    # Renormalize unigrams, recompute backoffs, assemble.
    tot = sum(probs[0].values())
    for g in probs[0]:
        probs[0][g] /= tot
    bo: List[Dict[Tuple[int, ...], float]] = [dict() for _ in range(n)]
    for k in range(1, n):
        succ: Dict[Tuple[int, ...], List[Tuple[int, float]]] = defaultdict(list)
        for g, pv in probs[k].items():
            succ[g[:-1]].append((g[-1], pv))
        for h, lst in succ.items():
            num = max(1.0 - sum(pv for _, pv in lst), 1e-12)
            den = max(1.0 - sum(_lookup_prob(probs, h[1:] + (w,))
                                for w, _ in lst), 1e-12)
            bo[k - 1][h] = num / den

    out = NgramModel()
    out.n = n
    out.words = vocab
    out.wid = wid
    V = len(vocab)
    out.ug_prob = np.full(V, -99.0 * LOG10, np.float32)
    out.ug_bo = np.zeros(V, np.float32)
    for (w,), pv in probs[0].items():
        out.ug_prob[w] = math.log(max(pv, 1e-99))
    for (w,), a in (bo[0].items() if n > 1 else []):
        out.ug_bo[w] = math.log(max(a, 1e-12))
    if n > 1:
        bgs = [(math.log(max(pv, 1e-99)) / LOG10,
                (vocab[g[0]], vocab[g[1]]),
                math.log(max(bo[1].get(g, 1.0), 1e-12)) / LOG10
                if n > 2 else 0.0)
               for g, pv in probs[1].items()]
        tgs = [(math.log(max(pv, 1e-99)) / LOG10,
                tuple(vocab[x] for x in g), 0.0)
               for g, pv in probs[2].items()] if n > 2 else []
        out._build_csr(bgs, tgs)
    return out


def train_lm(sentences: Sequence[Sequence[str]], n: int = 3,
             discount: str = "good_turing", top: int = 0,
             cutoffs: Optional[Sequence[int]] = None,
             use_unk: bool = False) -> NgramModel:
    """One-call pipeline: text -> vocab -> counts -> backoff LM."""
    wfreq = text2wfreq(sentences)
    vocab = wfreq2vocab(wfreq, top=top)
    counts, words = count_ngrams(sentences, vocab, n=n, use_unk=use_unk)
    return estimate_lm(counts, words, discount=discount, cutoffs=cutoffs)
