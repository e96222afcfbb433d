"""Letter-to-sound (grapheme-to-phoneme) fallback for OOV words.

Capability parity with sphinx3's LTS dictionary fallback (reference:
sphinx3/src/libs3decoder/libdict/lts.c applying the CMU6 rule table
cmu6_lts_rules.c; dict lookup falls back to LTS when a word is missing).
The reference ships a hand-built decision-tree rule table; this module
instead LEARNS the rules from a pronouncing dictionary (e.g. the shipped
cmudict data) — a data-driven re-design, no rule table to port:

1. EM alignment of letters to phone chunks (1 letter -> 0..2 phones),
   the classic joint-sequence G2P alignment.
2. Context rules: for each (letter, left k letters, right k letters)
   context, the most likely phone chunk, backed off to shorter contexts.
3. Prediction: per-letter longest-context match (greedy decision-list,
   the same decision structure as the reference's tree rules).

Training is a few seconds over cmudict on the host (counting, no FLOPs);
prediction is O(len(word)) table lookups.
"""

from __future__ import annotations

import re
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

_EPS = ""  # empty phone chunk (letter emits nothing)


def _clean_word(w: str) -> Optional[str]:
    w = w.split("(")[0].strip().upper()
    if not w or not re.fullmatch(r"[A-Z][A-Z']*", w):
        return None
    return w


def read_cmudict(path: str, max_words: int = 0) -> List[Tuple[str, List[str]]]:
    """Parse a cmudict-format file into (word, phones) pairs; stress digits
    are stripped to match Sphinx phone sets (cmudict/sphinxdict capability)."""
    out = []
    with open(path, "rb") as fh:
        for line in fh:
            try:
                s = line.decode("latin-1").strip()
            except Exception:
                continue
            if not s or s.startswith(("#", ";;")):
                continue
            parts = s.split()
            if len(parts) < 2:
                continue
            w = _clean_word(parts[0])
            if w is None:
                continue
            phones = [re.sub(r"\d", "", p).upper() for p in parts[1:]]
            if not all(re.fullmatch(r"[A-Z]+", p) for p in phones):
                continue
            out.append((w, phones))
            if max_words and len(out) >= max_words:
                break
    return out


def _align(word: str, phones: List[str], scores: Dict[Tuple[str, str], float]
           ) -> Optional[List[str]]:
    """Viterbi monotone alignment: each letter emits 0, 1, or 2 phones.
    Returns per-letter phone chunks (space-joined) or None."""
    L, P = len(word), len(phones)
    NEG = -1e30
    dp = [[NEG] * (P + 1) for _ in range(L + 1)]
    bp: List[List[int]] = [[0] * (P + 1) for _ in range(L + 1)]
    dp[0][0] = 0.0
    for i in range(1, L + 1):
        c = word[i - 1]
        for j in range(P + 1):
            best, arg = NEG, -1
            for k in (0, 1, 2):  # phones consumed by this letter
                if j - k < 0:
                    continue
                chunk = " ".join(phones[j - k : j])
                # Unseen pairs: prefer 1:1 letter->phone alignments.
                s = dp[i - 1][j - k] + scores.get(
                    (c, chunk), -8.0 - 6.0 * abs(k - 1))
                if s > best:
                    best, arg = s, k
            dp[i][j] = best
            bp[i][j] = arg
    if dp[L][P] <= NEG * 0.5:
        return None
    chunks: List[str] = []
    j = P
    for i in range(L, 0, -1):
        k = bp[i][j]
        chunks.append(" ".join(phones[j - k : j]))
        j -= k
    chunks.reverse()
    return chunks


class LtsModel:
    """Learned decision-list letter-to-sound rules."""

    def __init__(self, rules: Dict[Tuple[str, str, str], str], k: int):
        self.rules = rules     # (letter, left ctx, right ctx) -> chunk
        self.k = k

    def predict(self, word: str) -> List[str]:
        """Word -> phone sequence via longest-context rule match."""
        w = _clean_word(word)
        if w is None:
            return []
        w = w.replace("'", "")
        pad = "#" * self.k
        s = pad + w + pad
        phones: List[str] = []
        for i, c in enumerate(w):
            pos = i + self.k
            chunk = None
            for kk in range(self.k, -1, -1):
                key = (c, s[pos - kk : pos], s[pos + 1 : pos + 1 + kk])
                if key in self.rules:
                    chunk = self.rules[key]
                    break
            if chunk:
                phones.extend(chunk.split())
        return phones

    # ------------------------------------------------------------------
    @classmethod
    def train(cls, entries: Sequence[Tuple[str, List[str]]], k: int = 3,
              em_iters: int = 3, min_count: int = 2) -> "LtsModel":
        """Learn rules from (word, phones) pairs."""
        import math
        # EM over alignment scores.
        scores: Dict[Tuple[str, str], float] = {}
        for it in range(em_iters):
            counts: Counter = Counter()
            letter_tot: Counter = Counter()
            for w, ph in entries:
                wl = w.replace("'", "")
                if not wl:
                    continue
                chunks = _align(wl, ph, scores)
                if chunks is None:
                    continue
                for c, chunk in zip(wl, chunks):
                    counts[(c, chunk)] += 1
                    letter_tot[c] += 1
            scores = {
                key: math.log(n / letter_tot[key[0]])
                for key, n in counts.items()}
        # Context rule extraction from the final alignment.
        ctx_counts: Dict[Tuple[str, str, str], Counter] = defaultdict(Counter)
        pad = "#" * k
        for w, ph in entries:
            wl = w.replace("'", "")
            if not wl:
                continue
            chunks = _align(wl, ph, scores)
            if chunks is None:
                continue
            s = pad + wl + pad
            for i, (c, chunk) in enumerate(zip(wl, chunks)):
                pos = i + k
                for kk in range(k + 1):
                    key = (c, s[pos - kk : pos], s[pos + 1 : pos + 1 + kk])
                    ctx_counts[key][chunk] += 1
        rules: Dict[Tuple[str, str, str], str] = {}
        for key, cnt in ctx_counts.items():
            chunk, n = cnt.most_common(1)[0]
            total = sum(cnt.values())
            kk = len(key[1])
            # Context-free rules (kk=0) always included as final backoff;
            # longer contexts must be reliable and better than the backoff.
            if kk == 0 or (total >= min_count and n / total > 0.9):
                rules[key] = chunk
        return cls(rules, k)

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(f"LTS {self.k}\n")
            for (c, lc, rc), chunk in sorted(self.rules.items()):
                fh.write(f"{c}\t{lc}\t{rc}\t{chunk}\n")

    @classmethod
    def load(cls, path: str) -> "LtsModel":
        rules: Dict[Tuple[str, str, str], str] = {}
        with open(path) as fh:
            head = fh.readline().split()
            k = int(head[1])
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) == 4:
                    rules[(parts[0], parts[1], parts[2])] = parts[3]
        return cls(rules, k)


def train_from_cmudict(path: str, k: int = 3, max_words: int = 0,
                       **kwargs) -> LtsModel:
    return LtsModel.train(read_cmudict(path, max_words=max_words), k=k,
                          **kwargs)
