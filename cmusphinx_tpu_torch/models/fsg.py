"""Finite-state grammar model.

Capability parity with fsg_model.c (reference:
sphinxbase/src/libsphinxbase/lm/fsg_model.c, fsg_model.h:64-105): integer
states, word and null (epsilon) transitions with log probabilities, text
format read/write (`FSG_BEGIN/NUM_STATES/START_STATE/FINAL_STATE/TRANSITION`),
null-transition closure, silence/alternate-pronunciation self loops
(`fsg_model_add_silence` / `fsg_model_add_alt`).

Log domain is natural log floats (the reference uses int logmath).
Language weight `lw` scales transition log-probs at decode-graph build time.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, TextIO, Tuple

import numpy as np


@dataclass
class FsgLink:
    from_state: int
    to_state: int
    logprob: float          # natural log, unscaled by lw
    wid: int                # index into FsgModel.vocab; -1 = null transition


class FsgModel:
    def __init__(self, name: str = "", n_state: int = 0, start_state: int = 0,
                 final_state: int = 0, lw: float = 1.0):
        self.name = name
        self.n_state = n_state
        self.start_state = start_state
        self.final_state = final_state
        self.lw = lw
        self.vocab: List[str] = []
        self._windex: Dict[str, int] = {}
        self.links: List[FsgLink] = []
        # silence/alt bookkeeping (word id -> True)
        self.silwords: Dict[int, bool] = {}
        self.altwords: Dict[int, bool] = {}

    # ------------------------------------------------------------------
    def word_id(self, word: str) -> int:
        return self._windex.get(word, -1)

    def word_add(self, word: str) -> int:
        wid = self._windex.get(word)
        if wid is None:
            wid = len(self.vocab)
            self.vocab.append(word)
            self._windex[word] = wid
        return wid

    @property
    def n_word(self) -> int:
        return len(self.vocab)

    def add_link(self, frm: int, to: int, logprob: float, word: Optional[str]) -> FsgLink:
        wid = self.word_add(word) if word is not None else -1
        link = FsgLink(frm, to, float(logprob), wid)
        self.links.append(link)
        return link

    def trans_add(self, frm: int, to: int, logprob: float, wid: int) -> FsgLink:
        link = FsgLink(frm, to, float(logprob), wid)
        self.links.append(link)
        return link

    # ------------------------------------------------------------------
    @classmethod
    def read(cls, path: str, lw: float = 1.0) -> "FsgModel":
        with open(path, "r", errors="replace") as fh:
            return cls.read_fp(fh, lw=lw)

    @classmethod
    def read_fp(cls, fh: TextIO, lw: float = 1.0) -> "FsgModel":
        fsg = None
        for raw in fh:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            kw = parts[0].upper()
            if kw in ("FSG_BEGIN",):
                fsg = cls(name=parts[1] if len(parts) > 1 else "", lw=lw)
            elif fsg is None:
                continue
            elif kw in ("NUM_STATES", "N"):
                fsg.n_state = int(parts[1])
            elif kw in ("START_STATE", "S"):
                fsg.start_state = int(parts[1])
            elif kw in ("FINAL_STATE", "F"):
                fsg.final_state = int(parts[1])
            elif kw in ("TRANSITION", "T"):
                frm, to = int(parts[1]), int(parts[2])
                prob = float(parts[3])
                word = parts[4] if len(parts) > 4 else None
                lp = math.log(prob) if prob > 0 else -1e30
                fsg.add_link(frm, to, lp, word)
            elif kw == "FSG_END":
                break
        if fsg is None:
            raise ValueError("no FSG_BEGIN found")
        return fsg

    def write(self, fh: TextIO) -> None:
        fh.write(f"FSG_BEGIN {self.name}\n")
        fh.write(f"NUM_STATES {self.n_state}\n")
        fh.write(f"START_STATE {self.start_state}\n")
        fh.write(f"FINAL_STATE {self.final_state}\n\n")
        for l in self.links:
            word = f" {self.vocab[l.wid]}" if l.wid >= 0 else ""
            fh.write(f"TRANSITION {l.from_state} {l.to_state} "
                     f"{math.exp(l.logprob):.6g}{word}\n")
        fh.write("FSG_END\n")

    # ------------------------------------------------------------------
    def add_silence(self, silword: str, state: int, silprob: float) -> None:
        """Add a silence self-loop at one state (or all if state < 0)."""
        lp = math.log(silprob) if silprob > 0 else -1e30
        states = range(self.n_state) if state < 0 else [state]
        for s in states:
            link = self.add_link(s, s, lp, silword)
            self.silwords[link.wid] = True

    def add_alt(self, baseword: str, altword: str) -> int:
        """Duplicate all transitions labeled `baseword` with `altword`
        (fsg_model_add_alt): used for alternate pronunciations."""
        base_wid = self.word_id(baseword)
        if base_wid < 0:
            return 0
        alt_wid = self.word_add(altword)
        self.altwords[alt_wid] = True
        n = 0
        for l in list(self.links):
            if l.wid == base_wid:
                self.links.append(FsgLink(l.from_state, l.to_state, l.logprob, alt_wid))
                n += 1
        return n

    # ------------------------------------------------------------------
    def null_closure(self) -> np.ndarray:
        """Best-prob epsilon closure: closure[i, j] = max log prob of
        reaching j from i via null transitions only (diag = 0).

        Returns a dense [n_state, n_state] float32 matrix with -inf where
        unreachable — the dense analog of fsg_model_null_trans_closure.
        """
        n = self.n_state
        c = np.full((n, n), -np.inf, np.float64)
        np.fill_diagonal(c, 0.0)
        for l in self.links:
            if l.wid < 0:
                c[l.from_state, l.to_state] = max(
                    c[l.from_state, l.to_state], l.logprob * self.lw)
        # Floyd-Warshall max-plus closure over epsilon arcs.
        for k in range(n):
            np.maximum(c, c[:, k : k + 1] + c[k : k + 1, :], out=c)
        return c.astype(np.float32)

    def word_links(self) -> List[FsgLink]:
        return [l for l in self.links if l.wid >= 0]

    def accept(self, words: List[str]) -> bool:
        """Host-side recognizer (for tests): can the FSG emit this word
        sequence from start to final state?"""
        closure = self.null_closure()
        cur = {s for s in range(self.n_state)
               if np.isfinite(closure[self.start_state, s])}
        by_word: Dict[int, List[FsgLink]] = {}
        for l in self.word_links():
            by_word.setdefault(l.wid, []).append(l)
        for w in words:
            wid = self.word_id(w)
            if wid < 0:
                return False
            nxt = set()
            for l in by_word.get(wid, []):
                if l.from_state in cur:
                    for s in range(self.n_state):
                        if np.isfinite(closure[l.to_state, s]):
                            nxt.add(s)
            cur = nxt
            if not cur:
                return False
        return self.final_state in cur
