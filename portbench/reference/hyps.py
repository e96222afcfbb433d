"""The plain reference's check of a hypothesis, word by word.

For each word segment (word, first frame, last frame) of a served
hypothesis, the reference scores every word of the vocabulary over exactly
those frames: its triphone chain with the contexts the hypothesis gives it
(the previous word's last phone, the next word's first phone; SIL at the
ends and beside fillers), Viterbi through the model's transition matrices
(self loop, next state, skip; a phone's exit enters the next phone's first
state), on the reference's own senone scores; plus lw * ln P(w | the two
previous words) + ln(wip) from the ARPA file.  The served word's gap is by
how much its score lies below the best word's, per frame of the segment:
0 where the served word is the best.  Fillers are not checked; they are
context only.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

NEG = float("-inf")


class WordChecker:
    def __init__(self, model, lw: float, wip: float, device: str):
        md = model.mdef
        self.device, self.lw, self.log_wip = device, float(lw), math.log(wip)
        self.sil = md.sil
        cid = {n: i for i, n in enumerate(md.ci)}
        lm = model.lm
        self.fillers = {"<s>", "</s>", "<sil>"}
        names = [w for w in model.words if w in lm.wid and w not in self.fillers]
        self.names = names
        self.index = {w: i for i, w in enumerate(names)}
        self.lmid = np.asarray([lm.wid[w] for w in names])
        self.lm = lm
        prons = [[cid[p] for p in model.words[w]] for w in names]
        self.first = {w: p[0] for w, p in zip(names, prons)}
        self.last = {w: p[-1] for w, p in zip(names, prons)}
        V, L = len(names), max(len(p) for p in prons)
        n_ci = len(md.ci)
        # Dense (base, left, right) tables of each word position: the
        # triphone's tmat and senones (-1: absent).
        tabs = {}
        for pos in "bie":
            sen = np.full((n_ci, n_ci, n_ci, 3), -1, np.int64)
            tm = np.zeros((n_ci, n_ci, n_ci), np.int64)
            tabs[pos] = (sen, tm)
        for (b, l, r, pos), (tm, st) in md.tri.items():
            if pos in tabs:
                tabs[pos][0][b, l, r] = st
                tabs[pos][1][b, l, r] = tm
        self.tabs = {k: (torch.as_tensor(s, device=device),
                         torch.as_tensor(t, device=device))
                     for k, (s, t) in tabs.items()}
        ph = np.full((V, L), 0, np.int64)
        for v, p in enumerate(prons):
            ph[v, : len(p)] = p
        self.nph = torch.as_tensor([len(p) for p in prons], device=device)
        self.ph = torch.as_tensor(ph, device=device)
        self.L = L
        self.log_tp = torch.as_tensor(model.log_tp, device=device)   # [n_tmat, 3, 4]
        # Word-internal triphones: fixed a word.
        V_ar = torch.arange(V, device=device)
        j = torch.arange(L, device=device)[None, :]
        prv = self.ph[:, (j[0] - 1).clamp_min(0)]
        nxt = self.ph[:, (j[0] + 1).clamp_max(L - 1)]
        sen_i, tm_i = self.tabs["i"]
        self.sen_i = sen_i[self.ph, prv, nxt]                   # [V, L, 3]
        self.tm_i = tm_i[self.ph, prv, nxt]                     # [V, L]
        self._V_ar = V_ar

    def _chains(self, lc: int, rc: int):
        """Senones [V, 3L] and transition weights (self, next, skip) [V, 3L]
        of every word between left context lc and right context rc."""
        V, L = len(self.names), self.L
        ph, n = self.ph, self.nph
        last = n - 1
        pL = ph[self._V_ar, last]
        pL1 = ph[self._V_ar, (last - 1).clamp_min(0)]
        sen_b, tm_b = self.tabs["b"]
        sen_e, tm_e = self.tabs["e"]
        sen = self.sen_i.clone()
        tm = self.tm_i.clone()
        sen[:, 0] = sen_b[ph[:, 0], lc, ph[:, 1]]
        tm[:, 0] = tm_b[ph[:, 0], lc, ph[:, 1]]
        sen[self._V_ar, last] = sen_e[pL, pL1, rc]
        tm[self._V_ar, last] = tm_e[pL, pL1, rc]
        pos = torch.arange(L, device=self.device)[None, :]
        real = pos < n[:, None]
        sen = torch.where(real[..., None], sen, -1).reshape(V, 3 * L)
        tp = self.log_tp[tm]                                     # [V, L, 3, 4]
        j = torch.arange(3, device=self.device)
        stay = tp[:, :, j, j].reshape(V, 3 * L)
        nxt = tp[:, :, j, j + 1].reshape(V, 3 * L)
        skip = torch.cat([tp[:, :, j[:2], j[:2] + 2],
                          torch.full((V, L, 1), NEG, dtype=tp.dtype,
                                     device=self.device)], -1).reshape(V, 3 * L)
        return sen, stay, nxt, skip

    def segment_scores(self, scores: torch.Tensor, sf: int, ef: int,
                       lc: int, rc: int, h2: int, h1: int) -> torch.Tensor:
        """Every word's score [V] over frames sf..ef (inclusive)."""
        sen, stay, nxt, skip = self._chains(lc, rc)
        bad = sen < 0
        senc = sen.clamp_min(0)
        alpha = None
        for t in range(sf, ef + 1):
            emit = scores[t][senc].masked_fill(bad, NEG)
            if alpha is None:
                alpha = torch.full_like(emit, NEG)
                alpha[:, 0] = emit[:, 0]
                continue
            a = alpha + stay
            a[:, 1:] = torch.maximum(a[:, 1:], alpha[:, :-1] + nxt[:, :-1])
            a[:, 2:] = torch.maximum(a[:, 2:], alpha[:, :-2] + skip[:, :-2])
            alpha = a + emit
        k = 3 * self.nph
        rows = self._V_ar
        exit_ = torch.maximum(alpha[rows, k - 1] + nxt[rows, k - 1],
                              alpha[rows, k - 2] + skip[rows, k - 2])
        lm = torch.as_tensor(self.lm.scores(h2, h1)[self.lmid],
                             device=self.device, dtype=exit_.dtype)
        return exit_ + self.lw * lm + self.log_wip

    def check(self, scores: torch.Tensor,
              segments: Sequence[Tuple[str, int, int]]) -> List[float]:
        """The gap (nats a frame) of each non-filler segment of a
        hypothesis; inf for a word the vocabulary lacks or a segment
        outside the utterance's frames."""
        T = scores.shape[0]
        wid = self.lm.wid
        gaps = []
        hist = [wid["<s>"]]
        for i, (w, sf, ef) in enumerate(segments):
            if w in self.fillers or w.startswith("++"):
                continue
            if w not in self.index or not 0 <= sf <= ef < T:
                gaps.append(math.inf)
                hist.append(-1)
                continue
            prev = segments[i - 1][0] if i else None
            nxt = segments[i + 1][0] if i + 1 < len(segments) else None
            lc = self.last.get(prev, self.sil)
            rc = self.first.get(nxt, self.sil)
            h1 = hist[-1]
            h2 = hist[-2] if len(hist) > 1 else -1
            s = self.segment_scores(scores, sf, ef, lc, rc, h2, h1)
            served = s[self.index[w]]
            best = s.max()
            gap = float(best - served) / (ef - sf + 1)
            gaps.append(gap if math.isfinite(gap) else math.inf)
            hist.append(wid[w])
        return gaps
