"""The comparison that decides `correct`: what the timed path produced,
held to the plain reference (`reference/`), once the window has closed.

Numbers (a configuration's `check` names the ones compared, each with its
limit; the others are printed beside them):

- `score_gap`: over the kept scorer calls (every real frame of the checked
  batches) and every senone, the largest
  |served score - reference score| / (1 + |reference score|);
- `score_miss_share`: the share of those scores off the reference by
  more than 0.05 nats (half of a semi-continuous score's quantum,
  1024 ln 1.0001);
- `word_gap`: over the checked hypotheses' word segments, the largest gap
  (nats a frame) by which the served word's score lies below the best
  word's over the same frames (`reference/hyps.py`);
- `missing`: answers due in the window that never came or came empty,
  kept scorer calls of the wrong shape, checked hypotheses that could not
  be read.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .reference import hyps as ref_hyps
from .reference import model as ref_model
from .reference import scores as ref_scores

MISS_NATS = 0.05


class Check:
    def __init__(self, model_kw: Dict[str, str], cfg: dict, device):
        self.device = str(device)
        self.model = ref_model.read_model(model_kw["hmm"], model_kw["lm"],
                                          model_kw["dict"], cfg["model"])
        self.scorer = ref_scores.reference_scorer(self.model, self.device)
        dec = cfg.get("decoder", {})
        self.words = ref_hyps.WordChecker(self.model, dec.get("lw", 6.5),
                                          dec.get("wip", 0.65), self.device)
        self._ref: Dict[int, torch.Tensor] = {}

    def reference(self, ceps, u: int) -> torch.Tensor:
        """The reference's senone scores [T, S] of pool utterance u."""
        if u not in self._ref:
            with torch.no_grad():
                x = ref_scores.features(ceps[u], device=self.device)
                self._ref[u] = self.scorer(x)
        return self._ref[u]

    def run(self, window, kept, ceps, plan) -> Dict[str, float]:
        gap, miss, n, missing = 0.0, 0, 0, int(window.failed)
        word_gaps: List[float] = []

        def scores(served: torch.Tensor, ref: torch.Tensor):
            nonlocal gap, miss, n
            d = (served.double() - ref).abs()
            gap = max(gap, float((d / (1.0 + ref.abs())).max()))
            miss += int((d > MISS_NATS).sum())
            n += d.numel()

        def words(u: int, h) -> None:
            nonlocal missing
            if h is None or not h.segments:
                missing += 1
                return
            segs = [(s.word, int(s.start_frame), int(s.end_frame))
                    for s in h.segments]
            word_gaps.extend(self.words.check(self.reference(ceps, u), segs))

        answers = {}
        for i, j, h in window.answers:
            answers.setdefault(i, []).append((j, h))
        for i, out in kept:
            idx = plan[i]
            if out.dim() != 3 or out.shape[0] != len(idx):
                missing += 1
                continue
            for b, u in enumerate(idx):
                T = len(ceps[u])
                scores(out[b, :T], self.reference(ceps, u))
            for u, h in answers.get(i, []):
                words(u, h)
        return {
            "score_gap": gap if n else math.inf,
            "score_miss_share": miss / n if n else math.inf,
            "word_gap": max(word_gaps) if word_gaps else math.inf,
            "missing": float(missing),
        }
