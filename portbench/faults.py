"""Faults planted under the timed path, for the check's own tests and
its readings on the chip: each must turn `correct` false.

- `unchanged_state`: every block of the frame loop returns its state as
  it got it (no frame step runs);
- `half_batch`: a batch decodes its first half only, and answers the rest
  with the first half's hypotheses;
- `altered_token`: each hypothesis has its first word replaced, where the
  search assembles it, by the next word of the vocabulary.
"""

from __future__ import annotations

import dataclasses


def unchanged_state(dec) -> None:
    s = dec.search
    s._block = lambda carry, *a, **k: carry


def half_batch(dec) -> None:
    s = dec.search
    orig = s.decode_batch_cep

    def decode(ceps, fp, *a, **k):
        n = max(1, len(ceps) // 2)
        hyps = orig(ceps[:n], fp, *a, **k)
        return hyps + [hyps[i % n] for i in range(len(ceps) - n)]

    s.decode_batch_cep = decode


def _alter(search, h):
    words = search.vocab.word_str
    for i, seg in enumerate(h.segments):
        w = search.dict.wordid(seg.word)
        if w >= 0 and not search.dict.is_filler(w):
            k = (words.index(seg.word) + 1) % len(words)
            while search.vocab.is_filler[k]:
                k = (k + 1) % len(words)
            h.segments[i] = dataclasses.replace(seg, word=words[k])
            break
    return h


def altered_token(dec) -> None:
    s = dec.search
    chase, back = s._hyp_from_chase, s._backtrace
    s._hyp_from_chase = lambda *a, **k: _alter(s, chase(*a, **k))
    s._backtrace = lambda *a, **k: _alter(s, back(*a, **k))


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_token": altered_token}
