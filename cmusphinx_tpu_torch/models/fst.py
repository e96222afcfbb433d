"""ATT FSM (OpenFst-compatible text) exporters for LMs, FSGs, and
dictionaries.

Capability parity with the reference's FST tooling:
- LM -> FSM: sphinx3/src/libs3decoder/liblm/lm_attfsm.c (backoff n-gram
  automaton with epsilon backoff arcs) and sphinx_fsttools/sphinx_lm_fst.cc.
- Dictionary -> FST: sphinx_fsttools/sphinx_dict_fst.cc (phone->word
  transducer with pronunciation paths).
- FSG -> FSM: trivial relabeling of fsg_model transitions.

Format: one arc per line `src dst ilabel olabel [weight]`, final states as
`state [weight]`; separate `.isym`/`.osym` symbol tables with `<eps> 0`.
Weights are -ln(prob) (tropical semiring), matching OpenFst conventions.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, TextIO, Tuple

import numpy as np

EPS = "<eps>"


def _write_syms(path: str, syms: List[str]) -> None:
    with open(path, "w") as fh:
        fh.write(f"{EPS} 0\n")
        for i, s in enumerate(syms):
            fh.write(f"{s} {i + 1}\n")


def write_fsg_fst(fsg, path: str, symfile: Optional[str] = None) -> None:
    """fsg_model -> ATT FSM text.  Null transitions become epsilon arcs."""
    syms = list(fsg.vocab)
    with open(path, "w") as fh:
        for link in fsg.links:
            lab = syms[link.wid] if link.wid >= 0 else EPS
            w = -float(link.logprob)
            fh.write(f"{link.from_state} {link.to_state} {lab} {lab} "
                     f"{w:.6f}\n")
        fh.write(f"{fsg.final_state} 0\n")
    if symfile:
        _write_syms(symfile, syms)


def write_dict_fst(d, path: str, isymfile: Optional[str] = None,
                   osymfile: Optional[str] = None,
                   prob_alt: bool = True) -> None:
    """Dictionary -> phone-in/word-out transducer (sphinx_dict_fst.cc
    capability): state 0 is start/final; each pronunciation is a fresh
    chain of states emitting the word on the first phone arc.  Alternate
    pronunciations split probability mass uniformly when prob_alt."""
    phones = list(d.mdef.ciname) if d.mdef is not None else None

    def pname(pid: int) -> str:
        return phones[pid] if phones else str(pid)

    # Count alternates per base word for weighting.
    nalt: Dict[int, int] = {}
    for wid in range(d.n_word):
        b = d.basewid[wid]
        nalt[b] = nalt.get(b, 0) + 1

    next_state = 1
    lines: List[str] = []
    isyms: Dict[str, None] = {}
    osyms: Dict[str, None] = {}
    for wid in range(d.n_word):
        pron = d.pron[wid]
        if not pron:
            continue
        word = d.word_str(wid)
        base = d.base_str(wid)
        w = (-math.log(1.0 / nalt[d.basewid[wid]])
             if prob_alt and nalt[d.basewid[wid]] > 1 else 0.0)
        osyms[base] = None
        src = 0
        for i, pid in enumerate(pron):
            dst = 0 if i == len(pron) - 1 else next_state
            if dst:
                next_state += 1
            ilab = pname(pid)
            isyms[ilab] = None
            olab = base if i == 0 else EPS
            wt = w if i == 0 else 0.0
            lines.append(f"{src} {dst} {ilab} {olab} {wt:.6f}")
            src = dst
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n0 0\n")
    if isymfile:
        _write_syms(isymfile, list(isyms))
    if osymfile:
        _write_syms(osymfile, list(osyms))


def write_am_fst(mdef, tmat, path: str, isymfile: Optional[str] = None,
                 osymfile: Optional[str] = None,
                 triphones: bool = False) -> None:
    """Acoustic model -> HMM-level transducer (sphinx_am_fst capability —
    the reference binary sphinx_fsttools/sphinx_am_fst.cc declares
    -mdef/-binfst/-txtfst but its main() is an empty stub; this implements
    the advertised artifact): senone-in / phone-out FST.

    State 0 is start/final.  Each phone (CI by default, plus triphones
    when `triphones`) contributes its Bakis HMM expanded from its
    transition matrix: arcs consume senone symbols `s<id>` with weights
    -log P(transition), the first arc emits the phone name.  Composition
    with the dictionary FST (write_dict_fst) then yields a senone->word
    transducer, the OpenFst-style H o L pipeline.
    """
    names = {}
    for p in range(mdef.n_phone if triphones else mdef.n_ciphone):
        if p < mdef.n_ciphone:
            names[p] = mdef.ciname[p]
        else:
            b, lc, rc, wpos = mdef.phone_ctx[p]
            names[p] = (f"{mdef.ciname[b]}_{mdef.ciname[lc]}"
                        f"_{mdef.ciname[rc]}_{'ibesu'[wpos]}")
    isyms: Dict[str, None] = {}
    osyms: Dict[str, None] = {}
    lines: List[str] = []
    next_state = 1
    log_tp = tmat.log_tp
    for p, pname_ in names.items():
        ssid = int(mdef.phone_ssid[p])
        sen = mdef.sseq[ssid]
        tp = log_tp[int(mdef.phone_tmat[p])]
        n = len([s for s in sen if int(s) != 0xFFFF])
        # states: chain of n emitting states, entry from 0, exit to 0.
        ids = list(range(next_state, next_state + n))
        next_state += n
        osyms[pname_] = None
        for j in range(n):
            lab = f"s{int(sen[j])}"
            isyms[lab] = None
            # entry arc into state j's first visit comes from the
            # predecessor (or start), consuming state j's senone.
            srcs = ([(0, 0.0)] if j == 0 else [])
            if j >= 1:
                srcs.append((ids[j - 1], -float(tp[j - 1, j])))
            if j >= 2:
                srcs.append((ids[j - 2], -float(tp[j - 2, j])))
            for src, w in srcs:
                if not np.isfinite(w) or w > 1e29:
                    continue
                olab = pname_ if src == 0 else EPS
                lines.append(f"{src} {ids[j]} {lab} {olab} {w:.6f}")
            # self loop
            w = -float(tp[j, j])
            if np.isfinite(w) and w < 1e29:
                lines.append(f"{ids[j]} {ids[j]} {lab} {EPS} {w:.6f}")
        # exits to the final/start state from the last two states (the
        # tmat's nonemitting exit column is its last).
        ex_col = tp.shape[0]
        for j in (n - 1, n - 2):
            if j < 0:
                continue
            w = -float(tp[j, ex_col])
            if np.isfinite(w) and w < 1e29:
                lines.append(f"{ids[j]} 0 {EPS} {EPS} {w:.6f}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n0 0\n")
    if isymfile:
        _write_syms(isymfile, list(isyms))
    if osymfile:
        _write_syms(osymfile, list(osyms))


def write_lm_fst(lm, path: str, symfile: Optional[str] = None) -> None:
    """Backoff n-gram LM -> FSM (lm_attfsm.c capability).

    States: 0 = null (unigram) context, 1 = start (<s>), then one state per
    unigram context, one per bigram context (trigram LMs).  Arcs:
    n-gram arcs with weight -ln P, epsilon backoff arcs with weight
    -ln(backoff).  </s> arcs go to the single final state.
    """
    LOG10 = math.log(10.0)
    V = lm.n_words
    words = lm.words
    bos = lm.word_id("<s>")
    eos = lm.word_id("</s>")

    NULL = 0
    FINAL = 1
    ug_state = {w: 2 + w for w in range(V)}
    next_state = 2 + V
    bg_state: Dict[Tuple[int, int], int] = {}
    n = lm.n
    if n > 2:
        for w1 in range(V):
            for b in range(int(lm.bg_ptr[w1]), int(lm.bg_ptr[w1 + 1])):
                if int(lm.tg_ptr[b]) != int(lm.tg_ptr[b + 1]):
                    bg_state[(w1, int(lm.bg_wid[b]))] = next_state
                    next_state += 1

    lines: List[str] = []

    def dest_after(w1: int, w2: int) -> int:
        """State representing history (w1, w2) (or (w2,) if no trigram
        successors / bigram model)."""
        if w2 == eos:
            return FINAL
        if n > 2 and (w1, w2) in bg_state:
            return bg_state[(w1, w2)]
        return ug_state[w2]

    # Unigram arcs from NULL context.
    for w in range(V):
        wt = -float(lm.ug_prob[w])
        lab = words[w]
        if w == eos:
            lines.append(f"{NULL} {FINAL} {lab} {lab} {wt:.6f}")
        elif w == bos:
            continue
        else:
            lines.append(f"{NULL} {ug_state[w]} {lab} {lab} {wt:.6f}")
        # Backoff from the unigram context back to NULL.
        if n > 1 and w != eos:
            bo = -float(lm.ug_bo[w])
            lines.append(f"{ug_state[w]} {NULL} {EPS} {EPS} {bo:.6f}")
    # Bigram arcs.
    if n > 1:
        for w1 in range(V):
            for b in range(int(lm.bg_ptr[w1]), int(lm.bg_ptr[w1 + 1])):
                w2 = int(lm.bg_wid[b])
                wt = -float(lm.bg_prob[b])
                lab = words[w2]
                lines.append(
                    f"{ug_state[w1]} {dest_after(w1, w2)} {lab} {lab} {wt:.6f}")
                # Backoff from bigram context (w1,w2) to unigram context w2.
                if n > 2 and (w1, w2) in bg_state:
                    bo = -float(lm.bg_bo[b])
                    lines.append(f"{bg_state[(w1, w2)]} {ug_state[w2]} "
                                 f"{EPS} {EPS} {bo:.6f}")
    # Trigram arcs.
    if n > 2:
        for w1 in range(V):
            for b in range(int(lm.bg_ptr[w1]), int(lm.bg_ptr[w1 + 1])):
                w2 = int(lm.bg_wid[b])
                if (w1, w2) not in bg_state:
                    continue
                src = bg_state[(w1, w2)]
                for t in range(int(lm.tg_ptr[b]), int(lm.tg_ptr[b + 1])):
                    w3 = int(lm.tg_wid[t])
                    wt = -float(lm.tg_prob[t])
                    lab = words[w3]
                    lines.append(
                        f"{src} {dest_after(w2, w3)} {lab} {lab} {wt:.6f}")
    with open(path, "w") as fh:
        # Start state is <s>'s context when present, else NULL; ATT FSM's
        # start state is the source of the first arc — emit a leading
        # epsilon arc from 0' trick is unnecessary: we simply list arcs
        # from the start state first.  We instead remap: OpenFst takes the
        # first line's source as the start state.
        start = ug_state[bos] if bos >= 0 else NULL
        if not any(int(L.split()[0]) == start for L in lines):
            lines.insert(0, f"{start} {NULL} {EPS} {EPS} 0.0")
        ordered = sorted(lines, key=lambda L: int(L.split()[0]) != start)
        fh.write("\n".join(ordered) + f"\n{FINAL} 0\n")
    if symfile:
        _write_syms(symfile, list(words))


def read_fst(path: str) -> Tuple[List[Tuple[int, int, str, str, float]],
                                 Dict[int, float]]:
    """Parse ATT FSM text -> (arcs, finals).  For tests and round-trips."""
    arcs = []
    finals: Dict[int, float] = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if len(parts) <= 2:
                finals[int(parts[0])] = float(parts[1]) if len(parts) == 2 else 0.0
            else:
                src, dst, il = int(parts[0]), int(parts[1]), parts[2]
                ol = parts[3] if len(parts) > 3 else il
                w = float(parts[4]) if len(parts) > 4 else 0.0
                arcs.append((src, dst, il, ol, w))
    return arcs, finals
