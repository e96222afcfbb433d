"""Forced alignment and allphone decoding.

Port of `cmusphinx_tpu/decode/align.py` (`AlignSearch`, `PhoneSeg`,
`make_phone_dict`, `uniform_phone_lm`, `allphone_search`; the reference:
pocketsphinx state_align_search.c and ps_alignment.c, sphinx3's aligner
and allphone mode).

Alignment builds a sentence HMM over the acoustic model's triphone senones
(word-internal triphones from Dict2Pid, optional silences between words)
and runs a dense Viterbi over frames x states on the search's device: each
frame is one `[S, S]` step, `max` and a first-index argmax over the source
state (`jnp.argmax`'s tie rule), then the host backtraces to state, phone
and word segmentations.

Allphone decoding is the N-gram decoder over a phone dictionary (every CI
phone a one-phone word), with a phone N-gram LM or a uniform unigram.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.dict import Dictionary
from ..models.dict2pid import Dict2Pid
from ..models.mdef import BAD_SENID, Mdef
from ..models.ngram import NgramModel
from ..models.tmat import TransitionMatrices
from .ngram_search import _argmax_first
from .results import Segment

NEG = -1.0e30


@dataclass
class PhoneSeg:
    phone: str
    start_frame: int
    end_frame: int
    word: str
    word_idx: int = -1   # transcript position (-1 = silence)


class AlignSearch:
    """Forced aligner over a senone scorer."""

    def __init__(self, d: Dictionary, mdef: Mdef, tmat: TransitionMatrices,
                 scorer, *, device: torch.device | str = "cuda"):
        self.dict = d
        self.mdef = mdef
        self.tmat = tmat
        self.scorer = scorer
        self.device = torch.device(device)
        self.d2p = Dict2Pid(mdef, d)

    # ------------------------------------------------------------------
    def _build(self, words: Sequence[str], add_sil: bool = True):
        """Sentence HMM over the triphone pids, as host arrays."""
        mdef, d = self.mdef, self.dict
        n = mdef.max_emit_state
        pids: List[int] = []
        pword: List[int] = []   # index into `tokens` (-1 for silence)
        opt: List[bool] = []
        tokens = list(words)
        sil_pid = mdef.sil if mdef.sil >= 0 else 0
        if add_sil:
            pids.append(sil_pid)
            pword.append(-1)
            opt.append(True)
        for wi, w in enumerate(tokens):
            wid = d.wordid(w)
            if wid < 0:
                raise KeyError(f"word {w!r} not in dictionary")
            for pid in self.d2p.word_pids(wid):
                pids.append(pid)
                pword.append(wi)
                opt.append(False)
            if add_sil:
                pids.append(sil_pid)
                pword.append(-1)
                opt.append(True)

        S = len(pids) * n
        state_sen = np.zeros(S, np.int32)
        state_valid = np.ones(S, bool)
        state_phone = np.zeros(S, np.int32)
        state_word = np.full(S, -1, np.int32)
        M = np.full((S, S), NEG, np.float32)
        bad = int(np.uint16(BAD_SENID))
        log_tp = self.tmat.log_tp
        entry_lp = np.full(S, NEG, np.float32)
        sources: List = ["START"]
        finals: List[tuple] = []
        for k, pid in enumerate(pids):
            base = k * n
            ssid = int(self.mdef.phone_ssid[pid])
            tm = int(self.mdef.phone_tmat[pid])
            sen = self.mdef.sseq[ssid]
            for s in range(n):
                state_sen[base + s] = 0 if sen[s] == bad else int(sen[s])
                state_valid[base + s] = sen[s] != bad
                state_phone[base + s] = pid
                state_word[base + s] = pword[k]
            for i in range(n):
                for j in range(i, min(i + 3, n)):
                    M[base + i, base + j] = log_tp[tm, i, j]
            for src in sources:
                if src == "START":
                    entry_lp[base] = 0.0
                else:
                    st, stm, srow = src
                    M[st, base] = log_tp[stm, srow, n]
            new_sources = [(base + n - 1, tm, n - 1)]
            if n >= 2:
                new_sources.append((base + n - 2, tm, n - 2))
            sources = (sources + new_sources) if opt[k] else new_sources
        for src in sources:
            if src != "START":
                finals.append(src)
        fexit = np.full(S, NEG, np.float32)
        for (st, stm, srow) in finals:
            fexit[st] = log_tp[stm, srow, self.tmat.n_state]
        return (state_sen, state_valid, state_phone, state_word,
                M, entry_lp, fexit, tokens, n)

    @torch.inference_mode()
    def _viterbi(self, feats, state_sen, state_valid, M, entry_lp, fexit):
        """The dense Viterbi on the device: (final scores [S], backpointers
        [T-1, S]) on the host."""
        dev = self.device
        x = torch.as_tensor(np.asarray(feats, np.float32)).to(dev)
        scores = self.scorer.score(x)                            # [T, n_sen]
        sen = torch.as_tensor(state_sen.astype(np.int64), device=dev)
        ok = torch.as_tensor(state_valid, device=dev)
        ll = torch.where(ok[None, :], scores[:, sen], NEG)       # [T, S]
        Md = torch.as_tensor(M, device=dev)
        a = torch.as_tensor(entry_lp, device=dev) + ll[0]
        T = ll.shape[0]
        bps = torch.empty((max(T - 1, 0), Md.shape[0]), dtype=torch.int64,
                          device=dev)
        for t in range(1, T):
            cand = a[:, None] + Md
            bps[t - 1] = _argmax_first(cand, 0)
            a = (cand.amax(0) + ll[t]).clamp_min(NEG)
        fin = a + torch.as_tensor(fexit, device=dev)
        return fin.cpu().numpy(), bps.cpu().numpy()

    # ------------------------------------------------------------------
    def align(self, feats: np.ndarray, words: Sequence[str]) -> tuple:
        """Returns (word segments, phone segments, state ids per frame,
        alignment score)."""
        (state_sen, state_valid, state_phone, state_word, M, entry_lp,
         fexit, tokens, n) = self._build(words)
        T = int(feats.shape[0])
        fin, bps = self._viterbi(feats, state_sen, state_valid, M, entry_lp,
                                 fexit)
        s = int(np.argmax(fin))
        score = float(fin[s])
        states = [s]
        for t in range(T - 2, -1, -1):
            s = int(bps[t, states[-1]])
            states.append(s)
        states.reverse()

        # Segment into phones and words.
        phsegs: List[PhoneSeg] = []
        wsegs: List[Segment] = []
        t0 = 0
        for t in range(1, T + 1):
            changed = t == T or state_phone[states[t]] != state_phone[states[t - 1]] \
                or (t < T and states[t] < states[t - 1] - 2)
            if changed:
                pid = int(state_phone[states[t - 1]])
                wi = int(state_word[states[t - 1]])
                ci = pid if pid < self.mdef.n_ciphone else int(
                    self.mdef.phone_ctx[pid][0])
                phsegs.append(PhoneSeg(self.mdef.ciname[ci], t0, t - 1,
                                       tokens[wi] if wi >= 0 else "<sil>",
                                       wi))
                t0 = t
        # Word segments from the phone segments, grouped by transcript
        # position, so that repeated words stay distinct.
        cur, ws = None, 0
        for seg in phsegs:
            if seg.word_idx != cur:
                if cur is not None and cur >= 0:
                    wsegs.append(Segment(tokens[cur], ws,
                                         seg.start_frame - 1, 0.0))
                cur, ws = seg.word_idx, seg.start_frame
        if cur is not None and cur >= 0:
            wsegs.append(Segment(tokens[cur], ws, T - 1, 0.0))
        return wsegs, phsegs, states, score


def make_phone_dict(mdef: Mdef) -> Dictionary:
    """Phone dictionary for allphone decoding: every CI phone is a word."""
    d = Dictionary(mdef)
    for ci in range(mdef.n_ciphone):
        name = mdef.ciname[ci]
        if name == "SIL":
            continue
        d.add_word(name, [ci])
    d.filler_start = d.n_word
    for w in ("<s>", "</s>", "<sil>"):
        d.add_word(w, [mdef.sil if mdef.sil >= 0 else 0])
    d.filler_end = d.n_word - 1
    return d


def uniform_phone_lm(mdef: Mdef) -> NgramModel:
    """Uniform unigram phone LM (allphone without a phone LM)."""
    m = NgramModel()
    names = [mdef.ciname[ci] for ci in range(mdef.n_ciphone)
             if mdef.ciname[ci] != "SIL"] + ["<s>", "</s>"]
    m.n = 1
    m.words = names
    m.wid = {w: i for i, w in enumerate(names)}
    m.ug_prob = np.full(len(names), -np.log(len(names)), np.float32)
    m.ug_bo = np.zeros(len(names), np.float32)
    m.bg_ptr = np.zeros(len(names) + 1, np.int64)
    return m


def allphone_search(mdef: Mdef, tmat: TransitionMatrices, scorer,
                    lm: Optional[NgramModel] = None, **kwargs):
    """Allphone decoder (sphinx3 mode 1 / pocketsphinx allphone_search): an
    `NgramSearch` over the phone dictionary; keyword arguments (`config`,
    `device`, search options) go to it."""
    from .ngram_search import NgramSearch
    d = make_phone_dict(mdef)
    if lm is None:
        lm = uniform_phone_lm(mdef)
    return NgramSearch(lm, d, mdef, tmat, scorer, **kwargs)
