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

The frames run in blocks of `BLOCK` through the shared block runner
(`graphs.BlockRunner`): on the card each block is a replay of a captured
CUDA graph, the counterpart of the reference's compiled `lax.scan`.  A
graph is keyed by its block length and the state count, which is rounded
up to a multiple of `STATE_BUCKET`, so that a corpus of transcripts shares
a handful of graphs (the reference compiles its scan anew for every
`align` call).  The padded states come last and can be neither entered
nor left (`NEG` entry, transitions, exits and scores), so no output
changes: see `_pad_states`.

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
from .graphs import BlockRunner, pad_frames
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
    """Forced aligner over a senone scorer.  `_graphs = False`, a private
    attribute for the tests and `chip_smoke.py`, runs the blocks eagerly
    on the card."""

    # Frames a block (one graph a state bucket whatever the length).
    BLOCK = 50
    # The sentence HMM's states are padded to a multiple of this.  A
    # frame's `[S, S]` step is a handful of small kernels whose time at a
    # few hundred states is their latency, not their work, so a coarse
    # bucket keeps the graphs few at little cost: the hub4-class slice's 16
    # transcripts (48-120 states) share one graph at 128 (two at 64, ten
    # unpadded), and graphed they align no slower padded than unpadded
    # (PERF.md §5).
    STATE_BUCKET = 128

    def __init__(self, d: Dictionary, mdef: Mdef, tmat: TransitionMatrices,
                 scorer, *, device: torch.device | str = "cuda"):
        self.dict = d
        self.mdef = mdef
        self.tmat = tmat
        self.scorer = scorer
        self.device = torch.device(device)
        self.d2p = Dict2Pid(mdef, d)
        self._graphs = True
        self._runner = BlockRunner()

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

    def _block(self, carry, inputs, t, rows) -> tuple:
        """Frames of the state scores ll [K, Sp] (valid [K]) through the
        `[Sp, Sp]` step, writing the backpointer rows [K, Sp]; a frame past
        the utterance keeps alpha.  The transition matrix rides in the
        carry (copied into a graph once a call).  No host read, so the
        block can be captured."""
        a, M = carry
        ll, valid = inputs
        bps, = rows
        for k in range(ll.shape[0]):
            cand = a[:, None] + M
            bps[k].copy_(_argmax_first(cand, 0))
            a = torch.where(valid[k], (cand.amax(0) + ll[k]).clamp_min(NEG),
                            a)
        return a, M

    def _pad_states(self, state_sen, state_valid, M, entry_lp) -> tuple:
        """The sentence HMM's arrays of S states padded to Sp, a multiple
        of STATE_BUCKET, as tensors on the device: (senone [Sp] int64,
        valid [Sp], transitions [Sp, Sp], entry [Sp]).

        The padded states come last and get NEG entry, transitions to and
        from them, and (invalid) scores.  A padded alpha is then NEG + NEG
        at frame 0 and NEG after (the clamp), never more than a real
        state's (at least NEG + NEG, then NEG), and its transitions are
        NEG, never more than a real one's; f32 addition is monotone, so no
        candidate from a padded source exceeds one from a real source.  A
        real state's max is the unpadded one, and its first-index argmax,
        on a tie, takes the real source of lower index.  `_viterbi` cuts
        the final scores to S before the host's argmax.  No output
        changes."""
        S, B = len(state_sen), self.STATE_BUCKET
        Sp = -(-S // B) * B
        sen = np.zeros(Sp, np.int64)
        sen[:S] = state_sen
        ok = np.zeros(Sp, bool)
        ok[:S] = state_valid
        Mp = np.full((Sp, Sp), NEG, np.float32)
        Mp[:S, :S] = M
        ent = np.full(Sp, NEG, np.float32)
        ent[:S] = entry_lp
        return tuple(torch.as_tensor(x, device=self.device)
                     for x in (sen, ok, Mp, ent))

    def _scan(self, scores, sen, ok, M, ent) -> tuple:
        """The Viterbi over the senone scores [T, n_sen] on the (padded)
        sentence HMM (`_pad_states`): (alpha [Sp] at frame T-1,
        backpointers [F, Sp] of frames 1 .. T-1, rows past T-1 padding)
        on the device.  No host read: on the card each block is a graph's
        replay."""
        ll = torch.where(ok[None, :], scores[:, sen], NEG)       # [T, Sp]
        a = ent + ll[0]
        n, Sp = ll.shape[0] - 1, ll.shape[1]
        F = -(-n // self.BLOCK) * self.BLOCK
        ll = pad_frames(ll[1:], F)
        valid = torch.arange(F, device=ll.device) < n
        bps = torch.empty((F, Sp), dtype=torch.int64, device=ll.device)
        a, _ = self._runner.scan(self._block, (a, M), (ll, valid), (bps,),
                                 1, self.BLOCK, self._graphs and ll.is_cuda,
                                 row0=0)
        return a, bps

    @torch.inference_mode()
    def _viterbi(self, feats, state_sen, state_valid, M, entry_lp, fexit):
        """The dense Viterbi on the device: (final scores [S], backpointers
        [T-1, S]) on the host."""
        x = torch.as_tensor(np.asarray(feats, np.float32)).to(self.device)
        S, n = len(state_sen), x.shape[0] - 1
        a, bps = self._scan(self.scorer.score(x), *self._pad_states(
            state_sen, state_valid, M, entry_lp))
        fin = a[:S] + torch.as_tensor(fexit, device=self.device)
        return fin.cpu().numpy(), bps[:n, :S].cpu().numpy()

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
