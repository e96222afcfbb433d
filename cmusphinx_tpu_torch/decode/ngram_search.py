"""N-gram (trigram) decoder over a senone scorer: the flat-lexicon Viterbi
search with exact right-context fan-out and multiplexed left contexts.

Port of `cmusphinx_tpu/decode/ngram_search.py` (`NGRAM_ARGS`, `NgramVocab`,
`NgramSearch.__init__` for the flat fanout/mpx graph, `_xscores_all`,
`_init_hmmc`, `_make_core`, `device_decode`, `device_backtrace`,
`_hyp_from_chase`, `decode`, `decode_batch`, `decode_batch_cep`).  See the
reference's module docstring for the search's semantics.  What differs in
form, not in result:

- The batch is an explicit leading dimension (the reference vmaps).
- The frame scan is a Python loop over frames of batched tensor ops.
- Gathers are plain gathers; the reference's one-hot matmul gathers were a
  TPU workaround.  Both select values exactly.
- Top-E word exits use a stable descending sort, which keeps
  `jax.lax.top_k`'s lowest-index-first order on ties.  The slot order on
  the tape (slot = t·E + e) is therefore the reference's, slot for slot.
- Payloads ride as int64 inside the loop; the tapes are stored as int32.

Not ported yet (they raise NotImplementedError): composite contexts, the
prefix-tree lexicon and the static-senone path (ROADMAP A9/A10), the
phone-loop lookahead `pl_window`, bestpath rescoring and lattices, and
streaming (A11).  `maxbatch` is accepted and has no effect: chunking a
batch was a workaround for TPU compiler crashes.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from .._host import (Arg, Config, Dict2Pid, Dictionary, Mdef, NgramModel,
                     TransitionMatrices, build_word_graph)
from ..models.ngram_device import DeviceNgram
from ..ops.hmm import NEG_INF, hmm_enter, hmm_step
from .results import Hypothesis, Segment

NGRAM_ARGS = [
    Arg("lw", float, 6.5, "Language model probability weight"),
    Arg("wip", float, 0.65, "Word insertion penalty"),
    Arg("pip", float, 1.0, "Phone insertion penalty"),
    Arg("silprob", float, 0.005, "Silence word transition probability"),
    Arg("fillprob", float, 1e-8, "Filler word transition probability"),
    Arg("beam", float, 1e-48, "Beam width applied to every frame in Viterbi search"),
    Arg("wbeam", float, 7e-29, "Beam width applied to word exits"),
    Arg("maxwpf", int, 32, "Maximum distinct word exits recorded per frame"),
    Arg("pl_window", int, 0,
        "Phone-loop lookahead window in frames (0 = off; not ported yet)"),
    Arg("pl_weight", float, 3.0, "Weight on phone-loop lookahead penalties"),
    Arg("rcmode", str, "auto",
        "Cross-word right-context handling: 'fanout' (exact per-context "
        "word-final channels) or 'composite' (not ported yet); 'auto' "
        "picks fanout below 1000 words"),
    Arg("lcmode", str, "auto",
        "Cross-word left-context handling: 'mpx' (multiplexed senone "
        "sequences riding the Viterbi argmax) or 'composite' (not ported "
        "yet); 'auto' follows rcmode"),
    Arg("lexmode", str, "auto",
        "Lexicon layout: 'flat' or 'tree' (not ported yet); 'auto' picks "
        "tree at >= 10k words with composite contexts"),
    Arg("treela", str, "bg", "Tree lookahead smear (tree lexicon only)"),
    Arg("nlextree", int, 1, "Number of lexicon-tree copies (tree lexicon only)"),
    Arg("maxbatch", int, 16,
        "Largest utterance batch decoded as one program in the reference; "
        "no effect here"),
    Arg("bestpath", bool, False,
        "Run lattice trigram rescoring after Viterbi (not ported yet)"),
    Arg("bestpathlw", float, 9.5, "Language weight for bestpath rescoring"),
    Arg("latbeam", float, 0.0, "Lattice link beam for bestpath rescoring"),
    Arg("ascale", float, 20.0, "Inverse acoustic scale for lattice posteriors"),
    Arg("prune", bool, True,
        "Apply beam pruning (prune_channels / save_bp threshold semantics)"),
]


def _f32(x: float) -> float:
    """A Python float rounded to float32, as the reference's jnp.float32."""
    return float(np.float32(x))


class NgramVocab:
    """Search vocabulary: dict words in the LM + fillers, with LM ids."""

    def __init__(self, lm: NgramModel, d: Dictionary):
        words: List[int] = []
        lmwid: List[int] = []
        is_fil: List[bool] = []
        for wid in range(d.n_word):
            w = d.base_str(wid)
            if w == "<s>":
                continue
            if d.is_filler(wid):
                words.append(wid)
                lmwid.append(-1)
                is_fil.append(True)
            else:
                lw = lm.word_id(w)
                if lw < 0:
                    continue
                words.append(wid)
                lmwid.append(lw)
                is_fil.append(False)
        if not words:
            raise ValueError("no dictionary word occurs in the LM")
        self.dict_wid = np.asarray(words, np.int32)
        self.lmwid = np.asarray(lmwid, np.int32)
        self.is_filler = np.asarray(is_fil, bool)
        self.is_finish = np.asarray([d.base_str(w) == "</s>" for w in words], bool)
        self.word_str = [d.word_str(w) for w in words]
        self.n_word = len(words)


class NgramSearch(nn.Module):
    """Trigram decoder over a senone scorer.  The graph's tables, the
    transition matrices and the LM table are buffers on `device`."""

    FRAME_BUCKET = 100

    def __init__(self, lm: NgramModel, d: Dictionary, mdef: Mdef,
                 tmat: TransitionMatrices, scorer: nn.Module,
                 config: Optional[Config] = None, *,
                 device: torch.device | str, **kwargs):
        super().__init__()
        cfg = (config.copy() if config else Config(NGRAM_ARGS)).register(NGRAM_ARGS)
        cfg.update(**kwargs)
        self.config = cfg
        self.device = torch.device(device)
        # Host-side constants stay float64, as in the reference; the device
        # arithmetic uses their float32 roundings (the `_*32` copies).
        self.lw = float(cfg["lw"])
        self.log_wip = math.log(float(cfg["wip"]))
        log_pip = math.log(float(cfg["pip"]))
        self.log_pip = log_pip
        self._lw32, self._wip32, self._pip32 = (
            _f32(self.lw), _f32(self.log_wip), _f32(log_pip))
        self.silpen = log_pip + math.log(float(cfg["silprob"]))
        self.fillpen = log_pip + math.log(float(cfg["fillprob"]))
        self.E = int(cfg["maxwpf"])
        self.prune = bool(cfg["prune"])
        self.log_beam = _f32(math.log(float(cfg["beam"])))
        self.log_wbeam = _f32(math.log(float(cfg["wbeam"])))
        if int(cfg["pl_window"]):
            raise NotImplementedError(
                "pl_window (phone-loop lookahead) is not ported yet")

        self.lm = lm
        self.dict = d
        self.mdef = mdef
        self.scorer = scorer
        self.vocab = v = NgramVocab(lm, d)
        rc_mode = str(cfg["rcmode"])
        if rc_mode == "auto":
            rc_mode = "fanout" if v.n_word < 1000 else "composite"
        lc_mode = str(cfg["lcmode"])
        if lc_mode == "auto":
            lc_mode = "mpx" if rc_mode == "fanout" else "composite"
        lex_mode = str(cfg["lexmode"])
        if lex_mode == "auto":
            lex_mode = "flat"
        if (rc_mode, lc_mode, lex_mode) != ("fanout", "mpx", "flat"):
            raise NotImplementedError(
                f"rcmode={rc_mode!r}, lcmode={lc_mode!r}, lexmode="
                f"{lex_mode!r}: only the flat fanout/mpx graph is ported "
                "(composite contexts and the tree lexicon are ROADMAP "
                "A9/A10); vocabularies of 1000 words or more select "
                "composite contexts under 'auto'")
        g = self.graph = build_word_graph(v.dict_wid, d, mdef,
                                          Dict2Pid(mdef, d), rc_mode=rc_mode,
                                          lc_mode=lc_mode, lex_mode=lex_mode)
        if g.n_xs != g.n_sing:
            raise NotImplementedError("composite xs rows are not ported yet")
        self.E = min(self.E, v.n_word)
        self.dlm = DeviceNgram(lm, device=self.device)
        self.start_lmwid = lm.word_id("<s>")
        self.finish_lmwid = lm.word_id("</s>")
        self.sil_ci = mdef.sil if mdef.sil >= 0 else 0

        # <sil>/<s>/</s> get silpen; other fillers fillpen.
        fp = np.full(v.n_word, self.fillpen, np.float32)
        for k, w in enumerate(v.word_str):
            if w in ("<sil>", "</s>", "<s>"):
                fp[k] = self.silpen
        # Static initial entries with history (<s>,) and silence left context.
        ent0 = np.zeros(v.n_word, np.float32)
        for k in range(v.n_word):
            if v.is_filler[k]:
                ent0[k] = fp[k]
            else:
                ent0[k] = self.lw * self.lm.bg_score(
                    self.start_lmwid, int(v.lmwid[k])) + self.log_wip
        entc0 = np.full((g.n_chan,), NEG_INF, np.float32)
        entc0[g.is_entry] = ent0[g.word_of[g.is_entry]]
        xs0 = g.static_xs.copy()
        xs0[g.is_entry] = g.lcmap[g.lc_row[g.is_entry], self.sil_ci]

        def buf(name, a, dtype=None):
            t = torch.as_tensor(np.asarray(a))
            if dtype is not None:
                t = t.to(dtype)
            elif t.dtype in (torch.int16, torch.int32):
                t = t.long()
            self.register_buffer(name, t.to(self.device), persistent=False)

        buf("_tp", tmat.log_tp[g.tmat_idx], torch.float32)       # [C, S, S+1]
        buf("_sing_sen", g.sing_sen)                              # [n_xs, S]
        buf("_sing_valid", g.sing_valid)
        buf("_static_xs", g.static_xs)
        buf("_word_of", g.word_of)
        buf("_is_entry", g.is_entry)
        buf("_lcmap_flat", g.lcmap.reshape(-1))
        buf("_lc_row_base", g.lc_row.astype(np.int64) * g.n_ci)
        buf("_exit_valid", g.exit_tab >= 0)                       # [W, Vr]
        buf("_exit_tab_c", np.maximum(g.exit_tab, 0))
        buf("_rssid_first", g.rssid[:, g.firstci])                # [W, W]
        buf("_rssid_sil", g.rssid[:, self.sil_ci])                # [W]
        buf("_has_prev", g.prev_chan >= 0)
        buf("_prev_chan_c", np.maximum(g.prev_chan, 0))
        buf("_lastci", g.lastci)
        buf("_lmwid", v.lmwid)
        buf("_lmwid_c", np.maximum(v.lmwid, 0))
        buf("_is_filler", v.is_filler)
        buf("_is_finish", v.is_finish)
        buf("_fil_pen", fp)
        buf("_entc0", entc0)
        buf("_entxs0", xs0)
        # (tapes, lengths, last index) of the most recent batch; the tapes
        # stay on the device.
        self._last_batch: Optional[tuple] = None

    # ------------------------------------------------------------------
    def _xscores(self, scores_t: torch.Tensor) -> torch.Tensor:
        """Senone scores of one frame [B, n_sen] -> extended-senone-sequence
        scores [B, n_xs, S] (all rows are singletons on this graph)."""
        return torch.where(self._sing_valid, scores_t[:, self._sing_sen],
                           NEG_INF)

    def _init_hmmc(self, B: int):
        """Initial HMM carry: all channels silent except the static <s>
        entries; word-history payloads (hw2, hw1) start at (<s>, -1)."""
        g = self.graph
        C, S = g.n_chan, g.n_emit_state
        dev = self.device

        def full(shape, val):
            return torch.full(shape, val, dtype=torch.int64, device=dev)

        alpha = torch.full((C, S), NEG_INF, dtype=torch.float32, device=dev)
        xsr = self._static_xs[:, None].expand(C, S)
        alpha, pays = hmm_enter(
            alpha, (full((C, S), -1), xsr, full((C, S), self.start_lmwid),
                    full((C, S), -1)),
            self._entc0,
            (full((C,), -1), self._entxs0, full((C,), self.start_lmwid),
             full((C,), -1)))
        return tuple(a[None].expand(B, C, S).contiguous()
                     for a in (alpha,) + pays)

    def _step(self, hmmc, scores_t, t: int, valid_t, tape):
        """One frame of the Viterbi core for the whole batch.  Writes the
        frame's tape row into `tape` and returns the new carry."""
        alpha0, hist0, xsr0, hw20, hw10 = hmmc
        B = alpha0.shape[0]
        E = self.E
        W = self.vocab.n_word
        Vr = self.graph.n_rcvar
        neg = NEG_INF

        sen_c = torch.gather(self._xscores(scores_t), 1, xsr0)   # [B, C, S]
        alpha, (hist, xsr, hw2, hw1), ex, (exh, _, exh2, exh1) = hmm_step(
            alpha0, (hist0, xsr0, hw20, hw10), sen_c, self._tp)

        if self.prune:
            # Channel beam + word-exit beam relative to the frame best.
            bestscr = alpha.amax(dim=(1, 2))                      # [B]
            keep = alpha.amax(2) > (bestscr + self.log_beam)[:, None]
            alpha = torch.where(keep[..., None], alpha, neg)
            ex = torch.where(ex > (bestscr + self.log_wbeam)[:, None], ex, neg)

        # ---- word exits: per-variant readout [B, W, Vr] ----
        exv = torch.where(self._exit_valid, ex[:, self._exit_tab_c], neg)
        wex = exv.amax(2)                                         # [B, W]
        vwin = exv.argmax(2)
        sel = torch.gather(self._exit_tab_c.expand(B, W, Vr), 2,
                           vwin[..., None])[..., 0]               # [B, W]
        exh3 = torch.stack([exh, exh2, exh1], -1)                 # [B, C, 3]
        wexh3 = torch.gather(exh3, 1, sel[..., None].expand(B, W, 3))

        # ---- top-E word exits -> tape slots ----
        vals, wsel = torch.sort(wex, dim=1, descending=True, stable=True)
        vals, wsel = vals[:, :E], wsel[:, :E]                     # [B, E]
        ok = (vals > neg * 0.5) & valid_t[:, None]
        slot_rc = torch.gather(exv, 1, wsel[..., None].expand(B, E, Vr))
        pe, prev_h2, prev_h1 = torch.gather(
            wexh3, 1, wsel[..., None].expand(B, E, 3)).unbind(-1)
        fil = self._is_filler[wsel]
        h2 = torch.where(fil, prev_h2, self._lmwid[wsel])
        h1 = torch.where(fil, prev_h1, prev_h2)
        tw, tsc, tprev, th2, th1, trc = tape
        tw[:, t] = torch.where(ok, wsel, -1)
        tsc[:, t] = torch.where(ok, vals, neg)
        tprev[:, t] = pe
        th2[:, t] = h2
        th1[:, t] = h1
        trc[:, t] = torch.where(ok[..., None], slot_rc, neg)

        # ---- word entries (take effect next frame) ----
        Vlm = self.dlm.V
        i1 = torch.where(h1 < 0, Vlm, h1)
        i2 = torch.where(h2 < 0, Vlm, h2)
        plane = self.dlm.tg_dense.view((Vlm + 1) * (Vlm + 1), Vlm)
        lmw = plane[(i1 * (Vlm + 1) + i2)[..., None], self._lmwid_c]   # [B, E, W]
        bonus = torch.where(self._is_filler, self._fil_pen,
                            self._lw32 * lmw + self._wip32)
        # Acoustic part: the exiting word's rc variant serving this word's
        # first CI phone (rssid readout).
        if Vr == 1:
            ac = slot_rc
        else:
            ac = torch.gather(slot_rc, 2, self._rssid_first[wsel])
        cand = torch.where(ok[..., None], ac + bonus, neg)        # [B, E, W]
        # Single best entry per word (word_transition semantics).
        ent_w = cand.amax(1)                                      # [B, W]
        estar = cand.argmax(1)
        ebp_w = torch.where(ent_w > neg * 0.5, t * E + estar, -1)
        eh = torch.gather(torch.stack([self._lastci[wsel], h2, h1], -1), 1,
                          estar[..., None].expand(B, W, 3))
        lcstar, eh2_w, eh1_w = eh.unbind(-1)

        # Entry channel routing (score + mpx xs row by left context), and
        # within-word propagation (in-degree <= 1: a gather).
        wo = self._word_of
        pc = self._prev_chan_c
        is_entry = self._is_entry
        ent_xs_c = self._lcmap_flat[self._lc_row_base + lcstar[:, wo]]
        prop = torch.where(self._has_prev, ex[:, pc] + self._pip32, neg)
        bprop = torch.where(self._has_prev, exh[:, pc], -1)
        alpha, (hist, xsr, hw2, hw1) = hmm_enter(
            alpha, (hist, xsr, hw2, hw1),
            torch.where(is_entry, ent_w[:, wo], prop),
            (torch.where(is_entry, ebp_w[:, wo], bprop),
             torch.where(is_entry, ent_xs_c, self._static_xs),
             torch.where(is_entry, eh2_w[:, wo], exh2[:, pc]),
             torch.where(is_entry, eh1_w[:, wo], exh1[:, pc])))

        # Padded frames are identity.
        v = valid_t[:, None, None]
        return tuple(torch.where(v, new, old) for new, old in zip(
            (alpha, hist, xsr, hw2, hw1), hmmc))

    def device_decode(self, feats: torch.Tensor, valid: torch.Tensor):
        """Padded feats [B, Tpad, D] + valid mask [B, Tpad] -> backpointer
        tapes (tw, tsc, tprev, th2, th1 [B, Tpad*E]; trc [B, Tpad*E, Vr]),
        slot = t*E + e."""
        B, Tpad = feats.shape[0], feats.shape[1]
        E, Vr = self.E, self.graph.n_rcvar
        dev = self.device
        scores = self.scorer.score(feats)                         # [B, Tpad, n_sen]
        tape = tuple(torch.empty((B, Tpad, E), dtype=dt, device=dev)
                     for dt in (torch.int32, torch.float32, torch.int32,
                                torch.int32, torch.int32)) + (
            torch.empty((B, Tpad, E, Vr), dtype=torch.float32, device=dev),)
        hmmc = self._init_hmmc(B)
        for t in range(Tpad):
            hmmc = self._step(hmmc, scores[:, t], t, valid[:, t], tape)
        tw, tsc, tprev, th2, th1, trc = tape
        n = Tpad * E
        return (tw.view(B, n), tsc.view(B, n), tprev.view(B, n),
                th2.view(B, n), th1.view(B, n), trc.view(B, n, Vr))

    # ------------------------------------------------------------------
    def device_backtrace(self, tape, T: torch.Tensor) -> torch.Tensor:
        """1-best readout on the device for a batch: final-slot selection
        (silence right context + P(</s>|h), ngram_search_finish semantics)
        and the backpointer chase.  Returns the packed [B, 4, maxseg+1]
        array of the reference (rows word, start, end, score, emitted
        final word first; [:, 3, -1] = final path score)."""
        tw, tsc, tprev, th2, th1, trc = tape
        E = self.E
        B, n_slots = tw.shape
        dev = tw.device
        neg = NEG_INF
        T = T.to(device=dev, dtype=torch.int64)
        sidx = torch.arange(n_slots, device=dev)
        valid = (tw >= 0) & (sidx[None, :] < (T * E)[:, None])
        fbest = torch.where(valid, sidx // E, -1).amax(1)         # [B]
        base = fbest.clamp_min(0) * E
        idx = base[:, None] + torch.arange(E, device=dev)         # [B, E]
        tw_f = torch.gather(tw, 1, idx).long()
        tsc_f = torch.gather(tsc, 1, idx)
        th2_f = torch.gather(th2, 1, idx).long()
        th1_f = torch.gather(th1, 1, idx).long()
        trc_f = torch.gather(trc, 1, idx[..., None].expand(-1, -1,
                                                          trc.shape[2]))
        twc = tw_f.clamp_min(0)
        rc = torch.gather(trc_f, 2, self._rssid_sil[twc][..., None])[..., 0]
        s = torch.where(rc > neg * 0.5, rc, tsc_f)
        tg = self.dlm.score_tg(th1_f, th2_f,
                               torch.full_like(th1_f, self.finish_lmwid))
        s = s + torch.where(self._is_finish[twc], 0.0, self._lw32 * tg)
        s = torch.where(tw_f >= 0, s, neg)
        e0 = s.argmax(1)
        score = torch.gather(s, 1, e0[:, None])[:, 0]
        slot = torch.where(fbest >= 0, base + e0, -1)

        # Pointer chase, bounded by the number of words: the topology's
        # minimum word duration is 2 frames, hence T/2.
        maxseg = n_slots // (2 * E) + 2
        out = torch.full((B, 4, maxseg + 1), neg, dtype=torch.float32,
                         device=dev)
        out[:, :3] = -1.0
        rows = torch.arange(B, device=dev)
        i = torch.zeros(B, dtype=torch.int64, device=dev)
        for it in range(maxseg):
            if it % 8 == 0 and not bool((slot >= 0).any()):
                break
            ok = (slot >= 0) & (i < maxseg)
            s0 = slot.clamp_min(0)
            prev = tprev[rows, s0].long()
            start = torch.where(prev >= 0, prev // E + 1, 0)
            col = torch.stack([tw[rows, s0].float(), start.float(),
                               (s0 // E).float(), tsc[rows, s0]], -1)
            ii = i.clamp_max(maxseg - 1)
            out[rows, :, ii] = torch.where(ok[:, None], col,
                                           out[rows, :, ii])
            slot = torch.where(ok, prev, -1)
            i = i + ok.long()
        out[:, 3, maxseg] = score
        return out

    def _hyp_from_chase(self, chase: np.ndarray) -> Hypothesis:
        """Host assembly of a Hypothesis from one packed chase array
        [4, maxseg+1]."""
        v = self.vocab
        ks = chase[0, :-1].astype(np.int64)
        sts = chase[1, :-1].astype(np.int64)
        ens = chase[2, :-1].astype(np.int64)
        scs, score = chase[3, :-1], chase[3, -1]
        segs: List[Segment] = []
        for k, st, en, sc in zip(ks, sts, ens, scs):
            if k < 0:
                break
            segs.append(Segment(v.word_str[int(k)], int(st), int(en),
                                float(sc)))
        if not segs:
            return Hypothesis([], float("-inf"), [])
        segs.reverse()
        words = []
        for s in segs:
            wid = self.dict.wordid(s.word)
            if wid < 0 or not self.dict.is_filler(wid):
                words.append(self.dict.base_str(wid) if wid >= 0 else s.word)
        return Hypothesis(words, float(score), segs)

    # ------------------------------------------------------------------
    def _check_bestpath(self, bestpath: Optional[bool]) -> None:
        bp = bool(self.config["bestpath"]) if bestpath is None else bestpath
        if bp:
            raise NotImplementedError(
                "bestpath lattice rescoring is not ported yet (ROADMAP A11)")

    def _pad(self, arrays) -> tuple:
        """List of [T_i, n] -> ([B, Tpad, n] tensor, T [B] tensor, Ts)
        with Tpad a multiple of FRAME_BUCKET (the reference's tape shape)."""
        Ts = [int(a.shape[0]) for a in arrays]
        Tpad = -(-max(max(Ts), 1) // self.FRAME_BUCKET) * self.FRAME_BUCKET
        buf = np.zeros((len(arrays), Tpad, int(arrays[0].shape[1])),
                       np.float32)
        for i, a in enumerate(arrays):
            buf[i, : Ts[i]] = a
        return (torch.as_tensor(buf, device=self.device),
                torch.as_tensor(Ts, dtype=torch.int64, device=self.device), Ts)

    def _run(self, feats: torch.Tensor, T: torch.Tensor, Ts):
        valid = (torch.arange(feats.shape[1], device=self.device)[None, :]
                 < T[:, None])
        tapes = self.device_decode(feats, valid)
        chase = self.device_backtrace(tapes, T).cpu().numpy()
        self._last_batch = (tapes, Ts, len(Ts) - 1)
        return [self._hyp_from_chase(c) for c in chase]

    def decode(self, feats: np.ndarray,
               bestpath: Optional[bool] = None) -> Hypothesis:
        """feats [T, D] -> best hypothesis (a batch of one).  An empty
        utterance gives the empty hypothesis with score -inf."""
        if int(feats.shape[0]) == 0:
            return Hypothesis([], float("-inf"), [])
        return self.decode_batch([feats], bestpath)[0]

    @torch.inference_mode()
    def decode_batch(self, feats_list, bestpath: Optional[bool] = None
                     ) -> List[Hypothesis]:
        """Batched decode: all utterances padded to one frame bucket and
        decoded together.  Returns one Hypothesis per utterance."""
        if not feats_list:
            return []
        self._check_bestpath(bestpath)
        return self._run(*self._pad(feats_list))

    @torch.inference_mode()
    def decode_batch_cep(self, cep_list, fp, bestpath: Optional[bool] = None
                         ) -> List[Hypothesis]:
        """Cepstra [T_i, ncep] -> features (`fp`, a FeatPipeline) ->
        decode -> backtrace, all on the device."""
        if not cep_list:
            return []
        self._check_bestpath(bestpath)
        c, T, Ts = self._pad(cep_list)
        return self._run(fp._padded_kernel(c, T, True), T, Ts)
