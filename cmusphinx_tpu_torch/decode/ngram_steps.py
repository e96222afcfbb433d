"""The N-gram search's frame steps, one class a kind (`MpxStep`,
`StaticStep`, `TreeStep`, `TreeCopiesStep`), and the word-exit readout
they share (`Readout`: it reads its own tables and the device LM, never
the search).

`NgramSearch._pick_step` builds one step with the search; `_block` runs it.
A step owns its tables (buffers on the search's device) and gives a
batch's initial carry (`init_carry`, its side-tables `side_frames` long),
a stream's carry once its tape doubled (`grow`), a block's senone scores
[B, K, n_sen] as it reads them, by frame (`block_inputs`; `frame_bytes`
of them a frame at batch B cap the block), and one frame for the whole
batch (`frame`: t a 0-d int64 tensor; it writes the frame's tape rows,
views [B, E(, Vr)] of the block's tape, and returns the carry).  Payloads
ride as int32 in the mpx carry, as int64 in the static step and the tree
copies, and as uint8 for the one-copy tree's entry age; tapes as int32.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops import lm_entries, mpx_step, tree_step
from ..ops.hmm import NEG_INF, hmm_enter, hmm_step


def _argmax_first(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the maximum along `dim`, the lowest on ties
    (`jnp.argmax`'s rule), on any device."""
    m = x.amax(dim, keepdim=True)
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    idx = torch.arange(n, device=x.device).view(shape)
    return torch.where(x == m, idx, n).amin(dim)


def _top_k(x: torch.Tensor, k: int):
    """`jax.lax.top_k` along the last axis: descending, lowest index first
    on ties (a stable sort; `torch.topk` leaves the tie order open)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def topk2(x: torch.Tensor, k: int, bs: int = 128):
    """The reference's exact two-stage top-k along the last axis.  Up to
    M = 4*k*bs elements it is `_top_k`.  Above, the top-k of the per-block
    maxima picks k blocks, their indices are sorted back to index order,
    and their elements are re-ranked: ties then keep lowest-index priority
    among the selected blocks, which differs from a direct top-k only when
    the k-th value ties across more than k blocks."""
    M = x.shape[-1]
    nb = (M + bs - 1) // bs
    if nb <= k or M <= 4 * k * bs:
        return _top_k(x, k)
    lead = x.shape[:-1]
    pad = nb * bs - M
    if pad:
        x = torch.cat([x, x.new_full(lead + (pad,), NEG_INF)], -1)
    blk = x.reshape(lead + (nb, bs))
    _, bi = _top_k(blk.amax(-1), k)
    bi = bi.sort(-1).values
    sel = blk.gather(-2, bi[..., None].expand(lead + (k, bs)))
    tv, ti = _top_k(sel.reshape(lead + (k * bs,)), k)
    return tv, bi.gather(-1, ti // bs) * bs + ti % bs


class DeviceTables(nn.Module):
    """A module whose host tables are buffers on `device` (`_buf`)."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device

    def _buf(self, name: str, a, dtype=None) -> None:
        """Register host array `a` as a buffer on the module's device;
        narrow integers widen to int64 (torch's index type)."""
        t = torch.as_tensor(np.asarray(a))
        if dtype is not None:
            t = t.to(dtype)
        elif t.dtype in (torch.int16, torch.int32):
            t = t.long()
        self.register_buffer(name, t.to(self.device), persistent=False)


class Readout(DeviceTables):
    """The word-exit readout the steps share: E tape slots a frame, W
    words of Vr right-context variants; `lw` (float64, and `lw32`) the
    language weight, `wip32` the log word insertion penalty, `fil_pen`
    [W] the host's filler penalties; `lm_tab` the entries' tables
    (`ops/lm_entries.Tables`)."""

    def __init__(self, g, v, dlm, fil_pen, *, E: int, lw: float, lw32: float,
                 wip32: float, start_lmwid: int, prune: bool,
                 log_wbeam: float, device: torch.device):
        super().__init__(device)
        self.dlm = dlm
        self.E, self.W, self.Vr = E, v.n_word, g.n_rcvar
        self.lw, self.lw32, self.wip32 = lw, lw32, wip32
        self.start_lmwid = start_lmwid
        self.prune, self.log_wbeam, self.fil_pen = prune, log_wbeam, fil_pen
        buf = self._buf
        buf("_exit_valid", g.exit_tab >= 0)                       # [W, Vr]
        buf("_exit_tab_c", np.maximum(g.exit_tab, 0))
        buf("_rssid", g.rssid)                                    # [W, n_ci]
        buf("_firstci", g.firstci)
        buf("_lmwid", v.lmwid)
        buf("_lmwid_c", np.maximum(v.lmwid, 0))
        buf("_is_filler", v.is_filler)
        buf("_fil_pen", fil_pen)
        # Offsets of a frame's rows in the history side-table.
        buf("_ar_E", np.arange(E))
        # The entries' tables; a flat lexicon's over the score_rows backend
        # (no dense table) adds the LM's successor lists in search-word
        # space, for the kernel (the tree steps read no entries).
        succ = None
        if dlm.tg_dense is None and g.lex_mode == "flat":
            succ = lm_entries.successors(dlm, self._lmwid_c)
            for name, x in zip(succ._fields, succ):
                self.register_buffer("_succ_" + name, x, persistent=False)
        self.lm_tab = lm_entries.Tables(
            self._lmwid_c, self._firstci, self._is_filler, self._fil_pen,
            self._rssid, succ, lw32, wip32)

    def variants(self, ex, best=None):
        """The channel exits ex [B, C] by word and variant, exv [B, W, Vr]
        (with `best` [B], the word-exit beam), and each word's best
        variant's score wex and channel sel [B, W]."""
        B = ex.shape[0]
        exv = torch.where(self._exit_valid, ex[:, self._exit_tab_c], NEG_INF)
        if best is not None and self.prune:
            exv = torch.where(exv > best[:, None, None] + self.log_wbeam,
                              exv, NEG_INF)
        wex = exv.amax(2)
        vwin = exv.argmax(2)
        sel = torch.gather(self._exit_tab_c.expand(B, self.W, self.Vr), 2,
                           vwin[..., None])[..., 0]
        return exv, wex, sel

    def write(self, tape, ok, wsel, vals, pe, prev_h2, prev_h1, slot_rc):
        """The frame's tape rows for the exits wsel [B, E] (live where ok)
        from their predecessors' slots pe and histories; returns the exits'
        histories (h2, h1): a filler keeps its predecessor's."""
        fil = self._is_filler[wsel]
        h2 = torch.where(fil, prev_h2, self._lmwid[wsel])
        h1 = torch.where(fil, prev_h1, prev_h2)
        rows = (torch.where(ok, wsel, -1), torch.where(ok, vals, NEG_INF),
                pe, h2, h1, torch.where(ok[..., None], slot_rc, NEG_INF))
        for a, r in zip(tape, rows):
            a.copy_(r)
        return h2, h1

    def read_hist(self, ht, pe):
        """Histories (h2, h1) of the tape slots `pe` [B, L] from the
        side-table ht [B, Tpad*E, 2]; slot -1 is the initial (<s>, -1)."""
        ph = ht.gather(1, pe.clamp_min(0)[..., None].expand(-1, -1, 2))
        return (torch.where(pe < 0, self.start_lmwid, ph[..., 0]),
                torch.where(pe < 0, -1, ph[..., 1]))

    def record_hist(self, ht, t, valid_t, h2, h1) -> None:
        """Frame t's histories into rows t*E .. t*E+E-1 of ht."""
        ht.index_copy_(1, t * self.E + self._ar_E, torch.where(
            valid_t[:, None, None], torch.stack([h2, h1], -1), -1))

    def entries(self, t, ok, wsel, h1, h2, slot_rc, lastci=None):
        """Single best cross-word entry per word over the frame's E exit
        slots (`ops/lm_entries.py`): (entry score [B, W], tape slot [B, W]
        int64), or with `lastci` [W] (entry score, payloads [B, W, 4]
        int32: tape slot, left-context CI phone, h2, h1).  A flat lexicon
        over the `score_rows` LM backend goes through the wrapper (on the
        card, the kernel over the successor lists), the dense table through
        the plain version."""
        if self.lm_tab.succ is None:
            return lm_entries.entries_ref(self.dlm, self.lm_tab, t, ok, wsel,
                                          h1, h2, slot_rc, lastci)
        return lm_entries.entries(self.dlm, self.lm_tab, t, ok,
                                  wsel.contiguous(), h1, h2,
                                  slot_rc.contiguous(), lastci)


class Step(DeviceTables):
    """What every frame step holds: the word graph `g`, the readout `ro`,
    its tables (`_graph_tables`) and the frame's senone-sequence rows
    (`_xs_rows`); `pip` and `log_beam` are float32."""

    copies = 1
    # The graph's count of senone rows a frame of `block_inputs` keeps
    # (None: the step keeps none).
    _block_rows = None

    def __init__(self, g, ro: Readout, bands, ent0=None, *, pip: float,
                 log_beam: float, device: torch.device):
        super().__init__(device)
        self.graph, self.ro = g, ro
        self.prune, self.log_beam, self.log_wbeam = (ro.prune, log_beam,
                                                     ro.log_wbeam)
        self._pip32 = pip
        self._graph_tables(g, bands, ent0)

    def _graph_tables(self, g, bands, ent0=None) -> None:
        """The tables of the graph g that every step (and the grammar
        search) reads; with the words' initial entries ent0 [W], the
        channels' (`_entc0`)."""
        buf = self._buf
        buf("_sing_sen", g.sing_sen)                              # [n_sing, S]
        buf("_sing_valid", g.sing_valid)
        buf("_comp_valid", g.comp_valid)                          # [n_comp, S]
        groups = g.comp_groups or [g.comp_mem]
        for i, cg in enumerate(groups):                           # [n_i, S, U_i]
            buf(f"_comp_group{i}", cg)
        self._n_comp_groups = len(groups)
        buf("_has_prev", g.prev_chan >= 0)
        buf("_is_entry", g.is_entry)
        for name, b in zip(("d0", "d1", "d2", "elast", "eprev"), bands):
            buf("_band_" + name, b, torch.float32)
        if ent0 is not None:
            entc0 = np.full((g.n_chan,), NEG_INF, np.float32)
            entc0[g.is_entry] = ent0[g.word_of[g.is_entry]]
            buf("_entc0", entc0)

    @classmethod
    def frame_bytes(cls, g, B: int) -> int:
        if cls._block_rows is None:
            return 0
        rows = getattr(g, cls._block_rows)
        return (rows * g.n_emit_state + g.comp_mem.size) * 4 * B

    def grow(self, carry):
        """A stream's carry once its tape has doubled."""
        return carry

    def _bands(self):
        """The transition bands of every channel, `hmm_step`'s form."""
        return (self._band_d0, self._band_d1, self._band_d2,
                self._band_elast, self._band_eprev)

    def _xs_rows(self, scores: torch.Tensor) -> torch.Tensor:
        """Senone scores [..., n_sen] -> extended-senone-sequence scores
        [..., n_xs, S]: singleton rows are a gather, composite rows the max
        over their members, one width bucket (`comp_groups`) at a time."""
        g = self.graph
        base = torch.where(self._sing_valid, scores[..., self._sing_sen],
                           NEG_INF)
        if g.n_xs == g.n_sing:
            return base
        comp = torch.cat([scores[..., getattr(self, f"_comp_group{i}")]
                          .amax(-1) for i in range(self._n_comp_groups)], -2)
        comp = torch.where(self._comp_valid, comp, NEG_INF)
        return torch.cat([base[..., : g.n_sing, :],
                          comp[..., : g.n_xs - g.n_sing, :]], -2)


class MpxStep(Step):
    """Multiplexed left contexts (`lcmode=mpx`; entries at t = 0 take the
    silence context `sil_ci`), fanout or composite right contexts: the
    senone row of an entry channel rides the Viterbi argmax as a payload,
    and so do the LM histories.  The channel update is `ops/mpx_step.py`:
    on the card two CUDA kernels around the word-exit readout, each state
    reading its senone score through its own row of the frame's
    extended-senone-sequence rows (no expansion); the readout's entries
    and their payloads are one more on the `score_rows` LM backend
    (`ops/lm_entries.py`)."""

    def __init__(self, g, ro: Readout, bands, ent0, sil_ci: int, **kw):
        super().__init__(g, ro, bands, ent0, **kw)
        xs0 = g.static_xs.copy()
        xs0[g.is_entry] = g.lcmap[g.lc_row[g.is_entry], sil_ci]
        self._buf("_lastci", g.lastci)
        self._buf("_entxs0", xs0)
        for name, a in (("xs", g.static_xs),
                        ("pc", np.maximum(g.prev_chan, 0)),
                        ("word_of", g.word_of),
                        ("lc_base", g.lc_row.astype(np.int64) * g.n_ci),
                        ("ci_of", g.ci_of), ("lcmap", g.lcmap.reshape(-1))):
            self._buf("_mpx_" + name, a, torch.int32)
        self.tab = mpx_step.Tables(
            self._mpx_xs, self._mpx_pc, self._has_prev, self._is_entry,
            self._mpx_word_of, self._mpx_lc_base, self._mpx_ci_of,
            self._mpx_lcmap, tuple(b.contiguous() for b in self._bands()),
            self.prune, self.log_beam, self.log_wbeam, self._pip32)

    def init_carry(self, B: int, side_frames: int):
        """alpha [B, C, S] f32 silent but the <s> entries, and the int32
        payloads (tape slot, senone-sequence row, hw2 = <s>, hw1 = -1)."""
        g = self.graph
        C, S = g.n_chan, g.n_emit_state
        dev = self.device
        h0 = self.ro.start_lmwid

        def full(shape, val):
            return torch.full(shape, val, dtype=torch.int32, device=dev)

        alpha = torch.full((C, S), NEG_INF, dtype=torch.float32, device=dev)
        xsr = self._mpx_xs[:, None].expand(C, S)
        alpha, pays = hmm_enter(
            alpha, (full((C, S), -1), xsr, full((C, S), h0),
                    full((C, S), -1)),
            self._entc0,
            (full((C,), -1), self._entxs0, full((C,), h0), full((C,), -1)))
        return tuple(a[None].expand(B, C, S).contiguous()
                     for a in (alpha,) + pays)

    def block_inputs(self, scores):
        return scores.unbind(1)

    def frame(self, hmmc, scores_t, t, valid_t, tape, la_t=None):
        ro = self.ro
        B, E, W = hmmc[0].shape[0], ro.E, ro.W
        tab = self.tab
        rows = self._xs_rows(scores_t)                            # [B, n_xs, S]
        st = mpx_step.step_exits(hmmc, rows, tab)

        # ---- word exits: per-variant readout [B, W, Vr], word-exit beam ----
        exv, wex, sel = ro.variants(st.ex, st.best)
        wexh3 = torch.gather(st.exh3, 1, sel[..., None].expand(B, W, 3))

        # ---- top-E word exits -> tape slots ----
        vals, wsel = topk2(wex, E)                                # [B, E]
        ok = (vals > NEG_INF * 0.5) & valid_t[:, None]
        slot_rc = torch.gather(exv, 1, wsel[..., None].expand(B, E, ro.Vr))
        pe, prev_h2, prev_h1 = torch.gather(
            wexh3, 1, wsel[..., None].expand(B, E, 3)).long().unbind(-1)
        h2, h1 = ro.write(tape, ok, wsel, vals, pe, prev_h2, prev_h1,
                          slot_rc)

        # ---- word entries (take effect next frame): score and payloads
        # (tape slot, left-context CI phone, h2, h1) a word ----
        ent_w, ent_pay = ro.entries(t, ok, wsel, h1, h2, slot_rc,
                                    self._lastci)
        return mpx_step.prune_enter(hmmc, rows, st, ent_w, ent_pay, la_t,
                                    valid_t, tab)


class CompositeStep(Step):
    """Composite left contexts (static and tree steps): every channel's
    senones are static, and a block's are expanded at once.  The carry:
    alpha, the payload [B, (N,) C, S] (`_payload`: type, initial value),
    the history side-table [B, F*E, 2] (a token's history by tape slot)
    and the tree steps' entry corrections, `_ct_width` a frame."""

    _block_rows = "n_chan"
    _payload = (torch.int64, -1)
    _ct_width = 0

    def _expansion_tables(self, g) -> None:
        """The tables of the steps that step the expansion (`hmm_step`)."""
        self._buf("_static_xs", g.static_xs)
        self._buf("_ci_of", g.ci_of)
        self._buf("_prev_chan_c", np.maximum(g.prev_chan, 0))

    def init_carry(self, B: int, side_frames: int):
        """Every channel silent but the initial entries (copy 0's)."""
        g = self.graph
        C, S, N = g.n_chan, g.n_emit_state, self.copies
        dev = self.device
        alpha = torch.full((C, S), NEG_INF, dtype=torch.float32, device=dev)
        alpha, _ = hmm_enter(alpha, (), self._entc0, ())
        shape = (B, C, S) if N == 1 else (B, N, C, S)
        if N > 1:
            alpha = torch.cat([alpha[None], alpha.new_full((N - 1, C, S),
                                                           NEG_INF)])
        dtype, fill = self._payload
        carry = (alpha.expand(shape).contiguous(),
                 torch.full(shape, fill, dtype=dtype, device=dev),
                 torch.full((B, side_frames * self.ro.E, 2), -1,
                            dtype=torch.int64, device=dev))
        if self._ct_width:
            carry += (torch.zeros((B, side_frames * self._ct_width),
                                  dtype=torch.float32, device=dev),)
        return carry

    def grow(self, carry):
        """The side-tables doubled with the stream's tape."""
        alpha, hist, ht, *ct = carry
        ht = torch.cat([ht, torch.full_like(ht, -1)], 1)
        ct = [torch.cat([c, torch.zeros_like(c)], 1) for c in ct]
        return (alpha, hist, ht, *ct)

    def block_inputs(self, scores):
        """[B, K, n_sen] -> [K, B, C, S] (elementwise: no result changes)."""
        return self._xs_rows(scores.transpose(0, 1))[:, :, self._static_xs]

    def _prune(self, alpha, ex, la_t=None):
        """Channel beam and word-exit beam relative to each utterance's
        frame best (prune_channels / save_bp thresholds); alpha [B, ..., C,
        S] (a leading copy axis for the tree copies), ex [B, ..., C].  With
        the phone-loop lookahead la_t [B, n_ci], a channel's best score
        takes its phone's lookahead before the beam."""
        if not self.prune:
            return alpha, ex
        lead = (1,) * (alpha.dim() - 2)
        bestscr = alpha.flatten(1).amax(1).view(-1, *lead)        # [B, 1..]
        cmax = alpha.amax(-1)                                     # [B, .., C]
        if la_t is not None:
            cmax = cmax + la_t[:, self._ci_of].view(
                la_t.shape[0], *lead[1:], -1)
        keep = cmax > bestscr + self.log_beam
        alpha = torch.where(keep[..., None], alpha, NEG_INF)
        ex = torch.where(ex > bestscr + self.log_wbeam, ex, NEG_INF)
        return alpha, ex


class StaticStep(CompositeStep):
    """A flat lexicon: the reference's `_make_core_static` (any n_rcvar)
    and `_make_core_static_batched` (n_rcvar == 1) in one step; a pure
    shift propagates within words where every chain channel's predecessor
    is the previous channel (`_chain_shift`)."""

    def __init__(self, g, ro: Readout, bands, ent0, **kw):
        super().__init__(g, ro, bands, ent0, **kw)
        self._expansion_tables(g)
        self._buf("_word_of", g.word_of)
        self._buf("_exit_col", np.maximum(g.exit_tab[:, 0], 0))
        chain = np.arange(g.n_chan) - 1
        self._chain_shift = bool(
            np.all((g.prev_chan == -1) | (g.prev_chan == chain)))

    def frame(self, carry, sen_t, t, valid_t, tape, la_t=None):
        alpha0, hist0, ht = carry
        ro = self.ro
        B, E = alpha0.shape[0], ro.E
        neg = NEG_INF
        alpha, (hist,), ex, (exh,) = hmm_step(alpha0, (hist0,), sen_t,
                                               self._bands())
        alpha, ex = self._prune(alpha, ex, la_t)

        # ---- word exits ----
        if ro.Vr == 1:
            wex = ex[:, self._exit_col]                           # [B, W]
            wbp = exh[:, self._exit_col]
        else:
            exv, wex, sel = ro.variants(ex)
            wbp = torch.gather(exh, 1, sel)
        vals, wsel = topk2(wex, E)                                # [B, E]
        slot_rc = (vals[..., None] if ro.Vr == 1 else
                   torch.gather(exv, 1, wsel[..., None].expand(B, E, ro.Vr)))
        ok = (vals > neg * 0.5) & valid_t[:, None]
        pe = torch.gather(wbp, 1, wsel)
        h2, h1 = ro.write(tape, ok, wsel, vals, pe, *ro.read_hist(ht, pe),
                          slot_rc)

        # ---- word entries ----
        ent_w, ebp_w = ro.entries(t, ok, wsel, h1, h2, slot_rc)
        ro.record_hist(ht, t, valid_t, h2, h1)

        # ---- within-word propagation ----
        if self._chain_shift:
            prop = torch.cat([ex.new_full((B, 1), neg),
                              ex[:, :-1] + self._pip32], 1)
            bsh = torch.cat([exh.new_full((B, 1), -1), exh[:, :-1]], 1)
        else:
            pc = self._prev_chan_c
            prop = torch.where(self._has_prev, ex[:, pc] + self._pip32, neg)
            bsh = torch.where(self._has_prev, exh[:, pc], -1)
        ie = self._is_entry
        wo = self._word_of
        alpha, (hist,) = hmm_enter(
            alpha, (hist,), torch.where(ie, ent_w[:, wo], prop),
            (torch.where(ie, ebp_w[:, wo], bsh),))
        vm = valid_t[:, None, None]
        return (torch.where(vm, alpha, alpha0), torch.where(vm, hist, hist0),
                ht)


class LexTreeStep(CompositeStep):
    """The prefix-tree lexicon's steps, in `copies` copies: a unigram
    lookahead smear inside the tree, with `bgla` a bigram correction at
    the roots (over the LM `lm` and the vocabulary `v`), and the exact
    trigram for a shortlist of exits (`_tree_exits`)."""

    def __init__(self, g, ro: Readout, bands, lm, v, bgla: bool,
                 copies: int = 1, **kw):
        super().__init__(g, ro, bands, **kw)
        self.copies = copies
        self.use_bgla = bgla
        self._setup_tree_bgla(g, lm, v)
        lw = ro.lw
        # Tree entries carry only the lookahead smear; the exact LM,
        # P(w|<s>) included, is applied at the exit readout from the
        # (<s>, -1) history.
        entc0 = np.full((g.n_chan,), NEG_INF, np.float32)
        entc0[g.is_entry] = lw * g.la[g.is_entry]
        if bgla:
            entc0[self._roots_np] += self._corr0_np
        self._buf("_entc0", entc0)
        # lw-scaled lookahead tables: per-channel smear, telescoping
        # within-word delta, per-word exit correction (lw * ug(w); 0 for
        # fillers).
        la = lw * g.la.astype(np.float64)
        delta = np.where(g.prev_chan >= 0,
                         la - la[np.maximum(g.prev_chan, 0)], 0.0)
        self._buf("_la_entry_c", la.astype(np.float32))
        self._buf("_la_delta_c", delta.astype(np.float32))
        self._buf("_la_word_lw", (lw * g.la_word).astype(np.float32))
        self._buf("_psel_bonus", np.where(v.is_filler, ro.fil_pen,
                                          np.float32(ro.wip32)),
                  torch.float32)
        self._ct_width = copies * (self._n_roots if bgla else 1)
        if bgla:
            # Offsets of a frame's rows in the entry-correction side-table.
            self._buf("_ar_ct", np.arange(copies * self._n_roots))

    def _setup_tree_bgla(self, g, lm, v) -> None:
        """Bigram-lookahead tables for the tree smear (host numpy, as the
        reference's `_setup_tree_bgla`): for every re-entry history h, a
        per-root correction corr(h, r) = lw * (max over the subtree's words
        of bg(h, w) - ugmax(r)), stored as a CSR over (h, r) pairs with an
        explicit successor (`_bgla_ptr/_root/_val`) over the dense backoff
        base lw * bo(h).  `_root_of_word` maps each word to the root its
        tokens entered; `_corr0` is the <s> row for utterance-initial
        entries."""
        start = self.ro.start_lmwid
        prevc = g.prev_chan
        # A tree's exit channels are one block in word order (`exit_base`).
        cur = np.arange(v.n_word, dtype=np.int64) + g.exit_base
        for _ in range(256):
            nxt = prevc[cur]
            m = nxt >= 0
            if not m.any():
                break
            cur = np.where(m, nxt, cur)
        roots_idx = np.nonzero(g.is_entry)[0]
        R = len(roots_idx)
        rid = np.full(g.n_chan, -1, np.int64)
        rid[roots_idx] = np.arange(R)
        root_of_word = rid[cur]
        if not (root_of_word >= 0).all():
            raise ValueError("a word's channel path must start at a root")
        self._n_roots = R
        self._roots_np = roots_idx
        self._buf("_roots", roots_idx)
        self._buf("_root_of_word", root_of_word)
        if not self.use_bgla:
            self._corr0_np = np.zeros(R, np.float32)
            self._buf("_corr0", self._corr0_np)
            return
        ugmax_root = np.asarray(g.la, np.float64)[roots_idx]
        is_fil = np.asarray(v.is_filler)
        lmw = np.asarray(v.lmwid, np.int64)
        okw = (~is_fil) & (lmw >= 0)
        has_word = np.zeros(R, bool)
        has_word[root_of_word[okw]] = True
        Vlm = lm.n_words
        lww = np.float32(self.ro.lw)
        # Sparse excess entries: for every (context h, root r) with an
        # explicit bigram successor in subtree(r),
        #   excess = lw * (max explicit bg_prob - ugmax(r)).
        keys = np.zeros(0, np.int64)
        vals = np.zeros(0, np.float32)
        if len(lm.bg_wid):
            pairs = np.unique(
                np.stack([lmw[okw], root_of_word[okw]], 1), axis=0)
            pptr = np.searchsorted(pairs[:, 0], np.arange(Vlm + 1))
            cnt = np.diff(pptr)
            ctx = np.repeat(np.arange(Vlm),
                            np.diff(lm.bg_ptr)).astype(np.int64)
            wid = np.asarray(lm.bg_wid, np.int64)
            prob = np.asarray(lm.bg_prob, np.float32)
            ks, vs = [], []
            for p in range(int(cnt.max()) if len(cnt) else 0):
                sel = cnt[wid] > p
                r = pairs[pptr[wid[sel]] + p, 1]
                ks.append(ctx[sel] * R + r)
                vs.append(prob[sel] - ugmax_root[r].astype(np.float32))
            if ks:
                keys = np.concatenate(ks)
                vals = np.concatenate(vs)
                order = np.argsort(keys, kind="stable")
                keys, vals = keys[order], vals[order]
                uk, start_i = np.unique(keys, return_index=True)
                vmax = np.maximum.reduceat(vals, start_i)
                rr = (uk % R).astype(np.int64)
                keep = has_word[rr]
                keys, vals = uk[keep], (lww * vmax[keep]).astype(np.float32)
        rowptr = np.searchsorted(keys // R, np.arange(Vlm + 1))
        bgla_root = (keys % R if len(keys) else np.zeros(1, np.int64))
        bgla_val = vals if len(vals) else np.zeros(1, np.float32)
        self._buf("_bgla_ptr", rowptr)
        self._buf("_bgla_root", bgla_root, torch.int64)
        self._buf("_bgla_val", bgla_val, torch.float32)
        self._bgla_maxrow = int(np.diff(rowptr).max()) if len(keys) else 0
        self._buf("_bgla_base", (lww * np.asarray(lm.ug_bo, np.float32)
                                 ).astype(np.float32))
        self._buf("_has_word", has_word)
        # <s> row for utterance-initial entries (host-evaluated).
        corr0 = np.full(R, 0.0, np.float32)
        if start >= 0:
            corr0[:] = lww * float(lm.ug_bo[start])
            lo, hi = int(rowptr[start]), int(rowptr[start + 1])
            if hi > lo:
                np.maximum.at(corr0, bgla_root[lo:hi], bgla_val[lo:hi])
            corr0[~has_word] = 0.0
        self._corr0_np = corr0
        self._buf("_corr0", corr0)

    def _bgla_rows(self, h: torch.Tensor) -> torch.Tensor:
        """Bigram corrections for history words h [L] -> [L, R]: the base
        lw * bo(h) overlaid with the CSR excess entries by a scatter-max
        whose masked lanes go to the dropped column R; 0 for h < 0 (no
        context) and for roots without LM words."""
        R = self._n_roots
        L = h.shape[0]
        hc = h.clamp_min(0)
        corr = self._bgla_base[hc][:, None].expand(L, R + 1).contiguous()
        if self._bgla_maxrow:
            lo = self._bgla_ptr[hc]
            hi = self._bgla_ptr[hc + 1]
            pos = lo[:, None] + torch.arange(self._bgla_maxrow,
                                             device=h.device)
            okk = pos < hi[:, None]
            idx = pos.clamp_max(self._bgla_root.shape[0] - 1)
            r = torch.where(okk, self._bgla_root[idx], R)
            val = torch.where(okk, self._bgla_val[idx], NEG_INF)
            corr = corr.scatter_reduce(1, r, val, "amax")
        corr = corr[:, :R]
        return torch.where(self._has_word[None] & (h[:, None] >= 0), corr,
                           0.0)

    def _exit_cols(self, ex, exh):
        """Every word's exit channel of ex/exh [..., C] -> [..., W]: the
        block of the tree's exit channels."""
        xb, W = self.graph.exit_base, self.ro.W
        return ex[..., xb: xb + W], exh[..., xb: xb + W]

    def _tree_exits(self, t, valid_t, tape, wex, wbp, ht, ct, nsel=None):
        """The exit readout from each word's best exit `wex` [B, W] and its
        token's payload `wbp` (`_slots`): the shortlist on the smeared
        score, the exact trigram in place of the smeared unigram, the
        bigram correction of the token's entry cancelled (`_ct_rows`; nsel
        [B, W]: the copy of each exit), the top E to the tape and the
        history side-table.  Returns their (vals, ok, h2, h1) [B, E]."""
        ro = self.ro
        E, W, R = ro.E, ro.W, self._n_roots
        E2 = min(4 * E, W)
        neg = NEG_INF
        v2, wsel2 = topk2(wex + self._psel_bonus, E2)             # [B, E2]
        okp = (v2 > neg * 0.5) & valid_t[:, None]
        pe2 = self._slots(torch.gather(wbp, 1, wsel2), t)
        ph2, ph1 = ro.read_hist(ht, pe2)
        wl2 = ro._lmwid[wsel2]
        fil2 = ro._is_filler[wsel2]
        own = ro.dlm.score_tg(ph1, ph2, wl2.clamp_min(0), lanes=E2)
        if self.use_bgla:
            rw2 = self._root_of_word[wsel2]                       # [B, E2]
            row = self._ct_rows(pe2.clamp_min(0) // E, wsel2, nsel)
            cu = torch.gather(ct, 1, row * R + rw2)
            cu = torch.where(pe2 < 0, self._corr0[rw2], cu)
        else:
            cu = 0.0
        resc = torch.where(fil2, v2 - cu,
                           v2 - cu - self._la_word_lw[wsel2]
                           + ro.lw32 * own)
        resc = torch.where(okp, resc, neg)

        # ---- top-E rescored exits -> tape slots ----
        vals, sel = _top_k(resc, E)                               # [B, E]
        wsel = torch.gather(wsel2, 1, sel)
        ok = vals > neg * 0.5
        pe = torch.gather(pe2, 1, sel)
        h2, h1 = ro.write(tape, ok, wsel, vals, pe,
                          torch.gather(ph2, 1, sel),
                          torch.gather(ph1, 1, sel), vals[..., None])
        ro.record_hist(ht, t, valid_t, h2, h1)
        return vals, ok, h2, h1


class TreeStep(LexTreeStep):
    """One tree copy: the reference's `_make_core_tree` (N = 1) and
    `_make_core_tree_batched` in one step.  Tokens carry an 8-bit entry
    age (255 = the initial <s> entry; the increment saturates at 254 + 1);
    the re-entry always takes the frame's slot 0, so a token's tape slot
    is (t - age)*E.  The channel update is `ops/tree_step.py`: on the card
    two CUDA kernels around the exit readout, each channel reading its
    senone row of the frame's senone-sequence rows (no expansion)."""

    _block_rows = "n_xs"
    _payload = (torch.uint8, 255)

    def __init__(self, g, ro: Readout, bands, lm, v, bgla: bool, **kw):
        super().__init__(g, ro, bands, lm, v, bgla, **kw)
        root = np.zeros(g.n_chan, np.int32)
        root[self._roots_np] = np.arange(self._n_roots)
        for name, a in (("xs", g.static_xs), ("pc", np.maximum(g.prev_chan, 0)),
                        ("root", root), ("ci_of", g.ci_of)):
            self._buf("_tree_" + name, a, torch.int32)
        self.tab = tree_step.Tables(
            self._tree_xs, self._tree_pc, self._has_prev, self._is_entry,
            self._tree_root, self._tree_ci_of, self._la_delta_c,
            self._la_entry_c, tuple(b.contiguous() for b in self._bands()),
            self.prune, self.log_beam, self.log_wbeam, self._pip32)

    def block_inputs(self, scores):
        """The block's senone-sequence rows [K, B, n_xs, S]."""
        return self._xs_rows(scores.transpose(0, 1).contiguous())

    def _slots(self, age, t):
        age = age.long()
        return torch.where(age >= 255, -1, (t - age) * self.ro.E)

    def _ct_rows(self, row, wsel2, nsel):
        return row

    def frame(self, carry, rows_t, t, valid_t, tape, la_t=None):
        alpha0, hist0, ht, ct = carry
        R = self._n_roots
        neg = NEG_INF
        tab = self.tab
        st = tree_step.step_exits(alpha0, hist0, rows_t, tab)
        wex, wbp = self._exit_cols(st.ex, st.exh)                 # [B, W]
        if self.prune:
            wex = torch.where(wex > st.best[:, None] + self.log_wbeam, wex,
                              neg)
        vals, ok, h2, _ = self._tree_exits(t, valid_t, tape, wex, wbp, ht,
                                           ct)

        # ---- single best re-entry, into every root ----
        ent = torch.where(ok[:, 0], vals[:, 0], neg)              # [B]
        corr = None
        if self.use_bgla:
            # Per-history bigram correction at the roots, recorded for the
            # exact cancellation at the exit readout (0 on padded frames,
            # whose rows are never read).
            corr = self._bgla_rows(h2[:, 0])                      # [B, R]
            ct.index_copy_(1, t * R + self._ar_ct,
                           torch.where(valid_t[:, None], corr, 0.0))
        alpha0, hist0 = tree_step.prune_enter(alpha0, hist0, st, ent, corr,
                                              la_t, valid_t, tab)
        return alpha0, hist0, ht, ct


class TreeCopiesStep(LexTreeStep):
    """N > 1 tree copies [B, N, C, S] (`nlextree`; the reference's
    `_make_core_tree`, N > 1): the copies' exits merge per word (best
    copy, first on ties), and copy n re-enters from the n-th best tape
    slot whose (h2, h1) history no earlier copy took.  Tokens carry their
    tape slot (-1 = the initial history)."""

    def __init__(self, g, ro: Readout, bands, lm, v, bgla: bool,
                 copies: int, **kw):
        super().__init__(g, ro, bands, lm, v, bgla, copies, **kw)
        self._expansion_tables(g)

    def _slots(self, slot, t):
        return slot

    def _ct_rows(self, row, wsel2, nsel):
        return row * self.copies + torch.gather(nsel, 1, wsel2)

    def frame(self, carry, sen_t, t, valid_t, tape, la_t=None):
        alpha0, hist0, ht, ct = carry
        B, N = alpha0.shape[0], alpha0.shape[1]
        E, R = self.ro.E, self._n_roots
        neg = NEG_INF
        alpha, (hist,), ex, (exh,) = hmm_step(alpha0, (hist0,), sen_t[:, None],
                                               self._bands())
        alpha, ex = self._prune(alpha, ex, la_t)

        # ---- exit readout: best copy per word ----
        wexn, whn = self._exit_cols(ex, exh)                      # [B, N, W]
        nsel = _argmax_first(wexn, 1)                             # [B, W]
        wex = wexn.amax(1)
        wbp = torch.gather(whn, 1, nsel[:, None])[:, 0]
        vals, ok, h2, h1 = self._tree_exits(t, valid_t, tape, wex, wbp, ht,
                                            ct, nsel)

        # ---- re-entries: copy n takes the n-th history-distinct slot
        # (vals are sorted, so the first available slot is the best) ----
        ents, bps, hsels = [], [], []
        chosen = torch.zeros_like(ok)
        slots = torch.arange(E, device=ok.device)
        for _ in range(N):
            avail = ok & ~chosen
            has = avail.any(1)
            idx = torch.where(avail, slots, E).amin(1)
            idx = torch.where(has, idx, 0)[:, None]
            ents.append(torch.where(has, torch.gather(vals, 1, idx)[:, 0],
                                    neg))
            bps.append(torch.where(has, t * E + idx[:, 0], -1))
            hh2 = torch.gather(h2, 1, idx)
            hsels.append(torch.where(has, hh2[:, 0], -1))
            chosen = chosen | ((h2 == hh2) & (h1 == torch.gather(h1, 1, idx)))
        ent = torch.stack(ents, 1)                                # [B, N]
        ent_bp = torch.stack(bps, 1)

        # ---- within-word propagation with the telescoping smear ----
        pc = self._prev_chan_c
        prop = torch.where(self._has_prev,
                           ex[..., pc] + self._pip32 + self._la_delta_c, neg)
        bsh = torch.where(self._has_prev, exh[..., pc], -1)
        entry_base = ent[..., None] + self._la_entry_c            # [B, N, C]
        if self.use_bgla:
            corr = self._bgla_rows(torch.stack(hsels, 1).reshape(-1))
            corr = corr.view(B, N, R)
            ct.index_copy_(1, t * (N * R) + self._ar_ct, torch.where(
                valid_t[:, None], corr.reshape(B, N * R), 0.0))
            entry_base[..., self._roots] += corr
        ie = self._is_entry
        alpha, (hist,) = hmm_enter(
            alpha, (hist,), torch.where(ie, entry_base, prop),
            (torch.where(ie, ent_bp[..., None], bsh),))
        vm = valid_t[:, None, None, None]
        return (torch.where(vm, alpha, alpha0), torch.where(vm, hist, hist0),
                ht, ct)
