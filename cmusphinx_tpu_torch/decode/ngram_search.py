"""N-gram (trigram) decoder over a senone scorer: flat and prefix-tree
lexicons with exact or composite cross-word contexts.

Port of `cmusphinx_tpu/decode/ngram_search.py` (`NGRAM_ARGS`, `NgramVocab`,
`topk2`, `NgramSearch.__init__`, `_xscores_all`, `_init_hmmc`, `_make_core`,
`_expand_block_batched`, `_init_hmmc_static`, the static cores
`_make_core_static` / `_make_core_static_batched`, `_setup_tree_bgla`,
`_bgla_rows`, `_init_hmmc_tree`, the tree cores `_make_core_tree` (any
number of copies) / `_make_core_tree_batched`, the phone-loop lookahead
`pl_window`, `device_decode`, `device_decode_batched`,
`device_backtrace`, `_hyp_from_chase`, `decode`, `decode_batch`,
`decode_batch_cep`, the streaming decode `stream_start` / `stream_push` /
`stream_partial` / `stream_end`, and the host results layer: the readout
`_final_slot` / `_backtrace`, `get_lattice` and bestpath rescoring).  See
the reference's docstrings for the search's semantics.  The graph picks
one of three frame steps:

- `_step_mpx`: multiplexed left contexts (`lcmode=mpx`), fanout or
  composite right contexts; the senone row of an entry channel rides the
  Viterbi argmax as a payload, and so do the LM histories.  Its channel
  update is `ops/mpx_step.py`: on the card two CUDA kernels around the
  word-exit readout, each state reading its senone score through its own
  row of the frame's extended-senone-sequence rows (no expansion); the
  readout, the tape and the per-word entries stay here.
- `_step_static`: composite left contexts and a flat lexicon; every
  channel's senones are static, so they are expanded for a block of frames
  at once (`_expand_block`); histories live in a per-slot side-table.
- `_step_tree`: the prefix-tree lexicon (composite contexts); a unigram
  lookahead smear inside the tree, an optional bigram correction at the
  roots, the exact trigram for a shortlist of exits, and an 8-bit entry
  age as the token payload.  Its channel update is `ops/tree_step.py`:
  on the card two CUDA kernels around the exit readout, each channel
  reading its senone row from the frame's extended-senone-sequence rows
  (no expansion).  With `nlextree` N > 1, `_step_tree_copies` runs N
  copies of the tree `[B, N, C, S]`: copy n takes the n-th best
  history-distinct re-entry, and the payload is the tape slot.

`pl_window` W > 0 adds the CI-phone lookahead to every channel's best
score before the channel beam, in every step: the CI phones' best senone
scores relative to the frame's best, maxed over the next W frames (the
padding repeats the last row), times `pl_weight`.  A stream then holds
back W frames and scores each chunk on CHUNK + W frames; its flush pads
by repeating the last frame.  (The reference turns its batched fast path
off for pl_window and nlextree > 1; the port has one path, which serves
them.)

What differs in form, not in result:

- The batch is an explicit leading dimension: every step's state is
  `[B, C, S]` (the reference vmaps, or packs the batch by hand, and lays
  the static and tree states out `[B, S, C]` or flat state-major for the
  TPU's lanes); a single utterance is a batch of one.  One step serves
  what the reference splits into its unbatched and batched cores.
- The frame scan runs in blocks of frames (`_block`: the static and
  tree steps' senone rows, then a frame step per frame, the frame
  index a 0-d tensor advanced on the device).  On the card each block is
  a captured CUDA graph (`graphs.BlockRunner`), captured once per shape
  and replayed block after block: the counterpart of the reference's
  `jit`-compiled `lax.scan`.  On the CPU the same block runs eagerly.
- Gathers are plain gathers; the reference's one-hot matmul gathers, its
  flat state-major layout and its 128-lane root padding were TPU devices.
- Top-k is a stable descending sort, which keeps `jax.lax.top_k`'s
  lowest-index-first order on ties; `topk2` keeps the reference's
  two-stage tie rule.  The tape is the reference's, slot for slot.
- Payloads ride as int32 in the mpx carry, as int64 in the static step
  and the tree copies, and as uint8 for the one-copy tree's entry age;
  the tapes are stored as int32.

A stream decodes one utterance (a batch of one) in chunks of `CHUNK`
frames through the same frame steps, its carry and tape on the device
between pushes; its partial and final hypotheses come from the host
readout on the tape (`_backtrace`, with the host LM), as in the reference.
Lattices are built on the host from one utterance's tape
(`_lattice_from_tape`) and rescored by the native runtime
(`utils/native.py`).

`maxbatch` is accepted and has no effect: chunking a batch was a
workaround for TPU compiler crashes.

Under a profiler a batch decode is tiled by spans (`utils/profile.span`):
`ngram.pad` (host padding and the copies to the device), `ngram.features`,
`ngram.score`, `ngram.lookahead` (with `pl_window`), the runner's
`frame_loop`, `ngram.backtrace` (the chase and its copy to the host) and
`ngram.hyps` (the hypotheses, and bestpath).  `profile` counts
`host_reads`: each read of a batch's results from the device that blocks
the host (the chase's early-exit tests, its copy, and the batch's host
tapes that bestpath and the lattice read).
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..models.dict import Dictionary
from ..models.dict2pid import Dict2Pid
from ..models.mdef import Mdef
from ..models.ngram import NgramModel
from ..models.ngram_device import DeviceNgram
from ..models.tmat import TransitionMatrices
from ..ops import mpx_step, tree_step
from ..ops.hmm import NEG_INF, hmm_bands, hmm_enter, hmm_step
from ..utils import native
from ..utils.config import Arg, Config
from ..utils.profile import Profile, span
from .graphs import GRAPH_CACHE, BlockRunner  # noqa: F401 (read by tests)
from .lattice import LatNode, Lattice
from .lexgraph import build_word_graph
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
        "Phone-loop lookahead window in frames (0 = off): the CI-phone "
        "loop evaluated over the next pl_window frames tightens the beam"),
    Arg("pl_weight", float, 3.0, "Weight on phone-loop lookahead penalties"),
    Arg("rcmode", str, "auto",
        "Cross-word right-context handling: 'fanout' (exact per-context "
        "word-final channels) or 'composite' (one composite-triphone exit "
        "channel per word); 'auto' picks fanout below 1000 words"),
    Arg("lcmode", str, "auto",
        "Cross-word left-context handling: 'mpx' (multiplexed senone "
        "sequences riding the Viterbi argmax) or 'composite' (per-state max "
        "over left contexts: static senones, the large-vocabulary path); "
        "'auto' follows rcmode"),
    Arg("lexmode", str, "auto",
        "Lexicon layout: 'flat' (one phone chain per word) or 'tree' "
        "(prefix-shared channels, unigram lookahead smear, exact trigram at "
        "the exit readout); 'auto' picks tree at >= 10k words with "
        "composite contexts; tree requires composite lc+rc"),
    Arg("treela", str, "bg",
        "Tree lookahead smear: 'bg' adds a per-history bigram correction at "
        "the roots (cancelled exactly at the exit readout), 'ug' keeps the "
        "static unigram smear only"),
    Arg("nlextree", int, 1,
        "Number of lexicon-tree copies (tree lexicon only): copy n holds "
        "the n-th best history-distinct cross-word entry"),
    Arg("maxbatch", int, 16,
        "Largest utterance batch decoded as one program in the reference; "
        "no effect here"),
    Arg("bestpath", bool, False,
        "Run lattice trigram rescoring after Viterbi (ps -bestpath)"),
    Arg("bestpathlw", float, 9.5, "Language weight for bestpath rescoring"),
    Arg("latbeam", float, 0.0,
        "Lattice link beam for bestpath rescoring: links off every path "
        "within this (linear-probability) width of the bigram-approximate "
        "best path are skipped by the exact trigram DP.  Default 0 = "
        "fully exact rescoring"),
    Arg("ascale", float, 20.0, "Inverse acoustic scale for lattice posteriors"),
    Arg("prune", bool, True,
        "Apply beam pruning (prune_channels / save_bp threshold semantics)"),
]

# Bytes of senone scores one block of frames of the static and tree steps
# may hold (expanded to every channel, or the one-copy tree's rows).  The
# reference sized its frame blocks for TPU memory (ROADMAP A-x); the
# expansion is elementwise, so the block changes no result.
EXPAND_BLOCK_BYTES = 192 << 20


def _f32(x: float) -> float:
    """A Python float rounded to float32, as the reference's jnp.float32."""
    return float(np.float32(x))


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
    transition matrices and the LM tables are buffers on `device`.

    On the card the frame loop runs through captured CUDA graphs of a
    block of frames (`_scan`).  `_graphs = False`, a private attribute
    for the tests and `chip_smoke.py`, runs the same blocks eagerly
    there, to compare the two."""

    FRAME_BUCKET = 100

    def __init__(self, lm: NgramModel, d: Dictionary, mdef: Mdef,
                 tmat: TransitionMatrices, scorer: nn.Module,
                 config: Optional[Config] = None, *,
                 device: torch.device | str = "cuda", **kwargs):
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
        self.pl_window = int(cfg["pl_window"])
        self.pl_weight = float(cfg["pl_weight"])

        self.lm = lm
        self.dict = d
        self.mdef = mdef
        self.scorer = scorer
        self.vocab = v = NgramVocab(lm, d)
        rc_mode = str(cfg["rcmode"])
        if rc_mode == "auto":
            rc_mode = "fanout" if v.n_word < 1000 else "composite"
        self.rc_mode = rc_mode
        lc_mode = str(cfg["lcmode"])
        if lc_mode == "auto":
            lc_mode = "mpx" if rc_mode == "fanout" else "composite"
        lex_mode = str(cfg["lexmode"])
        if lex_mode == "auto":
            lex_mode = ("tree" if v.n_word >= 10000
                        and rc_mode == "composite"
                        and lc_mode == "composite" else "flat")
        # Unigram lookahead for the tree smear (0 for fillers: they pay
        # their own penalties at the exit readout).
        ugla = None
        if lex_mode == "tree":
            ugla = np.where(v.is_filler, 0.0,
                            np.asarray(lm.ug_prob)[np.maximum(v.lmwid, 0)])
        g = self.graph = build_word_graph(v.dict_wid, d, mdef,
                                          Dict2Pid(mdef, d), rc_mode=rc_mode,
                                          lc_mode=lc_mode, lex_mode=lex_mode,
                                          ug_lookahead=ugla)
        self._tree = g.lex_mode == "tree"
        self.nlextree = max(1, int(cfg["nlextree"])) if self._tree else 1
        # Static senones (composite left contexts): the frame-block
        # expansion, and a pure shift for within-word propagation when
        # every chain channel's predecessor is the previous channel.
        self._fast = g.lc_mode == "composite"
        chain = np.arange(g.n_chan) - 1
        self._chain_shift = bool(
            np.all((g.prev_chan == -1) | (g.prev_chan == chain)))
        self.E = min(self.E, v.n_word)
        self.dlm = DeviceNgram(lm, device=self.device)
        self._graphs = True
        self._runner = BlockRunner(axis=1, counters=(
            self.dlm.calls, tree_step.launches, mpx_step.launches))
        self.profile = Profile()
        self._host_reads = self.profile.counter("host_reads")
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
        self._ent0, self._fil_pen_np = ent0, fp      # host lattice terms
        entc0 = np.full((g.n_chan,), NEG_INF, np.float32)
        if self._tree:
            # Tree entries carry only the lookahead smear; the exact LM,
            # P(w|<s>) included, is applied at the exit readout from the
            # (<s>, -1) history.
            self._setup_tree_bgla(g, v)
            entc0[g.is_entry] = self.lw * g.la[g.is_entry]
            if self.use_bgla:
                entc0[self._roots_np] += self._corr0_np
        else:
            entc0[g.is_entry] = ent0[g.word_of[g.is_entry]]
        xs0 = g.static_xs.copy()
        xs0[g.is_entry] = g.lcmap[g.lc_row[g.is_entry], self.sil_ci]

        buf = self._buf
        buf("_sing_sen", g.sing_sen)                              # [n_sing, S]
        buf("_sing_valid", g.sing_valid)
        buf("_comp_valid", g.comp_valid)                          # [n_comp, S]
        groups = g.comp_groups or [g.comp_mem]
        for i, cg in enumerate(groups):                           # [n_i, S, U_i]
            buf(f"_comp_group{i}", cg)
        self._n_comp_groups = len(groups)
        buf("_static_xs", g.static_xs)
        buf("_word_of", g.word_of)
        buf("_is_entry", g.is_entry)
        buf("_exit_valid", g.exit_tab >= 0)                       # [W, Vr]
        buf("_exit_tab_c", np.maximum(g.exit_tab, 0))
        buf("_rssid", g.rssid)                                    # [W, n_ci]
        buf("_firstci", g.firstci)
        buf("_rssid_sil", g.rssid[:, self.sil_ci])                # [W]
        buf("_has_prev", g.prev_chan >= 0)
        buf("_ci_of", g.ci_of)
        # Phone-loop lookahead: each CI phone's senone row.
        ci_sen = mdef.sseq[mdef.phone_ssid[: mdef.n_ciphone]].astype(np.int64)
        bad = int(np.int32(np.uint16(0xFFFF)))
        buf("_ci_sen", np.where(ci_sen == bad, 0, ci_sen))
        buf("_ci_sen_valid", ci_sen != bad)
        buf("_prev_chan_c", np.maximum(g.prev_chan, 0))
        buf("_lmwid", v.lmwid)
        buf("_lmwid_c", np.maximum(v.lmwid, 0))
        buf("_is_filler", v.is_filler)
        buf("_is_finish", v.is_finish)
        buf("_fil_pen", fp)
        buf("_entc0", entc0)
        # Offsets of a frame's rows in the history side-table and (the tree
        # with bigram lookahead) the entry-correction side-table.
        buf("_ar_E", np.arange(self.E))
        if self._tree and self.use_bgla:
            buf("_ar_ct", np.arange(self.nlextree * self._n_roots))
        for name, b in zip(("d0", "d1", "d2", "elast", "eprev"),
                           hmm_bands(tmat.log_tp[g.tmat_idx])):
            buf("_band_" + name, b, torch.float32)
        if self._fast:
            buf("_exit_col", np.maximum(g.exit_tab[:, 0], 0))
            if self._tree:
                # lw-scaled lookahead tables: per-channel smear, telescoping
                # within-word delta, per-word exit correction (lw * ug(w);
                # 0 for fillers).
                la = self.lw * g.la.astype(np.float64)
                delta = np.where(g.prev_chan >= 0,
                                 la - la[np.maximum(g.prev_chan, 0)], 0.0)
                buf("_la_entry_c", la.astype(np.float32))
                buf("_la_delta_c", delta.astype(np.float32))
                buf("_la_word_lw", (self.lw * g.la_word).astype(np.float32))
                buf("_psel_bonus", np.where(v.is_filler, fp,
                                            np.float32(self.log_wip)),
                    torch.float32)
                if self.nlextree == 1:
                    self._tree_tab = self._tree_tables(g)
        else:
            buf("_lastci", g.lastci)
            buf("_entxs0", xs0)
            self._mpx_tab = self._mpx_tables(g)
        # (tapes, lengths, last index) of the most recent batch; the tapes
        # stay on the device until a lattice needs them (`_host_tapes`).
        # `_last`: one utterance's host tapes + its length, for get_lattice.
        self._last_batch: Optional[tuple] = None
        self._host_tapes: Optional[tuple] = None
        self._last: Optional[tuple] = None
        self._lm_arrays: Optional[native.LmArrays] = None  # built at first use

    def _buf(self, name: str, a, dtype=None) -> None:
        """Register host array `a` as a buffer on the search's device;
        narrow integers widen to int64 (torch's index type)."""
        t = torch.as_tensor(np.asarray(a))
        if dtype is not None:
            t = t.to(dtype)
        elif t.dtype in (torch.int16, torch.int32):
            t = t.long()
        self.register_buffer(name, t.to(self.device), persistent=False)

    # ------------------------------------------------------------------
    def _setup_tree_bgla(self, g, v) -> None:
        """Bigram-lookahead tables for the tree smear (host numpy, as the
        reference's `_setup_tree_bgla`): for every re-entry history h, a
        per-root correction corr(h, r) = lw * (max over the subtree's words
        of bg(h, w) - ugmax(r)), stored as a CSR over (h, r) pairs with an
        explicit successor (`_bgla_ptr/_root/_val`) over the dense backoff
        base lw * bo(h).  `_root_of_word` maps each word to the root its
        tokens entered; `_corr0` is the <s> row for utterance-initial
        entries."""
        lm, W = self.lm, v.n_word
        prevc = g.prev_chan
        if g.exit_base >= 0:
            cur = np.arange(W, dtype=np.int64) + g.exit_base
        else:
            cur = np.asarray(np.maximum(g.exit_tab[:, 0], 0), np.int64)
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
        self.use_bgla = str(self.config["treela"]) == "bg"
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
        lww = np.float32(self.lw)
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
                uk, start = np.unique(keys, return_index=True)
                vmax = np.maximum.reduceat(vals, start)
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
        if self.start_lmwid >= 0:
            corr0[:] = lww * float(lm.ug_bo[self.start_lmwid])
            lo, hi = int(rowptr[self.start_lmwid]), int(
                rowptr[self.start_lmwid + 1])
            if hi > lo:
                np.maximum.at(corr0, bgla_root[lo:hi], bgla_val[lo:hi])
            corr0[~has_word] = 0.0
        self._corr0_np = corr0
        self._buf("_corr0", corr0)

    def _tree_tables(self, g) -> tree_step.Tables:
        """The one-copy tree step's channel tables (`tree_step.Tables`)."""
        root = np.zeros(g.n_chan, np.int32)
        root[self._roots_np] = np.arange(self._n_roots)
        for name, a in (("xs", g.static_xs), ("pc", np.maximum(g.prev_chan, 0)),
                        ("root", root), ("ci_of", g.ci_of)):
            self._buf("_tree_" + name, a, torch.int32)
        return tree_step.Tables(
            self._tree_xs, self._tree_pc, self._has_prev, self._is_entry,
            self._tree_root, self._tree_ci_of, self._la_delta_c,
            self._la_entry_c, tuple(b.contiguous() for b in self._bands()),
            self.prune, self.log_beam, self.log_wbeam, self._pip32)

    def _mpx_tables(self, g) -> mpx_step.Tables:
        """The mpx step's channel tables (`mpx_step.Tables`)."""
        for name, a in (("xs", g.static_xs),
                        ("pc", np.maximum(g.prev_chan, 0)),
                        ("word_of", g.word_of),
                        ("lc_base", g.lc_row.astype(np.int64) * g.n_ci),
                        ("ci_of", g.ci_of), ("lcmap", g.lcmap.reshape(-1))):
            self._buf("_mpx_" + name, a, torch.int32)
        return mpx_step.Tables(
            self._mpx_xs, self._mpx_pc, self._has_prev, self._is_entry,
            self._mpx_word_of, self._mpx_lc_base, self._mpx_ci_of,
            self._mpx_lcmap, tuple(b.contiguous() for b in self._bands()),
            self.prune, self.log_beam, self.log_wbeam, self._pip32)

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

    # ------------------------------------------------------------------
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

    def _expand_block(self, scores_blk: torch.Tensor) -> torch.Tensor:
        """Static senone expansion of a block of frames: [B, K, n_sen] ->
        [K, B, C, S] (every channel's senone row is fixed)."""
        return self._xs_rows(scores_blk.transpose(0, 1))[:, :, self._static_xs]

    def _lm_scores(self, h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
        """P(w | h1, h2) for every search word: [B, E] histories ->
        [B, E, W].  Per-history score rows when the LM has no dense table,
        as the reference's cores do."""
        B, E = h1.shape
        W = self.vocab.n_word
        if self.dlm.tg_dense is None:
            rows = self.dlm.score_rows(h1.reshape(-1), h2.reshape(-1))
            return rows[:, self._lmwid_c].view(B, E, W)
        return self.dlm.score_tg(h1[..., None], h2[..., None], self._lmwid_c,
                                 lanes=E * W)

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

    def _lookahead(self, scores: torch.Tensor, n: int) -> torch.Tensor:
        """The phone-loop lookahead of the first n frames of scores [B, F,
        n_sen] (F >= n): each CI phone's best senone score relative to the
        frame's best, maxed over the frame and the next pl_window - 1 (rows
        past F repeat the last), times pl_weight -> [B, n, n_ci]."""
        cis = torch.where(self._ci_sen_valid, scores[..., self._ci_sen],
                          NEG_INF).amax(-1)                       # [B, F, n_ci]
        rel = cis - cis.amax(-1, keepdim=True)
        F = rel.shape[1]
        last = rel[:, -1:]
        shifts = [torch.cat([rel[:, dt: dt + n],
                             last.expand(-1, max(0, dt + n - F), -1)], 1)
                  for dt in range(self.pl_window)]
        return _f32(self.pl_weight) * torch.stack(shifts).amax(0)

    @staticmethod
    def _write_tape(tape_t, ok, wsel, vals, pe, h2, h1, slot_rc) -> None:
        """The frame's tape rows: `tape_t` holds views [B, E(, Vr)] of the
        block's tape at this frame's row (`_block`)."""
        rows = (torch.where(ok, wsel, -1), torch.where(ok, vals, NEG_INF),
                pe, h2, h1, torch.where(ok[..., None], slot_rc, NEG_INF))
        for a, r in zip(tape_t, rows):
            a.copy_(r)

    def _read_hist(self, ht, pe):
        """Histories (h2, h1) of the tape slots `pe` [B, L] from the
        side-table ht [B, Tpad*E, 2]; slot -1 is the initial (<s>, -1)."""
        ph = ht.gather(1, pe.clamp_min(0)[..., None].expand(-1, -1, 2))
        return (torch.where(pe < 0, self.start_lmwid, ph[..., 0]),
                torch.where(pe < 0, -1, ph[..., 1]))

    def _record_hist(self, ht, t, valid_t, h2, h1) -> None:
        """Frame t's histories into rows t*E .. t*E+E-1 of ht."""
        ht.index_copy_(1, t * self.E + self._ar_E, torch.where(
            valid_t[:, None, None], torch.stack([h2, h1], -1), -1))

    # ------------------------------------------------------------------
    # The mpx frame step (multiplexed left contexts).
    def _init_hmmc(self, B: int):
        """Initial HMM carry: all channels silent except the static <s>
        entries; word-history payloads (hw2, hw1) start at (<s>, -1).
        alpha [B, C, S] f32 and the int32 payloads (tape slot, senone-
        sequence row, hw2, hw1) [B, C, S]."""
        g = self.graph
        C, S = g.n_chan, g.n_emit_state
        dev = self.device

        def full(shape, val):
            return torch.full(shape, val, dtype=torch.int32, device=dev)

        alpha = torch.full((C, S), NEG_INF, dtype=torch.float32, device=dev)
        xsr = self._mpx_xs[:, None].expand(C, S)
        alpha, pays = hmm_enter(
            alpha, (full((C, S), -1), xsr, full((C, S), self.start_lmwid),
                    full((C, S), -1)),
            self._entc0,
            (full((C,), -1), self._entxs0, full((C,), self.start_lmwid),
             full((C,), -1)))
        return tuple(a[None].expand(B, C, S).contiguous()
                     for a in (alpha,) + pays)

    def _step_mpx(self, hmmc, scores_t, t, valid_t, tape, la_t=None):
        """One frame of the mpx core for the whole batch (frame t, a 0-d
        int64 tensor, as in every step).  Writes the frame's tape rows into
        `tape` (views of one row, `_write_tape`).  The channel update is
        `mpx_step`'s (its kernels on the card): the exits before the
        readout, the new carry after it, written into the carry's arrays,
        which are returned."""
        B = hmmc[0].shape[0]
        E = self.E
        W = self.vocab.n_word
        Vr = self.graph.n_rcvar
        neg = NEG_INF
        tab = self._mpx_tab
        rows = self._xs_rows(scores_t)                            # [B, n_xs, S]
        st = mpx_step.step_exits(hmmc, rows, tab)

        # ---- word exits: per-variant readout [B, W, Vr], word-exit beam ----
        exv = torch.where(self._exit_valid, st.ex[:, self._exit_tab_c], neg)
        if self.prune:
            exv = torch.where(exv > st.best[:, None, None] + self.log_wbeam,
                              exv, neg)
        wex = exv.amax(2)                                         # [B, W]
        vwin = exv.argmax(2)
        sel = torch.gather(self._exit_tab_c.expand(B, W, Vr), 2,
                           vwin[..., None])[..., 0]               # [B, W]
        wexh3 = torch.gather(st.exh3, 1, sel[..., None].expand(B, W, 3))

        # ---- top-E word exits -> tape slots ----
        vals, wsel = topk2(wex, E)                                # [B, E]
        ok = (vals > neg * 0.5) & valid_t[:, None]
        slot_rc = torch.gather(exv, 1, wsel[..., None].expand(B, E, Vr))
        pe, prev_h2, prev_h1 = torch.gather(
            wexh3, 1, wsel[..., None].expand(B, E, 3)).long().unbind(-1)
        fil = self._is_filler[wsel]
        h2 = torch.where(fil, prev_h2, self._lmwid[wsel])
        h1 = torch.where(fil, prev_h1, prev_h2)
        self._write_tape(tape, ok, wsel, vals, pe, h2, h1, slot_rc)

        # ---- word entries (take effect next frame): score and payloads
        # (tape slot, left-context CI phone, h2, h1) a word ----
        ent_w, ebp_w, estar = self._entries(t, ok, wsel, h1, h2, slot_rc)
        eh = torch.gather(torch.stack([self._lastci[wsel], h2, h1], -1), 1,
                          estar[..., None].expand(B, W, 3))
        ent_pay = torch.cat([ebp_w[..., None], eh], -1).to(torch.int32)
        return mpx_step.prune_enter(hmmc, rows, st, ent_w, ent_pay, la_t,
                                    valid_t, tab)

    def _entries(self, t, ok, wsel, h1, h2, slot_rc):
        """Single best cross-word entry per word (word_transition
        semantics): over this frame's E exit slots, exit score (the exit's
        rc variant serving the word's first CI phone) + LM or filler
        bonus.  Returns (entry score [B, W], entry bp slot, best slot)."""
        E = self.E
        lmw = self._lm_scores(h1, h2)                             # [B, E, W]
        bonus = torch.where(self._is_filler, self._fil_pen,
                            self._lw32 * lmw + self._wip32)
        if self.graph.n_rcvar == 1:
            ac = slot_rc                                          # [B, E, 1]
        else:
            ac = torch.gather(slot_rc, 2,
                              self._rssid[wsel[..., None], self._firstci])
        cand = torch.where(ok[..., None], ac + bonus, NEG_INF)    # [B, E, W]
        ent_w = cand.amax(1)                                      # [B, W]
        estar = cand.argmax(1)
        ebp_w = torch.where(ent_w > NEG_INF * 0.5, t * E + estar, -1)
        return ent_w, ebp_w, estar

    # ------------------------------------------------------------------
    def _bands(self):
        """The transition bands of every channel, `hmm_step`'s form."""
        return (self._band_d0, self._band_d1, self._band_d2,
                self._band_elast, self._band_eprev)

    def _init_static(self, B: int, Tpad: int):
        """Initial carry of the static and tree steps: (alpha, bp payload
        [B, C, S], history side-table [B, Tpad*E, 2]) and, for the tree
        with bigram lookahead, the entry-correction side-table [B, Tpad*R].
        The static payload is the tape slot (-1 = the initial (<s>, -1)
        history); the tree's is an 8-bit entry age (255 = initial).  N > 1
        tree copies (`nlextree`) ride an axis after the batch, alpha and
        payload [B, N, C, S], with the tape slot as their payload and the
        corrections [B, Tpad*N*R], row (t*N + n)*R."""
        g = self.graph
        C, S = g.n_chan, g.n_emit_state
        N = self.nlextree
        dev = self.device
        alpha = torch.full((C, S), NEG_INF, dtype=torch.float32, device=dev)
        alpha, _ = hmm_enter(alpha, (), self._entc0, ())
        shape = (B, C, S) if N == 1 else (B, N, C, S)
        if N > 1:
            # Copy 0 holds the initial entries; the others start empty.
            alpha = torch.cat([alpha[None], alpha.new_full((N - 1, C, S),
                                                           NEG_INF)])
        # Every token, entered or not, starts from the initial history.
        hist = (torch.full(shape, 255, dtype=torch.uint8, device=dev)
                if self._tree and N == 1 else
                torch.full(shape, -1, dtype=torch.int64, device=dev))
        carry = (alpha.expand(shape).contiguous(), hist,
                 torch.full((B, Tpad * self.E, 2), -1, dtype=torch.int64,
                            device=dev))
        if self._tree:
            R = self._n_roots if self.use_bgla else 1
            carry += (torch.zeros((B, Tpad * N * R), dtype=torch.float32,
                                  device=dev),)
        return carry

    def _step_static(self, carry, sen_t, t, valid_t, tape, la_t=None):
        """One frame of the static core (composite lc, flat lexicon): the
        reference's `_make_core_static` (any n_rcvar) and
        `_make_core_static_batched` (n_rcvar == 1) in one step."""
        alpha0, hist0, ht = carry
        B = alpha0.shape[0]
        E, W, Vr = self.E, self.vocab.n_word, self.graph.n_rcvar
        neg = NEG_INF
        alpha, (hist,), ex, (exh,) = hmm_step(alpha0, (hist0,), sen_t,
                                               self._bands())
        alpha, ex = self._prune(alpha, ex, la_t)

        # ---- word exits ----
        if Vr == 1:
            wex = ex[:, self._exit_col]                           # [B, W]
            wbp = exh[:, self._exit_col]
        else:
            exv = torch.where(self._exit_valid, ex[:, self._exit_tab_c], neg)
            wex = exv.amax(2)
            vwin = exv.argmax(2)
            sel = torch.gather(self._exit_tab_c.expand(B, W, Vr), 2,
                               vwin[..., None])[..., 0]
            wbp = torch.gather(exh, 1, sel)
        vals, wsel = topk2(wex, E)                                # [B, E]
        slot_rc = (vals[..., None] if Vr == 1 else
                   torch.gather(exv, 1, wsel[..., None].expand(B, E, Vr)))
        ok = (vals > neg * 0.5) & valid_t[:, None]
        pe = torch.gather(wbp, 1, wsel)
        prev_h2, prev_h1 = self._read_hist(ht, pe)
        fil = self._is_filler[wsel]
        h2 = torch.where(fil, prev_h2, self._lmwid[wsel])
        h1 = torch.where(fil, prev_h1, prev_h2)
        self._write_tape(tape, ok, wsel, vals, pe, h2, h1, slot_rc)

        # ---- word entries ----
        ent_w, ebp_w, _ = self._entries(t, ok, wsel, h1, h2, slot_rc)
        self._record_hist(ht, t, valid_t, h2, h1)

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

    def _tree_exits(self, t, valid_t, tape, wex, wbp, ht, ct,
                    nsel=None):
        """The tree steps' exit readout, from each word's best exit `wex`
        [B, W] and its token's payload `wbp`: the shortlist on the smeared
        score, the exact trigram in place of the smeared unigram, the bigram
        correction the token received at entry cancelled, the top E to the
        tape and the history side-table.  One copy (`nsel` None): the
        payload is the entry age; N copies: the tape slot, and `nsel` [B, W]
        the copy each exit came from (the reference's `use_age = N == 1`).
        Returns the slots' (vals, ok, h2, h1) [B, E]."""
        E, W = self.E, self.vocab.n_word
        R = self._n_roots
        E2 = min(4 * E, W)
        neg = NEG_INF
        v2, wsel2 = topk2(wex + self._psel_bonus, E2)             # [B, E2]
        okp = (v2 > neg * 0.5) & valid_t[:, None]
        p2 = torch.gather(wbp, 1, wsel2)
        if nsel is None:
            p2 = p2.long()
            pe2 = torch.where(p2 >= 255, -1, (t - p2) * E)
        else:
            pe2 = p2
        ph2, ph1 = self._read_hist(ht, pe2)
        wl2 = self._lmwid[wsel2]
        fil2 = self._is_filler[wsel2]
        own = self.dlm.score_tg(ph1, ph2, wl2.clamp_min(0), lanes=E2)
        if self.use_bgla:
            rw2 = self._root_of_word[wsel2]                       # [B, E2]
            row = pe2.clamp_min(0) // E
            if nsel is not None:
                row = row * self.nlextree + torch.gather(nsel, 1, wsel2)
            cu = torch.gather(ct, 1, row * R + rw2)
            cu = torch.where(pe2 < 0, self._corr0[rw2], cu)
        else:
            cu = 0.0
        resc = torch.where(fil2, v2 - cu,
                           v2 - cu - self._la_word_lw[wsel2]
                           + self._lw32 * own)
        resc = torch.where(okp, resc, neg)

        # ---- top-E rescored exits -> tape slots ----
        vals, sel = _top_k(resc, E)                               # [B, E]
        wsel = torch.gather(wsel2, 1, sel)
        ok = vals > neg * 0.5
        pe = torch.gather(pe2, 1, sel)
        prev_h2 = torch.gather(ph2, 1, sel)
        prev_h1 = torch.gather(ph1, 1, sel)
        fil = self._is_filler[wsel]
        h2 = torch.where(fil, prev_h2, self._lmwid[wsel])
        h1 = torch.where(fil, prev_h1, prev_h2)
        self._write_tape(tape, ok, wsel, vals, pe, h2, h1, vals[..., None])
        self._record_hist(ht, t, valid_t, h2, h1)
        return vals, ok, h2, h1

    def _exit_cols(self, ex, exh):
        """Every word's exit channel of ex/exh [..., C] -> [..., W]."""
        xb, W = self.graph.exit_base, self.vocab.n_word
        if xb >= 0:
            return ex[..., xb: xb + W], exh[..., xb: xb + W]
        return ex[..., self._exit_col], exh[..., self._exit_col]

    def _step_tree(self, carry, rows_t, t, valid_t, tape, la_t=None):
        """One frame of the prefix-tree core with one tree copy: the
        reference's `_make_core_tree` (N = 1) and `_make_core_tree_batched`
        in one step, from the frame's senone-sequence rows rows_t [B,
        n_xs, S].  Tokens carry an 8-bit entry age (255 = the initial <s>
        entry; the increment saturates at 254 + 1); the re-entry always
        takes the frame's slot 0, so a token's tape slot is (t - age)*E.
        The channel update is `tree_step`'s (its kernels on the card), and
        it writes the new alpha and age into the carry's."""
        alpha0, hist0, ht, ct = carry
        R = self._n_roots
        neg = NEG_INF
        tab = self._tree_tab
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

    def _step_tree_copies(self, carry, sen_t, t, valid_t, tape,
                          la_t=None):
        """One frame of the tree core with N > 1 copies (the reference's
        `_make_core_tree`, N > 1): the copies' exits merge per word (best
        copy, first on ties), the shortlist and the tape are the one-copy
        step's, and copy n re-enters from the n-th best tape slot whose
        (h2, h1) history no earlier copy took.  Tokens carry their tape
        slot (-1 = the initial history)."""
        alpha0, hist0, ht, ct = carry
        B, N = alpha0.shape[0], alpha0.shape[1]
        E, R = self.E, self._n_roots
        neg = NEG_INF
        alpha, (hist,), ex, (exh,) = hmm_step(alpha0, (hist0,), sen_t[:, None],
                                               self._bands())
        alpha, ex = self._prune(alpha, ex, la_t)

        # ---- exit readout: best copy per word ----
        wexn, whn = self._exit_cols(ex, exh)                      # [B, N, W]
        nsel = _argmax_first(wexn, 1)                            # [B, W]
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

    # ------------------------------------------------------------------
    def _block_len(self, B: int, n: int) -> int:
        """Frames a block of a scan of n frames at batch B: the largest
        divisor of gcd(n, FRAME_BUCKET) whose senone scores fit in
        EXPAND_BLOCK_BYTES: for the static step and the tree copies
        expanded to every channel, for the one-copy tree step its
        senone-sequence rows (each with the composite rows' members).  A
        batch (n a multiple of FRAME_BUCKET) and a stream's chunk (n =
        CHUNK) so run whole blocks of one length: one captured graph a
        shape."""
        base = math.gcd(n, self.FRAME_BUCKET)
        cap = base
        if self._fast:
            g = self.graph
            rows = g.n_xs if self._tree and self.nlextree == 1 else g.n_chan
            per_frame = (rows * g.n_emit_state + g.comp_mem.size) * 4 * B
            cap = min(cap, EXPAND_BLOCK_BYTES // per_frame)
        return max(d for d in range(1, max(1, cap) + 1) if base % d == 0)

    def _side_frames(self, Tpad: int) -> int:
        """Frames the static and tree steps' side-tables hold for a batch
        of Tpad frames: FRAME_BUCKET times a power of two, so that batches
        of nearby lengths share a captured graph.  Rows past Tpad are never
        read."""
        n = -(-Tpad // self.FRAME_BUCKET)
        return self.FRAME_BUCKET << max(0, (n - 1).bit_length())

    def _block(self, carry, scores: torch.Tensor, t: torch.Tensor,
               valid: torch.Tensor, tape, la: Optional[torch.Tensor] = None):
        """One block: frames t .. t+K-1 of the senone scores [B, K, n_sen]
        (valid [B, K]; the lookahead la [B, K, n_ci] or None) through the
        graph's frame step, the frame index t a 0-d int64 tensor advanced
        on the device; writes row k of the block's tape [B, K, E(, Vr)]
        for frame t+k and returns the carry.  The static step and the tree
        copies expand the block's senones first, the one-copy tree step
        takes the block's senone-sequence rows (both elementwise, so the
        block changes no result).  Nothing here reads a device value on
        the host, so the block can be captured."""
        if not self._fast:
            step, sen = self._step_mpx, scores.unbind(1)
        elif self._tree and self.nlextree == 1:
            step = self._step_tree
            sen = self._xs_rows(scores.transpose(0, 1).contiguous())
        else:
            step = (self._step_static if not self._tree else
                    self._step_tree_copies)
            sen = self._expand_block(scores)
        for k in range(scores.shape[1]):
            carry = step(carry, sen[k], t, valid[:, k],
                         tuple(a[:, k] for a in tape),
                         None if la is None else la[:, k])
            t = t + 1
        return carry

    def _scan(self, carry, scores: torch.Tensor, t0: int,
              valid: torch.Tensor, tape, la: Optional[torch.Tensor] = None):
        """Frames t0 .. t0+n-1 of the senone scores [B, n, n_sen] (valid
        [B, n]; the phone-loop lookahead la [B, n, n_ci] or None) block by
        block (`_block_len`); writes their rows t0 .. t0+n-1 of the tape
        and returns the carry.  On the card each block is a replay of a
        captured graph (`graphs.BlockRunner`), keyed by batch and block
        length, and for the static and tree steps the side-tables' size;
        a last block shorter than `_block_len` (only where the caller
        chose the block length) replays a graph of its own length."""
        B, n = scores.shape[0], scores.shape[1]
        return self._runner.scan(
            self._run_block, carry, (scores, valid, la), tape, t0,
            self._block_len(B, n), self._graphs and scores.is_cuda)

    def _run_block(self, carry, inputs, t, rows):
        """`_block` as the runner calls it."""
        scores, valid, la = inputs
        return self._block(carry, scores, t, valid, rows, la)

    # The runner's counters (captures, capture_s, replays); its graph
    # cache and pool under the names the tests and chip_smoke.py read.
    graph_stats = property(lambda self: self._runner.stats)
    _graph_cache = property(lambda self: self._runner.cache)
    _graph_pool = property(lambda self: self._runner.pool)
    # Read by portbench/drive.py, until its reader moves to graph_stats.
    _graph_stats = property(lambda self: self._runner.stats)

    def _tape(self, B: int, frames: int, fill: bool = False) -> tuple:
        """Tape arrays (tw, tsc, tprev, th2, th1 [B, frames, E]; trc [B,
        frames, E, Vr]); with `fill`, every slot reads as no word (a
        stream's tape, read before all of it is written)."""
        E, Vr, dev = self.E, self.graph.n_rcvar, self.device
        specs = ((torch.int32, -1), (torch.float32, NEG_INF),
                 (torch.int32, -1), (torch.int32, -1), (torch.int32, -1),
                 (torch.float32, NEG_INF))
        out = []
        for i, (dt, v) in enumerate(specs):
            shape = (B, frames, E) + ((Vr,) if i == 5 else ())
            out.append(torch.full(shape, v, dtype=dt, device=dev) if fill
                       else torch.empty(shape, dtype=dt, device=dev))
        return tuple(out)

    def device_decode(self, feats: torch.Tensor, valid: torch.Tensor):
        """Padded feats [B, Tpad, D] + valid mask [B, Tpad] -> backpointer
        tapes (tw, tsc, tprev, th2, th1 [B, Tpad*E]; trc [B, Tpad*E, Vr]),
        slot = t*E + e."""
        with span("ngram.score"):
            scores = self.scorer.score(feats)
        return self._viterbi(scores, valid)

    def _viterbi(self, scores: torch.Tensor, valid: torch.Tensor):
        """`device_decode` from the senone scores [B, Tpad, n_sen]: the
        lookahead, then the frame loop; no host read."""
        B, Tpad = scores.shape[0], scores.shape[1]
        E, Vr = self.E, self.graph.n_rcvar
        la = None
        if self.pl_window:
            with span("ngram.lookahead"):
                la = self._lookahead(scores, Tpad)
        tape = self._tape(B, Tpad)
        carry = (self._init_static(B, self._side_frames(Tpad)) if self._fast
                 else self._init_hmmc(B))
        self._scan(carry, scores, 0, valid, tape, la)
        n = Tpad * E
        return tuple(a.view(B, n) for a in tape[:5]) + (
            tape[5].view(B, n, Vr),)

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
                               torch.full_like(th1_f, self.finish_lmwid),
                               lanes=E)
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
            if it % 8 == 0:
                self._host_reads.increment()
                if not bool((slot >= 0).any()):
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
    def _pad(self, arrays) -> tuple:
        """List of [T_i, n] -> ([B, Tpad, n] tensor, T [B] tensor, Ts)
        with Tpad a multiple of FRAME_BUCKET (the reference's tape shape)."""
        with span("ngram.pad"):
            Ts = [int(a.shape[0]) for a in arrays]
            Tpad = (-(-max(max(Ts), 1) // self.FRAME_BUCKET)
                    * self.FRAME_BUCKET)
            buf = np.zeros((len(arrays), Tpad, int(arrays[0].shape[1])),
                           np.float32)
            for i, a in enumerate(arrays):
                buf[i, : Ts[i]] = a
            return (torch.as_tensor(buf, device=self.device),
                    torch.as_tensor(Ts, dtype=torch.int64,
                                    device=self.device), Ts)

    def _run(self, feats: torch.Tensor, T: torch.Tensor, Ts,
             bestpath: Optional[bool]) -> List[Hypothesis]:
        valid = (torch.arange(feats.shape[1], device=self.device)[None, :]
                 < T[:, None])
        tapes = self.device_decode(feats, valid)
        with span("ngram.backtrace"):
            chase = self.device_backtrace(tapes, T)
            self._host_reads.increment()
            chase = chase.cpu().numpy()
        self._last = None
        self._last_batch = (tapes, Ts, len(Ts) - 1)
        self._host_tapes = None
        bp = bool(self.config["bestpath"]) if bestpath is None else bestpath
        with span("ngram.hyps"):
            out = [self._hyp_from_chase(c) for c in chase]
            return self._rescore_batch(out) if bp else out

    def decode(self, feats: np.ndarray,
               bestpath: Optional[bool] = None) -> Hypothesis:
        """feats [T, D] -> best hypothesis (a batch of one).  With
        bestpath, the Viterbi result is rescored over the word lattice at
        -bestpathlw.  An empty utterance gives the empty hypothesis with
        score -inf."""
        if int(feats.shape[0]) == 0:
            return Hypothesis([], float("-inf"), [])
        return self.decode_batch([feats], bestpath)[0]

    @torch.inference_mode()
    def decode_batch(self, feats_list, bestpath: Optional[bool] = None
                     ) -> List[Hypothesis]:
        """Batched decode: all utterances padded to one frame bucket and
        decoded together.  Returns one Hypothesis per utterance, rescored
        over its lattice when bestpath is on (argument, else -bestpath)."""
        if not feats_list:
            return []
        return self._run(*self._pad(feats_list), bestpath)

    @torch.inference_mode()
    def decode_batch_cep(self, cep_list, fp, bestpath: Optional[bool] = None
                         ) -> List[Hypothesis]:
        """Cepstra [T_i, ncep] -> features (`fp`, a FeatPipeline) ->
        decode -> backtrace, all on the device."""
        if not cep_list:
            return []
        c, T, Ts = self._pad(cep_list)
        with span("ngram.features"):
            feats = fp._padded_kernel(c, T, True)
        return self._run(feats, T, Ts, bestpath)

    # ------------------------------------------------------------------
    # Streaming decode: the carry and the tape stay on the device between
    # pushes, so audio is decoded as it arrives, with partial hypotheses
    # at any point (ps_process_raw's incremental loop, pocketsphinx.c:
    # 699-719, and the gst plugin's partial results).
    CHUNK = 50

    @torch.inference_mode()
    def stream_start(self, max_frames: int = 3000) -> dict:
        """Begin a streaming utterance; returns its state (the carry and
        the tape on the device).  `max_frames` sizes the first tape; it
        doubles when the audio runs past it (acmod_set_grow semantics)."""
        carry = (self._init_static(1, max_frames) if self._fast
                 else self._init_hmmc(1))
        return {"carry": carry, "tape": self._tape(1, max_frames, fill=True), "t": 0,
                "max_frames": max_frames,
                "pending": np.zeros((0, 0), np.float32)}

    def _ensure_tape(self, state: dict, need_frames: int) -> None:
        """Double the tape, and the static and tree steps' per-frame
        side-tables (histories [1, F*E, 2]; the tree's entry corrections
        [1, F*R]) with it, until `need_frames` more frames fit."""
        while state["t"] + need_frames > state["max_frames"]:
            F = state["max_frames"]
            state["tape"] = tuple(torch.cat([a, b], 1) for a, b in zip(
                state["tape"], self._tape(1, F, fill=True)))
            if self._fast:
                alpha, hist, ht, *ct = state["carry"]
                ht = torch.cat([ht, torch.full_like(ht, -1)], 1)
                ct = [torch.cat([c, torch.zeros_like(c)], 1) for c in ct]
                state["carry"] = (alpha, hist, ht, *ct)
            state["max_frames"] = 2 * F

    def _stream_chunk(self, state: dict, block: np.ndarray, take: int
                      ) -> None:
        """Score CHUNK + pl_window frames [CHUNK + W, D] of features (of
        the first CHUNK, the first `take` real, the rest padding that
        leaves the carry as it was; the last W only the lookahead's) and
        run the first CHUNK through the frame step.  The tape grows to
        hold the whole chunk, padded rows included, which the step
        writes."""
        self._ensure_tape(state, self.CHUNK)
        x = torch.as_tensor(block[None]).to(self.device)
        scores = self.scorer.score(x)                     # [1, CHUNK + W, S]
        la = (self._lookahead(scores, self.CHUNK) if self.pl_window
              else None)
        valid = (torch.arange(self.CHUNK, device=self.device) < take)[None]
        state["carry"] = self._scan(state["carry"], scores[:, : self.CHUNK],
                                    state["t"], valid, state["tape"], la)
        state["t"] += take

    @torch.inference_mode()
    def stream_push(self, state: dict, feats: np.ndarray) -> dict:
        """Feed feature frames; whole CHUNKs are decoded on the device, the
        remainder is buffered until the next push or stream_end.  With
        pl_window W, the last W frames are held back too, so that every
        decoded frame sees its whole lookahead window."""
        feats = np.asarray(feats, np.float32)
        W = self.pl_window
        pend = state["pending"]
        buf = feats if pend.size == 0 else np.concatenate([pend, feats])
        k = max(buf.shape[0] - W, 0) // self.CHUNK
        for i in range(k):
            self._stream_chunk(
                state, buf[i * self.CHUNK: (i + 1) * self.CHUNK + W],
                self.CHUNK)
        state["pending"] = buf[k * self.CHUNK:]
        return state

    def _stream_flush(self, state: dict) -> int:
        """Decode the buffered remainder, padded by repeating its chunk's
        last frame and masked (the reference's flush: a chunk's lookahead
        takes the frames that follow it where there are any).  Returns the
        number of real frames decoded."""
        pend = state["pending"]
        need = self.CHUNK + self.pl_window
        while pend.shape[0]:
            take = min(pend.shape[0], self.CHUNK)
            rest = pend[take:]
            blk = np.repeat(pend[take - 1: take], need, axis=0)
            blk[:take] = pend[:take]
            avail = min(rest.shape[0], need - take)
            blk[take: take + avail] = rest[:avail]
            self._stream_chunk(state, blk, take)
            pend = rest
        state["pending"] = np.zeros((0, 0), np.float32)
        return state["t"]

    def _stream_host_tape(self, state: dict) -> tuple:
        """The first t frames of the stream's tape on the host, flat
        [t*E(, Vr)] as the readout indexes it: one copy per array, of the
        decoded frames only."""
        t = state["t"]
        return tuple(a[0, :t].cpu().numpy().reshape(
            (t * self.E,) + tuple(a.shape[3:])) for a in state["tape"])

    @torch.inference_mode()
    def stream_partial(self, state: dict) -> Hypothesis:
        """Best hypothesis so far (partial result); does not disturb the
        stream.  The buffered remainder is not included."""
        if state["t"] == 0:
            return Hypothesis([], float("-inf"), [])
        return self._backtrace(*self._stream_host_tape(state), state["t"])

    @torch.inference_mode()
    def stream_end(self, state: dict) -> Hypothesis:
        """Finish the stream: flush the remainder and return the final
        hypothesis; the lattice is then available from get_lattice()."""
        T = self._stream_flush(state)
        self._last = self._stream_host_tape(state) + (T,)
        return self._backtrace(*self._last)

    # ------------------------------------------------------------------
    # The host results layer: lattices and bestpath rescoring.
    def _latbeam_ln(self) -> float:
        """latbeam (linear prob) -> natural-log beam width for the native
        link pruner (0 = exact)."""
        lb = float(self.config["latbeam"])
        return -math.log(lb) if lb > 0.0 else 0.0

    def _rescore_batch(self, hyps: List[Hypothesis]) -> List[Hypothesis]:
        """Bestpath-rescore every utterance of the most recent batch: the
        lattice built from its host tape, then the native trigram DP, with
        utterances rescored in parallel threads (the native call releases
        the GIL).  An utterance keeps its Viterbi result where the lattice
        gives no path."""
        htapes = self._batch_host_tapes()
        Ts = self._last_batch[1]
        B = len(Ts)
        bplw = float(self.config["bestpathlw"])
        bw = self._latbeam_ln()
        lats = [self._lattice_from_tape(tuple(a[i] for a in htapes)
                                        + (Ts[i],))
                if hyps[i].segments else None for i in range(B)]

        def _one(i):
            if lats[i] is None:
                return hyps[i]
            h2 = lats[i].bestpath(lw=bplw, start_lmwid=self.start_lmwid,
                                  prune_beam=bw)
            return h2 if h2.segments else hyps[i]

        with ThreadPoolExecutor(max_workers=min(8, max(B, 1))) as ex:
            return list(ex.map(_one, range(B)))

    def _batch_host_tapes(self) -> tuple:
        """The last batch's tapes on the host, [B, Tpad*E(, Vr)]: one copy
        per array, made once per batch."""
        if self._host_tapes is None:
            tapes = self._last_batch[0]
            self._host_reads.increment(len(tapes))
            self._host_tapes = tuple(a.cpu().numpy() for a in tapes)
        return self._host_tapes

    def select_utt(self, i: int) -> None:
        """Point get_lattice at utterance `i` of the most recent batch."""
        htapes = self._batch_host_tapes()
        Ts = self._last_batch[1]
        self._last = tuple(a[i] for a in htapes) + (Ts[i],)

    def _slot_rc_score(self, trc_row: np.ndarray, k: int, ci: int) -> float:
        """Exit score of word k's rc variant serving CI phone ci."""
        return float(trc_row[int(self.graph.rssid[k, ci])])

    def _tg_batch(self, h1: np.ndarray, h2: np.ndarray,
                  w: np.ndarray) -> np.ndarray:
        """Batched trigram scores (the native lm3g core when built)."""
        if self._lm_arrays is None:
            self._lm_arrays = native.LmArrays(self.lm)
        out = native.tg_score_batch(self._lm_arrays, h1, h2, w)
        if out is not None:
            return out.astype(np.float64)
        return np.asarray([self.lm.tg_score(int(a), int(b), int(c))
                           for a, b, c in zip(h1, h2, w)], np.float64)

    def _lattice_from_tape(self, last) -> Lattice:
        """Lattice construction from one utterance's host tape arrays
        (tw, tsc, tprev, th2, th1 [n_slots]; trc [n_slots, Vr]; T): every
        live slot is a node.  The rc variant of a predecessor is read per
        slot, rssid[pk, firstci[k]], with no [W, W] table."""
        tw, tsc, tprev, th2, th1, trc = (np.asarray(a) for a in last[:6])
        T = last[6]
        g, v, E = self.graph, self.vocab, self.E
        n_slots = T * E
        slots = np.nonzero(tw[:n_slots] >= 0)[0]
        k = tw[slots].astype(np.int64)
        t = slots // E
        prev = tprev[slots]
        has_prev = prev >= 0
        pidx = np.maximum(prev, 0)
        sf = np.where(has_prev, pidx // E + 1, 0)
        # Entry score = predecessor exit (rc variant serving this word's
        # first CI phone) + LM/filler term: the score the decoder entered
        # this instance with (word_transition semantics).
        pk = tw[pidx].astype(np.int64)
        rcv = g.rssid[pk, g.firstci[k]].astype(np.int64)
        base = trc[pidx, rcv]
        base = np.where(base <= float(NEG_INF) * 0.5, tsc[pidx], base)
        fil = v.is_filler[k]
        lmterm = np.where(fil, self._fil_pen_np[k], 0.0).astype(np.float64)
        nz = has_prev & ~fil
        if nz.any():
            lmterm[nz] = (self.lw * self._tg_batch(
                th1[pidx[nz]], th2[pidx[nz]], v.lmwid[k[nz]])
                + self.log_wip)
        entry = np.where(has_prev, base + lmterm, self._ent0[k])
        # Per-instance rc readout decompressed to per-CI columns.
        rc_all = np.take_along_axis(
            trc[slots], g.rssid[k].astype(np.int64), axis=1)
        vit = tsc[slots]
        fp = self._fil_pen_np[k]
        lmw = v.lmwid[k]
        fin = v.is_finish[k]
        nodes = [
            LatNode(id=i, word=v.word_str[ki], kidx=int(ki),
                    lmwid=int(lw_), is_filler=bool(fi), fil_pen=float(fpi),
                    sf=int(sfi), ef=int(ti), vit_score=float(vi),
                    rc_score=rc_all[i], entry_score=float(en),
                    is_finish=bool(fni))
            for i, (ki, lw_, fi, fpi, sfi, ti, vi, en, fni) in enumerate(
                zip(k, lmw, fil, fp, sf, t, vit, entry, fin))
        ]
        return Lattice(nodes, g.firstci, g.lastci, self.lm, self.lw,
                       self.log_wip, self.sil_ci, self.finish_lmwid, T)

    def get_lattice(self) -> Lattice:
        """Word lattice for the most recent utterance (ps_get_lattice): the
        stream just ended, or the last utterance of the last batch (see
        `select_utt`)."""
        if self._last is None:
            if self._last_batch is None:
                raise RuntimeError("no utterance decoded yet")
            self.select_utt(self._last_batch[2])
        return self._lattice_from_tape(self._last)

    # ------------------------------------------------------------------
    # The host readout (partial and final hypotheses of a stream).
    def _final_slot(self, tw, tsc, th2, th1, trc, T):
        """Best utterance-final tape slot at the last frame with exits,
        scored with silence right context + P(</s> | h)
        (ngram_search_finish semantics)."""
        E, v = self.E, self.vocab
        for t in range(T - 1, -1, -1):
            sl = slice(t * E, t * E + E)
            ws = tw[sl]
            if not (ws >= 0).any():
                continue
            best, best_s = -1, -np.inf
            for e in range(E):
                if ws[e] < 0:
                    continue
                s = self._slot_rc_score(trc[sl][e], int(ws[e]), self.sil_ci)
                if not np.isfinite(s) or s <= float(NEG_INF) * 0.5:
                    s = tsc[sl][e]
                if not v.is_finish[ws[e]]:
                    s += self.lw * self.lm.tg_score(
                        int(th1[sl][e]), int(th2[sl][e]), self.finish_lmwid)
                if s > best_s:
                    best, best_s = t * E + e, float(s)
            if best >= 0:
                return best, best_s
        return -1, float("-inf")

    def _backtrace(self, tw, tsc, tprev, th2, th1, trc, T) -> Hypothesis:
        slot, score = self._final_slot(tw, tsc, th2, th1, trc, T)
        if slot < 0:
            return Hypothesis([], float("-inf"), [])
        v, E = self.vocab, self.E
        segs: List[Segment] = []
        while slot >= 0:
            k = int(tw[slot])
            t = slot // E
            prev = int(tprev[slot])
            start = prev // E + 1 if prev >= 0 else 0
            segs.append(Segment(v.word_str[k], start, t, float(tsc[slot])))
            slot = prev
        segs.reverse()
        words = []
        for s in segs:
            wid = self.dict.wordid(s.word)
            if wid < 0 or not self.dict.is_filler(wid):
                words.append(self.dict.base_str(wid) if wid >= 0 else s.word)
        return Hypothesis(words, score, segs)
