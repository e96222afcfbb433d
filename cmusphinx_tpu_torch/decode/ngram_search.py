"""N-gram (trigram) decoder over a senone scorer: flat and prefix-tree
lexicons with exact or composite cross-word contexts.

Port of `cmusphinx_tpu/decode/ngram_search.py`: the search, its cores
(`ngram_steps.py`: one frame step a kind, which `_pick_step` alone
chooses, and their shared word-exit readout), the phone-loop lookahead
`pl_window`, the device decode and backtrace, the batch and streaming
decodes, and the host results layer (the stream's readout, lattices and
bestpath rescoring).  See the reference's docstrings for the search's
semantics.

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
- The frame scan runs in blocks of frames (`_block`), the frame index a
  0-d tensor advanced on the device.  On the card each block is a
  captured CUDA graph (`graphs.BlockRunner`), captured once per shape and
  replayed block after block: the counterpart of the reference's
  `jit`-compiled `lax.scan`.  On the CPU the same block runs eagerly.
- Gathers are plain gathers; the reference's one-hot matmul gathers, its
  flat state-major layout and its 128-lane root padding were TPU devices.
- Top-k is a stable descending sort, which keeps `jax.lax.top_k`'s
  lowest-index-first order on ties; `topk2` keeps the reference's
  two-stage tie rule.  The tape is the reference's, slot for slot.

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
from ..ops import lm_entries, mpx_step, tree_step
from ..ops.hmm import NEG_INF, hmm_bands
from ..utils import native
from ..utils.config import Arg, Config
from ..utils.profile import Profile, span
from .graphs import GRAPH_CACHE, BlockRunner  # noqa: F401 (read by tests)
from .lattice import LatNode, Lattice
from .lexgraph import build_word_graph
from .ngram_steps import (DeviceTables, MpxStep, Readout, StaticStep, Step,
                          TreeCopiesStep, TreeStep)
from .ngram_steps import topk2  # noqa: F401 (imported from here)
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



class NgramSearch(DeviceTables):
    """Trigram decoder over a senone scorer; its tables, most of them its
    frame step's (`step`), are buffers on `device`.  On the card the frame
    loop runs through captured CUDA graphs of a block of frames (`_scan`);
    `_runner.graphs = False` runs them eagerly, to compare the two."""

    FRAME_BUCKET = 100

    def __init__(self, lm: NgramModel, d: Dictionary, mdef: Mdef,
                 tmat: TransitionMatrices, scorer: nn.Module,
                 config: Optional[Config] = None, *,
                 device: torch.device | str = "cuda", **kwargs):
        super().__init__(torch.device(device))
        cfg = (config.copy() if config else Config(NGRAM_ARGS)).register(NGRAM_ARGS)
        cfg.update(**kwargs)
        self.config = cfg
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
        self.E = min(int(cfg["maxwpf"]), v.n_word)
        self.dlm = DeviceNgram(lm, device=self.device)
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
        self.step = self._pick_step(cfg, tmat)
        self.nlextree = self.step.copies
        self._runner = BlockRunner(axis=1, counters=(
            self.dlm.calls, tree_step.launches, mpx_step.launches,
            lm_entries.launches))

        g = self.graph
        self._buf("_rssid_sil", g.rssid[:, self.sil_ci])          # [W]
        self._buf("_is_finish", v.is_finish)
        # Phone-loop lookahead: each CI phone's senone row.
        ci_sen = mdef.sseq[mdef.phone_ssid[: mdef.n_ciphone]].astype(np.int64)
        bad = int(np.int32(np.uint16(0xFFFF)))
        self._buf("_ci_sen", np.where(ci_sen == bad, 0, ci_sen))
        self._buf("_ci_sen_valid", ci_sen != bad)
        # (tapes, lengths, last index) of the most recent batch; the tapes
        # stay on the device until a lattice needs them (`_host_tapes`).
        # `_last`: one utterance's host tapes + its length, for get_lattice.
        self._last_batch: Optional[tuple] = None
        self._host_tapes: Optional[tuple] = None
        self._last: Optional[tuple] = None
        self._lm_arrays: Optional[native.LmArrays] = None  # built at first use

    def _pick_step(self, cfg: Config, tmat: TransitionMatrices) -> Step:
        """The `auto` mode rules, the word graph (`graph`) and its frame
        step: the one place that reads the modes that choose a step."""
        v = self.vocab
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
            ug = np.asarray(self.lm.ug_prob)
            ugla = np.where(v.is_filler, 0.0, ug[np.maximum(v.lmwid, 0)])
        g = self.graph = build_word_graph(v.dict_wid, self.dict, self.mdef,
                                          Dict2Pid(self.mdef, self.dict),
                                          rc_mode=rc_mode, lc_mode=lc_mode,
                                          lex_mode=lex_mode, ug_lookahead=ugla)
        ro = Readout(g, v, self.dlm, self._fil_pen_np, E=self.E, lw=self.lw,
                     lw32=self._lw32, wip32=self._wip32,
                     start_lmwid=self.start_lmwid, prune=self.prune,
                     log_wbeam=self.log_wbeam, device=self.device)
        bands = hmm_bands(tmat.log_tp[g.tmat_idx])
        kw = dict(pip=self._pip32, log_beam=self.log_beam, device=self.device)
        if g.lc_mode == "mpx":
            return MpxStep(g, ro, bands, self._ent0, self.sil_ci, **kw)
        if g.lex_mode == "flat":
            return StaticStep(g, ro, bands, self._ent0, **kw)
        tree = (self.lm, v, str(cfg["treela"]) == "bg")
        n = max(1, int(cfg["nlextree"]))
        if n > 1:
            return TreeCopiesStep(g, ro, bands, *tree, n, **kw)
        return TreeStep(g, ro, bands, *tree, **kw)

    # ------------------------------------------------------------------
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

    # ------------------------------------------------------------------
    def _block_len(self, B: int, n: int) -> int:
        """Frames a block of a scan of n frames at batch B: the largest
        divisor of gcd(n, FRAME_BUCKET) whose block inputs (the step's
        `frame_bytes`) fit in EXPAND_BLOCK_BYTES.  A batch (n a multiple of
        FRAME_BUCKET) and a stream's chunk (n = CHUNK) so run whole blocks
        of one length: one captured graph a shape."""
        base = math.gcd(n, self.FRAME_BUCKET)
        cap = base
        per_frame = self.step.frame_bytes(self.graph, B)
        if per_frame:
            cap = min(cap, EXPAND_BLOCK_BYTES // per_frame)
        return max(d for d in range(1, max(1, cap) + 1) if base % d == 0)

    def _side_frames(self, Tpad: int) -> int:
        """Frames the static and tree steps' side-tables hold for a batch
        of Tpad frames: FRAME_BUCKET times a power of two, so that batches
        of nearby lengths share a captured graph.  Rows past Tpad are never
        read."""
        n = -(-Tpad // self.FRAME_BUCKET)
        return self.FRAME_BUCKET << max(0, (n - 1).bit_length())

    def _block(self, carry, inputs, t: torch.Tensor, tape):
        """One block: frames t .. t+K-1 of the inputs (scores [B, K, n_sen],
        valid [B, K], the lookahead [B, K, n_ci] or None) through the frame
        step; writes row k of the block's tape for frame t+k and returns
        the carry.  No host read, so the block can be captured."""
        scores, valid, la = inputs
        step = self.step
        xs = step.block_inputs(scores)
        for k in range(scores.shape[1]):
            carry = step.frame(carry, xs[k], t, valid[:, k],
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
        return self._runner.scan(self._block, carry, (scores, valid, la),
                                 tape, t0, self._block_len(B, n))

    # The runner's counters (captures, capture_s, replays).
    graph_stats = property(lambda self: self._runner.stats)
    # Read by portbench/drive.py:119, until its reader moves to graph_stats.
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
        carry = self.step.init_carry(B, self._side_frames(Tpad))
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
        return self._hypothesis(segs, score)

    def _hypothesis(self, segs: List[Segment], score) -> Hypothesis:
        """The Hypothesis of a path's segments, last word first: its words
        without the fillers, under their base spellings."""
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
        return {"carry": self.step.init_carry(1, max_frames),
                "tape": self._tape(1, max_frames, fill=True), "t": 0,
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
            state["carry"] = self.step.grow(state["carry"])
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
                s = float(trc[sl][e][self.graph.rssid[ws[e], self.sil_ci]])
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
        v, E = self.vocab, self.E
        segs: List[Segment] = []
        while slot >= 0:
            k = int(tw[slot])
            t = slot // E
            prev = int(tprev[slot])
            start = prev // E + 1 if prev >= 0 else 0
            segs.append(Segment(v.word_str[k], start, t, float(tsc[slot])))
            slot = prev
        return self._hypothesis(segs, score)
