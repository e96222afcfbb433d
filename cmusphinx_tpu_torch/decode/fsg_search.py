"""FSG (grammar) decoder: dense time-synchronous Viterbi over a grammar's
links.

Port of `cmusphinx_tpu/decode/fsg_search.py` (`FSG_ARGS`, `FsgSearch`:
`__init__`, the frame step, `decode`, the stream, `_backtrace_at`; and the
host lattice `FsgLattice`).  See the reference's docstrings for the
search's semantics; in short, every grammar link's word is compiled into
cross-word triphone channels (`lexgraph.py`), and a frame is:

- the senone scores gathered into the channels (the mpx row of an entry
  channel rides the Viterbi argmax as a payload);
- one `hmm_step` over all channels `[C, S]`;
- the per-link right-context exit readout `exv [K, Vr]`;
- the dense link-to-link handoff `A = exv[k, rc(k2)] + W[k, k2]`, `[K,
  K]`, its max and first-index argmax over the source link k;
- each entry routed into the left-context variant of the winning link's
  last phone, and `hmm_enter`.

What differs in form, not in result:

- The frame scan runs in blocks of `BLOCK` frames through the shared
  block runner (`graphs.BlockRunner`), the frame index a 0-d tensor on
  the device; on the card each block is a replay of a captured CUDA
  graph, the counterpart of the reference's compiled `lax.scan`.  The
  carry `[C, S]` is fixed per search, so one graph serves the batch
  decode and the stream at every utterance length.  A pass decodes one
  utterance, as in the reference.
- The batch decode pads the senone scores, not the features, to the
  reference's 100-frame bucket (the scorer sees the real frames only);
  the stream's last chunk is padded to `CHUNK` the same way.  Padded
  frames leave the carry as it was and are cut from the outputs, as in
  the reference.
- Argmaxes take the first index on ties explicitly (`_argmax_first`), as
  `jnp.argmax` does.
- Results are the port's `decode/results.py` dataclasses.

`FsgSearch` adds silence and filler self-loops and alternate
pronunciations to the `FsgModel` it is given, as the reference does: give
each search its own copy of a grammar.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.dict import Dictionary
from ..models.dict2pid import Dict2Pid
from ..models.fsg import FsgModel
from ..models.mdef import Mdef
from ..models.tmat import TransitionMatrices
from ..ops.hmm import NEG_INF, hmm_bands, hmm_enter, hmm_step
from ..utils.config import Arg, Config
from .graphs import BlockRunner, pad_frames
from .lexgraph import build_word_graph
from .ngram_steps import DeviceTables, Step, _argmax_first
from .results import Hypothesis, Segment

FSG_ARGS = [
    Arg("lw", float, 6.5, "Language model probability weight"),
    Arg("wip", float, 0.65, "Word insertion penalty"),
    Arg("silprob", float, 0.005, "Silence word transition probability"),
    Arg("fillprob", float, 1e-8, "Filler word transition probability"),
    Arg("beam", float, 1e-48, "Beam width applied to every frame in Viterbi search"),
    Arg("wbeam", float, 7e-29, "Beam width applied to word exits"),
    Arg("prune", bool, False, "Apply beam pruning (dense search is exact by default)"),
]


class FsgSearch(nn.Module):
    """Grammar decoder over a senone scorer; its tables are buffers on
    `device`.

    On the card the frame loop runs through captured CUDA graphs of a
    block of frames; `_runner.graphs = False` runs the same blocks eagerly
    there, to compare the two."""

    CHUNK = 50
    FRAME_BUCKET = 100
    # Frames a block: a divisor of FRAME_BUCKET and CHUNK, so that a batch
    # decode and a stream chunk are whole blocks of one graph.
    BLOCK = 50

    def __init__(self, fsg: FsgModel, d: Dictionary, mdef: Mdef,
                 tmat: TransitionMatrices, scorer,
                 config: Optional[Config] = None, *,
                 device: torch.device | str = "cuda", **kwargs):
        super().__init__()
        cfg = (config.copy() if config else Config(FSG_ARGS)).register(FSG_ARGS)
        cfg.update(**kwargs)
        self.config = cfg
        self.device = torch.device(device)
        lw = float(cfg["lw"])
        self.lw = lw
        log_wip = math.log(float(cfg["wip"]))
        # Silence/filler loops and alternate pronunciations, added to the
        # grammar at search init (fsg_search.c:290-355).
        silprob = float(cfg["silprob"])
        fillprob = float(cfg["fillprob"])
        fsg.lw = lw
        if silprob > 0 and fsg.word_id("<sil>") < 0 and d.silwid >= 0:
            fsg.add_silence("<sil>", -1, silprob)
            for fwid in range(d.filler_start, d.filler_end + 1):
                w = d.word_str(fwid)
                if w in ("<s>", "</s>", "<sil>"):
                    continue
                if d.basewid[fwid] == fwid:
                    fsg.add_silence(w, -1, fillprob)
        for word in list(fsg.vocab):
            wid = d.wordid(word)
            if wid >= 0:
                for alt in d.alternates(wid):
                    if alt != wid:
                        fsg.add_alt(word, d.word_str(alt))

        self.fsg = fsg
        self.dict = d
        self.mdef = mdef
        self.scorer = scorer
        self.sil_ci = mdef.sil if mdef.sil >= 0 else 0
        self.prune = bool(cfg["prune"])
        self.log_beam = float(np.float32(math.log(float(cfg["beam"]))))

        # One word instance per grammar link.
        wids, src, dst, lp, words = [], [], [], [], []
        for link in fsg.word_links():
            word = fsg.vocab[link.wid]
            wid = d.wordid(word)
            if wid < 0:
                raise KeyError(f"FSG word {word!r} not in dictionary")
            wids.append(wid)
            src.append(link.from_state)
            dst.append(link.to_state)
            lp.append(lw * link.logprob + log_wip)
            words.append(word)
        self.words = words
        self.wids = wids
        self.n_link = K = len(words)
        self.n_state = fsg.n_state
        g = self.graph = build_word_graph(wids, d, mdef, Dict2Pid(mdef, d))
        self.src = np.asarray(src, np.int32)
        self.dst = np.asarray(dst, np.int32)
        self.entry_lp = np.asarray(lp, np.float32)
        self.closure = fsg.null_closure()          # [N, N] lw-scaled, 0 diag
        # Link-to-link weights W[k, k2] = closure(dst_k, src_k2) +
        # entry_lp[k2]; initial entries through the start state's closure;
        # final weights closure(dst_k, final) (host copies for the lattice).
        self._W_np = (self.closure[self.dst][:, self.src]
                      + self.entry_lp[None, :]).astype(np.float32)
        st0 = self.closure[fsg.start_state]
        self._ent0 = np.asarray(st0[self.src] + self.entry_lp, np.float32)
        self._finw = np.asarray(self.closure[self.dst, fsg.final_state],
                                np.float32)
        xs0 = g.static_xs.copy()
        xs0[g.is_entry] = g.lcmap[g.lc_row[g.is_entry], self.sil_ci]

        self._graph_tables(g, hmm_bands(tmat.log_tp[g.tmat_idx]), self._ent0)
        buf = self._buf
        buf("_static_xs", g.static_xs)
        buf("_word_of", g.word_of)
        buf("_lcmap_flat", g.lcmap.reshape(-1))
        buf("_lc_row_base", g.lc_row.astype(np.int64) * g.n_ci)
        buf("_exit_valid", g.exit_tab >= 0)
        buf("_exit_tab_c", np.maximum(g.exit_tab, 0))
        buf("_rcv", g.rssid[:, g.firstci])                  # [K, K]
        buf("_rssid_sil", g.rssid[:, self.sil_ci])         # [K]
        buf("_prev_chan_c", np.maximum(g.prev_chan, 0))
        buf("_lastci", g.lastci)
        buf("_W", self._W_np, torch.float32)
        buf("_entxs0", xs0)
        self._last = None
        self._runner = BlockRunner()

    # The runner's counters (captures, capture_s, replays).
    graph_stats = property(lambda self: self._runner.stats)

    # The graph's tables are the N-gram steps': the same buffers, the same
    # readers.
    _buf = DeviceTables._buf
    _graph_tables = Step._graph_tables
    _bands = Step._bands
    _xs_rows = Step._xs_rows

    # ------------------------------------------------------------------
    def _init_carry(self):
        """All channels silent but the initial entries (silence left
        context); payloads (bp slot, mpx xs row)."""
        g = self.graph
        C, S = g.n_chan, g.n_emit_state
        dev = self.device
        alpha = torch.full((C, S), NEG_INF, dtype=torch.float32, device=dev)
        hist = torch.full((C, S), -1, dtype=torch.int64, device=dev)
        xsr = self._static_xs[:, None].expand(C, S).contiguous()
        alpha, (hist, xsr) = hmm_enter(
            alpha, (hist, xsr), self._entc0,
            (torch.full((C,), -1, dtype=torch.int64, device=dev),
             self._entxs0))
        return alpha, hist, xsr

    def _step(self, carry, sen_t: torch.Tensor, t: torch.Tensor,
              valid_t: torch.Tensor, rows) -> tuple:
        """Frame t (a 0-d int64 tensor): advance the carry and write the
        frame's exits into `rows` (views wex, wexh, wexsil [K]; exv [K,
        Vr]).  A frame past the utterance (`valid_t` false) keeps the
        carry and reads NEG_INF exits, as the reference's `valid` mask
        does (which leaves wexh as it is)."""
        alpha0, hist0, xsr0 = carry
        K = self.n_link
        neg = NEG_INF
        sen_c = torch.gather(self._xs_rows(sen_t), 0, xsr0)      # [C, S]
        alpha, (hist, xsr), ex, (exh, _) = hmm_step(
            alpha0, (hist0, xsr0), sen_c, self._bands())
        if self.prune:
            bestscr = alpha.amax()
            keep = alpha.amax(1) > bestscr + self.log_beam
            alpha = torch.where(keep[:, None], alpha, neg)

        # Per-link exits with the per-rc-variant readout.
        exv = torch.where(self._exit_valid, ex[self._exit_tab_c], neg)  # [K, Vr]
        wex = exv.amax(1)
        vwin = _argmax_first(exv, 1)
        wexh = exh[self._exit_tab_c.gather(1, vwin[:, None])[:, 0]]

        # Link-to-link handoff: A[k, k2] = exit(k, rc = firstci(k2)) + W.
        A = exv.gather(1, self._rcv) + self._W                    # [K, K]
        ent = A.amax(0)
        kstar = _argmax_first(A, 0)
        ebp = torch.where(ent > neg * 0.5, t * K + kstar, -1)
        lcstar = self._lastci[kstar]

        wo = self._word_of
        ie = self._is_entry
        ent_xs_c = self._lcmap_flat[self._lc_row_base + lcstar[wo]]
        pc = self._prev_chan_c
        prop = torch.where(self._has_prev, ex[pc], neg)
        bprop = torch.where(self._has_prev, exh[pc], -1)
        alpha, (hist, xsr) = hmm_enter(
            alpha, (hist, xsr), torch.where(ie, ent[wo], prop),
            (torch.where(ie, ebp[wo], bprop),
             torch.where(ie, ent_xs_c, self._static_xs)))

        wexsil = exv.gather(1, self._rssid_sil[:, None])[:, 0]
        for r, v in zip(rows, (torch.where(valid_t, wex, neg), wexh,
                               torch.where(valid_t, wexsil, neg),
                               torch.where(valid_t, exv, neg))):
            r.copy_(v)
        return (torch.where(valid_t, alpha, alpha0),
                torch.where(valid_t, hist, hist0),
                torch.where(valid_t, xsr, xsr0))

    def _block(self, carry, inputs, t: torch.Tensor, rows) -> tuple:
        """Frames t .. t+K-1 of the senone scores [K, n_sen] (valid [K]),
        writing row k of each of the block's tape `rows` for frame t+k;
        nothing here reads a device value on the host, so the block can
        be captured (`graphs.BlockRunner`)."""
        scores, valid = inputs
        for k in range(scores.shape[0]):
            carry = self._step(carry, scores[k], t, valid[k],
                               tuple(r[k] for r in rows))
            t = t + 1
        return carry

    def _scan(self, carry, scores: torch.Tensor, t0: int, T: int):
        """Step frames t0 .. t0+n-1 of the senone scores [n, n_sen], the
        first T of them real, block by block; returns (carry, the exit
        tapes wex, wexh, wexsil [n, K], exv [n, K, Vr] on the device).  No
        host read: on the card each block is a graph's replay."""
        n = scores.shape[0]
        K, Vr = self.n_link, self.graph.n_rcvar
        dev = self.device
        valid = torch.arange(n, device=dev) < T
        tape = (torch.empty((n, K), dtype=torch.float32, device=dev),
                torch.empty((n, K), dtype=torch.int64, device=dev),
                torch.empty((n, K), dtype=torch.float32, device=dev),
                torch.empty((n, K, Vr), dtype=torch.float32, device=dev))
        carry = self._runner.scan(self._block, carry, (scores, valid), tape,
                                  t0, self.BLOCK, row0=0)
        return carry, tape

    def _run(self, carry, scores: torch.Tensor, t0: int, T: int):
        """`_scan`, then the real frames' exits on the host: (carry, wex,
        wexh, wexsil [T, K], exv [T, K, Vr])."""
        carry, tape = self._scan(carry, scores, t0, T)
        wex, wexh, wexsil, exv = (a[:T].cpu().numpy() for a in tape)
        return carry, (wex, wexh.astype(np.int32), wexsil, exv)

    def _scores(self, feats, n: int) -> torch.Tensor:
        """The senone scores of feats [T, D], padded with zero rows to n
        frames: the scorer runs on the T real frames only."""
        x = torch.as_tensor(np.asarray(feats, np.float32)).to(self.device)
        return pad_frames(self.scorer.score(x), n)

    @torch.inference_mode()
    def decode(self, feats) -> Hypothesis:
        """feats [T, D] -> best hypothesis."""
        T = int(feats.shape[0])
        if T == 0:
            return Hypothesis([], float("-inf"), [])
        Tpad = -(-T // self.FRAME_BUCKET) * self.FRAME_BUCKET
        _, (wex, wexh, wexsil, exv) = self._run(
            self._init_carry(), self._scores(feats, Tpad), 0, T)
        self._last = (wex, wexh, wexsil, exv, T)
        return self._backtrace_at(wex, wexh, wexsil, T)

    def _is_filler_word(self, word: str) -> bool:
        wid = self.dict.wordid(word)
        return wid >= 0 and self.dict.is_filler(wid)

    # ------------------------------------------------------------------
    # Streaming decode: the Viterbi carry stays on the device between
    # chunks; each chunk's [CHUNK, K] exit rows accumulate on the host for
    # the partial backtrace.
    @torch.inference_mode()
    def stream_start(self, max_frames: int = 100000) -> dict:
        return {"carry": self._init_carry(), "t": 0,
                "max_frames": max_frames,
                "wex": [], "wexh": [], "wexsil": [], "exv": [],
                "pending": np.zeros((0, 0), np.float32)}

    def _stream_chunk(self, state: dict, block: np.ndarray) -> None:
        """One chunk of at most CHUNK frames, padded to CHUNK (one graph
        for every chunk, the last one too)."""
        take = block.shape[0]
        state["carry"], outs = self._run(
            state["carry"], self._scores(block, self.CHUNK), state["t"], take)
        for key, a in zip(("wex", "wexh", "wexsil", "exv"), outs):
            state[key].append(a)
        state["t"] += take

    @torch.inference_mode()
    def stream_push(self, state: dict, feats: np.ndarray) -> dict:
        """Feed feature frames; whole CHUNKs are decoded, the remainder is
        buffered until the next push or stream_end."""
        feats = np.asarray(feats, np.float32)
        pend = state["pending"]
        buf = feats if pend.size == 0 else np.concatenate([pend, feats])
        k = buf.shape[0] // self.CHUNK
        for i in range(k):
            if state["t"] + self.CHUNK > state["max_frames"]:
                raise ValueError("stream exceeds max_frames")
            self._stream_chunk(state, buf[i * self.CHUNK: (i + 1) * self.CHUNK])
        state["pending"] = buf[k * self.CHUNK:]
        return state

    def _stream_flush(self, state: dict) -> int:
        """Decode the buffered remainder as a last chunk, its padding
        masked (the reference's flush); returns the frames decoded."""
        pend = state["pending"]
        if pend.shape[0]:
            self._stream_chunk(state, pend)
            state["pending"] = np.zeros((0, 0), np.float32)
        return state["t"]

    def _stream_tape(self, state: dict):
        K, Vr = self.n_link, self.graph.n_rcvar
        empty = {"wex": ((0, K), np.float32), "wexh": ((0, K), np.int32),
                 "wexsil": ((0, K), np.float32),
                 "exv": ((0, K, Vr), np.float32)}
        return tuple(np.concatenate(state[k]) if state[k] else
                     np.zeros(*empty[k]) for k in ("wex", "wexh", "wexsil",
                                                   "exv"))

    def stream_partial(self, state: dict) -> Hypothesis:
        """Best hypothesis so far: the best exit at the last decoded frame,
        preferring links that reach the grammar's final state."""
        if state["t"] == 0:
            return Hypothesis([], float("-inf"), [])
        wex, wexh, wexsil, _ = self._stream_tape(state)
        return self._backtrace_at(wex, wexh, wexsil, state["t"],
                                  require_final=False)

    @torch.inference_mode()
    def stream_end(self, state: dict) -> Hypothesis:
        T = self._stream_flush(state)
        wex, wexh, wexsil, exv = self._stream_tape(state)
        self._last = (wex, wexh, wexsil, exv, T)
        return self._backtrace_at(wex, wexh, wexsil, T, require_final=True)

    def _backtrace_at(self, wex_t, wexh_t, wexsil_t, T: int,
                      require_final: bool = True) -> Hypothesis:
        if T == 0:
            return Hypothesis([], float("-inf"), [])
        finals = wexsil_t[T - 1] + self._finw
        k = int(np.argmax(finals))
        score = float(finals[k])
        if not np.isfinite(score) or score <= NEG_INF / 2:
            if require_final:
                return Hypothesis([], float("-inf"), [])
            # Partial: the best exit whether or not it reaches the final
            # state.
            k = int(np.argmax(wex_t[T - 1]))
            score = float(wex_t[T - 1, k])
            if not np.isfinite(score) or score <= NEG_INF / 2:
                return Hypothesis([], float("-inf"), [])
        K = self.n_link
        segs: List[Segment] = []
        t = T - 1
        while True:
            prev = int(wexh_t[t, k])
            start = (prev // K) + 1 if prev >= 0 else 0
            segs.append(Segment(self.words[k], start, t, float(wex_t[t, k])))
            if prev < 0:
                break
            t, k = prev // K, prev % K
        segs.reverse()
        words = [s.word for s in segs if not self._is_filler_word(s.word)]
        return Hypothesis(words, score, segs)

    # ------------------------------------------------------------------
    def get_lattice(self) -> "FsgLattice":
        """Word lattice from the Viterbi history of the last utterance
        (fsg_search_lattice capability)."""
        if self._last is None:
            raise RuntimeError("no utterance decoded yet")
        wex, wexh, wexsil, exv, T = self._last
        return FsgLattice(self, wex, wexh, wexsil, exv, T)


class FsgLattice:
    """Word lattice over the FSG Viterbi history, on the host (the
    reference's `FsgLattice`): nodes are link exits (frame t, link k), so a
    node carries its grammar state and bestpath and N-best are exact over
    the lattice."""

    def __init__(self, search: FsgSearch, wex, wexh, wexsil, exv, T: int,
                 latbeam: float = 1e-28):
        self.search = search
        self.n_frames = T
        K = search.n_link
        g = search.graph
        W = search._W_np                                # [K, K] grammar wt
        rssid = np.asarray(g.rssid)                     # [K, n_ci]
        firstci = np.asarray(g.firstci)
        neg = NEG_INF

        # Candidate nodes: exits within latbeam of the frame-best exit.
        lb = math.log(latbeam)
        keep = np.zeros((T, K), bool)
        for t in range(T):
            row = wex[t]
            m = row.max()
            if m > neg / 2:
                keep[t] = row > max(m + lb, neg / 2)
        nodes = []          # (t, k, sf, ascr)
        for t in range(T):
            for k in np.nonzero(keep[t])[0]:
                prev = int(wexh[t, k])
                if prev >= 0:
                    t1, k1 = prev // K, prev % K
                    rc = int(rssid[k1, firstci[k]])
                    ev = float(exv[t1, k1, rc])
                    if ev <= neg / 2:
                        ev = float(wex[t1, k1])
                    entry = ev + float(W[k1, k])
                    sf = t1 + 1
                else:
                    entry = float(search._ent0[k])
                    sf = 0
                ascr = float(wex[t, k]) - entry
                nodes.append((t, k, sf, ascr))
        self.nodes = nodes
        N = len(nodes)
        # Edges (t1,k1) -> (t2,k2) where t1 == sf2 - 1 and the grammar
        # connects them: rc-adjusted source exit - its best exit + grammar
        # weight + the destination's acoustics.
        by_ef: dict = {}
        for i, (t, k, sf, _) in enumerate(nodes):
            by_ef.setdefault(t, []).append(i)
        self.preds = [[] for _ in range(N)]
        self.succs = [[] for _ in range(N)]
        self.edge_w: Dict[Tuple[int, int], float] = {}
        for j, (t2, k2, sf2, ascr2) in enumerate(nodes):
            if sf2 == 0:
                continue
            for i in by_ef.get(sf2 - 1, []):
                t1, k1, _, _ = nodes[i]
                gw = float(W[k1, k2])
                if gw <= neg / 2:
                    continue
                rc = int(rssid[k1, firstci[k2]])
                ev = float(exv[t1, k1, rc])
                if ev <= neg / 2:
                    continue
                w = (ev - float(wex[t1, k1])) + gw + ascr2
                self.edge_w[(i, j)] = w
                self.succs[i].append(j)
                self.preds[j].append(i)
        # Start weight: grammar entry + own acoustics; final adjustment:
        # the silence-rc exit + closure to the grammar's final state.
        self.start_w = np.full(N, neg, np.float32)
        self.final_w = np.full(N, neg, np.float32)
        finw = search._finw
        for i, (t, k, sf, ascr) in enumerate(nodes):
            if sf == 0:
                self.start_w[i] = float(search._ent0[k]) + ascr
            if t == T - 1 and np.isfinite(finw[k]) and finw[k] > neg / 2:
                ws = float(wexsil[t, k])
                if ws > neg / 2:
                    self.final_w[i] = (ws - float(wex[t, k])) + float(finw[k])
        # Keep only nodes on some complete start -> final path.
        fwd = self.start_w > neg / 2
        order = sorted(range(N), key=lambda i: nodes[i][0])
        for i in order:
            if fwd[i]:
                for j in self.succs[i]:
                    fwd[j] = True
        bwd = self.final_w > neg / 2
        for i in reversed(order):
            if bwd[i]:
                for p in self.preds[i]:
                    bwd[p] = True
        self.alive = fwd & bwd

    def _word(self, i: int) -> str:
        return self.search.words[self.nodes[i][1]]

    def _segs(self, path: List[int]) -> Tuple[List[str], List[Segment]]:
        segs = [Segment(self._word(i), self.nodes[i][2], self.nodes[i][0],
                        0.0) for i in path]
        words = [s.word for s in segs
                 if not self.search._is_filler_word(s.word)]
        return words, segs

    def _order(self) -> List[int]:
        return sorted(range(len(self.nodes)), key=lambda i: self.nodes[i][0])

    def bestpath(self) -> Hypothesis:
        """Exact Viterbi over the lattice DAG."""
        N = len(self.nodes)
        neg = NEG_INF
        best = np.where(self.alive, self.start_w, neg).astype(np.float64)
        back = -np.ones(N, np.int64)
        for i in self._order():
            if best[i] <= neg / 2 or not self.alive[i]:
                continue
            for j in self.succs[i]:
                s = best[i] + self.edge_w[(i, j)]
                if s > best[j]:
                    best[j] = s
                    back[j] = i
        fin = np.where(self.alive, best + self.final_w, neg)
        j = int(np.argmax(fin))
        if fin[j] <= neg / 2:
            return Hypothesis([], float("-inf"), [])
        path = []
        i = j
        while i >= 0:
            path.append(i)
            i = int(back[i])
        path.reverse()
        words, segs = self._segs(path)
        return Hypothesis(words, float(fin[j]), segs)

    def posterior(self, ascale: float = 0.05) -> np.ndarray:
        """Node posteriors by forward-backward (ps_lattice_posterior)."""
        N = len(self.nodes)
        alpha = np.full(N, -np.inf)
        beta = np.full(N, -np.inf)
        order = self._order()
        neg = NEG_INF
        for i in order:
            if self.alive[i] and self.start_w[i] > neg / 2:
                alpha[i] = np.logaddexp(alpha[i], ascale * self.start_w[i])
        for i in order:
            if not np.isfinite(alpha[i]):
                continue
            for j in self.succs[i]:
                if self.alive[j]:
                    alpha[j] = np.logaddexp(
                        alpha[j], alpha[i] + ascale * self.edge_w[(i, j)])
        for i in order:
            if self.alive[i] and self.final_w[i] > neg / 2:
                beta[i] = ascale * self.final_w[i]
        for i in reversed(order):
            for j in self.succs[i]:
                if np.isfinite(beta[j]):
                    beta[i] = np.logaddexp(
                        beta[i], beta[j] + ascale * self.edge_w[(i, j)])
        total = -np.inf
        for i in order:
            if self.final_w[i] > neg / 2 and np.isfinite(alpha[i]):
                total = np.logaddexp(total, alpha[i] + ascale * self.final_w[i])
        return alpha + beta - total

    def nbest(self, n: int = 10) -> List[Hypothesis]:
        """A* N-best with an exact backward-Viterbi heuristic (ps_astar
        capability; exact because the grammar state lives in the node)."""
        import heapq
        N = len(self.nodes)
        neg = NEG_INF
        h = np.where(self.alive, self.final_w, neg).astype(np.float64)
        order = self._order()
        for i in reversed(order):
            for j in self.succs[i]:
                if h[j] > neg / 2:
                    h[i] = max(h[i], self.edge_w[(i, j)] + h[j])
        heap = []
        cnt = 0
        for i in order:
            if self.alive[i] and self.start_w[i] > neg / 2 and h[i] > neg / 2:
                heapq.heappush(heap, (-(self.start_w[i] + h[i]), cnt, i,
                                      float(self.start_w[i]), None))
                cnt += 1
        paths: List[Tuple] = []
        out: List[Hypothesis] = []
        seen = set()
        while heap and len(out) < n:
            _, _, i, gscore, parent = heapq.heappop(heap)
            paths.append((i, parent))
            pid = len(paths) - 1
            if self.final_w[i] > neg / 2:
                s = gscore + float(self.final_w[i])
                path = []
                p = pid
                while p is not None:
                    path.append(paths[p][0])
                    p = paths[p][1]
                path.reverse()
                words, segs = self._segs(path)
                text = " ".join(words)
                if text not in seen:
                    seen.add(text)
                    out.append(Hypothesis(words, s, segs))
            for j in self.succs[i]:
                if h[j] > neg / 2:
                    g2 = gscore + self.edge_w[(i, j)]
                    heapq.heappush(heap, (-(g2 + h[j]), cnt, j, g2, pid))
                    cnt += 1
        return out

    def write(self, path: str, uttid: str = "utt",
              logbase: float = 1.0001) -> None:
        """Sphinx lattice text format (ps_lattice.c:232-370)."""
        lb = math.log(logbase)
        ids = [i for i in range(len(self.nodes)) if self.alive[i]]
        remap = {i: r for r, i in enumerate(ids)}
        with open(path, "w") as fh:
            fh.write("# getcwd: /\n")
            fh.write(f"# -logbase {logbase:g}\n")
            fh.write(f"Frames {self.n_frames}\n#\n")
            fh.write("Nodes %d (NODEID WORD STARTFRAME FIRST-ENDFRAME "
                     "LAST-ENDFRAME)\n" % len(ids))
            for i in ids:
                t, k, sf, _ = self.nodes[i]
                fh.write(f"{remap[i]} {self._word(i)} {sf} {t} {t}\n")
            starts = [i for i in ids if self.start_w[i] > NEG_INF / 2]
            finals = [i for i in ids if self.final_w[i] > NEG_INF / 2]
            fh.write(f"Initial {remap[starts[0]] if starts else 0}\n")
            fh.write(f"Final {remap[finals[0]] if finals else 0}\n")
            fh.write("Edges (FROM-NODEID TO-NODEID ASCORE)\n")
            for (i, j), w in self.edge_w.items():
                if self.alive[i] and self.alive[j]:
                    fh.write(f"{remap[i]} {remap[j]} {int(w / lb)}\n")
            fh.write("End\n")
