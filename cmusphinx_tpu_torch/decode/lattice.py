"""Word lattices and the results layer: bestpath, posteriors, N-best.

A copy of `cmusphinx_tpu/decode/lattice.py` (host numpy and Python; the
bestpath, posterior and N-best run in the port's own native runtime,
`utils/native.py`, where it builds, and in the pure-Python paths below
where it does not or for lattices read from files).

Capability parity with ps_lattice.c (reference:
pocketsphinx/src/libpocketsphinx/ps_lattice.c:1224 ps_lattice_bestpath,
:1394 ps_lattice_posterior, :1657 ps_astar_start / :1717 ps_astar_next,
:232-409 Sphinx lattice read/write, :292 HTK SLF write) and the sphinx3
DAG tools (sphinx3/src/libs3decoder/libsearch/{dag,astar}.c,
libconfidence/confidence.c word posteriors).

The lattice is built from the decoder's device backpointer tape: every tape
slot is a word *instance* (word, start frame, end frame) with per-right-
context exit scores (the bscore_stack analog).  Links connect any instance
ending at frame f to any instance starting at f+1 — the standard
word-boundary context-independence assumption the reference's lattice
construction (ngram_search.c:1100 ngram_search_lattice) also makes.

Unlike the reference's bestpath (which approximates the trigram history with
the single best predecessor per node), `bestpath()` here is an EXACT trigram
Viterbi over link states (pairs of adjacent instances) — affordable on host
because lattices are small (T x maxwpf instances).
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import native as _native
from .results import Hypothesis, Segment

NEG = -1.0e30


@dataclass
class LatNode:
    """A word instance (tape slot)."""
    id: int
    word: str          # word string (search vocabulary entry)
    kidx: int          # search word index
    lmwid: int         # LM word id (-1 for fillers)
    is_filler: bool
    fil_pen: float
    sf: int            # start frame
    ef: int            # end frame (inclusive)
    vit_score: float   # Viterbi exit score from pass 1 (best rc)
    rc_score: np.ndarray  # per-right-context exit scores [n_ci]
    entry_score: float    # score at word entry on the pass-1 path
    # True when the node IS the finish word </s> (whether it entered the
    # search as an LM word or as a filler): the utterance-final
    # P(</s> | h) term is skipped for such nodes — the decoder's
    # _final_slot does the same, so path scores stay comparable.
    is_finish: bool = False
    preds: List[int] = field(default_factory=list)
    succs: List[int] = field(default_factory=list)

    @property
    def base(self) -> str:
        """Base word string (alternate-pronunciation suffix stripped) —
        hypothesis text uses base forms like the reference's
        dict_basestr (dict.c)."""
        w = self.word
        return w[: w.rindex("(")] if w.endswith(")") and "(" in w else w


class Lattice:
    """Word lattice over decoder tape slots."""

    def __init__(self, nodes: List[LatNode], firstci: np.ndarray,
                 lastci: np.ndarray, lm, lw: float, log_wip: float,
                 sil_ci: int, finish_lmwid: int, T: int,
                 logbase: float = 1.0001,
                 explicit_edges: Optional[Dict[Tuple[int, int], float]] = None):
        self.nodes = nodes
        self.firstci = firstci
        self.lastci = lastci
        self.lm = lm
        self.lw = lw
        self.log_wip = log_wip
        self.sil_ci = sil_ci
        self.finish_lmwid = finish_lmwid
        self.n_frames = T
        self.logbase = logbase
        # Lattices read back from disk carry explicit per-link acoustic
        # scores (ps_lattice.c:409 read path) instead of per-node rc stacks.
        self._explicit = explicit_edges
        if explicit_edges is None:
            self._index_edges()
        else:
            for n in self.nodes:
                n.preds, n.succs = [], []
            for (i, j) in explicit_edges:
                self.nodes[i].succs.append(j)
                self.nodes[j].preds.append(i)
            maxef = max((n.ef for n in self.nodes), default=-1)
            self._starts = [n.id for n in self.nodes if not n.preds]
            self._ends = [n.id for n in self.nodes
                          if not n.succs and n.ef == maxef]

    def _index_edges(self):
        # A final node must cover the end of the utterance; mid-utterance
        # dead ends are deleted (ps_lattice.c:196 unreachable deletion) —
        # scores are frame-relative, so partial-coverage paths would
        # otherwise win.  Vectorized: a node reaches the end iff it ends at
        # maxef or SOME node starting at ef+1 reaches — a per-frame boolean,
        # computed in one descending frame sweep over numpy buckets (the
        # per-node Python recursion was a construction wall at 5k vocab).
        if not self.nodes:
            self._starts, self._ends = [], []
            return
        sf = np.fromiter((n.sf for n in self.nodes), np.int64,
                         len(self.nodes))
        ef = np.fromiter((n.ef for n in self.nodes), np.int64,
                         len(self.nodes))
        maxef = int(ef.max())
        order = np.argsort(sf, kind="stable")
        bounds = np.searchsorted(sf[order], np.arange(maxef + 2))
        frame_reach = np.zeros(maxef + 3, bool)
        reach = ef == maxef
        for f in range(maxef, -1, -1):
            idx = order[bounds[f] : bounds[f + 1]]
            if idx.size == 0:
                continue
            r = reach[idx] | frame_reach[ef[idx] + 1]
            reach[idx] = r
            frame_reach[f] = bool(r.any())
        keep_idx = np.nonzero(reach)[0]
        keep = [self.nodes[i] for i in keep_idx]
        for i, n in enumerate(keep):
            n.id = i
        self.nodes = keep
        sf, ef = sf[keep_idx], ef[keep_idx]
        # Successors of n = all nodes starting at n.ef + 1 (shared per-frame
        # id lists; edges are the word-boundary adjacency).
        order = np.argsort(sf, kind="stable")
        bounds = np.searchsorted(sf[order], np.arange(maxef + 3))
        starts_at = [order[bounds[f] : bounds[f + 1]].tolist()
                     for f in range(maxef + 2)]
        ends_order = np.argsort(ef, kind="stable")
        ebounds = np.searchsorted(ef[ends_order], np.arange(maxef + 2))
        ends_at = [ends_order[ebounds[f] : ebounds[f + 1]].tolist()
                   for f in range(maxef + 1)]
        for n in self.nodes:
            n.succs = starts_at[n.ef + 1] if n.ef + 1 <= maxef + 1 else []
            n.preds = ends_at[n.sf - 1] if n.sf >= 1 else []
        self._starts = starts_at[0]
        self._ends = ends_at[maxef]

    # ------------------------------------------------------------------
    def link_ascr(self, src: LatNode, dst_firstci: int) -> float:
        """Acoustic score of src's word segment when followed by a word
        starting with CI phone dst_firstci (ngram_compute_seg_score)."""
        s = float(src.rc_score[dst_firstci])
        if s <= NEG / 2:
            s = src.vit_score
        return s - src.entry_score

    def edge_ascr(self, src: LatNode, dst: LatNode) -> float:
        """Acoustic score on the link src -> dst: the stored value for
        lattices read from disk, else the rc-stack readout."""
        if self._explicit is not None:
            return self._explicit.get((src.id, dst.id), NEG)
        return self.link_ascr(src, self.firstci[dst.kidx])

    def final_ascr(self, src: LatNode) -> float:
        """Acoustic score of src as the utterance-final word (rc = SIL)."""
        if self._explicit is not None:
            # The file format carries acoustics on links only; the final
            # node's own segment score is folded into its incoming links
            # (dag.c semantics).
            return 0.0
        s = float(src.rc_score[self.sil_ci])
        if s <= NEG / 2:
            s = src.vit_score
        return s - src.entry_score

    def _is_finish(self, n: LatNode) -> bool:
        return n.is_finish or (n.lmwid == self.finish_lmwid
                               and not n.is_filler)

    def _lm_term(self, h1: int, h2: int, node: LatNode, lw: float) -> float:
        if node.is_filler:
            return node.fil_pen
        return lw * self.lm.tg_score(h1, h2, node.lmwid) + self.log_wip

    def _next_hist(self, h1: int, h2: int, node: LatNode) -> Tuple[int, int]:
        if node.is_filler:
            return h1, h2
        return h2, node.lmwid

    # ------------------------------------------------------------------
    def bestpath(self, lw: Optional[float] = None,
                 start_lmwid: int = -1,
                 prune_beam: float = 0.0) -> Hypothesis:
        """Exact trigram Viterbi over the lattice (ps_lattice_bestpath
        capability, without its single-history approximation).

        States are (node, LM history pair); the history set reachable at a
        node is small because fillers are transparent.  Runs in the native
        C++ runtime (csrc/sphinx_runtime.cc lattice_bestpath) when built;
        this Python implementation is the reference/fallback.

        prune_beam > 0 (natural-log units) gates the exact DP with a
        bigram-approximate forward/backward link beam in the native path —
        links off every path within prune_beam of the best are skipped.
        """
        lw = self.lw if lw is None else lw
        if _native is not None and self._explicit is None:
            r = _native.lattice_bestpath(self, lw, start_lmwid,
                                         prune_beam=prune_beam)
            if r is not None:
                ids, score = r
                segs = [Segment(self.nodes[i].word, self.nodes[i].sf,
                                self.nodes[i].ef, 0.0) for i in ids]
                words = [self.nodes[i].base for i in ids
                         if not self.nodes[i].is_filler]
                return Hypothesis(words, float(score), segs)
        # state: (node_id, h1, h2) -> (score, prev_state)
        best: Dict[Tuple[int, int, int], Tuple[float, Optional[Tuple]]] = {}
        order = sorted(range(len(self.nodes)),
                       key=lambda i: (self.nodes[i].sf, self.nodes[i].ef))
        for i in self._starts:
            n = self.nodes[i]
            t = self._lm_term(-1, start_lmwid, n, lw)
            h = self._next_hist(-1, start_lmwid, n)
            key = (i, h[0], h[1])
            sc = t
            if key not in best or sc > best[key][0]:
                best[key] = (sc, None)
        # Process states in topological (sf) order.
        states_at: Dict[int, List[Tuple[int, int, int]]] = {}
        for key in list(best):
            states_at.setdefault(key[0], []).append(key)
        for i in order:
            n = self.nodes[i]
            for key in states_at.get(i, []):
                sc, _ = best[key]
                _, h1, h2 = key
                for j in n.succs:
                    m = self.nodes[j]
                    ascr = self.edge_ascr(n, m)
                    t = self._lm_term(h1, h2, m, lw)
                    nh = self._next_hist(h1, h2, m)
                    nkey = (j, nh[0], nh[1])
                    nsc = sc + ascr + t
                    if nkey not in best or nsc > best[nkey][0]:
                        best[nkey] = (nsc, key)
                        states_at.setdefault(j, []).append(nkey)
        # Final: add the final word's own acoustics + </s>.
        bestk, bests = None, -np.inf
        for key, (sc, _) in best.items():
            n = self.nodes[key[0]]
            if n.succs:
                continue
            s = sc + self.final_ascr(n)
            if not self._is_finish(n):
                s += lw * self.lm.tg_score(key[1], key[2], self.finish_lmwid)
            if s > bests:
                bestk, bests = key, s
        if bestk is None:
            return Hypothesis([], float("-inf"), [])
        # Backtrace.
        segs: List[Segment] = []
        key = bestk
        while key is not None:
            n = self.nodes[key[0]]
            segs.append(Segment(n.word, n.sf, n.ef, best[key][0]))
            key = best[key][1]
        segs.reverse()
        words = [self.nodes[self._node_by_seg(s)].base for s in segs
                 if not self.nodes[self._node_by_seg(s)].is_filler]
        return Hypothesis(words, float(bests), segs)

    def _node_by_seg(self, seg: Segment) -> int:
        for n in self.nodes:
            if n.word == seg.word and n.sf == seg.start_frame and n.ef == seg.end_frame:
                return n.id
        return 0

    # ------------------------------------------------------------------
    def posterior(self, ascale: float = 0.05) -> np.ndarray:
        """Link-free node posteriors by forward-backward over edges
        (ps_lattice_posterior capability).  ascale scales acoustic scores
        (reference -ascale, default 20 -> 1/20).  Native-accelerated
        (csrc/sphinx_runtime.cc lattice_posterior) when built."""
        if _native is not None and self.nodes and self._explicit is None:
            p = _native.lattice_posterior(self, ascale)
            if p is not None:
                return p
        N = len(self.nodes)
        # log alpha/beta over nodes with summed (logaddexp) path mass.
        alpha = np.full(N, -np.inf)
        beta = np.full(N, -np.inf)
        order = sorted(range(N), key=lambda i: (self.nodes[i].sf, self.nodes[i].ef))
        for i in self._starts:
            n = self.nodes[i]
            alpha[i] = ascale * (self._lm_term(-1, -1, n, self.lw))
        for i in order:
            n = self.nodes[i]
            if not np.isfinite(alpha[i]):
                continue
            for j in n.succs:
                m = self.nodes[j]
                w = ascale * (self.edge_ascr(n, m)
                              + self._lm_term(-1, n.lmwid, m, self.lw))
                alpha[j] = np.logaddexp(alpha[j], alpha[i] + w)
        for i in self._ends:
            beta[i] = ascale * self.final_ascr(self.nodes[i])
        for i in reversed(order):
            n = self.nodes[i]
            for j in n.succs:
                m = self.nodes[j]
                w = ascale * (self.edge_ascr(n, m)
                              + self._lm_term(-1, n.lmwid, m, self.lw))
                if np.isfinite(beta[j]):
                    beta[i] = np.logaddexp(beta[i], beta[j] + w)
        norm = max((alpha[i] + beta[i] - ascale * self.final_ascr(self.nodes[i])
                    for i in self._ends if np.isfinite(alpha[i])),
                   default=-np.inf)
        # For ends, alpha+beta double-counts nothing; norm = total mass.
        total = -np.inf
        for i in self._ends:
            if np.isfinite(alpha[i]):
                total = np.logaddexp(total, alpha[i] + beta[i])
        post = alpha + beta - total
        return post

    # ------------------------------------------------------------------
    def nbest(self, n: int = 10, lw: Optional[float] = None,
              start_lmwid: int = -1) -> List[Hypothesis]:
        """A* N-best paths (ps_astar capability).  Heuristic = exact
        best-completion score from a backward Viterbi pass.
        Native-accelerated (csrc/sphinx_runtime.cc lattice_nbest) when
        built; paths are de-duplicated by word sequence here."""
        lw = self.lw if lw is None else lw
        if _native is not None and self.nodes and self._explicit is None:
            # Retry with a larger over-request when de-duplication exhausts
            # the batch while the C side may still hold more distinct paths
            # (parity with the Python fallback, which pops until n texts).
            want = 4 * n
            for _ in range(4):
                r = _native.lattice_nbest(self, n, lw, start_lmwid,
                                          want=want)
                if r is None:
                    break
                out, seen = [], set()
                for ids, score in r:
                    segs = [Segment(self.nodes[i].word, self.nodes[i].sf,
                                    self.nodes[i].ef, 0.0) for i in ids]
                    words = [self.nodes[i].base for i in ids
                             if not self.nodes[i].is_filler]
                    text = " ".join(words)
                    if text in seen:
                        continue
                    seen.add(text)
                    out.append(Hypothesis(words, float(score), segs))
                    if len(out) >= n:
                        break
                if len(out) >= n or len(r) < want:
                    return out
                want *= 4
            else:
                return out
        N = len(self.nodes)
        # Backward best-completion (bigram-approximate heuristic).
        h = np.full(N, -np.inf)
        order = sorted(range(N), key=lambda i: (self.nodes[i].sf, self.nodes[i].ef))
        for i in self._ends:
            node = self.nodes[i]
            s = self.final_ascr(node)
            if not self._is_finish(node):
                s += lw * self.lm.bg_score(node.lmwid, self.finish_lmwid)
            h[i] = s
        for i in reversed(order):
            node = self.nodes[i]
            for j in node.succs:
                m = self.nodes[j]
                if not np.isfinite(h[j]):
                    continue
                s = (self.edge_ascr(node, m)
                     + self._lm_term(-1, node.lmwid, m, lw) + h[j])
                h[i] = max(h[i], s)
        # A* over (partial path ending at node, history).
        heap = []
        cnt = 0
        for i in self._starts:
            node = self.nodes[i]
            g = self._lm_term(-1, start_lmwid, node, lw)
            hist = self._next_hist(-1, start_lmwid, node)
            heapq.heappush(heap, (-(g + h[i]), cnt, i, g, hist, None))
            cnt += 1
        out: List[Hypothesis] = []
        seen_texts = set()
        paths: List[Tuple] = []
        while heap and len(out) < n:
            negf, _, i, g, hist, parent = heapq.heappop(heap)
            node = self.nodes[i]
            entry = (i, g, hist, parent)
            paths.append(entry)
            pid = len(paths) - 1
            if not node.succs:
                s = g + self.final_ascr(node)
                if not self._is_finish(node):
                    s += lw * self.lm.tg_score(hist[0], hist[1], self.finish_lmwid)
                segs = []
                p = pid
                while p is not None:
                    pi, _, _, pparent = paths[p]
                    nn = self.nodes[pi]
                    segs.append(Segment(nn.word, nn.sf, nn.ef, 0.0))
                    p = pparent
                segs.reverse()
                words = []
                for seg in segs:
                    nn = self.nodes[self._node_by_seg(seg)]
                    if not nn.is_filler:
                        words.append(nn.base)
                text = " ".join(words)
                if text not in seen_texts:
                    seen_texts.add(text)
                    out.append(Hypothesis(words, float(s), segs))
                continue
            for j in node.succs:
                m = self.nodes[j]
                g2 = (g + self.edge_ascr(node, m)
                      + self._lm_term(hist[0], hist[1], m, lw))
                hist2 = self._next_hist(hist[0], hist[1], m)
                heapq.heappush(heap, (-(g2 + h[j]), cnt, j, g2, hist2, pid))
                cnt += 1
        return out

    # ------------------------------------------------------------------
    def sausage(self, ascale: float = 0.05):
        """Confusion network (sausage): posterior-weighted word slots in
        time order (sphinx4 result/SausageMaker.java + CLP lattice
        clustering capability, Mangu-style simplified).

        Returns a list of slots; each slot is a list of (word, prob) with
        probs summing to <= 1 (the remainder is the deletion/epsilon mass).
        Filler instances contribute to the epsilon mass.
        """
        post = np.exp(np.minimum(self.posterior(ascale), 0.0))
        # Cluster word instances by time overlap (greedy, time-ordered).
        order = sorted(range(len(self.nodes)),
                       key=lambda i: (self.nodes[i].sf, self.nodes[i].ef))
        slots: List[dict] = []
        spans: List[List[float]] = []
        for i in order:
            n = self.nodes[i]
            if n.is_filler:
                continue
            mid = 0.5 * (n.sf + n.ef)
            placed = False
            for k, (s0, s1) in enumerate(spans):
                if s0 <= mid <= s1:
                    # Same-word instances merge; different words compete.
                    slots[k][n.word] = slots[k].get(n.word, 0.0) + post[i]
                    spans[k][0] = min(s0, n.sf)
                    spans[k][1] = max(s1, n.ef)
                    placed = True
                    break
            if not placed:
                slots.append({n.word: float(post[i])})
                spans.append([float(n.sf), float(n.ef)])
        out = []
        for k in np.argsort([s[0] for s in spans]) if spans else []:
            total = sum(slots[k].values())
            norm = max(total, 1.0)
            out.append(sorted(((w, p / norm) for w, p in slots[k].items()),
                              key=lambda x: -x[1]))
        return out

    def consensus_hyp(self, ascale: float = 0.05,
                      eps_threshold: float = 0.5) -> Hypothesis:
        """Consensus decoding: best word per sausage slot, slots whose total
        mass is below eps_threshold are deleted."""
        words = []
        for slot in self.sausage(ascale):
            if not slot:
                continue
            w, p = slot[0]
            if sum(q for _, q in slot) >= eps_threshold:
                words.append(w)
        return Hypothesis(words, 0.0, [])

    # ------------------------------------------------------------------
    def word_confidence(self, segments, ascale: float = 0.05):
        """Backoff-LM word-posterior confidence (sphinx3
        libconfidence/confidence.c:1290 pwp / :1444 confidence_word_posterior
        capability): for each hypothesis segment, the posterior mass of the
        best time-overlapping lattice node with the same word, under the
        LM-weighted forward-backward.  Returns [(word, sf, ef, log_post)].
        """
        post = self.posterior(ascale)
        out = []
        for seg in segments:
            best = NEG
            for n in self.nodes:
                if n.word.lower() != seg.word.lower():
                    continue
                if n.ef < seg.start_frame or n.sf > seg.end_frame:
                    continue
                if np.isfinite(post[n.id]):
                    best = max(best, float(post[n.id]))
            out.append((seg.word, seg.start_frame, seg.end_frame,
                        min(best, 0.0)))
        return out

    # ------------------------------------------------------------------
    def write(self, path: str, uttid: str = "utt") -> None:
        """Sphinx lattice text format (ps_lattice.c:232-370)."""
        lb = math.log(self.logbase)
        with open(path, "w") as fh:
            fh.write("# getcwd: /\n")
            fh.write(f"# -logbase {self.logbase:g}\n")
            fh.write(f"Frames {self.n_frames}\n#\n")
            fh.write(f"Nodes {len(self.nodes)} (NODEID WORD STARTFRAME "
                     f"FIRST-ENDFRAME LAST-ENDFRAME)\n")
            for n in self.nodes:
                fh.write(f"{n.id} {n.word} {n.sf} {n.ef} {n.ef}\n")
            start = self._starts[0] if self._starts else 0
            end = max(self._ends, key=lambda i: self.nodes[i].ef) if self._ends else 0
            fh.write(f"Initial {start}\nFinal {end}\n")
            links = [(n.id, j) for n in self.nodes for j in n.succs]
            fh.write(f"Edges (FROM-NODEID TO-NODEID ASCORE)\n")
            for i, j in links:
                a = self.edge_ascr(self.nodes[i], self.nodes[j])
                fh.write(f"{i} {j} {int(a / lb)}\n")
            fh.write("End\n")

    def write_htk(self, path: str, uttid: str = "utt") -> None:
        """HTK SLF format (ps_lattice_write_htk)."""
        links = [(n.id, j) for n in self.nodes for j in n.succs]
        with open(path, "w") as fh:
            fh.write("VERSION=1.0\n")
            fh.write(f"UTTERANCE={uttid}\n")
            fh.write(f"N={len(self.nodes)}\tL={len(links)}\n")
            for n in self.nodes:
                fh.write(f"I={n.id}\tt={n.sf / 100.0:.2f}\tW={n.word}\t"
                         f"v={n.vit_score:.2f}\n")
            for k, (i, j) in enumerate(links):
                a = self.edge_ascr(self.nodes[i], self.nodes[j])
                fh.write(f"J={k}\tS={i}\tE={j}\ta={a:.2f}\tl=0.0\n")


class _FileScoreLM:
    """Stand-in LM for lattices whose LM scores live on the links (HTK
    SLF `l=` fields) rather than being recomputable: every n-gram query
    returns 0 so that bestpath/posterior/nbest score purely from the
    link weights (acoustic + lmscale*l folded into the edge)."""

    def word_id(self, w: str) -> int:
        return -1

    def tg_score(self, h1: int, h2: int, w: int) -> float:
        return 0.0

    def bg_score(self, h: int, w: int) -> float:
        return 0.0


import re as _re

_SLF_FIELD = _re.compile(r'(\S+?)=(?:"((?:[^\\"]|\\.)*)"|(\S+))')


def read_htk_lattice(path: str, lm=None, lw: float = 1.0,
                     log_wip: float = 0.0, frate: int = 100,
                     silprob: float = 0.005, fillprob: float = 1e-8,
                     finish_word: str = "</s>") -> "Lattice":
    """Read an HTK SLF lattice (the format the reference consumes in
    SphinxTrain/python/cmusphinx/lattice.py htk2dag and CLP/src/Lattice.cc)
    so sausage/posterior/bestpath/N-best run over externally produced
    lattices.  Round-trips `Lattice.write_htk`.

    Supported surface: `key=value` fields (quoted values allowed),
    header `N=/L=` or `NODES=/LINKS=` counts, optional `start=`/`end=`,
    `lmscale=`; node lines `I= t= [W=] [v=]`; link lines
    `J= S= E= [W=] [a=] [l=|n=]`.  Words may sit on nodes (our writer,
    sphinx convention) or on links (HTK convention — attached to the
    link's END node, matching how htk2dag-based consumers traverse).

    With lm=None the link `l=` scores (scaled by the header's lmscale)
    are folded into the edge weights and all n-gram queries return 0 —
    rescoring then reproduces the file's own path scores.  Passing an
    `lm` recomputes LM terms from it instead (lat_rescore.py capability).
    """
    header: Dict[str, str] = {}
    node_fields: Dict[int, Dict[str, str]] = {}
    link_fields: List[Dict[str, str]] = []
    state = "header"
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fields = {m.group(1): (m.group(2) if m.group(2) is not None
                                   else m.group(3))
                      for m in _SLF_FIELD.finditer(line)}
            if not fields:
                continue
            if "N" in fields or "NODES" in fields:
                state = "items"
                header.update(fields)
                continue
            if state == "header":
                header.update(fields)
            elif "I" in fields:
                node_fields[int(fields["I"])] = fields
            elif "J" in fields:
                link_fields.append(fields)
    n_nodes = int(header.get("N", header.get("NODES", len(node_fields))))
    lmscale = float(header.get("lmscale", 1.0))
    use_file_lm = lm is None
    if use_file_lm:
        lm = _FileScoreLM()
    silpen = math.log(silprob)
    fillpen = math.log(fillprob)
    finish_lmwid = lm.word_id(finish_word)

    words = [""] * n_nodes
    tframe = [0] * n_nodes
    for i, f in node_fields.items():
        tframe[i] = int(round(float(f.get("t", 0)) * frate))
        if "W" in f:
            words[i] = f["W"]
    edges: Dict[Tuple[int, int], float] = {}
    succs_t: Dict[int, List[int]] = {}
    for f in link_fields:
        s, e = int(f["S"]), int(f["E"])
        a = float(f.get("a", 0.0))
        l = float(f.get("n", f.get("l", 0.0)))
        if "W" in f and not words[e]:
            words[e] = f["W"]  # HTK word-on-link convention
        w = a + (lmscale * l if use_file_lm else 0.0)
        # Parallel links between the same node pair keep the best weight.
        if (s, e) not in edges or w > edges[(s, e)]:
            edges[(s, e)] = w
        succs_t.setdefault(s, []).append(e)
    maxt = max(tframe) if tframe else 0
    nodes: List[LatNode] = []
    for i in range(n_nodes):
        word = words[i] or "!NULL"
        sf = tframe[i]
        nxt = [tframe[j] for j in succs_t.get(i, [])]
        ef = (min(nxt) - 1) if nxt else maxt
        ef = max(ef, sf)
        lmwid = lm.word_id(word)
        is_fil = (word in ("<sil>", "<s>", "</s>", "!NULL", "!SENT_START",
                           "!SENT_END")
                  or word.startswith("++")
                  or (lmwid < 0 and not use_file_lm))
        fp = (0.0 if word in ("!NULL", "!SENT_START", "!SENT_END")
              else silpen if word in ("<sil>", "<s>", "</s>") else fillpen)
        if use_file_lm:
            fp = 0.0  # file scores carry everything
        nodes.append(LatNode(
            id=i, word=word, kidx=i, lmwid=lmwid, is_filler=bool(is_fil),
            fil_pen=fp, sf=sf, ef=ef, vit_score=0.0,
            rc_score=np.zeros(1), entry_score=0.0,
            is_finish=(word in (finish_word, "!SENT_END"))))
    lat = Lattice(nodes, np.zeros(n_nodes, np.int32),
                  np.zeros(n_nodes, np.int32), lm, lw, log_wip, 0,
                  finish_lmwid, maxt + 1, explicit_edges=edges)
    if "start" in header:
        lat._starts = [int(header["start"])]
    if "end" in header:
        lat._ends = [int(header["end"])]
    return lat


def read_lattice(path: str, lm, lw: float = 6.5, log_wip: float = -0.43,
                 silprob: float = 0.005, fillprob: float = 1e-8,
                 finish_word: str = "</s>") -> "Lattice":
    """Read a Sphinx text lattice back for offline rescoring
    (ps_lattice.c:409 ps_lattice_read; sphinx3 dag.c:1466 dag_load
    capability).  Edge acoustic scores come from the file (in logbase
    units); LM ids/fillers are resolved against `lm`:

    - words found in `lm` score with the trigram backoff chain;
    - `<sil>`, `<s>`, `</s>` and `++noise++`-style words are fillers with
      silence/filler penalties (ngram_search.c:645-650 semantics).
    """
    import math as _m
    nodes: List[LatNode] = []
    edges: Dict[Tuple[int, int], float] = {}
    logbase = 1.0001
    n_frames = 0
    silpen = _m.log(silprob)
    fillpen = _m.log(fillprob)
    finish_lmwid = lm.word_id(finish_word) if lm is not None else -1
    state = ""
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                if line.startswith("# -logbase"):
                    logbase = float(line.split()[-1])
                continue
            p = line.split()
            if p[0] == "Frames":
                n_frames = int(p[1])
            elif p[0] == "Nodes":
                state = "nodes"
            elif p[0] == "Initial" or p[0] == "Final":
                state = ""
            elif p[0] == "Edges":
                state = "edges"
            elif p[0] == "End":
                break
            elif state == "nodes":
                nid, word, sf, fef, lef = (int(p[0]), p[1], int(p[2]),
                                           int(p[3]), int(p[4]))
                lmwid = lm.word_id(word) if lm is not None else -1
                is_fil = (word in ("<sil>", "<s>", "</s>")
                          or word.startswith("++")) or lmwid < 0
                fp = silpen if word in ("<sil>", "<s>", "</s>") else fillpen
                while len(nodes) <= nid:
                    nodes.append(None)  # type: ignore
                nodes[nid] = LatNode(
                    id=nid, word=word, kidx=nid, lmwid=lmwid,
                    is_filler=bool(is_fil), fil_pen=fp, sf=sf, ef=lef,
                    vit_score=0.0, rc_score=np.zeros(1), entry_score=0.0,
                    is_finish=(word == finish_word))
            elif state == "edges":
                edges[(int(p[0]), int(p[1]))] = float(p[2]) * _m.log(logbase)
    assert all(n is not None for n in nodes), f"missing node ids in {path}"
    sil_ci = 0
    return Lattice(nodes, np.zeros(len(nodes), np.int32),
                   np.zeros(len(nodes), np.int32), lm, lw, log_wip, sil_ci,
                   finish_lmwid, n_frames, logbase=logbase,
                   explicit_edges=edges)
