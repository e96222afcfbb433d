"""Cross-word triphone lexicon graph: dense channel tables for one word list.

Replaces the reference's lexicon-tree + multiplexed root channels +
right-context fan-out (reference:
pocketsphinx/src/libpocketsphinx/ngram_search_fwdtree.c:67-149 mpx root
channels, ngram_search.c:534 ngram_search_alloc_all_rc,
dict2pid.h:133-180 ldiph_lc/lrdiph_rc/rssid compressed tables;
sphinx3/src/libs3decoder/libsearch/lextree.c composite cross-word
triphones) with a flat channel table designed for dense TPU evaluation:

- **mpx left contexts**: each word-begin channel is multiplexed — its senone
  sequence is an int payload (an "xs row" id) that rides the Viterbi argmax
  through the HMM states, switched at entry by the predecessor's final CI
  phone through a compressed lc->row table (`lcmap`).  This removes the
  per-left-context channel fan-out entirely (measured ~40 variants/word on
  hub4wsj — near-zero ssid sharing), exactly like the reference's mpx HMMs.
- **right contexts**, two modes:
  * ``fanout``: one channel per distinct word-final senone sequence over all
    right contexts (exact, the pocketsphinx alloc_all_rc analog), with a
    compressed per-word ``rssid[w, rc] -> variant`` table for readout — no
    [C, n_ci] masks.
  * ``composite``: ONE word-final channel whose per-state senone score is the
    max over all right-context variants' senones (the sphinx3 time-switch-
    tree composite-triphone approximation, srch_time_switch_tree.c /
    lextree.c composite ssids).  This is the scalable large-vocabulary mode:
    channels/word drops to ~(pron length + 1) and the per-frame exit readout
    is a single score per word.
- word-internal phones: one static channel each, chained by an edge list.
- single-phone words: mpx entry channels; in fanout mode one channel per
  distinct rc column of the (lc, rc) triphone grid (lrdiph_rc), in composite
  mode one channel whose lc->row table maps to composite-over-rc sets.

Senone lookup is factored through the **xs table**: a deduplicated list of
"extended senone sequences" — per state, a set of senone ids whose per-frame
score is the max over members (regular ssids are singleton sets).  Rows are
ordered singletons-first so the per-frame evaluation is two vectorized
gathers and a concat — `[scores[sing_sen]; max_u scores[comp_mem]]` — with
NO scatter/segment ops (TPU scatters serialize; gathers vectorize).  For the
same reason within-word propagation is a per-channel `prev_chan` gather
(every channel has in-degree <= 1 once word-begin channels are multiplexed),
not an edge-list scatter-max.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..models.dict import Dictionary
from ..models.dict2pid import (WPOS_BEGIN, WPOS_END, WPOS_INTERNAL,
                               WPOS_SINGLE, Dict2Pid)
from ..models.mdef import BAD_SENID, Mdef


@dataclass
class WordGraph:
    n_chan: int
    n_word: int
    n_ci: int
    n_emit_state: int
    rc_mode: str               # "fanout" | "composite"
    lc_mode: str               # "mpx" | "composite"
    lex_mode: str              # "flat" | "tree" (prefix-shared lexicon)
    # xs (extended senone sequence) table: rows [0, n_sing) are singletons
    # (<=1 member per state), rows [n_sing, n_sing+n_comp) are composites.
    n_xs: int
    n_sing: int
    sing_sen: np.ndarray       # [n_sing, S] senone id (0 if invalid)
    sing_valid: np.ndarray     # [n_sing, S] bool
    comp_mem: np.ndarray       # [n_comp, S, U] member senones (padded by dup)
    comp_valid: np.ndarray     # [n_comp, S] bool
    # per channel
    static_xs: np.ndarray      # [C] xs row used for non-entry activation
    tmat_idx: np.ndarray       # [C]
    word_of: np.ndarray        # [C] word index (ascending)
    is_entry: np.ndarray       # [C] bool (word-initial channel)
    lc_row: np.ndarray         # [C] row of lcmap for entry channels (0 else)
    lcmap: np.ndarray          # [n_lcrows, n_ci] -> xs row id
    ci_of: np.ndarray          # [C] base CI phone of the channel's phone
    # within-word propagation (in-degree <= 1: a gather, not an edge scatter)
    prev_chan: np.ndarray      # [C] source channel feeding this one (-1 none)
    # word exits
    exit_tab: np.ndarray       # [W, n_rcvar] exit channel ids (-1 pad)
    rssid: np.ndarray          # [W, n_ci] -> variant column of exit_tab
    n_rcvar: int
    # per word
    firstci: np.ndarray        # [W]
    lastci: np.ndarray         # [W]
    # tree mode only: static unigram-lookahead smear per channel —
    # la[c] = max over words whose pronunciation passes through c of
    # their unigram log-probability (0 for fillers/flat graphs).  The
    # search scales by lw and applies it incrementally (telescoping along
    # within-word propagation), then removes it exactly at word exit.
    la: Optional[np.ndarray] = None          # [C] logP_ug smear
    la_word: Optional[np.ndarray] = None     # [W] logP_ug at exit (0=filler)
    # tree mode: word-ordered contiguous exit-channel block start (-1 =
    # exits are not contiguous; use exit_tab gathers)
    exit_base: int = -1
    # composite rows partitioned into ascending power-of-two member-width
    # buckets (concatenation == comp_mem rows, truncated per bucket) —
    # the expansion's max-reduce runs per bucket (~6-8x less work than
    # the full padded width; member lists are ~5% dense)
    comp_groups: Optional[List[np.ndarray]] = None


class _XsTable:
    """Interning table for extended senone sequences."""

    def __init__(self, mdef: Mdef, S: int):
        self.mdef = mdef
        self.S = S
        self.bad = int(np.int32(np.uint16(BAD_SENID)))
        self._index: Dict[tuple, int] = {}
        self.rows: List[Tuple[Tuple[int, ...], ...]] = []
        self._ssid_cache: Dict[int, int] = {}

    def _intern(self, key: Tuple[Tuple[int, ...], ...]) -> int:
        r = self._index.get(key)
        if r is None:
            r = len(self.rows)
            self._index[key] = r
            self.rows.append(key)
        return r

    def of_ssid(self, ssid: int) -> int:
        r = self._ssid_cache.get(ssid)
        if r is None:
            sen = self.mdef.sseq[ssid]
            key = tuple((int(s),) if int(s) != self.bad else ()
                        for s in sen[: self.S])
            r = self._intern(key)
            self._ssid_cache[ssid] = r
        return r

    def of_composite(self, ssids: Sequence[int]) -> int:
        sen = self.mdef.sseq[np.asarray(sorted(set(int(s) for s in ssids)))]
        key = tuple(
            tuple(sorted(set(int(x) for x in sen[:, s] if int(x) != self.bad)))
            for s in range(self.S))
        return self._intern(key)

    def arrays(self):
        """Emit (perm, n_sing, sing_sen, sing_valid, comp_mem, comp_valid,
        comp_groups): rows reordered singletons-first, then composites by
        ascending member width so the max-reduce can run in power-of-two
        width BUCKETS (`comp_groups` = list of [ni, S, Ui] arrays whose
        concatenation along rows equals comp_mem truncated per bucket) —
        member lists are sparse (measured ~5% density at the full padded
        width at 5k words), so the bucketed reduce does ~6-8x less work.
        perm maps old row id -> new."""
        S = self.S
        is_sing = [all(len(mem) <= 1 for mem in row) for row in self.rows]

        def width(r):
            return max((len(mem) for mem in self.rows[r]), default=1)

        comp_rows = sorted((r for r, s in enumerate(is_sing) if not s),
                           key=width)
        order = [r for r, s in enumerate(is_sing) if s] + comp_rows
        perm = np.empty(len(self.rows), np.int32)
        perm[order] = np.arange(len(self.rows), dtype=np.int32)
        n_sing = sum(is_sing)
        sing_sen = np.zeros((max(n_sing, 1), S), np.int32)
        sing_valid = np.zeros((max(n_sing, 1), S), bool)
        comps = [self.rows[r] for r in comp_rows]
        U = max((len(mem) for row in comps for mem in row), default=1)
        comp_mem = np.zeros((max(len(comps), 1), S, U), np.int32)
        comp_valid = np.zeros((max(len(comps), 1), S), bool)
        for i, r in enumerate(order[:n_sing]):
            for s, mem in enumerate(self.rows[r]):
                if mem:
                    sing_sen[i, s] = mem[0]
                    sing_valid[i, s] = True
        for i, row in enumerate(comps):
            for s, mem in enumerate(row):
                if mem:
                    comp_mem[i, s, : len(mem)] = mem
                    comp_mem[i, s, len(mem):] = mem[0]
                    comp_valid[i, s] = True
        comp_groups: List[np.ndarray] = []
        lo = 0
        while lo < len(comps):
            w = max(max((len(mem) for mem in comps[lo]), default=1), 1)
            cap = 1
            while cap < w:
                cap *= 2
            hi = lo
            while hi < len(comps) and max(
                    (len(mem) for mem in comps[hi]), default=1) <= cap:
                hi += 1
            comp_groups.append(comp_mem[lo:hi, :, : min(cap, U)].copy())
            lo = hi
        if not comps:
            comp_groups = [comp_mem[:, :, :1].copy()]
        return (perm, n_sing, sing_sen, sing_valid, comp_mem, comp_valid,
                comp_groups)


def build_word_graph(dict_wids: Sequence[int], d: Dictionary, mdef: Mdef,
                     d2p: Dict2Pid, rc_mode: str = "fanout",
                     lc_mode: str = "mpx", lex_mode: str = "flat",
                     ug_lookahead: Optional[np.ndarray] = None) -> WordGraph:
    """Build the channel tables for `dict_wids` (search-vocabulary order).

    lc_mode="composite" replaces mpx word-begin channels with composite
    left-context triphones (per-state max over all left contexts' senones,
    the sphinx3 lextree composite-triphone treatment on the LEFT side,
    lextree.c / srch_time_switch_tree.c).  Every channel's senone sequence
    is then STATIC, which lets the large-vocabulary decode path precompute
    the whole [T, C, S] senone expansion frame-parallel instead of
    gathering per frame inside the scan.

    lex_mode="tree" shares word-prefix channels across words: interior
    channels are interned by the phone prefix THROUGH the lookahead phone
    (so each trie node has exactly one parent and `prev_chan` stays a
    gather), the final phone stays per-word (word identity resolved there,
    like the reference's tree where the last phone is excluded —
    ngram_search_fwdtree.c:67-149), and single-phone words keep their own
    channels.  Requires composite lc+rc (static senones, one exit variant).
    On cmu07a.dic (133k entries) this cuts channels 852k -> 382k, with
    169x sharing at the first phone and 15x at the second.  The word's LM
    score moves from entry (identity unknown at a shared root) to the exit
    readout; `ug_lookahead` ([W] unigram logP, 0 for fillers) provides the
    in-tree smear (sphinx3 lextree LM lookahead semantics)."""
    if lex_mode == "tree" and not (rc_mode == "composite"
                                   and lc_mode == "composite"):
        raise ValueError("lex_mode='tree' requires composite lc+rc")
    nci = mdef.n_ciphone
    S = mdef.max_emit_state
    W = len(dict_wids)
    xs = _XsTable(mdef, S)
    ssid_of = mdef.phone_ssid
    tmat_of = mdef.phone_tmat
    pid = d2p._pid

    static_xs: List[int] = []
    tmat_l: List[int] = []
    word_l: List[int] = []
    is_entry: List[bool] = []
    lc_row: List[int] = []
    prev_l: List[int] = []
    ci_of: List[int] = []
    exit_lists: List[List[int]] = [[] for _ in range(W)]
    rssid = np.zeros((W, nci), np.int16)
    firstci = np.zeros(W, np.int32)
    lastci = np.zeros(W, np.int32)

    # lcmap row interning.
    lc_index: Dict[tuple, int] = {}
    lc_rows: List[Tuple[int, ...]] = []

    def intern_lcrow(row: Sequence[int]) -> int:
        key = tuple(int(x) for x in row)
        r = lc_index.get(key)
        if r is None:
            r = len(lc_rows)
            lc_index[key] = r
            lc_rows.append(key)
        return r

    la_l: List[float] = []

    def add_chan(k: int, sxs: int, tmat: int, lcrow: int = 0,
                 entry: bool = False, prev: int = -1, base: int = 0) -> int:
        c = len(static_xs)
        static_xs.append(sxs)
        tmat_l.append(tmat)
        word_l.append(k)
        is_entry.append(entry)
        lc_row.append(lcrow)
        prev_l.append(prev)
        ci_of.append(base)
        la_l.append(-np.inf)
        return c

    tree = lex_mode == "tree"
    ugw = (np.asarray(ug_lookahead, np.float64) if ug_lookahead is not None
           else np.zeros(W))

    def smear(c: int, k: int) -> None:
        if la_l[c] < ugw[k]:
            la_l[c] = float(ugw[k])

    # Shared-structure caches (keyed by phone context, not word).
    begin_cache: Dict[Tuple[int, int], Tuple[int, int, int]] = {}
    end_cache: Dict[Tuple[int, int], tuple] = {}
    single_cache: Dict[int, tuple] = {}
    # Tree-mode channel interning: begin channels by initial diphone,
    # interior channels by phone prefix through the lookahead phone.
    # Exit channels are DEFERRED and materialized as one contiguous block
    # in word order after the trie, so the per-frame exit readout is a
    # SLICE ex[exit_base : exit_base + W] instead of W row-gathers.
    tree_begin: Dict[Tuple[int, int], int] = {}
    tree_int: Dict[Tuple[int, ...], int] = {}
    tree_pending: List[tuple] = []

    for k, wid in enumerate(dict_wids):
        phones = d.pron[wid]
        firstci[k] = phones[0]
        lastci[k] = phones[-1]
        if len(phones) == 1:
            b = int(phones[0])
            info = single_cache.get(b)
            if info is None:
                grid = np.empty((nci, nci), np.int64)
                for lc in range(nci):
                    for rc in range(nci):
                        grid[lc, rc] = pid(b, lc, rc, WPOS_SINGLE)
                tm = int(tmat_of[grid[d2p.sil, d2p.sil]])
                if rc_mode == "composite" and lc_mode == "composite":
                    # One fully-composite channel over the whole (lc, rc)
                    # grid: static senone sequence.
                    sxs = xs.of_composite(ssid_of[grid.reshape(-1)])
                    info = ("c", intern_lcrow([sxs] * nci), sxs, tm)
                elif rc_mode == "composite":
                    # One channel; lc row = composite-over-rc per lc.
                    row = [xs.of_composite(ssid_of[grid[lc]])
                           for lc in range(nci)]
                    info = ("c", intern_lcrow(row), row[d2p.sil], tm)
                elif lc_mode == "composite":
                    # Per-rc-variant channels, each composite over lc.
                    cols, inv = np.unique(grid.T, axis=0, return_inverse=True)
                    rows = []
                    for v in range(len(cols)):
                        sxs = xs.of_composite(ssid_of[cols[v]])
                        rows.append((intern_lcrow([sxs] * nci), sxs))
                    info = ("f", rows, inv.astype(np.int16), tm)
                else:
                    # One channel per distinct rc column (unique over rc of
                    # the lc->pid column vector) = lrdiph_rc variants.
                    cols, inv = np.unique(grid.T, axis=0, return_inverse=True)
                    rows = []
                    for v in range(len(cols)):
                        row = [xs.of_ssid(int(ssid_of[p])) for p in cols[v]]
                        rows.append((intern_lcrow(row), row[d2p.sil]))
                    info = ("f", rows, inv.astype(np.int16), tm)
                single_cache[b] = info
            if info[0] == "c":
                _, lcrow, sxs, tm = info
                if tree:
                    tree_pending.append((k, sxs, tm, lcrow, True, -1, b))
                    continue
                c = add_chan(k, sxs, tm, lcrow, entry=True, base=b)
                exit_lists[k].append(c)
                smear(c, k)
            else:
                _, rows, inv, tm = info
                for lcrow, sxs in rows:
                    c = add_chan(k, sxs, tm, lcrow, entry=True, base=b)
                    exit_lists[k].append(c)
                rssid[k] = inv
            continue

        # --- multi-phone word ---
        b, r = int(phones[0]), int(phones[1])
        info = begin_cache.get((b, r))
        if info is None:
            tab = [pid(b, lc, r, WPOS_BEGIN) for lc in range(nci)]
            if lc_mode == "composite":
                sxs = xs.of_composite(ssid_of[np.asarray(tab)])
                info = (intern_lcrow([sxs] * nci), sxs,
                        int(tmat_of[tab[d2p.sil]]))
            else:
                row = [xs.of_ssid(int(ssid_of[p])) for p in tab]
                info = (intern_lcrow(row), row[d2p.sil],
                        int(tmat_of[tab[d2p.sil]]))
            begin_cache[(b, r)] = info
        lcrow, sxs0, tm0 = info
        if tree:
            prev = tree_begin.get((b, r))
            if prev is None:
                prev = add_chan(k, sxs0, tm0, lcrow, entry=True, base=b)
                tree_begin[(b, r)] = prev
            smear(prev, k)
        else:
            prev = add_chan(k, sxs0, tm0, lcrow, entry=True, base=b)

        for i in range(1, len(phones) - 1):
            if tree:
                key = tuple(int(x) for x in phones[: i + 2])
                c = tree_int.get(key)
                if c is None:
                    p = pid(int(phones[i]), int(phones[i - 1]),
                            int(phones[i + 1]), WPOS_INTERNAL)
                    c = add_chan(k, xs.of_ssid(int(ssid_of[p])),
                                 int(tmat_of[p]), prev=prev,
                                 base=int(phones[i]))
                    tree_int[key] = c
                smear(c, k)
                prev = c
            else:
                p = pid(int(phones[i]), int(phones[i - 1]),
                        int(phones[i + 1]), WPOS_INTERNAL)
                prev = add_chan(k, xs.of_ssid(int(ssid_of[p])),
                                int(tmat_of[p]), prev=prev,
                                base=int(phones[i]))

        e, pe = int(phones[-1]), int(phones[-2])
        info = end_cache.get((e, pe))
        if info is None:
            tab = np.array([pid(e, pe, rc, WPOS_END) for rc in range(nci)],
                           np.int64)
            tm = int(tmat_of[tab[d2p.sil]])
            if rc_mode == "composite":
                info = ("c", xs.of_composite(ssid_of[tab]), tm)
            else:
                uniq, inv = np.unique(ssid_of[tab], return_inverse=True)
                info = ("f", [xs.of_ssid(int(u)) for u in uniq],
                        inv.astype(np.int16), tm)
            end_cache[(e, pe)] = info
        if info[0] == "c":
            _, sxs, tm = info
            if tree:
                tree_pending.append((k, sxs, tm, 0, False, prev, e))
                continue
            c = add_chan(k, sxs, tm, prev=prev, base=e)
            exit_lists[k].append(c)
            smear(c, k)
        else:
            _, sxss, inv, tm = info
            for sxs in sxss:
                exit_lists[k].append(add_chan(k, sxs, tm, prev=prev, base=e))
            rssid[k] = inv

    exit_base = -1
    if tree:
        # Materialize the word-ordered exit block (exactly one pending
        # entry per word, appended in word order by the loop above).
        assert len(tree_pending) == W
        exit_base = len(static_xs)
        for (k, sxs, tm, lcrow, entry, prev, base) in tree_pending:
            c = add_chan(k, sxs, tm, lcrow, entry=entry, prev=prev,
                         base=base)
            assert c == exit_base + k
            exit_lists[k].append(c)
            smear(c, k)

    n_rcvar = max((len(e) for e in exit_lists), default=1)
    exit_tab = np.full((W, n_rcvar), -1, np.int32)
    for k, lst in enumerate(exit_lists):
        exit_tab[k, : len(lst)] = lst

    (perm, n_sing, sing_sen, sing_valid, comp_mem, comp_valid,
     comp_groups) = xs.arrays()
    lcmap = (perm[np.asarray(lc_rows, np.int32)] if lc_rows
             else np.zeros((1, nci), np.int32))
    if tree:
        la_arr = np.asarray(la_l, np.float32)
        la_arr[~np.isfinite(la_arr)] = 0.0
        la_word = np.zeros(W, np.float32)
        for k, lst in enumerate(exit_lists):
            if lst:
                la_word[k] = la_arr[lst[0]]
    else:
        la_arr = la_word = None
    return WordGraph(
        n_chan=len(static_xs), n_word=W, n_ci=nci, n_emit_state=S,
        rc_mode=rc_mode, lc_mode=lc_mode, lex_mode=lex_mode,
        la=la_arr, la_word=la_word, exit_base=exit_base,
        n_xs=len(xs.rows), n_sing=n_sing,
        sing_sen=sing_sen, sing_valid=sing_valid,
        comp_mem=comp_mem, comp_valid=comp_valid,
        comp_groups=comp_groups,
        static_xs=perm[np.asarray(static_xs, np.int32)],
        tmat_idx=np.asarray(tmat_l, np.int32),
        word_of=np.asarray(word_l, np.int32),
        is_entry=np.asarray(is_entry, bool),
        lc_row=np.asarray(lc_row, np.int32),
        lcmap=lcmap,
        prev_chan=np.asarray(prev_l, np.int32),
        ci_of=np.asarray(ci_of, np.int32),
        exit_tab=exit_tab, rssid=rssid, n_rcvar=n_rcvar,
        firstci=firstci, lastci=lastci,
    )
