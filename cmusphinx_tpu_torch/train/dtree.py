"""Senone decision trees: linguistic questions, tree building, pruning,
unseen-triphone senone assignment.

Capability parity with the SphinxTrain tree-tying stages (reference:
SphinxTrain/src/libs/libcommon/dtree.c tree build/prune, quest.c question
evaluation, programs bldtree "Build senonic decision trees from discrete
pdfs", make_quests (automatic question generation by clustering CI phone
distributions), prunetree, tiestate; pipeline stages 40.buildtrees ->
45.prunetree -> 50.cd_hmm_tied):

- **Questions** are sets of CI phones, applied to the left or right context
  (plus word-position identity questions).  Like make_quests, they are
  generated from data: bottom-up clustering of the CI phones' state
  distributions; every intermediate cluster on the merge path becomes a
  question, so questions capture phonetic classes (vowels/nasals/...) as
  they manifest acoustically, without a hand-written linguistics table.
- **Trees**: one per (base phone, state position).  Nodes split the
  triphone-state population by the question with the largest gain in
  single-Gaussian log likelihood (continuous analog of dtree.c's entropy
  criterion): L(set) = -0.5 * occ * sum_d log var_d; gain = L(yes) + L(no)
  - L(parent).
- **Pruning**: grow greedily, then prune the globally smallest-gain splits
  until the total leaf count meets the senone budget (prunetree).
- **Tying**: every leaf is a tied senone.  UNSEEN triphones descend the
  tree by answering the questions with their own contexts and receive the
  reached leaf's senone — the generalization the reference gets from
  tiestate + trees, which agglomerative merging cannot provide.

A copy of `cmusphinx_tpu/train/dtree.py` (numpy only, on the host);
tests/test_torch_host.py holds it to the original.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .trainer import HmmParams, VAR_FLOOR
from .pipeline import TriphoneInventory


# ----------------------------------------------------------------------
@dataclass
class Question:
    """A phone-set question applied to one context slot."""
    ctx: str                  # "lc" | "rc" | "wpos"
    phones: frozenset         # phone ids (or word positions for "wpos")

    def answer(self, lc: int, rc: int, wp: int) -> bool:
        v = {"lc": lc, "rc": rc, "wpos": wp}[self.ctx]
        return v in self.phones


def make_questions(mu: np.ndarray, var: np.ndarray, occ: np.ndarray,
                   max_questions: int = 0) -> List[frozenset]:
    """Automatic question generation (make_quests capability): cluster CI
    phones bottom-up by their pooled-state Gaussian distributions; every
    intermediate cluster is a question (a candidate phone class).

    mu/var: [n_phone, D] pooled single-Gaussian stats; occ: [n_phone].
    """
    P = mu.shape[0]
    occ = np.maximum(occ.astype(np.float64), 1e-3)
    clusters: List[Optional[set]] = [{p} for p in range(P)]
    stats = [(occ[p], mu[p].astype(np.float64),
              (var[p] + mu[p] ** 2).astype(np.float64)) for p in range(P)]
    questions: List[frozenset] = [frozenset({p}) for p in range(P)]

    def loss(a, b):
        oa, ma, ea = a
        ob, mb, eb = b
        o = oa + ob
        m = (oa * ma + ob * mb) / o
        v = np.maximum((oa * ea + ob * eb) / o - m * m, VAR_FLOOR)
        va = np.maximum(ea - ma * ma, VAR_FLOOR)
        vb = np.maximum(eb - mb * mb, VAR_FLOOR)
        return 0.5 * (o * np.log(v).sum() - oa * np.log(va).sum()
                      - ob * np.log(vb).sum())

    live = list(range(P))
    while len(live) > 1:
        best, bl = None, np.inf
        for x in range(len(live)):
            for y in range(x + 1, len(live)):
                l = loss(stats[live[x]], stats[live[y]])
                if l < bl:
                    best, bl = (live[x], live[y]), l
        i, j = best
        oa, ma, ea = stats[i]
        ob, mb, eb = stats[j]
        o = oa + ob
        merged = set(clusters[i]) | set(clusters[j])
        clusters.append(merged)
        stats.append((o, (oa * ma + ob * mb) / o, (oa * ea + ob * eb) / o))
        questions.append(frozenset(merged))
        live.remove(i)
        live.remove(j)
        live.append(len(clusters) - 1)
    # Drop the trivial all-phones question; dedupe.
    out = []
    seen = set()
    for q in questions:
        if len(q) == P or q in seen:
            continue
        seen.add(q)
        out.append(q)
    if max_questions and len(out) > max_questions:
        out = out[:max_questions]
    return out


# ----------------------------------------------------------------------
@dataclass
class TreeNode:
    question: Optional[Question] = None
    yes: Optional["TreeNode"] = None
    no: Optional["TreeNode"] = None
    leaf: int = -1            # tied senone id when a leaf
    gain: float = 0.0         # gain of this node's split
    items: List[int] = field(default_factory=list)  # entry rows (build time)

    @property
    def is_leaf(self) -> bool:
        return self.question is None


class SenoneTree:
    """One decision tree for a (base phone, state) population."""

    def __init__(self, entries_ctx: np.ndarray, occ: np.ndarray,
                 mu: np.ndarray, second: np.ndarray,
                 questions: Sequence[Question], min_occ: float = 1.0,
                 min_gain: float = 0.0):
        """entries_ctx: [N, 3] (lc, rc, wp) per seen triphone state;
        occ/mu/second: per-entry sufficient statistics."""
        self.questions = list(questions)
        self.occ = occ.astype(np.float64)
        self.mu = mu.astype(np.float64)
        self.second = second.astype(np.float64)
        self.ctx = entries_ctx
        self.min_occ = min_occ
        self.min_gain = min_gain
        self.root = TreeNode(items=list(range(len(occ))))
        self._grow(self.root)

    # -- statistics ----------------------------------------------------
    def _ll(self, items) -> Tuple[float, float]:
        o = self.occ[items].sum()
        if o <= 0:
            return 0.0, 0.0
        m = (self.occ[items, None] * self.mu[items]).sum(0) / o
        v = np.maximum((self.occ[items, None] * self.second[items]).sum(0)
                       / o - m * m, VAR_FLOOR)
        return -0.5 * o * np.log(v).sum(), o

    def _grow(self, node: TreeNode) -> None:
        items = node.items
        l_par, o_par = self._ll(items)
        if o_par < 2 * self.min_occ or len(items) < 2:
            return
        best_q, best_gain, best_split = None, self.min_gain, None
        for q in self.questions:
            yes = [i for i in items
                   if q.answer(self.ctx[i, 0], self.ctx[i, 1], self.ctx[i, 2])]
            if not yes or len(yes) == len(items):
                continue
            yes_set = set(yes)
            no = [i for i in items if i not in yes_set]
            ly, oy = self._ll(yes)
            ln, on = self._ll(no)
            if oy < self.min_occ or on < self.min_occ:
                continue
            gain = ly + ln - l_par
            if gain > best_gain:
                best_q, best_gain, best_split = q, gain, (yes, no)
        if best_q is None:
            return
        node.question = best_q
        node.gain = float(best_gain)
        node.yes = TreeNode(items=best_split[0])
        node.no = TreeNode(items=best_split[1])
        self._grow(node.yes)
        self._grow(node.no)

    # -- pruning ---------------------------------------------------------
    def _collect_prunable(self, node: TreeNode, out: List[TreeNode]) -> None:
        if node.is_leaf:
            return
        if node.yes.is_leaf and node.no.is_leaf:
            out.append(node)
        else:
            self._collect_prunable(node.yes, out)
            self._collect_prunable(node.no, out)

    def n_leaves(self, node: Optional[TreeNode] = None) -> int:
        node = node or self.root
        if node.is_leaf:
            return 1
        return self.n_leaves(node.yes) + self.n_leaves(node.no)

    def prune_one(self) -> bool:
        """Collapse the smallest-gain (leaf, leaf) split.  Returns False if
        the tree is a single leaf."""
        cands: List[TreeNode] = []
        self._collect_prunable(self.root, cands)
        if not cands:
            return False
        node = min(cands, key=lambda n: n.gain)
        node.items = node.yes.items + node.no.items
        node.question, node.yes, node.no = None, None, None
        return True

    def min_prunable_gain(self) -> float:
        cands: List[TreeNode] = []
        self._collect_prunable(self.root, cands)
        return min((n.gain for n in cands), default=np.inf)

    # -- assignment ------------------------------------------------------
    def classify(self, lc: int, rc: int, wp: int) -> TreeNode:
        node = self.root
        while not node.is_leaf:
            node = node.yes if node.question.answer(lc, rc, wp) else node.no
        return node

    def label_leaves(self, next_id: int) -> int:
        def walk(node):
            nonlocal next_id
            if node.is_leaf:
                node.leaf = next_id
                next_id += 1
            else:
                walk(node.yes)
                walk(node.no)
        walk(self.root)
        return next_id


# ----------------------------------------------------------------------
class SenoneForest:
    """All (base phone, state) trees + the tied senone assignment."""

    def __init__(self, trees: Dict[Tuple[int, int], SenoneTree],
                 n_ci_sen: int):
        self.trees = trees
        self.n_ci_sen = n_ci_sen
        self.n_leaves = 0

    def prune_to(self, total_leaves: int) -> None:
        """Global smallest-gain pruning across all trees (prunetree)."""
        while sum(t.n_leaves() for t in self.trees.values()) > total_leaves:
            best_key, best_gain = None, np.inf
            for key, t in self.trees.items():
                g = t.min_prunable_gain()
                if g < best_gain:
                    best_key, best_gain = key, g
            if best_key is None:
                break
            self.trees[best_key].prune_one()

    def label(self) -> int:
        """Assign tied senone ids (CI senones first, leaves after)."""
        nid = self.n_ci_sen
        for key in sorted(self.trees):
            nid = self.trees[key].label_leaves(nid)
        self.n_leaves = nid - self.n_ci_sen
        return nid

    def senone(self, b: int, s: int, lc: int, rc: int, wp: int) -> int:
        """Tied senone for ANY triphone state — seen or unseen (tiestate)."""
        t = self.trees.get((b, s))
        if t is None:
            return -1
        return t.classify(lc, rc, wp).leaf


def build_forest(inv: TriphoneInventory, params: HmmParams, occ: np.ndarray,
                 min_occ: float = 1.0, max_questions: int = 0
                 ) -> SenoneForest:
    """bldtree over the untied CD statistics: one tree per (base, state).

    params/occ: untied CD parameters + senone occupancies from the last
    Baum-Welch pass (occ may be [S, K] mixture counts or [S]).
    """
    n = inv.n_state
    occ_s = occ.sum(-1) if occ.ndim == 2 else occ
    w = np.exp(params.lnw)
    mu = (w[..., None] * params.means).sum(1)
    second = (w[..., None] * (params.var + params.means ** 2)).sum(1)

    # CI phone pooled stats for automatic question generation.
    nb = len(inv.base.phones)
    D = mu.shape[1]
    ci_mu = np.zeros((nb, D))
    ci_var = np.ones((nb, D))
    ci_occ = np.zeros(nb)
    for p in range(nb):
        sens = [inv.base.senone(p, s) for s in range(n)]
        o = np.maximum(occ_s[sens], 1e-3)
        ci_occ[p] = o.sum()
        ci_mu[p] = (o[:, None] * mu[sens]).sum(0) / o.sum()
        ci_var[p] = np.maximum((o[:, None] * second[sens]).sum(0) / o.sum()
                               - ci_mu[p] ** 2, VAR_FLOOR)
    phone_sets = make_questions(ci_mu, ci_var, ci_occ,
                                max_questions=max_questions)
    questions = ([Question("lc", q) for q in phone_sets]
                 + [Question("rc", q) for q in phone_sets]
                 + [Question("wpos", frozenset({w_})) for w_ in range(4)])

    trees: Dict[Tuple[int, int], SenoneTree] = {}
    by_base: Dict[int, List[int]] = {}
    for t, (b, lc, rc, wp) in enumerate(inv.tris):
        by_base.setdefault(b, []).append(t)
    for b, tids in by_base.items():
        ctx = np.asarray([[inv.tris[t][1], inv.tris[t][2], inv.tris[t][3]]
                          for t in tids], np.int64)
        for s in range(n):
            sens = [inv.senone(t, s) for t in tids]
            trees[(b, s)] = SenoneTree(
                ctx, occ_s[sens], mu[sens], second[sens], questions,
                min_occ=min_occ)
            # Remember the global senone row of each entry for stats reuse.
            trees[(b, s)].sen_rows = sens  # type: ignore[attr-defined]
    return SenoneForest(trees, inv.base.n_sen)


def tie_states_dtree(inv: TriphoneInventory, params: HmmParams,
                     occ: np.ndarray, total_leaves: int,
                     min_occ: float = 1.0
                     ) -> Tuple[np.ndarray, HmmParams, SenoneForest]:
    """bldtree + prunetree + tiestate: returns (smap old->new senone ids,
    tied parameters, the forest for unseen-triphone assignment).

    Tied senone parameters are the occupancy-weighted merge of the leaf's
    member senones' single-Gaussian stats broadcast over components (the
    tied model is then retrained by EM as in the reference's 50.cd_hmm_tied).
    """
    forest = build_forest(inv, params, occ, min_occ=min_occ)
    forest.prune_to(total_leaves)
    n_total = forest.label()

    S = inv.n_sen
    occ_s = occ.sum(-1) if occ.ndim == 2 else occ
    smap = np.arange(S, dtype=np.int64)
    K = params.means.shape[1]
    D = params.means.shape[2]
    means = np.zeros((n_total, K, D), np.float32)
    var = np.ones((n_total, K, D), np.float32)
    lnw = np.zeros((n_total, K), np.float32)
    counts = np.zeros(n_total)
    means[: inv.base.n_sen] = params.means[: inv.base.n_sen]
    var[: inv.base.n_sen] = params.var[: inv.base.n_sen]
    lnw[: inv.base.n_sen] = params.lnw[: inv.base.n_sen]
    counts[: inv.base.n_sen] = 1.0
    acc_m = np.zeros((n_total, K, D))
    acc_e = np.zeros((n_total, K, D))
    acc_w = np.zeros((n_total, K))
    for (b, s), tree in forest.trees.items():
        rows = tree.sen_rows  # type: ignore[attr-defined]
        for i, sen in enumerate(rows):
            leaf = tree.classify(tree.ctx[i, 0], tree.ctx[i, 1],
                                 tree.ctx[i, 2]).leaf
            smap[sen] = leaf
            o = max(float(occ_s[sen]), 1e-3)
            counts[leaf] += o
            acc_m[leaf] += o * params.means[sen]
            acc_e[leaf] += o * (params.var[sen] + params.means[sen] ** 2)
            acc_w[leaf] += o * np.exp(params.lnw[sen])
    tied_rows = counts > 0
    tied_rows[: inv.base.n_sen] = False
    c = np.maximum(counts[tied_rows, None, None], 1e-3)
    means[tied_rows] = (acc_m[tied_rows] / c).astype(np.float32)
    var[tied_rows] = np.maximum(
        acc_e[tied_rows] / c - (acc_m[tied_rows] / c) ** 2,
        VAR_FLOOR).astype(np.float32)
    wsum = np.maximum(acc_w[tied_rows].sum(-1, keepdims=True), 1e-10)
    lnw[tied_rows] = np.log(np.maximum(
        acc_w[tied_rows] / wsum, 1e-10)).astype(np.float32)
    tied = HmmParams(means=means, var=var, lnw=lnw, tp=params.tp)
    return smap, tied, forest
