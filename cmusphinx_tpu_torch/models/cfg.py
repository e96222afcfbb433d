"""Context-free grammar engine: simple-CFG read, SRGS parse, CFG->FSG.

Capability parity with the sphinx3 libcfg component (reference:
sphinx3/src/libs3decoder/libcfg/s3_cfg.c:106 s3_cfg_read_simple — lines of
`score $SRC len item...` with '$'-prefixed nonterminals and $START as the
start symbol, include/s3_cfg.h:84-92; s3_cfg_srgs.c SRGS XML read/write;
s3_cfg_convert.c:24 s3_cfg_convert_to_fsg — regular approximation by
bounded recursive expansion of each rule into FSG states — and the
`cfg2fsg` program).

The TPU-side consumer is FsgSearch: a CFG/SRGS grammar compiles to an
FsgModel whose links become dense triphone channel tables, so grammar
decoding runs the same fused Viterbi scan as hand-written FSGs.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .fsg import FsgModel

NONTERM_PREFIX = "$"
START_SYMBOL = "$START"


@dataclass
class CfgRule:
    lhs: str                 # nonterminal ('$'-prefixed)
    score: float             # prior probability (linear, >= 0)
    rhs: List[str]           # items: terminals or nonterminals


class Cfg:
    """A weighted context-free grammar."""

    def __init__(self, start: str = START_SYMBOL):
        self.start = start
        self.rules: List[CfgRule] = []
        self._by_lhs: Dict[str, List[CfgRule]] = {}

    def add_rule(self, lhs: str, score: float, rhs: List[str]) -> None:
        if not lhs.startswith(NONTERM_PREFIX):
            raise ValueError(f"CFG rule source {lhs!r} is not a nonterminal")
        r = CfgRule(lhs, score, list(rhs))
        self.rules.append(r)
        self._by_lhs.setdefault(lhs, []).append(r)

    def productions(self, nt: str) -> List[CfgRule]:
        return self._by_lhs.get(nt, [])

    @property
    def nonterminals(self) -> List[str]:
        return list(self._by_lhs)

    # ------------------------------------------------------------------
    @classmethod
    def read_simple(cls, path: str) -> "Cfg":
        """Plain-CFG format (s3_cfg_read_simple): whitespace-separated
        stream of `score src n_items item1 ... itemN` records."""
        toks = open(path).read().split()
        g = cls()
        i = 0
        while i < len(toks):
            try:
                score = float(toks[i])
            except ValueError:
                break
            if score < 0:
                break
            lhs = toks[i + 1]
            n = int(toks[i + 2])
            rhs = toks[i + 3 : i + 3 + n]
            if len(rhs) != n:
                raise ValueError("truncated CFG production")
            g.add_rule(lhs, score, rhs)
            i += 3 + n
        return g

    def write_simple(self, path: str) -> None:
        with open(path, "w") as fh:
            for r in self.rules:
                fh.write(f"{r.score:g} {r.lhs} {len(r.rhs)} "
                         + " ".join(r.rhs) + "\n")

    # ------------------------------------------------------------------
    @classmethod
    def parse_srgs(cls, text: str) -> "Cfg":
        """Parse an SRGS XML grammar (s3_cfg_srgs.c capability).

        Supports <rule id scope>, <one-of>, <item weight repeat>,
        <ruleref uri="#name"> and special NULL/VOID/GARBAGE, <token>,
        <tag> (ignored), <example> (ignored).  The root rule comes from
        the <grammar root=...> attribute, else the first public rule.
        """
        import xml.etree.ElementTree as ET

        root = ET.fromstring(text)

        def tag(e) -> str:
            return e.tag.rsplit("}", 1)[-1]

        if tag(root) != "grammar":
            raise ValueError("SRGS document root must be <grammar>")
        g = cls()
        counter = [0]

        def fresh(base: str) -> str:
            counter[0] += 1
            return f"${base}#{counter[0]}"

        def nt_of(rule_id: str) -> str:
            return NONTERM_PREFIX + rule_id

        def emit_element(e, into: str) -> None:
            """Add productions so that nonterminal `into` derives e."""
            seqs = emit_sequence(e)
            for score, items in seqs:
                g.add_rule(into, score, items)

        def content_items(e) -> List[Tuple[float, List[str]]]:
            """Expand an element's mixed content into the cross-product of
            alternatives; returns [(score, items)]."""
            seqs: List[Tuple[float, List[str]]] = [(1.0, [])]

            def append_choices(choices: List[Tuple[float, List[str]]]):
                nonlocal seqs
                out = []
                for s0, items0 in seqs:
                    for s1, items1 in choices:
                        out.append((s0 * s1, items0 + items1))
                seqs = out

            def append_text(txt: Optional[str]):
                if txt and txt.split():
                    append_choices([(1.0, [w.lower() for w in txt.split()])])

            append_text(e.text)
            for child in e:
                t = tag(child)
                if t == "one-of":
                    nt = fresh("oneof")
                    emit_element(child, nt)
                    append_choices([(1.0, [nt])])
                elif t == "item":
                    choices = item_choices(child)
                    append_choices(choices)
                elif t == "ruleref":
                    special = child.get("special")
                    if special == "NULL":
                        pass  # derives epsilon
                    elif special in ("VOID", "GARBAGE"):
                        # VOID blocks the branch; GARBAGE unsupported ->
                        # treated as VOID (conservative).
                        append_choices([(1.0, ["$__void__"])])
                    else:
                        uri = child.get("uri", "")
                        if not uri.startswith("#"):
                            raise ValueError(
                                f"external ruleref {uri!r} not supported")
                        append_choices([(1.0, [nt_of(uri[1:])])])
                elif t in ("tag", "example", "meta", "metadata", "lexicon"):
                    pass
                elif t == "token":
                    append_text(child.text)
                else:
                    raise ValueError(f"unsupported SRGS element <{t}>")
                append_text(child.tail)
            return seqs

        def item_choices(item) -> List[Tuple[float, List[str]]]:
            """<item> content with weight/repeat applied."""
            weight = float(item.get("weight", "1.0"))
            seqs = content_items(item)
            rep = item.get("repeat")
            if rep:
                nt = fresh("rep")
                for s, items in seqs:
                    g.add_rule(nt, s, items)
                m = re.match(r"^\s*(\d+)\s*(?:-\s*(\d+)?)?\s*$", rep)
                if not m:
                    raise ValueError(f"bad repeat spec {rep!r}")
                lo = int(m.group(1))
                hi = m.group(2)
                unbounded = "-" in rep and hi is None
                star = fresh("star")
                if unbounded:
                    # star -> eps | nt star
                    g.add_rule(star, 1.0, [])
                    g.add_rule(star, 1.0, [nt, star])
                    return [(weight, [nt] * lo + [star])]
                hi = int(hi) if hi is not None else lo
                if hi < lo:
                    raise ValueError(f"bad repeat range {rep!r}")
                opt = fresh("opt")
                g.add_rule(opt, 1.0, [])
                g.add_rule(opt, 1.0, [nt])
                return [(weight, [nt] * lo + [opt] * (hi - lo))]
            return [(weight * s, items) for s, items in seqs]

        def emit_sequence(e) -> List[Tuple[float, List[str]]]:
            t = tag(e)
            if t == "one-of":
                out = []
                for child in e:
                    if tag(child) != "item":
                        raise ValueError("<one-of> children must be <item>")
                    out.extend(item_choices(child))
                return out
            return content_items(e)

        root_name = root.get("root")
        first_public = None
        for child in root:
            if tag(child) != "rule":
                continue
            rid = child.get("id")
            if rid is None:
                raise ValueError("<rule> without id")
            if first_public is None and child.get("scope", "private") == "public":
                first_public = rid
            emit_element(child, nt_of(rid))
        start_rule = root_name or first_public
        if start_rule is None:
            raise ValueError("SRGS grammar has no root and no public rule")
        g.add_rule(START_SYMBOL, 1.0, [nt_of(start_rule)])
        return g

    @classmethod
    def parse_srgs_file(cls, path: str) -> "Cfg":
        with open(path, errors="replace") as fh:
            return cls.parse_srgs(fh.read())

    # ------------------------------------------------------------------
    def to_fsg(self, name: str = "cfg", lw: float = 1.0,
               max_expansion: int = 2) -> FsgModel:
        """Regular approximation: expand productions into FSG states
        (s3_cfg_convert_to_fsg semantics, s3_cfg_convert.c:24-120): each
        nonterminal may be re-entered at most `max_expansion` times along
        one derivation path; deeper recursion branches are dropped.  Rule
        priors become transition log-probabilities; per-LHS scores are
        normalized to a distribution first.
        """
        fsg = FsgModel(name=name, lw=lw)
        n_state = [2]

        def new_state() -> int:
            n_state[0] += 1
            return n_state[0] - 1

        # Normalize per-LHS rule scores.
        norm: Dict[str, float] = {}
        for nt, rules in self._by_lhs.items():
            norm[nt] = sum(max(r.score, 0.0) for r in rules) or 1.0

        def expand(nt: str, src: int, dst: int,
                   counts: Dict[str, int]) -> None:
            if nt == "$__void__" or nt not in self._by_lhs:
                return  # dead end: no transitions -> branch blocked
            if counts.get(nt, 0) >= max_expansion:
                return
            counts = dict(counts)
            counts[nt] = counts.get(nt, 0) + 1
            for r in self.productions(nt):
                p = max(r.score, 1e-30) / norm[nt]
                lp = math.log(p)
                if not r.rhs:
                    fsg.add_link(src, dst, lp, None)
                    continue
                # Direct right/left recursion becomes an FSG LOOP (exact
                # for regular productions like `X -> a X | eps`), so
                # unbounded SRGS repeats need no expansion bound; only
                # center/mutual recursion is depth-bounded below.
                rhs = r.rhs
                cur, end = src, dst
                if len(rhs) > 1 and rhs[-1] == nt:
                    rhs, cur, end = rhs[:-1], src, src   # X -> alpha X
                elif len(rhs) > 1 and rhs[0] == nt:
                    rhs, cur, end = rhs[1:], dst, dst    # X -> X alpha
                for i, item in enumerate(rhs):
                    last = i == len(rhs) - 1
                    nxt = end if last else new_state()
                    ilp = lp if i == 0 else 0.0
                    if item.startswith(NONTERM_PREFIX):
                        if ilp != 0.0:
                            # carry the rule prior on an epsilon edge.
                            mid = new_state()
                            fsg.add_link(cur, mid, ilp, None)
                            cur = mid
                        expand(item, cur, nxt, counts)
                    else:
                        fsg.add_link(cur, nxt, ilp, item)
                    cur = nxt

        expand(self.start, 0, 1, {})
        fsg.n_state = n_state[0]
        fsg.start_state = 0
        fsg.final_state = 1
        _prune_dead_links(fsg)
        return fsg


def _prune_dead_links(fsg: FsgModel) -> None:
    """Drop links not on any start->final path (prune_states in
    s3_cfg_convert.c): forward reachability from the start state and
    backward from the final state over all links."""
    n = fsg.n_state
    fwd = [False] * n
    bwd = [False] * n
    fwd[fsg.start_state] = True
    bwd[fsg.final_state] = True
    changed = True
    while changed:
        changed = False
        for l in fsg.links:
            if fwd[l.from_state] and not fwd[l.to_state]:
                fwd[l.to_state] = True
                changed = True
            if bwd[l.to_state] and not bwd[l.from_state]:
                bwd[l.from_state] = True
                changed = True
    fsg.links = [l for l in fsg.links
                 if fwd[l.from_state] and bwd[l.to_state]]


# ---------------------------------------------------------------------------
def sample_sentences(cfg: "Cfg", n: int, seed: int = 0,
                     max_depth: int = 64) -> List[List[str]]:
    """Sample sentences from the weighted CFG (logios
    Tools/cfg2ngram/src capability: PCFG corpus generation for n-gram
    estimation).  Rules are drawn proportionally to their scores; deep
    recursions are re-drawn (bounded like the FSG conversion).
    """
    import random
    rng = random.Random(seed)
    out: List[List[str]] = []

    def gen(nt: str, depth: int) -> Optional[List[str]]:
        if depth > max_depth:
            return None
        rules = cfg.productions(nt)
        if not rules:
            raise ValueError(f"nonterminal {nt} has no productions")
        tot = sum(max(r.score, 0.0) for r in rules)
        x = rng.random() * (tot if tot > 0 else len(rules))
        acc = 0.0
        pick = rules[-1]
        for r in rules:
            acc += (max(r.score, 0.0) if tot > 0 else 1.0)
            if x <= acc:
                pick = r
                break
        sent: List[str] = []
        for item in pick.rhs:
            if item.startswith(NONTERM_PREFIX):
                sub = gen(item, depth + 1)
                if sub is None:
                    return None
                sent.extend(sub)
            else:
                sent.append(item)
        return sent

    attempts = 0
    while len(out) < n and attempts < 50 * n:
        attempts += 1
        s = gen(cfg.start, 0)
        if s:
            out.append(s)
    return out


def cfg_to_ngram(cfg: "Cfg", n: int = 3, samples: int = 10000,
                 seed: int = 0, discount: str = "witten_bell"):
    """cfg2ngram: sample a corpus from the PCFG and estimate an n-gram LM
    with the repo's cmuclmtk-parity estimator (logios cfg2ngram pipeline:
    grammar -> sampled corpus -> counts -> backoff LM)."""
    from ..lm.estimate import count_ngrams, estimate_lm
    sents = sample_sentences(cfg, samples, seed=seed)
    vocab = sorted({w for s in sents for w in s})
    counts, words = count_ngrams(sents, vocab, n=n)
    return estimate_lm(counts, words, discount=discount)
