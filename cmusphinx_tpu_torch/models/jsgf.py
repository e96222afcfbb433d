"""JSGF grammar parser and FSG compiler.

Capability parity with sphinxbase jsgf (reference:
sphinxbase/src/libsphinxbase/lm/jsgf.c + flex/bison grammar
jsgf_scanner.l / jsgf_parser.y): parses JSpeech Grammar Format — rule
definitions, alternatives with /weights/, sequences, groups, optionals,
Kleene star/plus (jsgf.c:176 `jsgf_kleene_new`), rule references, <NULL>
and <VOID>, {tags} (ignored) — and compiles a chosen public rule to an
`FsgModel` with epsilon transitions (jsgf.c:445 `jsgf_build_fsg_internal`).

Implemented as a hand-written recursive-descent parser (no flex/bison):
a tokenizer plus one function per grammar production, compiling directly
to FSG states via Thompson-style construction.  Right-recursive rule
references compile to loops (matching the reference's rulestack behavior).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .fsg import FsgModel

_TOKEN_RE = re.compile(r"""
    (?P<comment>//[^\n]*|/\*.*?\*/)
  | (?P<weight>/[0-9.eE+\-]+/)
  | (?P<ruleref><[^>]+>)
  | (?P<quoted>"[^"]*")
  | (?P<tag>\{[^}]*\})
  | (?P<op>[()\[\]|;*+=])
  | (?P<token>[^\s()\[\]|;*+={}<>/"]+)
""", re.VERBOSE | re.DOTALL)


@dataclass
class _Atom:
    kind: str       # "token" | "ref" | "null" | "void" | "group" | "opt"
    value: object = None
    weight: float = 1.0
    repeat: str = ""  # "", "*", "+"


@dataclass
class _Alt:
    seq: List[_Atom]
    weight: float = 1.0


@dataclass
class Rule:
    name: str
    public: bool
    alts: List[_Alt]


class JsgfGrammar:
    def __init__(self, name: str):
        self.name = name
        self.rules: Dict[str, Rule] = {}
        self.imports: List[str] = []

    # ------------------------------------------------------------------
    @classmethod
    def parse(cls, text: str) -> "JsgfGrammar":
        toks = []
        for m in _TOKEN_RE.finditer(text):
            kind = m.lastgroup
            if kind == "comment":
                continue
            toks.append((kind, m.group()))
        p = _Parser(toks)
        return p.parse_grammar()

    @classmethod
    def parse_file(cls, path: str) -> "JsgfGrammar":
        with open(path, "r", errors="replace") as fh:
            return cls.parse(fh.read())

    def public_rules(self) -> List[Rule]:
        return [r for r in self.rules.values() if r.public]

    # ------------------------------------------------------------------
    def build_fsg(self, rule: Optional[str] = None, lw: float = 1.0) -> FsgModel:
        """Compile a rule (default: the single public rule) to an FsgModel."""
        if rule is None:
            pub = self.public_rules()
            if not pub:
                raise ValueError(f"grammar {self.name} has no public rules")
            r = pub[0]
        else:
            key = rule if rule.startswith("<") else f"<{rule}>"
            if key not in self.rules:
                raise KeyError(f"rule {key} not defined in {self.name}")
            r = self.rules[key]

        fsg = FsgModel(name=self.name, lw=lw)
        comp = _Compiler(self, fsg)
        entry, exit_ = comp.expand_rule(r)
        fsg.n_state = comp.nstate
        fsg.start_state = entry
        fsg.final_state = exit_
        return fsg


class _Parser:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect_op(self, op):
        k, v = self.next()
        if k != "op" or v != op:
            raise ValueError(f"expected {op!r}, got {v!r}")

    def parse_grammar(self) -> JsgfGrammar:
        name = "grammar"
        g = None
        while self.i < len(self.toks):
            k, v = self.peek()
            if k == "token" and v.startswith("#JSGF"):
                # consume until ';'
                while self.i < len(self.toks):
                    k2, v2 = self.next()
                    if k2 == "op" and v2 == ";":
                        break
                continue
            if k == "token" and v == "grammar":
                self.next()
                parts = []
                while True:
                    k2, v2 = self.next()
                    if k2 == "op" and v2 == ";":
                        break
                    parts.append(v2)
                name = "".join(parts)
                g = JsgfGrammar(name)
                continue
            if k == "token" and v == "import":
                self.next()
                while True:
                    k2, v2 = self.next()
                    if k2 == "op" and v2 == ";":
                        break
                    if g is not None and k2 == "ruleref":
                        g.imports.append(v2)
                continue
            if k == "token" and v == "public":
                self.next()
                self._parse_rule(g, public=True)
                continue
            if k == "ruleref":
                self._parse_rule(g, public=False)
                continue
            # Stray token (e.g. encoding line remnants) — skip.
            self.next()
        if g is None:
            raise ValueError("no 'grammar' declaration found")
        return g

    def _parse_rule(self, g: JsgfGrammar, public: bool) -> None:
        k, v = self.next()
        if k != "ruleref":
            raise ValueError(f"expected <rulename>, got {v!r}")
        rname = v
        self.expect_op("=")
        alts = self._parse_alternation(end_ops=(";",))
        self.expect_op(";")
        if g is None:
            raise ValueError("rule before grammar declaration")
        g.rules[rname] = Rule(rname, public, alts)

    def _parse_alternation(self, end_ops) -> List[_Alt]:
        alts = [self._parse_sequence(end_ops)]
        while True:
            k, v = self.peek()
            if k == "op" and v == "|":
                self.next()
                alts.append(self._parse_sequence(end_ops))
            else:
                break
        return alts

    def _parse_sequence(self, end_ops) -> _Alt:
        seq: List[_Atom] = []
        weight = 1.0
        first = True
        while True:
            k, v = self.peek()
            if k is None or (k == "op" and (v in end_ops or v == "|")):
                break
            self.next()
            if k == "weight":
                if first:
                    weight = float(v.strip("/"))
                continue
            if k == "tag":
                continue
            if k == "quoted":
                atom = _Atom("token", v.strip('"'))
            elif k == "ruleref":
                if v == "<NULL>":
                    atom = _Atom("null")
                elif v == "<VOID>":
                    atom = _Atom("void")
                else:
                    atom = _Atom("ref", v)
            elif k == "op" and v == "(":
                atom = _Atom("group", self._parse_alternation(end_ops=(")",)))
                self.expect_op(")")
            elif k == "op" and v == "[":
                atom = _Atom("opt", self._parse_alternation(end_ops=("]",)))
                self.expect_op("]")
            elif k == "token":
                atom = _Atom("token", v)
            else:
                raise ValueError(f"unexpected token {v!r}")
            # Postfix repeat operators.
            k2, v2 = self.peek()
            if k2 == "op" and v2 in ("*", "+"):
                self.next()
                atom.repeat = v2
            seq.append(atom)
            first = False
        return _Alt(seq, weight)


class _Compiler:
    def __init__(self, grammar: JsgfGrammar, fsg: FsgModel):
        self.g = grammar
        self.fsg = fsg
        self.nstate = 0
        self.stack: Dict[str, Tuple[int, int]] = {}  # active rule -> (entry, exit)

    def new_state(self) -> int:
        s = self.nstate
        self.nstate += 1
        return s

    def eps(self, a: int, b: int, logprob: float = 0.0) -> None:
        self.fsg.add_link(a, b, logprob, None)

    def expand_rule(self, rule: Rule) -> Tuple[int, int]:
        if rule.name in self.stack:
            # Recursive reference: link back to the active instance.
            return self.stack[rule.name]
        entry, exit_ = self.new_state(), self.new_state()
        self.stack[rule.name] = (entry, exit_)
        self._expand_alternation(rule.alts, entry, exit_)
        del self.stack[rule.name]
        return entry, exit_

    def _expand_alternation(self, alts: List[_Alt], entry: int, exit_: int) -> None:
        for alt in alts:
            lp = math.log(alt.weight) if alt.weight > 0 else -1e30
            node = self.new_state()
            self.eps(entry, node, lp)
            end = self._expand_sequence(alt.seq, node)
            if end is None:  # <VOID>
                continue
            self.eps(end, exit_)

    def _expand_sequence(self, seq: List[_Atom], node: int) -> Optional[int]:
        for atom in seq:
            if atom.kind == "void":
                return None
            if atom.kind == "null" and not atom.repeat:
                nxt = self.new_state()
                self.eps(node, nxt)
                node = nxt
                continue
            a_entry, a_exit = self._expand_atom_base(atom)
            if atom.repeat == "*":
                nxt = self.new_state()
                self.eps(node, nxt)        # skip
                self.eps(node, a_entry)    # take once
                self.eps(a_exit, a_entry)  # loop
                self.eps(a_exit, nxt)
                node = nxt
            elif atom.repeat == "+":
                nxt = self.new_state()
                self.eps(node, a_entry)
                self.eps(a_exit, a_entry)  # loop
                self.eps(a_exit, nxt)
                node = nxt
            else:
                self.eps(node, a_entry)
                node = a_exit
        return node

    def _expand_atom_base(self, atom: _Atom) -> Tuple[int, int]:
        if atom.kind == "token":
            a, b = self.new_state(), self.new_state()
            self.fsg.add_link(a, b, 0.0, str(atom.value))
            return a, b
        if atom.kind == "ref":
            name = str(atom.value)
            rule = self.g.rules.get(name)
            if rule is None:
                # Try qualified names from imports (local name match).
                for rn, r in self.g.rules.items():
                    if rn.rsplit(".", 1)[-1].strip("<>") == name.strip("<>"):
                        rule = r
                        break
            if rule is None:
                raise KeyError(f"undefined rule {name}")
            return self.expand_rule(rule)
        if atom.kind in ("group", "opt"):
            a, b = self.new_state(), self.new_state()
            self._expand_alternation(atom.value, a, b)
            if atom.kind == "opt":
                self.eps(a, b)
            return a, b
        if atom.kind == "null":
            a = self.new_state()
            return a, a
        raise ValueError(atom.kind)


def jsgf_read_file(path: str, rule: Optional[str] = None, lw: float = 1.0) -> FsgModel:
    """Convenience: parse a .gram file and compile to an FSG."""
    return JsgfGrammar.parse_file(path).build_fsg(rule, lw=lw)
