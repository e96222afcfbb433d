"""Phoenix task-grammar compiler (logios MakeGra capability).

Capability parity with logios/Tools/MakeGra (compile_gra.pl + the
phoenix_v0 grammar format): parse Phoenix `.gra` task grammars — the
dialog-system grammar front end the reference feeds into its language
compilation suite — into the repo's weighted CFG, from which the rest of
the logios pipeline already exists here: Cfg.to_fsg (grammar decoding),
sample_sentences (the corpus generator), cfg_to_ngram (MakeLM's
cfg2ngram stage, models/cfg.py).

Phoenix format (phoenix_v0/Example/Grammar/*.gra, MakeGra/doc):
- `[NetName]` flush-left opens a net (nonterminal); nets end at `;`.
- Indented `( tok tok ... )` lines are that net's alternative phrases.
- `UPPERNAME` flush-left inside a net block opens a net-local macro,
  with its own indented alternatives, usable in the net's phrases.
- Tokens: lowercase words = terminals; `[Net]` = net reference;
  `MACRO` = local macro reference; `*tok` marks the token optional;
  `+tok` marks it one-or-more (`*+tok`/`+*tok` = zero-or-more).
- `#` comments; `##...` banners ignored.

The `.forms` file lists the top-level nets (grammar entry points); the
compiled CFG's start symbol derives one top-level net per sentence.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from .cfg import Cfg

_NET_RE = re.compile(r"^\[([A-Za-z0-9_'-]+)\]\s*$")
_MACRO_RE = re.compile(r"^([A-Z][A-Z0-9_'-]*)\s*$")


class PhoenixGrammar:
    """Parsed Phoenix grammar: nets + per-net macros."""

    def __init__(self):
        # net name -> list of phrases; each phrase is a token list
        self.nets: Dict[str, List[List[str]]] = {}
        # (net, macro) -> phrases
        self.macros: Dict[Tuple[str, str], List[List[str]]] = {}
        self.net_order: List[str] = []

    @classmethod
    def parse(cls, text: str) -> "PhoenixGrammar":
        g = cls()
        net: Optional[str] = None
        macro: Optional[str] = None
        for raw in text.splitlines():
            line = raw.split("#", 1)[0].rstrip()
            if not line.strip():
                continue
            if line.strip() == ";":
                net = macro = None
                continue
            flush = not raw[:1].isspace()
            m = _NET_RE.match(line) if flush else None
            if m:
                net = m.group(1)
                macro = None
                g.nets.setdefault(net, [])
                g.net_order.append(net)
                continue
            m = _MACRO_RE.match(line.strip()) if flush else None
            if m and net is not None:
                macro = m.group(1)
                g.macros.setdefault((net, macro), [])
                continue
            body = line.strip()
            if body.startswith("(") and body.endswith(")"):
                toks = body[1:-1].split()
                if net is None:
                    continue
                if macro is not None:
                    g.macros[(net, macro)].append(toks)
                else:
                    g.nets[net].append(toks)
        return g

    @classmethod
    def parse_file(cls, path: str) -> "PhoenixGrammar":
        return cls.parse(open(path, errors="replace").read())

    # ------------------------------------------------------------------
    def to_cfg(self, forms: Optional[Sequence[str]] = None) -> Cfg:
        """Compile to the repo's weighted CFG.  `forms` selects the
        top-level nets (the .forms file contents); default: every net.
        Unresolved net references (imported from other .gra files of the
        domain) degrade to terminals of the same name, matching how
        MakeGra stubs dynamic classes in the abstracted grammar."""
        cfg = Cfg(start="$PHOENIX")
        tops = [f for f in (forms or self.net_order) if f in self.nets]
        for f in tops:
            cfg.add_rule("$PHOENIX", 1.0, [self._nt(f)])

        def emit_tokens(net: str, toks: List[str]) -> List[str]:
            out: List[str] = []
            for tok in toks:
                opt = rep = False
                while tok[:1] in "*+":
                    opt |= tok[0] == "*"
                    rep |= tok[0] == "+"
                    tok = tok[1:]
                if not tok:
                    continue
                base = self._resolve(net, tok, cfg)
                if rep:
                    # one-or-more (zero-or-more when also optional)
                    r = f"${net}__rep_{len(cfg.rules)}"
                    cfg.add_rule(r, 1.0, [base])
                    cfg.add_rule(r, 0.5, [base, r])
                    base = r
                if opt:
                    o = f"${net}__opt_{len(cfg.rules)}"
                    cfg.add_rule(o, 1.0, [])
                    cfg.add_rule(o, 1.0, [base])
                    base = o
                out.append(base)
            return out

        for net, phrases in self.nets.items():
            for toks in phrases:
                cfg.add_rule(self._nt(net), 1.0, emit_tokens(net, toks))
        for (net, macro), phrases in self.macros.items():
            for toks in phrases:
                cfg.add_rule(self._mnt(net, macro), 1.0,
                             emit_tokens(net, toks))
        return cfg

    @staticmethod
    def _nt(net: str) -> str:
        return f"$NET_{net}"

    @staticmethod
    def _mnt(net: str, macro: str) -> str:
        return f"$NET_{net}__{macro}"

    def _resolve(self, net: str, tok: str, cfg: Cfg) -> str:
        if tok.startswith("[") and tok.endswith("]"):
            name = tok[1:-1]
            if name in self.nets:
                return self._nt(name)
            return name.lower()        # unresolved import -> class stub
        if (net, tok) in self.macros:
            return self._mnt(net, tok)
        return tok.lower()


def read_forms(path: str) -> List[str]:
    """Parse a Phoenix .forms file: FUNCTION: blocks listing net names
    ([net] lines); returns the nets in order."""
    out = []
    for raw in open(path, errors="replace"):
        line = raw.split("#", 1)[0].strip()
        m = re.match(r"^\[([A-Za-z0-9_'-]+)\]$", line)
        if m:
            out.append(m.group(1))
    return out
