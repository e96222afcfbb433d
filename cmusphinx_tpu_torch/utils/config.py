"""Typed configuration system.

Capability parity with sphinxbase cmd_ln (reference:
sphinxbase/include/sphinxbase/cmd_ln.h:88-156): modules declare typed argument
tables (name / type / default / doc); a Config merges defaults, model-embedded
`feat.params` files (reference: pocketsphinx/src/libpocketsphinx/pocketsphinx.c:98-156
layers `-hmm`-dir defaults), and user overrides.  One Config object is threaded
through all constructors, as in the reference.

Keys are stored without the leading dash; lookups accept either form.
"""

from __future__ import annotations

import shlex
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional


@dataclass(frozen=True)
class Arg:
    """One typed argument declaration (analog of sphinxbase arg_t)."""

    name: str
    type: type  # bool, int, float, str
    default: Any
    doc: str = ""


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return bool(v)
    s = str(v).strip().lower()
    if s in ("yes", "true", "t", "y", "1", "on"):
        return True
    if s in ("no", "false", "f", "n", "0", "off"):
        return False
    raise ValueError(f"cannot parse boolean from {v!r}")


class Config:
    """A typed key/value store with registered argument tables."""

    def __init__(self, *tables: Iterable[Arg], **overrides: Any):
        self._args: Dict[str, Arg] = {}
        self._values: Dict[str, Any] = {}
        for table in tables:
            self.register(table)
        self.update(**overrides)

    @staticmethod
    def _norm(name: str) -> str:
        return name[1:] if name.startswith("-") else name

    def register(self, table: Iterable[Arg]) -> "Config":
        for arg in table:
            key = self._norm(arg.name)
            self._args[key] = arg
            self._values.setdefault(key, self._coerce(arg, arg.default))
        return self

    def _coerce(self, arg: Arg, value: Any) -> Any:
        if value is None:
            return None
        if arg.type is bool:
            return _parse_bool(value)
        return arg.type(value)

    def __contains__(self, name: str) -> bool:
        return self._norm(name) in self._values

    def __getitem__(self, name: str) -> Any:
        return self._values[self._norm(name)]

    def get(self, name: str, default: Any = None) -> Any:
        return self._values.get(self._norm(name), default)

    def __setitem__(self, name: str, value: Any) -> None:
        key = self._norm(name)
        arg = self._args.get(key)
        self._values[key] = self._coerce(arg, value) if arg else value

    def update(self, **kwargs: Any) -> "Config":
        for k, v in kwargs.items():
            self[k] = v
        return self

    def set_defaults(self, **kwargs: Any) -> "Config":
        """Set values only if they are still at their registered default (or absent)."""
        for k, v in kwargs.items():
            key = self._norm(k)
            arg = self._args.get(key)
            cur = self._values.get(key)
            if key not in self._values or (arg is not None and cur == self._coerce(arg, arg.default)):
                self[key] = v
        return self

    def update_from_file(self, path: str, only_default: bool = False) -> "Config":
        """Parse an arg-file fragment (`-key value` pairs), e.g. a model's feat.params.

        Reference behavior: pocketsphinx.c:156 merges the acoustic model's
        feat.params so frontend parameterization always matches the model.
        """
        with open(path, "r", errors="replace") as fh:
            tokens = shlex.split(fh.read(), comments=False)
        i = 0
        while i < len(tokens):
            tok = tokens[i]
            if tok.startswith("-") and len(tok) > 1 and not tok[1].isdigit():
                key = tok
                if i + 1 < len(tokens) and not (
                    tokens[i + 1].startswith("-") and len(tokens[i + 1]) > 1
                    and not tokens[i + 1][1].isdigit() and not _is_number(tokens[i + 1])
                ):
                    value = tokens[i + 1]
                    i += 2
                else:
                    value = "yes"
                    i += 1
                if only_default:
                    self.set_defaults(**{self._norm(key): value})
                else:
                    self[key] = value
            else:
                i += 1
        return self

    def copy(self) -> "Config":
        out = Config()
        out._args = dict(self._args)
        out._values = dict(self._values)
        return out

    def asdict(self) -> Dict[str, Any]:
        return dict(self._values)

    def __repr__(self) -> str:
        return f"Config({self._values!r})"


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False
