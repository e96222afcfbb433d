"""Code the harness finds by a name in `BENCHMARK.json` or a
configuration: `<kind>/<name>.py` beside this module (`kinds/` an
acoustic-model kind, `metrics/` a metric's reader), loaded from its file."""

from __future__ import annotations

import functools
import importlib.util
import os
from types import ModuleType

DIR = os.path.dirname(os.path.abspath(__file__))


def path(kind: str, name: str) -> str:
    return os.path.join(DIR, kind, name + ".py")


@functools.lru_cache(maxsize=None)
def load(kind: str, name: str) -> ModuleType:
    """The module of `name` under `kind/`; a name with no file fails at
    once, naming the path it looked for."""
    p = path(kind, name)
    if not os.path.isfile(p):
        raise LookupError(f"no {kind} file for {name!r}: {p} not found")
    sp = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", p)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod
