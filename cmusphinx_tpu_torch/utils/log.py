"""Leveled logging — err.h capability parity.

Reference: sphinxbase/include/sphinxbase/err.h:122-205 — E_INFO/E_WARN/
E_ERROR/E_FATAL/E_DEBUG(level) macros printing `LEVEL: "file", line: msg`,
redirectable to a file (err_set_logfile / -logfn), with a global debug level
(err_set_debug_level).  E_FATAL exits; here it raises.  A copy of
`cmusphinx_tpu/utils/log.py`.

Usage:
    from cmusphinx_tpu_torch.utils.log import E_INFO, E_WARN, E_ERROR, E_DEBUG
    E_INFO("loaded %d senones", n)
"""

from __future__ import annotations

import inspect
import os
import sys
import time
from typing import IO, Optional

_LEVELS = {"DEBUG": 0, "INFOCONT": 1, "INFO": 1, "WARN": 2, "ERROR": 3,
           "FATAL": 4}
_state = {
    "fh": None,          # Optional[IO]; None -> stderr
    "min_level": 1,      # suppress below this (err_set_loglevel)
    "debug_level": 0,    # E_DEBUG(level) printed iff level <= debug_level
}


class FatalError(RuntimeError):
    """Raised by E_FATAL (the reference exits the process)."""


def err_set_logfile(path: Optional[str]) -> None:
    """Redirect log output to a file (err.h err_set_logfile / -logfn)."""
    if _state["fh"] not in (None, sys.stderr):
        _state["fh"].close()
    _state["fh"] = open(path, "a") if path else None


def err_set_logfp(fh: Optional[IO]) -> None:
    _state["fh"] = fh


def err_set_loglevel(level: str) -> None:
    _state["min_level"] = _LEVELS[level.upper()]


def err_set_debug_level(level: int) -> int:
    old = _state["debug_level"]
    _state["debug_level"] = int(level)
    return old


def _emit(tag: str, fmt: str, *args, cont: bool = False) -> None:
    fh = _state["fh"] or sys.stderr
    msg = (fmt % args) if args else fmt
    if cont:
        fh.write(msg)
    else:
        frame = inspect.stack()[2]
        base = os.path.basename(frame.filename)
        fh.write(f"{tag}: \"{base}\", line {frame.lineno}: {msg}\n")
    fh.flush()


def E_DEBUG(level: int, fmt: str, *args) -> None:
    if level <= _state["debug_level"]:
        _emit("DEBUG", fmt, *args)


def E_INFO(fmt: str, *args) -> None:
    if _state["min_level"] <= 1:
        _emit("INFO", fmt, *args)


def E_INFOCONT(fmt: str, *args) -> None:
    """Continuation line without the file:line header (err.h E_INFOCONT)."""
    if _state["min_level"] <= 1:
        _emit("INFO", fmt, *args, cont=True)


def E_WARN(fmt: str, *args) -> None:
    if _state["min_level"] <= 2:
        _emit("WARN", fmt, *args)


def E_ERROR(fmt: str, *args) -> None:
    if _state["min_level"] <= 3:
        _emit("ERROR", fmt, *args)


def E_FATAL(fmt: str, *args) -> None:
    _emit("FATAL", fmt, *args)
    raise FatalError((fmt % args) if args else fmt)
