"""Pronunciation dictionary.

Capability parity with dict.c (reference:
pocketsphinx/src/libpocketsphinx/dict.c:80 `dict_add_word`, :252-345
`dict_init`): word -> CI phone sequence, alternate pronunciations as
`word(2)`, a separate filler dictionary (noisedict), auto-added
`<s>` / `</s>` / `<sil>` mapped to SIL, case-insensitive lookup by default.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np

from .mdef import Mdef

START_WORD = "<s>"
FINISH_WORD = "</s>"
SILENCE_WORD = "<sil>"

_ALT_RE = re.compile(r"^(.*)\((\d+)\)$")


class Dictionary:
    def __init__(self, mdef: Optional[Mdef] = None, nocase: bool = True):
        self.mdef = mdef
        self.nocase = nocase
        self.words: List[str] = []          # full word strings (with (n))
        self.pron: List[List[int]] = []     # CI phone id sequences
        self.basewid: List[int] = []        # alt -> base word id
        self.next_alt: List[int] = []       # chain of alternates (-1 end)
        self._index: Dict[str, int] = {}
        self.filler_start = 0
        self.filler_end = -1
        self.lts = None                     # optional LtsModel OOV fallback

    # ------------------------------------------------------------------
    def _key(self, w: str) -> str:
        return w.lower() if self.nocase else w

    def wordid(self, w: str) -> int:
        return self._index.get(self._key(w), -1)

    def set_lts(self, lts) -> None:
        """Attach a letter-to-sound model used as OOV fallback
        (sphinx3 libdict/lts.c dict fallback capability)."""
        self.lts = lts

    def wordid_or_lts(self, w: str) -> int:
        """Dictionary lookup with LTS fallback: an OOV word whose LTS
        pronunciation resolves to known phones is added on the fly."""
        wid = self.wordid(w)
        if wid >= 0 or self.lts is None:
            return wid
        phones = self.lts.predict(w)
        if not phones or self.mdef is None:
            return -1
        if not all(p in self.mdef.ciphone_id for p in phones):
            return -1
        return self.add_word(w, phones)

    def basewordid(self, w: str) -> int:
        wid = self.wordid(w)
        return self.basewid[wid] if wid >= 0 else -1

    def word_str(self, wid: int) -> str:
        return self.words[wid]

    def base_str(self, wid: int) -> str:
        """Word string without the (n) alternate suffix."""
        return self.words[self.basewid[wid]]

    @property
    def n_word(self) -> int:
        return len(self.words)

    def is_filler(self, wid: int) -> bool:
        return (self.filler_start <= wid <= self.filler_end) or \
            self.words[self.basewid[wid]] in (START_WORD, FINISH_WORD, SILENCE_WORD)

    def add_word(self, word: str, phones: List[str] | List[int]) -> int:
        """Runtime word addition (dict_add_word)."""
        if phones and isinstance(phones[0], str):
            if self.mdef is None:
                raise ValueError("need an mdef to resolve phone names")
            pids = []
            for p in phones:
                pid = self.mdef.ciphone_id.get(p, -1)
                if pid < 0:
                    raise KeyError(f"phone {p!r} (word {word!r}) not in mdef")
                pids.append(pid)
        else:
            pids = [int(p) for p in phones]
        wid = len(self.words)
        self.words.append(word)
        self.pron.append(pids)
        m = _ALT_RE.match(word)
        if m and self._key(m.group(1)) in self._index:
            base = self._index[self._key(m.group(1))]
            self.basewid.append(base)
            # chain onto the base's alternate list
            self.next_alt.append(-1)
            w = base
            while self.next_alt[w] >= 0:
                w = self.next_alt[w]
            self.next_alt[w] = wid
        else:
            self.basewid.append(wid)
            self.next_alt.append(-1)
        self._index.setdefault(self._key(word), wid)
        return wid

    def alternates(self, wid: int) -> List[int]:
        """All word ids sharing this word's base (including itself)."""
        base = self.basewid[wid]
        out = [base]
        w = base
        while self.next_alt[w] >= 0:
            w = self.next_alt[w]
            out.append(w)
        return out

    # ------------------------------------------------------------------
    def _read_file(self, path: str, skip_bad: bool = True) -> None:
        with open(path, "r", errors="replace") as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#") or line.startswith(";;"):
                    continue
                parts = line.split()
                word, phones = parts[0], parts[1:]
                if not phones:
                    continue
                if self._key(word) in self._index and not _ALT_RE.match(word):
                    continue  # duplicate
                try:
                    self.add_word(word, phones)
                except KeyError as e:
                    if not skip_bad:
                        raise
                    # Reference warns and skips words with unknown phones.

    @classmethod
    def read(cls, dict_path: Optional[str], mdef: Optional[Mdef] = None,
             filler_path: Optional[str] = None, nocase: bool = True) -> "Dictionary":
        d = cls(mdef, nocase=nocase)
        if dict_path:
            d._read_file(str(dict_path))
        d.filler_start = d.n_word
        if filler_path:
            d._read_file(str(filler_path))
        sil = [mdef.sil] if (mdef and mdef.sil >= 0) else [0]
        for w in (START_WORD, FINISH_WORD, SILENCE_WORD):
            if d.wordid(w) < 0:
                d.add_word(w, sil)
        d.filler_end = d.n_word - 1
        return d

    # Convenience ids ---------------------------------------------------
    @property
    def startwid(self) -> int:
        return self.wordid(START_WORD)

    @property
    def finishwid(self) -> int:
        return self.wordid(FINISH_WORD)

    @property
    def silwid(self) -> int:
        return self.wordid(SILENCE_WORD)

    def first_phone(self, wid: int) -> int:
        return self.pron[wid][0]

    def last_phone(self, wid: int) -> int:
        return self.pron[wid][-1]

    def pronlen(self, wid: int) -> int:
        return len(self.pron[wid])
