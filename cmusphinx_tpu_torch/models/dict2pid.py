"""Cross-word triphone mapping.

Capability parity with dict2pid.c (reference:
pocketsphinx/src/libpocketsphinx/dict2pid.c, dict2pid.h:133-180): maps each
word's phone sequence to senone-sequence ids (ssids) with triphone context:

- word-internal phones: full triphone (lc = previous phone, rc = next phone,
  wpos 'i');
- word-begin phone: wpos 'b' with cross-word left context (ldiph_lc table);
- word-end phone: wpos 'e' with cross-word right context (rssid);
- single-phone words: wpos 's' with both cross-word contexts (lrdiph_rc).

Word positions index WPOS_NAMES = "ibesu" (mdef.py).  Unseen triphones fall
back to the CI phone (bin_mdef_phone_id_nearest behavior).

Precompiled host-side into numpy tables; decoders embed the resulting ssids
into dense channel arrays.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np

from .dict import Dictionary
from .mdef import Mdef

WPOS_INTERNAL = 0
WPOS_BEGIN = 1
WPOS_END = 2
WPOS_SINGLE = 3


class Dict2Pid:
    def __init__(self, mdef: Mdef, d: Dictionary):
        self.mdef = mdef
        self.dict = d
        self.sil = mdef.sil if mdef.sil >= 0 else 0

    @lru_cache(maxsize=None)
    def _pid(self, b: int, lc: int, rc: int, wpos: int) -> int:
        return self.mdef.phone_id(b, lc, rc, wpos)

    def word_pids(self, wid: int, lc: Optional[int] = None,
                  rc: Optional[int] = None) -> List[int]:
        """Triphone phone ids for a word given cross-word contexts
        (defaults: silence on both sides)."""
        phones = self.dict.pron[wid]
        lc = self.sil if lc is None else lc
        rc = self.sil if rc is None else rc
        n = len(phones)
        if n == 1:
            return [self._pid(phones[0], lc, rc, WPOS_SINGLE)]
        out = [self._pid(phones[0], lc, phones[1], WPOS_BEGIN)]
        for i in range(1, n - 1):
            out.append(self._pid(phones[i], phones[i - 1], phones[i + 1],
                                 WPOS_INTERNAL))
        out.append(self._pid(phones[-1], phones[-2], rc, WPOS_END))
        return out

    def word_ssids(self, wid: int, lc: Optional[int] = None,
                   rc: Optional[int] = None) -> List[int]:
        return [int(self.mdef.phone_ssid[p]) for p in self.word_pids(wid, lc, rc)]

    def word_tmats(self, wid: int, lc: Optional[int] = None,
                   rc: Optional[int] = None) -> List[int]:
        return [int(self.mdef.phone_tmat[p]) for p in self.word_pids(wid, lc, rc)]

    # ------------------------------------------------------------------
    # Dense cross-word tables (for the lextree N-gram decoder).
    def ldiph_lc_table(self, b: int, r: int) -> np.ndarray:
        """ssid for word-begin triphone (b, lc, r) for every left context lc
        (dict2pid.h ldiph_lc[b][r][l])."""
        n = self.mdef.n_ciphone
        out = np.zeros(n, np.int32)
        for lc in range(n):
            out[lc] = self.mdef.phone_ssid[self._pid(b, lc, r, WPOS_BEGIN)]
        return out

    def rc_ssids(self, b: int, lc: int) -> Tuple[np.ndarray, np.ndarray]:
        """Word-end right-context fan-out: unique ssids + rc->index map
        (dict2pid compressed rssid)."""
        n = self.mdef.n_ciphone
        ssids = np.zeros(n, np.int32)
        for rc in range(n):
            ssids[rc] = self.mdef.phone_ssid[self._pid(b, lc, rc, WPOS_END)]
        uniq, cimap = np.unique(ssids, return_inverse=True)
        return uniq.astype(np.int32), cimap.astype(np.int32)
