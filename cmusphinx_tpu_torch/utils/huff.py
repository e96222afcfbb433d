"""Canonical Huffman coding (sphinxbase util/huff_code.c capability).

The reference uses this for experimental compressed LM dumps (DMP32).
Codes are CANONICAL: only the code lengths are stored/transmitted; the
actual codewords are reconstructed by assigning consecutive values within
each length, shortest first (huff_code.c canonical construction), so a
code table serializes as (symbol, length) pairs.

API: build from (symbol, frequency) pairs; encode a symbol sequence into
bytes; decode back.  Symbols may be ints or strings (the reference has
both huff_code_build_int and huff_code_build_str).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Sequence, Tuple


class HuffCode:
    def __init__(self, lengths: Dict[object, int]):
        """Build the canonical code from per-symbol code lengths."""
        if not lengths:
            raise ValueError("empty alphabet")
        self.lengths = dict(lengths)
        # Canonical assignment: sort by (length, symbol); codes count up,
        # shifting left at each length increase.
        items = sorted(self.lengths.items(), key=lambda kv: (kv[1], str(kv[0])))
        self.codes: Dict[object, Tuple[int, int]] = {}
        code, prev_len = 0, items[0][1]
        for sym, ln in items:
            code <<= (ln - prev_len)
            self.codes[sym] = (code, ln)
            code += 1
            prev_len = ln
        # Decode table: (length, first_code_at_length, symbols in order).
        self._by_len: Dict[int, Tuple[int, List[object]]] = {}
        for sym, (c, ln) in self.codes.items():
            if ln not in self._by_len:
                self._by_len[ln] = (c, [])
            first, syms = self._by_len[ln]
            self._by_len[ln] = (min(first, c), syms)
        for sym, (c, ln) in sorted(self.codes.items(),
                                   key=lambda kv: kv[1][0]):
            self._by_len[ln][1].append(sym)

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, freqs: Dict[object, int]) -> "HuffCode":
        """Huffman lengths from frequencies (ties broken deterministically)."""
        if not freqs:
            raise ValueError("empty alphabet")
        if len(freqs) == 1:
            return cls({next(iter(freqs)): 1})
        heap = [(f, i, {s: 0}) for i, (s, f) in
                enumerate(sorted(freqs.items(), key=lambda kv: str(kv[0])))]
        heapq.heapify(heap)
        n = len(heap)
        while len(heap) > 1:
            f1, _, d1 = heapq.heappop(heap)
            f2, _, d2 = heapq.heappop(heap)
            merged = {s: l + 1 for s, l in d1.items()}
            merged.update({s: l + 1 for s, l in d2.items()})
            n += 1
            heapq.heappush(heap, (f1 + f2, n, merged))
        return cls(heap[0][2])

    # ------------------------------------------------------------------
    def encode(self, symbols: Sequence) -> Tuple[bytes, int]:
        """-> (packed big-endian bitstream, total bit count)."""
        acc = 0
        nbits = 0
        for s in symbols:
            c, ln = self.codes[s]
            acc = (acc << ln) | c
            nbits += ln
        pad = (-nbits) % 8
        acc <<= pad
        return acc.to_bytes((nbits + pad) // 8 or 1, "big"), nbits

    def decode(self, data: bytes, nbits: int) -> List:
        """Decode `nbits` of a packed bitstream back to symbols."""
        out: List = []
        val = int.from_bytes(data, "big") >> ((8 * len(data)) - nbits
                                              if data else 0)
        bits = [(val >> (nbits - 1 - i)) & 1 for i in range(nbits)]
        code = 0
        ln = 0
        for b in bits:
            code = (code << 1) | b
            ln += 1
            ent = self._by_len.get(ln)
            if ent is None:
                continue
            first, syms = ent
            if first <= code < first + len(syms):
                out.append(syms[code - first])
                code, ln = 0, 0
        if ln:
            raise ValueError("trailing bits do not decode")
        return out

    # ------------------------------------------------------------------
    def write(self, fh) -> None:
        """Serialize as (symbol, length) lines — canonical codes need
        nothing else (huff_code_write capability, text form)."""
        fh.write(f"{len(self.lengths)}\n")
        for sym, ln in sorted(self.lengths.items(),
                              key=lambda kv: (kv[1], str(kv[0]))):
            fh.write(f"{sym!r} {ln}\n")

    @classmethod
    def read(cls, fh) -> "HuffCode":
        import ast
        n = int(fh.readline())
        lengths = {}
        for _ in range(n):
            line = fh.readline().rsplit(" ", 1)
            lengths[ast.literal_eval(line[0])] = int(line[1])
        return cls(lengths)
