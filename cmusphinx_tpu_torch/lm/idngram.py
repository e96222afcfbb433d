"""Disk-scale id-n-gram counting: spill files + k-way merge.

Capability parity with cmuclmtk's larger-than-RAM pipeline (reference:
cmuclmtk/src/libs/ac_hash.c hash-file n-gram counting with temp-file
spills, src/programs/mergeidngram.c k-way merge of sorted idngram files,
lm_sort; SURVEY.md §2.5): corpora that do not fit in memory stream
through a bounded-size hash, overflowing to sorted binary spill files
that are merged with a heap — counting memory is O(max_ram_ngrams),
independent of corpus size.

File format (one file per n-gram order): little-endian records of
`n * uint32 word ids + uint64 count`, sorted lexicographically by ids
(the idngram convention).  `estimate_lm` consumes the merged counts
directly, applying cutoffs at load so the in-memory model tables stay
bounded by the *kept* n-gram count, not the corpus size.
"""

from __future__ import annotations

import heapq
import os
import struct
import tempfile
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

BOS, EOS, UNK = "<s>", "</s>", "<UNK>"


def _rec_dtype(n: int) -> np.dtype:
    return np.dtype([("ids", "<u4", (n,)), ("count", "<u8")])


def write_idngram(path: str, grams: Dict[Tuple[int, ...], int],
                  n: int) -> None:
    """Write one sorted idngram spill file."""
    arr = np.zeros(len(grams), dtype=_rec_dtype(n))
    for i, g in enumerate(sorted(grams)):
        arr[i]["ids"] = g
        arr[i]["count"] = grams[g]
    with open(path, "wb") as fh:
        fh.write(arr.tobytes())


def read_idngram(path: str, n: int,
                 chunk: int = 1 << 16) -> Iterator[Tuple[Tuple[int, ...], int]]:
    """Stream (gram, count) records from a sorted idngram file."""
    dt = _rec_dtype(n)
    with open(path, "rb") as fh:
        while True:
            buf = fh.read(dt.itemsize * chunk)
            if not buf:
                break
            arr = np.frombuffer(buf, dtype=dt)
            for rec in arr:
                yield tuple(int(x) for x in rec["ids"]), int(rec["count"])


def merge_idngram(paths: Sequence[str], out: str, n: int) -> int:
    """K-way merge of sorted idngram files, summing duplicate grams
    (mergeidngram capability).  Streams; O(k) memory.  Returns the number
    of distinct n-grams written."""
    streams = [read_idngram(p, n) for p in paths]
    merged = heapq.merge(*streams, key=lambda gc: gc[0])
    dt = _rec_dtype(n)
    ndistinct = 0
    with open(out, "wb") as fh:
        cur: Optional[Tuple[int, ...]] = None
        cnt = 0
        buf = []

        def flush_rec(g, c):
            nonlocal ndistinct
            rec = np.zeros(1, dtype=dt)
            rec[0]["ids"] = g
            rec[0]["count"] = c
            buf.append(rec.tobytes())
            ndistinct += 1
            if len(buf) >= 4096:
                fh.write(b"".join(buf))
                buf.clear()

        for g, c in merged:
            if g == cur:
                cnt += c
            else:
                if cur is not None:
                    flush_rec(cur, cnt)
                cur, cnt = g, c
        if cur is not None:
            flush_rec(cur, cnt)
        fh.write(b"".join(buf))
    return ndistinct


class DiskNgramCounter:
    """Bounded-memory n-gram counter (ac_hash capability): accumulate in a
    dict until `max_ram_ngrams` distinct grams are held across all orders,
    then spill each order to a sorted temp file; finalize() merges."""

    def __init__(self, n: int = 3, max_ram_ngrams: int = 2_000_000,
                 tmpdir: Optional[str] = None):
        self.n = n
        self.max_ram = max_ram_ngrams
        self.tmpdir = tmpdir or tempfile.mkdtemp(prefix="idngram_")
        os.makedirs(self.tmpdir, exist_ok=True)
        self._mem: List[Dict[Tuple[int, ...], int]] = [dict()
                                                       for _ in range(n)]
        self._spills: List[List[str]] = [[] for _ in range(n)]
        self._serial = 0

    def _held(self) -> int:
        return sum(len(d) for d in self._mem)

    def add_ids(self, ids: Sequence[Optional[int]]) -> None:
        """Count all 1..n-grams of one id sentence (None = context break)."""
        L = len(ids)
        for k in range(1, self.n + 1):
            d = self._mem[k - 1]
            for i in range(L - k + 1):
                gram = ids[i : i + k]
                if any(g is None for g in gram):
                    continue
                t = tuple(gram)
                d[t] = d.get(t, 0) + 1
        if self._held() >= self.max_ram:
            self.spill()

    def spill(self) -> None:
        for k in range(self.n):
            if not self._mem[k]:
                continue
            p = os.path.join(self.tmpdir,
                             f"spill.{k + 1}.{self._serial}.idngram")
            write_idngram(p, self._mem[k], k + 1)
            self._spills[k].append(p)
            self._mem[k] = dict()
        self._serial += 1

    def finalize(self) -> List[str]:
        """Merge spills; returns one merged idngram path per order."""
        self.spill()
        out = []
        for k in range(self.n):
            dst = os.path.join(self.tmpdir, f"merged.{k + 1}.idngram")
            merge_idngram(self._spills[k], dst, k + 1)
            for p in self._spills[k]:
                os.unlink(p)
            out.append(dst)
        return out


def count_ngrams_disk(sentences: Iterable[Sequence[str]],
                      vocab: Sequence[str], n: int = 3,
                      use_unk: bool = False,
                      max_ram_ngrams: int = 2_000_000,
                      tmpdir: Optional[str] = None
                      ) -> Tuple[List[str], List[str]]:
    """Disk-backed analog of estimate.count_ngrams: returns (merged idngram
    paths per order, wordlist).  Matches count_ngrams results exactly."""
    words = list(dict.fromkeys(([UNK] if use_unk else []) + [BOS, EOS]
                               + list(vocab)))
    wid = {w: i for i, w in enumerate(words)}
    ctr = DiskNgramCounter(n=n, max_ram_ngrams=max_ram_ngrams, tmpdir=tmpdir)
    unk = wid.get(UNK)
    for sent in sentences:
        ids: List[Optional[int]] = [wid[BOS]]
        for w in sent:
            ids.append(wid.get(w, unk))
        ids.append(wid[EOS])
        ctr.add_ids(ids)
    return ctr.finalize(), words


def load_idngram_counts(paths: Sequence[str],
                        cutoffs: Optional[Sequence[int]] = None
                        ) -> List[Dict[Tuple[int, ...], int]]:
    """Load merged idngram files into per-order dicts, dropping k-grams
    with count <= cutoffs[k-1] at load time (idngram2lm -cutoffs) so the
    resident size is the kept-model size."""
    out = []
    for k, p in enumerate(paths, start=1):
        cut = int(cutoffs[k - 1]) if cutoffs and k <= len(cutoffs) else 0
        d: Dict[Tuple[int, ...], int] = {}
        for g, c in read_idngram(p, k):
            if k == 1 or c > cut:
                d[g] = c
        out.append(d)
    return out


def train_lm_disk(sentences: Iterable[Sequence[str]], vocab: Sequence[str],
                  n: int = 3, discount: str = "good_turing",
                  cutoffs: Optional[Sequence[int]] = None,
                  use_unk: bool = False, max_ram_ngrams: int = 2_000_000,
                  tmpdir: Optional[str] = None):
    """One-call disk-scale pipeline: stream text -> spill/merge counts ->
    backoff LM.  `sentences` may be any (single-pass) iterable, so corpora
    larger than RAM stream from disk."""
    from .estimate import estimate_lm
    paths, words = count_ngrams_disk(sentences, vocab, n=n, use_unk=use_unk,
                                     max_ram_ngrams=max_ram_ngrams,
                                     tmpdir=tmpdir)
    counts = load_idngram_counts(paths, cutoffs)
    return estimate_lm(counts, words, discount=discount)


# ----------------------------------------------------------------------
# Fringe format tools (cmuclmtk/src/programs/{ngram2mgram,text2wngram,
# idngram2stats}.c capability).

def ngram_to_mgram(in_path: str, out_path: str, n: int, m: int) -> int:
    """Truncate a sorted id-n-gram file to its first-m-id prefixes, summing
    counts of grams sharing a prefix (ngram2mgram.c).  The input's
    lexicographic order makes equal prefixes adjacent, so this streams in
    O(1) memory.  Returns the number of distinct m-grams written."""
    if not 1 <= m < n:
        raise ValueError(f"need 1 <= m < n, got n={n} m={m}")
    dt = _rec_dtype(m)
    ndistinct = 0
    with open(out_path, "wb") as fh:
        cur: Optional[Tuple[int, ...]] = None
        cnt = 0
        buf: List[bytes] = []

        def flush_rec(g, c):
            nonlocal ndistinct
            rec = np.zeros(1, dtype=dt)
            rec[0]["ids"] = g
            rec[0]["count"] = c
            buf.append(rec.tobytes())
            ndistinct += 1
            if len(buf) >= 4096:
                fh.write(b"".join(buf))
                buf.clear()

        for g, c in read_idngram(in_path, n):
            p = g[:m]
            if p == cur:
                cnt += c
            else:
                if cur is not None:
                    flush_rec(cur, cnt)
                cur, cnt = p, c
        if cur is not None:
            flush_rec(cur, cnt)
        fh.write(b"".join(buf))
    return ndistinct


def text_to_wngram(sentences: Iterable[Sequence[str]], n: int = 3,
                   sent_markers: bool = False
                   ) -> List[Tuple[Tuple[str, ...], int]]:
    """Count word n-grams of a text stream and return them sorted
    alphabetically with counts (text2wngram.c output contract:
    `w1 ... wn count` lines in sorted order).  text2wngram treats the
    input as a flat word stream; sent_markers=True adds <s>/</s> per
    sentence (the pipeline's -sent_markers convention)."""
    counts: Dict[Tuple[str, ...], int] = {}
    stream: List[str] = []
    for sent in sentences:
        if sent_markers:
            stream.append(BOS)
        stream.extend(sent)
        if sent_markers:
            stream.append(EOS)
    for i in range(len(stream) - n + 1):
        g = tuple(stream[i : i + n])
        counts[g] = counts.get(g, 0) + 1
    return sorted(counts.items())


def idngram_stats(path: str, n: int, fof_size: int = 50
                  ) -> Tuple[int, int, np.ndarray]:
    """Frequency-of-frequency statistics of an idngram file
    (idngram2stats.c): returns (n_distinct, total_count, fof) where
    fof[c-1] = number of n-grams occurring exactly c times, c=1..fof_size."""
    fof = np.zeros(fof_size, np.int64)
    n_distinct = 0
    total = 0
    for _, c in read_idngram(path, n):
        n_distinct += 1
        total += c
        if 1 <= c <= fof_size:
            fof[c - 1] += 1
    return n_distinct, total, fof
