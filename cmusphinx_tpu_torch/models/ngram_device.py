"""Device-resident trigram LM lookup (port of
`cmusphinx_tpu/models/ngram_device.py` `DeviceNgram`).

Every backend is exact, and all give the same scores:

- **dense**: small vocabularies get a backoff-resolved trigram table
  `[V+1, V+1, V]`; index V in a history axis stands for "no context" (-1),
  and a lookup of any (h1, h2, w) is one gather.
- **CSR**: the LM's successor lists (`bg_ptr`, `bg_wid`, `bg_prob`,
  `bg_bo`, `tg_ptr`, `tg_wid`, `tg_prob`) as buffers, searched by a
  fixed-trip row-wise bisection (`_row_search`, `score_bg`, CSR
  `score_tg`).
- **score_rows**: whole score rows `[L, V]` for L histories, built by
  scattering the successor lists over the backed-off base row.
- **probe**: LMs with at most 16k bigrams + trigrams compare every query
  against every list entry (`score_tg_probe`).
- **hashed**: larger LMs get open-addressed tables of (key, key, payload)
  rows built on the host (`_pack_table`); a lookup is a fixed number of
  row gathers (`score_tg_hashed`).

`score_tg` routes a point query as the reference does, by the lane count
of one utterance's query, and counts each answer in `calls` so that a run
can show which backend served it.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import numpy as np
import torch
from torch import nn

from .ngram import NgramModel


def build_dense3(m: NgramModel) -> np.ndarray:
    """Host-side dense [V+1, V+1, V] fully backed-off trigram scores
    (the reference's `DeviceNgram._build_dense3`, in numpy)."""
    V = m.n_words
    ug = m.ug_prob.astype(np.float32)
    B = m.ug_bo.astype(np.float32)[:, None] + ug[None, :]    # bigram w/ backoff
    bg_w1 = np.repeat(np.arange(V), np.diff(m.bg_ptr))
    if len(m.bg_wid):
        B[bg_w1, m.bg_wid] = m.bg_prob
    T = np.empty((V + 1, V + 1, V), np.float32)
    T[:, V, :] = ug[None, :]                 # w2 = -1: unigram
    T[V, :V, :] = B                          # w1 = -1: bigram
    if m.n < 3 or len(m.tg_wid) == 0:
        T[:V, :V, :] = B[None, :, :]
    else:
        bo = np.zeros((V, V), np.float32)
        if len(m.bg_wid):
            bo[bg_w1, m.bg_wid] = m.bg_bo if len(m.bg_bo) else 0.0
        T[:V, :V, :] = bo[:, :, None] + B[None, :, :]
        tg_b = np.repeat(np.arange(len(m.bg_wid)), np.diff(m.tg_ptr))
        T[bg_w1[tg_b], m.bg_wid[tg_b], m.tg_wid] = m.tg_prob
    return T


def _row_search(data: torch.Tensor, lo, hi, key) -> torch.Tensor:
    """First index i in [lo, hi) with data[i] == key, else -1: a fixed-trip
    bisection (bisect_left) of every query lane over its own row of
    `data`, which is sorted within each row."""
    n = int(data.shape[0])
    n_iter = max(int(np.ceil(np.log2(max(n, 2)))) + 1, 1)
    lo, hi, key = torch.broadcast_tensors(lo.long(), hi.long(), key.long())
    l, h = lo, hi
    for _ in range(n_iter):
        m = (l + h) // 2
        go_right = data[m.clamp_max(n - 1)] < key
        l, h = torch.where(go_right, m + 1, l), torch.where(go_right, h, m)
    found = (l < hi) & (data[l.clamp_max(n - 1)] == key)
    return torch.where(found, l, -1)


# Backend routing thresholds of the reference's `score_tg`.
PROBE_MAX_ENTRIES = 16 << 10         # NB + NT for the probe tables
PROBE_MAX_WORK = 64 << 20            # lanes * (NB + NT) for one probe sweep
HASHED_MAX_LANES = 1 << 16


class DeviceNgram(nn.Module):
    """Trigram backoff scoring on `device` (see the module docstring).
    `calls` counts the answers of each backend: "dense", "probe",
    "hashed" and "csr" for `score_tg`, "rows" for `score_rows`."""

    # Load factor of the hashed tables (the reference's value, chosen for
    # its compile-payload cap; kept so both packages build the same tables).
    _HASH_LOAD = 0.6

    def __init__(self, m: NgramModel, *, device: torch.device | str = "cuda",
                 dense3_limit: int = 256 << 20):
        super().__init__()
        self.calls: Counter = Counter()
        V = self.V = m.n_words
        self.n = m.n
        self.NB, self.NT = len(m.bg_wid), len(m.tg_wid)

        def buf(name, a, dtype):
            a = np.asarray(a)
            if not len(a):
                a = np.zeros(1)
            self.register_buffer(
                name, torch.as_tensor(a).to(dtype).to(device), persistent=False)

        buf("ug_prob", m.ug_prob, torch.float32)
        buf("ug_bo", m.ug_bo, torch.float32)
        buf("bg_ptr", m.bg_ptr, torch.int64)                  # [V+1]
        buf("bg_wid", m.bg_wid, torch.int64)
        buf("bg_prob", m.bg_prob, torch.float32)
        buf("bg_bo", m.bg_bo if len(m.bg_bo) else np.zeros(self.NB),
            torch.float32)
        buf("tg_ptr", m.tg_ptr, torch.int64)                  # [NB+1]
        buf("tg_wid", m.tg_wid, torch.int64)
        buf("tg_prob", m.tg_prob, torch.float32)
        # Longest successor lists: the scatter widths of score_rows.
        self.MAXB = int(np.diff(m.bg_ptr).max()) if self.NB else 0
        self.MAXT = int(np.diff(m.tg_ptr).max()) if self.NT else 0
        dense = bool(V) and (V + 1) * (V + 1) * V * 4 <= dense3_limit
        self.register_buffer("tg_dense", torch.as_tensor(
            build_dense3(m)).to(device) if dense else None)
        self.probe = 0 < self.NB + self.NT <= PROBE_MAX_ENTRIES
        if self.probe:
            bg_w1 = np.repeat(np.arange(max(V, 1)), np.diff(m.bg_ptr))
            buf("_p_bg_w1", bg_w1, torch.int64)
            if self.NT:
                tg_b = np.repeat(np.arange(self.NB), np.diff(m.tg_ptr))
                buf("_p_tg_w1", bg_w1[tg_b], torch.int64)
                buf("_p_tg_w2", np.asarray(m.bg_wid)[tg_b], torch.int64)
        self.hashed = False
        if not self.probe and self.tg_dense is None and self.NB:
            self._build_hash(m, device)

    @classmethod
    def from_dense(cls, tg_dense, *, device: torch.device | str = "cuda"
                   ) -> "DeviceNgram":
        """Wrap an existing dense [V+1, V+1, V] table (dense backend only)."""
        tg = torch.as_tensor(tg_dense, dtype=torch.float32, device=device)
        V = tg.shape[-1]
        if tuple(tg.shape) != (V + 1, V + 1, V):
            raise ValueError(f"dense trigram table must be [V+1, V+1, V], "
                             f"got {tuple(tg.shape)}")
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self.calls = Counter()
        self.V = V
        self.probe = self.hashed = False
        self.register_buffer("tg_dense", tg)
        return self

    # -- hashed point-lookup backend ------------------------------------
    @staticmethod
    def _hash32(a: np.ndarray, b: np.ndarray, size: int) -> np.ndarray:
        """uint32-wraparound hash masked to 31 bits (host form)."""
        h = ((a.astype(np.uint64) * np.uint64(2654435761)
              + b.astype(np.uint64) * np.uint64(97))
             & np.uint64(0x7FFFFFFF))
        return (h % np.uint64(size)).astype(np.int64)

    @classmethod
    def _pack_table(cls, k1: np.ndarray, k2: np.ndarray, vals: np.ndarray):
        """Bulk linear-probe build of a [size + maxdisp + 1, 2 + n_vals] f32
        table (keys < 2^24, exact in f32).  Entries sorted by home slot take
        slot j_i = max(home_i, j_{i-1} + 1), and the table is padded past
        `size` instead of wrapping.  Returns (table, probe depth, size)."""
        n = len(k1)
        size = max(int(n / cls._HASH_LOAD), 8)
        home = cls._hash32(k1, k2, size)
        order = np.argsort(home, kind="stable")
        hs = home[order]
        ar = np.arange(n, dtype=np.int64)
        j = np.maximum.accumulate(hs - ar) + ar
        maxp = int((j - hs).max()) if n else 0
        tab = np.full((size + maxp + 1, 2 + vals.shape[1]), -1.0, np.float32)
        tab[j, 0] = k1[order]
        tab[j, 1] = k2[order]
        tab[j, 2:] = vals[order]
        return tab, maxp + 1, size

    def _build_hash(self, m: NgramModel, device) -> None:
        if self.V >= (1 << 24) or self.NB >= (1 << 24):
            return  # keys would not be exact in f32
        bg_w1 = np.repeat(np.arange(max(self.V, 1)),
                          np.diff(m.bg_ptr)).astype(np.int64)
        bg_bo = (np.asarray(m.bg_bo) if len(m.bg_bo)
                 else np.zeros(self.NB, np.float32))
        vals = np.stack([np.asarray(m.bg_prob), bg_bo,
                         np.arange(self.NB, dtype=np.float32)], axis=1)
        tab, self._hbg_probes, self._hbg_size = self._pack_table(
            bg_w1, np.asarray(m.bg_wid, np.int64), vals)
        self.register_buffer("_hbg", torch.as_tensor(tab).to(device),
                             persistent=False)
        tabt = None
        if self.NT:
            tg_b = np.repeat(np.arange(self.NB),
                             np.diff(m.tg_ptr)).astype(np.int64)
            tabt, self._htg_probes, self._htg_size = self._pack_table(
                tg_b, np.asarray(m.tg_wid, np.int64),
                np.asarray(m.tg_prob)[:, None])
            tabt = torch.as_tensor(tabt).to(device)
        self.register_buffer("_htg", tabt, persistent=False)
        self.hashed = True

    @staticmethod
    def _hash_find(tab: torch.Tensor, probes: int, size: int, k1, k2):
        """Open-address lookup -> (hit mask, [lanes, n_vals]).  The uint32
        hash of the reference is taken in int64: both keep the low 31 bits
        of the same sum, so the slot is the same (keys of -1 included)."""
        k1f, k2f = k1.float(), k2.float()
        h = (k1.long() * 2654435761 + k2.long() * 97) & 0x7FFFFFFF
        slot = h % size
        hit = torch.zeros(k1.shape, dtype=torch.bool, device=tab.device)
        out = torch.zeros(k1.shape + (tab.shape[1] - 2,), dtype=torch.float32,
                          device=tab.device)
        for p in range(probes):
            rows = tab[slot + p]
            m = (~hit) & (rows[..., 0] == k1f) & (rows[..., 1] == k2f)
            out = torch.where(m[..., None], rows[..., 2:], out)
            hit = hit | m
        return hit, out

    def score_tg_hashed(self, w1, w2, w3) -> torch.Tensor:
        """Exact trigram backoff through the hashed tables."""
        w1, w2, w3 = torch.broadcast_tensors(w1.long(), w2.long(), w3.long())
        w2c = w2.clamp_min(0)
        ug3 = self.ug_prob[w3.clamp_min(0)]
        h23, v23 = self._hash_find(self._hbg, self._hbg_probes,
                                   self._hbg_size, w2c, w3)
        bg23 = torch.where(w2 < 0, ug3,
                           torch.where(h23, v23[..., 0],
                                       self.ug_bo[w2c] + ug3))
        if self.n < 3 or self._htg is None:
            return bg23
        w1c = w1.clamp_min(0)
        h12, v12 = self._hash_find(self._hbg, self._hbg_probes,
                                   self._hbg_size, w1c, w2c)
        rowid = v12[..., 2].long()
        ht, vt = self._hash_find(self._htg, self._htg_probes, self._htg_size,
                                 torch.where(h12, rowid, -1), w3)
        s = torch.where(ht & h12, vt[..., 0],
                        torch.where(h12, v12[..., 1], 0.0) + bg23)
        return torch.where(w1 < 0, bg23, s)

    # -- CSR backend ----------------------------------------------------
    def _find_bg(self, w1, w2) -> torch.Tensor:
        """Bigram row index for (w1, w2), -1 if absent."""
        if self.NB == 0:
            return torch.full(torch.broadcast_shapes(w1.shape, w2.shape), -1,
                              dtype=torch.int64, device=self.bg_ptr.device)
        w1 = w1.long()
        return _row_search(self.bg_wid, self.bg_ptr[w1], self.bg_ptr[w1 + 1],
                           w2)

    def score_bg(self, w2, w3) -> torch.Tensor:
        """bg(w2, w3) with unigram backoff; w2 < 0 -> unigram."""
        w2, w3 = w2.long(), w3.long()
        w2c = w2.clamp_min(0)
        b = self._find_bg(w2c, w3)
        backoff = self.ug_bo[w2c] + self.ug_prob[w3]
        s = torch.where(b >= 0, self.bg_prob[b.clamp_min(0)], backoff)
        return torch.where(w2 < 0, self.ug_prob[w3], s)

    def score_rows(self, h1, h2) -> torch.Tensor:
        """Trigram score rows for L (h1, h2) histories: [L] -> [L, V].

        The backed-off base row, overwritten by h2's bigram successors,
        plus bo(h1, h2), overwritten by the (h1, h2) trigram successors;
        -1 histories back off.  Masked lanes scatter into column V, a
        dustbin that is dropped: only it ever receives duplicate indices,
        so the scatter's order on duplicates changes no kept value."""
        self.calls["rows"] += 1
        h1, h2 = h1.long(), h2.long()
        L, V = h1.shape[0], self.V
        h2c = h2.clamp_min(0)
        ug = self.ug_prob[None, :]
        base = torch.where(h2[:, None] >= 0, self.ug_bo[h2c][:, None] + ug,
                           ug)
        rows = torch.cat([base, base.new_zeros((L, 1))], 1)     # [L, V+1]
        if self.NB:
            lo, hi = self.bg_ptr[h2c], self.bg_ptr[h2c + 1]
            pos = lo[:, None] + torch.arange(self.MAXB, device=lo.device)
            ok = (pos < hi[:, None]) & (h2[:, None] >= 0)
            idx = pos.clamp_max(self.NB - 1)
            rows.scatter_(1, torch.where(ok, self.bg_wid[idx], V),
                          self.bg_prob[idx])
        if self.n >= 3 and self.NT:
            b = self._find_bg(h1.clamp_min(0), h2c)
            b = torch.where((h1 >= 0) & (h2 >= 0), b, -1)
            bc = b.clamp_min(0)
            rows = rows + torch.where(b >= 0, self.bg_bo[bc], 0.0)[:, None]
            lo, hi = self.tg_ptr[bc], self.tg_ptr[bc + 1]
            pos = lo[:, None] + torch.arange(self.MAXT, device=lo.device)
            ok = (pos < hi[:, None]) & (b[:, None] >= 0)
            idx = pos.clamp_max(self.NT - 1)
            rows.scatter_(1, torch.where(ok, self.tg_wid[idx], V),
                          self.tg_prob[idx])
        return rows[:, :V]

    # -- probe backend --------------------------------------------------
    def score_tg_probe(self, w1, w2, w3) -> torch.Tensor:
        """Exact trigram backoff by comparing every query lane with every
        bigram and trigram of the (small) LM."""
        w1, w2, w3 = torch.broadcast_tensors(w1.long(), w2.long(), w3.long())
        shp = w1.shape
        w1, w2, w3 = w1.reshape(-1), w2.reshape(-1), w3.reshape(-1)
        w2c = w2.clamp_min(0)
        ug3 = self.ug_prob[w3.clamp_min(0)]
        h23 = ((self._p_bg_w1[None, :] == w2[:, None])
               & (self.bg_wid[None, :] == w3[:, None]))
        p23 = torch.where(h23, self.bg_prob[None, :], 0.0).sum(1)
        bg23 = torch.where(w2 < 0, ug3,
                           torch.where(h23.any(1), p23, self.ug_bo[w2c] + ug3))
        if self.n < 3 or self.NT == 0:
            return bg23.reshape(shp)
        h12 = ((self._p_bg_w1[None, :] == w1[:, None])
               & (self.bg_wid[None, :] == w2[:, None]))
        bo12 = torch.where(h12, self.bg_bo[None, :], 0.0).sum(1)
        ht = ((self._p_tg_w1[None, :] == w1[:, None])
              & (self._p_tg_w2[None, :] == w2[:, None])
              & (self.tg_wid[None, :] == w3[:, None]))
        pt = torch.where(ht, self.tg_prob[None, :], 0.0).sum(1)
        s = torch.where(ht.any(1), pt, bo12 + bg23)
        return torch.where(w1 < 0, bg23, s).reshape(shp)

    # ------------------------------------------------------------------
    def backend(self, lanes: int) -> str:
        """The backend `score_tg` takes for a query of `lanes` lanes."""
        if self.tg_dense is not None:
            return "dense"
        if self.probe and lanes * (self.NB + self.NT) <= PROBE_MAX_WORK:
            return "probe"
        if self.hashed and lanes <= HASHED_MAX_LANES:
            return "hashed"
        return "csr"

    def score_tg(self, w1, w2, w3, lanes: Optional[int] = None
                 ) -> torch.Tensor:
        """Trigram backoff scores; w1 = -1 means bigram, w2 = -1 unigram.
        Shapes broadcast.  `lanes` is the lane count of one utterance's
        query, which picks the backend (default: the whole query's)."""
        if lanes is None:
            lanes = int(np.prod(torch.broadcast_shapes(
                w1.shape, w2.shape, w3.shape)))
        kind = self.backend(lanes)
        self.calls[kind] += 1
        if kind == "dense":
            i1 = torch.where(w1 < 0, self.V, w1).long()
            i2 = torch.where(w2 < 0, self.V, w2).long()
            i1, i2, i3 = torch.broadcast_tensors(i1, i2, w3.long())
            return self.tg_dense[i1, i2, i3]
        if kind == "probe":
            return self.score_tg_probe(w1, w2, w3)
        if kind == "hashed":
            return self.score_tg_hashed(w1, w2, w3)
        w1, w2, w3 = torch.broadcast_tensors(w1.long(), w2.long(), w3.long())
        bg23 = self.score_bg(w2, w3)
        if self.n < 3 or self.NT == 0:
            return bg23
        b = self._find_bg(w1.clamp_min(0), w2.clamp_min(0))
        bhit = b >= 0
        bc = b.clamp_min(0)
        t = _row_search(self.tg_wid, self.tg_ptr[bc], self.tg_ptr[bc + 1], w3)
        thit = bhit & (t >= 0)
        via_bo = torch.where(bhit, self.bg_bo[bc], 0.0) + bg23
        s = torch.where(thit, self.tg_prob[t.clamp_min(0)], via_bo)
        return torch.where(w1 < 0, bg23, s)
