"""Model definition: CI phones, triphones, senone sequence maps.

Reads both the binary BMDF format (reference:
pocketsphinx/src/libpocketsphinx/bin_mdef.c:334-520 `bin_mdef_read`) and the
text mdef format (reference: pocketsphinx/src/libpocketsphinx/mdef.c:99-538),
presenting one `Mdef` API:

- phone inventory: CI phones by name, triphones as (base, lc, rc, wpos);
- `phone_id(b, l, r, wpos)` triphone lookup with CI fallback;
- `sseq[n_sseq, max_emit_state]` senone-sequence table (uint16, BAD=0xffff);
- `phone_ssid[n_phone]`, `phone_tmat[n_phone]`;
- `cd2cisen`, `sen2cimap` senone maps.

The triphone index is stored as a python dict on host (decode-time lookups
are precompiled into dense arrays by dict2pid, not chased per frame).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

BAD_SSID = 0xFFFF
BAD_SENID = 0xFFFF

WPOS_NAMES = "ibesu"  # internal, begin, end, single, undefined (mdef.h word positions)


class Mdef:
    def __init__(self):
        self.n_ciphone = 0
        self.n_phone = 0
        self.n_emit_state = 0
        self.n_ci_sen = 0
        self.n_sen = 0
        self.n_tmat = 0
        self.n_sseq = 0
        self.ciname: List[str] = []
        self.ciphone_id: Dict[str, int] = {}
        self.sil = -1
        # Per-phone arrays [n_phone]
        self.phone_ssid: np.ndarray = np.zeros(0, np.int32)
        self.phone_tmat: np.ndarray = np.zeros(0, np.int32)
        # Triphone context [n_phone, 4]: base, lc, rc, wpos (-1 for CI rows)
        self.phone_ctx: np.ndarray = np.zeros((0, 4), np.int32)
        # Senone sequences [n_sseq, n_emit_state] uint16
        self.sseq: np.ndarray = np.zeros((0, 0), np.uint16)
        self.sseq_len: Optional[np.ndarray] = None
        self.cd2cisen: np.ndarray = np.zeros(0, np.int16)
        self.sen2cimap: np.ndarray = np.zeros(0, np.int16)
        self.ci_filler: Optional[np.ndarray] = None
        self._tri_index: Dict[Tuple[int, int, int, int], int] = {}

    # ------------------------------------------------------------------
    @classmethod
    def read(cls, path: str) -> "Mdef":
        with open(path, "rb") as fh:
            magic = fh.read(4)
        if magic in (b"BMDF", b"FDMB"):
            return cls.read_binary(path)
        return cls.read_text(path)

    @classmethod
    def read_binary(cls, path: str) -> "Mdef":
        m = cls()
        with open(path, "rb") as fh:
            data = fh.read()
        magic = data[:4]
        order = "<" if magic == b"BMDF" else ">"
        ver, hdrlen = struct.unpack(order + "ii", data[4:12])
        if ver > 1:
            raise ValueError(f"unsupported BMDF version {ver}")
        pos = 12 + hdrlen
        (m.n_ciphone, m.n_phone, m.n_emit_state, m.n_ci_sen, m.n_sen,
         m.n_tmat, m.n_sseq, n_ctx, n_cd_tree, sil) = struct.unpack(
            order + "10i", data[pos : pos + 40])
        pos += 40
        # CI phone names: n_ciphone NUL-terminated strings.
        for _ in range(m.n_ciphone):
            end = data.index(b"\0", pos)
            m.ciname.append(data[pos:end].decode())
            pos = end + 1
        m.ciphone_id = {n: i for i, n in enumerate(m.ciname)}
        m.sil = m.ciphone_id.get("SIL", sil)
        pos = (pos + 3) & ~3  # padding to 4-byte boundary
        # CD tree nodes: int16 ctx, int16 n_down, int32 pid/down.
        cd_tree = np.frombuffer(data, dtype=np.dtype(
            [("ctx", order + "i2"), ("n_down", order + "i2"), ("c", order + "i4")]),
            count=n_cd_tree, offset=pos)
        pos += 8 * n_cd_tree
        # Phone entries: int32 ssid, int32 tmat, int8 info[4].
        phones = np.frombuffer(data, dtype=np.dtype(
            [("ssid", order + "i4"), ("tmat", order + "i4"),
             ("wpos", "i1"), ("ctx", "i1", (3,))]), count=m.n_phone, offset=pos)
        pos += 12 * m.n_phone
        m.phone_ssid = phones["ssid"].astype(np.int32)
        m.phone_tmat = phones["tmat"].astype(np.int32)
        # For CI rows the first info byte is the filler flag (bin_mdef.h:79-84).
        m.ci_filler = phones["wpos"][: m.n_ciphone].astype(bool)
        sseq_size = struct.unpack(order + "i", data[pos : pos + 4])[0]
        pos += 4
        flat_sseq = np.frombuffer(data, dtype=order + "u2", count=sseq_size, offset=pos)
        pos += 2 * sseq_size
        if m.n_emit_state:
            m.sseq = flat_sseq.reshape(m.n_sseq, m.n_emit_state).astype(np.uint16)
        else:
            m.sseq_len = np.frombuffer(data, dtype="u1", count=m.n_sseq, offset=pos)
            max_len = int(m.sseq_len.max())
            m.sseq = np.full((m.n_sseq, max_len), BAD_SENID, np.uint16)
            o = 0
            for i, ln in enumerate(m.sseq_len):
                m.sseq[i, :ln] = flat_sseq[o : o + ln]
                o += ln

        m._decode_cd_tree(cd_tree)
        m._build_ctx_from_index()
        m._build_senone_maps()
        return m

    def _decode_cd_tree(self, cd_tree: np.ndarray) -> None:
        """Walk the compressed CD tree to recover the triphone index.

        Level order (bin_mdef.c:150-240 tree construction, :739
        bin_mdef_phone_id lookup): root = 4 word-position nodes, then CI
        phone, then left context, then right context (leaf carrying pid).
        Internal nodes with n_down == 0 are dead ends (c.pid == -1).
        """
        ctx = cd_tree["ctx"]
        n_down = cd_tree["n_down"]
        c = cd_tree["c"]
        for w in range(min(4, len(cd_tree))):
            wpos = int(ctx[w])
            ci0, nci = int(c[w]), int(n_down[w])
            for ci_node in range(ci0, ci0 + nci):
                b = int(ctx[ci_node])
                if int(n_down[ci_node]) == 0:
                    continue
                lc0, nlc = int(c[ci_node]), int(n_down[ci_node])
                for lc_node in range(lc0, lc0 + nlc):
                    lc = int(ctx[lc_node])
                    if int(n_down[lc_node]) == 0:
                        continue
                    rc0, nrc = int(c[lc_node]), int(n_down[lc_node])
                    for rc_node in range(rc0, rc0 + nrc):
                        rc = int(ctx[rc_node])
                        pid = int(c[rc_node])
                        if pid >= 0:
                            self._tri_index[(b, lc, rc, wpos)] = pid

    def _build_ctx_from_index(self) -> None:
        self.phone_ctx = np.full((self.n_phone, 4), -1, np.int32)
        for i in range(self.n_ciphone):
            self.phone_ctx[i, 0] = i
        for (b, lc, rc, wpos), pid in self._tri_index.items():
            self.phone_ctx[pid] = (b, lc, rc, wpos)

    def _build_senone_maps(self) -> None:
        """cd2cisen / sen2cimap as in bin_mdef.c:478-516."""
        self.cd2cisen = np.full(self.n_sen, -1, np.int16)
        self.cd2cisen[: self.n_ci_sen] = np.arange(self.n_ci_sen, dtype=np.int16)
        self.sen2cimap = np.full(self.n_sen, -1, np.int16)
        for pid in range(self.n_phone):
            ssid = self.phone_ssid[pid]
            ci = int(self.phone_ctx[pid, 0]) if pid >= self.n_ciphone else pid
            if ci < 0:
                continue
            n_st = self.n_emit_state or int(self.sseq_len[ssid])
            for j in range(n_st):
                s = int(self.sseq[ssid, j])
                if s == BAD_SENID:
                    continue
                if self.sen2cimap[s] == -1:
                    self.sen2cimap[s] = ci
                ci_ssid = self.phone_ssid[ci]
                self.cd2cisen[s] = self.sseq[ci_ssid, j]

    # ------------------------------------------------------------------
    @classmethod
    def read_text(cls, path: str) -> "Mdef":
        """Text mdef (mdef.c): version 0.3, counts, then per-phone lines
        `base lc rc wpos attrib tmat state-ids... N`."""
        m = cls()
        counts = {}
        rows = []
        with open(path, "r", errors="replace") as fh:
            lines = [ln.strip() for ln in fh if ln.strip() and not ln.strip().startswith("#")]
        it = iter(lines)
        version = next(it)
        if not version.startswith("0.3"):
            raise ValueError(f"unsupported text mdef version {version!r}")
        for ln in it:
            parts = ln.split()
            if len(parts) == 2 and parts[1] in (
                    "n_base", "n_tri", "n_state_map", "n_tied_state",
                    "n_tied_ci_state", "n_tied_tmat"):
                counts[parts[1]] = int(parts[0])
                continue
            rows.append(parts)
        m.n_ciphone = counts["n_base"]
        m.n_phone = counts["n_base"] + counts["n_tri"]
        m.n_sen = counts["n_tied_state"]
        m.n_ci_sen = counts["n_tied_ci_state"]
        m.n_tmat = counts["n_tied_tmat"]
        n_emit = (counts["n_state_map"] // m.n_phone) - 1 if m.n_phone else 0
        m.n_emit_state = n_emit

        ssid_map: Dict[Tuple[int, ...], int] = {}
        phone_ssid, phone_tmat, ctxs = [], [], []
        filler_names = set()
        for parts in rows:
            if parts[1] == "-" and parts[4] == "filler":
                filler_names.add(parts[0])
        for parts in rows:
            base, lc, rc, wpos, attrib, tmat = parts[:6]
            states = parts[6:]
            if states and states[-1] == "N":
                states = states[:-1]
            sseq = tuple(int(s) for s in states)
            if base not in m.ciphone_id and lc == "-":
                m.ciphone_id[base] = len(m.ciname)
                m.ciname.append(base)
        for parts in rows:
            base, lc, rc, wpos, attrib, tmat = parts[:6]
            states = parts[6:]
            if states and states[-1] == "N":
                states = states[:-1]
            sseq = tuple(int(s) for s in states)
            sid = ssid_map.setdefault(sseq, len(ssid_map))
            phone_ssid.append(sid)
            phone_tmat.append(int(tmat))
            b = m.ciphone_id[base]
            if lc == "-":
                ctxs.append((b, -1, -1, -1))
            else:
                wp = WPOS_NAMES.index(wpos) if wpos in WPOS_NAMES else 4
                ctxs.append((b, m.ciphone_id[lc], m.ciphone_id[rc], wp))
        m.n_sseq = len(ssid_map)
        m.phone_ssid = np.asarray(phone_ssid, np.int32)
        m.phone_tmat = np.asarray(phone_tmat, np.int32)
        m.phone_ctx = np.asarray(ctxs, np.int32)
        m.sseq = np.full((m.n_sseq, n_emit), BAD_SENID, np.uint16)
        for seq, sid in ssid_map.items():
            m.sseq[sid, : len(seq)] = seq
        for i, (b, lc, rc, wp) in enumerate(ctxs):
            if lc >= 0:
                m._tri_index[(b, lc, rc, wp)] = i
        m.ci_filler = np.asarray([n in filler_names for n in m.ciname], bool)
        m.sil = m.ciphone_id.get("SIL", -1)
        m._build_senone_maps()
        return m

    # ------------------------------------------------------------------
    def write_binary(self, path: str) -> None:
        """Write the BMDF binary format (reference layout:
        pocketsphinx/src/libpocketsphinx/bin_mdef.c:517-599 bin_mdef_write;
        cd-tree level order :148-250 — 4 word-position roots, then all CI
        nodes, then all left-context nodes, then right-context leaves).
        Round-trips through Mdef.read_binary and the reference reader."""
        n_ci = self.n_ciphone
        # Group triphones: (wpos, base) -> {lc: [(rc, pid), ...]}.
        groups: Dict[Tuple[int, int], Dict[int, List[Tuple[int, int]]]] = {}
        for (b, lc, rc, wpos), pid in self._tri_index.items():
            groups.setdefault((wpos, b), {}).setdefault(lc, []).append((rc, pid))
        # Level-order allocation (bin_mdef.c two-pass counter scheme).
        n_lc_total = sum(len(lcs) for lcs in groups.values())
        ci_start = 4
        lc_start = ci_start + 4 * n_ci
        rc_start = lc_start + n_lc_total
        n_rc_total = sum(len(rcl) for lcs in groups.values()
                         for rcl in lcs.values())
        n_nodes = rc_start + n_rc_total
        tree = np.zeros(n_nodes, dtype=np.dtype(
            [("ctx", "<i2"), ("n_down", "<i2"), ("c", "<i4")]))
        ci_idx, lc_idx, rc_idx = ci_start, lc_start, rc_start
        for wpos in range(4):
            tree[wpos] = (wpos, n_ci, ci_idx)
            for b in range(n_ci):
                lcs = groups.get((wpos, b), {})
                tree[ci_idx] = (b, len(lcs), lc_idx if lcs else -1)
                for lc in sorted(lcs):
                    rcl = sorted(lcs[lc])
                    tree[lc_idx] = (lc, len(rcl), rc_idx if rcl else -1)
                    for rc, pid in rcl:
                        tree[rc_idx] = (rc, 0, pid)
                        rc_idx += 1
                    lc_idx += 1
                ci_idx += 1
        # Phone entries (12 bytes each).
        phones = np.zeros(self.n_phone, dtype=np.dtype(
            [("ssid", "<i4"), ("tmat", "<i4"), ("b0", "i1"), ("b1", "i1"),
             ("b2", "i1"), ("b3", "i1")]))
        phones["ssid"] = self.phone_ssid
        phones["tmat"] = self.phone_tmat
        for i in range(n_ci):
            phones["b0"][i] = 1 if self.is_filler(i) else 0
        for i in range(n_ci, self.n_phone):
            b, lc, rc, wpos = self.phone_ctx[i]
            phones["b0"][i] = wpos
            phones["b1"][i] = b
            phones["b2"][i] = lc
            phones["b3"][i] = rc

        desc = (b"cmusphinx_tpu binary mdef file\n"
                b"(BMDF layout per pocketsphinx bin_mdef.c)\n\0")
        hdrlen = (len(desc) + 3) & ~3
        with open(path, "wb") as fh:
            fh.write(b"BMDF")
            fh.write(struct.pack("<ii", 1, hdrlen))
            fh.write(desc + b"\0" * (hdrlen - len(desc)))
            fh.write(struct.pack(
                "<10i", n_ci, self.n_phone, self.n_emit_state, self.n_ci_sen,
                self.n_sen, self.n_tmat, self.n_sseq, 3, n_nodes,
                self.sil if self.sil >= 0 else 0))
            for name in self.ciname:
                fh.write(name.encode() + b"\0")
            pad = (-fh.tell()) % 4
            fh.write(b"\0" * pad)
            fh.write(tree.tobytes())
            fh.write(phones.tobytes())
            if self.n_emit_state:
                sseq = self.sseq.astype("<u2")
                fh.write(struct.pack("<i", sseq.size))
                fh.write(sseq.tobytes())
            else:
                lens = np.asarray(self.sseq_len, np.uint8)
                flat = np.concatenate([
                    self.sseq[i, : lens[i]] for i in range(self.n_sseq)
                ]).astype("<u2")
                fh.write(struct.pack("<i", flat.size))
                fh.write(flat.tobytes())
                fh.write(lens.tobytes())

    def write_text(self, path: str) -> None:
        """Write the text mdef format (mdef.c / bin_mdef_write_text)."""
        with open(path, "w") as fh:
            fh.write("0.3\n")
            fh.write(f"{self.n_ciphone} n_base\n")
            fh.write(f"{self.n_phone - self.n_ciphone} n_tri\n")
            fh.write(f"{self.n_phone * (self.max_emit_state + 1)} n_state_map\n")
            fh.write(f"{self.n_sen} n_tied_state\n")
            fh.write(f"{self.n_ci_sen} n_tied_ci_state\n")
            fh.write(f"{self.n_tmat} n_tied_tmat\n")
            fh.write("#\n# Columns definitions\n#%4s %3s %3s %1s %6s %4s %s\n"
                     % ("base", "lft", "rt", "p", "attrib", "tmat",
                        "     ... state id's ..."))
            for p in range(self.n_phone):
                ssid = int(self.phone_ssid[p])
                states = [str(int(s)) for s in self.sseq[ssid]
                          if int(s) != BAD_SENID]
                if p < self.n_ciphone:
                    attr = "filler" if self.is_filler(p) else "n/a"
                    fh.write("%5s %3s %3s %1s %6s %4d %s N\n" % (
                        self.ciname[p], "-", "-", "-", attr,
                        int(self.phone_tmat[p]), " ".join(states)))
                else:
                    b, lc, rc, wpos = self.phone_ctx[p]
                    fh.write("%5s %3s %3s %1s %6s %4d %s N\n" % (
                        self.ciname[b], self.ciname[lc], self.ciname[rc],
                        WPOS_NAMES[wpos], "n/a",
                        int(self.phone_tmat[p]), " ".join(states)))

    # ------------------------------------------------------------------
    def phone_id(self, b: int, lc: int = -1, rc: int = -1, wpos: int = -1) -> int:
        """Triphone lookup with fallbacks as in bin_mdef_phone_id_nearest
        (bin_mdef.c:739-870): fillers in context map to SIL; exact triphone,
        then other word positions, then *silence contexts* (lc->SIL for
        begin/single, rc->SIL for end/single), and only then the CI phone."""
        if lc < 0 or rc < 0:
            return b
        if self.sil >= 0:
            if self.is_filler(lc):
                lc = self.sil
            if self.is_filler(rc):
                rc = self.sil

        def lookup(l, r):
            pid = self._tri_index.get((b, l, r, wpos), -1)
            if pid >= 0:
                return pid
            for wp in range(4):
                pid = self._tri_index.get((b, l, r, wp), -1)
                if pid >= 0:
                    return pid
            return -1

        pid = lookup(lc, rc)
        if pid >= 0:
            return pid
        # Back off cross-word contexts to silence (bin_mdef.c:838-860).
        if self.sil >= 0:
            newl, newr = lc, rc
            if wpos in (1, 3):      # begin / single
                newl = self.sil
            if wpos in (2, 3):      # end / single
                newr = self.sil
            if (newl, newr) != (lc, rc):
                pid = lookup(newl, newr)
                if pid >= 0:
                    return pid
        return b

    def is_filler(self, ci: int) -> bool:
        if self.ci_filler is not None and ci < len(self.ci_filler):
            return bool(self.ci_filler[ci])
        name = self.ciname[ci]
        return name == "SIL" or (name.startswith("+") and name.endswith("+"))

    @property
    def max_emit_state(self) -> int:
        return self.sseq.shape[1]

    def pid2ssid(self, pid: int) -> int:
        return int(self.phone_ssid[pid])

    def pid2ci(self, pid: int) -> int:
        return int(self.phone_ctx[pid, 0]) if pid >= self.n_ciphone else pid
