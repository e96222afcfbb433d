"""Mixture weight readers: `sendump` (quantized) and `mixture_weights` (s3).

sendump (reference: pocketsphinx/src/libpocketsphinx/s2_semi_mgau.c:889-1040
`read_sendump`): int32-length-prefixed title and header strings, key/value
strings until a zero length, optional legacy row/column ints, an optional
16-entry cluster codebook (4-bit quantization), then uint8 mixture-weight
arrays [n_feat][n_density][n_sen] (column-compressed to nibbles for 4-bit).

A byte m encodes the quantized negated log mixture weight:
m = (-log_b(w)) >> shift with b the logmath base (default 1.0001) and
shift = 10 (SENSCR_SHIFT, hmm.h:63).  We convert to natural-log float32:
ln w = -m * (1 << shift) * ln(b).

mixture_weights (reference: ms_senone.c:286 senone_init / s2_semi_mgau.c
read_mixw): s3 header then int32 n_sen, n_feat, n_comp, count and float32
weights [n_sen][n_feat][n_comp], normalized and floored on load.

Both return ln-domain weights shaped [n_feat, n_density, n_sen] float32 —
the layout the batched senone-scoring matmul wants.
"""

from __future__ import annotations

import math
import struct
from typing import Optional, Tuple

import numpy as np

from ..utils.bio import S3File

SENSCR_SHIFT = 10  # reference hmm.h:63


def read_sendump(path: str, logbase: float = 1.0001,
                 truncate: bool = True, return_raw: bool = False) -> np.ndarray:
    """Read a sendump file -> ln mixture weights [n_feat, n_density, n_sen].

    With return_raw=True, returns (weights, meta): the quantized uint8
    negated-log weights unscaled (the exact values the reference decoder
    computes with) and a dict with n_bits/logbase/shift."""
    with open(path, "rb") as fh:
        data = fh.read()

    def rd_i32(pos, swap):
        v = struct.unpack(("<" if not swap else ">") + "i", data[pos : pos + 4])[0]
        return v

    pos = 0
    n = rd_i32(pos, False)
    swap = not (1 <= n <= 999)
    if swap:
        n = rd_i32(pos, True)
        if not (1 <= n <= 999):
            raise ValueError(f"bad sendump title length {n}")
    pos += 4
    title = data[pos : pos + n].rstrip(b"\0").decode(errors="replace")
    pos += n
    n = rd_i32(pos, swap)
    pos += 4
    pos += n  # header string
    n_feat = n_density = n_sen = None
    n_clust, n_bits = 0, 8
    shift = SENSCR_SHIFT
    while True:
        n = rd_i32(pos, swap)
        pos += 4
        if n == 0:
            break
        line = data[pos : pos + n].rstrip(b"\0").decode(errors="replace")
        pos += n
        # Free-text lines share prefixes with the key/value ones; like the
        # reference's atoi we only honor lines whose value parses.
        for key in ("feature_count", "mixture_count", "model_count",
                    "cluster_count", "cluster_bits", "logbase", "mixw_shift"):
            if line.startswith(key + " "):
                try:
                    val = float(line[len(key) + 1:])
                except ValueError:
                    continue
                if key == "feature_count":
                    n_feat = int(val)
                elif key == "mixture_count":
                    n_density = int(val)
                elif key == "model_count":
                    n_sen = int(val)
                elif key == "cluster_count":
                    n_clust = int(val)
                elif key == "cluster_bits":
                    n_bits = int(val)
                elif key == "logbase":
                    logbase = float(val)
                elif key == "mixw_shift":
                    shift = int(val)
    cols = None
    if n_clust == 0:
        # Legacy layout: explicit rows/columns follow.  NOTE: the column
        # count may be PADDED past n_sen (s2_semi_mgau.c:92-107 "they might
        # be padded") — rows are strided by `c`, not n_sen.
        r = rd_i32(pos, swap)
        pos += 4
        c = rd_i32(pos, swap)
        pos += 4
        if n_density is None:
            n_density = r
        if n_sen is None:
            n_sen = c
        cols = c
    if cols is None:
        cols = n_sen
    if n_clust == 15:
        n_clust += 1
    if n_feat is None:
        # Infer from remaining size.
        step = cols if n_bits == 8 else (cols + 1) // 2
        n_feat = (len(data) - pos - n_clust) // (n_density * step)

    mixw_cb = None
    if n_clust:
        mixw_cb = np.frombuffer(data, np.uint8, n_clust, pos)
        pos += n_clust

    step = cols if n_bits == 8 else (cols + 1) // 2
    raw = np.frombuffer(data, np.uint8, n_feat * n_density * step, pos)
    raw = raw.reshape(n_feat, n_density, step)
    if n_bits == 8:
        raw = raw[:, :, :n_sen]
    if n_bits == 4:
        # Unpack nibbles: LOW nibble = even senone, HIGH = odd
        # (s2_semi_mgau.c get_scores_4b_feat_*: cw = x & 0xf when (n&1)==0,
        # x >> 4 when odd).
        hi = (raw >> 4).astype(np.uint8)
        lo = (raw & 0x0F).astype(np.uint8)
        un = np.empty((n_feat, n_density, step * 2), np.uint8)
        un[:, :, 0::2] = lo
        un[:, :, 1::2] = hi
        raw = un[:, :, :n_sen]  # also trims any column padding
        raw = mixw_cb[raw]  # dequantize through the codebook

    if return_raw:
        return np.ascontiguousarray(raw), {
            "n_bits": n_bits, "logbase": logbase, "shift": shift}
    scale = float((1 << shift) * math.log(logbase))
    return (-raw.astype(np.float32)) * scale


def write_sendump(path: str, ln_mixw: np.ndarray, logbase: float = 1.0001,
                  n_bits: int = 8, title: str = "cmusphinx_tpu sendump"
                  ) -> None:
    """Write ln mixture weights [n_feat, n_density, n_sen] as a sendump
    file readable by the reference decoder (mk_s2sendump capability,
    reference: SphinxTrain/src/programs/mk_s2sendump + the read layout in
    s2_semi_mgau.c:889-1040).

    8-bit: bytes are (-log_b(w)) >> SENSCR_SHIFT clamped to 159
    (MAX_NEG_MIXW, tied_mgau_common.h:84).  4-bit: the 256 possible byte
    values are k-means-clustered to a 16-entry codebook and packed as
    nibbles (low nibble = even senone).
    """
    ln_mixw = np.asarray(ln_mixw, np.float64)
    n_feat, n_density, n_sen = ln_mixw.shape
    scale = float((1 << SENSCR_SHIFT) * math.log(logbase))
    q = np.clip(np.round(-ln_mixw / scale), 0, 159).astype(np.uint8)

    def wstr(fh, s: str) -> None:
        b = s.encode() + b"\0"
        fh.write(struct.pack("<i", len(b)))
        fh.write(b)

    with open(path, "wb") as fh:
        wstr(fh, title)
        wstr(fh, "1.0")
        wstr(fh, f"feature_count {n_feat}")
        wstr(fh, f"mixture_count {n_density}")
        wstr(fh, f"model_count {n_sen}")
        wstr(fh, f"logbase {logbase:.6f}")
        wstr(fh, f"mixw_shift {SENSCR_SHIFT}")
        if n_bits == 4:
            # 16-entry codebook via 1-d k-means over the byte values.
            vals = q.reshape(-1).astype(np.float64)
            cb = np.percentile(vals, np.linspace(0, 100, 16))
            for _ in range(20):
                idx = np.argmin(np.abs(vals[:, None] - cb[None]), axis=1)
                for j in range(16):
                    sel = vals[idx == j]
                    if len(sel):
                        cb[j] = sel.mean()
            cb = np.round(np.sort(cb)).astype(np.uint8)
            wstr(fh, "cluster_count 15")  # reference writes 15, reads as 16
            wstr(fh, "cluster_bits 4")
        else:
            wstr(fh, "cluster_count 0")
        fh.write(struct.pack("<i", 0))  # end of header
        if n_bits == 4:
            fh.write(cb.tobytes())
            idx = np.argmin(
                np.abs(q.reshape(-1, 1).astype(np.int32)
                       - cb[None].astype(np.int32)), axis=1
            ).astype(np.uint8).reshape(q.shape)
            if n_sen % 2:
                idx = np.concatenate(
                    [idx, np.zeros((n_feat, n_density, 1), np.uint8)], -1)
            packed = (idx[:, :, 0::2] | (idx[:, :, 1::2] << 4)).astype(np.uint8)
            fh.write(packed.tobytes())
        else:
            # Legacy rows/cols ints (read when cluster_count == 0).
            fh.write(struct.pack("<ii", n_density, n_sen))
            fh.write(q.tobytes())


def read_mixture_weights(path: str, floor: float = 0.0000001,
                         norm: bool = True) -> np.ndarray:
    """Read s3 mixture_weights -> ln weights [n_feat, n_comp, n_sen]."""
    with S3File.open(path) as s3:
        n_sen = int(s3.read_int32(1)[0])
        n_feat = int(s3.read_int32(1)[0])
        n_comp = int(s3.read_int32(1)[0])
        n = int(s3.read_int32(1)[0])
        if n != n_sen * n_feat * n_comp:
            raise ValueError(f"{path}: count mismatch")
        w = s3.read_float32(n).reshape(n_sen, n_feat, n_comp).astype(np.float64)
        s3.verify_chksum()
    if norm:
        tot = w.sum(axis=-1, keepdims=True)
        tot[tot == 0] = 1.0
        w = w / tot
    w = np.maximum(w, floor)
    lnw = np.log(w).astype(np.float32)
    return np.transpose(lnw, (1, 2, 0))  # -> [n_feat, n_comp, n_sen]
