"""Senone score files: dump and replay.

Capability parity with acmod senone-score logging (reference:
pocketsphinx/src/libpocketsphinx/acmod.c:350-364 acmod_write_senfh_header,
:886-922 acmod_write_scores, :806 acmod_read_senfh_header, and
ps_decode_senscr) — the reference's key testing mechanism: golden senone
streams decouple search testing from GMM compute (SURVEY.md §4).

Format (bit-compatible with the reference): s3 bio header with n_sen and
logbase, then per frame an int16 active count and int16 scores (negated,
quantized by 2^shift * ln(logbase)); the delta-coded active-subset variant
is read transparently.

Port of `cmusphinx_tpu/utils/senfh.py`: the reader and writer are copies
(host); `ReplayScorer` returns the replayed stream as a tensor on its
device.
"""

from __future__ import annotations

import math
import struct
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

SENSCR_SHIFT = 10
MAGIC = 0x11223344


def write_senscr(path: str, scores: np.ndarray, logbase: float = 1.0001,
                 mdef_file: str = "none") -> None:
    """scores: [T, n_sen] natural-log, frame-relative (<= 0)."""
    T, n_sen = scores.shape
    scale = (1 << SENSCR_SHIFT) * math.log(logbase)
    rel = scores - scores.max(axis=1, keepdims=True)
    q = np.clip(np.round(-rel / scale), 0, 32767).astype("<i2")
    with open(path, "wb") as fh:
        fh.write(b"s3\n")
        fh.write(b"version 0.1\n")
        fh.write(f"mdef_file {mdef_file}\n".encode())
        fh.write(f"n_sen {n_sen}\n".encode())
        fh.write(f"logbase {logbase:f}\n".encode())
        fh.write(b"endhdr\n")
        fh.write(struct.pack("<I", MAGIC))
        for t in range(T):
            fh.write(struct.pack("<h", n_sen))
            fh.write(q[t].tobytes())


def read_senscr(path: str) -> Tuple[np.ndarray, float]:
    """Returns (scores [T, n_sen] natural-log relative (<= 0), logbase).
    Handles both all-active and delta-coded active-subset frames (inactive
    senones get a large negative score)."""
    data = open(path, "rb").read()
    end = data.index(b"endhdr\n") + len(b"endhdr\n")
    hdr = data[:end].decode(errors="replace")
    fields = dict(line.split(None, 1) for line in hdr.splitlines()[1:-1]
                  if " " in line)
    n_sen = int(fields["n_sen"])
    logbase = float(fields["logbase"])
    (magic,) = struct.unpack_from("<I", data, end)
    assert magic == MAGIC, hex(magic)
    pos = end + 4
    scale = (1 << SENSCR_SHIFT) * math.log(logbase)
    frames = []
    while pos < len(data):
        (na,) = struct.unpack_from("<h", data, pos)
        pos += 2
        if na == n_sen:
            scr = np.frombuffer(data, "<i2", na, pos)
            pos += 2 * na
            idx = np.arange(n_sen)
        else:
            deltas = np.frombuffer(data, np.uint8, na, pos)
            pos += na
            idx = np.cumsum(deltas)
            scr = np.frombuffer(data, "<i2", na, pos)
            pos += 2 * na
        row = np.full(n_sen, 32767, np.int32)
        row[idx] = scr
        frames.append(row)
    q = np.asarray(frames)
    return (-q.astype(np.float32) * scale), logbase


class ReplayScorer(nn.Module):
    """Senone scorer replaying a dumped score stream (ps_decode_senscr
    capability): search runs against golden scores with no GMM compute.

    `score(feats [..., T, D])` -> `[..., T, S]` on `device`: the first T
    frames of the stream (frames past its end at -1e7), the same for every
    row of a batch, as the reference's per-utterance `vmap` gives it."""

    def __init__(self, scores: np.ndarray, *,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.register_buffer("scores", torch.as_tensor(
            np.ascontiguousarray(scores, np.float32)).to(device))
        self.n_sen = self.scores.shape[1]

    @classmethod
    def from_file(cls, path: str, *, device: torch.device | str = "cuda"
                  ) -> "ReplayScorer":
        scores, _ = read_senscr(path)
        return cls(scores, device=device)

    def score(self, feats: torch.Tensor) -> torch.Tensor:
        T = feats.shape[-2]
        n = min(T, self.scores.shape[0])
        out = self.scores.new_full((T, self.n_sen), -1.0e7)
        out[:n] = self.scores[:n]
        return out.expand(*feats.shape[:-2], T, self.n_sen)

    forward = score
