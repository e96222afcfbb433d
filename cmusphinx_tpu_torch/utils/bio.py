"""Sphinx-3 binary model file I/O.

Replicates the on-disk contract of sphinxbase bio.c (reference:
sphinxbase/src/libsphinxbase/util/bio.c:187 `bio_readhdr`): an ASCII header
("s3\\n" then "key value\\n" pairs until "endhdr\\n"), a uint32 byte-order
magic 0x11223344 used for endianness detection, then raw arrays, optionally
followed by a uint32 checksum when the header carries `chksum0`.

All readers return numpy arrays in native byte order.
"""

from __future__ import annotations

import io
from typing import BinaryIO, Dict, Tuple

import numpy as np

BYTE_ORDER_MAGIC = 0x11223344


class S3File:
    """Reader for an s3-format binary file."""

    def __init__(self, fh: BinaryIO):
        self.fh = fh
        self.hdr: Dict[str, str] = {}
        self.swap = False
        self._chksum = np.uint32(0)
        self._read_header()

    @classmethod
    def open(cls, path: str) -> "S3File":
        return cls(open(path, "rb"))

    def _read_header(self) -> None:
        first = self._readline()
        if first.strip() == "s3":
            while True:
                line = self._readline()
                parts = line.strip().split(None, 1)
                if not parts:
                    continue
                if parts[0] == "endhdr":
                    break
                self.hdr[parts[0]] = parts[1] if len(parts) > 1 else ""
        else:
            # Old-style header: first line is the version string; no attributes.
            self.hdr["version"] = first.strip()
        magic = np.frombuffer(self.fh.read(4), dtype="<u4")[0]
        if magic == BYTE_ORDER_MAGIC:
            self.swap = False  # file is little-endian (we read as LE)
        elif int(magic.byteswap()) == BYTE_ORDER_MAGIC:
            self.swap = True
        else:
            raise ValueError(f"bad byte-order magic {int(magic):#x}")

    def _readline(self) -> str:
        buf = bytearray()
        while True:
            c = self.fh.read(1)
            if not c:
                raise EOFError("premature EOF in s3 header")
            buf += c
            if c == b"\n":
                break
        return buf.decode("utf-8", errors="replace")

    @property
    def chksum_present(self) -> bool:
        return self.hdr.get("chksum0", "no") in ("yes", "1")

    def _dtype(self, kind: str, size: int) -> np.dtype:
        order = ">" if self.swap else "<"
        return np.dtype(f"{order}{kind}{size}")

    def read_array(self, dtype_kind: str, itemsize: int, count: int) -> np.ndarray:
        dt = self._dtype(dtype_kind, itemsize)
        raw = self.fh.read(itemsize * count)
        if len(raw) != itemsize * count:
            raise EOFError(f"short read: wanted {count} x {itemsize}")
        arr = np.frombuffer(raw, dtype=dt, count=count)
        if self.chksum_present:
            self._accum_chksum(raw, itemsize)
        return arr.astype(arr.dtype.newbyteorder("="))

    def read_int32(self, count: int = 1) -> np.ndarray:
        return self.read_array("i", 4, count)

    def read_uint32(self, count: int = 1) -> np.ndarray:
        return self.read_array("u", 4, count)

    def read_float32(self, count: int = 1) -> np.ndarray:
        return self.read_array("f", 4, count)

    def read_float64(self, count: int = 1) -> np.ndarray:
        return self.read_array("f", 8, count)

    def read_1d_float32(self) -> np.ndarray:
        """bio_fread_1d equivalent: uint32 length then data."""
        n = int(self.read_uint32(1)[0])
        return self.read_float32(n)

    _CHKSUM_MAX_ELEMENTS = 4_000_000  # skip O(n) python loop on huge files

    def _accum_chksum(self, raw: bytes, itemsize: int) -> None:
        """Replicates chksum_accum (bio.c:266-295): rotate-left-accumulate of
        native-order element values; rotation is 5/10/20 bits for 1/2/4-byte
        elements."""
        if self._chksum is None:
            return
        if itemsize == 4:
            vals, rot = np.frombuffer(raw, dtype=self._dtype("u", 4)), 20
        elif itemsize == 2:
            vals, rot = np.frombuffer(raw, dtype=self._dtype("u", 2)), 10
        else:
            vals, rot = np.frombuffer(raw, dtype=np.uint8), 5
        if len(vals) > self._CHKSUM_MAX_ELEMENTS:
            self._chksum = None  # too large to verify cheaply on host
            return
        s = int(self._chksum)
        inv = 32 - rot
        for v in vals.tolist():
            s = (((s << rot) & 0xFFFFFFFF) | (s >> inv)) + v
            s &= 0xFFFFFFFF
        self._chksum = np.uint32(s)

    def verify_chksum(self) -> None:
        if not self.chksum_present:
            return
        stored = int(np.frombuffer(self.fh.read(4), dtype=self._dtype("u", 4))[0])
        if self._chksum is None:
            return  # verification skipped (file too large)
        if stored != int(self._chksum):
            raise ValueError(f"checksum mismatch: stored {stored:#x} computed {int(self._chksum):#x}")

    def close(self) -> None:
        self.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_s3_header(fh: BinaryIO, version: str, extra: Dict[str, str] | None = None,
                    chksum: bool = False) -> None:
    fh.write(b"s3\n")
    fh.write(f"version {version}\n".encode())
    for k, v in (extra or {}).items():
        fh.write(f"{k} {v}\n".encode())
    if chksum:
        fh.write(b"chksum0 yes\n")
    fh.write(b"endhdr\n")
    fh.write(np.array([BYTE_ORDER_MAGIC], dtype="<u4").tobytes())


def read_mfc(path: str, ncep: int = 13) -> np.ndarray:
    """Read a Sphinx MFC cepstra file: int32 float-count header + float32 data.

    Byte order sniffed from the header as in feat.c:360 `feat_s2mfc_read`.
    """
    with open(path, "rb") as fh:
        raw = fh.read()
    n = np.frombuffer(raw[:4], dtype="<i4")[0]
    order = "<"
    if int(n) * 4 != len(raw) - 4:
        n = np.frombuffer(raw[:4], dtype=">i4")[0]
        order = ">"
        if int(n) * 4 != len(raw) - 4:
            raise ValueError(f"{path}: header {int(n)} disagrees with size {len(raw) - 4}")
    data = np.frombuffer(raw[4:], dtype=f"{order}f4").astype(np.float32)
    return data.reshape(-1, ncep)


def write_mfc(path: str, cep: np.ndarray) -> None:
    cep = np.asarray(cep, dtype=np.float32)
    with open(path, "wb") as fh:
        fh.write(np.array([cep.size], dtype="<i4").tobytes())
        fh.write(cep.astype("<f4").tobytes())


def read_raw_audio(path: str, dtype: str = "<i2") -> np.ndarray:
    """Read a headerless 16-bit PCM file into int16 samples."""
    with open(path, "rb") as fh:
        return np.frombuffer(fh.read(), dtype=dtype).astype(np.int16)
