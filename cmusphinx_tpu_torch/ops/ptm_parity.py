"""`PtmParityScorer`'s CUDA kernel (`csrc/ptm_parity.cu`): pocketsphinx's
phonetically-tied-mixture scorer, bit for bit its plain path
(`PtmParityScorer.score_ref`), from features [N, D] to senone scores
[N, S] in one cooperative launch.

`pack(scorer)` lays the scorer's buffers out for the kernel, once:

- `book` [C, F, K, 4 * rec] float32: a record a codeword, its L means,
  its L precisions and its determinant (L the stream width, 13, or 16 with
  zero padding for any width up to 16; a padded dimension adds exactly 0);
- `cols` [F, L] int32: the feature column of each stream dimension;
- the senones ordered by codebook, each codebook's run padded to a
  multiple of 4 (Sp slots in all): `mixp` [F, K, Sp] uint8 the weights in
  that order, `gcb` [Sp / 4] int32 the codebook of each group of 4, `orig`
  [Sp] int32 the senone of each slot (-1 on padding);
- `table` [256] int32, the 8-bit log-add table, and `dmax`, the index from
  which its entries are all 0 (the kernel clamps |a - b| there, so the
  entries it reads lie one to a shared-memory bank).

`score(x, packed)` launches the kernel on the current stream and counts it
in `launches`.  The library is built with the others
(`cuda_libs.build_all`) at the first use, with nvcc for sm_90a into
`build/kernels`, and loaded with ctypes by this module alone.  Nothing is
compiled when it is imported.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from . import cuda_libs

LIBRARY = "ptm_parity"
MAX_TOPN = 4
MAX_FEAT = 4
MAX_WIDTH = 16
MAX_DENSITY = 256
# Codebooks times streams: one a thread of a block in the second pass.
MAX_BOOKS = 256
# A weight row's byte offset and a score's fsc share one 32-bit word.
MAX_WEIGHT_BYTES = 1 << 24
# Shared memory a block may use, bytes, and the frames a block of the
# kernel's second pass holds in it.
MAX_SMEM = 232448
FRAMES_A_TASK = 2

launches: Counter = Counter()

_lib = None


# `ptm_parity_launch`'s parameters in order (`csrc/ptm_parity.cu`): the
# pointers, the ints, the scale and the stream.
PARAMS = ("x", "cols", "book", "mixp", "gcb", "orig", "table", "top", "bar",
          "out", "N", "D", "C", "F", "K", "S", "Sp", "L", "topn", "shift",
          "max_neg", "dmax", "scale", "stream")
N_POINTERS, N_INTS = 10, 12


class Packed(NamedTuple):
    cols: torch.Tensor
    book: torch.Tensor
    mixp: torch.Tensor
    gcb: torch.Tensor
    orig: torch.Tensor
    table: torch.Tensor
    width: int          # L, the padded stream width
    dmax: int
    n_slot: int         # Sp


def build() -> float:
    """Build the kernels' libraries that are missing and load this one;
    returns the seconds spent compiling."""
    global _lib
    spent = cuda_libs.build_all()
    if _lib is None:
        lib = ctypes.CDLL(str(cuda_libs.library_path(LIBRARY)))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ptm_parity_launch.argtypes = ([p] * N_POINTERS + [i] * N_INTS
                                          + [ctypes.c_float, p])
        lib.ptm_parity_launch.restype = i
        _lib = lib
    return spent


def _width(sc) -> int:
    return 13 if set(sc.veclen) == {13} else MAX_WIDTH


def _slots(sen2cb: np.ndarray, n_cb: int):
    """The senones ordered by codebook, each run padded to a multiple of 4:
    (orig [Sp] with -1 on padding, gcb [Sp / 4])."""
    orig, gcb = [], []
    for c in range(n_cb):
        run = np.flatnonzero(sen2cb == c)
        pad = -len(run) % 4
        orig.extend(run.tolist() + [-1] * pad)
        gcb.extend([c] * ((len(run) + pad) // 4))
    return np.asarray(orig, np.int64), np.asarray(gcb, np.int32)


def check(sc) -> None:
    """Raise `ValueError` on a scorer whose model the kernel was not built
    for."""
    n_slot = sc.n_sen + 3 * sc.n_cb
    smem = 4 * (256 + FRAMES_A_TASK * (MAX_FEAT + 4 * sc.n_cb * sc.n_feat
                                       + sc.n_sen))
    limits = [(sc.topn <= MAX_TOPN, f"top {sc.topn} > {MAX_TOPN}"),
              (sc.n_feat <= MAX_FEAT, f"{sc.n_feat} streams > {MAX_FEAT}"),
              (max(sc.veclen) <= MAX_WIDTH,
               f"a stream of {max(sc.veclen)} > {MAX_WIDTH}"),
              (sc.n_density <= MAX_DENSITY,
               f"{sc.n_density} codewords > {MAX_DENSITY}"),
              (sc.n_cb * sc.n_feat <= MAX_BOOKS,
               f"{sc.n_cb} codebooks x {sc.n_feat} streams > {MAX_BOOKS}"),
              (sc.n_feat * sc.n_density * n_slot <= MAX_WEIGHT_BYTES,
               "weights past 2^24 bytes"),
              (smem <= MAX_SMEM, f"{smem} bytes of shared memory")]
    bad = [why for ok, why in limits if not ok]
    if bad:
        raise ValueError("the PTM parity kernel does not take this model: "
                         + "; ".join(bad))


def pack(sc) -> Packed:
    """The kernel's operands from a `PtmParityScorer`'s buffers, on their
    device; raises where `check` does."""
    check(sc)
    C, F, K, L = sc.n_cb, sc.n_feat, sc.n_density, _width(sc)
    dev = sc.mixw.device
    rec = (2 * L + 1 + 3) // 4
    book = torch.zeros((C, F, K, 4 * rec), dtype=torch.float32, device=dev)
    cols = torch.zeros((F, L), dtype=torch.int32, device=dev)
    for f, ln in enumerate(sc.veclen):
        book[:, f, :, :ln] = getattr(sc, f"means{f}")
        book[:, f, :, L: L + ln] = getattr(sc, f"prec{f}")
        book[:, f, :, 2 * L] = getattr(sc, f"lrd{f}")
        cols[f, :ln] = getattr(sc, f"slice{f}").to(torch.int32)
        cols[f, ln:] = cols[f, 0]
    orig, gcb = _slots(sc.sen2cb.cpu().numpy(), C)
    mixw = sc.mixw.cpu().numpy().astype(np.uint8)             # [F, K, S]
    mixp = np.where(orig >= 0, mixw[:, :, np.maximum(orig, 0)], 0)
    table = sc.table8.cpu().numpy().astype(np.int32)
    nz = np.flatnonzero(table)
    dmax = min(int(nz[-1]) + 1 if nz.size else 0, 255)
    return Packed(cols, book.contiguous(),
                  torch.as_tensor(np.ascontiguousarray(mixp, np.uint8),
                                  device=dev),
                  torch.as_tensor(gcb, device=dev),
                  torch.as_tensor(orig.astype(np.int32), device=dev),
                  torch.as_tensor(table, device=dev), L, dmax, len(orig))


def least_bytes(N: int, sc) -> int:
    """The fewest bytes a call on N frames must move, each operand once:
    the features [N, D] and the scores [N, S] (float32), the 8-bit weights
    [F, K, S], and the codebooks (float32 means and precisions a
    dimension, a determinant a codeword, of C codebooks)."""
    D, F = sum(sc.veclen), sc.n_feat
    books = 4 * sc.n_cb * sc.n_density * (2 * D + F)
    return 4 * N * D + 4 * N * sc.n_sen + F * sc.n_density * sc.n_sen + books


def score(x: torch.Tensor, sc, packed: Packed) -> torch.Tensor:
    """x [N, D] float32 on the card -> senone scores [N, S]."""
    if x.device.type != "cuda":
        raise ValueError("the PTM parity kernel takes CUDA tensors")
    if x.dim() != 2:
        raise ValueError(f"x must be [N, D], got {tuple(x.shape)}")
    x = x.float().contiguous()
    N, D = x.shape
    if _lib is None:
        build()
    out = torch.empty((N, sc.n_sen), dtype=torch.float32, device=x.device)
    # The pass-1 scratch [N, C, F, 4] and, after it, the barrier's count.
    top = torch.empty(N * sc.n_cb * sc.n_feat * 4 + 4, dtype=torch.int32,
                      device=x.device)
    args = {"x": x, **{k: getattr(packed, k) for k in
                       ("cols", "book", "mixp", "gcb", "orig", "table")},
            "top": top, "bar": top[-4:], "out": out}
    args = {k: v.data_ptr() for k, v in args.items()}
    args.update(N=N, D=D, C=sc.n_cb, F=sc.n_feat, K=sc.n_density,
                S=sc.n_sen, Sp=packed.n_slot, L=packed.width, topn=sc.topn,
                shift=sc.SHIFT, max_neg=sc.MAX_NEG_ASCR, dmax=packed.dmax,
                scale=float(np.float32(sc.scale)),
                stream=torch.cuda.current_stream(x.device).cuda_stream)
    with torch.cuda.device(x.device):
        err = _lib.ptm_parity_launch(*(args[k] for k in PARAMS))
    if err != 0:
        raise RuntimeError(f"ptm_parity launch failed: CUDA error {err}")
    launches["score"] += 1
    return out
