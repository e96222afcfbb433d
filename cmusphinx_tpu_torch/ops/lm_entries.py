"""The cross-word entry readout (`ngram_steps.Readout.entries`) on the
`score_rows` LM backend as one hand-written CUDA kernel, and its plain
PyTorch version.

    entries  the frame's E word exits a row (live mask ok, word wsel, LM
             history h1 / h2, exit scores a right-context variant slot_rc)
             -> each search word's single best cross-word entry over the
             exits: its score ent_w [B, W] and either its tape slot ebp
             [B, W] int64 (the static step) or its payloads ent_pay [B, W,
             4] int32 (tape slot, the exit word's last CI phone, h2, h1;
             the mpx step, given `lastci`)

The kernel takes each history's LM scores from its real successor lists
(`successors`: built once, in search-word space) and forms each word's
best entry over the exits in one pass; no [B*E, V] score row and no [B, E,
W] candidate array exists.  The plain version (`entries_ref`) is the
composition the steps ran before: `DeviceNgram.score_rows` (or the dense
table's `score_tg`), the column gather, the bonus, the candidates, `amax`
and `argmax`, and the mpx step's payload gather.

For CPU tensors `entries` runs the plain version.  For CUDA tensors it
launches the kernel of `csrc/lm_entries.cu` on the current stream, or
raises (the dense backend has no kernel: the readout calls `entries_ref`
there itself); it never falls back from one to the other.  `launches`
counts the kernel's launches.  The tree steps, the grammar search and
`device_backtrace` share none of it.

The library is built with the others (`cuda_libs.build_all`): at first
use, with nvcc for sm_90a into `build/kernels`, named by a hash of its
source, loaded with ctypes.  Nothing is compiled when this module is
imported.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple, Optional

import torch

from . import cuda_libs
from .cuda_libs import expect
from .hmm import NEG_INF

LIBRARY = "lm_entries"
# CI phones the kernel stages a right-context table for (shared memory).
MAX_CI = 96

launches: Counter = Counter()

_lib = None


class Successors(NamedTuple):
    """The LM's successor lists in search-word space, CSR, on one device:
    `bg_ptr` [V+1] int32 each LM word's bigram successors `bg_w` (search
    words, sorted within a row; every search word of the successor's LM
    id) with their scores `bg_p` f32; `tg_ptr` [NB+1] each bigram row's
    trigram successors `tg_w`, `tg_p` (empty without trigrams)."""
    bg_ptr: torch.Tensor
    bg_w: torch.Tensor
    bg_p: torch.Tensor
    tg_ptr: torch.Tensor
    tg_w: torch.Tensor
    tg_p: torch.Tensor


class Tables(NamedTuple):
    """The readout's word tables, on one device: per search word [W]
    `lmwid_c` its LM id (-1 clamped to 0) and `firstci` its first CI
    phone (int64), `is_filler` (bool), `fil_pen` (f32); `rssid` [W, n_ci]
    int64 the right-context variant of a word exit serving each next CI
    phone; `succ` the successor lists (None where the readout runs the
    plain version: over a dense table, and in a tree lexicon, whose steps
    read no entries); `lw32`, `wip32` the language weight and log
    insertion penalty, each a float32 value."""
    lmwid_c: torch.Tensor
    firstci: torch.Tensor
    is_filler: torch.Tensor
    fil_pen: torch.Tensor
    rssid: torch.Tensor
    succ: Optional[Successors]
    lw32: float
    wip32: float


def _trigram(dlm) -> bool:
    return dlm.n >= 3 and dlm.NT > 0


def _expand(ptr, wid, prob, order, inv_ptr, W: int):
    """One LM successor CSR (rows `ptr`, LM ids `wid`, scores `prob`)
    mapped to search words: each entry repeated for every search word of
    its LM id (`order[inv_ptr[id]:inv_ptr[id+1]]`), each row sorted by
    search word.  Returns (ptr, words, scores) as int32, int32, f32."""
    n_rows = ptr.shape[0] - 1
    cnt = inv_ptr[wid + 1] - inv_ptr[wid]
    row = torch.repeat_interleave(torch.arange(n_rows, device=ptr.device),
                                  ptr.diff())
    total = int(cnt.sum())
    first = torch.repeat_interleave(inv_ptr[wid], cnt, output_size=total)
    k = (torch.arange(total, device=ptr.device)
         - torch.repeat_interleave(cnt.cumsum(0) - cnt, cnt,
                                   output_size=total))
    w = order[first + k]
    row = torch.repeat_interleave(row, cnt, output_size=total)
    p = torch.repeat_interleave(prob, cnt, output_size=total)
    o = torch.argsort(row * W + w)
    new_ptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=ptr.device)
    new_ptr[1:] = torch.bincount(row, minlength=n_rows).cumsum(0)
    if total >= 1 << 31:
        raise ValueError(f"{total} successor entries do not fit int32")
    return new_ptr.int(), w[o].int(), p[o]


def successors(dlm, lmwid_c: torch.Tensor) -> Successors:
    """The search-word successor lists of the LM `dlm` (a `DeviceNgram`
    with its CSR buffers) for search words of LM ids `lmwid_c` [W], on
    their device, by vectorised ops (no loop over the entries)."""
    dev, W, V = lmwid_c.device, lmwid_c.shape[0], dlm.V
    order = torch.argsort(lmwid_c, stable=True)
    inv_ptr = torch.searchsorted(lmwid_c[order],
                                 torch.arange(V + 1, device=dev))
    NB, NT = dlm.NB, dlm.NT
    bg = _expand(dlm.bg_ptr, dlm.bg_wid[:NB], dlm.bg_prob[:NB], order,
                 inv_ptr, W)
    if _trigram(dlm):
        tg = _expand(dlm.tg_ptr[: NB + 1], dlm.tg_wid[:NT],
                     dlm.tg_prob[:NT], order, inv_ptr, W)
    else:
        tg = (torch.zeros(NB + 1, dtype=torch.int32, device=dev),
              torch.zeros(0, dtype=torch.int32, device=dev),
              torch.zeros(0, dtype=torch.float32, device=dev))
    return Successors(*bg, *tg)


def least_bytes(B: int, E: int, W: int, Vr: int, n_ci: int,
                payload: bool, list_entries: int = 0) -> int:
    """The fewest bytes one frame's readout must move: the word tables
    (LM id and first CI phone int64, filler flag, filler penalty) and each
    word's unigram score, read once; the exits (live flag, word, h1, h2
    int64 and Vr scores; with Vr > 1 each exit's row of `rssid`); the
    outputs [B, W] (the entry score and an int64 tape slot, or the int32
    payloads' 16 bytes); and `list_entries` successor entries (search word
    and score) that fall in the words.  The lists' bounds, the bisections
    and each history's backoff weights are data, set by the histories,
    and not counted.  The kernel reads the word tables once an utterance
    (all but the first time from L2) and each exit's history once a block
    of words."""
    words = W * (8 + 8 + 1 + 4 + 4)
    exits = B * E * (1 + 8 + 8 + 8 + 4 * Vr) + (
        B * E * n_ci * 8 if Vr > 1 else 0)
    outs = B * W * (4 + (16 if payload else 8))
    return words + exits + outs + 8 * list_entries


# ----------------------------------------------------------------------
def entries_ref(dlm, tab: Tables, t: torch.Tensor, ok: torch.Tensor,
                wsel: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
                slot_rc: torch.Tensor, lastci: Optional[torch.Tensor] = None):
    """Plain version of `entries`, any LM backend: single best cross-word
    entry per word (word_transition semantics): over this frame's E exit
    slots, exit score (the exit's rc variant serving the word's first CI
    phone) + LM or filler bonus, P(w | h1, h2) for every search word
    (per-history score rows where the LM has no dense table, as the
    reference's cores do)."""
    B, E = h1.shape
    W = tab.lmwid_c.shape[0]
    if dlm.tg_dense is None:
        rows = dlm.score_rows(h1.reshape(-1), h2.reshape(-1))
        lmw = rows[:, tab.lmwid_c].view(B, E, W)                  # [B, E, W]
    else:
        lmw = dlm.score_tg(h1[..., None], h2[..., None], tab.lmwid_c,
                           lanes=E * W)
    bonus = torch.where(tab.is_filler, tab.fil_pen,
                        tab.lw32 * lmw + tab.wip32)
    if slot_rc.shape[2] == 1:
        ac = slot_rc                                              # [B, E, 1]
    else:
        ac = torch.gather(slot_rc, 2, tab.rssid[wsel[..., None], tab.firstci])
    cand = torch.where(ok[..., None], ac + bonus, NEG_INF)        # [B, E, W]
    ent_w = cand.amax(1)                                          # [B, W]
    estar = cand.argmax(1)
    ebp_w = torch.where(ent_w > NEG_INF * 0.5, t * E + estar, -1)
    if lastci is None:
        return ent_w, ebp_w
    eh = torch.gather(torch.stack([lastci[wsel], h2, h1], -1), 1,
                      estar[..., None].expand(B, W, 3))
    return ent_w, torch.cat([ebp_w[..., None], eh], -1).to(torch.int32)


# ----------------------------------------------------------------------
def build() -> float:
    """Build the kernel's library (with the others, if any is missing) and
    load it; returns the seconds spent compiling."""
    global _lib
    spent = cuda_libs.build_all()
    if _lib is None:
        lib = ctypes.CDLL(str(cuda_libs.library_path(LIBRARY)))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lm_entries_launch.argtypes = (
            [p] * 11 + [i] + [p] * 5 + [i] * 2 + [f] * 2 + [p] * 7 + [i] * 3
            + [p] * 4)
        lib.lm_entries_launch.restype = i
        _lib = lib
    return spent


def _check(dlm, tab: Tables, t, ok, wsel, h1, h2, slot_rc, lastci) -> dict:
    """Check the exits and the tables; returns every tensor by name."""
    if ok.dim() != 2:
        raise ValueError(f"ok must be [B, E], got {tuple(ok.shape)}")
    B, E = ok.shape
    W = tab.lmwid_c.shape[0]
    if slot_rc.dim() != 3 or slot_rc.shape[:2] != (B, E):
        raise ValueError(f"slot_rc must be [{B}, {E}, Vr], got "
                         f"{tuple(slot_rc.shape)}")
    expect(t, "t", (), torch.int64)
    expect(ok, "ok", (B, E), torch.bool)
    for name, x in (("wsel", wsel), ("h1", h1), ("h2", h2)):
        expect(x, name, (B, E), torch.int64)
    expect(slot_rc, "slot_rc", slot_rc.shape, torch.float32)
    if tab.rssid.dim() != 2 or tab.rssid.shape[0] != W:
        raise ValueError(f"rssid must be [{W}, n_ci], got "
                         f"{tuple(tab.rssid.shape)}")
    for name in ("lmwid_c", "firstci"):
        expect(getattr(tab, name), name, (W,), torch.int64)
    expect(tab.is_filler, "is_filler", (W,), torch.bool)
    expect(tab.fil_pen, "fil_pen", (W,), torch.float32)
    expect(tab.rssid, "rssid", tab.rssid.shape, torch.int64)
    named = {"t": t, "ok": ok, "wsel": wsel, "h1": h1, "h2": h2,
             "slot_rc": slot_rc, "lmwid_c": tab.lmwid_c,
             "firstci": tab.firstci, "is_filler": tab.is_filler,
             "fil_pen": tab.fil_pen, "rssid": tab.rssid}
    if lastci is not None:
        expect(lastci, "lastci", (W,), torch.int64)
        named["lastci"] = lastci
    cuda_libs.contiguous(named)
    return named


def entries(dlm, tab: Tables, t: torch.Tensor, ok: torch.Tensor,
            wsel: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
            slot_rc: torch.Tensor, lastci: Optional[torch.Tensor] = None):
    """Each search word's best cross-word entry over the frame's exits
    (t the frame, a 0-d int64 tensor; ok [B, E] bool; wsel, h1, h2 [B, E]
    int64; slot_rc [B, E, Vr] f32; all contiguous) from the LM `dlm` on
    its `score_rows` backend.  Returns (ent_w [B, W] f32, ebp_w [B, W]
    int64), or with `lastci` [W] int64 (ent_w, ent_pay [B, W, 4] int32)."""
    named = _check(dlm, tab, t, ok, wsel, h1, h2, slot_rc, lastci)
    dev = cuda_libs.one_device(named.values(), "lm-entries")
    if dev.type == "cpu":
        return entries_ref(dlm, tab, t, ok, wsel, h1, h2, slot_rc, lastci)
    if dlm.tg_dense is not None or tab.succ is None:
        raise ValueError("the lm-entries kernel takes the score_rows "
                         "backend only")
    B, E = ok.shape
    W, n_ci = tab.rssid.shape
    Vr = slot_rc.shape[2]
    if Vr > 1 and n_ci > MAX_CI:
        raise ValueError(f"the lm-entries kernel takes at most {MAX_CI} CI "
                         f"phones, got {n_ci}")
    lm = (dlm.ug_prob, dlm.ug_bo, dlm.bg_ptr, dlm.bg_wid, dlm.bg_bo,
          *tab.succ)
    if {x.device for x in lm} != {dev}:
        raise ValueError("the LM's tables are not on the exits' device")
    if _lib is None:
        build()
    ent_w = torch.empty((B, W), dtype=torch.float32, device=dev)
    if lastci is None:
        ebp = torch.empty((B, W), dtype=torch.int64, device=dev)
        pay = None
    else:
        ebp = None
        pay = torch.empty((B, W, 4), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib.lm_entries_launch(
            *(x.data_ptr() for x in lm[:11]), int(_trigram(dlm)),
            *(x.data_ptr() for x in (tab.lmwid_c, tab.is_filler, tab.fil_pen,
                                     tab.firstci, tab.rssid)),
            W, n_ci, tab.lw32, tab.wip32,
            *(x.data_ptr() for x in (t, ok, wsel, h1, h2, slot_rc)),
            None if lastci is None else lastci.data_ptr(), B, E, Vr,
            ent_w.data_ptr(), None if ebp is None else ebp.data_ptr(),
            None if pay is None else pay.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lm_entries launch failed: CUDA error {err}")
    launches["entries"] += 1
    return (ent_w, ebp) if lastci is None else (ent_w, pay)
