"""The multiplexed-left-context frame step's channel update
(`ngram_steps.MpxStep`) as two hand-written CUDA kernels, and their
plain PyTorch version.

    step_exits   (kernel A)  the carry (alpha [B, C, S] and its four
                             payloads: tape slot, senone-sequence row, LM
                             words h2 and h1), the frame's senone-sequence
                             rows [B, n_xs, S] -> `hmm_step`, each state
                             reading its own row: the exits ex [B, C],
                             their payloads exh3 [B, C, 3] (tape slot, h2,
                             h1), the frame's best score best [B]
    (the search)             the word-exit readout with the word-exit
                             beam, the tape, the per-word entries ent_w
                             [B, W] and their payloads ent_pay [B, W, 4]
                             (tape slot, left-context CI phone, h2, h1)
    prune_enter  (kernel B)  the step again from the same carry, the
                             channel beam (with the phone-loop lookahead),
                             the word-exit beam on the predecessor's exit,
                             the within-word propagation with the phone
                             penalty, the entries at each word's entry
                             channels with their left context's row,
                             `hmm_enter` and the valid mask: the new
                             carry, written into the old one

The payloads ride as int32: tape slots t*E + e, senone-sequence rows and
LM word ids all fit.

For CPU tensors the wrappers run the plain version (`step_exits_ref`,
`prune_enter_ref`: `hmm_step`, the beams, the propagation, the entry
routing and `hmm_enter` as the search composed them; the second half
redoes the step, as kernel B does).  For CUDA tensors the wrappers launch the kernels
of `csrc/mpx_step.cu` on the current stream, or raise; they never fall
back from one to the other.  `launches` counts the kernels' launches by
name.  The other frame steps and searches share nothing with these
kernels (the one-copy tree's are `ops/tree_step.py`'s).

The library is built with the others (`cuda_libs.build_all`): at first
use, with nvcc for sm_90a into `build/kernels`, named by a hash of its
source, loaded with ctypes.  Nothing is compiled when this module is
imported.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple, Optional, Tuple

import torch

from . import cuda_libs
from .cuda_libs import expect
from .hmm import NEG_INF, hmm_enter, hmm_step

LIBRARY = "mpx_step"
# States a channel the kernels are instantiated for.
MAX_STATES = 5

launches: Counter = Counter()

_lib = None

Carry = Tuple[torch.Tensor, ...]


class Tables(NamedTuple):
    """A flat lexicon's channel tables and the step's constants, on one
    device.  Per channel [C], int32 unless said: `xs` its static
    senone-sequence row, `pc` its predecessor channel (0 where none),
    `has_prev`, `is_entry` (bool), `word_of` its word, `lc_base` its row
    of the left-context map times n_ci (0 off the entry channels), `ci_of`
    its CI phone; `lcmap` the flattened left-context map [n_lcrows * n_ci]
    -> senone-sequence row; `bands` `hmm_bands`' five arrays (float32,
    contiguous).  `prune`, `log_beam`, `log_wbeam`, `pip`: the search's
    beams and phone insertion penalty, each a float32 value."""
    xs: torch.Tensor
    pc: torch.Tensor
    has_prev: torch.Tensor
    is_entry: torch.Tensor
    word_of: torch.Tensor
    lc_base: torch.Tensor
    ci_of: torch.Tensor
    lcmap: torch.Tensor
    bands: Tuple[torch.Tensor, ...]
    prune: bool
    log_beam: float
    log_wbeam: float
    pip: float


class Exits(NamedTuple):
    """Kernel A's results: ex [B, C] f32 the exits before the word-exit
    beam, exh3 [B, C, 3] int32 their payloads (tape slot, h2, h1), best
    [B] f32 the row's best stepped score."""
    ex: torch.Tensor
    exh3: torch.Tensor
    best: torch.Tensor


def build() -> float:
    """Build the kernels' library (with the others, if any is missing) and
    load it; returns the seconds spent compiling."""
    global _lib
    spent = cuda_libs.build_all()
    if _lib is None:
        lib = ctypes.CDLL(str(cuda_libs.library_path(LIBRARY)))
        p, i, f, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                        ctypes.c_int64)
        lib.mpx_step_exits_launch.argtypes = [i] + [p] * 14 + [i] * 3 + [p]
        lib.mpx_step_exits_launch.restype = i
        lib.mpx_prune_enter_launch.argtypes = (
            [i] + [p] * 25 + [i64, p, i64] + [i] * 5 + [f] * 3 + [p])
        lib.mpx_prune_enter_launch.restype = i
        _lib = lib
    return spent


def least_bytes(B: int, C: int, S: int, n_xs: int, W: int, n_ci: int,
                lookahead: bool = False) -> int:
    """The fewest bytes one frame step's channel update must move in two
    passes around the exit readout (which needs every exit before any
    entry), each array read once a pass and each output written once.
    Pass one reads the carry (alpha and four int32 payloads, 20 bytes a
    state), the rows [B, n_xs, S] and the bands, and writes the exits
    with their three payloads [B, C] and the best scores.  Pass two redoes
    the step from the same inputs, reads the predecessors' exits, the best
    scores, its channel tables (with `ci_of` under the lookahead), each
    word's entry score [B, W], the lookahead [B, n_ci] and valid, and
    writes the carry.  An exit's or an entry's payloads, and its row of
    the left-context map, are read only where a token enters: data, not
    shape, sets them, and they are not counted.  These kernels move this
    count and those reads."""
    states, chans = B * C * S, B * C
    step_in = 20 * states + 4 * B * n_xs * S + 4 * C * (3 * S - 1)
    a = step_in + 16 * chans + 4 * B
    tables = C * (4 + 4 + 1 + 1 + 4 + 4 + (4 if lookahead else 0))
    b = (step_in + 4 * chans + 4 * B + tables + 4 * B * W
         + (4 * B * n_ci if lookahead else 0) + B + 20 * states)
    return a + b


# ----------------------------------------------------------------------
def _step_ref(carry: Carry, rows: torch.Tensor, tab: Tables):
    """`hmm_step` over the carry, each state's senone score read through
    its own row (payload xsr): (the stepped carry, the exits, their
    payloads [B, C, 3])."""
    alpha0, hist0, xsr0, hw20, hw10 = carry
    sen = torch.gather(rows, 1, xsr0.long())
    alpha, pays, ex, (exh, _, exh2, exh1) = hmm_step(
        alpha0, (hist0, xsr0, hw20, hw10), sen, tab.bands)
    return (alpha,) + pays, ex, torch.stack([exh, exh2, exh1], -1)


def step_exits_ref(carry: Carry, rows: torch.Tensor, tab: Tables) -> Exits:
    """Plain version of `step_exits`."""
    stepped, ex, exh3 = _step_ref(carry, rows, tab)
    return Exits(ex, exh3, stepped[0].flatten(1).amax(1))


def prune_enter_ref(carry: Carry, rows: torch.Tensor, st: Exits,
                    ent_w: torch.Tensor, ent_pay: torch.Tensor,
                    la_t: Optional[torch.Tensor], valid: torch.Tensor,
                    tab: Tables) -> Carry:
    """Plain version of `prune_enter`: the step redone from the carry, as
    kernel B does."""
    neg = NEG_INF
    (alpha, hist, xsr, hw2, hw1), _, _ = _step_ref(carry, rows, tab)
    ex = st.ex
    if tab.prune:
        bestscr = st.best[:, None]
        cmax = alpha.amax(-1)
        if la_t is not None:
            cmax = cmax + la_t[:, tab.ci_of]
        keep = cmax > bestscr + tab.log_beam
        alpha = torch.where(keep[..., None], alpha, neg)
        ex = torch.where(ex > bestscr + tab.log_wbeam, ex, neg)
    pc = tab.pc
    prop = torch.where(tab.has_prev, ex[:, pc] + tab.pip, neg)
    exh, exh2, exh1 = st.exh3[:, pc].unbind(-1)
    bprop = torch.where(tab.has_prev, exh, -1)
    wo = tab.word_of
    ebp, lc, eh2, eh1 = ent_pay[:, wo].unbind(-1)
    ent_xs = tab.lcmap[tab.lc_base + lc]
    ie = tab.is_entry
    alpha, pays = hmm_enter(
        alpha, (hist, xsr, hw2, hw1), torch.where(ie, ent_w[:, wo], prop),
        (torch.where(ie, ebp, bprop), torch.where(ie, ent_xs, tab.xs),
         torch.where(ie, eh2, exh2), torch.where(ie, eh1, exh1)))
    vm = valid[:, None, None]
    for old, new in zip(carry, (alpha,) + pays):
        old.copy_(torch.where(vm, new, old))
    return carry


# ----------------------------------------------------------------------
_CARRY = ("alpha", "hist", "xsr", "hw2", "hw1")


def _check_inputs(carry: Carry, rows: torch.Tensor, tab: Tables) -> dict:
    """Check the carry, the rows and the tables; returns them by name."""
    if len(carry) != len(_CARRY):
        raise ValueError(f"the carry must be {_CARRY}, got {len(carry)} "
                         f"arrays")
    B, C, S = carry[0].shape
    for name, t in zip(_CARRY, carry):
        expect(t, name, (B, C, S),
               torch.float32 if name == "alpha" else torch.int32)
    cuda_libs.expect_rows(rows, B, S)
    for name in ("xs", "pc", "word_of", "lc_base", "ci_of"):
        expect(getattr(tab, name), name, (C,), torch.int32)
    for name in ("has_prev", "is_entry"):
        expect(getattr(tab, name), name, (C,), torch.bool)
    if tab.lcmap.dim() != 1:
        raise ValueError("lcmap must be flat")
    expect(tab.lcmap, "lcmap", tab.lcmap.shape, torch.int32)
    named = {**dict(zip(_CARRY, carry)), "rows": rows,
             **cuda_libs.expect_bands(tab.bands, C, S)}
    named.update({k: v for k, v in tab._asdict().items()
                  if isinstance(v, torch.Tensor)})
    cuda_libs.contiguous(named)
    return named


def _ready(S: int) -> None:
    cuda_libs.expect_states(S, MAX_STATES)
    if _lib is None:
        build()


def step_exits(carry: Carry, rows: torch.Tensor, tab: Tables) -> Exits:
    """One frame's `hmm_step` over every channel of the carry (alpha [B,
    C, S] f32; hist, xsr, hw2, hw1 [B, C, S] int32), each state's senone
    score row xsr of the frame's rows [B, n_xs, S] f32.  Returns `Exits`;
    the carry is not modified."""
    named = _check_inputs(carry, rows, tab)
    dev = cuda_libs.one_device(named.values(), "mpx-step")
    if dev.type == "cpu":
        return step_exits_ref(carry, rows, tab)
    B, C, S = carry[0].shape
    _ready(S)
    out = Exits(carry[0].new_empty((B, C)),
                carry[1].new_empty((B, C, 3)),
                torch.full((B,), float("-inf"), device=dev))
    with torch.cuda.device(dev):
        err = _lib.mpx_step_exits_launch(
            S, *(t.data_ptr() for t in carry), rows.data_ptr(),
            *(b.data_ptr() for b in tab.bands),
            *(t.data_ptr() for t in out), B, C, rows.shape[1],
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mpx_step_exits launch failed: CUDA error {err}")
    launches["step_exits"] += 1
    return out


def prune_enter(carry: Carry, rows: torch.Tensor, st: Exits,
                ent_w: torch.Tensor, ent_pay: torch.Tensor,
                la_t: Optional[torch.Tensor], valid: torch.Tensor,
                tab: Tables) -> Carry:
    """The rest of the frame's channel update from the same carry and rows
    and kernel A's results `st`: the beams (with `tab.prune`; la_t [B,
    n_ci] the phone-loop lookahead or None), the propagation, the entries
    (ent_w [B, W] f32 each word's entry score, ent_pay [B, W, 4] int32 its
    tape slot, left-context CI phone, h2 and h1), `hmm_enter`, and valid
    [B] bool: the new carry is written into the carry's arrays, on valid
    rows only, and they are returned."""
    named = _check_inputs(carry, rows, tab)
    B, C, S = carry[0].shape
    expect(st.ex, "ex", (B, C), torch.float32)
    expect(st.exh3, "exh3", (B, C, 3), torch.int32)
    expect(st.best, "best", (B,), torch.float32)
    if ent_w.dim() != 2 or ent_w.shape[0] != B:
        raise ValueError(f"ent_w must be [{B}, W], got {tuple(ent_w.shape)}")
    W = ent_w.shape[1]
    expect(ent_w, "ent_w", (B, W), torch.float32)
    expect(ent_pay, "ent_pay", (B, W, 4), torch.int32)
    expect(valid, "valid", (B,), torch.bool)
    cuda_libs.expect_lookahead(la_t, B)
    cuda_libs.contiguous({"ex": st.ex, "exh3": st.exh3, "best": st.best,
                          "ent_w": ent_w, "ent_pay": ent_pay})
    dev = cuda_libs.one_device(
        [*named.values(), *st, ent_w, ent_pay, la_t, valid], "mpx-step")
    if dev.type == "cpu":
        return prune_enter_ref(carry, rows, st, ent_w, ent_pay, la_t, valid,
                               tab)
    _ready(S)
    if ent_pay.data_ptr() % 16:
        raise ValueError("ent_pay must be 16-byte aligned")
    with torch.cuda.device(dev):
        err = _lib.mpx_prune_enter_launch(
            S, *(t.data_ptr() for t in carry), rows.data_ptr(),
            *(b.data_ptr() for b in tab.bands),
            *(t.data_ptr() for t in st),
            *(t.data_ptr() for t in (tab.xs, tab.pc, tab.has_prev,
                                     tab.is_entry, tab.word_of, tab.lc_base,
                                     tab.ci_of, tab.lcmap, ent_w, ent_pay)),
            None if la_t is None else la_t.data_ptr(),
            0 if la_t is None else la_t.stride(0),
            valid.data_ptr(), valid.stride(0), B, C, rows.shape[1], W,
            int(tab.prune), tab.log_beam, tab.log_wbeam, tab.pip,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mpx_prune_enter launch failed: CUDA error "
                           f"{err}")
    launches["prune_enter"] += 1
    return carry
