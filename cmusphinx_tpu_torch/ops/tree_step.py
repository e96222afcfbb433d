"""The one-copy prefix-tree frame step's channel update
(`ngram_steps.TreeStep`) as two hand-written CUDA kernels, and their
plain PyTorch version.

    step_exits   (kernel A)  alpha0, hist0 [B, C, S] (the entry ages),
                             the frame's senone-sequence rows [B, n_xs,
                             S] -> `hmm_step` through each channel's
                             row: the stepped alpha
                             and age [B, C, S], the exits ex [B, C] and
                             their ages, the frame's best score best [B]
    (the search)             the word-exit beam on the word columns, the
                             exit readout (`_tree_exits`), the re-entry
                             score ent [B] and the bigram corrections corr
                             [B, R] at the roots
    prune_enter  (kernel B)  the channel beam (with the phone-loop
                             lookahead), the word-exit beam, the within-word
                             propagation with the telescoping smear, the
                             entries, `hmm_enter` and the valid mask: the
                             new carry, written into alpha0 and hist0

The entry age is the tree's token payload: 8 bits, 255 for the initial
<s> entry, advanced by `clamp_max(254) + 1` each frame.

For CPU tensors the wrappers run the plain version (`step_exits_ref`,
`prune_enter_ref`: `hmm_step`, the beams, the propagation and `hmm_enter`
as the search composed them).  For CUDA tensors they launch the kernels of
`csrc/tree_step.cu` on the current stream, or raise; they never fall back
from one to the other.  `launches` counts the kernels' launches by name.
The static step, the tree copies and the other searches keep
`ops/hmm.py`; the mpx step has its own kernels (`ops/mpx_step.py`).

The library is built with K1's (`cuda_libs.build_all`): at first use,
with nvcc for sm_90a into `build/kernels`, named by a hash of its source,
loaded with ctypes.  Nothing is compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple, Optional, Tuple

import torch

from . import cuda_libs
from .cuda_libs import expect
from .hmm import NEG_INF, hmm_enter, hmm_step

LIBRARY = "tree_step"
# States a channel the kernels are instantiated for.
MAX_STATES = 5

launches: Counter = Counter()

_lib = None


class Tables(NamedTuple):
    """A tree's channel tables and the step's constants, on one device.
    Per channel [C]: `xs` its senone-sequence row (int32), `pc` its
    predecessor channel (int32, 0 where none), `has_prev`, `is_entry`
    (bool), `root` its index among the roots (int32, 0 off the roots),
    `ci_of` its CI phone (int32), `la_delta` and `la_entry` the smear's
    within-word delta and entry value (float32); `bands` `hmm_bands`'
    five arrays (float32, contiguous).  `prune`, `log_beam`, `log_wbeam`,
    `pip`: the search's beams and phone insertion penalty, each a float32
    value."""
    xs: torch.Tensor
    pc: torch.Tensor
    has_prev: torch.Tensor
    is_entry: torch.Tensor
    root: torch.Tensor
    ci_of: torch.Tensor
    la_delta: torch.Tensor
    la_entry: torch.Tensor
    bands: Tuple[torch.Tensor, ...]
    prune: bool
    log_beam: float
    log_wbeam: float
    pip: float


class Stepped(NamedTuple):
    """Kernel A's results: alpha [B, C, S] f32 and age [B, C, S] uint8
    before the beams, ex [B, C] f32 and exh [B, C] uint8, best [B] f32."""
    alpha: torch.Tensor
    hist: torch.Tensor
    ex: torch.Tensor
    exh: torch.Tensor
    best: torch.Tensor


def build() -> float:
    """Build the kernels' library (with K1's, if either is missing) and
    load it; returns the seconds spent compiling."""
    global _lib
    spent = cuda_libs.build_all()
    if _lib is None:
        lib = ctypes.CDLL(str(cuda_libs.library_path(LIBRARY)))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.tree_step_exits_launch.argtypes = [i] + [p] * 14 + [i] * 3 + [p]
        lib.tree_step_exits_launch.restype = i
        lib.tree_prune_enter_launch.argtypes = (
            [i] + [p] * 17 + [ctypes.c_int64, p, ctypes.c_int64] + [i] * 4
            + [f] * 3 + [p])
        lib.tree_prune_enter_launch.restype = i
        _lib = lib
    return spent


def least_bytes(B: int, C: int, S: int, n_xs: int, R: int, n_ci: int,
                lookahead: bool = False) -> int:
    """The fewest bytes one frame step's channel update must move in two
    passes around the exit readout (which needs every exit before any
    entry), each array read once a pass and each output written once.
    Pass one reads alpha0 and the ages [B, C, S], the rows [B, n_xs, S],
    the rows' indices and the bands, and writes the exits and their ages
    [B, C] and the best scores.  Pass two redoes the step from the same
    inputs (no stepped [B, C, S] arrays in between: every operation of the
    step is an add or a max), reads the exits, the best scores, its
    channel tables, ent, corr [B, R], the lookahead [B, n_ci] and valid,
    and writes the carry.  These kernels do not redo the step: kernel A
    writes the stepped alpha and ages and kernel B reads them back in
    place of alpha0 and the ages, which moves 5 bytes a state more than
    this count and the rows, indices and bands once less."""
    states, chans = B * C * S, B * C
    step_in = 5 * states + 4 * B * n_xs * S + C * 4 * (1 + 3 * S - 1)
    a = step_in + 5 * chans + 4 * B
    b = (step_in + 5 * chans + 4 * B + C * (4 * 5 + 2) + 4 * B
         + 4 * B * R + (4 * B * n_ci if lookahead else 0) + B + 5 * states)
    return a + b


# ----------------------------------------------------------------------
def step_exits_ref(alpha0, hist0, rows, tab: Tables) -> Stepped:
    """Plain version of `step_exits`."""
    alpha, (hist,), ex, (exh,) = hmm_step(
        alpha0, (hist0.clamp_max(254) + 1,), rows[:, tab.xs], tab.bands)
    return Stepped(alpha, hist, ex, exh, alpha.flatten(1).amax(1))


def prune_enter_ref(alpha0, hist0, st: Stepped, ent, corr, la_t, valid,
                    tab: Tables):
    """Plain version of `prune_enter`."""
    neg = NEG_INF
    alpha, ex = st.alpha, st.ex
    if tab.prune:
        bestscr = st.best[:, None]
        cmax = alpha.amax(-1)
        if la_t is not None:
            cmax = cmax + la_t[:, tab.ci_of]
        keep = cmax > bestscr + tab.log_beam
        alpha = torch.where(keep[..., None], alpha, neg)
        ex = torch.where(ex > bestscr + tab.log_wbeam, ex, neg)
    pc = tab.pc
    prop = torch.where(tab.has_prev, ex[:, pc] + tab.pip + tab.la_delta, neg)
    bsh = torch.where(tab.has_prev, st.exh[:, pc], 255)
    entry = ent[:, None] + tab.la_entry
    if corr is not None:
        entry = entry + corr[:, tab.root]
    ie = tab.is_entry
    alpha, (hist,) = hmm_enter(
        alpha, (st.hist,), torch.where(ie, entry, prop),
        (torch.where(ie, 0, bsh).to(torch.uint8),))
    vm = valid[:, None, None]
    alpha0.copy_(torch.where(vm, alpha, alpha0))
    hist0.copy_(torch.where(vm, hist, hist0))
    return alpha0, hist0


# ----------------------------------------------------------------------
def _check_tables(tab: Tables, C: int, S: int) -> dict:
    """Check the tables; returns their tensors by name."""
    for name in ("xs", "pc", "root", "ci_of"):
        expect(getattr(tab, name), name, (C,), torch.int32)
    for name in ("has_prev", "is_entry"):
        expect(getattr(tab, name), name, (C,), torch.bool)
    for name in ("la_delta", "la_entry"):
        expect(getattr(tab, name), name, (C,), torch.float32)
    return {**{k: v for k, v in tab._asdict().items()
               if isinstance(v, torch.Tensor)},
            **cuda_libs.expect_bands(tab.bands, C, S)}


def step_exits(alpha0: torch.Tensor, hist0: torch.Tensor, rows: torch.Tensor,
               tab: Tables) -> Stepped:
    """One frame's `hmm_step` over every channel: alpha0 [B, C, S] f32,
    hist0 [B, C, S] uint8 (the entry ages), rows [B, n_xs, S] f32 (the
    frame's senone-sequence scores, each channel reading row `tab.xs`).
    Returns `Stepped`; the inputs are not modified."""
    B, C, S = alpha0.shape
    expect(hist0, "hist0", (B, C, S), torch.uint8)
    expect(alpha0, "alpha0", (B, C, S), torch.float32)
    cuda_libs.expect_rows(rows, B, S)
    named = _check_tables(tab, C, S)
    cuda_libs.contiguous({"alpha0": alpha0, "hist0": hist0, "rows": rows,
                          **named})
    dev = cuda_libs.one_device([alpha0, hist0, rows, *named.values()],
                               "tree-step")
    if dev.type == "cpu":
        return step_exits_ref(alpha0, hist0, rows, tab)
    cuda_libs.expect_states(S, MAX_STATES)
    if _lib is None:
        build()
    out = Stepped(torch.empty_like(alpha0), torch.empty_like(hist0),
                  alpha0.new_empty((B, C)), hist0.new_empty((B, C)),
                  torch.full((B,), float("-inf"), device=dev))
    with torch.cuda.device(dev):
        err = _lib.tree_step_exits_launch(
            S, alpha0.data_ptr(), hist0.data_ptr(), rows.data_ptr(),
            tab.xs.data_ptr(), *(b.data_ptr() for b in tab.bands),
            *(t.data_ptr() for t in out), B, C, rows.shape[1],
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tree_step_exits launch failed: CUDA error {err}")
    launches["step_exits"] += 1
    return out


def prune_enter(alpha0: torch.Tensor, hist0: torch.Tensor, st: Stepped,
                ent: torch.Tensor, corr: Optional[torch.Tensor],
                la_t: Optional[torch.Tensor], valid: torch.Tensor,
                tab: Tables):
    """The rest of the frame's channel update from kernel A's results
    `st`: the beams (with `tab.prune`; la_t [B, n_ci] the phone-loop
    lookahead or None), the propagation, the entries (ent [B] the
    re-entry score; corr [B, R] the roots' bigram corrections or None),
    `hmm_enter`, and valid [B] bool: the new carry is written into alpha0
    and hist0, on valid rows only, and they are returned."""
    B, C, S = alpha0.shape
    expect(alpha0, "alpha0", (B, C, S), torch.float32)
    expect(hist0, "hist0", (B, C, S), torch.uint8)
    for name, t, shape, dtype in zip(
            Stepped._fields, st, ((B, C, S), (B, C, S), (B, C), (B, C), (B,)),
            (torch.float32, torch.uint8, torch.float32, torch.uint8,
             torch.float32)):
        expect(t, name, shape, dtype)
    expect(ent, "ent", (B,), torch.float32)
    expect(valid, "valid", (B,), torch.bool)
    if corr is not None:
        if corr.dim() != 2 or corr.shape[0] != B:
            raise ValueError(f"corr must be [{B}, R], got "
                             f"{tuple(corr.shape)}")
        expect(corr, "corr", corr.shape, torch.float32)
    cuda_libs.expect_lookahead(la_t, B)
    named = _check_tables(tab, C, S)
    cuda_libs.contiguous({"alpha0": alpha0, "hist0": hist0, "ent": ent,
                          **dict(zip(Stepped._fields, st)), **named,
                          **({} if corr is None else {"corr": corr})})
    dev = cuda_libs.one_device([alpha0, hist0, *st, ent, corr, la_t, valid,
                                *named.values()], "tree-step")
    if dev.type == "cpu":
        return prune_enter_ref(alpha0, hist0, st, ent, corr, la_t, valid,
                               tab)
    cuda_libs.expect_states(S, MAX_STATES)
    if _lib is None:
        build()
    with torch.cuda.device(dev):
        err = _lib.tree_prune_enter_launch(
            S, alpha0.data_ptr(), hist0.data_ptr(),
            *(t.data_ptr() for t in st),
            *(t.data_ptr() for t in (tab.pc, tab.has_prev, tab.is_entry,
                                     tab.root, tab.ci_of, tab.la_delta,
                                     tab.la_entry, ent)),
            None if corr is None else corr.data_ptr(),
            None if la_t is None else la_t.data_ptr(),
            0 if la_t is None else la_t.stride(0),
            valid.data_ptr(), valid.stride(0), B, C,
            0 if corr is None else corr.shape[1], int(tab.prune),
            tab.log_beam, tab.log_wbeam, tab.pip,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tree_prune_enter launch failed: CUDA error "
                           f"{err}")
    launches["prune_enter"] += 1
    return alpha0, hist0
