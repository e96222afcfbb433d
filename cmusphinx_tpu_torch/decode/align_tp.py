"""Time-parallel forced alignment.

Port of `cmusphinx_tpu/decode/align_tp.py` (`align_time_parallel`,
`_pred_table`).  Viterbi is a max-plus linear recurrence: with the
per-frame operator A_t[i, j] = M[i, j] + ll_t[j], alpha is
a_t = a_{t-1} (x) A_t, which is associative, so time splits into chunks:

1. Pass 1 (every chunk at once): each chunk reduces its frames to a
   max-plus transfer matrix G_c[entry, exit] over the sentence HMM's
   sparse predecessor table (`_pred_table`), O(S^2 P) a frame.
2. Combine (host, float64, sequential over the chunks): boundary alphas
   a_c = a_{c-1} (x) G_c, the score max(a_D + fexit), and a backward
   argmax over the G_c for the chunk-boundary states.
3. Pass 2 (every chunk at once): a Viterbi scan a chunk from its known
   entry state, with backpointers (first index on ties, `jnp.argmax`'s
   rule); the host stitches the chunks' backtraces.

The reference shards the chunk axis over a 1-D `jax.sharding.Mesh`; here
`devices` takes that role: chunks are split into contiguous groups, one a
device, and each frame step is issued on every device in turn, so that
the devices run their groups at the same time (with None, every chunk runs
on the aligner's device).  The senone scores come from the aligner's
scorer (K1 on the card).  Max and one f32 addition a term: on the same
scores the path score is the reference's exactly; ties may pick another
path of equal score.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ngram_steps import _argmax_first

NEG = -1.0e30


def _pred_table(M: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse predecessor view of the sentence-HMM transition matrix:
    tab[j, p] = p-th predecessor state of j, w[j, p] = its log prob."""
    S = M.shape[0]
    preds = [np.nonzero(M[:, j] > NEG / 2)[0] for j in range(S)]
    P = max((len(p) for p in preds), default=1)
    tab = np.zeros((S, P), np.int32)
    w = np.full((S, P), NEG, np.float32)
    for j, ps in enumerate(preds):
        tab[j, : len(ps)] = ps
        w[j, : len(ps)] = M[ps, j]
    return tab, w


class _Group:
    """The chunks [lo, hi) on one device, with their operands there."""

    def __init__(self, dev, lo, hi, ll_ops, valid, tab, w):
        self.dev, self.lo, self.hi = torch.device(dev), lo, hi
        self.ll = ll_ops[lo:hi].to(self.dev)             # [n, L, S]
        self.valid = valid[lo:hi].to(self.dev)           # [n, L]
        self.tab = tab.to(self.dev)
        self.w = w.to(self.dev)


def _groups(devices, D: int, *args) -> List[_Group]:
    n = len(devices)
    cuts = [D * i // n for i in range(n + 1)]
    return [_Group(d, cuts[i], cuts[i + 1], *args)
            for i, d in enumerate(devices) if cuts[i + 1] > cuts[i]]


def _transfer(groups: List[_Group], S: int, L: int) -> np.ndarray:
    """Pass 1: each chunk's max-plus transfer matrix [S, S] (entry x exit),
    [D, S, S] on the host."""
    Cs = []
    for g in groups:
        eye = torch.full((S, S), NEG, device=g.dev)
        eye.fill_diagonal_(0.0)
        Cs.append(eye.expand(g.hi - g.lo, S, S).clone())
    for k in range(L):
        for i, g in enumerate(groups):
            C = Cs[i]
            cand = C[:, :, g.tab] + g.w                   # [n, S, S, P]
            Cn = (cand.amax(-1) + g.ll[:, k, None, :]).clamp_min(NEG)
            Cs[i] = torch.where(g.valid[:, k, None, None], Cn, C)
    return np.concatenate([C.cpu().numpy() for C in Cs])


def _pass2(groups: List[_Group], a_entries: np.ndarray, S: int, L: int
           ) -> np.ndarray:
    """Pass 2: constrained Viterbi over each chunk from its boundary
    alphas; backpointers [D, L, S] on the host."""
    As, Bs = [], []
    for g in groups:
        As.append(torch.as_tensor(a_entries[g.lo: g.hi]).to(g.dev))
        Bs.append(torch.empty((g.hi - g.lo, L, S), dtype=torch.int64,
                              device=g.dev))
    for k in range(L):
        for i, g in enumerate(groups):
            a = As[i]
            cand = a[:, g.tab] + g.w                      # [n, S, P]
            best = (cand.amax(-1) + g.ll[:, k]).clamp_min(NEG)
            bp = g.tab[torch.arange(S, device=g.dev), _argmax_first(cand, -1)]
            v = g.valid[:, k, None]
            As[i] = torch.where(v, best, a)
            Bs[i][:, k] = torch.where(v, bp, torch.arange(S, device=g.dev))
    return np.concatenate([B.cpu().numpy() for B in Bs])


@torch.inference_mode()
def align_time_parallel(aligner, feats, words: Sequence[str],
                        n_chunks: int = 4,
                        devices: Optional[Sequence] = None):
    """Returns (states [T] int64, score).  `aligner` is a decode.align
    AlignSearch; `devices` (a list of torch devices, or None for the
    aligner's) take the chunks in contiguous groups."""
    (state_sen, state_valid, state_phone, state_word, M, entry_lp,
     fexit, tokens, n) = aligner._build(list(words))
    dev = aligner.device
    x = torch.as_tensor(np.asarray(feats, np.float32)).to(dev)
    scores = aligner.scorer.score(x)                      # [T, n_sen]
    sen = torch.as_tensor(state_sen.astype(np.int64), device=dev)
    ok = torch.as_tensor(state_valid, device=dev)
    ll = torch.where(ok[None, :], scores[:, sen], NEG)   # [T, S]
    T = int(x.shape[0])
    S = M.shape[0]

    D = max(1, min(n_chunks, T - 1))
    # Frames 1..T-1 carry operators (frame 0 is the init); pad to D*L.
    nOp = T - 1
    L = -(-nOp // D)
    ll_ops = torch.zeros((D * L, S), device=dev)
    ll_ops[:nOp] = ll[1:]
    valid = torch.arange(D * L, device=dev) < nOp
    tab, w = _pred_table(M)
    groups = _groups(list(devices) if devices else [dev], D,
                     ll_ops.view(D, L, S), valid.view(D, L),
                     torch.as_tensor(tab.astype(np.int64)),
                     torch.as_tensor(w))
    Gs = _transfer(groups, S, L)

    # --- combine: boundary alphas + utterance score + boundary states ---
    a = (entry_lp + ll[0].cpu().numpy()).astype(np.float64)
    bounds = [a]
    for c in range(D):
        a = (a[:, None] + Gs[c]).max(0)
        bounds.append(a)
    fin = bounds[-1] + fexit
    e_last = int(np.argmax(fin))
    score = float(fin[e_last])
    # backward chunk-boundary argmax
    exits = [0] * (D + 1)
    exits[D] = e_last
    for c in range(D - 1, -1, -1):
        exits[c] = int(np.argmax(bounds[c] + Gs[c][:, exits[c + 1]]))

    # --- pass 2: constrained per-chunk scans ---
    a_entries = np.full((D, S), NEG, np.float32)
    for c in range(D):
        a_entries[c, exits[c]] = bounds[c][exits[c]]
    bps = _pass2(groups, a_entries, S, L)

    # --- stitch the state path ---
    states = np.zeros(T, np.int64)
    states[0] = exits[0]
    t = 1
    for c in range(D):
        nloc = min(L, max(0, nOp - c * L))
        if nloc == 0:
            break
        s = exits[c + 1]
        chain = [s]
        for k in range(nloc - 1, 0, -1):
            s = int(bps[c, k, s])
            chain.append(s)
        chain.reverse()
        states[t : t + nloc] = chain
        t += nloc
    return states, score
