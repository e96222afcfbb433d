"""Vectorized per-HMM Viterbi step (port of `cmusphinx_tpu/ops/hmm.py`).

Semantics match the reference exactly:
- emission first: s[j] = alpha[j] + sen[j];
- exit into the non-emitting final state from the last two states,
  exit = max(s[S-1] + tp[S-1, S], s[S-2] + tp[S-2, S]), last state on ties;
- Bakis transitions with at most one skip,
  alpha'[j] = max(s[j] + tp[j,j], s[j-1] + tp[j-1,j], s[j-2] + tp[j-2,j]),
  ties resolved self loop first, then j-1, then j-2;
- integer payloads (backpointer slots, mpx xs rows, LM history words) ride
  along with the argmax.

Scores are float32 natural logs.  `NEG_INF` stays the finite -1e30 sentinel:
the decoder compares against `NEG_INF * 0.5`, and a log-sum-exp over a row
of `-inf` would give NaN.

`hmm_step` and `hmm_enter` take any number of leading batch dimensions:
alpha, payloads and senone scores are `[..., N, S]`, and the transitions
come as the bands of `hmm_bands`, computed once per graph.  One form serves
every search: the reference's channel-major, batch-major `[B, S, C]` and
flat state-major `_sm` variants differ only in layout, chosen for the
TPU's lanes.  Payloads keep their dtype (int32 in the mpx carry).  On the
card the N-gram search's mpx step and one-copy tree step run these
semantics in hand-written kernels (`ops/mpx_step.py`, `ops/tree_step.py`),
whose plain versions compose the functions here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

NEG_INF = float(np.float32(-1.0e30))

Payloads = Tuple[torch.Tensor, ...]


def hmm_init_state(n: int, n_state: int, n_payload: int = 1, *,
                   device: torch.device | str):
    """Fresh (inactive) HMM state: scores at NEG_INF, payloads -1."""
    alpha = torch.full((n, n_state), NEG_INF, dtype=torch.float32,
                       device=device)
    payloads = tuple(torch.full((n, n_state), -1, dtype=torch.int32,
                                device=device) for _ in range(n_payload))
    return alpha, payloads


def hmm_bands(log_tp: np.ndarray):
    """Transition bands from [N, S, S+1] matrices (host numpy, once per
    graph): (d0 [N, S] self loops, d1 [N, S-1], d2 [N, S-2] skips,
    e_last [N], e_prev [N] exits).  The reference's bands, laid out
    channel-major like the states instead of flat state-major."""
    N, S = log_tp.shape[0], log_tp.shape[1]
    j = np.arange(S)
    d0 = log_tp[:, j, j]
    d1 = log_tp[:, j[:-1], j[:-1] + 1]
    d2 = log_tp[:, j[:-2], j[:-2] + 2]
    e_last = log_tp[:, S - 1, S]
    e_prev = log_tp[:, S - 2, S] if S >= 2 else np.full(N, NEG_INF)
    return d0, d1, d2, e_last, e_prev


def hmm_step(alpha: torch.Tensor, payloads: Payloads, sen: torch.Tensor,
             bands: Tuple[torch.Tensor, ...]):
    """One Viterbi frame update for N HMMs.

    alpha:    [..., N, S] state scores (emission not yet applied)
    payloads: tuple of [..., N, S] integer tensors carried with the argmax
    sen:      [..., N, S] senone scores per state
    bands:    `hmm_bands`' arrays as tensors on alpha's device

    Returns (new_alpha, new_payloads, exit_score [..., N],
    exit_payloads tuple of [..., N]).
    """
    S = alpha.shape[-1]
    d0, d1, d2, e_last, e_prev = bands
    s = alpha + sen

    e_l = s[..., S - 1] + e_last
    if S >= 2:
        e_p = s[..., S - 2] + e_prev
        take_last = e_l >= e_p
        exit_score = torch.where(take_last, e_l, e_p)
        exit_payloads = tuple(
            torch.where(take_last, p[..., S - 1], p[..., S - 2])
            for p in payloads)
    else:
        exit_score = e_l
        exit_payloads = tuple(p[..., S - 1] for p in payloads)
    exit_score = exit_score.clamp_min(NEG_INF)

    c_self = s + d0
    if S == 1:
        return c_self.clamp_min(NEG_INF), payloads, exit_score, exit_payloads

    # Candidates from j-1 and j-2; the first states' payloads stand in for
    # their missing predecessors (their scores are NEG_INF).
    neg = s.new_full(s.shape[:-1] + (min(S - 1, 2),), NEG_INF)
    c_prev = torch.cat([neg[..., :1], s[..., :-1] + d1], -1)
    p_prev = [torch.cat([p[..., :1], p[..., :-1]], -1) for p in payloads]
    if S >= 3:
        c_skip = torch.cat([neg, s[..., :-2] + d2], -1)
        p_skip = [torch.cat([p[..., :2], p[..., :-2]], -1) for p in payloads]
        m12 = torch.maximum(c_prev, c_skip)
        new_alpha = torch.maximum(c_self, m12)
        sel_self = c_self >= m12
        sel_prev = c_prev >= c_skip
        new_payloads = tuple(
            torch.where(sel_self, p, torch.where(sel_prev, pp, ps))
            for p, pp, ps in zip(payloads, p_prev, p_skip))
    else:
        new_alpha = torch.maximum(c_self, c_prev)
        sel_self = c_self >= c_prev
        new_payloads = tuple(torch.where(sel_self, p, pp)
                             for p, pp in zip(payloads, p_prev))
    return (new_alpha.clamp_min(NEG_INF), new_payloads, exit_score,
            exit_payloads)


def hmm_enter(alpha: torch.Tensor, payloads: Payloads,
              entry_score: torch.Tensor, entry_payloads: Payloads):
    """Inject entry tokens into state 0 where the entry score is better
    (hmm_enter semantics).  entry_score / entry_payloads: [..., N].
    Returns new tensors; the inputs are not modified."""
    better = entry_score > alpha[..., 0]
    new_alpha = alpha.clone()
    new_alpha[..., 0] = torch.where(better, entry_score, alpha[..., 0])
    new_payloads = []
    for p, ep in zip(payloads, entry_payloads):
        q = p.clone()
        q[..., 0] = torch.where(better, ep.to(p.dtype), p[..., 0])
        new_payloads.append(q)
    return new_alpha, tuple(new_payloads)
