"""Baum-Welch forward-backward: the training hot loop, batched on the device.

Capability parity with SphinxTrain bw (reference:
SphinxTrain/src/programs/bw/forward.c:179-640 scaled alpha pass,
backward.c:308 fused beta + posterior accumulation, baum_welch.c:134-290,
accum.c:323-500 accumulators, viterbi.c Viterbi-mode alignment), ported
from `cmusphinx_tpu/train/bw.py` with the same semantics:

- log-space alpha/beta with the finite sentinel NEG = -1e30 and its clamps
  (a row that is all NEG log-sum-exps to about -1e30, never to -inf);
- each sentence HMM's sparse transitions become a dense [S, S] log matrix,
  one per utterance: [B, S, S];
- the reference's `vmap` over utterances is an explicit batch axis: the
  forward pass is one Python loop over Tmax frames of a [B, S, S]
  log-sum-exp, the backward pass the same loop in reverse, and a row past
  its own length T_b keeps its carry (so beta[T_b - 1] is the exit vector);
- the state and component posteriors are reduced over time by batched
  matrix products (no [T, S, K, D] tensor), then scattered onto senones with
  `index_add_` (the padded states go to a dump row), and the edge posteriors
  onto the transition matrices with `index_put_(accumulate=True)`.  On CUDA
  both are atomics: their order of summation varies from run to run.

Every product runs in IEEE float32 (the package turns TF32 off).  The
per-component densities [b, Tmax, Smax, K] are made twice, in blocks of
utterances of at most `BLOCK_BYTES`: once for the state likelihoods, once
for the component posteriors, so that memory stays bounded at K=256.

`UttBatch` is numpy on the host, as in the reference; `UttBatch.to(device)`
moves its padded arrays once.  Every device entry point takes `device` and
defaults to "cuda".
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..decode.ngram_steps import _argmax_first
from .sentence_hmm import SentHmm

NEG = -1.0e30
# Largest [b, Tmax, Smax, K] block of per-component densities a stage makes
# at once.
BLOCK_BYTES = 1 << 30


@dataclass
class UttBatch:
    """Padded batch of sentence HMMs + features."""
    feats: np.ndarray      # [B, Tmax, D]
    T: np.ndarray          # [B]
    state_sen: np.ndarray  # [B, Smax] (padded with 0)
    smask: np.ndarray      # [B, Smax] bool
    entry_lp: np.ndarray   # [B, Smax] (0 / -inf)
    # transitions as dense coordinates for scatter
    esrc: np.ndarray       # [B, Emax]
    edst: np.ndarray
    etmat: np.ndarray
    eti: np.ndarray
    etj: np.ndarray
    emask: np.ndarray      # [B, Emax]
    fsrc: np.ndarray       # [B, Fmax]
    ftm: np.ndarray
    fti: np.ndarray
    fmask: np.ndarray
    state_phone: np.ndarray  # [B, Smax]
    state_word: np.ndarray   # [B, Smax]

    def to(self, device: torch.device | str = "cuda") -> "DeviceBatch":
        """The padded arrays on `device`: int32 indices, bool masks, float32
        features and entry scores."""
        return DeviceBatch(**{f.name: torch.as_tensor(getattr(self, f.name),
                                                      device=device)
                              for f in fields(self)})


@dataclass
class DeviceBatch:
    """An `UttBatch` moved to a device (`UttBatch.to`): the same fields as
    tensors."""
    feats: torch.Tensor
    T: torch.Tensor
    state_sen: torch.Tensor
    smask: torch.Tensor
    entry_lp: torch.Tensor
    esrc: torch.Tensor
    edst: torch.Tensor
    etmat: torch.Tensor
    eti: torch.Tensor
    etj: torch.Tensor
    emask: torch.Tensor
    fsrc: torch.Tensor
    ftm: torch.Tensor
    fti: torch.Tensor
    fmask: torch.Tensor
    state_phone: torch.Tensor
    state_word: torch.Tensor

    def to(self, device: torch.device | str = "cuda") -> "DeviceBatch":
        return DeviceBatch(**{f.name: getattr(self, f.name).to(device)
                              for f in fields(self)})


def pack_batch(hmms: Sequence[SentHmm], feats: Sequence[np.ndarray]) -> UttBatch:
    B = len(hmms)
    D = feats[0].shape[1]
    Tmax = max(f.shape[0] for f in feats)
    Smax = max(len(h.state_sen) for h in hmms)
    Emax = max(len(h.esrc) for h in hmms)
    Fmax = max(len(h.fsrc) for h in hmms)

    fe = np.zeros((B, Tmax, D), np.float32)
    T = np.zeros(B, np.int32)
    ss = np.zeros((B, Smax), np.int32)
    sm = np.zeros((B, Smax), bool)
    el = np.full((B, Smax), NEG, np.float32)
    es = np.zeros((B, Emax), np.int32)
    ed = np.zeros((B, Emax), np.int32)
    et = np.zeros((B, Emax), np.int32)
    ei = np.zeros((B, Emax), np.int32)
    ej = np.zeros((B, Emax), np.int32)
    em = np.zeros((B, Emax), bool)
    fs = np.zeros((B, Fmax), np.int32)
    fm = np.zeros((B, Fmax), bool)
    ft = np.zeros((B, Fmax), np.int32)
    fi = np.zeros((B, Fmax), np.int32)
    sp = np.zeros((B, Smax), np.int32)
    sw = np.full((B, Smax), -1, np.int32)
    for b, (h, f) in enumerate(zip(hmms, feats)):
        t, s, e, fn = f.shape[0], len(h.state_sen), len(h.esrc), len(h.fsrc)
        fe[b, :t] = f
        T[b] = t
        ss[b, :s] = h.state_sen
        sm[b, :s] = True
        el[b, :s] = h.entry_lp
        es[b, :e] = h.esrc
        ed[b, :e] = h.edst
        et[b, :e] = h.etmat
        ei[b, :e] = h.eti
        ej[b, :e] = h.etj
        em[b, :e] = True
        fs[b, :fn] = h.fsrc
        ft[b, :fn] = h.ftm
        fi[b, :fn] = h.fti
        fm[b, :fn] = True
        sp[b, :s] = h.state_phone
        sw[b, :s] = h.state_word
    return UttBatch(feats=fe, T=T, state_sen=ss, smask=sm, entry_lp=el,
                    esrc=es, edst=ed, etmat=et, eti=ei, etj=ej, emask=em,
                    fsrc=fs, ftm=ft, fti=fi, fmask=fm,
                    state_phone=sp, state_word=sw)


# ----------------------------------------------------------------------
def _senone_terms(means, prec, lnw):
    """Per-senone lin = 2 prec mean, quad = prec [n_sen, K, D] and const
    [n_sen, K] = log normaliser - sum prec mean^2 + ln w."""
    lrd = -0.5 * torch.log(2.0 * math.pi / (2.0 * prec)).sum(-1)
    return 2.0 * prec * means, prec, lrd - (prec * means * means).sum(-1) + lnw


def gmm_logliks(feats, means, prec, lnw):
    """Per-senone per-component log densities.

    feats [..., T, D]; means/prec(0.5/var) [n_sen, K, D]; lnw [n_sen, K]
    -> comp [..., T, n_sen, K], total [..., T, n_sen] (logsumexp over K).
    """
    S, K, D = means.shape
    lrd = -0.5 * torch.log(2.0 * math.pi / (2.0 * prec)).sum(-1)
    lin = (2.0 * prec * means).reshape(S * K, D)
    quad = prec.reshape(S * K, D)
    const = (lrd - (prec * means * means).sum(-1)).reshape(S * K)
    ll = (const + feats @ lin.T - (feats * feats) @ quad.T)
    comp = ll.reshape(*feats.shape[:-1], S, K) + lnw
    return comp, torch.logsumexp(comp, -1)


def _state_comp(feats, state_sen, lin, quad, const):
    """comp [b, T, S, K] of a block of utterances from the senone terms
    gathered per state: const + x.lin - x^2.quad (btd,bskd->btsk)."""
    B, T, D = feats.shape
    S = state_sen.shape[1]
    K = const.shape[1]
    idx = state_sen.long()
    lin_s = lin[idx].view(B, S * K, D)
    quad_s = quad[idx].view(B, S * K, D)
    comp = torch.baddbmm(const[idx].view(B, 1, S * K), feats,
                         lin_s.transpose(1, 2))
    comp.baddbmm_(feats * feats, quad_s.transpose(1, 2), alpha=-1.0)
    return comp.view(B, T, S, K)


def state_logliks(feats, state_sen, means, prec, lnw):
    """Per-STATE mixture log densities of a batch of sentence HMMs: params
    are gathered per state, so cost and memory scale with the sentence
    length (Smax), not the model size (n_sen).

    feats [B, T, D]; state_sen [B, S] senone per state ->
    comp [B, T, S, K] (incl. log mixture weights), ll [B, T, S]
    (logsumexp_K).
    """
    comp = _state_comp(feats, state_sen, *_senone_terms(means, prec, lnw))
    return comp, torch.logsumexp(comp, -1)


def _blocks(B: int, Tmax: int, S: int, K: int, itemsize: int):
    per = max(1, BLOCK_BYTES // max(Tmax * S * K * itemsize, 1))
    return [slice(lo, min(B, lo + per)) for lo in range(0, B, per)]


def _dense_trans(db: DeviceBatch, log_tp):
    """Edge lists -> dense [B, Smax, Smax] log transition matrices."""
    B, Smax = db.state_sen.shape
    lp = log_tp[db.etmat.long(), db.eti.long(), db.etj.long()]
    lp = torch.where(db.emask, lp, NEG)
    M = torch.full((B, Smax * Smax), NEG, dtype=log_tp.dtype,
                   device=log_tp.device)
    # duplicate (src,dst) pairs don't occur in these graphs; use max to be safe
    M.scatter_reduce_(1, (db.esrc.long() * Smax + db.edst.long()), lp,
                      "amax", include_self=True)
    return M.view(B, Smax, Smax)


def _frames_valid(db: DeviceBatch, Tmax: int):
    return torch.arange(Tmax, device=db.T.device)[None, :] < db.T[:, None]


def posterior_rtol(llh, Tmax: int) -> float:
    """Relative tolerance between two float32 passes' accumulators, or
    between one and a float64 pass: max(1e-4, 2 * 2^-24 * max|llh| *
    sqrt(Tmax)).  A posterior is exp(alpha + beta - llh), and alpha and
    beta are sums of the size of |llh| rounded once a frame: the exponent
    carries about ulp(|llh|) * sqrt(Tmax) of float32 rounding, whatever the
    order of the sums.  (Measured on the CPU against float64, with a floor
    of a tenth of the bound times the array's largest magnitude: at most
    half of 2^-24 * max|llh| * sqrt(Tmax), from either package.)"""
    if torch.is_tensor(llh):
        llh = llh.detach().cpu().numpy()
    m = float(np.max(np.abs(np.asarray(llh, np.float64)), initial=0.0))
    return max(1e-4, 2.0 * 2.0 ** -24 * m * math.sqrt(Tmax))


def phseg_to_frames(phsegs, T: int, phone_id: Dict[str, int]) -> np.ndarray:
    """Rasterize a phone segmentation (decode/align.py PhoneSeg list, the
    -phsegdir artifact) into a per-frame phone-id vector for the
    phseg-constrained forward-backward below.  Frames not covered by any
    segment get -1 (unconstrained)."""
    out = np.full(T, -1, np.int32)
    for seg in phsegs:
        pid = phone_id.get(seg.phone, -1)
        if pid >= 0:
            out[seg.start_frame : seg.end_frame + 1] = pid
    return out


# ----------------------------------------------------------------------
@dataclass
class FbPass:
    """One forward-backward pass in flight: the batch, the senone terms,
    the state likelihoods (`ll_raw` before the masks, `ll` after), the
    dense transitions, alpha and beta [B, Tmax, S], the exit scores and the
    total log-likelihood per utterance."""
    db: DeviceBatch
    terms: tuple
    log_tp: torch.Tensor
    ll_raw: torch.Tensor
    ll: torch.Tensor
    M: torch.Tensor
    alpha: torch.Tensor
    fexit: torch.Tensor
    llh: torch.Tensor
    beta: Optional[torch.Tensor] = None


def _state_ll(db: DeviceBatch, terms):
    """ll [B, Tmax, S] = logsumexp_K of the state densities, by blocks."""
    x = db.feats.to(terms[0].dtype)
    B, Tmax, _ = x.shape
    S, K = db.state_sen.shape[1], terms[2].shape[1]
    return torch.cat([
        torch.logsumexp(_state_comp(x[b], db.state_sen[b], *terms), -1)
        for b in _blocks(B, Tmax, S, K, x.element_size())])


def _exit_scores(db: DeviceBatch, a_last, log_tp):
    nst = log_tp.shape[1]
    fexit = (a_last.gather(1, db.fsrc.long())
             + log_tp[db.ftm.long(), db.fti.long(), nst])
    return torch.where(db.fmask, fexit, NEG)


def fb_forward(batch, means, prec, lnw, log_tp, phseg=None,
               device: torch.device | str = "cuda") -> FbPass:
    """The forward half of `forward_backward`: state likelihoods, dense
    transitions, the alpha pass and each utterance's log-likelihood."""
    db = batch.to(device)
    means, prec, lnw, log_tp = (torch.as_tensor(a, device=device)
                                for a in (means, prec, lnw, log_tp))
    terms = _senone_terms(means, prec, lnw)
    B, Tmax, _ = db.feats.shape
    # ACTIVE-STATE densities: only the sentence HMM's Smax states (params
    # gathered per state), not all n_sen senones — the reference's pattern
    # (bw computes densities per active state, forward.c:383-405).
    ll_raw = _state_ll(db, terms)
    ll = torch.where(db.smask[:, None, :], ll_raw, NEG)
    if phseg is not None:
        ph = torch.as_tensor(phseg, device=device)[:, :, None]
        allowed = (ph < 0) | (db.state_phone[:, None, :] == ph)
        ll = torch.where(allowed, ll, NEG)
    M = _dense_trans(db, log_tp)                              # [B, S, S]
    valid = _frames_valid(db, Tmax)

    alpha = torch.empty_like(ll)
    a = db.entry_lp.to(ll.dtype) + ll[:, 0]
    alpha[:, 0] = a
    for t in range(1, Tmax):
        nxt = torch.logsumexp(a[:, :, None] + M, dim=1) + ll[:, t]
        a = torch.where(valid[:, t, None], nxt.clamp_min(NEG), a)
        alpha[:, t] = a

    # Final exit arcs at each row's true last frame.
    last = (db.T.long() - 1).clamp_min(0)
    a_last = alpha[torch.arange(B, device=ll.device), last]
    fexit = _exit_scores(db, a_last, log_tp)
    llh = torch.logsumexp(fexit, 1)
    return FbPass(db=db, terms=terms, log_tp=log_tp, ll_raw=ll_raw, ll=ll,
                  M=M, alpha=alpha, fexit=fexit, llh=llh)


def fb_backward(p: FbPass) -> FbPass:
    """The beta pass: beta[T_b - 1] is the exit vector bT; frames at or
    past T_b keep the carry (the reference's where(valid, prev, b))."""
    db, ll, M, log_tp = p.db, p.ll, p.M, p.log_tp
    B, Tmax, S = ll.shape
    nst = log_tp.shape[1]
    exit_lp = torch.where(db.fmask,
                          log_tp[db.ftm.long(), db.fti.long(), nst], NEG)
    b = torch.full((B, S), NEG, dtype=ll.dtype, device=ll.device)
    b.scatter_reduce_(1, db.fsrc.long(), exit_lp, "amax", include_self=True)
    valid = _frames_valid(db, Tmax)
    beta = torch.empty_like(ll)
    beta[:, Tmax - 1] = b
    for t in range(Tmax - 2, -1, -1):
        prev = torch.logsumexp(M + (b + ll[:, t + 1])[:, None, :], dim=2)
        b = torch.where(valid[:, t + 1, None], prev.clamp_min(NEG), b)
        beta[:, t] = b
    p.beta = beta
    return p


def fb_accumulate(p: FbPass, weights=None):
    """Posteriors and accumulators of a finished pass: returns (llh [B],
    {"mixw", "mean", "var", "tmat", "n_frames"})."""
    db, terms, llh = p.db, p.terms, p.llh
    B, Tmax, S = p.ll.shape
    lin = terms[0]
    n_sen, K, D = lin.shape
    dev = lin.device
    w = (None if weights is None
         else torch.as_tensor(weights, dtype=lin.dtype, device=dev))
    valid = _frames_valid(db, Tmax)

    # State posteriors.
    gamma = p.alpha + p.beta - llh[:, None, None]              # [B, T, S]
    gamma = torch.where(valid[:, :, None] & db.smask[:, None, :], gamma, NEG)
    g = gamma.clamp_max_(0.0).exp_()

    # Component posteriors, reduced over time by batched products, then
    # scattered to senones.  The normaliser is the state likelihood BEFORE
    # the masks: equal to the reference's wherever a state is live, and
    # finite where it is masked (g = 0 there), so a state the phone
    # segmentation rules out at some frame adds 0, not 0 * inf = NaN.
    x = db.feats.to(lin.dtype)
    rs = lin.new_empty(B, S, K)
    ms = lin.new_empty(B, S * K, D)
    vs = lin.new_empty(B, S * K, D)
    for b in _blocks(B, Tmax, S, K, x.element_size()):
        r = _state_comp(x[b], db.state_sen[b], *terms)
        r.sub_(p.ll_raw[b][..., None]).clamp_min_(-60.0).exp_()
        r.mul_(g[b][..., None])
        rs[b] = r.sum(1)
        rt = r.view(r.shape[0], Tmax, S * K).transpose(1, 2)
        torch.bmm(rt, x[b], out=ms[b])
        torch.bmm(rt, x[b] * x[b], out=vs[b])
        del r, rt   # free this block before the next is made
    if w is not None:
        rs *= w[:, None, None]
        ms *= w[:, None, None]
        vs *= w[:, None, None]
    seg = torch.where(db.smask, db.state_sen.long(), n_sen).reshape(-1)
    mixw = lin.new_zeros(n_sen + 1, K).index_add_(0, seg, rs.view(B * S, K))
    mean = lin.new_zeros(n_sen + 1, K, D).index_add_(
        0, seg, ms.view(B * S, K, D))
    var = lin.new_zeros(n_sen + 1, K, D).index_add_(
        0, seg, vs.view(B * S, K, D))

    # Transition accumulation: xi over edges, t in 0..T-2:
    # alpha[t,src] + lp + ll[t+1,dst] + beta[t+1,dst] - llh.
    log_tp = p.log_tp
    n_tmat, nst = log_tp.shape[0], log_tp.shape[1]
    E = db.esrc.shape[1]
    etm, eti, etj = db.etmat.long(), db.eti.long(), db.etj.long()
    elp = log_tp[etm, eti, etj]                                 # [B, E]
    src = db.esrc.long()[:, None, :].expand(B, Tmax - 1, E)
    dst = db.edst.long()[:, None, :].expand(B, Tmax - 1, E)
    xi = p.alpha[:, :-1].gather(2, src)
    xi.add_(elp[:, None, :]).add_(p.ll[:, 1:].gather(2, dst))
    xi.add_(p.beta[:, 1:].gather(2, dst)).sub_(llh[:, None, None])
    xi = torch.where(valid[:, 1:, None] & db.emask[:, None, :], xi, NEG)
    xe = xi.clamp_max_(0.0).exp_().sum(1)                       # [B, E]
    # exit arcs count once at T-1
    fpost = (p.fexit - llh[:, None]).clamp_max(0.0).exp()       # [B, F]
    if w is not None:
        xe = xe * w[:, None]
        fpost = fpost * w[:, None]
    tacc = lin.new_zeros(n_tmat, nst, nst + 1)
    tacc.index_put_((etm.reshape(-1), eti.reshape(-1), etj.reshape(-1)),
                    torch.where(db.emask, xe, 0.0).reshape(-1),
                    accumulate=True)
    ftm, fti = db.ftm.long().reshape(-1), db.fti.long().reshape(-1)
    tacc.index_put_((ftm, fti, torch.full_like(ftm, nst)),
                    torch.where(db.fmask, fpost, 0.0).reshape(-1),
                    accumulate=True)
    acc = {"mixw": mixw[:-1], "mean": mean[:-1], "var": var[:-1],
           "tmat": tacc, "n_frames": db.T.sum()}
    return llh, acc


def forward_backward(batch, means, prec, lnw, log_tp, weights=None,
                     phseg=None, device: torch.device | str = "cuda"):
    """One EM pass over a padded utterance batch (an `UttBatch`, or a
    `DeviceBatch` already moved).

    Returns (total log-likelihood [B], accumulators dict) as tensors on
    `device`.  The parameters' dtype (float32; float64 for a reference
    computation) is the dtype of the pass.

    `weights` [B] optionally scales each utterance's contribution to the
    accumulators (used for lattice-posterior-weighted MMIE denominator
    statistics, SphinxTrain bw -mmie capability).

    `phseg` [B, Tmax] optionally constrains the state space per frame to
    states whose phone matches the given segmentation (the reference's
    -phsegdir gating, bw/forward.c:223-224 can_prune_phseg): a state is
    active at frame t only when phseg[b, t] < 0 (unconstrained) or equals
    the state's `state_phone` id.  Ids must live in the same space the
    sentence HMM was built with (`phseg_to_frames` maps PhoneSeg names).
    """
    p = fb_forward(batch, means, prec, lnw, log_tp, phseg=phseg,
                   device=device)
    return fb_accumulate(fb_backward(p), weights)


def viterbi_align(batch, means, prec, lnw, log_tp,
                  device: torch.device | str = "cuda"):
    """Forced alignment: best state sequence per utterance (viterbi.c /
    pocketsphinx state_align_search capability).

    Returns (scores [B], states [B, Tmax]) — state index at each frame
    (into the utterance's sentence HMM; -1 on padding).  Ties go to the
    lowest index, as `jnp.argmax` gives them.
    """
    db = batch.to(device)
    means, prec, lnw, log_tp = (torch.as_tensor(a, device=device)
                                for a in (means, prec, lnw, log_tp))
    terms = _senone_terms(means, prec, lnw)
    B, Tmax, _ = db.feats.shape
    ll = torch.where(db.smask[:, None, :], _state_ll(db, terms), NEG)
    M = _dense_trans(db, log_tp)
    valid = _frames_valid(db, Tmax)

    alpha = torch.empty_like(ll)
    bps = torch.empty(B, max(Tmax - 1, 0), ll.shape[2], dtype=torch.long,
                      device=ll.device)
    a = db.entry_lp.to(ll.dtype) + ll[:, 0]
    alpha[:, 0] = a
    for t in range(1, Tmax):
        cand = a[:, :, None] + M
        nxt = cand.amax(1) + ll[:, t]
        bps[:, t - 1] = _argmax_first(cand, 1)
        a = torch.where(valid[:, t, None], nxt.clamp_min(NEG), a)
        alpha[:, t] = a
    rows = torch.arange(B, device=ll.device)
    last = (db.T.long() - 1).clamp_min(0)
    fexit = _exit_scores(db, alpha[rows, last], log_tp)
    best = _argmax_first(fexit, 1)
    score = fexit[rows, best]
    s = db.fsrc.long()[rows, best]

    # Backtrace through bps [B, Tmax-1, S], only within each true length.
    states = torch.empty(B, Tmax, dtype=torch.long, device=ll.device)
    states[:, Tmax - 1] = s
    for t in range(Tmax - 2, -1, -1):
        prev = bps[:, t].gather(1, s[:, None])[:, 0]
        s = torch.where(t + 1 <= last, prev, s)
        states[:, t] = s
    states = torch.where(valid, states, -1)
    return score, states


def alignment_scores(batch, means, prec, lnw, log_tp, states,
                     device: torch.device | str = "cuda"):
    """The score [B] of given state paths ([B, Tmax], -1 past each row's
    length, as `viterbi_align` returns them) through their sentence HMMs:
    entry + state likelihoods + transitions + exit, in the parameters'
    dtype.  Two paths of one utterance that score alike are a near-tie of
    the Viterbi search."""
    db = batch.to(device)
    means, prec, lnw, log_tp = (torch.as_tensor(a, device=device)
                                for a in (means, prec, lnw, log_tp))
    terms = _senone_terms(means, prec, lnw)
    B, Tmax, _ = db.feats.shape
    ll = torch.where(db.smask[:, None, :], _state_ll(db, terms), NEG)
    M = _dense_trans(db, log_tp)
    valid = _frames_valid(db, Tmax)
    st = torch.as_tensor(states, device=device).long().clamp_min(0)
    rows = torch.arange(B, device=ll.device)
    emit = ll.gather(2, st[..., None])[..., 0]                  # [B, T]
    step = M[rows[:, None], st[:, :-1], st[:, 1:]] + emit[:, 1:]
    last = (db.T.long() - 1).clamp_min(0)
    exit_lp = torch.where(db.fmask, log_tp[db.ftm.long(), db.fti.long(),
                                           log_tp.shape[1]], NEG)
    exits = torch.where(db.fsrc.long() == st[rows, last][:, None], exit_lp,
                        NEG).amax(1)
    return (db.entry_lp.to(ll.dtype)[rows, st[:, 0]] + emit[:, 0]
            + torch.where(valid[:, 1:], step, 0.0).sum(1) + exits)

