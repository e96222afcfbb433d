"""MMIE discriminative training: lattice-based numerator/denominator
Baum-Welch with extended-BW (EBW) parameter updates.

Capability parity with SphinxTrain's MMIE mode (reference:
SphinxTrain/src/programs/bw/main.c:1055-1500 lattice-based num/den
accumulation; pipeline stages scripts_pl/60-65 lattice generation /
pruning / MMIE training), ported from `cmusphinx_tpu/train/mmie.py`: the
accumulation runs on `device` (default "cuda"), the lattice packing and
the EBW update are host copies.  Formulation:

- Numerator statistics = the ordinary transcript forward-backward
  (`bw.forward_backward`), exactly as in ML training.
- Denominator statistics = forward-backward over each DECODED word lattice:
  every lattice node (word, start frame, end frame) becomes a small
  word-level sentence HMM over its frame span, and its accumulators are
  scaled by the node's lattice posterior (the probability mass of all
  competitor paths through that word).  All node-HMMs across all lattice
  nodes are packed into ONE padded batch and run as a single batched
  forward-backward — the lattice structure is consumed on the host, the
  FLOPs run dense on the device.
- Update = extended Baum-Welch with per-Gaussian smoothing constant
  D = max(E * den_occupancy, ml_floor) chosen per mixture so variances
  stay positive (standard EBW; main.c's -constE).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .bw import UttBatch, forward_backward, pack_batch
from .sentence_hmm import FlatModel, SentHmm, build_sentence_hmm
from .trainer import HmmParams, device_params, host_acc


def lattice_den_batch(lattice, feats: np.ndarray,
                      pron: Dict[str, List[str]], model: FlatModel,
                      ascale: float = 0.05,
                      min_post: float = 1e-3
                      ) -> Tuple[UttBatch, np.ndarray]:
    """Pack one utterance's lattice into a denominator FB batch.

    lattice: a decode.lattice.Lattice for this utterance (its `nodes` and
    `posterior(ascale)`); feats [T, D];
    returns (UttBatch of per-node word HMMs over their frame spans,
    node posterior weights [N]).  Nodes whose posterior falls below
    `min_post` are dropped (lattice pruning, stage 61 capability).
    """
    post = np.exp(np.minimum(lattice.posterior(ascale), 0.0))
    hmms: List[SentHmm] = []
    spans: List[np.ndarray] = []
    weights: List[float] = []
    for node, p in zip(lattice.nodes, post):
        if p < min_post:
            continue
        w = node.word.split("(")[0]
        if w in ("<s>", "</s>") or w.startswith("<") or w.startswith("++"):
            # Fillers map to the silence phone if present.
            if "SIL" not in model.phone_id:
                continue
            h = build_sentence_hmm(["<fil>"], {"<fil>": ["SIL"]}, model,
                                   optional_sil=False)
        else:
            if w not in pron:
                continue
            h = build_sentence_hmm([w], pron, model, optional_sil=False)
        sf, ef = int(node.sf), int(node.ef)
        span = feats[sf : ef + 1]
        if span.shape[0] < 1:
            continue
        hmms.append(h)
        spans.append(np.asarray(span, np.float32))
        weights.append(float(p))
    if not hmms:
        raise ValueError("no lattice nodes survived posterior pruning")
    return pack_batch(hmms, spans), np.asarray(weights, np.float32)


def accumulate_mmie(num_batch: UttBatch, den_batch: UttBatch,
                    den_weights: np.ndarray, params: HmmParams,
                    device: torch.device | str = "cuda"
                    ) -> Tuple[Dict, Dict, float]:
    """One utterance-set MMIE accumulation pass on `device`.

    Returns (num_acc, den_acc, objective) where objective ~ sum(num llh) -
    sum(posterior-weighted den llh) — the MMI criterion up to constants;
    the accumulators as host numpy arrays.
    """
    args = device_params(params, device)
    llh_n, num_acc = forward_backward(num_batch, *args, device=device)
    llh_d, den_acc = forward_backward(den_batch, *args, weights=den_weights,
                                      device=device)
    w = torch.as_tensor(den_weights, dtype=llh_d.dtype, device=llh_d.device)
    obj = float(llh_n.sum()) - float((w * llh_d).sum())
    return host_acc(num_acc), host_acc(den_acc), obj


def ebw_update(params: HmmParams, num_acc: Dict, den_acc: Dict,
               E: float = 2.0, min_var: float = 1e-4,
               mixw_floor: float = 1e-5) -> HmmParams:
    """Extended Baum-Welch update of means/variances/mixture weights.

    D_sk = max(E * den_gamma_sk, 2 * D_min) where D_min is the smallest
    constant keeping the new variance positive (halved-interval check as in
    the standard EBW recipe; main.c MMIE update capability).
    """
    ng = num_acc["mixw"]          # [S, K] occupancies
    dg = den_acc["mixw"]
    nx = num_acc["mean"]          # [S, K, D]
    dx = den_acc["mean"]
    nx2 = num_acc["var"]
    dx2 = den_acc["var"]
    mu, var = params.means.astype(np.float64), params.var.astype(np.float64)

    # Per-Gaussian smoothing constant.
    D0 = E * dg
    # Increase D until variance positive: solve quadratic check numerically.
    D = np.maximum(D0, 1.0)
    for _ in range(12):
        denom = (ng - dg + D)[..., None]
        mu_new = (nx - dx + D[..., None] * mu) / np.maximum(denom, 1e-10)
        var_new = ((nx2 - dx2 + D[..., None] * (var + mu * mu))
                   / np.maximum(denom, 1e-10)) - mu_new * mu_new
        bad = (var_new <= min_var).any(-1) | (denom[..., 0] <= 1e-6)
        if not bad.any():
            break
        D = np.where(bad, D * 2.0, D)
    denom = (ng - dg + D)[..., None]
    mu_new = (nx - dx + D[..., None] * mu) / np.maximum(denom, 1e-10)
    var_new = ((nx2 - dx2 + D[..., None] * (var + mu * mu))
               / np.maximum(denom, 1e-10)) - mu_new * mu_new
    var_new = np.maximum(var_new, min_var)

    # EBW mixture-weight update (iterative fixed point).
    w = np.exp(params.lnw.astype(np.float64))
    w = w / np.maximum(w.sum(-1, keepdims=True), 1e-10)
    C = np.max(dg / np.maximum(w, 1e-10), axis=-1, keepdims=True) + 1.0
    for _ in range(20):
        num = ng - dg + C * w
        num = np.maximum(num, mixw_floor)
        w_new = num / np.maximum(num.sum(-1, keepdims=True), 1e-10)
        if np.max(np.abs(w_new - w)) < 1e-8:
            w = w_new
            break
        w = w_new

    # Transitions: plain ML on numerator counts (EBW tmat updates buy
    # little; matches common practice and the reference's default focus).
    tn = num_acc["tmat"]
    tden = tn.sum(-1, keepdims=True)
    tp = np.where(tden > 0, tn / np.maximum(tden, 1e-10), params.tp)

    return HmmParams(means=mu_new.astype(np.float32),
                     var=var_new.astype(np.float32),
                     lnw=np.log(np.maximum(w, mixw_floor)).astype(np.float32),
                     tp=tp.astype(np.float64))
