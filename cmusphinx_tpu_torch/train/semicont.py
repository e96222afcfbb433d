"""Semi-continuous (shared VQ codebook) training.

Capability parity with the SphinxTrain semi-continuous pipeline (reference:
05.vector_quantize stage — programs agg_seg (pool/segment observations) +
kmeans_init (VQ codebook means/variances, SphinxTrain/src/programs/
kmeans_init) — then bw with a single shared codebook and per-senone mixture
weights, and mk_s2sendump export):

- `kmeans_init`: pooled feature observations -> K-codeword diagonal-Gaussian
  codebook (k-means++ seeding, GEMM distances, per-cluster variances).
- `SemiContTrainer`: Baum-Welch where all senones SHARE the codebook.
  Reestimation pools the per-senone Gaussian accumulators into one codebook
  update (the semi-continuous gauden_norm with n_mgau=1) and reestimates
  per-senone mixture weights; decode-side this is exactly the
  SemiContinuousScorer / sendump model family.
- `export_semicont`: a decodable model directory — s3 gauden files in the
  n_mgau=1 shared-codebook layout, quantized `sendump` via the repo's
  writer (byte-identical through read_sendump), mdef/tmats/feat.params.

Ported from `cmusphinx_tpu/train/semicont.py`: `kmeans_init` and the
reestimation are numpy copies (float64 k-means from a RandomState seed, so
the codebook is bit-equal to the reference's); each EM step's
forward-backward runs on `device` (default "cuda").
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .model_io import _write_s3, write_text_mdef, write_tmat
from .sentence_hmm import FlatModel
from .trainer import (MIXW_FLOOR, TMAT_FLOOR, VAR_FLOOR, HmmParams, Trainer,
                      host_acc)
from ..models.sendump import write_sendump


def kmeans_init(feats: Sequence[np.ndarray], K: int, n_iter: int = 15,
                seed: int = 0, max_obs: int = 200_000
                ) -> Tuple[np.ndarray, np.ndarray]:
    """VQ codebook from pooled observations (agg_seg + kmeans_init).

    Returns (means [K, D], var [K, D])."""
    X = np.concatenate([np.asarray(f, np.float64) for f in feats])
    rng = np.random.RandomState(seed)
    if X.shape[0] > max_obs:
        X = X[rng.choice(X.shape[0], max_obs, replace=False)]
    N, D = X.shape
    # k-means++ seeding.
    cent = np.empty((K, D))
    cent[0] = X[rng.randint(N)]
    d2 = ((X - cent[0]) ** 2).sum(1)
    for k in range(1, K):
        p = d2 / max(d2.sum(), 1e-30)
        cent[k] = X[rng.choice(N, p=p)]
        d2 = np.minimum(d2, ((X - cent[k]) ** 2).sum(1))
    x2 = (X ** 2).sum(1)
    for _ in range(n_iter):
        d = x2[:, None] - 2.0 * X @ cent.T + (cent ** 2).sum(1)[None]
        a = d.argmin(1)
        for k in range(K):
            sel = a == k
            if sel.any():
                cent[k] = X[sel].mean(0)
            else:  # reseed empty cluster at the worst-fit point
                cent[k] = X[d.min(1).argmax()]
    d = x2[:, None] - 2.0 * X @ cent.T + (cent ** 2).sum(1)[None]
    a = d.argmin(1)
    var = np.ones_like(cent)
    gv = X.var(0) + VAR_FLOOR
    for k in range(K):
        sel = a == k
        var[k] = X[sel].var(0) + VAR_FLOOR if sel.sum() > 1 else gv
    return cent.astype(np.float32), var.astype(np.float32)


class SemiContTrainer(Trainer):
    """Baum-Welch with one shared codebook (semi-continuous bw + norm)."""

    def __init__(self, model: FlatModel, pron: Dict[str, List[str]],
                 transcripts: Sequence[Sequence[str]],
                 feats: Sequence[np.ndarray], K: int = 64,
                 reest_codebook: bool = True, seed: int = 0,
                 device: torch.device | str = "cuda"):
        super().__init__(model, pron, transcripts, feats, K=1, device=device)
        cb_means, cb_var = kmeans_init(feats, K, seed=seed)
        self.K = K
        self.reest_codebook = reest_codebook
        S = model.n_sen
        self.params = HmmParams(
            means=np.broadcast_to(cb_means, (S, K, cb_means.shape[1])).copy(),
            var=np.broadcast_to(cb_var, (S, K, cb_var.shape[1])).copy(),
            lnw=np.full((S, K), -np.log(K), np.float32),
            tp=self.params.tp)

    def em_step(self) -> float:
        llh, acc = self.accumulate()
        acc = host_acc(acc)
        per_frame = float(llh.cpu().numpy().sum()) / max(int(acc["n_frames"]), 1)
        occ = acc["mixw"]                          # [S, K]
        # Mixture weights per senone (the semi-continuous free parameters).
        seen = occ.sum(-1) > 1e-8
        w = occ / np.maximum(occ.sum(-1, keepdims=True), 1e-10)
        w = np.maximum(w, MIXW_FLOOR)
        w /= w.sum(-1, keepdims=True)
        lnw = np.where(seen[:, None], np.log(w), self.params.lnw)
        # Pool Gaussian accumulators over senones -> ONE codebook update
        # (n_mgau=1 gauden_norm_wt_mean/var semantics).
        means, var = self.params.means, self.params.var
        if self.reest_codebook:
            po = np.maximum(occ.sum(0), 1e-10)[:, None]          # [K, 1]
            cm = acc["mean"].sum(0) / po                         # [K, D]
            cv = np.maximum(acc["var"].sum(0) / po - cm ** 2, VAR_FLOOR)
            S = means.shape[0]
            means = np.broadcast_to(cm.astype(np.float32),
                                    means.shape).copy()
            var = np.broadcast_to(cv.astype(np.float32), var.shape).copy()
        tacc = acc["tmat"]
        tsum = tacc.sum(-1, keepdims=True)
        tp = np.where(tsum > 1e-8, tacc / np.maximum(tsum, 1e-10),
                      self.params.tp)
        allowed = self.params.tp > 0
        tp = np.where(allowed, np.maximum(tp, TMAT_FLOOR), 0.0)
        tp /= np.maximum(tp.sum(-1, keepdims=True), 1e-10)
        self.params = HmmParams(means=means.astype(np.float32),
                                var=var.astype(np.float32),
                                lnw=lnw.astype(np.float32),
                                tp=tp.astype(np.float32))
        self.iteration += 1
        self.history.append(per_frame)
        return per_frame

    @property
    def codebook(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.params.means[0], self.params.var[0]


def export_semicont(dirpath: str, model: FlatModel, trainer: SemiContTrainer,
                    feat: str = "1s_c_d_dd", n_bits: int = 8) -> None:
    """Write a decodable semi-continuous model directory: shared-codebook
    s3 gauden (n_mgau=1, n_feat=1), quantized sendump (mk_s2sendump), text
    mdef, transition matrices, feat.params."""
    os.makedirs(dirpath, exist_ok=True)
    cb_means, cb_var = trainer.codebook
    K, D = cb_means.shape
    _write_s3(os.path.join(dirpath, "means"), "1.0",
              [cb_means.reshape(1, 1, K, D)], [1, 1, K, D, K * D])
    _write_s3(os.path.join(dirpath, "variances"), "1.0",
              [cb_var.reshape(1, 1, K, D)], [1, 1, K, D, K * D])
    # sendump wants [n_feat, n_density, n_sen].
    lnw = trainer.params.lnw.T[None]               # [1, K, S]
    write_sendump(os.path.join(dirpath, "sendump"), lnw, n_bits=n_bits)
    write_text_mdef(os.path.join(dirpath, "mdef"), model)
    write_tmat(os.path.join(dirpath, "transition_matrices"), trainer.params)
    with open(os.path.join(dirpath, "feat.params"), "w") as fh:
        fh.write(f"-feat {feat}\n-cmn current\n-agc none\n")
