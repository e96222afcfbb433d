"""Training orchestration: EM loop, reestimation, checkpointing, scale-out.

Capability parity with SphinxTrain's norm + the scripts_pl convergence loop
(reference: SphinxTrain/src/programs/norm/main.c summing bw accumulator
dirs and reestimating via gauden_norm_wt_mean/var gauden.c:1568-1795;
scripts_pl/20.ci_hmm/slave_convg.pl:59-136 likelihood-ratio convergence;
bw/main.c:464-485 -ckptintv accumulator+cursor checkpointing), ported from
`cmusphinx_tpu/train/trainer.py`:

- the parameters and the accumulators stay numpy on the host; the batch
  moves to the device once and each EM step's forward-backward runs there;
- data-parallel EM runs over `torch.distributed`: each rank takes a
  contiguous block of the batch and the accumulators are summed with
  `all_reduce` (the reference's `psum` over `dp`, and `norm`'s file
  summation);
- checkpoints are npz files of the parameters + iteration + history, the
  same layout as the reference's (either package loads the other's);
- flat start (init_gau/mk_flat capability): global mean/variance plus
  deterministic small perturbations per component.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .bw import UttBatch, forward_backward, pack_batch
from .sentence_hmm import FlatModel, build_sentence_hmm

MIXW_FLOOR = 1e-5
VAR_FLOOR = 1e-4
TMAT_FLOOR = 1e-4


@dataclass
class HmmParams:
    """Trainable parameter set (continuous diagonal GMMs per senone)."""
    means: np.ndarray   # [n_sen, K, D]
    var: np.ndarray     # [n_sen, K, D]
    lnw: np.ndarray     # [n_sen, K] log mixture weights
    tp: np.ndarray      # [n_tmat, n, n+1] probabilities

    @property
    def prec(self) -> np.ndarray:
        return (0.5 / self.var).astype(np.float32)

    @property
    def log_tp(self) -> np.ndarray:
        with np.errstate(divide="ignore"):
            return np.where(self.tp > 0, np.log(np.maximum(self.tp, 1e-30)),
                            -1.0e30).astype(np.float32)


def flat_start(model: FlatModel, feats: Sequence[np.ndarray], K: int = 1,
               seed: int = 0) -> HmmParams:
    """Global-stats initialization (init_gau + norm capability), with small
    deterministic mean perturbations to break component symmetry."""
    allf = np.concatenate([np.asarray(f) for f in feats])
    gm = allf.mean(0)
    gv = allf.var(0) + VAR_FLOOR
    D = allf.shape[1]
    rng = np.random.RandomState(seed)
    means = np.tile(gm, (model.n_sen, K, 1)).astype(np.float32)
    if K > 1:
        means += (rng.randn(model.n_sen, K, D) * 0.1 *
                  np.sqrt(gv)[None, None, :]).astype(np.float32)
    var = np.tile(gv, (model.n_sen, K, 1)).astype(np.float32)
    lnw = np.full((model.n_sen, K), -np.log(K), np.float32)
    return HmmParams(means=means, var=var, lnw=lnw,
                     tp=model.init_tmat().astype(np.float32))


def reestimate(params: HmmParams, acc: Dict[str, np.ndarray]) -> HmmParams:
    """norm: accumulators -> new parameters (gauden_norm_wt_mean/var)."""
    occ = np.asarray(acc["mixw"])          # [n_sen, K]
    mean_acc = np.asarray(acc["mean"])     # [n_sen, K, D]
    var_acc = np.asarray(acc["var"])
    denom = np.maximum(occ, 1e-10)[..., None]
    new_means = mean_acc / denom
    # var = E[x^2] - mean^2, floored (gauden.c:1668 norm_wt_var).
    new_var = var_acc / denom - new_means ** 2
    new_var = np.maximum(new_var, VAR_FLOOR)
    # Untouched senones keep their old parameters.
    seen = occ.sum(-1) > 1e-8              # [n_sen]
    new_means = np.where(seen[:, None, None], new_means, params.means)
    new_var = np.where(seen[:, None, None], new_var, params.var)
    w = occ / np.maximum(occ.sum(-1, keepdims=True), 1e-10)
    w = np.maximum(w, MIXW_FLOOR)
    w /= w.sum(-1, keepdims=True)
    lnw = np.where(seen[:, None], np.log(w), params.lnw)
    tacc = np.asarray(acc["tmat"])
    tsum = tacc.sum(-1, keepdims=True)
    tp = np.where(tsum > 1e-8, tacc / np.maximum(tsum, 1e-10), params.tp)
    # Floor only topologically-allowed transitions (tmat.c semantics).
    allowed = params.tp > 0
    tp = np.where(allowed, np.maximum(tp, TMAT_FLOOR), 0.0)
    tp /= np.maximum(tp.sum(-1, keepdims=True), 1e-10)
    return HmmParams(means=new_means.astype(np.float32),
                     var=new_var.astype(np.float32),
                     lnw=lnw.astype(np.float32), tp=tp.astype(np.float32))


def host_acc(acc: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """A pass's accumulators as host numpy arrays."""
    return {k: v.cpu().numpy() for k, v in acc.items()}


def device_params(params: HmmParams, device) -> tuple:
    """(means, prec, lnw, log_tp) of `params` as tensors on `device`."""
    return tuple(torch.as_tensor(a, device=device) for a in (
        params.means, params.prec, params.lnw, params.log_tp))


class Trainer:
    """Baum-Welch EM over a corpus of (transcript, features) pairs; the
    forward-backward runs on `device`."""

    def __init__(self, model: FlatModel, pron: Dict[str, List[str]],
                 transcripts: Sequence[Sequence[str]],
                 feats: Sequence[np.ndarray], K: int = 1,
                 ckpt_dir: Optional[str] = None,
                 device: torch.device | str = "cuda"):
        self.model = model
        self.device = torch.device(device)
        hmms = [build_sentence_hmm(t, pron, model) for t in transcripts]
        self.batch = pack_batch(hmms, [np.asarray(f) for f in feats])
        self.dbatch = self.batch.to(self.device)
        self.params = flat_start(model, feats, K=K)
        self.ckpt_dir = ckpt_dir
        self.iteration = 0
        self.history: List[float] = []

    # ------------------------------------------------------------------
    def accumulate(self, params: Optional[HmmParams] = None):
        """One forward-backward over the corpus at `params` (the current
        parameters by default): (llh [B], accumulators) on the device."""
        params = self.params if params is None else params
        return forward_backward(self.dbatch,
                                *device_params(params, self.device),
                                device=self.device)

    def _finish_step(self, total_ll: float, acc) -> float:
        per_frame = total_ll / max(int(acc["n_frames"]), 1)
        self.params = reestimate(self.params, acc)
        self.iteration += 1
        self.history.append(per_frame)
        return per_frame

    def em_step(self) -> float:
        """One full-corpus EM iteration; returns mean per-frame log-lik."""
        llh, acc = self.accumulate()
        acc = host_acc(acc)
        per_frame = self._finish_step(float(llh.cpu().numpy().sum()), acc)
        if self.ckpt_dir:
            self.save_checkpoint()
        return per_frame

    def train(self, max_iter: int = 20, conv_ratio: float = 1e-3) -> List[float]:
        """slave_convg.pl loop: iterate until the likelihood improvement
        ratio falls below conv_ratio."""
        prev = None
        for _ in range(max_iter):
            ll = self.em_step()
            if prev is not None:
                denom = abs(prev) if prev else 1.0
                if (ll - prev) / denom < conv_ratio and ll >= prev:
                    break
            prev = ll
        return self.history

    # ------------------------------------------------------------------
    def save_checkpoint(self) -> str:
        os.makedirs(self.ckpt_dir, exist_ok=True)
        path = os.path.join(self.ckpt_dir, f"ckpt_{self.iteration:03d}.npz")
        np.savez(path, means=self.params.means, var=self.params.var,
                 lnw=self.params.lnw, tp=self.params.tp,
                 iteration=self.iteration,
                 history=np.asarray(self.history))
        return path

    @staticmethod
    def load_checkpoint(path: str) -> Tuple[HmmParams, int, List[float]]:
        z = np.load(path)
        params = HmmParams(means=z["means"], var=z["var"], lnw=z["lnw"],
                           tp=z["tp"])
        return params, int(z["iteration"]), list(z["history"])

    # ------------------------------------------------------------------
    def em_step_sharded(self, group=None) -> float:
        """Data-parallel EM step over the ranks of a `torch.distributed`
        process group (NCCL between cards, gloo on the CPU; None: the
        default group): utterances split into one contiguous block a rank,
        the batch padded with T=0 rows to a multiple of the world size,
        accumulators and the total log-likelihood summed with `all_reduce`
        (the 'norm over accumulator dirs').  Every rank holds the same
        parameters before and after the step."""
        import torch.distributed as dist

        world = dist.get_world_size(group)
        rank = dist.get_rank(group)
        b = self.batch
        B = b.feats.shape[0]
        pad = (-B) % world
        per = (B + pad) // world
        lo, hi = rank * per, (rank + 1) * per

        def block(a):
            if pad:
                a = np.concatenate([a, np.zeros((pad,) + a.shape[1:],
                                                a.dtype)])
            return a[lo:hi]
        # Padded rows have T=0 -> no frames, no counts.
        part = UttBatch(**{k: block(getattr(b, k))
                           for k in b.__dataclass_fields__}).to(self.device)
        llh, acc = forward_backward(part, *device_params(self.params,
                                                         self.device),
                                    device=self.device)
        # A T=0 row's llh is the sentinel (~-1e30): it adds nothing.
        total = torch.where(part.T > 0, llh, 0.0).sum()
        acc["llh"] = total.to(torch.float64)
        for v in acc.values():
            dist.all_reduce(v, op=dist.ReduceOp.SUM, group=group)
        acc = host_acc(acc)
        return self._finish_step(float(acc.pop("llh")), acc)
