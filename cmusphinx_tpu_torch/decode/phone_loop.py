"""Phone-loop search: every CI phone's HMM in one loop, as a lookahead
heuristic and as a light phoneme recognizer.

Port of `cmusphinx_tpu/decode/phone_loop.py` (`PhoneLoopSearch`; the
reference: pocketsphinx phone_loop_search.c).  All CI-phone HMMs run as
one `[n_ci, S]` `hmm_step` a frame; the loop re-entry (every phone may
follow every phone, with penalty pip) is the frame's best exit entering
every phone.

- `phone_scores(feats)` -> [T, n_ci] best in-phone state score a frame,
  relative to the frame's best;
- `heuristic(feats, window)` -> [T] the windowed sum of the per-frame
  bests, scaled by pl_weight;
- `lookahead_mask(feats, window, pl_beam)` -> [T, n_ci] bool: phones whose
  windowed score is within pl_beam of the frame best.

The frame loop runs in blocks of `BLOCK` frames through the shared block
runner (`graphs.BlockRunner`): on the card each block is a replay of a
captured CUDA graph, the counterpart of the reference's compiled
`lax.scan`.  The scores are padded to whole blocks; a padded frame keeps
the loop's state, and its rows are cut from the outputs, so the first T
rows are the reference's T-frame scan.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.mdef import Mdef
from ..models.tmat import TransitionMatrices
from ..ops.hmm import NEG_INF, hmm_bands, hmm_enter, hmm_step
from .graphs import BlockRunner, pad_frames


class PhoneLoopSearch:
    """Batched CI-phone loop over a senone scorer; its tables live on
    `device`.  `_runner.graphs = False` runs the blocks eagerly on the
    card."""

    # Frames a block (one graph whatever the utterance's length).
    BLOCK = 50

    def __init__(self, mdef: Mdef, tmat: TransitionMatrices, scorer,
                 pip: float = 1.0, pl_weight: float = 3.0, *,
                 device: torch.device | str = "cuda"):
        self.mdef = mdef
        self.scorer = scorer
        self.device = torch.device(device)
        self.n_ci = mdef.n_ciphone
        self.log_pip = math.log(pip) if pip > 0 else 0.0
        self.pl_weight = pl_weight
        ssid = mdef.phone_ssid[: self.n_ci]
        sen = mdef.sseq[ssid].astype(np.int64)                  # [n_ci, S]
        sen = np.where(sen == np.iinfo(np.uint16).max, 0, sen)
        self._sen_idx = torch.as_tensor(sen, device=self.device)
        tm = mdef.phone_tmat[: self.n_ci]
        self._bands = tuple(torch.as_tensor(b, dtype=torch.float32,
                                            device=self.device)
                            for b in hmm_bands(tmat.log_tp[tm]))
        self._n_state = sen.shape[1]
        self._lp = float(np.float32(self.log_pip))
        self._runner = BlockRunner()

    # The runner's counters (captures, capture_s, replays).
    graph_stats = property(lambda self: self._runner.stats)

    def _block(self, carry, inputs, t, rows) -> tuple:
        """Frames of the senone scores [K, n_sen] (valid [K]) through the
        loop, writing rows k of best [K] and phones [K, n_ci]; no host
        read, so the block can be captured."""
        alpha, = carry
        scores, valid = inputs
        best, phones = rows
        n = self.n_ci
        for k in range(scores.shape[0]):
            sen_c = scores[k][self._sen_idx]                     # [n_ci, S]
            a, _, ex, _ = hmm_step(alpha, (), sen_c, self._bands)
            # The loop: the best exit re-enters every phone.
            best_exit = ex.amax() + self._lp
            a, _ = hmm_enter(a, (), best_exit.expand(n), ())
            phone_best = a.amax(1)
            # Renormalize against drift on long utterances.
            m = phone_best.amax()
            best[k].copy_(m)
            phones[k].copy_(phone_best - m)
            alpha = torch.where(valid[k], a - m, alpha)
        return (alpha,)

    def _scan(self, scores: torch.Tensor):
        """The loop over the senone scores [T, n_sen], padded to whole
        blocks: (best [F], phones [F, n_ci]) on the device, rows past T
        padding.  No host read: on the card each block is a graph's
        replay."""
        n, S, T = self.n_ci, self._n_state, scores.shape[0]
        dev = scores.device
        F = -(-T // self.BLOCK) * self.BLOCK
        scores = pad_frames(scores, F)
        alpha = torch.full((n, S), NEG_INF, dtype=torch.float32, device=dev)
        alpha[:, 0] = 0.0                  # every phone enterable at t = 0
        valid = torch.arange(F, device=dev) < T
        best = torch.empty(F, dtype=torch.float32, device=dev)
        phones = torch.empty((F, n), dtype=torch.float32, device=dev)
        self._runner.scan(self._block, (alpha,), (scores, valid),
                          (best, phones), 0, self.BLOCK)
        return best, phones

    @torch.inference_mode()
    def _run(self, feats):
        """feats [T, D] -> (best [T], phone [T, n_ci]) on the host."""
        x = torch.as_tensor(np.asarray(feats, np.float32)).to(self.device)
        T = x.shape[0]
        best, phones = self._scan(self.scorer.score(x))
        return best[:T].cpu().numpy(), phones[:T].cpu().numpy()

    def phone_scores(self, feats) -> np.ndarray:
        """[T, D] feats -> frame-relative per-phone scores [T, n_ci]."""
        return self._run(feats)[1]

    def heuristic(self, feats, window: int = 5) -> np.ndarray:
        """Per-frame lookahead score: the sum of the per-frame bests over
        the next `window` frames, scaled by pl_weight."""
        b = self._run(feats)[0]
        T = b.shape[0]
        out = np.empty(T, np.float32)
        csum = np.concatenate([[0.0], np.cumsum(b)])
        for t in range(T):
            e = min(T, t + window)
            out[t] = csum[e] - csum[t]
        return self.pl_weight * out

    def lookahead_mask(self, feats, window: int = 5,
                       pl_beam: float = 1e-10) -> np.ndarray:
        """[T, n_ci] bool: phone ci is plausible around frame t (its
        windowed-max score within pl_beam of the frame best)."""
        ph = self.phone_scores(feats)
        T = ph.shape[0]
        wmax = np.copy(ph)
        for dt in range(1, window):
            wmax[: T - dt] = np.maximum(wmax[: T - dt], ph[dt:])
        thresh = wmax.max(axis=1, keepdims=True) + math.log(pl_beam)
        return wmax >= thresh
