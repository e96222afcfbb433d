"""GMM frame classifier + state-machine endpointer.

Port of `cmusphinx_tpu/frontend/ep.py` (`FrameClassifier`, `Utterance`,
`Endpointer`; the reference: sphinx3 libep classify.c and
s3_endpointer.c:51-80 — a GMM frame classifier into silence / speech /
noise feeding a begin/end state machine, the `main_ep` tool).

Classifying every frame is one Gaussian-mixture log-likelihood on the
device: `[T, D] @ [D, C*K]` products in IEEE f32 (the reference asks for
`Precision.HIGHEST`; the package switches TF32 off) and a log-sum-exp over
each class's K components.  `fit` seeds on the host exactly as the
reference does (`np.random.default_rng(seed)`) and runs its EM steps as
torch ops on the device.  The voting in `classify` and the `Endpointer`
state machine are host code, copied.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
from torch import nn

CLASS_SIL, CLASS_SPEECH, CLASS_NOISE = 0, 1, 2


class FrameClassifier(nn.Module):
    """Diagonal-GMM per-class frame classifier (classify.c capability).

    Buffers on `device`: `lin`, `quad` [D, C*K], `const` [C*K] and
    `logprior` [C], made on the host from means, variances and weights in
    the reference's float32 arithmetic."""

    def __init__(self, means: np.ndarray, var: np.ndarray, lnw: np.ndarray,
                 priors: Optional[np.ndarray] = None, *,
                 device: torch.device | str = "cuda"):
        """means/var [C, K, D]; lnw [C, K]; priors [C]."""
        super().__init__()
        C, K, D = means.shape
        self.n_class, self.n_comp, self.dim = C, K, D
        prec = 0.5 / np.maximum(var, 1e-6)
        lrd = (-0.5 * np.log(2.0 * np.pi * np.maximum(var, 1e-6))).sum(-1)
        const = lrd + lnw - (prec * means * means).sum(-1)       # [C, K]

        def buf(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32)
                                   ).to(device)

        self.register_buffer("lin", buf((2.0 * prec * means)
                                        .reshape(C * K, D).T))
        self.register_buffer("quad", buf(prec.reshape(C * K, D).T))
        self.register_buffer("const", buf(const.reshape(C * K)))
        self.register_buffer("logprior", buf(np.log(
            priors if priors is not None else np.full(C, 1.0 / C))))
        self.means, self.var, self.lnw = means, var, lnw

    def score(self, x: torch.Tensor) -> torch.Tensor:
        """x [T, D] on the module's device -> [T, C] class log posteriors
        (unnormalized)."""
        ll = self.const[None] + x @ self.lin - (x * x) @ self.quad
        ll = ll.reshape(x.shape[0], self.n_class, self.n_comp)
        return torch.logsumexp(ll, -1) + self.logprior[None]

    forward = score

    @torch.inference_mode()
    def log_likelihoods(self, feats) -> np.ndarray:
        """[T, D] -> [T, C] class log posteriors (unnormalized), on the
        host."""
        x = torch.as_tensor(np.asarray(feats, np.float32)).to(
            self.lin.device)
        return self.score(x).cpu().numpy()

    def classify(self, feats, voting_window: int = 5) -> np.ndarray:
        """[T, D] -> [T] class ids, with majority smoothing over a window
        (classify.c's voting capability)."""
        ll = self.log_likelihoods(feats)
        raw = np.argmax(ll, axis=1)
        if voting_window <= 1:
            return raw
        T = raw.shape[0]
        out = np.empty_like(raw)
        h = voting_window // 2
        for t in range(T):
            seg = raw[max(0, t - h) : min(T, t + h + 1)]
            out[t] = np.bincount(seg, minlength=self.n_class).argmax()
        return out

    # ------------------------------------------------------------------
    @classmethod
    def fit(cls, feats: np.ndarray, labels: np.ndarray, n_class: int,
            n_comp: int = 4, n_iter: int = 10, seed: int = 0, *,
            device: torch.device | str = "cuda") -> "FrameClassifier":
        """Per-class GMM fit with EM: the host seeding of the reference,
        then every class's EM step at once on the device."""
        rng = np.random.default_rng(seed)
        feats = np.asarray(feats, np.float32)
        D = feats.shape[1]
        means = np.zeros((n_class, n_comp, D), np.float32)
        var = np.ones((n_class, n_comp, D), np.float32)
        lnw = np.full((n_class, n_comp), -np.log(n_comp), np.float32)
        priors = np.zeros(n_class)
        for c in range(n_class):
            xc = feats[labels == c]
            priors[c] = max(len(xc), 1)
            if len(xc) == 0:
                continue
            sel = rng.choice(len(xc), size=n_comp, replace=len(xc) < n_comp)
            means[c] = xc[sel]
            var[c] = xc.var(0, keepdims=True) + 1e-3
        priors /= priors.sum()

        def dev(a):
            return torch.as_tensor(a).to(device)

        mask = np.zeros((len(feats), n_class), np.float32)
        mask[np.arange(len(feats)), labels] = 1.0
        m, v, w = dev(means), dev(var), dev(lnw)
        x, km = dev(feats), dev(mask)
        with torch.no_grad():
            for _ in range(n_iter):
                m, v, w = _em_step(m, v, w, x, km)
        return cls(m.cpu().numpy(), v.cpu().numpy(), w.cpu().numpy(), priors,
                   device=device)


def _em_step(m, v, w, x, mask):
    """One EM step of every class's GMM: x [N, D], mask [N, C] membership;
    means m, variances v [C, K, D], log weights w [C, K]."""
    prec = 0.5 / v.clamp_min(1e-6)
    lrd = (-0.5 * torch.log(2 * np.pi * v.clamp_min(1e-6))).sum(-1)
    diff = x[:, None, None, :] - m[None]                      # [N, C, K, D]
    ll = lrd[None] + w[None] - (prec[None] * diff * diff).sum(-1)
    r = torch.softmax(ll, -1) * mask[:, :, None]              # [N, C, K]
    n = r.sum(0) + 1e-6                                       # [C, K]
    mu = torch.einsum("nck,nd->ckd", r, x) / n[..., None]
    x2 = torch.einsum("nck,nd->ckd", r, x * x) / n[..., None]
    vv = (x2 - mu * mu).clamp_min(1e-4)
    ww = torch.log(n / n.sum(-1, keepdim=True))
    return mu, vv, ww


@dataclass
class Utterance:
    start_frame: int
    end_frame: int  # inclusive


class Endpointer:
    """Begin/end state machine over frame classes (s3_endpointer.c
    capability): an utterance begins after `begin_window` of mostly-speech
    frames and ends after `end_window` of non-speech, padded by
    `pad_before`/`pad_after` frames.  A copy of the reference's (host)."""

    def __init__(self, begin_window: int = 8, begin_threshold: int = 5,
                 end_window: int = 40, pad_before: int = 15,
                 pad_after: int = 10):
        self.begin_window = begin_window
        self.begin_threshold = begin_threshold
        self.end_window = end_window
        self.pad_before = pad_before
        self.pad_after = pad_after

    def segment(self, classes: np.ndarray) -> List[Utterance]:
        """[T] frame class ids -> utterance spans."""
        speech = (np.asarray(classes) == CLASS_SPEECH).astype(np.int32)
        T = speech.shape[0]
        utts: List[Utterance] = []
        in_speech = False
        start = 0
        sil_run = 0
        # rolling count of speech frames in the begin window
        csum = np.concatenate([[0], np.cumsum(speech)])
        t = 0
        while t < T:
            if not in_speech:
                e = min(T, t + self.begin_window)
                if csum[e] - csum[t] >= self.begin_threshold and speech[t]:
                    in_speech = True
                    start = max(0, t - self.pad_before)
                    sil_run = 0
                t += 1
            else:
                if speech[t]:
                    sil_run = 0
                else:
                    sil_run += 1
                    if sil_run >= self.end_window:
                        end = min(T - 1, t - sil_run + self.pad_after)
                        utts.append(Utterance(start, end))
                        in_speech = False
                t += 1
        if in_speech:
            utts.append(Utterance(start, T - 1))
        return utts
