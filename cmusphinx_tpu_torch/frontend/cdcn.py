"""CDCN — Codeword-Dependent Cepstral Normalization (Acero 1990).

Capability parity with SphinxTrain cdcn_train/cdcn_norm and the sphinx2
runtime (reference: SphinxTrain/src/programs/cdcn_train/{vq,em_full_vars}.c
codebook training; cdcn_norm/{initialize,correction,max_q,mmse_x}.c the
per-utterance environment EM).  The model: an observed noisy-channel
cepstrum z relates to clean speech x through a spectral tilt q (linear
channel) and additive noise n,

    z = x + q + r(x, n, q),    r = IDFT[ log(1 + exp(DFT[n - q - x])) ]

where the DFT pair moves between cepstrum and log-spectrum (the
reference's resfft on an even sequence = an unnormalized symmetric cosine
transform, an involution up to 2N — reproduced here as an explicit
matrix).  Per utterance, EM alternates: correction vectors per codeword
(correction.c), posterior re-estimation of (n, q) (max_q.c), and finally
the MMSE clean-speech estimate under the codeword mixture (mmse_x.c).
Codeword 0 is the noise mode (y = n + s() expansion, correction.c:91).

Everything is dense numpy — the per-utterance EM is tiny (K x T x D) and
runs on host alongside the feature pipeline.

A copy of `cmusphinx_tpu/frontend/cdcn.py` (host numpy).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

_N = 32     # reference FFT length parameters (correction.c:55-57)
_N2 = 64


def _cosine_matrix(n: int = _N) -> np.ndarray:
    """The resfft even-sequence transform as a matrix F ([n+1, n+1]):
    F @ F == 2n * I (the reference applies the same routine forward and
    back, dividing by N2)."""
    j = np.arange(n + 1)
    w = np.where((j == 0) | (j == n), 1.0, 2.0)
    F = np.cos(np.pi * np.outer(j, j) / n) * w[None, :]
    return F


_F = _cosine_matrix()


def _softplus_spec(cep: np.ndarray) -> np.ndarray:
    """cep [.., D] -> IDFT[log(1 + exp(DFT[cep]))] [.., D]."""
    D = cep.shape[-1]
    aux = np.zeros(cep.shape[:-1] + (_N + 1,))
    aux[..., :D] = cep
    spec = aux @ _F.T
    spec = np.logaddexp(spec, 0.0)          # f1(x) = ln(exp(x) + 1)
    back = spec @ _F.T / _N2
    return back[..., :D]


@dataclass
class CdcnModel:
    means: np.ndarray    # [K, D] clean-cepstrum codebook (codeword 0 = noise)
    var: np.ndarray      # [K, D] diagonal variances
    prob: np.ndarray     # [K] mode priors

    @property
    def n_codes(self) -> int:
        return self.means.shape[0]

    # ------------------------------------------------------------------
    def _corrbook(self, tilt: np.ndarray, noise: np.ndarray) -> np.ndarray:
        """Per-codeword correction vectors (correction.c): codeword 0 uses
        the y = n + s() expansion, the rest r = f1(noise - tilt - mean)."""
        r = _softplus_spec(noise[None] - tilt[None] - self.means[1:])
        r0 = _softplus_spec((self.means[0] + tilt - noise)[None])
        return np.concatenate([r0, r], axis=0)

    def _denorm_prob(self) -> np.ndarray:
        """initialize.c: priors de-normalized by sqrt(det) — the Gaussian
        normalizers folded into the mixture weights."""
        return self.prob * np.sqrt(np.prod(self.var, axis=-1))

    def norm(self, z: np.ndarray, n_iter: int = 4):
        """Clean one utterance of cepstra z [T, D].  Returns
        (x_hat [T, D], tilt [D], noise [D], loglik history)."""
        z = np.asarray(z, np.float64)
        T, D = z.shape
        # --- initialize.c: tilt from the data mean, noise from the
        # low-energy frames (min + range/20 threshold on c0).
        lp = self._denorm_prob()
        codemean = (lp[:, None] * self.means).sum(0) / max(lp.sum(), 1e-30)
        tilt = z.mean(0) - codemean
        c0 = z[:, 0]
        ceiling = c0.min() + (c0.max() - c0.min()) / 20.0
        mask = c0 < ceiling
        noise = z[mask].mean(0) if mask.any() else z.mean(0)

        iprob = self.prob / np.maximum(
            np.sqrt(np.prod(self.var, axis=-1)), 1e-30)
        hist = []
        for _ in range(n_iter):
            corr = self._corrbook(tilt, noise)              # [K, D]
            # --- max_q.c: posteriors over codewords; codeword 0 measures
            # (z - corr0) against the NOISE estimate, others (z - mean -
            # corr) against the tilt.
            qk0 = z - corr[0][None]                          # [T, D]
            d0 = (((qk0 - noise[None]) ** 2) / self.var[0][None]).sum(-1)
            qk = z[:, None, :] - self.means[None, 1:] - corr[None, 1:]
            dk = (((qk - tilt[None, None]) ** 2)
                  / self.var[None, 1:]).sum(-1)              # [T, K-1]
            f = np.concatenate(
                [np.exp(-0.5 * d0)[:, None] * iprob[0],
                 np.exp(-0.5 * dk) * iprob[None, 1:]], axis=1)
            probz = f.sum(-1)
            ok = probz > 0
            hist.append(float(np.log(probz[ok]).mean()) if ok.any()
                        else -np.inf)
            post = np.where(ok[:, None], f / np.maximum(
                probz[:, None], 1e-300), 0.0)
            pnoise = post[:, 0]
            dennoise, dentilt = pnoise.sum(), (1.0 - pnoise)[ok].sum()
            if dennoise > 0:
                noise = (pnoise[:, None] * qk0).sum(0) / dennoise
            if dentilt > 0:
                tilt = (post[:, 1:, None] * qk).sum((0, 1)) / dentilt
        # --- mmse_x.c: posterior-weighted clean estimate.
        corr = self._corrbook(tilt, noise)
        xk = z[:, None, :] - tilt[None, None] - corr[None]   # [T, K, D]
        d = (((xk - self.means[None]) ** 2) / self.var[None]).sum(-1)
        f = np.exp(-0.5 * d) * iprob[None]
        den = f.sum(-1, keepdims=True)
        x = np.where(den > 0,
                     (f[..., None] * xk).sum(1) / np.maximum(den, 1e-300),
                     z)
        return x.astype(np.float32), tilt, noise, hist


def train_cdcn(ceps: Sequence[np.ndarray], n_codes: int = 32,
               n_iter: int = 20, seed: int = 0,
               var_floor: float = 0.25) -> CdcnModel:
    """cdcn_train capability: k-means VQ of CLEAN cepstra into a codebook
    with diagonal variances and priors; the lowest-energy (c0) cluster is
    moved to codeword 0 — the noise mode."""
    X = np.concatenate([np.asarray(c, np.float64) for c in ceps], axis=0)
    rng = np.random.RandomState(seed)
    K = min(n_codes, len(X))
    cent = X[rng.choice(len(X), K, replace=False)].copy()
    for _ in range(n_iter):
        d = ((X[:, None] - cent[None]) ** 2).sum(-1)
        a = d.argmin(1)
        for k in range(K):
            m = a == k
            if m.any():
                cent[k] = X[m].mean(0)
    d = ((X[:, None] - cent[None]) ** 2).sum(-1)
    a = d.argmin(1)
    var = np.full_like(cent, 1.0)
    prob = np.zeros(K)
    for k in range(K):
        m = a == k
        prob[k] = m.mean()
        if m.sum() > 1:
            var[k] = np.maximum(X[m].var(0), var_floor)
    order = np.argsort(cent[:, 0])
    order = np.concatenate([[order[0]], np.delete(np.arange(K), order[0])])
    return CdcnModel(means=cent[order], var=var[order], prob=prob[order])
