"""A plain reference of pocketsphinx's phonetically-tied-mixture scorer
(ptm_mgau.c), written from its equations in plain PyTorch, float64, one
frame at a time, with no batching and no kernel.  It imports neither
package of this repository.

With logbase b = 1.0001, SHIFT = 10, MAX_NEG_ASCR = 96, codebooks c (one a
CI phone), streams f and codewords k:

- prec'[c,f,k,j] = trunc(1 / (2 var) / ln b);
  lrd'[c,f,k] = sum_j trunc(ln(1 / sqrt(2 pi var)) / ln b);
- d[c,f,k] = trunc(clamp(lrd' - sum_j prec' (x_j - mu_j)^2, -2e9, 0));
- the top N of each (c, f) by a stable sort (ties to the lower index);
- norm[f] = max over c of top_0 >> SHIFT;
  fsc[c,f,r] = min(norm[f] - (top_r >> SHIFT), MAX_NEG_ASCR);
- senone s, cb = sen2cb[s], per stream y_r = mixw[f, idx[cb,f,r], s] +
  fsc[cb,f,r]; fden = y_0; fden = min(fden, y_r) -
  table8[min(|fden - y_r|, 255)] for r = 1..N-1;
- score = -(sum over f of fden) * 2^SHIFT ln b.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

LOGBASE = 1.0001
SHIFT = 10
MAX_NEG_ASCR = 96


def logadd8_table(base: float = LOGBASE, shift: int = SHIFT) -> np.ndarray:
    """logmath's 8-bit add table: entry d is the rounded
    log_base(1 + base^-(d << shift)), shifted right by `shift`."""
    ln_b = math.log(base)
    i = (np.arange(256, dtype=np.int64) << shift).astype(np.float64)
    k = np.floor(np.log1p(np.power(base, -i)) / ln_b + 0.5 * (1 << shift))
    return k.astype(np.int64) >> shift


class PtmReference:
    """means, var: per stream [C, K, L_f]; mixw: raw 8-bit weights
    [F, K, S]; sen2cb [S]; streams: the feature columns of each stream."""

    def __init__(self, means: Sequence[np.ndarray], var: Sequence[np.ndarray],
                 mixw: np.ndarray, sen2cb: np.ndarray,
                 streams: Sequence[Sequence[int]], topn: int = 4):
        inv = 1.0 / math.log(LOGBASE)
        self.mu, self.prec, self.lrd = [], [], []
        for m, v in zip(means, var):
            v = np.asarray(v, np.float64)
            self.mu.append(torch.as_tensor(np.asarray(m, np.float64)))
            self.prec.append(torch.as_tensor(np.trunc(1.0 / (2.0 * v) * inv)))
            self.lrd.append(torch.as_tensor(np.trunc(
                np.log(1.0 / np.sqrt(2.0 * np.pi * v)) * inv).sum(-1)))
        self.w = torch.as_tensor(np.asarray(mixw, np.int64))
        self.cb = torch.as_tensor(np.asarray(sen2cb, np.int64))
        self.streams = [torch.as_tensor(list(s)) for s in streams]
        self.table = torch.as_tensor(logadd8_table())
        self.topn = int(topn)
        self.scale = (1 << SHIFT) * math.log(LOGBASE)

    def densities(self, x: torch.Tensor, f: int) -> torch.Tensor:
        """Integer densities [C, K] of one frame's stream f."""
        diff = x[self.streams[f]] - self.mu[f]                # [C, K, L]
        d = self.lrd[f] - (self.prec[f] * diff * diff).sum(-1)
        return torch.trunc(d.clamp(-2.0e9, 0.0)).to(torch.int64)

    def frame(self, x: torch.Tensor) -> torch.Tensor:
        """One frame's features [D] -> senone scores [S]."""
        n = self.topn
        acc = torch.zeros(self.w.shape[2], dtype=torch.int64)
        for f in range(len(self.streams)):
            d = self.densities(x, f)
            order = torch.sort(-d, dim=1, stable=True).indices[:, :n]
            vals = torch.gather(d, 1, order)
            sh = torch.div(vals, 1 << SHIFT, rounding_mode="floor")
            norm = sh[:, 0].max()
            fsc = (norm - sh).clamp_max(MAX_NEG_ASCR)         # [C, n]
            idx, sc = order[self.cb], fsc[self.cb]            # [S, n]
            s = torch.arange(self.w.shape[2])
            fden = None
            for r in range(n):
                y = self.w[f][idx[:, r], s] + sc[:, r]
                if fden is None:
                    fden = y
                    continue
                dd = (fden - y).abs().clamp_max(255)
                fden = torch.minimum(fden, y) - self.table[dd]
            acc += fden
        return -acc.to(torch.float64) * self.scale

    def __call__(self, x) -> torch.Tensor:
        """Features [N, D] -> senone scores [N, S], float64."""
        x = torch.as_tensor(np.asarray(x, np.float64))
        return torch.stack([self.frame(row) for row in x])
