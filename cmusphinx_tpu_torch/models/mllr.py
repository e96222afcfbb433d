"""MLLR adaptation: transform loading, application, and estimation.

Capability parity with ps_mllr (reference:
pocketsphinx/src/libpocketsphinx/ps_mllr.c:169 ps_mllr_read — text format
`n_class n_feat {veclen {A rows} {b} {h}}`; applied to means in
s2_semi_mgau/ptm/ms mgau `transform()`), sphinx3 online adaptation
(libam/adaptor.c, mllr.c) and SphinxTrain's mllr_solve / mllr_transform
programs (libs/libmllr).

`solve_mllr` estimates a single-class transform from Baum-Welch style
statistics (occupancies and weighted observation sums) by the standard
row-wise closed form: for output dim i,
    w_i = G_i^{-1} k_i,
    G_i = sum_g occ_g / var_gi * xi_g xi_g^T,
    k_i = sum_g (1 / var_gi) * xsum_gi * xi_g^T,
with xi_g = [mu_g ; 1] the extended mean.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class MllrTransform:
    """Per-stream, per-class affine transforms of Gaussian means."""
    A: List[np.ndarray]   # per stream: [n_class, d, d]
    b: List[np.ndarray]   # per stream: [n_class, d]
    h: List[np.ndarray]   # per stream: [n_class, d] (variance scale; 1.0)

    @property
    def n_class(self) -> int:
        return self.A[0].shape[0]

    @property
    def n_feat(self) -> int:
        return len(self.A)

    # ------------------------------------------------------------------
    @classmethod
    def read(cls, path: str) -> "MllrTransform":
        toks = open(path).read().split()
        pos = 0

        def rd():
            nonlocal pos
            v = toks[pos]
            pos += 1
            return v

        n_class = int(rd())
        n_feat = int(rd())
        A, b, h = [], [], []
        for f in range(n_feat):
            d = int(rd())
            Af = np.empty((n_class, d, d), np.float32)
            bf = np.empty((n_class, d), np.float32)
            hf = np.ones((n_class, d), np.float32)
            for m in range(n_class):
                for j in range(d):
                    for k in range(d):
                        Af[m, j, k] = float(rd())
                for j in range(d):
                    bf[m, j] = float(rd())
                # h row is optional in older files
                if pos + d <= len(toks):
                    save = pos
                    try:
                        row = [float(toks[pos + i]) for i in range(d)]
                        hf[m] = row
                        pos += d
                    except ValueError:
                        pos = save
            A.append(Af)
            b.append(bf)
            h.append(hf)
        return cls(A=A, b=b, h=h)

    def write(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(f"{self.n_class}\n{self.n_feat}\n")
            for f in range(self.n_feat):
                d = self.A[f].shape[1]
                fh.write(f"{d}\n")
                for m in range(self.n_class):
                    for j in range(d):
                        fh.write(" ".join(f"{v:f}" for v in self.A[f][m, j])
                                 + " \n")
                    fh.write(" ".join(f"{v:f}" for v in self.b[f][m]) + " \n")
                    fh.write(" ".join(f"{v:f}" for v in self.h[f][m]) + " \n")

    # ------------------------------------------------------------------
    def apply(self, gauden, cb2mllr: Optional[np.ndarray] = None):
        """Transform gauden means in place: mu' = A mu + b
        (ps_mgau transform / mllr_transform capability).  cb2mllr maps
        codebook -> regression class (default: all class 0)."""
        for f in range(min(self.n_feat, gauden.n_feat)):
            d = self.A[f].shape[1]
            cls_of = (cb2mllr if cb2mllr is not None
                      else np.zeros(gauden.n_mgau, np.int32))
            for m in range(gauden.n_mgau):
                c = int(cls_of[m])
                mu = gauden.means[m, f, :, :d]
                gauden.means[m, f, :, :d] = (
                    mu @ self.A[f][c].T + self.b[f][c][None, :])
        return gauden


def solve_mllr(means: np.ndarray, var: np.ndarray, occ: np.ndarray,
               xsum: np.ndarray) -> MllrTransform:
    """Estimate a single-class MLLR transform (mllr_solve capability).

    means/var: [G, D] Gaussian params (flattened over senones/components);
    occ: [G] state-component occupancies; xsum: [G, D] posterior-weighted
    observation sums (the Baum-Welch `mean` accumulator).
    """
    G, D = means.shape
    xi = np.concatenate([means, np.ones((G, 1))], axis=1)     # [G, D+1]
    A = np.zeros((D, D + 1), np.float64)
    for i in range(D):
        iv = occ / np.maximum(var[:, i], 1e-8)                # [G]
        Gi = (iv[:, None, None] * xi[:, :, None] * xi[:, None, :]).sum(0)
        ki = ((xsum[:, i] / np.maximum(var[:, i], 1e-8))[:, None]
              * xi).sum(0)
        A[i] = np.linalg.solve(Gi + 1e-6 * np.eye(D + 1), ki)
    W = A[:, :D].astype(np.float32)
    b = A[:, D].astype(np.float32)
    return MllrTransform(A=[W[None, :, :]], b=[b[None, :]],
                         h=[np.ones((1, D), np.float32)])
