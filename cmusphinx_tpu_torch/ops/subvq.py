"""Sub-vector-quantized Gaussian selection (fast-GMM layer).

Port of `cmusphinx_tpu/ops/subvq.py` (the reference: sphinx3
libs3decoder/libam/subvq.c:208-350 subvq_read / format,
subvq_mgau_shortlist; builder tool sphinx3/src/programs/main_gausubvq.c):
the feature space is split into sub-vectors, each sub-space VQ-quantized,
and every Gaussian of the acoustic model is mapped to its nearest codeword
per sub-vector.  The approximate log density of a Gaussian is the sum of
its codewords' densities, cheap to evaluate for all Gaussians; a
shortlist within `beam` of the best is what the reference evaluates
exactly.

The text format (`read_subvq`, `write_subvq`) and the builder
(`build_subvq`, `_kmeans_gauss`: KL-divergence k-means on the host,
seeded by `np.random.RandomState`) are copies of the reference's.
`SubVQScorer` runs on the device: the codeword densities (IEEE f32
products), the per-Gaussian sum of its codewords' densities, the
log-sum-exp over K and `shortlist`, in blocks of frames that bound the
`[frames, S*K]` intermediates.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..models.gauden import GaussianParams
from .fused_gmm import _REF_CHUNK_BYTES


@dataclass
class SubVQ:
    dims: List[np.ndarray]     # per subvector: feature dims (int32)
    means: List[np.ndarray]    # per subvector: [vqsize, len] float32
    var: List[np.ndarray]      # per subvector: [vqsize, len] float32
    map: np.ndarray            # [n_mgau, n_density, n_sv] int32 codeword ids
    sqerr: Optional[List[float]] = None

    @property
    def n_sv(self) -> int:
        return len(self.dims)

    @property
    def vqsize(self) -> int:
        return self.means[0].shape[0]


def read_subvq(path: str) -> SubVQ:
    """Parse the sphinx3 text subvq format (subvq.c:208-350)."""
    with open(path) as fh:
        toks = fh.readline().split()
        if toks[0] != "VQParam" or toks[3] != "->":
            raise ValueError(f"{path}: bad VQParam header")
        n_mgau, n_density = int(toks[1]), int(toks[2])
        n_sv, vqsize = int(toks[4]), int(toks[5])
        dims, means, var, sqerr = [], [], [], []
        for s in range(n_sv):
            toks = fh.readline().split()
            if toks[0] != "Subvector" or int(toks[1]) != s:
                raise ValueError(f"{path}: bad Subvector {s} header")
            l = int(toks[3])
            dims.append(np.asarray([int(t) for t in toks[4 : 4 + l]], np.int32))
            means.append(np.zeros((vqsize, l), np.float32))
            var.append(np.zeros((vqsize, l), np.float32))
        mp = np.zeros((n_mgau, n_density, n_sv), np.int32)
        for s in range(n_sv):
            toks = fh.readline().split()
            if toks[0] != "Codebook" or int(toks[1]) != s:
                raise ValueError(f"{path}: bad Codebook {s} header")
            sqerr.append(float(toks[3]) if len(toks) > 3 else 0.0)
            l = len(dims[s])
            for r in range(vqsize):
                vals = np.asarray(fh.readline().split(), np.float64)
                means[s][r] = vals[0::2][:l]
                var[s][r] = vals[1::2][:l]
            toks = fh.readline().split()
            if toks[0] != "Map" or int(toks[1]) != s:
                raise ValueError(f"{path}: bad Map {s} header")
            for r in range(n_mgau):
                mp[r, :, s] = np.asarray(fh.readline().split(), np.int32)
        if fh.readline().split()[:1] != ["End"]:
            raise ValueError(f"{path}: missing End token")
    return SubVQ(dims=dims, means=means, var=var, map=mp, sqerr=sqerr)


def write_subvq(path: str, svq: SubVQ) -> None:
    n_mgau, n_density, _ = svq.map.shape
    with open(path, "w") as fh:
        fh.write(f"VQParam {n_mgau} {n_density} -> {svq.n_sv} {svq.vqsize}\n")
        for s, d in enumerate(svq.dims):
            fh.write(f"Subvector {s} length {len(d)} "
                     + " ".join(str(int(x)) for x in d) + "\n")
        for s in range(svq.n_sv):
            e = svq.sqerr[s] if svq.sqerr else 0.0
            fh.write(f"Codebook {s} Sqerr {e:e}\n")
            for r in range(svq.vqsize):
                row = []
                for c in range(len(svq.dims[s])):
                    row.append(f"{svq.means[s][r, c]:.4e} {svq.var[s][r, c]:.4e}")
                fh.write("  " + "  ".join(row) + "\n")
            fh.write(f"Map {s}\n")
            for r in range(n_mgau):
                fh.write(" ".join(str(int(x)) for x in svq.map[r, :, s]) + "\n")
        fh.write("End\n")


def _kl_dists(M, V, LVsum, cm, cv) -> np.ndarray:
    """[G, k] KL(g || c) between diagonal Gaussians, via GEMMs only — never
    materializes a [G, k, d] intermediate (the naive broadcast would be
    several GB for production models, e.g. 8k senones x 32 gau x vq 256).

    KL = 0.5 * sum_d [ log vc - log vg + (vg + (mg - mc)^2) / vc - 1 ]
    """
    inv = 1.0 / cv                                       # [k, d]
    a = np.log(cv).sum(1)[None, :] - LVsum[:, None]      # log-det terms
    b = V @ inv.T                                        # sum vg/vc
    c = ((M * M) @ inv.T - 2.0 * (M @ (cm * inv).T)
         + (cm * cm * inv).sum(1)[None, :])              # sum (mg-mc)^2/vc
    return 0.5 * np.maximum(a + b + c - M.shape[1], 0.0)


def _kmeans_gauss(M, V, k: int, n_iter: int, rng: np.random.RandomState,
                  n_restarts: int = 3):
    """Bregman k-means over diagonal Gaussians under KL(g||c): assignment
    minimizes KL to the codeword; the centroid update is exact moment
    matching (mc = mean of member means, vc = mean of vg + (mg-mc)^2).
    This directly minimizes the density-approximation error the shortlist
    depends on — the modern counterpart of the reference's Euclidean VQ over
    interleaved mean/var vectors (sphinx3 main_gausubvq.c, vector_vqgen)."""
    G, d = M.shape
    LVsum = np.log(V).sum(1)
    best = None
    for _ in range(n_restarts):
        # k-means++-style seeding in KL distance.
        idx = [rng.randint(G)]
        dmin = _kl_dists(M, V, LVsum, M[idx[-1:]], V[idx[-1:]])[:, 0]
        for _ in range(1, k):
            tot = dmin.sum()
            i = rng.choice(G, p=dmin / tot) if tot > 0 else rng.randint(G)
            idx.append(int(i))
            dmin = np.minimum(
                dmin, _kl_dists(M, V, LVsum, M[i:i + 1], V[i:i + 1])[:, 0])
        cm, cv = M[idx].copy(), V[idx].copy()
        for _ in range(n_iter):
            dk = _kl_dists(M, V, LVsum, cm, cv)
            assign = dk.argmin(1)
            mind = dk[np.arange(G), assign]
            for c in range(k):
                m = assign == c
                if m.any():
                    cm[c] = M[m].mean(0)
                    cv[c] = (V[m] + (M[m] - cm[c]) ** 2).mean(0)
                else:  # reseed empties to the worst-represented Gaussian
                    far = int(mind.argmax())
                    cm[c], cv[c] = M[far], V[far]
                    mind[far] = 0.0
        dk = _kl_dists(M, V, LVsum, cm, cv)
        assign = dk.argmin(1)
        err = float(dk[np.arange(G), assign].sum())
        if best is None or err < best[3]:
            best = (assign.copy(), cm.copy(), cv.copy(), err)
    return best


def build_subvq(gauden: GaussianParams, n_sv: int = 3, vqsize: int = 256,
                n_iter: int = 20, seed: int = 0, n_restarts: int = 3) -> SubVQ:
    """gausubvq capability: VQ the model's Gaussians per sub-vector.

    Dims are split contiguously into n_sv groups (the tool's default
    auto-partition); each sub-space codebook is trained with KL-divergence
    Bregman k-means over the Gaussians' (mean, var) pairs (see
    _kmeans_gauss), with k-means++ seeding and best-of-n restarts.
    """
    if gauden.n_feat != 1:
        raise ValueError("subvq expects single-stream models")
    D = gauden.veclen[0]
    S, K = gauden.n_mgau, gauden.n_density
    G = S * K
    vqsize = min(vqsize, G)
    all_means = gauden.means[:, 0, :, :D].reshape(G, D).astype(np.float64)
    all_var = np.maximum(
        gauden.var[:, 0, :, :D].reshape(G, D).astype(np.float64), 1e-6)
    rng = np.random.RandomState(seed)
    bounds = np.linspace(0, D, n_sv + 1).astype(int)
    dims, cms, cvs, sqerr = [], [], [], []
    mp = np.zeros((S, K, n_sv), np.int32)
    for s in range(n_sv):
        d = np.arange(bounds[s], bounds[s + 1], dtype=np.int32)
        assign, cm, cv, err = _kmeans_gauss(
            all_means[:, d], all_var[:, d], vqsize, n_iter, rng,
            n_restarts=n_restarts)
        dims.append(d)
        cms.append(cm.astype(np.float32))
        cvs.append(np.maximum(cv, 1e-4).astype(np.float32))
        sqerr.append(err)
        mp[:, :, s] = assign.reshape(S, K)
    return SubVQ(dims=dims, means=cms, var=cvs, map=mp, sqerr=sqerr)


class SubVQScorer(nn.Module):
    """Approximate continuous scorer via sub-vector codeword densities
    (subvq_mgau_shortlist capability, dense formulation).

    Per frame: codeword log densities per subvector ([N, n_sv*vqsize] by
    the two-product trick), per-Gaussian approx = the sum over subvectors
    of its codeword's density (a gather a subvector), senone score =
    logsumexp_k(approx + ln w).  `shortlist(x, beam)` returns the
    per-frame Gaussian keep-mask the reference would evaluate exactly.
    Buffers on `device`; features `[..., T, D]`."""

    def __init__(self, svq: SubVQ, ln_mixw: np.ndarray, *,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.svq = svq
        S, K, n_sv = svq.map.shape
        self.n_sen, self.n_density, self.n_sv = S, K, n_sv

        def buf(a, dtype=np.float32):
            return torch.as_tensor(np.ascontiguousarray(a, dtype)).to(device)

        for s in range(n_sv):
            m, v = svq.means[s].astype(np.float64), svq.var[s].astype(np.float64)
            prec = 1.0 / (2.0 * np.maximum(v, 1e-4))
            lrd = -0.5 * (np.log(np.maximum(v, 1e-4)).sum(-1)
                          + v.shape[1] * math.log(2 * math.pi))
            # lin/quad [l, vq], const [vq], dims [l], as the reference.
            self.register_buffer(f"lin{s}", buf(
                (2.0 * prec * m).astype(np.float32).T))
            self.register_buffer(f"quad{s}", buf(prec.astype(np.float32).T))
            self.register_buffer(f"const{s}", buf(
                (lrd - (prec * m * m).sum(-1)).astype(np.float32)))
            self.register_buffer(f"dims{s}", buf(svq.dims[s], np.int64))
        # Gather index: gaussian g, subvector s -> column s*vq + map[g,s].
        # map entries of -1 mark absent Gaussians (codebooks with fewer than
        # n_density components, which the reference compacts away in
        # subvq_map_compact): clamp the index and force their approx log
        # density to -1e30 so they never win in logsumexp or shortlist().
        vq = svq.vqsize
        flat_map = svq.map.reshape(S * K, n_sv)
        valid = (flat_map >= 0).all(-1)                   # [S*K]
        self.register_buffer("gidx", buf(
            np.arange(n_sv)[None, :] * vq + np.maximum(flat_map, 0),
            np.int64).T.contiguous())                     # [n_sv, S*K]
        self.register_buffer("invalid_bias", buf(
            np.where(valid, 0.0, -1e30)))
        self.register_buffer("lnw", buf(ln_mixw.reshape(S, K)))

    def codeword_densities(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, D] -> [N, n_sv * vqsize] codeword log densities."""
        outs = []
        for s in range(self.n_sv):
            xs = x[:, getattr(self, f"dims{s}")]
            outs.append(getattr(self, f"const{s}")[None]
                        + xs @ getattr(self, f"lin{s}")
                        - (xs * xs) @ getattr(self, f"quad{s}"))
        return torch.cat(outs, 1)

    def _approx(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, D] -> [N, S*K]: each Gaussian's codeword densities summed
        over the subvectors in order."""
        dens = self.codeword_densities(x)
        g = dens[:, self.gidx[0]]
        for s in range(1, self.n_sv):
            g = g + dens[:, self.gidx[s]]
        return g + self.invalid_bias[None]

    def _rows(self) -> int:
        """Frames a block: one [rows, S*K] f32 block near the plain
        scorers' chunk budget (a few such blocks live at once)."""
        return max(1, _REF_CHUNK_BYTES // (self.n_sen * self.n_density * 4))

    def gaussian_approx(self, feats: torch.Tensor) -> torch.Tensor:
        """[..., T, D] -> [..., T, S, K] approximate per-Gaussian log
        densities."""
        x = feats.reshape(-1, feats.shape[-1])
        out = torch.cat([self._approx(x[lo: lo + self._rows()])
                         for lo in range(0, x.shape[0], self._rows())]
                        ) if x.shape[0] else x.new_zeros(
                            (0, self.n_sen * self.n_density))
        return out.reshape(*feats.shape[:-1], self.n_sen, self.n_density)

    def score(self, feats: torch.Tensor) -> torch.Tensor:
        """[..., T, D] -> [..., T, S] approximate senone scores."""
        x = feats.reshape(-1, feats.shape[-1])
        S, K = self.n_sen, self.n_density
        out = torch.empty((x.shape[0], S), dtype=torch.float32,
                          device=x.device)
        rows = self._rows()
        for lo in range(0, x.shape[0], rows):
            ga = self._approx(x[lo: lo + rows]).view(-1, S, K)
            out[lo: lo + rows] = torch.logsumexp(ga + self.lnw[None], -1)
        return out.reshape(*feats.shape[:-1], S)

    forward = score

    def shortlist(self, feats: torch.Tensor, beam: float = 10.0
                  ) -> torch.Tensor:
        """[..., T, D] -> [..., T, S, K] bool: Gaussians within `beam` nats
        of the frame's best (the set subvq_mgau_shortlist would evaluate
        exactly)."""
        x = feats.reshape(-1, feats.shape[-1])
        S, K = self.n_sen, self.n_density
        out = torch.empty((x.shape[0], S, K), dtype=torch.bool,
                          device=x.device)
        rows = self._rows()
        for lo in range(0, x.shape[0], rows):
            ga = self._approx(x[lo: lo + rows])
            best = ga.amax(-1, keepdim=True)
            out[lo: lo + rows] = (ga > best - beam).view(-1, S, K)
        return out.reshape(*feats.shape[:-1], S, K)
