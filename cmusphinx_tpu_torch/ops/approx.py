"""Approximate-GMM evaluation family, dense/masked formulations.

Port of `cmusphinx_tpu/ops/approx.py` (`DownsampledScorer`,
`CigmmsScorer`, `GsSelectorScorer`, `KdTreeSelectorScorer`; the
reference: sphinx3 libs3decoder/libam/approx_cont_mgau.c:108-276, gs.c,
kdtree.c).  Each scorer wraps a base scorer (`inner`) and, like it, maps
features `[..., T, D]` to senone scores `[..., T, S]` on the device:

- `DownsampledScorer` (`-ds`) scores frames 0, ds, 2ds, ... of each
  utterance (dim -2, never the batch) and repeats each for the frames it
  skips; the inner scorer runs once a call (K1 on the card).
- `CigmmsScorer` (`-cipbeam`): a CD senone whose parent CI senone falls
  more than the beam below the frame's best CI senone takes its parent's
  score.  Both are computed (masking makes no product cheaper).
- `GsSelectorScorer` (VQ Gaussian selection) and `KdTreeSelectorScorer`
  (BBI kd-tree) build their shortlists on the host as the reference does,
  then score the full density matrix of a `ContinuousScorer`'s parameters
  and floor the Gaussians outside each frame's shortlist.  The density
  products are IEEE f32 `torch.matmul`s on the inner scorer's `[S, K, D]`
  parameters (bf16-rounded in its bf16 mode, computed in f32 as the
  reference's `jnp.dot(f32, bf16)` promotes), in blocks of frames.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .fused_gmm import _REF_CHUNK_BYTES


class DownsampledScorer(nn.Module):
    """Frame-downsampled senone scoring (reference -ds semantics): score
    frames [0, ds, 2ds, ...] and substitute the previous computed frame's
    scores for the skipped ones."""

    def __init__(self, scorer: nn.Module, ds_ratio: int = 2):
        super().__init__()
        if ds_ratio < 1:
            raise ValueError("ds_ratio must be >= 1")
        self.inner = scorer
        self.ds = int(ds_ratio)
        self.n_sen = scorer.n_sen

    def score(self, feats: torch.Tensor) -> torch.Tensor:
        T = feats.shape[-2]
        if self.ds == 1 or T == 0:
            return self.inner.score(feats)
        base = self.inner.score(feats[..., :: self.ds, :])
        return base.repeat_interleave(self.ds, dim=-2)[..., :T, :]

    forward = score


class CigmmsScorer(nn.Module):
    """CI-GMM selection (CIGMMS): CD senones whose parent CI senone falls
    below the frame-best CI score by more than `ci_pbeam` take the parent
    CI score instead of their own (approx_cont_mgau.c CIGMMS).

    cd2cisen: [n_sen] parent CI senone per senone (mdef.cd2cisen; CI
    senones map to themselves)."""

    def __init__(self, scorer: nn.Module, cd2cisen: np.ndarray,
                 n_ci_sen: int, ci_pbeam: float = 7.0, *,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.inner = scorer
        self.n_sen = scorer.n_sen
        self.register_buffer("cd2ci", torch.as_tensor(
            np.asarray(cd2cisen, np.int64)).to(device))
        self.n_ci_sen = int(n_ci_sen)
        self.beam = float(ci_pbeam)

    def score(self, feats: torch.Tensor) -> torch.Tensor:
        s = self.inner.score(feats)                        # [..., T, S]
        ci = s[..., : self.n_ci_sen]
        best = ci.amax(-1, keepdim=True)
        parent = s[..., self.cd2ci]
        out = torch.where(parent >= best - self.beam, s, parent)
        # CI senones always keep their own scores.
        return torch.cat([ci, out[..., self.n_ci_sen:]], -1)

    forward = score


def _gauss_means(gauden) -> tuple:
    S, K = gauden.n_mgau, gauden.n_density
    D = int(gauden.veclen[0])
    return S, K, D, gauden.means[:, 0, :, :D].reshape(S * K, D).astype(
        np.float64)


# Rows of the host k-means's [rows, C, D] float64 distance block.
_KMEANS_ROWS = 4096


def _sq_dists(M: np.ndarray, cent: np.ndarray) -> np.ndarray:
    """((M[:, None] - cent[None]) ** 2).sum(-1) in blocks of rows: each
    row's sum is the reference's, without its [G, C, D] array (3.3 GB at
    the hub4 width)."""
    out = np.empty((len(M), len(cent)))
    for lo in range(0, len(M), _KMEANS_ROWS):
        out[lo: lo + _KMEANS_ROWS] = (
            (M[lo: lo + _KMEANS_ROWS, None] - cent[None]) ** 2).sum(-1)
    return out


def vq_codebook(gauden, n_clusters: int = 64, seed: int = 0,
                n_iter: int = 10) -> tuple:
    """The Gaussian selector's VQ on the host (the reference's k-means over
    the Gaussians' means): (assign [S, K] int32, centroids [C, D]
    float32)."""
    S, K, D, M = _gauss_means(gauden)
    rng = np.random.RandomState(seed)
    C = min(n_clusters, len(M))
    cent = M[rng.choice(len(M), C, replace=False)].copy()
    for _ in range(n_iter):
        a = _sq_dists(M, cent).argmin(1)
        for c in range(C):
            m = a == c
            if m.any():
                cent[c] = M[m].mean(0)
    assign = _sq_dists(M, cent).argmin(1).reshape(S, K).astype(np.int32)
    return assign, cent.astype(np.float32)


class _MaskedDensities(nn.Module):
    """The full density matrix of a ContinuousScorer's parameters with each
    frame's non-shortlisted Gaussians floored at the frame's best plus
    `floor`, then the log-sum-exp over K; subclasses give the keep mask."""

    def __init__(self, scorer: nn.Module, S: int, K: int, D: int,
                 floor: float):
        super().__init__()
        self.inner = scorer
        self.n_sen = scorer.n_sen
        self.floor = float(floor)
        self._S, self._K, self._D = S, K, D

    def keep(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, D] -> [N, S, K] shortlist mask."""
        raise NotImplementedError

    def score(self, feats: torch.Tensor) -> torch.Tensor:
        x = feats.reshape(-1, feats.shape[-1])
        S, K = self._S, self._K
        lin = self.inner.lin.float().reshape(S * K, -1)
        quad = self.inner.quad.float().reshape(S * K, -1)
        const = self.inner.const.reshape(1, S * K)
        out = torch.empty((x.shape[0], S), dtype=torch.float32,
                          device=x.device)
        rows = max(1, _REF_CHUNK_BYTES // (S * K * 4))
        for lo in range(0, x.shape[0], rows):
            xb = x[lo: lo + rows]
            ll = (const + xb @ lin.T - (xb * xb) @ quad.T).view(-1, S, K)
            best = ll.amax((1, 2), keepdim=True)
            ll = torch.where(self.keep(xb), ll, best + self.floor)
            out[lo: lo + rows] = torch.logsumexp(ll, -1)
        return out.reshape(*feats.shape[:-1], S)

    forward = score


class GsSelectorScorer(_MaskedDensities):
    """VQ Gaussian-selector shortlists (sphinx3 gs.c): a coarse VQ codebook
    over the feature space maps each frame to its `top_c` nearest
    clusters; only Gaussians assigned to those clusters (by their means)
    are scored exactly, the rest take the floor.

    scorer: a single-stream ContinuousScorer; `codebook` (`vq_codebook`'s
    output) skips the host k-means."""

    def __init__(self, scorer: nn.Module, gauden, n_clusters: int = 64,
                 top_c: int = 2, floor: float = -40.0, seed: int = 0,
                 n_iter: int = 10, *, codebook: tuple | None = None,
                 device: torch.device | str = "cuda"):
        super().__init__(scorer, gauden.n_mgau, gauden.n_density,
                         int(gauden.veclen[0]), floor)
        assign, cent = (codebook if codebook is not None else
                        vq_codebook(gauden, n_clusters, seed, n_iter))
        self.register_buffer("assign", torch.as_tensor(
            np.asarray(assign, np.int64)).to(device))          # [S, K]
        self.register_buffer("cent", torch.as_tensor(
            np.asarray(cent, np.float32)).to(device))          # [C, D]
        self.top_c = int(top_c)

    def clusters(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, D] -> [N, C] the frames' kept clusters (every cluster as
        near as the top_c-th nearest)."""
        x = x[..., : self._D]
        d2 = ((x[:, None, :] - self.cent[None]) ** 2).sum(-1)     # [N, C]
        thr = d2.sort(-1).values[:, self.top_c - 1: self.top_c]
        return d2 <= thr

    def keep(self, x: torch.Tensor) -> torch.Tensor:
        return self.clusters(x)[:, self.assign]


def bbi_tree(gauden, depth: int = 6, radius: float = 3.0,
             maxbbi: int = 0) -> tuple:
    """The BBI kd-tree on the host (a copy of the reference's builder):
    (node_dim [2^(depth+1)] int32, node_thr float32, leaf_keep [2^depth,
    S, K] bool), internal nodes heap-indexed from 1."""
    S, K, D, M = _gauss_means(gauden)
    SD = np.sqrt(gauden.var[:, 0, :, :D].reshape(S * K, D)
                 .astype(np.float64))
    box_lo = M - radius * SD
    box_hi = M + radius * SD
    n_nodes = 1 << depth               # heap-indexed internal nodes 1..
    n_leaves = 1 << depth
    node_dim = np.zeros(2 * n_nodes, np.int32)
    node_thr = np.zeros(2 * n_nodes, np.float32)
    leaf_keep = np.zeros((n_leaves, S * K), bool)

    def build(node: int, lo: np.ndarray, hi: np.ndarray, level: int,
              cand: np.ndarray) -> None:
        if level == depth:
            leaf = node - n_nodes
            # Bucket-box intersection over the candidate set.
            inter = cand
            if maxbbi and inter.sum() > maxbbi:
                # Keep the maxbbi Gaussians with the largest overlap
                # volume fraction inside this bucket (read_bbi_list's
                # maxbbi truncation semantics).
                ov_lo = np.maximum(box_lo, lo[None])
                ov_hi = np.minimum(box_hi, hi[None])
                frac = np.where(
                    inter[:, None],
                    np.clip(ov_hi - ov_lo, 1e-10, None)
                    / np.clip(box_hi - box_lo, 1e-10, None), 0.0)
                vol = np.sum(np.log(np.clip(frac, 1e-10, None)), 1)
                vol = np.where(inter, vol, -np.inf)
                keep_idx = np.argsort(vol, kind="stable")[-maxbbi:]
                capped = np.zeros_like(inter)
                capped[keep_idx] = inter[keep_idx]
                inter = capped
            leaf_keep[leaf] = inter
            return
        # Split the dimension with the largest candidate-mean spread, at
        # the candidate median.
        cm = M[cand] if cand.any() else M
        dim = int(np.argmax(cm.max(0) - cm.min(0)))
        thr = float(np.median(cm[:, dim]))
        node_dim[node] = dim
        node_thr[node] = thr
        lhi = hi.copy(); lhi[dim] = min(hi[dim], thr)
        rlo = lo.copy(); rlo[dim] = max(lo[dim], thr)
        lcand = cand & (box_lo[:, dim] <= lhi[dim])
        rcand = cand & (box_hi[:, dim] >= rlo[dim])
        build(2 * node, lo, lhi, level + 1, lcand)
        build(2 * node + 1, rlo, hi, level + 1, rcand)

    INF = np.full(D, np.inf)
    build(1, -INF, INF, 0, np.ones(S * K, bool))
    return node_dim, node_thr, leaf_keep.reshape(n_leaves, S, K)


class KdTreeSelectorScorer(_MaskedDensities):
    """Bucket-Box-Intersection kd-tree Gaussian shortlists (sphinx3
    libs3decoder/libam/kdtree.c:1-294, Fritsch & Rogina's BBI, ICASSP
    1996): a kd-tree partitions feature space into 2^depth buckets; each
    Gaussian owns a box (mean +/- radius*stddev) and a bucket's shortlist
    is every Gaussian whose box meets the bucket.  A frame descends the
    tree by `depth` compares; its bucket's shortlist is scored exactly,
    the rest take the floor.  The tree is built on the host (`bbi_tree`;
    `tree` given skips it); `maxbbi` caps a bucket's shortlist by
    box-volume overlap (reference -kdmaxbbi)."""

    def __init__(self, scorer: nn.Module, gauden, depth: int = 6,
                 radius: float = 3.0, maxbbi: int = 0, floor: float = -40.0,
                 *, tree: tuple | None = None,
                 device: torch.device | str = "cuda"):
        super().__init__(scorer, gauden.n_mgau, gauden.n_density,
                         int(gauden.veclen[0]), floor)
        node_dim, node_thr, leaf_keep = (
            tree if tree is not None else
            bbi_tree(gauden, depth, radius, maxbbi))
        self.depth = int(depth)
        self._n_nodes = 1 << depth
        self.register_buffer("node_dim", torch.as_tensor(
            np.asarray(node_dim, np.int64)).to(device))
        self.register_buffer("node_thr", torch.as_tensor(
            np.asarray(node_thr, np.float32)).to(device))
        self.register_buffer("leaf_keep", torch.as_tensor(
            np.asarray(leaf_keep, bool)).to(device))

    def leaves(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, D] -> [N] bucket of each frame: `depth` compares of f32
        values, the heap index doubling a level."""
        x = x[..., : self._D]
        idx = torch.ones(x.shape[0], dtype=torch.int64, device=x.device)
        for _ in range(self.depth):
            v = x.gather(1, self.node_dim[idx][:, None])[:, 0]
            idx = 2 * idx + (v > self.node_thr[idx]).long()
        return idx - self._n_nodes

    def keep(self, x: torch.Tensor) -> torch.Tensor:
        return self.leaf_keep[self.leaves(x)]
