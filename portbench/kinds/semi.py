"""The semi-continuous kind of hub4wsj_sc_8k: one shared codebook of K
Gaussians a stream, 3 streams of 13 (`-svspec 0-12/13-25/26-38`), 8-bit
`sendump` weights, scored by the program's `PsParityScorer`.

Reference: pocketsphinx's integer arithmetic (s2_semi_mgau.c): per stream
the log-base-1.0001 densities of the shared codebook (precisions and
determinants truncated a dimension at a time), truncated to integers; the
top 4 a frame (ties to the lower index); shifted right by 10 and taken
relative to the best; clamped at 96; added to the senone's 8-bit weights
and summed over the 4 with the 8-bit log-add table; summed over streams;
times -1024 ln(1.0001)."""

from __future__ import annotations

import math
import os
from typing import List, Sequence

import numpy as np
import torch

from portbench.gen import task as gen_task
from portbench.reference import model as ref_model
from portbench.reference import scores as ref_scores

SIZE_KEYS = ("n_density_semi",)   # Gaussians a stream
NCEP = gen_task.NCEP
# Feature streams (-svspec 0-12/13-25/26-38).
STREAMS = [list(range(0, 13)), list(range(13, 26)), list(range(26, 39))]
# Frontend parameters of hub4wsj_sc_8k's feat.params.
FE_PARAMS = {"nfilt": 20, "lowerf": 1, "upperf": 4000,
             "transform": "dct", "cmninit": "56,-3,1"}
FEAT_PARAMS = {"feat": "1s_c_d_dd", "svspec": "0-12/13-25/26-38",
               **gen_task.BASE_FEAT, **FE_PARAMS}
TOPN = 4
MAX_NEG_ASCR = 96


# ---- generator

def acoustic(rng, size, structure) -> gen_task.Acoustic:
    """Stream 0 holds the static cepstra; each senone's stream-0 weights
    concentrate on 3 codewords, and its frames are drawn from them.  The
    other streams get generic codebooks and near-uniform weights."""
    S, K = size.n_sen, size.own["n_density_semi"]
    lens = [len(x) for x in STREAMS]
    L = max(lens)
    cw = rng.normal(0.0, 1.5, (K, NCEP))            # codeword cepstra
    means = np.zeros((1, len(lens), K, L), np.float32)
    var = np.zeros_like(means)
    means[0, 0, :, :lens[0]] = cw
    var[0, 0, :, :lens[0]] = rng.uniform(0.2, 0.6, (K, lens[0]))
    for f, ln in enumerate(lens[1:], 1):
        means[0, f, :, :ln] = rng.normal(0.0, 2.0, (K, ln))
        var[0, f, :, :ln] = rng.uniform(1.0, 4.0, (K, ln))
    w0 = gen_task.peaked(rng, S, K, 3)
    ws = [w0] + [rng.dirichlet(np.full(K, 50.0), size=S) for _ in lens[1:]]
    ln_mixw = np.log(np.stack(ws)).transpose(0, 2, 1)     # [F, K, S]
    p0 = w0 / w0.sum(-1, keepdims=True)

    def emit(rng, s, n):
        k = rng.choice(K, size=n, p=p0[s])
        return cw[k] + rng.normal(0.0, 0.25, (n, NCEP))

    return gen_task.Acoustic(means, gen_task.floored(var), lens,
                             np.ascontiguousarray(ln_mixw, np.float32), emit)


def write_weights(am: gen_task.Acoustic, hmm: str) -> None:
    """The 8-bit `sendump` of the ln weights [F, K, S]."""
    gen_task.write_sendump8(os.path.join(hmm, "sendump"), am.ln_mixw)


# ---- reference

def read_weights(hmm: str, model) -> dict:
    """The sendump's raw bytes [F, K, S] and the streams of feat.params's
    svspec."""
    return {"sendump": ref_model.read_sendump8(os.path.join(hmm, "sendump")),
            "streams": [list(range(int(a), int(b) + 1)) for a, b in
                        (s.split("-") for s in
                         model.feat_params["svspec"].split("/"))]}


class SemiReference:
    """Semi-continuous senone scores in pocketsphinx's integer arithmetic."""

    def __init__(self, means: List[np.ndarray], var: List[np.ndarray],
                 sendump: np.ndarray, streams: Sequence[Sequence[int]],
                 device: str, precision: str = "f64"):
        inv = 1.0 / math.log(ref_scores.LOGBASE)
        dt = ref_scores.dtype(precision)
        self.precision, self.device = precision, device
        self.streams = [torch.as_tensor(list(s), device=device) for s in streams]
        self.means, self.prec, self.lrd, self.b, self.const = [], [], [], [], []
        for m, v in zip(means, var):
            m, v = m[0], v[0]                        # [K, d]
            prec = np.trunc((1.0 / (2.0 * v)) * inv)
            lrd = np.trunc(np.log(1.0 / np.sqrt(2.0 * np.pi * v)) * inv).sum(-1)
            self.means.append(torch.as_tensor(m, device=device).to(dt))
            self.prec.append(torch.as_tensor(prec, device=device).to(dt))
            self.lrd.append(torch.as_tensor(lrd, device=device).to(dt))
            self.b.append(torch.as_tensor(
                np.concatenate([2.0 * prec * m, -prec], -1).T.copy(),
                device=device).to(dt))
            self.const.append(torch.as_tensor(
                lrd - (prec * m * m).sum(-1), device=device).to(dt))
        self.w = torch.as_tensor(sendump, device=device)        # [F, K, S]
        self.table = torch.as_tensor(ref_scores.logadd8_table(), device=device)
        self.scale = (1 << ref_scores.SHIFT) * math.log(ref_scores.LOGBASE)

    def densities(self, x: torch.Tensor, f: int) -> torch.Tensor:
        """Integer densities [N, K] of stream f."""
        xs = x[:, self.streams[f]].to(self.means[f].dtype)
        if self.precision == "f64":
            diff = xs[:, None, :] - self.means[f][None]
            d = self.lrd[f][None] - (diff * diff * self.prec[f][None]).sum(-1)
        else:
            a = torch.cat([xs, xs * xs], 1)
            d = self.const[f][None] + ref_scores.product(a, self.b[f], "tf32")
        return torch.trunc(d.clamp(-2.0e9, 0.0)).to(torch.int64)

    def __call__(self, x: torch.Tensor, rows: int = 1024) -> torch.Tensor:
        out = []
        shift = ref_scores.SHIFT
        for i in range(0, x.shape[0], rows):
            xi = x[i: i + rows]
            acc = 0
            for f in range(len(self.streams)):
                d = self.densities(xi, f)
                order = torch.sort(-d, dim=1, stable=True).indices[:, :TOPN]
                vals = torch.gather(d, 1, order)
                sh = torch.div(vals, 1 << shift, rounding_mode="floor")
                fsc = (sh[:, :1] - sh).clamp_max(MAX_NEG_ASCR)   # >= 0
                tmp = None
                for j in range(TOPN):
                    y = self.w[f][order[:, j]] + fsc[:, j: j + 1]   # [n, S]
                    if tmp is None:
                        tmp = y
                        continue
                    dd = (tmp - y).abs().clamp_max(255)
                    tmp = torch.minimum(tmp, y) - self.table[dd]
                acc = acc + tmp
            out.append(-acc.to(torch.float64) * self.scale)
        return torch.cat(out)


def reference_scorer(model, device: str, precision: str = "f64"):
    return SemiReference(model.means, model.var, model.weights["sendump"],
                         model.weights["streams"], device, precision)


# ---- counts: `psparity_flops` is a frozen copy of the program's counter
# (`cmusphinx_tpu_torch/utils/mfu.py`); `psparity_bytes` is the
# yardstick's own.

def score_shape(decoder) -> dict:
    sc = decoder.scorer
    return {"kind": "semi", "S": int(sc.n_sen), "K": int(sc.n_density),
            "veclens": [len(s) for s in decoder.fp.stream_slices()],
            "topn": int(sc.topn)}


def psparity_flops(T: int, n_feat: int, n_density: int, veclens, n_sen: int,
                   topn: int) -> float:
    """Semi-continuous scoring: per stream the density product, the top-N
    rounds and the senones' log-add over the top N."""
    f = 0.0
    for d in veclens:
        f += 2.0 * T * int(d) * n_density
        f += 4.0 * topn * T * n_density
        f += 3.0 * T * topn * n_sen
    return f


def psparity_bytes(T: int, n_density: int, veclens, n_sen: int) -> float:
    """The 8-bit weights [n_feat, n_density, S], the codebooks (means and
    precisions a dimension, a determinant a density), the features
    [T, D] (float32) and the output [T, S] (float32), each once."""
    D = sum(int(d) for d in veclens)
    weights = 1.0 * len(veclens) * n_density * n_sen
    books = 4.0 * n_density * (2 * D + len(veclens))
    return weights + books + 4.0 * T * D + 4.0 * T * n_sen


def score_flops(shape: dict, T: int) -> float:
    return psparity_flops(T, len(shape["veclens"]), shape["K"],
                          shape["veclens"], shape["S"], shape["topn"])


def score_bytes(shape: dict, T: int) -> float:
    return psparity_bytes(T, shape["K"], shape["veclens"], shape["S"])
