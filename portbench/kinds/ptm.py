"""The phonetically-tied-mixture kind of pocketsphinx's default US English
model (model/en-us/en-us, cmusphinx-en-us-ptm-5.2, `-model ptm`): one
codebook of K Gaussians a CI phone and stream, 3 streams of 13
(`-svspec 0-12/13-25/26-38`), 8-bit `sendump` weights, each senone mixing
its CI phone's codebook; scored by the program's `PtmParityScorer`.

Reference: pocketsphinx's integer arithmetic (ptm_mgau.c), written from
its equations in plain PyTorch, float64: per codebook and stream the
log-base-1.0001 densities (precisions and determinants truncated a
dimension at a time, the direct form lrd' - sum prec' (x - mu)^2),
truncated to integers; the top 4 of each codebook and stream (a stable
sort: ties to the lower index); shifted right by 10 and taken relative to
the best of all codebooks in the stream; clamped at 96; added to the
senone's 8-bit weights of its codebook's top 4 and summed over the 4 with
the 8-bit log-add table; summed over streams; times -1024 ln(1.0001).  A
senone's codebook is the CI phone of the first phone in the mdef that uses
it (bin_mdef.c's sen2cimap), codebook 0 where none does."""

from __future__ import annotations

import math
import os
from typing import List, Sequence

import numpy as np
import torch

from portbench.gen import task as gen_task
from portbench.reference import model as ref_model
from portbench.reference import scores as ref_scores

SIZE_KEYS = ("n_density_ptm_stream",)   # Gaussians a codebook and stream
NCEP = gen_task.NCEP
STREAMS = [list(range(0, 13)), list(range(13, 26)), list(range(26, 39))]
# The frontend lines of en-us's feat.params that the program reads.
FE_PARAMS = {"lowerf": 130, "upperf": 6800, "nfilt": 25, "transform": "dct",
             "lifter": 22, "varnorm": "no"}
FEAT_PARAMS = {"feat": "1s_c_d_dd", "svspec": "0-12/13-25/26-38",
               **gen_task.BASE_FEAT, **FE_PARAMS}
TOPN = 4
MAX_NEG_ASCR = 96


def _sen2cb(n_sen: int, ci_states, tri_states) -> np.ndarray:
    """Senone -> the CI phone of the first phone that uses it, 0 where
    none does; `ci_states` the CI phones' senones in order, `tri_states`
    (base, senones) of the triphones in mdef order."""
    cb = np.full(n_sen, -1, np.int64)
    for b, st in list(enumerate(ci_states)) + list(tri_states):
        for s in st:
            if cb[s] < 0:
                cb[s] = b
    return np.maximum(cb, 0)


# ---- generator

def acoustic(rng, size, structure) -> gen_task.Acoustic:
    """One codebook a CI phone and stream.  Stream 0 holds the static
    cepstra; each senone's stream-0 weights concentrate on 3 codewords of
    its phone's codebook, and its frames are drawn from them.  The other
    streams get generic codebooks and near-uniform weights."""
    C, S = len(structure.phones), size.n_sen
    K = size.own["n_density_ptm_stream"]
    F = len(STREAMS)
    cw = rng.normal(0.0, 1.5, (C, K, NCEP))          # codeword cepstra
    means = np.zeros((C, F, K, NCEP), np.float32)
    var = np.zeros_like(means)
    means[:, 0] = cw
    var[:, 0] = rng.uniform(0.2, 0.6, (C, K, NCEP))
    for f in range(1, F):
        means[:, f] = rng.normal(0.0, 2.0, (C, K, NCEP))
        var[:, f] = rng.uniform(1.0, 4.0, (C, K, NCEP))
    w0 = gen_task.peaked(rng, S, K, 3)
    ws = [w0] + [rng.dirichlet(np.full(K, 50.0), size=S) for _ in STREAMS[1:]]
    ln_mixw = np.log(np.stack(ws)).transpose(0, 2, 1)     # [F, K, S]
    p0 = w0 / w0.sum(-1, keepdims=True)
    ci = [[b * gen_task.N_STATE + j for j in range(gen_task.N_STATE)]
          for b in range(C)]
    cb = _sen2cb(S, ci, ((k[0], st) for k, st in structure.tri.items()))

    def emit(rng, s, n):
        k = rng.choice(K, size=n, p=p0[s])
        return cw[cb[s], k] + rng.normal(0.0, 0.25, (n, NCEP))

    return gen_task.Acoustic(means, gen_task.floored(var), [NCEP] * F,
                             np.ascontiguousarray(ln_mixw, np.float32), emit)


def write_weights(am: gen_task.Acoustic, hmm: str) -> None:
    """The 8-bit `sendump` of the ln weights [F, K, S]."""
    gen_task.write_sendump8(os.path.join(hmm, "sendump"), am.ln_mixw)


# ---- reference

def read_weights(hmm: str, model) -> dict:
    """The sendump's raw bytes [F, K, S], each senone's codebook (from the
    mdef) and the streams of feat.params's svspec."""
    md = model.mdef
    return {"sendump": ref_model.read_sendump8(os.path.join(hmm, "sendump")),
            "sen2cb": _sen2cb(md.n_sen, md.ci_states,
                              ((k[0], st) for k, (_, st) in md.tri.items())),
            "streams": [list(range(int(a), int(b) + 1)) for a, b in
                        (s.split("-") for s in
                         model.feat_params["svspec"].split("/"))]}


class PtmReference:
    """PTM senone scores in pocketsphinx's integer arithmetic."""

    def __init__(self, means: List[np.ndarray], var: List[np.ndarray],
                 sendump: np.ndarray, sen2cb: np.ndarray,
                 streams: Sequence[Sequence[int]], device: str,
                 precision: str = "f64"):
        inv = 1.0 / math.log(ref_scores.LOGBASE)
        dt = ref_scores.dtype(precision)
        self.precision = precision
        self.streams = [torch.as_tensor(list(s), device=device)
                        for s in streams]
        self.mu, self.prec, self.lrd, self.b, self.const = [], [], [], [], []
        for m, v in zip(means, var):                  # [C, K, d]
            prec = np.trunc((1.0 / (2.0 * v)) * inv)
            lrd = np.trunc(np.log(1.0 / np.sqrt(2.0 * np.pi * v))
                           * inv).sum(-1)
            C, K, d = m.shape
            self.mu.append(torch.as_tensor(m, device=device).to(dt))
            self.prec.append(torch.as_tensor(prec, device=device).to(dt))
            self.lrd.append(torch.as_tensor(lrd, device=device).to(dt))
            self.b.append(torch.as_tensor(
                np.concatenate([2.0 * prec * m, -prec], -1).reshape(
                    C * K, 2 * d).T.copy(), device=device).to(dt))
            self.const.append(torch.as_tensor(
                lrd - (prec * m * m).sum(-1), device=device).to(dt))
        self.w = torch.as_tensor(sendump, device=device)         # [F, K, S]
        self.cb = torch.as_tensor(sen2cb, device=device)
        self.table = torch.as_tensor(ref_scores.logadd8_table(), device=device)
        self.scale = (1 << ref_scores.SHIFT) * math.log(ref_scores.LOGBASE)

    def densities(self, x: torch.Tensor, f: int) -> torch.Tensor:
        """Integer densities [n, C, K] of stream f."""
        xs = x[:, self.streams[f]].to(self.mu[f].dtype)
        if self.precision == "f64":
            diff = xs[:, None, None, :] - self.mu[f][None]
            d = self.lrd[f][None] - (self.prec[f][None] * diff * diff).sum(-1)
        else:
            a = torch.cat([xs, xs * xs], 1)
            d = self.const[f][None] + ref_scores.product(
                a, self.b[f], "tf32").view(xs.shape[0], *self.const[f].shape)
        return torch.trunc(d.clamp(-2.0e9, 0.0)).to(torch.int64)

    def __call__(self, x: torch.Tensor, rows: int = 128) -> torch.Tensor:
        out = []
        shift = ref_scores.SHIFT
        for i in range(0, x.shape[0], rows):
            xi = x[i: i + rows]
            acc = 0
            for f in range(len(self.streams)):
                d = self.densities(xi, f)                      # [n, C, K]
                order = torch.sort(-d, dim=2, stable=True).indices[..., :TOPN]
                sh = torch.div(torch.gather(d, 2, order), 1 << shift,
                               rounding_mode="floor")
                norm = sh[:, :, :1].amax(1, keepdim=True)      # [n, 1, 1]
                fsc = (norm - sh).clamp_max(MAX_NEG_ASCR)      # [n, C, 4]
                idx, sc = order[:, self.cb], fsc[:, self.cb]   # [n, S, 4]
                tmp = None
                for j in range(TOPN):
                    y = torch.gather(self.w[f], 0, idx[:, :, j]) + sc[:, :, j]
                    if tmp is None:
                        tmp = y
                        continue
                    dd = (tmp - y).abs().clamp_max(255)
                    tmp = torch.minimum(tmp, y) - self.table[dd]
                acc = acc + tmp
            out.append(-acc.to(torch.float64) * self.scale)
        return torch.cat(out)


def reference_scorer(model, device: str, precision: str = "f64"):
    w = model.weights
    return PtmReference(model.means, model.var, w["sendump"], w["sen2cb"],
                        w["streams"], device, precision)


# ---- counts: the yardstick's own, in `semi.py`'s conventions with C
# codebooks.

def score_shape(decoder) -> dict:
    sc = decoder.scorer
    return {"kind": "ptm", "C": int(sc.n_cb), "S": int(sc.n_sen),
            "K": int(sc.n_density),
            "veclens": [len(s) for s in decoder.fp.stream_slices()],
            "topn": int(sc.topn)}


def score_flops(shape: dict, T: int) -> float:
    """Per stream: the density product of every codebook (2 T d K C), the
    top-N rounds of every codebook (4 N T K C) and the senones' log-add
    over the top N (3 T N S)."""
    C, K, S, n = shape["C"], shape["K"], shape["S"], shape["topn"]
    f = 0.0
    for d in shape["veclens"]:
        f += 2.0 * T * int(d) * K * C
        f += 4.0 * n * T * K * C
        f += 3.0 * T * n * S
    return f


def score_bytes(shape: dict, T: int) -> float:
    """The 8-bit weights [F, K, S], the codebooks (means and precisions a
    dimension, a determinant a codeword, of C codebooks), the features
    [T, D] (float32) and the output [T, S] (float32), each once."""
    C, K, S, vl = shape["C"], shape["K"], shape["S"], shape["veclens"]
    D = sum(int(d) for d in vl)
    weights = 1.0 * len(vl) * K * S
    books = 4.0 * C * K * (2 * D + len(vl))
    return weights + books + 4.0 * T * D + 4.0 * T * S
