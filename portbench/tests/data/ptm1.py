"""A test kind, added to a temporary root's `kinds/` by the tests alone:
phonetically tied mixtures with one 39-dim stream and float
`mixture_weights`, one codebook of K Gaussians a CI phone, each senone
mixing its phone's codebook.  It is the program's `fixture._ptm` frozen in
numpy, which the program's `Decoder` scores with `PTMScorer`; not the
published PTM model (3 streams, 8-bit weights) and no configuration of the
benchmark.

Reference: score[t, s] = logsumexp_k(ln w[s,k] + ln N(x_t; mu[c,k],
var[c,k])) with c the codebook of senone s's CI phone, read from the mdef
as the reference's `bin_mdef.c` does (the first phone, in mdef order, whose
states use s)."""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from portbench.gen import task as gen_task
from portbench.reference import model as ref_model
from portbench.reference import scores as ref_scores

SIZE_KEYS = ("n_density_ptm",)    # Gaussians a CI phone's codebook
FEAT_PARAMS = {"feat": "1s_c_d_dd", **gen_task.BASE_FEAT}
NCEP = gen_task.NCEP


def _sen2ci(n_sen: int, ci_states, tri_states) -> np.ndarray:
    """Senone -> the CI phone of the first phone that uses it (-1: none);
    `ci_states` the CI phones' senones in order, `tri_states` (base,
    senones) of the triphones in mdef order."""
    cb = np.full(n_sen, -1, np.int64)
    for b, st in list(enumerate(ci_states)) + list(tri_states):
        for s in st:
            if cb[s] < 0:
                cb[s] = b
    return cb


# ---- generator

def acoustic(rng, size, structure) -> gen_task.Acoustic:
    C, S = len(structure.phones), size.n_sen
    K, D = size.own["n_density_ptm"], 3 * NCEP
    means = np.empty((C, 1, K, D), np.float32)
    means[:, 0, :, :NCEP] = rng.normal(0.0, 1.5, (C, K, NCEP))
    means[:, 0, :, NCEP:] = rng.normal(0.0, 0.1, (C, K, 2 * NCEP))
    var = np.empty((C, 1, K, D), np.float32)
    var[..., :NCEP] = rng.uniform(0.2, 0.6, (C, 1, K, NCEP))
    var[..., NCEP:] = rng.uniform(1.0, 6.0, (C, 1, K, 2 * NCEP))
    mixw = gen_task.peaked(rng, S, K, 2)
    ci = [[b * gen_task.N_STATE + j for j in range(gen_task.N_STATE)]
          for b in range(C)]
    cb = np.maximum(_sen2ci(S, ci, ((k[0], st) for k, st in
                                    structure.tri.items())), 0)

    def emit(rng, s, n):
        k = rng.choice(K, size=n, p=mixw[s] / mixw[s].sum())
        return means[cb[s], 0, k, :NCEP] + rng.normal(0.0, 0.25, (n, NCEP))

    return gen_task.Acoustic(means, gen_task.floored(var), [D],
                             gen_task.ln_weights(mixw), emit)


def write_weights(am: gen_task.Acoustic, hmm: str) -> None:
    """`mixture_weights`, file layout [S][1][K]."""
    w = np.exp(am.ln_mixw.astype(np.float64))[:, None, :]
    gen_task.write_s3_array(os.path.join(hmm, "mixture_weights"),
                            list(w.shape), w)


# ---- reference

def read_weights(hmm: str, model, mixwfloor: float = 1e-7) -> dict:
    """ln mixture weights [S, K], normalised and floored, and each
    senone's codebook."""
    w = ref_model.read_s3_array(os.path.join(hmm, "mixture_weights"), 3)[:, 0]
    w = w / w.sum(-1, keepdims=True)
    md = model.mdef
    cb = _sen2ci(md.n_sen, md.ci_states,
                 ((k[0], st) for k, (_, st) in md.tri.items()))
    if (cb < 0).any():
        raise ValueError(f"{hmm}: senones no phone uses have no codebook")
    return {"ln_mixw": np.log(np.maximum(w, mixwfloor)), "sen2cb": cb}


class PtmReference:
    def __init__(self, means: np.ndarray, var: np.ndarray, ln_mixw: np.ndarray,
                 sen2cb: np.ndarray, device: str, precision: str = "f64"):
        C, K, D = means.shape
        dt = ref_scores.dtype(precision)
        self.C, self.K, self.precision = C, K, precision
        inv = 1.0 / (2.0 * var)
        lrd = -0.5 * (np.log(var).sum(-1) + D * math.log(2 * math.pi))
        const = lrd - (inv * means * means).sum(-1)
        b = np.concatenate([2.0 * inv * means, -inv], -1).reshape(C * K, 2 * D)
        self.b = torch.as_tensor(b.T.copy(), device=device).to(dt)
        self.const = torch.as_tensor(const.reshape(1, C * K),
                                     device=device).to(dt)
        self.w = torch.as_tensor(ln_mixw, device=device).to(dt)
        self.cb = torch.as_tensor(sen2cb, device=device)

    def __call__(self, x: torch.Tensor, rows: int = 256) -> torch.Tensor:
        x = x.to(self.b.dtype)
        out = []
        for i in range(0, x.shape[0], rows):
            xi = x[i: i + rows]
            a = torch.cat([xi, xi * xi], 1)
            d = self.const + ref_scores.product(a, self.b, self.precision)
            d = d.view(-1, self.C, self.K)[:, self.cb, :] + self.w
            out.append(torch.logsumexp(d, -1))
        return torch.cat(out)


def reference_scorer(model, device: str, precision: str = "f64"):
    return PtmReference(model.means[0], model.var[0],
                        model.weights["ln_mixw"], model.weights["sen2cb"],
                        device, precision)


# ---- counts (the test kind's own)

def score_shape(decoder) -> dict:
    sc = decoder.scorer
    return {"kind": "ptm1", "C": int(sc.n_cb), "S": int(sc.n_sen),
            "K": int(sc.n_density), "D": int(sc.lin.shape[2])}


def score_flops(shape: dict, T: int) -> float:
    """The two [T, D] @ [D, C*K] products, the square and the bias, then a
    senone's K weights added and log-summed."""
    C, S, K, D = shape["C"], shape["S"], shape["K"], shape["D"]
    return 2 * 2.0 * T * D * C * K + T * D + T * C * K + 3.0 * T * S * K


def score_bytes(shape: dict, T: int) -> float:
    """Codebooks, weights, the senone map, features and output once."""
    C, S, K, D = shape["C"], shape["S"], shape["K"], shape["D"]
    return 4.0 * (2 * C * K * D + C * K + S * K + 2 * T * D + T * S) + 8.0 * S
