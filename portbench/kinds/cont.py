"""The continuous kind: one codebook of K diagonal Gaussians a senone over
the 39-dim `1s_c_d_dd` features, float mixture weights
(`mixture_weights`), scored by the program's `ContinuousScorer` (K1).

Reference: score[t, s] = logsumexp_k(ln w[s,k] + ln N(x_t; mu[s,k],
var[s,k])), as one product [x | x^2] @ [2 inv mu | -inv] with
inv = 1 / (2 var), plus a constant a Gaussian."""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from portbench.gen import task as gen_task
from portbench.reference import model as ref_model
from portbench.reference import scores as ref_scores

SIZE_KEYS = ("n_density",)        # Gaussians a senone (K)
FEAT_PARAMS = {"feat": "1s_c_d_dd", **gen_task.BASE_FEAT}
NCEP = gen_task.NCEP


# ---- generator

def acoustic(rng, size, structure) -> gen_task.Acoustic:
    S, K, D = size.n_sen, size.own["n_density"], 3 * NCEP
    center = rng.normal(0.0, 1.5, (S, NCEP))
    means = np.empty((S, 1, K, D), np.float32)
    means[:, 0, :, :NCEP] = center[:, None, :] + rng.normal(0, 0.3, (S, K, NCEP))
    means[:, 0, :, NCEP:] = rng.normal(0.0, 0.1, (S, K, 2 * NCEP))
    var = np.empty((S, 1, K, D), np.float32)
    var[..., :NCEP] = rng.uniform(0.2, 0.6, (S, 1, K, NCEP))
    var[..., NCEP:2 * NCEP] = rng.uniform(1.0, 3.0, (S, 1, K, NCEP))
    var[..., 2 * NCEP:] = rng.uniform(2.0, 6.0, (S, 1, K, NCEP))
    mixw = rng.dirichlet(np.full(K, 2.0), size=S)

    def emit(rng, s, n):
        k = rng.choice(K, size=n, p=mixw[s])
        return means[s, 0, k, :NCEP] + rng.normal(0.0, 0.25, (n, NCEP))

    return gen_task.Acoustic(means, gen_task.floored(var), [D],
                             gen_task.ln_weights(mixw), emit)


def write_weights(am: gen_task.Acoustic, hmm: str) -> None:
    """`mixture_weights`, file layout [S][1][K]."""
    w = np.exp(am.ln_mixw.astype(np.float64))[:, None, :]
    gen_task.write_s3_array(os.path.join(hmm, "mixture_weights"),
                            list(w.shape), w)


# ---- reference

def read_weights(hmm: str, model, mixwfloor: float = 1e-7) -> dict:
    """ln mixture weights [S, K], normalised and floored."""
    w = ref_model.read_s3_array(os.path.join(hmm, "mixture_weights"), 3)[:, 0]
    w = w / w.sum(-1, keepdims=True)
    return {"ln_mixw": np.log(np.maximum(w, mixwfloor))}


class ContinuousReference:
    """Continuous senone scores from the model's means, variances and
    mixture weights."""

    def __init__(self, means: np.ndarray, var: np.ndarray, ln_mixw: np.ndarray,
                 device: str, precision: str = "f64"):
        S, K, D = means.shape
        dt = ref_scores.dtype(precision)
        self.S, self.K, self.precision = S, K, precision
        inv = 1.0 / (2.0 * var)
        lrd = -0.5 * (np.log(var).sum(-1) + D * math.log(2 * math.pi))
        const = ln_mixw + lrd - (inv * means * means).sum(-1)
        b = np.concatenate([2.0 * inv * means, -inv], -1).reshape(S * K, 2 * D)
        self.b = torch.as_tensor(b.T.copy(), device=device).to(dt)
        self.const = torch.as_tensor(const.reshape(1, S * K),
                                     device=device).to(dt)

    def __call__(self, x: torch.Tensor, rows: int = 256) -> torch.Tensor:
        x = x.to(self.b.dtype)
        out = []
        for i in range(0, x.shape[0], rows):
            xi = x[i: i + rows]
            a = torch.cat([xi, xi * xi], 1)
            d = self.const + ref_scores.product(a, self.b, self.precision)
            out.append(torch.logsumexp(d.view(-1, self.S, self.K), -1))
        return torch.cat(out)


def reference_scorer(model, device: str, precision: str = "f64"):
    return ContinuousReference(model.means[0], model.var[0],
                               model.weights["ln_mixw"], device, precision)


# ---- counts: frozen copies of the program's counters
# (`cmusphinx_tpu_torch/utils/mfu.py`: `continuous_gmm_flops`,
# `continuous_gmm_bytes`).

def score_shape(decoder) -> dict:
    sc = decoder.scorer
    return {"kind": "cont", "S": int(sc.n_sen), "K": int(sc.n_density),
            "D": int(sc.lin.shape[2])}


def continuous_gmm_flops(T: int, S: int, K: int, D: int) -> float:
    """Continuous senone scoring of T frames: two [T, D] @ [D, S*K]
    products, the square, the bias and the log-sum-exp."""
    gemm = 2 * 2.0 * T * D * S * K
    elem = T * D + 3.0 * T * S * K
    return gemm + elem


def continuous_gmm_bytes(T: int, S: int, K: int, D: int,
                         fused: bool = True) -> float:
    """Parameters, features and output once (an unfused path also writes
    and reads the [T, S*K] densities)."""
    base = 4.0 * (2 * S * K * D + S * K + 2 * T * D + T * S)
    if not fused:
        base += 2 * 4.0 * T * S * K
    return base


def score_flops(shape: dict, T: int) -> float:
    return continuous_gmm_flops(T, shape["S"], shape["K"], shape["D"])


def score_bytes(shape: dict, T: int) -> float:
    return continuous_gmm_bytes(T, shape["S"], shape["K"], shape["D"])
