"""The plain reference's features and senone scores.

Written from the Sphinx definitions, in plain PyTorch (any device), and
computed in float64 by default:

- features `1s_c_d_dd`: cepstra replicate-padded by 3 frames a side,
  the mean of the padded block subtracted (`-cmn current`, no AGC), then
  [c, d, dd] with d[t] = c[t+2] - c[t-2] and
  dd[t] = (c[t+3] - c[t-1]) - (c[t+1] - c[t-3]);
- continuous senones: score[t, s] = logsumexp_k(ln w[s,k] + ln N(x_t;
  mu[s,k], var[s,k])), diagonal Gaussians;
- semi-continuous senones in pocketsphinx's integer arithmetic
  (s2_semi_mgau.c): per stream the log-base-1.0001 densities of the
  shared codebook (precisions and determinants truncated a dimension at a
  time), truncated to integers; the top 4 a frame (ties to the lower
  index); shifted right by 10 and taken relative to the best; clamped at
  96; added to the senone's 8-bit weights and summed over the 4 with the
  8-bit log-add table; summed over streams; times -1024 ln(1.0001).

`precision="tf32"` is the control: the same computation with float32
features and every product's operands rounded to TF32 (10 mantissa bits,
round to nearest even) before float32 products, as a tensor core's TF32
mode multiplies; on the chip and on the CPU alike.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

WINDOW = 3
LOGBASE = 1.0001
SHIFT = 10
TOPN = 4
MAX_NEG_ASCR = 96


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.float().contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def _dtype(precision: str) -> torch.dtype:
    if precision not in ("f64", "tf32"):
        raise ValueError(f"precision must be f64 or tf32, got {precision!r}")
    return torch.float64 if precision == "f64" else torch.float32


def features(cep: np.ndarray, precision: str = "f64",
             device: str = "cpu") -> torch.Tensor:
    """Cepstra [T, 13] -> features [T, 39]."""
    c = torch.as_tensor(np.asarray(cep), device=device).to(_dtype(precision))
    T, w = c.shape[0], WINDOW
    pad = torch.cat([c[:1].expand(w, -1), c, c[-1:].expand(w, -1)])
    pad = pad - pad.mean(0, keepdim=True)

    def sh(k):
        return pad[w + k: w + k + T]

    return torch.cat([sh(0), sh(2) - sh(-2),
                      (sh(3) - sh(-1)) - (sh(1) - sh(-3))], 1)


def _product(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        return tf32_round(a) @ tf32_round(b)
    return a @ b


class ContinuousReference:
    """Continuous senone scores from the model's means, variances and
    mixture weights."""

    def __init__(self, means: np.ndarray, var: np.ndarray, ln_mixw: np.ndarray,
                 device: str, precision: str = "f64"):
        S, K, D = means.shape
        dt = _dtype(precision)
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
            d = self.const + _product(a, self.b, self.precision)
            out.append(torch.logsumexp(d.view(-1, self.S, self.K), -1))
        return torch.cat(out)


def logadd8_table(base: float = LOGBASE, shift: int = SHIFT) -> np.ndarray:
    """logmath's shifted 8-bit add table: entry d is the rounded
    log_base(1 + base^-(d << shift)), shifted right by `shift`."""
    ln_b = math.log(base)
    d = np.arange(256, dtype=np.int64)
    i = (d << shift).astype(np.float64)
    k = np.floor((np.log1p(np.power(base, -i)) / ln_b) + 0.5 * (1 << shift))
    return k.astype(np.int64) >> shift


class SemiReference:
    """Semi-continuous senone scores in pocketsphinx's integer arithmetic."""

    def __init__(self, means: List[np.ndarray], var: List[np.ndarray],
                 sendump: np.ndarray, streams: Sequence[Sequence[int]],
                 device: str, precision: str = "f64"):
        inv = 1.0 / math.log(LOGBASE)
        dt = _dtype(precision)
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
        self.table = torch.as_tensor(logadd8_table(), device=device)
        self.scale = (1 << SHIFT) * math.log(LOGBASE)

    def densities(self, x: torch.Tensor, f: int) -> torch.Tensor:
        """Integer densities [N, K] of stream f."""
        xs = x[:, self.streams[f]].to(self.means[f].dtype)
        if self.precision == "f64":
            diff = xs[:, None, :] - self.means[f][None]
            d = self.lrd[f][None] - (diff * diff * self.prec[f][None]).sum(-1)
        else:
            a = torch.cat([xs, xs * xs], 1)
            d = self.const[f][None] + _product(a, self.b[f], "tf32")
        return torch.trunc(d.clamp(-2.0e9, 0.0)).to(torch.int64)

    def __call__(self, x: torch.Tensor, rows: int = 1024) -> torch.Tensor:
        out = []
        for i in range(0, x.shape[0], rows):
            xi = x[i: i + rows]
            acc = 0
            for f in range(len(self.streams)):
                d = self.densities(xi, f)
                order = torch.sort(-d, dim=1, stable=True).indices[:, :TOPN]
                vals = torch.gather(d, 1, order)
                sh = torch.div(vals, 1 << SHIFT, rounding_mode="floor")
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
    """The reference scorer of a `model.Model`."""
    if model.kind == "cont":
        return ContinuousReference(model.means[0], model.var[0], model.ln_mixw,
                                   device, precision)
    return SemiReference(model.means, model.var, model.sendump, model.streams,
                         device, precision)
