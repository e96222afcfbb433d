"""The plain reference's features and what its senone scorers share.

Written from the Sphinx definitions, in plain PyTorch (any device), and
computed in float64 by default:

- features `1s_c_d_dd`: cepstra replicate-padded by 3 frames a side,
  the mean of the padded block subtracted (`-cmn current`, no AGC), then
  [c, d, dd] with d[t] = c[t+2] - c[t-2] and
  dd[t] = (c[t+3] - c[t-1]) - (c[t+1] - c[t-3]);
- the senone scores: each kind's `reference_scorer` (`kinds/<model>.py`).

`precision="tf32"` is the control: the same computation with float32
features and every product's operands rounded to TF32 (10 mantissa bits,
round to nearest even) before float32 products, as a tensor core's TF32
mode multiplies; on the chip and on the CPU alike.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import kinds

WINDOW = 3
LOGBASE = 1.0001
SHIFT = 10


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.float().contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def dtype(precision: str) -> torch.dtype:
    if precision not in ("f64", "tf32"):
        raise ValueError(f"precision must be f64 or tf32, got {precision!r}")
    return torch.float64 if precision == "f64" else torch.float32


def features(cep: np.ndarray, precision: str = "f64",
             device: str = "cpu") -> torch.Tensor:
    """Cepstra [T, 13] -> features [T, 39]."""
    c = torch.as_tensor(np.asarray(cep), device=device).to(dtype(precision))
    T, w = c.shape[0], WINDOW
    pad = torch.cat([c[:1].expand(w, -1), c, c[-1:].expand(w, -1)])
    pad = pad - pad.mean(0, keepdim=True)

    def sh(k):
        return pad[w + k: w + k + T]

    return torch.cat([sh(0), sh(2) - sh(-2),
                      (sh(3) - sh(-1)) - (sh(1) - sh(-3))], 1)


def product(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b; with `precision="tf32"` as the control multiplies."""
    if precision == "tf32":
        return tf32_round(a) @ tf32_round(b)
    return a @ b


def logadd8_table(base: float = LOGBASE, shift: int = SHIFT) -> np.ndarray:
    """logmath's shifted 8-bit add table: entry d is the rounded
    log_base(1 + base^-(d << shift)), shifted right by `shift`."""
    ln_b = math.log(base)
    d = np.arange(256, dtype=np.int64)
    i = (d << shift).astype(np.float64)
    k = np.floor((np.log1p(np.power(base, -i)) / ln_b) + 0.5 * (1 << shift))
    return k.astype(np.int64) >> shift


def reference_scorer(model, device: str, precision: str = "f64"):
    """The reference scorer of a `model.Model`, by its kind."""
    return kinds.load(model.kind).reference_scorer(model, device, precision)
