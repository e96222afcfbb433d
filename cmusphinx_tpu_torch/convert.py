"""Carry the JAX package's device parameters across to the port.

Inputs are numpy arrays, as `np.asarray` gives them from the reference's
objects, so this module needs no JAX.  Both packages also build from the
same host objects (`GaussianParams`, `Mdef`, `Dictionary`, `NgramModel`);
the tests check that the two routes give the same tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.ngram_device import DeviceNgram


def _f32(a) -> np.ndarray:
    # bfloat16 arrays (ml_dtypes) widen to float32 exactly.
    return np.asarray(a).astype(np.float32)


def continuous_from_jax(lin: np.ndarray, quad: np.ndarray, const: np.ndarray,
                        n_sen: int, n_density: int):
    """The reference ContinuousScorer's lin/quad [D, S*K] and const [S*K]
    (`cmusphinx_tpu/ops/gmm.py:172-175`) -> the port's senone-major
    lin/quad [S, K, D] and const [S, K] (float32 numpy)."""
    S, K = n_sen, n_density
    D = lin.shape[0]
    lin3 = np.ascontiguousarray(_f32(lin).T.reshape(S, K, D))
    quad3 = np.ascontiguousarray(_f32(quad).T.reshape(S, K, D))
    return lin3, quad3, _f32(const).reshape(S, K)


def ngram_from_jax(tg_dense: np.ndarray, *,
                   device: torch.device | str) -> DeviceNgram:
    """The reference DeviceNgram's dense [V+1, V+1, V] table
    (`cmusphinx_tpu/models/ngram_device.py:81`) -> the port's DeviceNgram."""
    return DeviceNgram.from_dense(_f32(tg_dense), device=device)


def _streams(arrays):
    return [_f32(a) for a in arrays]


def psparity_from_jax(means, prec, lrd, mixw, tbl_steps) -> dict:
    """The reference PsParityScorer's per-stream logmath-domain `means`,
    `prec`, `lrd` and `mixw` [K, S] lists and its threshold steps
    `_tbl_steps` (`cmusphinx_tpu/ops/gmm.py:311-346`) -> keyword arguments
    of `PsParityScorer.from_params`: the same arrays, mixw stacked to int32
    [n_feat, K, S], and the logadd table table8[d] = sum_v [d < steps[v]]
    (the threshold-sum form read back as a table)."""
    steps = np.asarray(tbl_steps, np.int64)
    table8 = (np.arange(256)[:, None] < steps[None, :]).sum(1)
    return {"means": _streams(means), "prec": _streams(prec),
            "lrd": _streams(lrd),
            "mixw": np.stack([np.asarray(m, np.int32) for m in mixw]),
            "table8": table8.astype(np.int32)}


def semicont_from_jax(means, prec, lrd, w) -> dict:
    """The reference SemiContinuousScorer's per-stream `means`, `prec`,
    `lrd` lists and linear weights `w` [n_feat, K, S] -> keyword arguments
    of `SemiContinuousScorer.from_params` (float32 numpy)."""
    return {"means": _streams(means), "prec": _streams(prec),
            "lrd": _streams(lrd), "w": _f32(w)}


def ptm_from_jax(lin, quad, const, lnw, sen2cb, n_cb: int,
                 n_density: int) -> dict:
    """The reference PTMScorer's lin/quad [D, C*K], const [C*K], lnw [S, K]
    and sen2cb [S] -> keyword arguments of `PTMScorer.from_params`:
    codebook-major lin/quad [C, K, D] and const [C, K]."""
    C, K = n_cb, n_density
    D = np.asarray(lin).shape[0]
    return {"lin": np.ascontiguousarray(_f32(lin).T.reshape(C, K, D)),
            "quad": np.ascontiguousarray(_f32(quad).T.reshape(C, K, D)),
            "const": _f32(const).reshape(C, K), "lnw": _f32(lnw),
            "sen2cb": np.asarray(sen2cb, np.int32)}
