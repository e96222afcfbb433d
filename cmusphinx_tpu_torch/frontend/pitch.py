"""YIN fundamental-frequency estimation (sphinx_pitch capability).

Reference: sphinxbase/src/libsphinxbase/fe/yin.c (321 LoC) — the YIN
algorithm: squared-difference function over lags, cumulative-mean
normalization, absolute threshold with parabolic refinement.  Vectorized
over all frames at once: the difference function for every (frame, lag)
pair is a couple of cumulative-sum tricks + an FFT-free correlation,
batched as array ops.

A copy of `cmusphinx_tpu/frontend/pitch.py` (host numpy).
"""

from __future__ import annotations

import numpy as np


def yin_pitch(samples: np.ndarray, sample_rate: float = 16000.0,
              frame_len: float = 0.025, frame_shift: float = 0.01,
              fmin: float = 60.0, fmax: float = 400.0,
              threshold: float = 0.1) -> np.ndarray:
    """Per-frame F0 in Hz (0 where unvoiced).  samples: [N] float."""
    x = np.asarray(samples, np.float64)
    w = int(round(sample_rate * frame_len))
    step = int(round(sample_rate * frame_shift))
    tau_min = max(int(sample_rate / fmax), 2)
    tau_max = min(int(sample_rate / fmin), w - 1)
    n_frames = max((len(x) - w - tau_max) // step + 1, 0)
    if n_frames <= 0:
        return np.zeros(0, np.float32)

    idx = np.arange(w)
    starts = np.arange(n_frames) * step
    frames = x[starts[:, None] + idx]                       # [F, w]
    out = np.zeros(n_frames, np.float32)

    # Difference function d[f, tau] = sum_j (x[j] - x[j+tau])^2.
    taus = np.arange(tau_min, tau_max + 1)
    d = np.empty((n_frames, len(taus)))
    for k, tau in enumerate(taus):
        seg2 = x[starts[:, None] + idx + tau]
        diff = frames - seg2
        d[:, k] = np.einsum("ij,ij->i", diff, diff)
    # Cumulative mean normalized difference.
    csum = np.cumsum(d, axis=1)
    denom = csum / np.arange(1, len(taus) + 1)[None, :]
    dn = np.where(denom > 0, d / np.maximum(denom, 1e-12), 1.0)

    for f in range(n_frames):
        below = np.nonzero(dn[f] < threshold)[0]
        if len(below) == 0:
            k = int(np.argmin(dn[f]))
            if dn[f][k] > 0.6:       # clearly unvoiced
                continue
        else:
            k = int(below[0])
            # walk to the local minimum of this dip
            while k + 1 < len(taus) and dn[f][k + 1] < dn[f][k]:
                k += 1
        tau = taus[k]
        # Parabolic interpolation around the minimum.
        if 0 < k < len(taus) - 1:
            a, b, c = dn[f][k - 1], dn[f][k], dn[f][k + 1]
            den = a - 2 * b + c
            if abs(den) > 1e-12:
                tau = tau + 0.5 * (a - c) / den
        out[f] = sample_rate / tau
    return out
