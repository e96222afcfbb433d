"""Continuous-listening voice activity detection.

Capability parity with cont_ad (reference:
sphinxbase/src/libsphinxad/cont_ad_base.c — adaptive noise-level estimation
in the log-power domain, speech/silence state machine with onset/offset
hysteresis, absolute timestamping, `cont_ad_read` streaming wrapper) and the
sphinx3 endpointer (libep/s3_endpointer.c state machine).

Power is computed per 10 ms frame; the noise floor adapts by decaying
toward the observed minimum (the reference's histogram-based estimate
behaves the same way).  A frame is speech when its log power exceeds
noise + `delta`; `onset_frames` consecutive speech frames open a segment
(with `pad_frames` of leading context), `offset_frames` of silence close it.

A copy of `cmusphinx_tpu/frontend/vad.py` (host numpy).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class SpeechSegment:
    start_sample: int
    end_sample: int      # exclusive
    data: np.ndarray


class ContAD:
    """Streaming silence filter over raw 16-bit/float samples."""

    def __init__(self, sample_rate: float = 16000.0, frame_ms: float = 10.0,
                 delta: float = 9.0, onset_frames: int = 4,
                 offset_frames: int = 50, pad_frames: int = 20,
                 noise_init: float = 40.0, adapt_rate: float = 0.02):
        self.fs = int(round(sample_rate * frame_ms / 1000.0))
        self.delta = delta
        self.onset = onset_frames
        self.offset = offset_frames
        self.pad = pad_frames
        self.noise = noise_init          # dB-ish log power floor
        self.adapt = adapt_rate
        self.reset()

    def reset(self) -> None:
        self._carry = np.zeros(0, np.float32)
        self._nsamp = 0
        self._state = "sil"
        self._run = 0
        self._ring: List[np.ndarray] = []
        self._seg: List[np.ndarray] = []
        self._seg_start = 0
        self._out: List[SpeechSegment] = []

    # ------------------------------------------------------------------
    @staticmethod
    def frame_power(frame: np.ndarray) -> float:
        """Log power in dB (cont_ad computes a comparable log-energy)."""
        e = float(np.mean(np.square(frame.astype(np.float64)))) + 1.0
        return 10.0 * np.log10(e)

    def process(self, samples: np.ndarray) -> List[SpeechSegment]:
        """Feed samples; returns any speech segments completed so far."""
        buf = np.concatenate([self._carry, np.asarray(samples, np.float32)])
        n_frames = len(buf) // self.fs
        out: List[SpeechSegment] = []
        for i in range(n_frames):
            frame = buf[i * self.fs : (i + 1) * self.fs]
            self._feed_frame(frame, out)
            self._nsamp += self.fs
        self._carry = buf[n_frames * self.fs :]
        return out

    def end_stream(self) -> List[SpeechSegment]:
        """Flush: close any open segment."""
        out: List[SpeechSegment] = []
        if self._state == "speech" and self._seg:
            data = np.concatenate(self._seg)
            out.append(SpeechSegment(self._seg_start,
                                     self._seg_start + len(data), data))
        self._state = "sil"
        self._seg = []
        self._ring = []
        return out

    # ------------------------------------------------------------------
    def _feed_frame(self, frame: np.ndarray, out: List[SpeechSegment]) -> None:
        p = self.frame_power(frame)
        is_speech = p > self.noise + self.delta
        # Noise floor adaptation: fast decay downward, slow drift upward
        # (cont_ad adapts mainly during silence).
        if not is_speech:
            self.noise += self.adapt * (p - self.noise)
        else:
            self.noise += 0.1 * self.adapt * max(p - self.noise, 0.0)

        if self._state == "sil":
            self._ring.append(frame)
            if len(self._ring) > self.pad:
                self._ring.pop(0)
            self._run = self._run + 1 if is_speech else 0
            if self._run >= self.onset:
                self._state = "speech"
                lead = len(self._ring) * self.fs
                self._seg_start = max(self._nsamp + self.fs - lead, 0)
                self._seg = list(self._ring)
                self._ring = []
                self._run = 0
        else:
            self._seg.append(frame)
            self._run = self._run + 1 if not is_speech else 0
            if self._run >= self.offset:
                data = np.concatenate(self._seg)
                out.append(SpeechSegment(self._seg_start,
                                         self._seg_start + len(data), data))
                self._seg = []
                self._state = "sil"
                self._run = 0


def segment_file(samples: np.ndarray, **kwargs) -> List[SpeechSegment]:
    """Whole-file segmentation convenience (sphinx_adtools capability)."""
    vad = ContAD(**kwargs)
    out = vad.process(samples)
    out += vad.end_stream()
    return out
