"""Push-pipeline front door: VAD-gated continuous decoding with callbacks.

The GStreamer element capability (reference:
pocketsphinx/src/gst-plugin/gstpocketsphinx.c — decoder element posting
partial results as bus messages, gated by the `vader` VAD element) as a
plain Python object: feed audio chunks (pushed, or pulled from any
`AudioSource`), the ContAD gate segments speech, each segment streams
through the decoder's incremental path, and the caller receives
`on_partial(text, t)` during speech plus `on_result(hypothesis, t0, t1)`
at each segment end — the bus-message analog.  A copy of
`cmusphinx_tpu/pipeline.py` over the port's `Decoder`.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .frontend.source import AudioSource
from .frontend.vad import ContAD


class SpeechPipeline:
    """gstpocketsphinx + vader in one object.

    decoder: a cmusphinx_tpu_torch.api.Decoder (N-gram search for
        streaming).
    on_partial(text, time_s): called at most once per `partial_every`
        seconds while inside a speech segment (partial-result messages).
    on_result(hyp, seg_start_s, seg_end_s): called at each segment end.
    """

    def __init__(self, decoder, on_partial: Optional[Callable] = None,
                 on_result: Optional[Callable] = None,
                 vad_delta: float = 9.0, partial_every: float = 0.25,
                 sample_rate: Optional[float] = None):
        self.dec = decoder
        self.on_partial = on_partial
        self.on_result = on_result
        self.sr = float(sample_rate or decoder.config["samprate"])
        dec_sr = float(decoder.config["samprate"])
        if abs(self.sr - dec_sr) > 1e-6:
            raise ValueError(
                f"source sample rate {self.sr:g} != decoder -samprate {dec_sr:g}; "
                "resample the audio or re-init the decoder with a matching "
                "-samprate (the feature frontend is rate-specific)")
        self.vad = ContAD(sample_rate=self.sr, delta=vad_delta)
        self._partial_every = int(partial_every * self.sr)
        self._since_partial = 0
        self._clock = 0  # absolute samples consumed

    # ------------------------------------------------------------------
    def _emit_segment(self, seg) -> None:
        dec, sr = self.dec, self.sr
        dec.start_utt(streaming=True)
        self._since_partial = 0
        chunk = max(self._partial_every, 1)
        data = seg.data
        for i in range(0, len(data), chunk):
            dec.process_raw(data[i : i + chunk])
            if self.on_partial is not None:
                h = dec.hyp()
                t = (seg.start_sample + min(i + chunk, len(data))) / sr
                self.on_partial(h.text if h else "", t)
        hyp = dec.end_utt()
        if self.on_result is not None:
            self.on_result(hyp, seg.start_sample / sr, seg.end_sample / sr)

    def push(self, samples: np.ndarray) -> None:
        """Feed a chunk of audio (any length); speech segments completed
        by this chunk are decoded and their callbacks fired."""
        samples = np.asarray(samples, np.float32).ravel()
        self._clock += len(samples)
        for seg in self.vad.process(samples):
            self._emit_segment(seg)

    def finish(self) -> None:
        """End of stream: flush the VAD and decode any open segment."""
        for seg in self.vad.end_stream():
            self._emit_segment(seg)

    def run(self, source: AudioSource, chunk_s: float = 0.25) -> None:
        """Pull-drive the pipeline from an AudioSource until exhausted."""
        n = max(int(chunk_s * self.sr), 1)
        while True:
            block = source.read(n)
            if block is None:
                break
            if len(block):
                self.push(block)
        self.finish()
