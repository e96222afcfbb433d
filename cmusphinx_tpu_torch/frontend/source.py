"""Audio sources: the capture seam between audio producers and the decoder.

Capability parity with libsphinxad (reference:
sphinxbase/src/libsphinxad/ad_alsa.c `ad_read` pull contract — a source
returns up to N samples, 0 when momentarily dry, or signals end-of-stream)
without binding to any device API: files, raw byte streams, and pushed
buffers (the GStreamer appsrc-style producer) all present the same
`read()` surface, so `SpeechPipeline` (cmusphinx_tpu_torch.pipeline) and
the continuous CLI are source-agnostic.  A copy of
`cmusphinx_tpu/frontend/source.py`.

Samples are float32 mono at the source's declared rate; int16 input is
converted (the reference's ad_read int16 contract).
"""

from __future__ import annotations

import collections
import threading
import wave
from typing import Optional

import numpy as np


class AudioSource:
    """Pull interface: `read(n)` returns up to n samples as float32
    (possibly 0-length when momentarily dry), or None at end of stream."""

    sample_rate: float = 16000.0

    def read(self, n: int) -> Optional[np.ndarray]:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __iter__(self):
        while True:
            block = self.read(4096)
            if block is None:
                return
            if len(block):
                yield block


def _to_f32(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    if x.dtype == np.int16:
        return x.astype(np.float32)
    return x.astype(np.float32, copy=False).ravel()


class RawFileSource(AudioSource):
    """Headerless 16-bit PCM file (the reference's -infile / adrec data)."""

    def __init__(self, path: str, sample_rate: float = 16000.0):
        self.sample_rate = float(sample_rate)
        self._data = np.frombuffer(open(path, "rb").read(), np.int16)
        self._pos = 0

    def read(self, n: int) -> Optional[np.ndarray]:
        if self._pos >= len(self._data):
            return None
        block = self._data[self._pos : self._pos + n]
        self._pos += len(block)
        return _to_f32(block)


class WavFileSource(AudioSource):
    """RIFF WAV file (16-bit PCM, mono or first channel)."""

    def __init__(self, path: str):
        self._wf = wave.open(path, "rb")
        if self._wf.getsampwidth() != 2:
            raise ValueError("only 16-bit PCM WAV is supported")
        self.sample_rate = float(self._wf.getframerate())
        self._channels = self._wf.getnchannels()
        self._done = False

    def read(self, n: int) -> Optional[np.ndarray]:
        if self._done:
            return None
        raw = self._wf.readframes(n)
        if not raw:
            self._done = True
            return None
        x = np.frombuffer(raw, np.int16)
        if self._channels > 1:
            x = x[:: self._channels]
        return _to_f32(x)

    def close(self) -> None:
        self._wf.close()


class BufferSource(AudioSource):
    """Push-style source (GStreamer appsrc / JS-callback analog): a
    producer thread calls `push(samples)`; `end()` marks end-of-stream.
    `read` never blocks — it returns an empty block while the queue is
    dry, matching the non-blocking ad_read contract."""

    def __init__(self, sample_rate: float = 16000.0):
        self.sample_rate = float(sample_rate)
        self._q: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._eos = False

    def push(self, samples: np.ndarray) -> None:
        with self._lock:
            if self._eos:
                raise RuntimeError("push after end()")
            self._q.append(_to_f32(samples))

    def end(self) -> None:
        with self._lock:
            self._eos = True

    def read(self, n: int) -> Optional[np.ndarray]:
        with self._lock:
            if not self._q:
                return None if self._eos else np.zeros(0, np.float32)
            out = []
            got = 0
            while self._q and got < n:
                blk = self._q.popleft()
                if got + len(blk) > n:
                    self._q.appendleft(blk[n - got :])
                    blk = blk[: n - got]
                out.append(blk)
                got += len(blk)
        return np.concatenate(out) if len(out) > 1 else out[0]
