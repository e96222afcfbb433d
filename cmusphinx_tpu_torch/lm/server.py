"""Network language-model access (sphinx4 NetworkLanguageModel capability).

Wire protocol parity with sphinx4
linguist/language/ngram/NetworkLanguageModel.java:104-170: the server
greets `probserver ready`; each request is one line of space-separated
words; the reply is the log10 probability of the LAST word given the
preceding ones (backoff n-gram), or `-inf` for an unknown word.  The
client keeps an LRU cache like the reference's.

The HBM-resident hashed backend (models/ngram_device.py) is the
in-process home for production LMs; this module exists for ecosystem
parity — decoders on other hosts (or the reference's own sphinx4
configured with a NetworkLanguageModel) can score against a model served
from this framework.
"""

from __future__ import annotations

import math
import socket
import socketserver
import threading
from collections import OrderedDict
from typing import List, Optional, Sequence

_LN10 = math.log(10.0)


class LmServer:
    """Serve an NgramModel over the sphinx4 probserver line protocol."""

    def __init__(self, lm, host: str = "127.0.0.1", port: int = 0):
        self.lm = lm
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                self.wfile.write(b"probserver ready\n")
                for raw in self.rfile:
                    words = raw.decode("utf-8", "replace").split()
                    if not words:
                        self.wfile.write(b"0\n")
                        continue
                    s = outer.score_log10(words)
                    self.wfile.write(
                        (b"-inf\n" if s is None
                         else f"{s:.6f}\n".encode()))

        self.server = socketserver.ThreadingTCPServer((host, port), Handler)
        self.server.daemon_threads = True
        self.host, self.port = self.server.server_address
        self._thread: Optional[threading.Thread] = None

    def score_log10(self, words: Sequence[str]) -> Optional[float]:
        """log10 P(words[-1] | words[:-1]) with backoff; None = unknown."""
        lm = self.lm
        ids = [lm.word_id(w) for w in words]
        if ids[-1] < 0:
            return None
        w3 = ids[-1]
        w2 = ids[-2] if len(ids) >= 2 and ids[-2] >= 0 else -1
        w1 = ids[-3] if len(ids) >= 3 and ids[-3] >= 0 and w2 >= 0 else -1
        return float(lm.tg_score(w1, w2, w3)) / _LN10

    def start(self) -> None:
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()


class NetworkLm:
    """Client: score word sequences against a probserver (the reference's
    NetworkLanguageModel with its LRUCache)."""

    LOG_ZERO = -1e10

    def __init__(self, host: str = "localhost", port: int = 2525,
                 cache_size: int = 10000, timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self._rd = self.sock.makefile("rb")
        self._wr = self.sock.makefile("wb")
        greeting = self._rd.readline().decode().strip()
        if greeting != "probserver ready":
            raise IOError(f"unexpected greeting {greeting!r}")
        self._cache: OrderedDict = OrderedDict()
        self._cache_size = cache_size

    def log10_prob(self, words: Sequence[str]) -> float:
        """log10 P(words[-1] | words[:-1]); LOG_ZERO for unknown words."""
        key = tuple(words)
        if key in self._cache:
            self._cache.move_to_end(key)
            return self._cache[key]
        self._wr.write((" ".join(words) + "\n").encode())
        self._wr.flush()
        result = self._rd.readline().decode().strip().lstrip("\x00")
        p = self.LOG_ZERO if result == "-inf" else float(result)
        self._cache[key] = p
        if len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)
        return p

    def ln_prob(self, words: Sequence[str]) -> float:
        return self.log10_prob(words) * _LN10

    def close(self) -> None:
        self.sock.close()
