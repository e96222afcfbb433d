"""HMM transition matrices.

Reader for the s3 `transition_matrices` format (reference:
pocketsphinx/src/libpocketsphinx/tmat.c:191-293 `tmat_init`): s3 header, then
int32 n_tmat, n_src, n_dst (= n_src+1), count, and float32 probabilities
[n_tmat][n_src][n_dst].  Rows are sum-normalized, nonzero-floored, and
re-normalized, then stored as *natural-log* float32 (the reference quantizes
to uint8 in its integer log domain; on TPU we keep float log space — scores
are floats everywhere).

Topology check mirrors tmat_chk_uppertri / tmat_chk_1skip (tmat.c:116-172):
transitions only to j >= i and j <= i+2 (Bakis, at most one skip).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.bio import S3File
from ..utils.logmath import LOG_ZERO


@dataclass
class TransitionMatrices:
    log_tp: np.ndarray  # [n_tmat, n_state, n_state+1] float32 natural log
    n_tmat: int
    n_state: int  # number of emitting states

    @classmethod
    def read(cls, path: str, tpfloor: float = 0.0001) -> "TransitionMatrices":
        with S3File.open(path) as s3:
            n_tmat = int(s3.read_int32(1)[0])
            n_src = int(s3.read_int32(1)[0])
            n_dst = int(s3.read_int32(1)[0])
            n = int(s3.read_int32(1)[0])
            if n_dst != n_src + 1:
                raise ValueError(f"{path}: n_dst {n_dst} != n_src+1")
            if n != n_tmat * n_src * n_dst:
                raise ValueError(f"{path}: count mismatch")
            tp = s3.read_float32(n).reshape(n_tmat, n_src, n_dst).astype(np.float64)
            s3.verify_chksum()

        # Normalize, floor nonzero entries, renormalize (tmat.c:274-280).
        sums = tp.sum(axis=-1, keepdims=True)
        sums[sums == 0] = 1.0
        tp = tp / sums
        nz = tp > 0
        tp = np.where(nz & (tp < tpfloor), tpfloor, tp)
        sums = tp.sum(axis=-1, keepdims=True)
        sums[sums == 0] = 1.0
        tp = tp / sums
        log_tp = np.where(tp > 0, np.log(np.maximum(tp, 1e-37)), LOG_ZERO)
        return cls(log_tp=log_tp.astype(np.float32), n_tmat=n_tmat, n_state=n_src)

    def check_bakis(self) -> bool:
        """True if all matrices are upper-triangular with at most 1 skip."""
        n = self.n_state
        for i in range(n):
            for j in range(n + 1):
                if (j < i or j > i + 2) and np.any(self.log_tp[:, i, j] > LOG_ZERO / 2):
                    return False
        return True
