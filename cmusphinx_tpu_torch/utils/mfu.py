"""FLOP/byte accounting and MFU (model FLOPs utilization) reporting on the
H100 (port of `cmusphinx_tpu/utils/mfu.py`).

The reference never reports hardware utilization (xRT only); every hot
stage gets an analytic FLOP and device-memory byte count here, and a
measured time on the card divides into them.  The counters are functions
of shapes and equal the JAX package's.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
full 700 W power limit; a card set lower runs slower under load, so a
report names the card and its limit beside it):
- tensor cores: 989 TFLOP/s bf16, 495 TFLOP/s TF32;
- float32 outside the tensor cores: 67 TFLOP/s;
- HBM3: 3.35 TB/s.  A stage whose arithmetic intensity (FLOP/byte) is
  below peak_flops/peak_bw (295 in bf16) is bound by memory, and its
  bandwidth utilization is the meaningful number.

MFU is reported against the bf16 peak (the conservative denominator);
beside it, the utilization against the peak of the precision the stage
runs in (`Stage.precision`, a key of `PEAK_FLOPS`): K1's `highest` mode
is three TF32 products (3xTF32), so its adjusted peak is 495/3 TFLOP/s;
`high` is three bf16 products, 989/3.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

H100_PEAK_BF16 = 989e12     # FLOP/s
H100_PEAK_TF32 = 495e12
H100_PEAK_F32 = 67e12       # the CUDA cores, no tensor cores
H100_HBM_BW = 3.35e12       # bytes/s

# The peak of each way a stage's products run.
PEAK_FLOPS = {"bf16": H100_PEAK_BF16, "tf32": H100_PEAK_TF32,
              "f32": H100_PEAK_F32, "3xtf32": H100_PEAK_TF32 / 3,
              "3xbf16": H100_PEAK_BF16 / 3}
# K1's -gmmprec modes (ops/fused_gmm.py) as PEAK_FLOPS keys.
K1_PRECISION = {"highest": "3xtf32", "high": "3xbf16", "bf16": "bf16"}


# ----------------------------------------------------------------------
# Analytic FLOP counts (multiply-add = 2 FLOPs).

def continuous_gmm_flops(T: int, S: int, K: int, D: int) -> float:
    """ContinuousScorer / the K1 kernel: two [T, D] @ [D, S*K] GEMMs
    (linear + quadratic term) + the elementwise square, bias and
    logsumexp reduction (ops/gmm.py ContinuousScorer)."""
    gemm = 2 * 2.0 * T * D * S * K
    elem = T * D + 3.0 * T * S * K   # x*x, add const, exp+max+sum
    return gemm + elem


def continuous_gmm_bytes(T: int, S: int, K: int, D: int,
                         fused: bool) -> float:
    """Device-memory traffic: params + feats + output; an unfused path
    also round-trips the [T, S*K] density matrix through memory."""
    base = 4.0 * (2 * S * K * D + S * K        # lin/quad + const
                  + 2 * T * D                  # feats + feats^2
                  + T * S)                     # output
    if not fused:
        base += 2 * 4.0 * T * S * K
    return base


def psparity_flops(T: int, n_feat: int, n_density: int,
                   veclens, n_sen: int, topn: int) -> float:
    """Semi-continuous 8-bit parity scorer (ops/gmm.py PsParityScorer):
    per stream a [T, D_s] @ [D_s, n_density] density GEMM, the top-N
    argmax selection, and the senone logadd over topn x n_sen 8-bit
    mixture weights (s2_semi_mgau.c:81-530 capability)."""
    f = 0.0
    for d in veclens:
        f += 2.0 * T * int(d) * n_density      # density GEMM
        f += 4.0 * topn * T * n_density        # topn argmax rounds
        f += 3.0 * T * topn * n_sen            # logadd table stage
    return f


def viterbi_scan_bytes(T: int, C: int, S: int, B: int = 1,
                       planes: int = 2, n_rcvar: int = 1) -> float:
    """Device-memory traffic model of the dense Viterbi scan: per frame
    the carry planes (alpha + payload, [B, S, C] each) are read+written,
    the pre-expanded senone block is read, and the propagation gathers
    read the exit rows.  4 bytes/element."""
    per_frame = (planes * 2.0 * B * S * C      # carry r/w
                 + B * S * C                   # senone block read
                 + planes * B * C)             # propagation gather reads
    return 4.0 * T * per_frame


def onehot_scan_flops(T: int, tables_elems: float, B: int = 1) -> float:
    """One-hot gathers in the reference's small-graph scan cores: each
    gathered element costs a dot-product row (ngram_search.py
    _make_core)."""
    return 2.0 * T * B * tables_elems


# ----------------------------------------------------------------------
@dataclass
class Stage:
    name: str
    seconds: float
    flops: float = 0.0
    bytes: float = 0.0
    note: str = ""
    precision: str = "bf16"          # a key of PEAK_FLOPS

    @property
    def mfu(self) -> float:
        return self.flops / max(self.seconds, 1e-12) / H100_PEAK_BF16

    @property
    def adjusted_mfu(self) -> float:
        """Utilization against the peak of the stage's own precision."""
        return (self.flops / max(self.seconds, 1e-12)
                / PEAK_FLOPS[self.precision])

    @property
    def bw_util(self) -> float:
        return self.bytes / max(self.seconds, 1e-12) / H100_HBM_BW


def report(stages: List[Stage]) -> str:
    """Markdown table: stage | ms | GFLOP | MFU (bf16 peak) | precision |
    MFU at its peak | GB | HBM util."""
    out = ["| stage | ms | GFLOP | MFU(bf16 peak) | precision | "
           "MFU(its peak) | GB | HBM util |",
           "|---|---|---|---|---|---|---|---|"]
    for s in stages:
        out.append(
            f"| {s.name} | {s.seconds * 1e3:.3f} | {s.flops / 1e9:.2f} | "
            f"{100 * s.mfu:.2f}% | {s.precision} | "
            f"{100 * s.adjusted_mfu:.1f}% | {s.bytes / 1e9:.3f} | "
            f"{100 * s.bw_util:.1f}% |" + (f" {s.note}" if s.note else ""))
    return "\n".join(out)
