"""The yardstick's peaks, and its operation and byte counts from shapes.

The counts are each kind's (`kinds/<model>.py`: `score_flops`,
`score_bytes`, found by the shape's "kind"); they depend on shapes alone,
never on how a kernel is written.  Peaks: one NVIDIA H100 SXM, NVIDIA's
data sheet, dense rates at the full 700 W.
"""

from __future__ import annotations

from . import kinds

PEAK_BF16 = 989e12      # FLOP/s: the whole step's share of the chip (mfu)
PEAK_TF32 = 495e12      # FLOP/s: the scorer's operations bound
HBM_BW = 3.35e12        # bytes/s


def score_flops(shape: dict, T: int) -> float:
    """Operations of scoring T frames, by the shape's kind."""
    return kinds.load(shape["kind"]).score_flops(shape, T)


def score_bytes(shape: dict, T: int) -> float:
    """Bytes of scoring T frames, by the shape's kind."""
    return kinds.load(shape["kind"]).score_bytes(shape, T)


def score_least_s(shape: dict, T: int) -> float:
    """The least time a chip could take to score T frames: operations over
    the TF32 dense peak or bytes over the memory rate, the larger."""
    return max(score_flops(shape, T) / PEAK_TF32,
               score_bytes(shape, T) / HBM_BW)
