"""The yardstick's peaks and its operation and byte counts, from shapes.

The FLOP counts are frozen copies of the program's counters
(`cmusphinx_tpu_torch/utils/mfu.py`: `continuous_gmm_flops`,
`continuous_gmm_bytes`, `psparity_flops`); `psparity_bytes` is the
yardstick's own.  They depend on shapes alone, never on how a kernel is
written.  Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at
the full 700 W.
"""

from __future__ import annotations

PEAK_BF16 = 989e12      # FLOP/s: the whole step's share of the chip (mfu)
PEAK_TF32 = 495e12      # FLOP/s: the scorer's operations bound
HBM_BW = 3.35e12        # bytes/s


def continuous_gmm_flops(T: int, S: int, K: int, D: int) -> float:
    """Continuous senone scoring of T frames: two [T, D] @ [D, S*K]
    products, the square, the bias and the log-sum-exp."""
    gemm = 2 * 2.0 * T * D * S * K
    elem = T * D + 3.0 * T * S * K
    return gemm + elem


def continuous_gmm_bytes(T: int, S: int, K: int, D: int,
                         fused: bool = True) -> float:
    """Parameters, features and output once (an unfused path also writes
    and reads the [T, S*K] densities)."""
    base = 4.0 * (2 * S * K * D + S * K + 2 * T * D + T * S)
    if not fused:
        base += 2 * 4.0 * T * S * K
    return base


def psparity_flops(T: int, n_feat: int, n_density: int, veclens, n_sen: int,
                   topn: int) -> float:
    """Semi-continuous scoring: per stream the density product, the top-N
    rounds and the senones' log-add over the top N."""
    f = 0.0
    for d in veclens:
        f += 2.0 * T * int(d) * n_density
        f += 4.0 * topn * T * n_density
        f += 3.0 * T * topn * n_sen
    return f


def psparity_bytes(T: int, n_density: int, veclens, n_sen: int) -> float:
    """The 8-bit weights [n_feat, n_density, S], the codebooks (means and
    precisions a dimension, a determinant a density), the features
    [T, D] (float32) and the output [T, S] (float32), each once."""
    D = sum(int(d) for d in veclens)
    weights = 1.0 * len(veclens) * n_density * n_sen
    books = 4.0 * n_density * (2 * D + len(veclens))
    return weights + books + 4.0 * T * D + 4.0 * T * n_sen


def score_flops(shape: dict, T: int) -> float:
    if shape["kind"] == "cont":
        return continuous_gmm_flops(T, shape["S"], shape["K"], shape["D"])
    return psparity_flops(T, len(shape["veclens"]), shape["K"],
                          shape["veclens"], shape["S"], shape["topn"])


def score_bytes(shape: dict, T: int) -> float:
    if shape["kind"] == "cont":
        return continuous_gmm_bytes(T, shape["S"], shape["K"], shape["D"])
    return psparity_bytes(T, shape["K"], shape["veclens"], shape["S"])


def score_least_s(shape: dict, T: int) -> float:
    """The least time a chip could take to score T frames: operations over
    the TF32 dense peak or bytes over the memory rate, the larger."""
    return max(score_flops(shape, T) / PEAK_TF32,
               score_bytes(shape, T) / HBM_BW)
