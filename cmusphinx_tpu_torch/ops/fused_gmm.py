"""Fused continuous-GMM senone scoring: the Hopper kernel K1 and its plain
PyTorch version.

    score[t, s] = logsumexp_k( const[s,k] + x_t . lin[s,k] - x_t^2 . quad[s,k] )

`fused_mixture_scores` is the wrapper: for CUDA tensors it launches the
hand-written kernel in `csrc/fused_gmm.cu` (the port of
`cmusphinx_tpu/ops/pallas_gmm.py::_kernel`), for CPU tensors it runs the
plain version `fused_mixture_scores_ref`.  It never falls back from one to
the other.  `fused_mixture_scores.launches` counts the kernel's launches.

The plain version takes the parameters senone-major — lin/quad `[S, K, D]`,
const `[S, K]`.  The kernel reads only their packed form, `pack_params`
(made once by the scorer): one tensor-core operand B = [lin | -quad] per
density, in senone tiles laid out as the kernel's shared memory holds them,
each operand split into the parts its precision mode multiplies (tf32 or
bf16 hi and lo), K padded to a power of two with pad densities of const
-1e30, S padded to whole tiles (see the note in the CUDA source).  The
kernel takes any D: up to D = 64 one instantiation a depth reads each tile
whole; past it, a depth loop reads each tile in chunks of `CHUNK_DP`
depth elements, and `pack_params` lays the tiles out chunk by chunk.  Both
read x [T, D] and stage A = [x | x^2] themselves; `plan` reports the depth
loop's geometry.

The kernel is compiled with nvcc for sm_90a at first use into `build/` at
the repository root (git-ignored), named by a hash of its source, and
loaded with ctypes (`cuda_libs`, with the port's other hand-written
library in the same parallel step).  Nothing is compiled when this module
is imported.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import cuda_libs

PRECISIONS = ("highest", "high", "bf16")
_MODE = {"highest": 0, "high": 1, "bf16": 2}
# Densities per senone tile of the kernel, in each mode (Cfg<MODE>::N).
TILE_N = {"highest": 64, "high": 128, "bf16": 128}
# Const of the pad densities: exp() of it is 0 (pallas_gmm._PAD_CONST).
PAD_CONST = -1e30
# Depths up to NARROW_DP (D <= 64) have one instantiation each and read a
# tile whole; past it the kernel loops over chunks of CHUNK_DP elements.
NARROW_DP = 128
CHUNK_DP = 32

LIBRARY = "fused_gmm"

# Frames per chunk of the plain version are chosen so one chunk's [rows,
# S*K] density matrix stays near this many bytes.  Chunking bounds memory
# and changes no number: every frame is computed independently.
_REF_CHUNK_BYTES = 512 << 20

_lib = None


def build() -> float:
    """Compile the kernel, with the port's other libraries (if any of them
    was not built yet), and load it.  Returns the seconds spent compiling
    (0.0 when every library existed)."""
    global _lib
    spent = cuda_libs.build_all()
    if _lib is None:
        lib = ctypes.CDLL(str(cuda_libs.library_path(LIBRARY)))
        lib.fused_gmm_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
            + [ctypes.c_void_p])
        lib.fused_gmm_launch.restype = ctypes.c_int
        lib.fused_gmm_plan.argtypes = [ctypes.c_int] * 2 + [
            ctypes.POINTER(ctypes.c_int)] * 2
        lib.fused_gmm_plan.restype = ctypes.c_int
        _lib = lib
    return spent


# ----------------------------------------------------------------------
def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """f32 `a` rounded to tf32 (10 mantissa bits, round to nearest even),
    as f32: the kernel's `tf32_rn`."""
    b = a.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
    return torch.where(b >= 2 ** 31, b - 2 ** 32, b).to(torch.int32).view(
        torch.float32)


def split_parts(a: torch.Tensor, precision: str):
    """The tensor-core operands of f32 `a` in one precision mode, in the
    operand type: tf32 hi and lo (f32 containers) for "highest", bf16 hi
    and lo for "high", bf16 for "bf16".  hi + lo reconstructs `a` within
    2^-22 (tf32) or 2^-16 (bf16) of |a|."""
    a = a.float()
    if precision == "highest":
        hi = tf32_round(a)
        return [hi, tf32_round(a - hi)]
    hi = a.to(torch.bfloat16)
    if precision == "high":
        return [hi, (a - hi.float()).to(torch.bfloat16)]
    return [hi]


@dataclass(frozen=True)
class Packed:
    """K1's parameters for one precision mode: `tiles` [n_tiles,
    tile_bytes] uint8, each tile N densities (`n_tile`) of B = [lin |
    -quad] over depth `dp`, every part in the wgmma core-matrix layout
    (past `NARROW_DP`, chunk by chunk: [dp / CHUNK_DP][parts][N x
    CHUNK_DP]); `const` [n_tiles * N] f32, their consts; `kp` densities a
    senone (a power of two >= 8)."""
    tiles: torch.Tensor
    const: torch.Tensor
    precision: str
    S: int
    K: int
    D: int
    kp: int
    dp: int
    n_tile: int


def _core_layout(b: torch.Tensor, n: int) -> torch.Tensor:
    """Rows [R, Dp] of one operand part -> bytes [R/n, n*Dp*itemsize] in
    the no-swizzle K-major layout: per tile [n/8][Dp/epc] core matrices of
    8 rows x 16 bytes (epc = 16 / itemsize elements a core row)."""
    R, dp = b.shape
    epc = 16 // b.element_size()
    t = b.reshape(R // n, n // 8, 8, dp // epc, epc).permute(0, 1, 3, 2, 4)
    return t.contiguous().view(torch.uint8).reshape(R // n, -1)


def _chunk_layout(parts, n: int) -> torch.Tensor:
    """Rows [R, Dp] of every operand part -> bytes [R/n, Dp/CHUNK_DP *
    parts * n * CHUNK_DP * itemsize]: per block of n rows, chunk by chunk,
    each chunk's parts in turn, each part [n/8][CHUNK_DP/epc] core
    matrices (the depth loop's byte image of a stage)."""
    R, dp = parts[0].shape
    epc = 16 // parts[0].element_size()
    t = torch.stack([p.reshape(R // n, n // 8, 8, dp // CHUNK_DP,
                               CHUNK_DP // epc, epc).permute(0, 3, 1, 4, 2, 5)
                     for p in parts], 2)
    return t.contiguous().view(torch.uint8).reshape(R // n, -1)


def depth(D: int) -> int:
    """K1's depth for D features: 2D rounded up to 16, or past
    NARROW_DP to whole chunks."""
    dp = -(-2 * D // 16) * 16
    return dp if dp <= NARROW_DP else -(-2 * D // CHUNK_DP) * CHUNK_DP


def pack_params(lin: torch.Tensor, quad: torch.Tensor, const: torch.Tensor,
                precision: str = "highest") -> Packed:
    """lin/quad [S, K, D] (f32, or bf16 in bf16 mode), const [S, K] f32 ->
    K1's packed senone tiles, on the parameters' device."""
    _check_params(lin, quad, const, precision)
    S, K, D = lin.shape
    kp = max(8, 1 << (K - 1).bit_length())
    dp = depth(D)
    n = TILE_N[precision]
    rows = -(-S * kp // n) * n
    b = lin.new_zeros((rows, dp), dtype=torch.float32)
    bv = b[: S * kp].view(S, kp, dp)
    bv[:, :K, :D] = lin.float()
    bv[:, :K, D: 2 * D] = -quad.float()
    c = const.new_full((rows,), PAD_CONST, dtype=torch.float32)
    c[: S * kp].view(S, kp)[:, :K] = const
    parts = split_parts(b, precision)
    tiles = (torch.cat([_core_layout(p, n) for p in parts], 1).contiguous()
             if dp <= NARROW_DP else _chunk_layout(parts, n))
    return Packed(tiles, c, precision, S, K, D, kp, dp, n)


def plan(precision: str, dp: int) -> tuple:
    """The depth loop's geometry at depth dp > NARROW_DP, as the CUDA side
    chooses it at launch (fused_gmm_plan): (frames a block, A staged chunk
    by chunk rather than resident)."""
    if _lib is None:
        build()
    wg, streamed = ctypes.c_int(0), ctypes.c_int(0)
    err = _lib.fused_gmm_plan(_MODE[precision], dp, ctypes.byref(wg),
                              ctypes.byref(streamed))
    if err != 0:
        raise RuntimeError(f"K1 has no geometry for depth {dp}: CUDA error "
                           f"{err}")
    return 64 * wg.value, bool(streamed.value)


# ----------------------------------------------------------------------
def _bf16_parts(a: torch.Tensor):
    """Split f32 `a` into bf16 hi + lo (round to nearest even), as f32."""
    return [p.float() for p in split_parts(a, "high")]


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [T, D] . b [N, D]^T as ah.bh + ah.bl + al.bh: every product of two
    bf16 values is exact in f32; the sums are f32."""
    ah, al = _bf16_parts(a)
    bh, bl = _bf16_parts(b)
    return (ah @ bh.T + ah @ bl.T) + al @ bh.T


def _densities(x, lin2, quad2, const1, precision):
    """x [T, D] -> [T, S*K] log densities for one precision mode."""
    if precision == "bf16":
        xb = x.to(torch.bfloat16).float()
        x2b = (x * x).to(torch.bfloat16).float()
        return const1 + xb @ lin2.float().T - x2b @ quad2.float().T
    if precision == "high":
        return const1 + _dot3(x, lin2) - _dot3(x * x, quad2)
    return const1 + x @ lin2.T - (x * x) @ quad2.T


def mask_topn(d: torch.Tensor, topn: int) -> torch.Tensor:
    """Keep every value >= the topn-th largest of its last axis (so ties
    past N survive, reference `_mask_topn`), masking the rest to -inf."""
    if topn <= 0 or topn >= d.shape[-1]:
        return d
    thresh = d.topk(topn, dim=-1).values[..., -1:]
    return torch.where(d >= thresh, d, float("-inf"))


def fused_mixture_scores_ref(x: torch.Tensor, lin: torch.Tensor,
                             quad: torch.Tensor, const: torch.Tensor,
                             precision: str = "highest",
                             topn: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel: `const + x@lin - (x*x)@quad`,
    reshaped to [T, S, K], then `torch.logsumexp` over K.  In bf16 mode the
    bf16 operands are upcast to f32 before the product (a bf16 x bf16
    product is exact in f32).  Frames are taken in chunks to bound the
    [T, S*K] density matrix's memory.  `topn > 0` keeps each senone's top-N
    densities (`mask_topn`) before the log-sum-exp; the kernel has no such
    option."""
    if precision not in _MODE:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    S, K, D = lin.shape
    T = x.shape[0]
    lin2, quad2 = lin.reshape(S * K, D), quad.reshape(S * K, D)
    const1 = const.reshape(1, S * K)
    out = torch.empty((T, S), dtype=torch.float32, device=x.device)
    rows = max(1, _REF_CHUNK_BYTES // (S * K * 4))
    for lo in range(0, T, rows):
        ll = _densities(x[lo: lo + rows], lin2, quad2, const1, precision)
        out[lo: lo + rows] = torch.logsumexp(mask_topn(ll.view(-1, S, K), topn),
                                             dim=-1)
    return out


def _check_params(lin, quad, const, precision):
    if precision not in _MODE:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    if lin.dim() != 3 or quad.shape != lin.shape:
        raise ValueError("expected lin/quad [S, K, D]; got "
                         f"{tuple(lin.shape)}, {tuple(quad.shape)}")
    if tuple(const.shape) != tuple(lin.shape[:2]):
        raise ValueError(f"shape mismatch: lin {tuple(lin.shape)}, const "
                         f"{tuple(const.shape)}")
    ptype = torch.bfloat16 if precision == "bf16" else torch.float32
    if const.dtype != torch.float32:
        raise TypeError("const must be float32")
    if lin.dtype != ptype or quad.dtype != ptype:
        raise TypeError(f"precision {precision!r} takes {ptype} lin/quad, "
                        f"got {lin.dtype}/{quad.dtype}")


def _check_x(x, D):
    if x.dim() != 2 or x.shape[1] != D:
        raise ValueError(f"expected x [T, {D}], got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError("x must be float32")


def fused_mixture_scores(x: torch.Tensor, lin: torch.Tensor,
                         quad: torch.Tensor, const: torch.Tensor,
                         precision: str = "highest",
                         packed: Packed | None = None) -> torch.Tensor:
    """x [T, D] f32 -> [T, S] f32 log mixture scores.

    CPU tensors take the plain version on lin/quad [S, K, D] (f32, or bf16
    in bf16 mode) and const [S, K] f32.  CUDA tensors launch the K1 kernel
    on `packed`, which they require (`pack_params` of those parameters in
    this mode): the kernel reads nothing else of the model."""
    if x.device.type == "cpu":
        _check_params(lin, quad, const, precision)
        _check_x(x, lin.shape[2])
        devs = {t.device for t in (x, lin, quad, const)}
        if len(devs) != 1:
            raise ValueError(f"tensors on different devices: {devs}")
        return fused_mixture_scores_ref(x, lin, quad, const, precision)
    if x.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {x.device}")
    if packed is None:
        raise ValueError("K1 runs on packed parameters: pass "
                         "packed=pack_params(lin, quad, const, precision)")
    _check_x(x, packed.D)
    if packed.precision != precision or packed.tiles.device != x.device:
        raise ValueError(f"parameters packed for {packed.precision!r} on "
                         f"{packed.tiles.device}, not {precision!r} on "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    T, S, D = x.shape[0], packed.S, packed.D
    out = torch.empty((T, S), dtype=torch.float32, device=x.device)
    if T == 0:
        return out
    if max(T * max(D, S), packed.tiles.numel()) >= 2 ** 31:
        raise ValueError("K1 takes tensors of fewer than 2^31 elements")
    if _lib is None:
        build()
    n_tiles, tile_bytes = packed.tiles.shape
    kp_log = packed.kp.bit_length() - 1
    with torch.cuda.device(x.device):
        err = _lib.fused_gmm_launch(
            _MODE[precision], x.data_ptr(), packed.tiles.data_ptr(),
            packed.const.data_ptr(), out.data_ptr(), T, S, D, packed.dp,
            kp_log, packed.n_tile, n_tiles, tile_bytes,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K1 fused_gmm launch failed: CUDA error {err}")
    fused_mixture_scores.launches += 1
    return out


fused_mixture_scores.launches = 0
