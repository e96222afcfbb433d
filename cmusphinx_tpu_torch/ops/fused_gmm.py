"""Fused continuous-GMM senone scoring: the Hopper kernel K1 and its plain
PyTorch version.

    score[t, s] = logsumexp_k( const[s,k] + x_t . lin[s,k] - x_t^2 . quad[s,k] )

`fused_mixture_scores` is the wrapper: for CUDA tensors it launches the
hand-written kernel in `csrc/fused_gmm.cu` (the port of
`cmusphinx_tpu/ops/pallas_gmm.py::_kernel`), for CPU tensors it runs the
plain version `fused_mixture_scores_ref`.  It never falls back from one to
the other.  `fused_mixture_scores.launches` counts the kernel's launches.

Parameters stay senone-major — lin/quad `[S, K, D]`, const `[S, K]`; the
reference's mixture-major block packing was a Mosaic shape-cast workaround.

The kernel is compiled with nvcc for sm_90a at first use into `build/` at
the repository root (git-ignored), named by a hash of its source, and
loaded with ctypes.  Nothing is compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

PRECISIONS = ("highest", "high", "bf16")
_MODE = {"highest": 0, "high": 1, "bf16": 2}

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_gmm.cu"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# Frames per chunk of the plain version are chosen so one chunk's [rows,
# S*K] density matrix stays near this many bytes.  Chunking bounds memory
# and changes no number: every frame is computed independently.
_REF_CHUNK_BYTES = 512 << 20

_lib = None


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def library_path() -> pathlib.Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libfused_gmm-{digest}.so"


def build() -> float:
    """Compile the kernel (if this source was not built yet) and load it.
    Returns the seconds spent compiling (0.0 when the library existed).
    The compiler's report (ptxas registers, spills) goes to `<library>.log`."""
    global _lib
    so = library_path()
    spent = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            r = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                               check=True, capture_output=True, text=True)
            so.with_suffix(".log").write_text(r.stdout + r.stderr)
            os.replace(tmp, so)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"nvcc failed to build {SOURCE.name}:\n"
                               f"{e.stdout}\n{e.stderr}") from e
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        spent = time.perf_counter() - t0
    if _lib is None:
        lib = ctypes.CDLL(str(so))
        lib.fused_gmm_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
            + [ctypes.c_void_p])
        lib.fused_gmm_launch.restype = ctypes.c_int
        _lib = lib
    return spent


# ----------------------------------------------------------------------
def _bf16_parts(a: torch.Tensor):
    """Split f32 `a` into bf16 hi + lo (round to nearest even), as f32."""
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


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


def _check(x, lin, quad, const, precision):
    if precision not in _MODE:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    if x.dim() != 2 or lin.dim() != 3 or quad.shape != lin.shape:
        raise ValueError("expected x [T, D], lin/quad [S, K, D]; got "
                         f"{tuple(x.shape)}, {tuple(lin.shape)}, "
                         f"{tuple(quad.shape)}")
    S, K, D = lin.shape
    if x.shape[1] != D or tuple(const.shape) != (S, K):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, lin "
                         f"{tuple(lin.shape)}, const {tuple(const.shape)}")
    ptype = torch.bfloat16 if precision == "bf16" else torch.float32
    if x.dtype != torch.float32 or const.dtype != torch.float32:
        raise TypeError("x and const must be float32")
    if lin.dtype != ptype or quad.dtype != ptype:
        raise TypeError(f"precision {precision!r} takes {ptype} lin/quad, "
                        f"got {lin.dtype}/{quad.dtype}")
    devs = {t.device for t in (x, lin, quad, const)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")


def fused_mixture_scores(x: torch.Tensor, lin: torch.Tensor,
                         quad: torch.Tensor, const: torch.Tensor,
                         precision: str = "highest") -> torch.Tensor:
    """x [T, D] f32; lin/quad [S, K, D] (f32, or bf16 in bf16 mode);
    const [S, K] f32 -> [T, S] f32 log mixture scores.

    CUDA tensors launch the K1 kernel; CPU tensors take the plain version."""
    _check(x, lin, quad, const, precision)
    if x.device.type == "cpu":
        return fused_mixture_scores_ref(x, lin, quad, const, precision)
    if x.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {x.device}")
    for name, t in (("x", x), ("lin", lin), ("quad", quad), ("const", const)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    S, K, D = lin.shape
    T = x.shape[0]
    out = torch.empty((T, S), dtype=torch.float32, device=x.device)
    if T == 0:
        return out
    if max(T * max(D, S), S * K * D) >= 2 ** 31:
        raise ValueError("K1 takes tensors of fewer than 2^31 elements")
    build()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib.fused_gmm_launch(
            _MODE[precision], x.data_ptr(), lin.data_ptr(), quad.data_ptr(),
            const.data_ptr(), out.data_ptr(), T, S, K, D, stream)
    if err != 0:
        raise RuntimeError(f"K1 fused_gmm launch failed: CUDA error {err}")
    fused_mixture_scores.launches += 1
    return out


fused_mixture_scores.launches = 0
