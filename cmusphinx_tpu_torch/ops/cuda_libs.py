"""The build of the port's hand-written CUDA libraries.

`LIBRARIES` names each library with its source under `csrc/` and its
units (nvcc flags a compilation unit).  `build_all` compiles with nvcc for
sm_90a, at first use, every library not built yet: the units of all of
them at once, each library then linked into `build/kernels` at the
repository root (git-ignored), named by a hash of its source, its flags
and its units.  The kernels' modules (`fused_gmm`, `tree_step`,
`ptm_parity`, `mpx_step`, `lm_entries`) load their library with ctypes
after it, and check their arguments with the `expect*` functions here.  Nothing is
compiled when this module is imported.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# name -> (source, units).  K1 (`fused_gmm`): one unit a precision mode
# (`fused_gmm.PRECISIONS`, its kernels) and one of the C entry points.
LIBRARIES = {
    "fused_gmm": (_PKG / "csrc" / "fused_gmm.cu",
                  [["-DK1_MODE=0"], ["-DK1_MODE=1"], ["-DK1_MODE=2"], []]),
    "tree_step": (_PKG / "csrc" / "tree_step.cu", [[]]),
    "ptm_parity": (_PKG / "csrc" / "ptm_parity.cu", [[]]),
    "mpx_step": (_PKG / "csrc" / "mpx_step.cu", [[]]),
    "lm_entries": (_PKG / "csrc" / "lm_entries.cu", [[]]),
}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def library_path(name: str) -> pathlib.Path:
    source, units = LIBRARIES[name]
    digest = hashlib.sha1(source.read_bytes() + " ".join(NVCC_FLAGS).encode()
                          + repr(units).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile(jobs, workdir: str) -> tuple:
    """Compile the (source, unit flags) jobs into objects in `workdir`, all
    nvcc processes at once: (object paths, the compiler's report a job)."""
    objs = [os.path.join(workdir, f"unit{i}.o") for i in range(len(jobs))]
    procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, *u, "-c", "-o", o,
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for (src, u), o in zip(jobs, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [(src.name, u, log) for (src, u), p, log in zip(jobs, procs, logs)
              if p.returncode]
    if failed:
        raise RuntimeError("nvcc failed: " + "".join(
            f"{name} {u}:\n{log}\n" for name, u, log in failed))
    return objs, logs


def build_all() -> float:
    """Compile every library of `LIBRARIES` that is not built yet, the
    units of all of them in one parallel step, and link each.  Returns the
    seconds spent (0.0 when all existed).  Each library's compiler report
    (ptxas registers, spills) goes to `<library>.log`."""
    missing = [n for n in LIBRARIES if not library_path(n).exists()]
    if not missing:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        jobs = [(LIBRARIES[n][0], u, n) for n in missing
                for u in LIBRARIES[n][1]]
        objs, logs = _compile([j[:2] for j in jobs], work)
        for name in missing:
            so = library_path(name)
            mine = [i for i, j in enumerate(jobs) if j[2] == name]
            tmp = os.path.join(work, so.name)
            r = subprocess.run([nvcc(), "-shared", "-o", tmp,
                                *(objs[i] for i in mine)],
                               capture_output=True, text=True)
            if r.returncode:
                raise RuntimeError(f"nvcc failed to link {so.name}:\n"
                                   f"{r.stdout}\n{r.stderr}")
            so.with_suffix(".log").write_text(
                "".join(logs[i] for i in mine) + r.stdout + r.stderr)
            os.replace(tmp, so)
    return time.perf_counter() - t0


# ---- the wrappers' argument checks ---------------------------------------
def expect(t: torch.Tensor, name: str, shape, dtype) -> None:
    """TypeError unless `t` has `dtype`, ValueError unless `shape`."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def expect_rows(rows: torch.Tensor, B: int, S: int) -> None:
    """A frame's senone-sequence rows: [B, n_xs, S] float32."""
    if rows.dim() != 3 or rows.shape[0] != B or rows.shape[2] != S:
        raise ValueError(f"rows must be [{B}, n_xs, {S}], got "
                         f"{tuple(rows.shape)}")
    expect(rows, "rows", rows.shape, torch.float32)


def expect_lookahead(la_t, B: int) -> None:
    """The phone-loop lookahead: None, or [B, n_ci] f32, rows contiguous."""
    if la_t is None:
        return
    if la_t.dim() != 2 or la_t.shape[0] != B:
        raise ValueError(f"la_t must be [{B}, n_ci], got "
                         f"{tuple(la_t.shape)}")
    expect(la_t, "la_t", la_t.shape, torch.float32)
    if la_t.stride(1) != 1:
        raise ValueError("la_t's rows must be contiguous")


def expect_bands(bands, C: int, S: int) -> dict:
    """`hmm_bands`' five float32 arrays of C channels, by name."""
    named = dict(zip(("d0", "d1", "d2", "e_last", "e_prev"), bands))
    for (name, b), shape in zip(named.items(), (
            (C, S), (C, max(S - 1, 0)), (C, max(S - 2, 0)), (C,), (C,))):
        expect(b, name, shape, torch.float32)
    return named


def expect_states(S: int, most: int) -> None:
    if not 1 <= S <= most:
        raise ValueError(f"the kernels take 1 to {most} states, got {S}")


def contiguous(tensors: dict) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def one_device(tensors, kernel: str) -> torch.device:
    """The one device, the CPU or a card, of the tensors (None aside)."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no {kernel} kernel for device {dev}")
    return dev
