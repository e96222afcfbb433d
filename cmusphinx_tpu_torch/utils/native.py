"""ctypes bindings for the native host runtime (`csrc/sphinx_runtime.cc`).

A copy of `cmusphinx_tpu/utils/native.py` over the port's own copy of the
C++ source.  The library is compiled with g++ at first use into `build/`
at the repository root (git-ignored), named by a hash of its source, and
loaded with ctypes; nothing is compiled when this module is imported.
Where no compiler is found the callers use their pure-Python paths, as the
reference's do (`loaded()` says which ran).

Native components (reference parity):
- lm3g trigram scoring core      (sphinxbase lm/lm3g_templates.c:46-260)
- lattice bestpath / posterior / A* N-best
                                 (pocketsphinx ps_lattice.c:1224,1394,1657)
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "sphinx_runtime.cc"
BUILD_DIR = _PKG.parent / "build" / "native"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_tried = False

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

_LM_ARGS = [_f32p, _f32p, _i64p, _i32p, _f32p, _f32p, _i64p, _i32p, _f32p,
            ct.c_int32, ct.c_int32]
_LAT_ARGS = [ct.c_int32, ct.c_int32, ct.c_int32,
             _i32p, _i32p, _i32p, _i32p, _u8p, _u8p, _f32p,
             _f32p, _f32p, _f32p, _i64p, _i32p] + _LM_ARGS


def library_path() -> pathlib.Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libsphinx_runtime-{digest}.so"


def _build(so: pathlib.Path) -> bool:
    """Compile the source into `so` (through a temporary file, so that
    concurrent processes never load a half-written library)."""
    if so.exists():
        return True
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib():
    """The loaded native library, or None when it cannot be built."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not _build(so):
            return None
        lib = ct.CDLL(str(so))
        lib.lm3g_tg_score.restype = ct.c_float
        lib.lm3g_tg_score.argtypes = _LM_ARGS + [ct.c_int32] * 3
        lib.lm3g_tg_score_batch.restype = None
        lib.lm3g_tg_score_batch.argtypes = _LM_ARGS + [
            _i32p, _i32p, _i32p, ct.c_int64, _f32p]
        lib.lattice_bestpath.restype = ct.c_int32
        lib.lattice_bestpath.argtypes = _LAT_ARGS + [
            ct.c_float, ct.c_float, ct.c_int32, ct.c_int32, ct.c_float,
            _i32p, ct.c_int32, ct.POINTER(ct.c_float)]
        lib.lattice_posterior.restype = None
        lib.lattice_posterior.argtypes = _LAT_ARGS + [
            ct.c_float, ct.c_float, ct.c_int32, ct.c_float, _f64p]
        lib.lattice_nbest.restype = ct.c_int32
        lib.lattice_nbest.argtypes = _LAT_ARGS + [
            ct.c_float, ct.c_float, ct.c_int32, ct.c_int32,
            ct.c_int32, ct.c_int32, _i32p, ct.c_int64, _i32p, _f32p]
        _lib = lib
        return _lib


def loaded() -> bool:
    """Whether the native library is built and loaded (building it now if
    it was not tried yet)."""
    return get_lib() is not None


class LmArrays:
    """Contiguity-normalized CSR views of an NgramModel for the C core."""

    def __init__(self, lm):
        c = np.ascontiguousarray
        self.ug_prob = c(lm.ug_prob, np.float32)
        self.ug_bo = c(lm.ug_bo, np.float32)
        self.bg_ptr = c(lm.bg_ptr, np.int64)
        self.bg_wid = c(lm.bg_wid, np.int32)
        self.bg_prob = c(lm.bg_prob, np.float32)
        self.bg_bo = c(lm.bg_bo if len(lm.bg_bo) else np.zeros(
            len(lm.bg_wid), np.float32), np.float32)
        self.tg_ptr = c(lm.tg_ptr if len(lm.tg_ptr) > 1 else np.zeros(
            len(lm.bg_wid) + 1, np.int64), np.int64)
        self.tg_wid = c(lm.tg_wid, np.int32)
        self.tg_prob = c(lm.tg_prob, np.float32)
        self.V = np.int32(len(self.ug_prob))
        self.order = np.int32(getattr(lm, "n", 3))

    def args(self):
        return (self.ug_prob, self.ug_bo, self.bg_ptr, self.bg_wid,
                self.bg_prob, self.bg_bo, self.tg_ptr, self.tg_wid,
                self.tg_prob, self.V, self.order)


def tg_score_batch(lm_arrays: LmArrays, w1, w2, w3):
    """Trigram scores of (w1, w2, w3) triples, or None (the caller's
    Python path) when no native library is available."""
    lib = get_lib()
    if lib is None:
        return None
    w1 = np.ascontiguousarray(w1, np.int32)
    w2 = np.ascontiguousarray(w2, np.int32)
    w3 = np.ascontiguousarray(w3, np.int32)
    out = np.empty(w1.shape[0], np.float32)
    lib.lm3g_tg_score_batch(*lm_arrays.args(), w1, w2, w3,
                            np.int64(w1.shape[0]), out)
    return out


class LatArrays:
    """Flat-array view of a Lattice for the C results layer."""

    def __init__(self, lat):
        nodes = lat.nodes
        N = len(nodes)
        c = np.ascontiguousarray
        self.N = np.int32(N)
        self.n_ci = np.int32(nodes[0].rc_score.shape[0] if N else 1)
        self.sil_ci = np.int32(lat.sil_ci)
        self.sf = c([n.sf for n in nodes], np.int32)
        self.ef = c([n.ef for n in nodes], np.int32)
        self.lmwid = c([n.lmwid for n in nodes], np.int32)
        self.firstci = c([lat.firstci[n.kidx] for n in nodes], np.int32)
        self.is_filler = c([n.is_filler for n in nodes], np.uint8)
        self.is_finish = c([getattr(n, "is_finish", False)
                            or (n.lmwid == lat.finish_lmwid
                                and not n.is_filler)
                            for n in nodes], np.uint8)
        self.fil_pen = c([n.fil_pen for n in nodes], np.float32)
        self.entry = c([n.entry_score for n in nodes], np.float32)
        self.vit = c([n.vit_score for n in nodes], np.float32)
        self.rc = (np.stack([n.rc_score for n in nodes]).astype(np.float32)
                   if N else np.zeros((0, 1), np.float32))
        self.rc = c(self.rc.reshape(N, -1), np.float32)
        ptr = np.zeros(N + 1, np.int64)
        succ = []
        for n in nodes:
            ptr[n.id + 1] = len(n.succs)
            succ.extend(n.succs)
        # nodes are already id-ordered after _index_edges
        self.succ_ptr = c(np.cumsum(ptr), np.int64)
        self.succ = c(succ if succ else np.zeros(0, np.int32), np.int32)

    def args(self):
        return (self.N, self.n_ci, self.sil_ci, self.sf, self.ef, self.lmwid,
                self.firstci, self.is_filler, self.is_finish, self.fil_pen,
                self.entry, self.vit, self.rc, self.succ_ptr, self.succ)


def lattice_bestpath(lat, lw: float, start_lmwid: int,
                     prune_beam: float = 0.0):
    """Native exact trigram Viterbi.  Returns (node_ids, score) or None.
    prune_beam > 0 gates the exact DP with a bigram-approximate link beam
    (see csrc/sphinx_runtime.cc)."""
    lib = get_lib()
    if lib is None or not lat.nodes:
        return None
    la, lma = LatArrays(lat), LmArrays(lat.lm)
    cap = max(256, lat.n_frames + 8)
    path = np.zeros(cap, np.int32)
    score = ct.c_float(0.0)
    n = lib.lattice_bestpath(
        *la.args(), *lma.args(),
        np.float32(lw), np.float32(lat.log_wip),
        np.int32(lat.finish_lmwid), np.int32(start_lmwid),
        np.float32(prune_beam),
        path, np.int32(cap), ct.byref(score))
    if n < 0:  # buffer too small: retry exact size
        cap = -n
        path = np.zeros(cap, np.int32)
        n = lib.lattice_bestpath(
            *la.args(), *lma.args(),
            np.float32(lw), np.float32(lat.log_wip),
            np.int32(lat.finish_lmwid), np.int32(start_lmwid),
            np.float32(prune_beam),
            path, np.int32(cap), ct.byref(score))
    if n <= 0:
        return None
    return path[:n].tolist(), float(score.value)


def lattice_posterior(lat, ascale: float):
    """Native forward-backward node posteriors, or None."""
    lib = get_lib()
    if lib is None or not lat.nodes:
        return None
    la, lma = LatArrays(lat), LmArrays(lat.lm)
    out = np.zeros(len(lat.nodes), np.float64)
    lib.lattice_posterior(
        *la.args(), *lma.args(),
        np.float32(lat.lw), np.float32(lat.log_wip),
        np.int32(lat.finish_lmwid), np.float32(ascale), out)
    return out


def lattice_nbest(lat, n: int, lw: float, start_lmwid: int,
                  max_pop: int = 200000, want: int = 0):
    """Native A* N-best.  Returns list of (node_ids, score) or None.
    Over-requests (4n by default; callers may pass a larger `want` when
    de-duplication exhausts the batch) so the Python caller can de-dup
    same-text paths."""
    lib = get_lib()
    if lib is None or not lat.nodes:
        return None
    la, lma = LatArrays(lat), LmArrays(lat.lm)
    want = want or 4 * n
    cap = np.int64(want * (lat.n_frames + 8))
    nodes = np.zeros(int(cap), np.int32)
    lens = np.zeros(want, np.int32)
    scores = np.zeros(want, np.float32)
    got = lib.lattice_nbest(
        *la.args(), *lma.args(),
        np.float32(lw), np.float32(lat.log_wip),
        np.int32(lat.finish_lmwid), np.int32(start_lmwid),
        np.int32(want), np.int32(max_pop), nodes, cap, lens, scores)
    out = []
    pos = 0
    for k in range(got):
        out.append((nodes[pos : pos + lens[k]].tolist(), float(scores[k])))
        pos += int(lens[k])
    return out
