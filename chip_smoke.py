#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (cmusphinx_tpu_torch) on one GPU.

Run from the repository root:

    python3 chip_smoke.py

It needs one CUDA device, nvcc (CUDA_HOME or /usr/local/cuda) and no JAX.
Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device: the card, its power limit, its SMs and highest SM clock, torch
   / CUDA / nvcc versions.
2. build: compile kernel K1 (csrc/fused_gmm.cu) for sm_90a into build/.
3. K1 against its plain PyTorch version and against float64 at S=5150,
   K=32, D=39 in each -gmmprec mode, with magnitude-scaled bounds (see
   `SAME_MODE`, `MODE_BOUND`), on a unit-scale model at T=2000 and at the
   main path's T=9,600 and on a floored-variance model at T=2000; at both
   unit shapes the times (CUDA events) of K1, of its plain version and of
   the cuBLAS route (`library_route`), and K1's bound (`k1_bound`).  The
   same at D=64, K1's widest depth (`fused_gmm.MAX_D`), T=2000.
4. the slice: the seeded hub4-class fixture (cmusphinx_tpu_torch.fixture,
   16 utterances) through NgramSearch.decode_batch_cep with K1, its launch
   count, hypotheses against the plain scorer's on the card, WER and xRT.
5. semicont_scorer: PsParityScorer (8-bit and 4-bit weights) and
   SemiContinuousScorer at the hub4wsj_sc_8k width (S=5150, K=256, 3x13
   svspec streams, top-4, T=2000 frames of the semi-continuous fixture) on
   the card against the same modules on the host CPU: PsParityScorer's
   epilogue bit-exact on the card's own int32 densities, the densities
   within D*2^-22*M + 1, at most 1 in 1000 senone scores differing; the
   time of each stage (CUDA events) and the peak device memory.
6. semicont_slice: the semi-continuous fixture (16 utterances) through
   decode_batch_cep with PsParityScorer: WER, xRT (median of 5 passes),
   the scorer's share of a pass, peak memory; repeated passes must give
   identical hypotheses.
7. decoder: both fixtures written as model directories
   (fixture.write_model_dir) and loaded by Decoder(hmm=, lm=, dict=,
   device="cuda"): the scorer class the model selects, 4 utterances through
   decode_cep_file equal to the same Decoder's decode_batch_cep, K1
   launched by the continuous model, and one decode_raw of seeded 16-bit
   PCM whose cepstra from the card's Frontend match the CPU Frontend's.

8. large_vocab_tree: the LARGE continuous fixture at 20,000 words
   (fixture.LARGE, 16 utterances) through decode_batch_cep under `auto`,
   which must pick the prefix-tree lexicon, its exits scored by the hashed
   LM backend and its senones by K1: channels, K1's launch count, WER, xRT
   (median of 5 passes), peak memory, identical hypotheses in every pass,
   and the counted batch held against the host CPU (`hold_against_cpu`):
   utterance 0 decoded end to end there, and the search alone on the
   card's senone scores, with integer tape values of the valid frames
   equal, float values within rtol 1e-5, words and segments equal.
9. large_vocab_static: the LARGE semi-continuous fixture cut to 5,000 words
   with PsParityScorer under `auto`, which must pick the flat
   composite-context graph (the static-senone step) with `score_rows`
   entries; the same numbers, and the same CPU hold, its search part over
   all 16 utterances of the batch.

Phases 10-14 run beside the phases whose state they reuse: 10
after 3, 11 and 14 after 4, 13 after 7, 12 after 8.

10. k1 at the stream's shape: phase 3's checks and times at T=50 (one
   50-frame chunk of a stream).
11. stream: four utterances of the continuous fixture (the batch features
   of phase 4) through NgramSearch.stream_start / stream_push (50-frame
   pushes, stream_partial after each) / stream_end, one of them from a
   100-frame tape that must grow: the tape equal to the utterance's row of
   phase 4's batch (integers equal, floats within rtol 1e-5 over its T*E
   slots), the final hypothesis equal to the batch's, each partial but its
   last word (the word under way) a prefix of the final, K1 launched at
   least once a chunk; push -> partial latency p50 / p99 (host clock
   around synchronised work), the partial's share of it, and the
   streaming xRT.
12. stream_tree: utterance 0 of phase 8's 20,000-word tree streamed the
   same way and held to its batch row; K1 launched; latency and xRT.
13. decoder_stream: Decoder(streaming=True) on both model directories:
   cepstra in 25-frame pieces and PCM in 0.25-s pieces, a partial after
   each; final hypotheses equal to the CPU Decoder's on the same inputs;
   nbest(10) and get_prob after each.
14. lattice: for each utterance of phase 4's batch, get_lattice (node
   count, ms to build), bestpath by the native runtime (which must load)
   against the pure-Python bestpath, nbest(10) (ms to rescore); then
   decode_batch_cep(bestpath=True): its wall time and WER.

Then the kernel table {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Without CUDA it exits 1 before any result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.api import Decoder
from cmusphinx_tpu_torch.decode import NgramSearch
from cmusphinx_tpu_torch.decode import lattice as lattice_mod
from cmusphinx_tpu_torch.frontend import FeatPipeline, Frontend
from cmusphinx_tpu_torch.ops import (ContinuousScorer, PsParityScorer,
                                     SemiContinuousScorer, fused_gmm)
from cmusphinx_tpu_torch.ops.fused_gmm import (fused_mixture_scores,
                                               fused_mixture_scores_ref)
from cmusphinx_tpu_torch.utils import native
from cmusphinx_tpu_torch.utils.bio import write_mfc

SEED = 0
S, K, D, T_K1 = 5150, 32, 39, 2000
# The main path's batch: 16 utterances padded to 600 frames.
T_MAIN = 16 * 600
MODES = ("highest", "high", "bf16")
# K1's widest depth, timed beside D=39: its depth 2D fills the 128 the
# kernel instantiates, and "highest" and "high" have one ring stage there.
D_WIDE = 64
# Error bounds, as multiples of M[t,s] = max_k(|const| + sum|x lin| +
# sum x^2 quad), for features of width d.  Each mode against a float64
# evaluation: MODE_BOUND.  Kernel against plain: in "high" and "bf16" the
# same products, the f32 sums in another order (d * 2^-22); in "highest"
# the kernel's 3xTF32 products against the plain version's IEEE f32 ones,
# within the sum of the two sides' float64 bounds (2 * d * 2^-22).
MODE_BOUND = {"highest": lambda d: d * 2.0 ** -22,
              "high": lambda d: 2.0 ** -14, "bf16": lambda d: 2.0 ** -6}
SAME_MODE = {"highest": lambda d: 2 * d * 2.0 ** -22,
             "high": lambda d: d * 2.0 ** -22,
             "bf16": lambda d: d * 2.0 ** -22}
# The card's peaks for K1's bound (H100 SXM at 700 W, NVIDIA's data
# sheet): tensor cores 495 TFLOP/s tf32, 989 bf16; 3.35 TB/s of memory.
PEAK_FLOPS = {"tf32": 495e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12
# Exps a clock on each SM's special-function units (sm_90), at the card's
# highest SM clock as nvidia-smi reports it (phase 1).  That K1's exps run
# on these units alone is an assumption of its design, not a hard limit:
# some of them could run as FMA polynomials.
SFU_EXPS_PER_CLOCK = 16
DECODE_PASSES = 5
T_SEMI, TOPN = 2000, 4
# Share of (t, s) whose PsParityScorer score may differ between the card
# and the host CPU (the f32 density GEMMs sum in another order; the 10-bit
# shift absorbs nearly every unit of difference; the tests measured none).
PS_DIFF_SHARE = 1e-3
# Frontend: 1e-4 on each log-mel value, carried through |dct| and the
# lifter (tests/test_torch_fe.py).
LOGMEL_TOL = 1e-4
DECODER_UTTS = 4
# The streaming phases: a stream's chunk, the utterances streamed, and the
# Decoder's pieces (25 cepstral frames, 0.25 s of PCM).
T_STREAM = NgramSearch.CHUNK
STREAM_UTTS = 4
CEP_PIECE, RAW_PIECE_S = 25, 0.25
# Bestpath by the native runtime (float32 sums) against the pure-Python
# path (float64) on the same lattice: words equal, scores within the
# tapes' float tolerance.
LATTICE_RTOL = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str = "name,power.limit", fmt: str = "csv,noheader"
               ) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port has no CPU "
                         "fallback for this run")
    nvcc = subprocess.run([fused_gmm.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": nvidia_smi(),
            "sms": sms, "sm_clock_max_mhz": clock,
            "exps_per_s": SFU_EXPS_PER_CLOCK * sms * clock * 1e6,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": nvcc[-1], "python": sys.version.split()[0]}
    emit(info)
    return info


def phase_build() -> None:
    secs = fused_gmm.build()
    log = fused_gmm.library_path().with_suffix(".log").read_text()
    emit({"phase": "build", "seconds": round(secs, 3),
          "library": fused_gmm.library_path().name,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})


# ----------------------------------------------------------------------
def gmm_case(rng, floored: bool, T: int = T_K1, D: int = D):
    """Senone-major f32 lin/quad [S, K, D], const [S, K] and frames x [T, D]
    near the model.  `floored`: realistic cepstral means, variances spread
    over decades and floored at 1e-4 (prec up to 5e3), as trained models
    have; else the unit-scale synthetic model of evals/run_pallas_e2e.py."""
    if floored:
        scale = np.r_[np.full(13, 3.0), np.full(D - 13, 0.3)]
        means = rng.randn(S, K, D) * scale
        var = np.exp(rng.randn(S, K, D) * 2.0 - 1.5)
        var[rng.rand(S, K, D) < 0.05] = 1e-6
        var = np.maximum(var, 1e-4)
    else:
        means = rng.randn(S, K, D)
        var = 0.5 + rng.rand(S, K, D)
    means, var = means.astype(np.float32), var.astype(np.float32)
    prec = (0.5 / var).astype(np.float32)
    lrd = -0.5 * (np.log(var).sum(-1) + D * np.log(2.0 * np.pi))
    lnw = np.log(rng.dirichlet(np.ones(K), size=S))
    lin = (2.0 * prec * means).astype(np.float32)
    const = (lrd + lnw - (prec * means * means).sum(-1)).astype(np.float32)
    pick_s, pick_k = rng.randint(S, size=T), rng.randint(K, size=T)
    x = (means[pick_s, pick_k]
         + rng.randn(T, D) * np.sqrt(var[pick_s, pick_k])).astype(np.float32)
    return lin, prec, const, x


def magnitude_and_exact(x, lin, quad, const, rows: int = 250):
    """M[t,s] and the float64 scores, on the device, in frame chunks."""
    D = x.shape[1]
    l2 = lin.double().reshape(S * K, D)
    q2 = quad.double().reshape(S * K, D)
    c1 = const.double().reshape(1, S * K)
    Ms, exact = [], []
    for lo in range(0, x.shape[0], rows):
        xb = x[lo: lo + rows].double()
        Ms.append((c1.abs() + xb.abs() @ l2.abs().T + (xb * xb) @ q2.T)
                  .view(-1, S, K).amax(-1))
        ll = (c1 + xb @ l2.T - (xb * xb) @ q2.T).view(-1, S, K)
        exact.append(torch.logsumexp(ll, -1))
    return torch.cat(Ms), torch.cat(exact)


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_bound(T: int, mode: str, exps_per_s: float, D: int = D) -> tuple:
    """(least ms, what bounds it) for K1 at [T, S, K, D] in one mode: the
    larger of the bytes it must move (x, lin, quad and const read once, the
    scores written once) over the memory rate, its tensor-core products
    (three passes of 2*T*S*K*2D flops in "highest" and "high", one in
    "bf16") over their peak, and its T*S*K exps over `exps_per_s`."""
    pbytes = 2 if mode == "bf16" else 4
    nbytes = 4 * T * D + 2 * S * K * D * pbytes + 4 * S * K + 4 * T * S
    flops = (1 if mode == "bf16" else 3) * 2 * T * S * K * 2 * D
    ops_s = max(flops / PEAK_FLOPS["tf32" if mode == "highest" else "bf16"],
                T * S * K / exps_per_s)
    if nbytes / PEAK_BYTES > ops_s:
        return 1e3 * nbytes / PEAK_BYTES, "bytes"
    return 1e3 * ops_s, "operations"


def library_route(lin, quad, const):
    """The cuBLAS yardstick, which the port never calls: one IEEE-f32
    matmul of [x | x^2] by [lin | -quad]^T (with const added), then
    torch.logsumexp over K."""
    D = lin.shape[2]
    b = torch.cat([lin.float(), -quad.float()], -1).reshape(S * K, 2 * D)
    c = const.reshape(1, S * K)

    def run(x):
        a = torch.cat([x, x * x], 1)
        return torch.logsumexp(torch.addmm(c, a, b.T).view(-1, S, K), -1)
    return run


def check_k1(dev, floored: bool, modes, exps_per_s: float, T: int = T_K1,
             timed: bool = True, D: int = D) -> dict:
    rng = np.random.RandomState(SEED + 1 + floored + (T != T_K1) * 10
                                + (D != 39) * 20)
    lin, quad, const, x = (torch.as_tensor(a, device=dev)
                           for a in gmm_case(rng, floored, T, D))
    M, exact = magnitude_and_exact(x, lin, quad, const)
    lib = library_route(lin, quad, const) if timed else None
    results = {}
    for mode in modes:
        sc = ContinuousScorer.from_params(
            lin.cpu().numpy(), quad.cpu().numpy(), const.cpu().numpy(),
            precision=mode, device=dev)
        lp, qp, pk = sc.lin, sc.quad, sc.packed()
        got = fused_mixture_scores(x, lp, qp, const, mode, packed=pk)
        ref = fused_mixture_scores_ref(x, lp, qp, const, mode)
        torch.cuda.synchronize()
        if not (torch.isfinite(got).all() and got.shape == (T, S)):
            raise AssertionError(f"K1 {mode}: bad output")
        err_p = (got.double() - ref.double()).abs()
        err_x = (got.double() - exact).abs()
        err_r = (ref.double() - exact).abs()
        r = {"max_abs_err": float(err_p.max()),
             "worst_err_over_bound": float(
                 (err_p / (SAME_MODE[mode](D) * M)).max()),
             "max_abs_err_vs_fp64": float(err_x.max()),
             "worst_fp64_err_over_bound":
                 float((err_x / (MODE_BOUND[mode](D) * M)).max()),
             "plain_worst_fp64_err_over_bound":
                 float((err_r / (MODE_BOUND[mode](D) * M)).max())}
        if timed:
            bound_ms, bound_by = k1_bound(T, mode, exps_per_s, D)
            r.update({
                "ms": cuda_ms(lambda: fused_mixture_scores(
                    x, lp, qp, const, mode, packed=pk)),
                "plain_ms": cuda_ms(lambda: fused_mixture_scores_ref(
                    x, lp, qp, const, mode)),
                "library_ms": cuda_ms(lambda: lib(x)),
                "bound_ms": bound_ms, "bound_by": bound_by})
            r["share"] = r["bound_ms"] / r["ms"]
        emit({"phase": "k1", "model": "floored" if floored else "unit",
              "mode": mode, "S": S, "K": K, "D": D, "T": T, **r})
        if r["worst_err_over_bound"] > 1.0:
            raise AssertionError(f"K1 {mode}: kernel and plain version "
                                 f"disagree beyond their bound: {r}")
        if r["worst_fp64_err_over_bound"] > 1.0:
            raise AssertionError(f"K1 {mode}: error against float64 beyond "
                                 f"the mode's bound: {r}")
        results[mode] = r
        del sc, lp, qp, pk
    return results


# ----------------------------------------------------------------------
def phase_slice(dev, fx) -> dict:
    t0 = time.perf_counter()
    fp = FeatPipeline(fx.feat_config(), device=dev)
    scorer = ContinuousScorer(fx.gauden, fx.ln_mixw, device=dev)
    search = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, scorer, device=dev)
    setup_s = time.perf_counter() - t0

    # The main path, once, counted: every launch of K1 in this run.
    fused_mixture_scores.launches = 0
    t0 = time.perf_counter()
    hyps = search.decode_batch_cep(fx.ceps, fp)
    first_s = time.perf_counter() - t0
    launches = fused_mixture_scores.launches
    if launches < 1:
        raise AssertionError("the decode did not launch K1")
    tapes = [a.cpu().numpy() for a in search._last_batch[0]]

    walls = []
    for _ in range(DECODE_PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = search.decode_batch_cep(fx.ceps, fp)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if [h.words for h in again] != [h.words for h in hyps]:
            raise AssertionError("repeated decode changed its hypotheses")

    # The same decode with the scorer's plain version on the card.
    scorer.kernel = False
    plain = search.decode_batch_cep(fx.ceps, fp)
    scorer.kernel = True
    plain_tapes = [a.cpu().numpy() for a in search._last_batch[0]]
    segs = [[(s.word, s.start_frame, s.end_frame) for s in h.segments]
            for h in hyps]
    if [h.words for h in plain] != [h.words for h in hyps] or segs != [
            [(s.word, s.start_frame, s.end_frame) for s in h.segments]
            for h in plain]:
        raise AssertionError("K1 and the plain scorer decode differently")
    E = search.E
    int_diff = sum(int((a != b).sum()) for a, b in zip(tapes, plain_tapes)
                   if a.dtype.kind != "f")
    slot_diff = int(np.any(np.stack([a != b for a, b in zip(tapes, plain_tapes)
                                     if a.dtype.kind != "f"]), 0).sum())
    flt_diff = max(float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
                   for a, b in zip(tapes, plain_tapes) if a.dtype.kind == "f")
    for h in hyps:
        if not (h.segments and np.isfinite(h.score)):
            raise AssertionError(f"empty or non-finite hypothesis: {h}")
    errs = sum(fixture.word_errors(r, h.words)
               for r, h in zip(fx.transcripts, hyps))
    n_ref = sum(len(r) for r in fx.transcripts)
    med = statistics.median(walls)
    out = {"phase": "slice", "fixture": "hub4-class seed 0",
           "S": fx.size.n_sen, "K": fx.size.n_density, "D": 3 * fixture.NCEP,
           "words": search.vocab.n_word, "channels": search.graph.n_chan,
           "rc_variants": search.graph.n_rcvar, "utterances": len(fx.ceps),
           "frames_padded": int(tapes[0].shape[1] // E),
           "audio_s": fx.audio_seconds, "setup_s": setup_s,
           "first_decode_s": first_s, "decode_s": walls,
           "median_decode_s": med, "xRT": fx.audio_seconds / med,
           "k1_launches": launches, "tape_slots_differing": slot_diff,
           "tape_int_values_differing": int_diff,
           "tape_float_max_rel_diff": flt_diff,
           "word_errors": errs, "ref_words": n_ref,
           "wer": errs / n_ref}
    emit(out)
    return out, (search, fp, tapes, hyps)


# ----------------------------------------------------------------------
def peak_mb() -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 20


def semi_inputs(fx, n: int) -> np.ndarray:
    """The first n feature frames of the semi-continuous fixture."""
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    return np.concatenate(fp.compute_batch(fx.ceps))[:n]


def int_density_bound(sc, x) -> list:
    """Per stream, floor(D*2^-22*M) + 1 with M = |const| + sum|x lin| +
    sum x^2 prec in float64: how far two f32 GEMM orders may move the
    truncated densities."""
    out = []
    for f in range(sc.n_feat):
        xs = x[:, getattr(sc, f"slice{f}")].double()
        m = getattr(sc, f"means{f}").double()
        p = getattr(sc, f"prec{f}").double()
        const = getattr(sc, f"lrd{f}").double() - (p * m * m).sum(-1)
        M = const.abs() + xs.abs() @ (2 * p * m).abs().T + (xs * xs) @ p.T
        out.append(torch.floor(xs.shape[1] * 2.0 ** -22 * M) + 1)
    return out


def timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def check_psparity(dev, fx, raw, wrap: bool, x_cpu) -> dict:
    sl = fx.stream_slices()
    cpu = PsParityScorer(fx.gauden, raw, sl, topn=TOPN, wrap_uint8=wrap,
                         device="cpu")
    gpu = PsParityScorer(fx.gauden, raw, sl, topn=TOPN, wrap_uint8=wrap,
                         device=dev)
    x = x_cpu.to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 20
    d_gpu = gpu.int_densities(x)
    got = gpu.epilogue(d_gpu)
    torch.cuda.synchronize()
    peak = peak_mb() - base
    d_cpu = cpu.int_densities(x_cpu)
    bounds = int_density_bound(gpu, x)
    dmax = 0
    for a, b, lim in zip(d_gpu, d_cpu, bounds):
        diff = (a.cpu().long() - b.long()).abs()
        dmax = max(dmax, int(diff.max()))
        if bool((diff > lim.cpu()).any()):
            raise AssertionError("PsParityScorer densities beyond "
                                 "D*2^-22*M + 1 of the CPU's")
    # Stage (b) on the card against the CPU, on the card's densities.
    if not torch.equal(got.cpu(), cpu.epilogue([d.cpu() for d in d_gpu])):
        raise AssertionError("PsParityScorer epilogue differs from the "
                             "CPU's on identical int32 densities")
    want = cpu.score(x_cpu)
    q = (got.cpu() - want).abs() / gpu.scale
    n_diff = int((q > 0).sum())
    r = {"weights": "4-bit (wrap_uint8)" if wrap else "8-bit",
         "max_int_density_diff": dmax, "scores_differing": n_diff,
         "share_differing": n_diff / q.numel(),
         "max_diff_quanta": float(q.max()),
         "ms": cuda_ms(lambda: gpu.score(x)),
         "densities_ms": cuda_ms(lambda: gpu.int_densities(x)),
         "epilogue_ms": cuda_ms(lambda: gpu.epilogue(d_gpu)),
         "cpu_ms": 1e3 * timed(lambda: cpu.score(x_cpu)),
         "peak_mb_over_inputs": peak}
    if n_diff / q.numel() > PS_DIFF_SHARE:
        raise AssertionError(f"PsParityScorer: {n_diff} scores differ "
                             f"from the CPU's: {r}")
    if not bool(torch.isfinite(got).all()) or \
            got.shape != (len(x), raw.shape[-1]):
        raise AssertionError("PsParityScorer: bad output")
    return r


def phase_semicont_scorer(dev, fx) -> dict:
    x_cpu = torch.as_tensor(semi_inputs(fx, T_SEMI))
    raw8, meta = fixture.sendump_bytes(fx)
    assert meta["n_bits"] == 8
    # A 4-bit sendump holds bytes of a 16-entry codebook; values up to 255
    # make the uint8 wrap happen.
    rng = np.random.RandomState(SEED + 5)
    cb = np.sort(rng.choice(256, 16, replace=False)).astype(np.uint8)
    raw4 = cb[rng.randint(16, size=raw8.shape)]
    out = {"phase": "semicont_scorer", "S": raw8.shape[2],
           "K": fx.gauden.n_density, "streams": fx.gauden.veclen,
           "topn": TOPN, "T": T_SEMI,
           "psparity": [check_psparity(dev, fx, raw8, False, x_cpu),
                        check_psparity(dev, fx, raw4, True, x_cpu)]}
    sl = fx.stream_slices()
    cpu = SemiContinuousScorer(fx.gauden, fx.ln_mixw, sl, topn=TOPN,
                               device="cpu")
    gpu = SemiContinuousScorer(fx.gauden, fx.ln_mixw, sl, topn=TOPN,
                               device=dev)
    x = x_cpu.to(dev)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2 ** 20
    got = gpu.score(x)
    torch.cuda.synchronize()
    peak = peak_mb() - base
    want = cpu.score(x_cpu)
    err = (got.cpu() - want).abs()
    lim = sum(b.max(1, keepdim=True).values.cpu() for b in
              int_density_bound(gpu, x)) + 1e-5 * want.abs()
    out["semicontinuous"] = {
        "max_abs_err": float(err.max()), "worst_err_over_bound":
        float((err / lim).max()), "ms": cuda_ms(lambda: gpu.score(x)),
        "cpu_ms": 1e3 * timed(lambda: cpu.score(x_cpu)),
        "peak_mb_over_inputs": peak}
    emit(out)
    if out["semicontinuous"]["worst_err_over_bound"] > 1.0:
        raise AssertionError(f"SemiContinuousScorer: card and CPU disagree: "
                             f"{out['semicontinuous']}")
    return out


def phase_semicont_slice(dev, fx) -> dict:
    t0 = time.perf_counter()
    raw, meta = fixture.sendump_bytes(fx)
    fp = FeatPipeline(fx.feat_config(), device=dev)
    scorer = PsParityScorer(fx.gauden, raw, fx.stream_slices(), topn=TOPN,
                            wrap_uint8=meta["n_bits"] == 4, device=dev)
    search = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, scorer, device=dev)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hyps = search.decode_batch_cep(fx.ceps, fp)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak = peak_mb()
    walls = []
    for _ in range(DECODE_PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = search.decode_batch_cep(fx.ceps, fp)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if [h.words for h in again] != [h.words for h in hyps]:
            raise AssertionError("repeated decode changed its hypotheses")
    for h in hyps:
        if not (h.segments and np.isfinite(h.score)):
            raise AssertionError(f"empty or non-finite hypothesis: {h}")
    # The scorer alone at the pass's batch shape.
    c, T, _ = search._pad(fx.ceps)
    with torch.inference_mode():
        feats = fp._padded_kernel(c, T, True)
        score_ms = cuda_ms(lambda: scorer.score(feats), reps=3)
    errs = sum(fixture.word_errors(r, h.words)
               for r, h in zip(fx.transcripts, hyps))
    n_ref = sum(len(r) for r in fx.transcripts)
    med = statistics.median(walls)
    out = {"phase": "semicont_slice", "fixture": "semi seed 0",
           "S": fx.size.n_sen, "K": fx.gauden.n_density,
           "streams": fx.gauden.veclen, "utterances": len(fx.ceps),
           "frames_padded": int(feats.shape[1]),
           "audio_s": fx.audio_seconds, "setup_s": setup_s,
           "first_decode_s": first_s, "decode_s": walls,
           "median_decode_s": med, "xRT": fx.audio_seconds / med,
           "scorer_ms_per_batch": score_ms,
           "scorer_share": score_ms / 1e3 / med, "peak_mb": peak,
           "word_errors": errs, "ref_words": n_ref, "wer": errs / n_ref}
    emit(out)
    return out


def phase_decoder(dev, fixtures) -> dict:
    out = {"phase": "decoder", "models": {}}
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        for model, fx in fixtures.items():
            kw = fixture.write_model_dir(fx, os.path.join(tmp, model))
            t0 = time.perf_counter()
            dec = Decoder(device=dev, **kw)
            init_s = time.perf_counter() - t0
            want_cls = {"cont": ContinuousScorer,
                        "semi": PsParityScorer}[model]
            if type(dec.scorer) is not want_cls:
                raise AssertionError(f"{model}: Decoder chose "
                                     f"{type(dec.scorer).__name__}")
            paths = []
            for i, c in enumerate(fx.ceps[:DECODER_UTTS]):
                paths.append(os.path.join(tmp, f"{model}{i}.mfc"))
                write_mfc(paths[-1], c)
            # The main path, once, counted.
            fused_gmm.fused_mixture_scores.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hyps = [dec.decode_cep_file(p) for p in paths]
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
            launches = fused_gmm.fused_mixture_scores.launches
            batch = dec.search.decode_batch_cep(fx.ceps[:DECODER_UTTS],
                                                dec.fp)
            if [h.words for h in hyps] != [h.words for h in batch]:
                raise AssertionError(f"{model}: decode_cep_file and "
                                     f"decode_batch_cep disagree")
            if (launches > 0) != (model == "cont"):
                raise AssertionError(f"{model}: K1 launched {launches} times")
            errs = sum(fixture.word_errors(r, h.words)
                       for r, h in zip(fx.transcripts, hyps))
            out["models"][model] = {
                "scorer": type(dec.scorer).__name__, "init_s": init_s,
                "decode_cep_file_s": decode_s, "k1_launches": launches,
                "word_errors": errs,
                "ref_words": sum(len(r) for r in fx.transcripts[:len(hyps)])}
        # decode_raw on the semi-continuous model (hub4-like frontend).
        raw = fixture.synthetic_pcm(SEED)
        raw_path = os.path.join(tmp, "speech.raw")
        raw.tofile(raw_path)
        t0 = time.perf_counter()
        h = dec.decode_raw(raw_path)
        raw_s = time.perf_counter() - t0
        cpu_fe = Frontend(dec.config, device="cpu")
        want = cpu_fe.process(raw.astype(np.float32))
        got = dec.fe.process(raw.astype(np.float32))
        b = np.full(cpu_fe.nfilt, LOGMEL_TOL) @ np.abs(
            cpu_fe.dct.numpy().astype(np.float64))
        if cpu_fe.lifter is not None:
            b = b * np.abs(cpu_fe.lifter.numpy())
        err = np.abs(got.astype(np.float64) - want)
        out["decode_raw"] = {"samples": len(raw), "frames": len(got),
                             "words": len(h.words), "seconds": raw_s,
                             "cep_max_abs_err": float(err.max()),
                             "worst_err_over_bound": float((err / b).max())}
    out["k1_launches"] = out["models"]["cont"]["k1_launches"]
    out["peak_mb"] = peak_mb()
    emit(out)
    if got.shape != want.shape or out["decode_raw"]["worst_err_over_bound"] > 1:
        raise AssertionError(f"card and CPU Frontend disagree: {out}")
    return out


# ----------------------------------------------------------------------
class CardScores(torch.nn.Module):
    """A scorer that returns given senone scores [B, Tpad, S], cut to the
    batch and frames it is asked for."""

    def __init__(self, scores: torch.Tensor):
        super().__init__()
        self.scores = scores

    def score(self, feats: torch.Tensor) -> torch.Tensor:
        return self.scores[: feats.shape[0], : feats.shape[1]]


def hold_against_cpu(search, fp, tapes, hyps, cpu_search, fx, cpu_fp,
                     n: int) -> dict:
    """The counted batch decode on the card (`tapes` [B, Tpad*E, ...] on the
    host, `hyps`) held against the host CPU: integer tape values equal and
    float values within rtol 1e-5 over each utterance's valid frames (all
    the backtrace reads), words and segments equal.

    - `e2e`: utterance 0 decoded end to end on the CPU, with its own
      features and scorer, against row 0 of the batch.
    - `search`: the first n utterances of the batch through the CPU search
      fed the card's senone scores, which holds the search alone with every
      live slot of the batch.  The scorers are held card against CPU in
      their own phases; how many of these scores the CPU scorer gives
      otherwise is reported, not held."""
    E = search.E
    out = {}

    def segs(h):
        return [(s.word, s.start_frame, s.end_frame) for s in h.segments]

    def check(name, want):
        cpu_tapes = [t.numpy() for t in cpu_search._last_batch[0]]
        int_diff, rel = 0, 0.0
        for i, c in enumerate(fx.ceps[:len(want)]):
            for x, y in zip(tapes, cpu_tapes):
                x, y = x[i, :len(c) * E], y[i, :len(c) * E]
                if x.dtype.kind == "f":
                    rel = max(rel, float(np.max(np.abs(x - y) / np.maximum(
                        np.abs(y), 1e-30))))
                else:
                    int_diff += int((x != y).sum())
        same = all(a.words == b.words and segs(a) == segs(b)
                   for a, b in zip(hyps, want))
        out.update({f"{name}_utterances": len(want),
                    f"{name}_int_values_differing": int_diff,
                    f"{name}_float_max_rel_diff": rel,
                    f"{name}_hyps_equal": same})
        if int_diff or rel > 1e-5 or not same:
            raise AssertionError(f"card and CPU decode differently: {out}")

    check("e2e", cpu_search.decode_batch_cep(fx.ceps[:1], cpu_fp))

    c, T, Ts = search._pad(fx.ceps)
    with torch.inference_mode():
        feats = fp._padded_kernel(c, T, True)
        scores = search.scorer.score(feats).cpu()
    feats = feats.cpu()
    own = cpu_search.scorer
    cpu_search.scorer = CardScores(scores)
    try:
        check("search", cpu_search.decode_batch(
            [feats[i, :Ts[i]].numpy() for i in range(n)]))
    finally:
        cpu_search.scorer = own
    valid = torch.arange(feats.shape[1])[None, :] < T[:n, None].cpu()
    with torch.inference_mode():
        differ = own.score(feats[:n]) != scores[:n]
    out["cpu_scores_differing"] = int((differ & valid[..., None]).sum())
    out["scores_compared"] = int(valid.sum()) * scores.shape[2]
    return out


def phase_large_vocab(dev, card: str, name: str, fx, make_scorer,
                      want_lex: str, want_lm: str, hold_utts: int) -> dict:
    t0 = time.perf_counter()
    fp = FeatPipeline(fx.feat_config(), device=dev)
    search = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, make_scorer(dev),
                         device=dev)
    setup_s = time.perf_counter() - t0
    g = search.graph
    if (g.rc_mode, g.lc_mode, g.lex_mode) != ("composite", "composite",
                                              want_lex):
        raise AssertionError(f"{name}: auto picked {g.rc_mode}/{g.lc_mode}/"
                             f"{g.lex_mode}")

    # The main path, once, counted.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_mixture_scores.launches = 0
    search.dlm.calls.clear()
    t0 = time.perf_counter()
    hyps = search.decode_batch_cep(fx.ceps, fp)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fused_mixture_scores.launches
    lm_calls = dict(search.dlm.calls)
    peak = peak_mb()
    if lm_calls.get(want_lm, 0) < 1:
        raise AssertionError(f"{name}: LM answered by {lm_calls}, not "
                             f"{want_lm}")
    tapes = [t.cpu().numpy() for t in search._last_batch[0]]
    frames = int(tapes[0].shape[1] // search.E)

    walls = []
    for _ in range(DECODE_PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = search.decode_batch_cep(fx.ceps, fp)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if [h.words for h in again] != [h.words for h in hyps]:
            raise AssertionError(f"{name}: repeated decode changed its "
                                 f"hypotheses")
    for h in hyps:
        if not (h.segments and np.isfinite(h.score)):
            raise AssertionError(f"{name}: empty or non-finite hypothesis")

    t0 = time.perf_counter()
    cpu_search = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                             make_scorer("cpu"), device="cpu")
    hold = hold_against_cpu(search, fp, tapes, hyps, cpu_search, fx,
                            FeatPipeline(fx.feat_config(), device="cpu"),
                            hold_utts)
    hold["cpu_hold_s"] = time.perf_counter() - t0
    errs = sum(fixture.word_errors(r, h.words)
               for r, h in zip(fx.transcripts, hyps))
    n_ref = sum(len(r) for r in fx.transcripts)
    med = statistics.median(walls)
    out = {"phase": name, "card": card, "model": fx.model,
           "S": fx.size.n_sen, "words": search.vocab.n_word,
           "lm_words": fx.lm.n_words, "bigrams": len(fx.lm.bg_wid),
           "trigrams": len(fx.lm.tg_wid),
           "graph": f"{g.rc_mode}/{g.lc_mode}/{g.lex_mode}",
           "channels": g.n_chan, "lm_backend_calls": lm_calls,
           "utterances": len(fx.ceps), "frames_padded": frames,
           "audio_s": fx.audio_seconds, "setup_s": setup_s,
           "first_decode_s": first_s, "decode_s": walls,
           "median_decode_s": med, "xRT": fx.audio_seconds / med,
           "k1_launches": launches, "peak_mb": peak,
           "hyps_identical_across_passes": True,
           "word_errors": errs, "ref_words": n_ref, "wer": errs / n_ref,
           **hold}
    emit(out)
    return out, (search, fp, tapes, hyps)


# ----------------------------------------------------------------------
def batch_features(search, fp, fx) -> list:
    """The features phase 4's batch decoded, per utterance on the host."""
    c, T, Ts = search._pad(fx.ceps)
    with torch.inference_mode():
        feats = fp._padded_kernel(c, T, True).cpu().numpy()
    return [feats[i, :Ts[i]] for i in range(len(Ts))]


def run_stream(search, feats: np.ndarray, max_frames: int):
    """One utterance through the stream in CHUNK pushes, a partial after
    each: (final, partial word lists, [(push -> partial ms, of it the
    partial's ms)], state).  The push is not synchronised apart: its
    device work finishes inside the partial's host copy."""
    st = search.stream_start(max_frames=max_frames)
    partials, lat_ms = [], []
    for i in range(0, len(feats), T_STREAM):
        t0 = time.perf_counter()
        search.stream_push(st, feats[i: i + T_STREAM])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        partials.append(search.stream_partial(st).words)
        t2 = time.perf_counter()
        lat_ms.append((1e3 * (t2 - t0), 1e3 * (t2 - t1)))
    return search.stream_end(st), partials, lat_ms, st


def hold_stream(search, final, partials, tapes, i: int, hyp) -> dict:
    """The stream's tape against row i of a batch's host tapes over its
    T*E slots, its final hypothesis against the batch's, and its partials
    against the final (each but its last word, the word under way, a
    prefix of the final)."""
    E, T = search.E, search._last[6]
    int_diff, rel = 0, 0.0
    for x, y in zip(search._last[:6], tapes):
        y = y[i, :T * E]
        if x.dtype.kind == "f":
            rel = max(rel, float(np.max(np.abs(x - y) / np.maximum(
                np.abs(y), 1e-30))))
        else:
            int_diff += int((x != y).sum())

    def segs(h):
        return [(s.word, s.start_frame, s.end_frame) for s in h.segments]
    return {"int_values_differing": int_diff, "float_max_rel_diff": rel,
            "final_equal": final.words == hyp.words
            and segs(final) == segs(hyp),
            "final_score_rel_diff": abs(final.score - hyp.score)
            / abs(hyp.score),
            "partials": len(partials),
            "partials_strict_prefix": sum(
                final.words[: len(p)] == p for p in partials),
            "partials_prefix_but_last": all(
                final.words[: max(len(p) - 1, 0)] == p[:-1]
                for p in partials)}


def stream_phase(name: str, search, feats_list, tapes, hyps, utts,
                 max_frames) -> dict:
    """`utts` utterances streamed (max_frames[k] for the k-th), counted
    and timed, each held to its batch row (`hold_stream`)."""
    fused_mixture_scores.launches = 0
    torch.cuda.synchronize()
    holds, lat_ms, chunks, grew = [], [], 0, []
    wall = 0.0
    for i, mf in zip(utts, max_frames):
        t0 = time.perf_counter()
        final, partials, ms, st = run_stream(search, feats_list[i], mf)
        wall += time.perf_counter() - t0
        holds.append(hold_stream(search, final, partials, tapes, i, hyps[i]))
        lat_ms += ms
        chunks += -(-len(feats_list[i]) // T_STREAM)
        grew.append(st["max_frames"] > mf)
    launches = fused_mixture_scores.launches
    audio_s = sum(len(feats_list[i]) for i in utts) / 100.0
    total, partial = np.array(lat_ms).T
    out = {"phase": name, "utterances": len(utts), "chunk_frames": T_STREAM,
           "chunks": chunks, "k1_launches": launches,
           "tape_grew": grew, "audio_s": audio_s, "stream_wall_s": wall,
           "xRT": audio_s / wall,
           "push_partial_ms_p50": float(np.percentile(total, 50)),
           "push_partial_ms_p99": float(np.percentile(total, 99)),
           "push_partial_ms_max": float(total.max()),
           "partial_ms_p50": float(np.percentile(partial, 50)),
           "partial_ms_p99": float(np.percentile(partial, 99)),
           "pushes": len(total), "holds": holds}
    emit(out)
    bad = [h for h in holds if h["int_values_differing"]
           or h["float_max_rel_diff"] > 1e-5 or not h["final_equal"]
           or not h["partials_prefix_but_last"]]
    if bad:
        raise AssertionError(f"{name}: the stream and the batch differ: {bad}")
    if launches < chunks:
        raise AssertionError(f"{name}: K1 launched {launches} times for "
                             f"{chunks} chunks")
    if max_frames[0] < max(len(feats_list[i]) for i in utts) and not any(grew):
        raise AssertionError(f"{name}: the tape never grew")
    return out


def phase_decoder_stream(dev, fixtures) -> dict:
    out = {"phase": "decoder_stream", "models": {}}
    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        for model, fx in fixtures.items():
            kw = fixture.write_model_dir(fx, os.path.join(tmp, model))
            gpu, cpu = Decoder(device=dev, **kw), Decoder(device="cpu", **kw)
            rate = float(gpu.config["samprate"])
            inputs = {"cep": (fx.ceps[0], CEP_PIECE),
                      "raw": (fixture.synthetic_pcm(SEED, 2.0, int(rate))
                              .astype(np.float32), int(RAW_PIECE_S * rate))}
            res = {}
            for kind, (data, step) in inputs.items():
                finals = []
                for dec in (gpu, cpu):
                    fused_gmm.fused_mixture_scores.launches = 0
                    ms = []
                    t0 = time.perf_counter()
                    dec.start_utt(streaming=True)
                    for i in range(0, len(data), step):
                        t1 = time.perf_counter()
                        getattr(dec, f"process_{kind}")(data[i: i + step])
                        dec.hyp()
                        ms.append(1e3 * (time.perf_counter() - t1))
                    h = dec.end_utt()
                    wall = time.perf_counter() - t0
                    finals.append((h, ms, wall, len(dec.nbest(10)),
                                   dec.get_prob(),
                                   fused_gmm.fused_mixture_scores.launches))
                (g, gms, gwall, gnb, gprob, gl), (c, *_) = finals
                launches += gl
                same = (g.words == c.words and
                        [(s.start_frame, s.end_frame) for s in g.segments]
                        == [(s.start_frame, s.end_frame) for s in c.segments])
                res[kind] = {"pieces": len(gms), "words": len(g.words),
                             "equal_to_cpu": same,
                             "score_rel_diff": abs(g.score - c.score)
                             / abs(c.score) if c.segments else 0.0,
                             "piece_ms_p50": float(np.percentile(gms, 50)),
                             "wall_s": gwall, "nbest": gnb, "prob": gprob,
                             "k1_launches": gl}
                if not same or not (0.0 < gprob <= 1.0) or gnb < 1:
                    raise AssertionError(f"decoder_stream {model} {kind}: "
                                         f"{res[kind]}, card {g}, cpu {c}")
                if (gl > 0) != (model == "cont"):
                    raise AssertionError(f"decoder_stream {model}: K1 "
                                         f"launched {gl} times")
            out["models"][model] = res
    out["k1_launches"] = launches
    emit(out)
    return out


def phase_lattice(search, fp, fx, hyps) -> dict:
    """Phase 4's batch: each utterance's lattice and its rescoring."""
    if not native.loaded():
        raise AssertionError("the native runtime did not build or load")
    bplw, start = float(search.config["bestpathlw"]), search.start_lmwid
    rows = []
    for i in range(len(fx.ceps)):
        t0 = time.perf_counter()
        search.select_utt(i)
        lat = search.get_lattice()
        t1 = time.perf_counter()
        best = lat.bestpath(lw=bplw, start_lmwid=start)
        t2 = time.perf_counter()
        nb = lat.nbest(10, start_lmwid=start)
        post = lat.posterior(1.0 / float(search.config["ascale"]))
        own, lattice_mod._native = lattice_mod._native, None
        try:
            py = lat.bestpath(lw=bplw, start_lmwid=start)
        finally:
            lattice_mod._native = own
        rows.append({"nodes": len(lat.nodes), "build_ms": 1e3 * (t1 - t0),
                     "rescore_ms": 1e3 * (t2 - t1), "nbest": len(nb),
                     "words_equal": best.words == py.words,
                     "score_rel_diff": abs(best.score - py.score)
                     / abs(py.score),
                     "posterior_finite": int(np.isfinite(post).sum())})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rescored = search.decode_batch_cep(fx.ceps, fp, bestpath=True)
    bp_s = time.perf_counter() - t0
    errs = sum(fixture.word_errors(r, h.words)
               for r, h in zip(fx.transcripts, rescored))
    out = {"phase": "lattice", "native_loaded": native.loaded(),
           "utterances": len(rows),
           "nodes": [r["nodes"] for r in rows],
           "build_ms_median": statistics.median(r["build_ms"] for r in rows),
           "rescore_ms_median": statistics.median(r["rescore_ms"]
                                                  for r in rows),
           "nbest_counts": [r["nbest"] for r in rows],
           "native_python_words_equal": all(r["words_equal"] for r in rows),
           "native_python_score_max_rel_diff": max(r["score_rel_diff"]
                                                   for r in rows),
           "bestpath_batch_s": bp_s,
           "bestpath_differs_from_viterbi": sum(
               a.words != b.words for a, b in zip(rescored, hyps)),
           "bestpath_word_errors": errs,
           "ref_words": sum(len(r) for r in fx.transcripts)}
    emit(out)
    if not out["native_python_words_equal"] or \
            out["native_python_score_max_rel_diff"] > LATTICE_RTOL or \
            min(out["nodes"]) < 1 or \
            min(out["nbest_counts"]) < 1:
        raise AssertionError(f"lattice: {out}")
    return out


def main() -> int:
    info = phase_device()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    phase_build()
    exps = info["exps_per_s"]
    check_k1(dev, floored=False, modes=MODES, exps_per_s=exps)
    check_k1(dev, floored=True, modes=MODES, exps_per_s=exps, timed=False)
    k1 = check_k1(dev, floored=False, modes=MODES, exps_per_s=exps, T=T_MAIN)
    check_k1(dev, floored=False, modes=MODES, exps_per_s=exps, D=D_WIDE)
    k1_stream = check_k1(dev, floored=False, modes=MODES, exps_per_s=exps,
                         T=T_STREAM)
    cont = fixture.build(SEED)
    sl, (search, fp, tapes, hyps) = phase_slice(dev, cont)
    stream = stream_phase("stream", search, batch_features(search, fp, cont),
                          tapes, hyps, range(STREAM_UTTS),
                          [2 * T_STREAM] + [3000] * (STREAM_UTTS - 1))
    phase_lattice(search, fp, cont, hyps)
    del search, fp, tapes, hyps
    semi = fixture.build(SEED, model="semi")
    phase_semicont_scorer(dev, semi)
    phase_semicont_slice(dev, semi)
    dec = phase_decoder(dev, {"cont": cont, "semi": semi})
    dec_stream = phase_decoder_stream(dev, {"cont": cont, "semi": semi})
    card = info["nvidia_smi"]
    large = fixture.build(SEED, size=fixture.LARGE)
    tree, (search, fp, tapes, hyps) = phase_large_vocab(
        dev, card, "large_vocab_tree", large,
        lambda d: ContinuousScorer(large.gauden, large.ln_mixw, device=d),
        "tree", "hashed", hold_utts=1)
    if tree["k1_launches"] < 1:
        raise AssertionError("the tree decode did not launch K1")
    stream_tree = stream_phase("stream_tree", search,
                               batch_features(search, fp, large), tapes, hyps,
                               [0], [3000])
    del large, search, fp, tapes, hyps
    semi5k = fixture.build(SEED, model="semi", size=fixture.LARGE_5K)
    raw, meta = fixture.sendump_bytes(semi5k)
    phase_large_vocab(
        dev, card, "large_vocab_static", semi5k,
        lambda d: PsParityScorer(semi5k.gauden, raw, semi5k.stream_slices(),
                                 topn=TOPN, wrap_uint8=meta["n_bits"] == 4,
                                 device=d),
        "flat", "rows", hold_utts=len(semi5k.ceps))
    # The batch's shape (T=9,600) keys the row; the stream's (T=50, one
    # chunk) rides beside it.
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    emit({"kernels": [{
        "name": "fused_gmm", "route": "cuda",
        "source": "cmusphinx_tpu_torch/csrc/fused_gmm.cu",
        "replaces": "cmusphinx_tpu/ops/pallas_gmm.py:74",
        "launches": sum(p["k1_launches"] for p in (
            sl, dec, tree, stream, stream_tree, dec_stream)),
        **{k: k1["highest"][k] for k in keys},
        "stream_shape": {"T": T_STREAM, **{k: k1_stream["highest"][k]
                                           for k in keys}}}]})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
