#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (cmusphinx_tpu_torch) on one GPU.

Run from the repository root:

    python3 chip_smoke.py

It needs one CUDA device, nvcc (CUDA_HOME or /usr/local/cuda) and no JAX.
Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device: the card, its power limit, its SMs and highest SM clock, torch
   / CUDA / nvcc versions.
2. build: compile kernel K1 (csrc/fused_gmm.cu, its units in parallel) for
   sm_90a into build/, and beside it the C++ host runtime.
3. K1 against its plain PyTorch version and against float64 at S=5150,
   K=32, D=39 in each -gmmprec mode, with magnitude-scaled bounds (see
   `SAME_MODE`, `MODE_BOUND`), on a unit-scale model at T=2000 and at the
   main path's T=9,600 and on a floored-variance model at T=2000; at both
   unit shapes the times (CUDA events) of K1, of its plain version and of
   the cuBLAS route (`library_route`), and K1's bound (`k1_bound`).  The
   same at D=64, the widest depth of K1's one-instantiation-a-depth path,
   T=2000.
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
   LM backend and its senones by K1: channels, K1's launch count (once),
   WER, xRT (median of 5 passes), peak memory, identical hypotheses in
   every pass, and the counted batch held against the host CPU (`Holds`):
   utterance 0 decoded end to end there, and the search alone on the
   card's senone scores for utterance 0, with integer tape values of the
   valid frames equal, float values within rtol 1e-5, words and segments
   equal.
9. large_vocab_static: the LARGE semi-continuous fixture cut to 5,000 words
   with PsParityScorer under `auto`, which must pick the flat
   composite-context graph (the static-senone step) with `score_rows`
   entries; the same numbers, and the same CPU hold over all 16
   utterances of the batch.
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
14. lattice: phase 4's batch decoded again with wide beams (the CPU
   tests' beams, for lattices of 100+ nodes), and for each utterance
   get_lattice (node count, ms to build), bestpath by the native runtime
   (which must load) against the pure-Python bestpath, nbest(10) (ms to
   rescore); then decode_batch_cep(bestpath=True): its wall time and WER.
15. k1_wide: phase 3 at D=78 and D=150 (K1's depth loop, its geometry
   from fused_gmm.plan), T=2000, unit (timed, with bound and cuBLAS route)
   and floored models, in each mode; then a continuous model over 26
   cepstra (D=78) written as a model directory and decoded by
   Decoder(device="cuda"): K1 launched once an utterance, WER, utterance
   0 equal to the CPU Decoder's.
16. grammar: Decoder(hmm=, jsgf=) and (hmm=, fsg=) on the continuous
   fixture's model directory with its grammar (fixture.grammar_jsgf /
   grammar_fsg): 16 utterances through decode_cep_file, counted (K1 once an
   utterance), ms an utterance on the host clock and in CUDA events, ms a
   frame, xRT, WER; the last utterance's lattice (bestpath, nbest(5));
   utterance 0 through the FSG stream in 50-frame pushes (K1 once a
   chunk), its final equal to the batch's; held against the CPU (`Holds`):
   utterance 0 end to end, and all 16 utterances through the CPU grammar
   search fed the card's senone scores (the counted decodes' exit tapes,
   integers equal, floats within rtol 1e-5; hypotheses equal).  The frame
   loop runs as captured CUDA graphs of 50-frame blocks (the default; one
   graph a search); the 16 utterances again eager (`FsgSearch._graphs =
   False`) and graphed, and the streams of STREAM_UTTS utterances in turns:
   exit tapes, hypotheses and partials bit-equal; each way's ms an
   utterance, ms a frame, xRT and push -> partial p50 / p99.
17. align_allphone: Decoder.align of 4 utterances with their transcripts
   (states and segments equal to the CPU's, K1 launched once each), then
   eager and graphed again (states, segments and scores bit-equal; ms an
   utterance and a frame each way), and an -allphone uniform decode
   against the CPU's (K1 once).
18. ngram_options: pl_window=5 on the continuous slice (the batch counted,
   K1 once, and all 16 utterances held against the CPU search on its
   senone scores; two utterances streamed, K1 once a chunk, their tapes
   equal to the batch rows before the last pl_window - 1 frames);
   nlextree=2 on the 20,000-word tree (4 utterances counted, K1 once, and
   held against the CPU search on the card's senone scores).
19. cpu_holds: every CPU hold above, collected (`Holds`).
20. train: the trainer (cmusphinx_tpu_torch.train) at the hub4-class
   continuous width: 64 utterances of the fixture
   (fixture.FULL with n_utt=64, features from FeatPipeline on the card), a
   CI model over its 39 phones + SIL (3 states: 120 senones) at K=32,
   D=39.  One forward-backward at the flat start with CUDA events around
   its stages (forward, backward, accumulation), held against the same
   pass on the CPU (each utterance's llh within rtol 1e-5, every
   accumulator within bw.posterior_rtol); one pass under torch.profiler
   (device events a frame step, the device's idle share); 3 EM steps
   (history may not fall; ms a step, BW frames/s, peak MB); viterbi_align
   at the final parameters held against the CPU's (states equal but for
   near-ties scored in float64 within 1e-6); estimate_mllt (D=39) on the
   alignment's senone labels held against the CPU's (row directions within
   1e-3, objective within rtol 1e-5); the model exported (export_model)
   beside the fixture's LM and dictionary and 16 utterances decoded by
   Decoder(device="cuda"), K1 once an utterance, words equal to the CPU
   Decoder's on the same directory, WER printed.
21. train_pipeline: train_full_pipeline on the slice's 16 utterances to 32
   Gaussians at its default iteration counts (CI, CD untied, tied by
   agglomerative merging, then 5 splits), every stage's history not
   falling; host seconds of tying apart from the seconds of EM; the
   export_cd_model directory read back by Mdef, read_gauden and
   TransitionMatrices.
22. train_semicont: SemiContTrainer at hub4wsj_sc_8k's codebook width
   (K=256) on the same 16 utterances: step 1 held against the CPU as in
   20, 2 EM steps, ms a step, peak MB.

23. approx: the continuous slice's batch through decode_batch_cep with
   DownsampledScorer(ds=2) and with CigmmsScorer(ci_pbeam=7) around
   ContinuousScorer (K1 once a batch; WER), each held against the CPU
   search on the card's senone scores; GsSelectorScorer (64 clusters,
   top 2) and KdTreeSelectorScorer (depth 6, radius 3) at T=2000, their
   codebook and tree built on the host in the hold workers, held against
   the CPU (kd-tree leaves equal; the selector's cluster masks counted;
   scores within D * 2^-22 * M where the masks agree); each scorer's ms
   (CUDA events) and peak MB.
24. subvq: build_subvq at the full width (3 subvectors of 256 codewords,
   SUBVQ_ITER k-means iterations and SUBVQ_RESTARTS restarts, printed),
   in a hold worker; SubVQScorer and its shortlist at T=2000 held against
   the CPU; the batch decoded with it as the scorer (WER, peak MB), held
   against the CPU search on its scores.
25. replay: utterance 0's K1 scores written by write_senscr and decoded
   through ReplayScorer.from_file: the live decode's words and segments.
26. endpoint: FrameClassifier fitted on the card to the 16 utterances'
   frames, labelled SIL / speech by the card's AlignSearch (K1 once an
   utterance); the utterances joined end to end classified and segmented
   by Endpointer, the spans equal to the CPU's (the same classifier moved
   to the CPU, and the CPU's own fit); the log-likelihoods' largest
   difference from the CPU's.
27. align_tp: align_time_parallel (8 chunks) of utterance 0 and of the
   first four utterances joined, K1 once each: the score against the
   card's sequential AlignSearch.align and each path re-summed on the
   host, within 4 T 2^-24 relative; ms against the sequential alignment;
   S, P and T.
28. multi_rank: parallel.dryrun.dryrun_multichip(1, "cuda") over a real
   NCCL group of one rank (the mesh dp=1 x mp=1): a sharded EM step
   against em_step, the -part/-npart accumulators against the single
   pass, and data-parallel decodes of the slice (mpx and tree; K1 four
   times) and of the SMALL semi-continuous fixture (PsParityScorer)
   gathered and held to the one-process decode.
29. senone_shards: parallel.senone_shard's shards, scored and joined by
   score_parts (the dry run's mp axis scored shard by shard on one card)
   at mp = 2 and 3: K1 on the shards of the slice's ContinuousScorer
   (S=5150, K=32, T=2000) in each mode, and PsParityScorer's epilogue on
   slices of its 8- and 4-bit mixture weights (S=5150, K=256, T=2000),
   each bit-equal to the unsharded scores (else the first index that
   differs); the ms of each of those shards' calls beside the unsharded
   call's (CUDA events).
30. tools: cli.tools fe over a control file of seeded PCM on the card,
   its cepstra held to `-platform cpu`'s within the decoder phase's
   bound; cli.lmtool train from the slice's transcripts to ARPA and
   cli.tools lm2fst of it (host only, timed).
31. mfu: utils.mfu's report for K1 at T=9,600 (phase 3's times) and
   PsParityScorer at T=2000 (phase 5's), beside the card's name and
   power limit.
32. graphs: every N-gram decode and stream above ran its frame loop
   through captured CUDA graphs (NgramSearch's default on the card).
   Here the slice (300 words, B=16), the 5,000-word flat composite batch
   and the 20,000-word tree (B=16), and the mpx and tree streams run
   graphed and eager (`NgramSearch._graphs = False`), in turns, on the
   same card: tapes bit-equal, hypotheses and DeviceNgram.calls equal;
   for each, ms a frame of the frame loop (`_viterbi` on the pass's
   senone scores), xRT, stream push -> partial p50 / p99, the device's
   busy ms (torch.profiler) and idle share over a 100-frame window, the
   search's captures and capture seconds, the graphs cached; and one
   replay of each batch's frame loop under
   torch.cuda.set_sync_debug_mode("error").

33. graphs_search: cold, mixed traffic through the grammar, alignment and
   phone-loop frame loops: the 16 utterances one at a time through
   Decoder(jsgf=) and Decoder(fsg=), with their transcripts (distinct
   lengths and state counts) through Decoder.align (and again with the
   aligner's state bucket off), and through PhoneLoopSearch; each graphed
   from an empty graph cache (cold), eager, and graphed again (warm: no
   capture), every result bit-equal to the eager run's, K1 once an
   utterance exactly; seconds of each, captures and their seconds, graphs
   held and their card memory (allocated, reserved), one replay of each
   search's frame loop under torch.cuda.set_sync_debug_mode("error"), and
   the device's events, busy ms and idle share over a PROFILE_FRAMES
   window of each frame loop, graphed and eager.

The CPU holds run in worker processes while the card goes on, so the
phases run in the order that hands the holds over first: the host builds
of 23-24 go to the workers first, then 1-3, 10, 15 (K1), 16, 20-22,
23-28, 9, 8, 12, 18, then 15 (the Decoder), 4, 11, 14, 17, 5, 29, 6, 7,
13, 30, 19 and 31; phase 32's cells are measured after 9, 12 and 11,
phase 33 after 17.

Then the kernel table {"kernels": [...]}, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Without CUDA it exits 1 before any result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import io
import functools
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch

from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.api import Decoder
from cmusphinx_tpu_torch.decode import NgramSearch
from cmusphinx_tpu_torch.decode import lattice as lattice_mod
from cmusphinx_tpu_torch.decode.align import AlignSearch
from cmusphinx_tpu_torch.decode.align_tp import _pred_table, align_time_parallel
from cmusphinx_tpu_torch.decode.phone_loop import PhoneLoopSearch
from cmusphinx_tpu_torch.frontend import FeatPipeline, Frontend, ep
from cmusphinx_tpu_torch.ops import (ContinuousScorer, PsParityScorer,
                                     SemiContinuousScorer, approx, fused_gmm,
                                     subvq)
from cmusphinx_tpu_torch.ops.fused_gmm import (fused_mixture_scores,
                                               fused_mixture_scores_ref)
from cmusphinx_tpu_torch.models.gauden import read_gauden
from cmusphinx_tpu_torch.models.mdef import Mdef
from cmusphinx_tpu_torch.models.tmat import TransitionMatrices
from cmusphinx_tpu_torch.train import bw, pipeline
from cmusphinx_tpu_torch.train.model_io import export_model
from cmusphinx_tpu_torch.train.semicont import SemiContTrainer
from cmusphinx_tpu_torch.train.sentence_hmm import FlatModel
from cmusphinx_tpu_torch.train.trainer import Trainer, device_params, host_acc
from cmusphinx_tpu_torch.train.transform import (class_scatter_stats,
                                                 estimate_mllt,
                                                 mllt_objective)
from cmusphinx_tpu_torch.cli import lmtool, tools
from cmusphinx_tpu_torch.parallel.dryrun import dryrun_multichip, free_port
from cmusphinx_tpu_torch.parallel.senone_shard import score_parts, shards
from cmusphinx_tpu_torch.utils import mfu, native, senfh
from cmusphinx_tpu_torch.utils.bio import read_mfc
from cmusphinx_tpu_torch.utils.bio import write_mfc

SEED = 0
S, K, D, T_K1 = 5150, 32, 39, 2000
# The main path's batch: 16 utterances padded to 600 frames.
T_MAIN = 16 * 600
MODES = ("highest", "high", "bf16")
# The widest depth of K1's one-instantiation-a-depth path, timed beside
# D=39: its depth 2D fills 128, and "highest" and "high" have one ring
# stage there.  Past it, the depth loop: D=78 (26 cepstra, 1s_c_d_dd) and
# D=150.
D_WIDE = 64
D_LOOP = (78, 150)
NCEP_WIDE = 26
GRAMMARS = ("jsgf", "fsg")
ALIGN_UTTS = 4
PL_WINDOW, PL_WEIGHT = 5, 3.0
TREE_COPIES, COPIES_UTTS = 2, 4
# The CPU tests' wide beams (tests/test_torch_cuda.py), for lattices of
# 100+ nodes an utterance.
WIDE_BEAMS = {"beam": 1e-120, "wbeam": 1e-100, "lw": 2.0}
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
# The CPU holds (see `Holds`): worker processes, torch threads each, and
# utterances of a batch a task.
HOLD_WORKERS, HOLD_THREADS, HOLD_UTTS = 3, 2, 4
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
# The training phases: the hub4-class continuous width (D=39, K=32) over
# TRAIN_UTTS utterances of the fixture, TRAIN_STEPS EM steps, the first
# TRAIN_DECODE_UTTS decoded by the exported model; the semi-continuous
# trainer at hub4wsj_sc_8k's codebook width; the CD pipeline split to
# PIPE_GAUSS Gaussians at its default iteration counts.
TRAIN_UTTS, TRAIN_K, TRAIN_STEPS, TRAIN_DECODE_UTTS = 64, 32, 3, 16
SEMI_TRAIN_K, SEMI_TRAIN_STEPS = 256, 2
PIPE_GAUSS = 32
# Card against CPU: each utterance's log-likelihood within rtol 1e-5; the
# accumulators within bw.posterior_rtol (float32 rounding of the
# log-domain recursion); a Viterbi path that differs a near-tie (both
# paths within 1e-6 relative, scored in float64); MLLT's rows (unit
# length: the objective ignores their scale) within 1e-3 and its
# objective within rtol 1e-5.  A history may not fall by more than 1e-4
# nats a frame (the reference's own EM test allows as much).
LLH_RTOL, TIE_RTOL, MLLT_ATOL, MLLT_OBJ_RTOL, EM_SLACK = (
    1e-5, 1e-6, 1e-3, 1e-5, 1e-4)
# Phases 23-28 at the slice's width: the masked selectors and SubVQ at
# T=T_APPROX frames; the Gaussian selector's VQ size (its default) and the
# BBI tree's depth and box radius (their defaults); SubVQ at the
# reference's default codebooks (3 subvectors of 256 codewords) with
# fewer k-means iterations and restarts than its 20 and 3, which take
# minutes of host time at this width; its shortlist beam.  The endpointer:
# components a class, EM steps, and a state machine that splits the
# joined utterances.  The time-parallel alignment's chunks.
T_APPROX = 2000
GS_CLUSTERS = 64
KD_DEPTH, KD_RADIUS = 6, 3.0
SUBVQ_NSV, SUBVQ_SIZE, SUBVQ_ITER, SUBVQ_RESTARTS, SUBVQ_BEAM = (
    3, 256, 4, 1, 10.0)
EP_COMP, EP_ITER = 4, 10
EP_SPANS = {"end_window": 20, "pad_before": 5, "pad_after": 5}
ALIGN_TP_CHUNKS = 8
# Phase 29: the mp shard counts (3 leaves a remainder of S=5150).
SHARD_MPS = (2, 3)
# Phase 30: seeded PCM files through `tools fe`, their seconds.
TOOLS_PCM_S = (1.0, 2.0, 3.0)
# Phase 32: timed passes of each frame loop (graphed, eager, in turns),
# and the frames of the window traced for the device's busy time.  Its
# traffic cells start from an empty graph cache: one utterance at a time
# in TRAFFIC_BUCKETS distinct 100-frame buckets (more than the searches
# cache at 8 graphs a search, and past two side-table sizes), then
# batches of mixed lengths (TRAFFIC_BATCHES: batch size -> batches).
GRAPH_PASSES = 2
PROFILE_FRAMES = 100
TRAFFIC_BUCKETS = 9
TRAFFIC_BATCHES = {4: 2, 16: 1}


# The host clock at the start of main: each phase's line carries the
# seconds since then (`elapsed_s`), so that the command time splits into
# phases.
_START = [time.perf_counter()]


def emit(obj) -> None:
    if "phase" in obj:
        obj["elapsed_s"] = time.perf_counter() - _START[0]
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
    """K1's units (nvcc, in parallel) and, beside them, the lattice phase's
    C++ host runtime (g++)."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(native.loaded)
        secs = fused_gmm.build()
        host_loaded = host.result()
    log = fused_gmm.library_path().with_suffix(".log").read_text()
    emit({"phase": "build", "seconds": round(secs, 3),
          "native_loaded": host_loaded,
          "library": fused_gmm.library_path().name,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln],
          # ptxas's advisories that it serialised wgmma (none expected).
          "wgmma_serialized": [ln.strip() for ln in log.splitlines()
                               if "wgmma" in ln]})


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
        if pk.dp > fused_gmm.NARROW_DP:
            r["frames_a_block"], r["a_staged_by_chunk"] = fused_gmm.plan(
                mode, pk.dp)
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


def sendumps(fx) -> tuple:
    """The fixture's 8-bit sendump bytes, and a 4-bit one: bytes of a
    16-entry codebook whose values up to 255 make the uint8 wrap happen."""
    raw8, meta = fixture.sendump_bytes(fx)
    assert meta["n_bits"] == 8
    rng = np.random.RandomState(SEED + 5)
    cb = np.sort(rng.choice(256, 16, replace=False)).astype(np.uint8)
    return raw8, cb[rng.randint(16, size=raw8.shape)]


def phase_semicont_scorer(dev, fx) -> dict:
    x_cpu = torch.as_tensor(semi_inputs(fx, T_SEMI))
    raw8, raw4 = sendumps(fx)
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
# The CPU holds.  A card's decode is held against the host CPU's run of the
# same search fed the card's own senone scores (every hold here: integer
# tape values equal, float values within rtol 1e-5 over the valid frames,
# words and segments equal), and utterance 0 against a CPU decode end to
# end.  The CPU runs take longer than the card's, so they run in worker
# processes (spawned, so they never touch CUDA) while the card goes on with
# the next phases; each phase hands its holds over (`Holds.submit`) and the
# phase "cpu_holds" collects them at the end, failing on any difference.
# The timed phases share the host's cores with these workers.
class CardScores(torch.nn.Module):
    """A scorer that returns given senone scores [B, Tpad, S], cut to the
    batch and frames it is asked for."""

    def __init__(self, scores: torch.Tensor):
        super().__init__()
        self.scores = scores

    def score(self, feats: torch.Tensor) -> torch.Tensor:
        return self.scores[: feats.shape[0], : feats.shape[1]]


class GivenScores(torch.nn.Module):
    """A scorer that returns the senone scores it was given, whatever the
    features (the CPU grammar search fed the card's scores)."""

    def __init__(self, scores: torch.Tensor):
        super().__init__()
        self.scores = scores

    def score(self, feats):
        return self.scores


def segs(h) -> list:
    return [(s.word, s.start_frame, s.end_frame) for s in h.segments]


def tape_diff(got, want) -> tuple:
    """(integer values differing, largest relative float difference) of
    two lists of arrays, pairwise of one shape."""
    int_diff, rel = 0, 0.0
    for x, y in zip(got, want):
        if x.dtype.kind == "f":
            rel = max(rel, float(np.max(np.abs(x - y) / np.maximum(
                np.abs(y), 1e-30), initial=0.0)))
        else:
            int_diff += int((x != y).sum())
    return int_diff, rel


def make_scorer(kind: str, fx, dev):
    """The slices' scorers: "cont" (ContinuousScorer, K1 on the card), "ps"
    (PsParityScorer over the fixture's sendump), and the approximate
    scorers around ContinuousScorer: "ds2" (DownsampledScorer, ds=2) and
    "cigmms7" (CigmmsScorer, ci_pbeam=7)."""
    if kind == "cont":
        return ContinuousScorer(fx.gauden, fx.ln_mixw, device=dev)
    if kind == "ds2":
        return approx.DownsampledScorer(make_scorer("cont", fx, dev), 2)
    if kind == "cigmms7":
        return approx.CigmmsScorer(make_scorer("cont", fx, dev),
                                   fx.mdef.cd2cisen, fx.mdef.n_ci_sen, 7.0,
                                   device=dev)
    raw, meta = fixture.sendump_bytes(fx)
    return PsParityScorer(fx.gauden, raw, fx.stream_slices(), topn=TOPN,
                          wrap_uint8=meta["n_bits"] == 4, device=dev)


# A worker's fixtures, CPU searches and Decoders, built once by key.
_WORKER = {}


def _worker_init(threads: int) -> None:
    torch.set_num_threads(threads)


def _cached(key, make):
    if key not in _WORKER:
        _WORKER[key] = make()
    return _WORKER[key]


def _cpu_search(spec, kind: str, kw: tuple):
    """Fixture `spec` = (seed, model, size) and its CPU NgramSearch."""
    def make():
        fx = _cached(spec, lambda: fixture.build(spec[0], model=spec[1],
                                                 size=spec[2]))
        return fx, NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                               make_scorer(kind, fx, "cpu"), device="cpu",
                               **dict(kw))
    return _cached((spec, kind, kw), make)


def hold_search_task(spec, kind, kw, rows, scores, feats, Ts, card_segs,
                     count_own: bool = True) -> dict:
    """A worker's hold of utterances of a card batch: the CPU search fed
    the card's senone scores [n, Tpad, S] (features [n, Tpad, D]) against
    the card's tape rows and segments.  With `count_own`, also counts the
    scores the CPU search's own scorer gives otherwise (reported, not
    held)."""
    t0 = time.perf_counter()
    _, cpu = _cpu_search(spec, kind, kw)
    E = cpu.E
    own, cpu.scorer = cpu.scorer, CardScores(torch.as_tensor(scores))
    try:
        hyps = cpu.decode_batch([feats[i, :T] for i, T in enumerate(Ts)])
    finally:
        cpu.scorer = own
    want = [t.numpy() for t in cpu._last_batch[0]]
    int_diff, rel = tape_diff(
        [x[i, :T * E] for x in rows for i, T in enumerate(Ts)],
        [y[i, :T * E] for y in want for i, T in enumerate(Ts)])
    out = {"utterances": len(Ts), "int_values_differing": int_diff,
           "float_max_rel_diff": rel,
           "hyps_equal": [segs(h) for h in hyps] == card_segs}
    if count_own:
        valid = np.arange(feats.shape[1])[None, :] < np.asarray(Ts)[:, None]
        with torch.inference_mode():
            differ = own.score(torch.as_tensor(feats)).numpy() != scores
        out["cpu_scores_differing"] = int((differ & valid[..., None]).sum())
        out["scores_compared"] = int(valid.sum()) * scores.shape[2]
    out["seconds"] = time.perf_counter() - t0
    return out


def hold_e2e_task(spec, kind, kw, row0, T0: int, card_segs) -> dict:
    """A worker's end-to-end hold: utterance 0 of fixture `spec` decoded on
    the CPU (its own features and scorer) against the card batch's row 0."""
    t0 = time.perf_counter()
    fx, cpu = _cpu_search(spec, kind, kw)
    fp = _cached(("fp", spec), lambda: FeatPipeline(fx.feat_config(),
                                                    device="cpu"))
    hyp = cpu.decode_batch_cep(fx.ceps[:1], fp)[0]
    E = cpu.E
    int_diff, rel = tape_diff([x[0, :T0 * E] for x in row0],
                              [y.numpy()[0, :T0 * E]
                               for y in cpu._last_batch[0]])
    return {"utterances": 1, "int_values_differing": int_diff,
            "float_max_rel_diff": rel, "hyps_equal": segs(hyp) == card_segs,
            "seconds": time.perf_counter() - t0}


def hold_grammar_task(paths: tuple, feats, scores, card_exits, card_segs
                      ) -> dict:
    """A worker's hold of one grammar utterance: the CPU Decoder's grammar
    search (model directory and grammar `paths`) fed the card's senone
    scores [T, S], against the card's exit tapes (`FsgSearch._last`)."""
    t0 = time.perf_counter()
    cpu = _cached(paths, lambda: Decoder(device="cpu", **dict(paths)))
    own = cpu.search.scorer
    cpu.search.scorer = GivenScores(torch.as_tensor(scores))
    try:
        hyp = cpu.search.decode(feats)
    finally:
        cpu.search.scorer = own
    int_diff, rel = tape_diff(card_exits, cpu.search._last[:4])
    return {"utterances": 1, "int_values_differing": int_diff,
            "float_max_rel_diff": rel, "hyps_equal": segs(hyp) == card_segs,
            "seconds": time.perf_counter() - t0}


def grammar_e2e_task(paths: tuple, mfc: str, card_segs) -> dict:
    """A worker's end-to-end grammar hold: one mfc file through the CPU
    Decoder against the card's segments."""
    t0 = time.perf_counter()
    cpu = _cached(paths, lambda: Decoder(device="cpu", **dict(paths)))
    return {"utterances": 1, "int_values_differing": 0,
            "float_max_rel_diff": 0.0,
            "hyps_equal": segs(cpu.decode_cep_file(mfc)) == card_segs,
            "seconds": time.perf_counter() - t0}


class Holds:
    """The CPU holds in flight: a spawned pool of HOLD_WORKERS processes of
    HOLD_THREADS torch threads each; every task is named by the phase (and
    part) whose output it holds."""

    def __init__(self):
        ctx = multiprocessing.get_context("spawn")
        self.pool = ctx.Pool(HOLD_WORKERS, _worker_init, (HOLD_THREADS,))
        self.jobs = []

    def submit(self, name: str, fn, *args) -> None:
        self.jobs.append((name, self.pool.apply_async(fn, args)))

    def finish(self) -> dict:
        """Wait for every hold; emit phase "cpu_holds" (per name: tasks,
        utterances, the differences, the workers' seconds) and fail on any
        difference."""
        t0 = time.perf_counter()
        out = {}
        for name, job in self.jobs:
            r = job.get()
            o = out.setdefault(name, {"tasks": 0, "utterances": 0,
                                      "int_values_differing": 0,
                                      "float_max_rel_diff": 0.0,
                                      "hyps_equal": True, "seconds": 0.0})
            o["tasks"] += 1
            for k in ("utterances", "int_values_differing", "seconds",
                      "cpu_scores_differing", "scores_compared"):
                if k in r:
                    o[k] = o.get(k, 0) + r[k]
            o["float_max_rel_diff"] = max(o["float_max_rel_diff"],
                                          r["float_max_rel_diff"])
            o["hyps_equal"] &= r["hyps_equal"]
            # The training holds judge themselves (`ok`) and carry their
            # measurements (`detail`).
            if "ok" in r:
                o["ok"] = o.get("ok", True) and r["ok"]
                o.setdefault("detail", []).append(r["detail"])
        res = {"phase": "cpu_holds", "workers": HOLD_WORKERS,
               "threads": HOLD_THREADS, "wait_s": time.perf_counter() - t0,
               "holds": out}
        emit(res)
        bad = {k: v for k, v in out.items() if v["int_values_differing"]
               or v["float_max_rel_diff"] > 1e-5 or not v["hyps_equal"]
               or not v.get("ok", True)}
        if bad:
            raise AssertionError(f"card and CPU decode differently: {bad}")
        return res

    def close(self, ok: bool) -> None:
        if ok:
            self.pool.close()
        else:
            self.pool.terminate()
        self.pool.join()


def submit_batch_holds(holds: Holds, name: str, spec, kind: str, kw: dict,
                       search, fp, fx, tapes, hyps, n: int,
                       e2e: bool = True, count_own: bool = True) -> None:
    """Hand a counted card batch (`tapes` [B, Tpad*E, ...] on the host,
    `hyps`) to the CPU holds: its first n utterances through the CPU
    search (`kind`'s scorer) fed the card's senone scores, HOLD_UTTS a
    task, and (`e2e`) utterance 0 end to end."""
    c, T, Ts = search._pad(fx.ceps)
    with torch.inference_mode():
        feats = fp._padded_kernel(c, T, True)
        scores = search.scorer.score(feats).cpu().numpy()
    feats = feats.cpu().numpy()
    kw = tuple(sorted(kw.items()))
    for lo in range(0, n, HOLD_UTTS):
        hi = min(n, lo + HOLD_UTTS)
        holds.submit(f"{name}/search", hold_search_task, spec, kind, kw,
                     [t[lo:hi] for t in tapes], scores[lo:hi], feats[lo:hi],
                     Ts[lo:hi], [segs(h) for h in hyps[lo:hi]], count_own)
    if e2e:
        holds.submit(f"{name}/e2e", hold_e2e_task, spec, kind, kw,
                     [t[:1] for t in tapes], Ts[0], segs(hyps[0]))


def phase_large_vocab(dev, card: str, name: str, spec, kind: str,
                      want_lex: str, want_lm: str, hold_utts: int | None,
                      holds: Holds) -> dict:
    """A large-vocabulary batch of fixture `spec` under `auto`, counted,
    timed and held against the CPU (its first `hold_utts` utterances, None:
    all)."""
    fx = fixture.build(spec[0], model=spec[1], size=spec[2])
    if hold_utts is None:
        hold_utts = len(fx.ceps)
    t0 = time.perf_counter()
    fp = FeatPipeline(fx.feat_config(), device=dev)
    search = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                         make_scorer(kind, fx, dev), device=dev)
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

    submit_batch_holds(holds, name, spec, kind, {}, search, fp, fx, tapes,
                       hyps, hold_utts)
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
           "cpu_hold_utterances": hold_utts}
    emit(out)
    return out, (fx, search, fp, tapes, hyps)


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
        x = x[: len(y)]
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


# ----------------------------------------------------------------------
# Phase "graphs": the N-gram frame loop through captured CUDA graphs
# (the default, which every phase above ran) against the eager loop
# (`NgramSearch._graphs = False`) on the same card, in turns.

def device_busy_ms(prof) -> tuple:
    """(device events, ms the card was busy): the union of the intervals
    of the trace's device events (an op and its kernel may both be
    listed; the union counts their time once)."""
    from torch.autograd import DeviceType
    iv = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in iv:
        if b > end:
            busy += b - max(a, end)
            end = b
    return len(iv), busy / 1e3


@contextlib.contextmanager
def frames_graphed(search, graphs: bool):
    """A search's frame loop graphed or eager (`_graphs = False`) for the
    block's duration."""
    search._graphs = graphs
    try:
        yield
    finally:
        search._graphs = True


@contextlib.contextmanager
def frame_loop(search, graphs: bool):
    """An N-gram search's frame loop graphed or eager for the block's
    duration; its LM calls counted from 0."""
    search.dlm.calls.clear()
    with frames_graphed(search, graphs):
        yield


def busy_and_idle(fn) -> dict:
    """The device's work in fn() (a short window: the trace's events are
    read back on the host): fn once to warm up (a capture, if it needs
    one), once on the host clock alone, then once under torch.profiler
    (device activity only).  The idle share is of that one profiled
    window: the device's busy ms in its trace over its own synchronised
    wall.  A busy time past the wall would be a clock or trace fault:
    the share is then None and `idle_share_flag` says why.  Tracing
    slows the host's launches, so that share reads high; the same busy
    ms over the untraced run's wall (`idle_share_untraced_wall`, None
    where the busy ms exceed it) reads low, as the trace's kernels run
    a little long."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    bare = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev, busy = device_busy_ms(prof)
    flag = ("no device event" if not ev else
            "busy past the wall" if busy > 1e3 * wall else None)
    return {"window_wall_ms": 1e3 * wall,
            "window_unprofiled_wall_ms": 1e3 * bare,
            "window_device_events": ev, "window_device_busy_ms": busy,
            "device_idle_share": None if flag else 1.0 - busy / (1e3 * wall),
            "idle_share_flag": flag,
            "idle_share_untraced_wall": None if flag or busy > 1e3 * bare
            else 1.0 - busy / (1e3 * bare)}


def release_graphs(search) -> dict:
    """Drop the search's captured graphs and their pool; the card memory
    they held (allocated: their static buffers; reserved: those and the
    pool), measured across the drop with the allocator's caches
    emptied."""
    import gc
    n = len(search._runner.cache)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    a0, r0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    search._runner.release()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    a1, r1 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    return {"graphs": n, "allocated_mb": (a0 - a1) / 2 ** 20,
            "reserved_mb": (r0 - r1) / 2 ** 20}


def graph_batch_cell(search, fp, fx, card: str) -> dict:
    """A batch cell graphed and eager, in turns: the decode's tapes
    bit-equal and its LM calls equal; the pass's wall (xRT) and the frame
    loop's (`_viterbi` on the pass's senone scores: ms a frame); the
    device's busy ms and idle share over the loop's first PROFILE_FRAMES
    frames (every frame runs the same fixed-shape ops); one replay of the
    frame loop under torch.cuda.set_sync_debug_mode("error"); the
    search's captures and capture seconds so far (the phase's decodes and
    streams took them)."""
    stats = dict(search._graph_stats)
    c, T, Ts = search._pad(fx.ceps)
    with torch.inference_mode():
        scores = search.scorer.score(fp._padded_kernel(c, T, True))
    valid = torch.arange(c.shape[1], device=c.device)[None, :] < T[:, None]
    frames = int(c.shape[1])
    res = {m: {"pass_s": [], "loop_s": []} for m in ("graphed", "eager")}
    for rep in range(GRAPH_PASSES):
        for m in ("graphed", "eager"):
            with frame_loop(search, m == "graphed"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                hyps = search.decode_batch_cep(fx.ceps, fp)
                torch.cuda.synchronize()
                res[m]["pass_s"].append(time.perf_counter() - t0)
                if rep == 0:
                    res[m]["tapes"] = [a.cpu().numpy()
                                       for a in search._last_batch[0]]
                    res[m]["segs"] = [segs(h) for h in hyps]
                    res[m]["lm_calls"] = dict(search.dlm.calls)
                with torch.inference_mode():
                    t0 = time.perf_counter()
                    search._viterbi(scores, valid)
                    torch.cuda.synchronize()
                    res[m]["loop_s"].append(time.perf_counter() - t0)
    w = min(PROFILE_FRAMES, frames)
    for m in ("graphed", "eager"):
        r = res[m]
        with frame_loop(search, m == "graphed"), torch.inference_mode():
            r.update(busy_and_idle(
                lambda: search._viterbi(scores[:, :w], valid[:, :w])))
        loop = statistics.median(r["loop_s"])
        r.update({"median_pass_s": statistics.median(r["pass_s"]),
                  "xRT": fx.audio_seconds / statistics.median(r["pass_s"]),
                  "ms_a_frame": 1e3 * loop / frames,
                  "window_frames": w})
    with torch.inference_mode():
        before = search._graph_stats["captures"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            search._viterbi(scores, valid)
            sync_free = True
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    g, e = res["graphed"], res["eager"]
    out = {"card": card, "utterances": len(Ts), "frames_padded": frames,
           "block_frames": search._block_len(len(Ts), frames),
           "audio_s": fx.audio_seconds,
           "captures": stats["captures"], "capture_s": stats["capture_s"],
           "graphs_cached": len(search._graph_cache),
           "replayed_without_capture":
               search._graph_stats["captures"] == before,
           "replay_sync_free": sync_free,
           "tapes_bit_equal": all(np.array_equal(a, b) for a, b in
                                  zip(g.pop("tapes"), e.pop("tapes"))),
           "segments_equal": g.pop("segs") == e.pop("segs"),
           "lm_calls_equal": g["lm_calls"] == e["lm_calls"],
           "graphed": g, "eager": e}
    return out


def graph_stream_cell(search, feats_list, utts, card: str) -> dict:
    """Streams graphed and eager, in turns (utterance by utterance): the
    tapes bit-equal, the finals and LM calls equal; push -> partial p50 /
    p99, streaming xRT, and the device's busy ms and idle share over the
    first PROFILE_FRAMES frames of utterance utts[0] streamed."""
    res = {m: {"lat_ms": [], "wall_s": 0.0, "tapes": [], "finals": [],
               "lm_calls": Counter()} for m in ("graphed", "eager")}
    for i in utts:
        for m in ("graphed", "eager"):
            r = res[m]
            with frame_loop(search, m == "graphed"):
                t0 = time.perf_counter()
                final, _, ms, _ = run_stream(search, feats_list[i], 3000)
                wall = time.perf_counter() - t0
                r["lm_calls"].update(search.dlm.calls)
            r["wall_s"] += wall
            r["lat_ms"] += [x[0] for x in ms]
            r["tapes"] += list(search._last[:6])
            r["finals"].append(segs(final))
    audio_s = sum(len(feats_list[i]) for i in utts) / 100.0
    head = feats_list[utts[0]][:PROFILE_FRAMES]
    for m in ("graphed", "eager"):
        r = res[m]
        with frame_loop(search, m == "graphed"):
            r.update(busy_and_idle(lambda: run_stream(search, head, 3000)))
        lat = np.array(r.pop("lat_ms"))
        r.update({"push_partial_ms_p50": float(np.percentile(lat, 50)),
                  "push_partial_ms_p99": float(np.percentile(lat, 99)),
                  "xRT": audio_s / r["wall_s"], "pushes": len(lat),
                  "lm_calls": dict(r["lm_calls"]),
                  "window_frames": len(head)})
    g, e = res["graphed"], res["eager"]
    return {"card": card, "utterances": len(utts), "audio_s": audio_s,
            "chunk_frames": T_STREAM,
            "graphs_cached": len(search._graph_cache),
            "tapes_bit_equal": all(np.array_equal(a, b) for a, b in
                                   zip(g.pop("tapes"), e.pop("tapes"))),
            "finals_equal": g.pop("finals") == e.pop("finals"),
            "lm_calls_equal": g["lm_calls"] == e["lm_calls"],
            "graphed": g, "eager": e}


def graph_shapes(search) -> list:
    """[batch, block frames, side-table frames (static and tree steps;
    else None)] of each graph the search holds."""
    return [[*g.inputs[0].shape[:2], g.carry[2].shape[1] // search.E
             if search._fast else None]
            for g in search._runner.cache.values()]


def traffic(fx, seed: int) -> list:
    """Cold, mixed-length traffic cut from the fixture's cepstra joined:
    one utterance in each of TRAFFIC_BUCKETS 100-frame buckets, one at a
    time in a seeded order, then TRAFFIC_BATCHES of utterances whose
    lengths fall in seeded buckets.  [(batch size, [cepstra])]."""
    pool = np.concatenate(fx.ceps)
    rng = np.random.default_rng(seed)

    def cut(bucket: int) -> np.ndarray:
        n = int(rng.integers(100 * bucket + 1, 100 * bucket + 101))
        i = int(rng.integers(0, len(pool) - n + 1))
        return pool[i: i + n]
    seq = [(1, [cut(int(b))]) for b in rng.permutation(TRAFFIC_BUCKETS)]
    for B, n in TRAFFIC_BATCHES.items():
        seq += [(B, [cut(int(b)) for b in
                     rng.integers(0, TRAFFIC_BUCKETS, B)])
                for _ in range(n)]
    return seq


def graph_traffic_cell(search, fp, seq, card: str, one=None) -> dict:
    """The traffic `seq` through the search from an empty graph cache:
    graphed (cold: every new shape captures), eager, then graphed again
    (warm: no capture may happen), each decode's tapes bit-equal to the
    eager run's.  Single utterances go through `one` (a Decoder's
    utterance API) where given, else `decode_batch_cep` as a batch of
    one.  Reports the wall of each part, the captures, their seconds and
    the graphs cached, and the card memory the graphs held; what the
    search's earlier cells left cached is released first and reported."""
    earlier = release_graphs(search)
    stats0 = dict(search._graph_stats)
    res = {}
    for m in ("graphed_cold", "eager", "graphed_warm"):
        walls = {}
        tapes, words = [], []
        before = dict(search._graph_stats)
        with frame_loop(search, m != "eager"):
            for B, ceps in seq:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if B == 1 and one is not None:
                    hyps = [one(ceps[0])]
                else:
                    hyps = search.decode_batch_cep(ceps, fp)
                torch.cuda.synchronize()
                key = f"B={B}"
                walls[key] = walls.get(key, 0.0) + time.perf_counter() - t0
                tapes.append([a.cpu().numpy()
                              for a in search._last_batch[0]])
                words.append([segs(h) for h in hyps])
        res[m] = {"wall_s": walls, "total_s": sum(walls.values()),
                  "captures": search._graph_stats["captures"]
                  - before["captures"],
                  "capture_s": search._graph_stats["capture_s"]
                  - before["capture_s"],
                  "replays": search._graph_stats["replays"]
                  - before["replays"],
                  "tapes": tapes, "segs": words}
    e = res["eager"]
    out = {"card": card, "decodes": len(seq),
           "batch_sizes": [B for B, _ in seq],
           "frames": [max(len(c) for c in ceps) for _, ceps in seq],
           "padded_frames": sum(-(-max(len(c) for c in ceps) // 100) * 100
                                for _, ceps in seq),
           "graphs_cached": len(search._graph_cache),
           "graph_shapes": graph_shapes(search),
           "earlier_graphs": earlier,
           "warm_replays_only": res["graphed_warm"]["captures"] == 0}
    for m in ("graphed_cold", "graphed_warm"):
        g = res[m]
        out[f"{m}_tapes_bit_equal"] = all(
            all(np.array_equal(a, b) for a, b in zip(x, y))
            for x, y in zip(g.pop("tapes"), e["tapes"]))
        out[f"{m}_segments_equal"] = g.pop("segs") == e["segs"]
    e.pop("tapes"), e.pop("segs")
    out["tapes_bit_equal"] = (out["graphed_cold_tapes_bit_equal"]
                              and out["graphed_warm_tapes_bit_equal"])
    out["segments_equal"] = (out["graphed_cold_segments_equal"]
                             and out["graphed_warm_segments_equal"])
    out.update(res)
    out["graph_memory"] = release_graphs(search)
    out["captures_total"] = search._graph_stats["captures"] - stats0[
        "captures"]
    return out


def decoder_traffic_cell(dev, fx, tmp: str, card: str) -> dict:
    """`graph_traffic_cell` through a new `Decoder` of the slice's model:
    single utterances by its utterance API (`start_utt`, `process_cep`,
    `end_utt`: what `decode_cep_file` runs after reading the file),
    batches by its search's `decode_batch_cep`."""
    dec = Decoder(device=dev, **fixture.write_model_dir(
        fx, os.path.join(tmp, "traffic")))

    def one(cep):
        dec.start_utt()
        dec.process_cep(cep)
        return dec.end_utt()
    g = dec.search.graph
    out = graph_traffic_cell(dec.search, dec.fp, traffic(fx, SEED), card,
                             one=one)
    out["graph"] = f"{g.rc_mode}/{g.lc_mode}/{g.lex_mode}"
    return out


def phase_graphs(cells: dict) -> dict:
    """Emit the cells of phase "graphs"; fail on any tape, hypothesis or
    LM-call difference between the graphed and the eager frame loop, on
    a replay that synchronised or captured, and on a warm traffic pass
    that captured."""
    out = {"phase": "graphs", "cells": cells}
    emit(out)
    keys = ("tapes_bit_equal", "segments_equal", "finals_equal",
            "lm_calls_equal", "replayed_without_capture", "replay_sync_free",
            "warm_replays_only")
    bad = {k: v for k, v in cells.items()
           if not all(v.get(x, True) for x in keys)}
    if bad:
        raise AssertionError(f"graphs: graphed and eager differ: {bad}")
    return out


# ----------------------------------------------------------------------
# Phase "graphs_search": the grammar, alignment and phone-loop frame loops
# through captured CUDA graphs (their default) against the eager blocks,
# on cold, mixed traffic: the slice's utterances one at a time, in their
# own lengths and state counts.

TRAFFIC_MODES = ("graphed_cold", "eager", "graphed_warm")


def search_traffic(get_search, items, run_one, same) -> dict:
    """`items` one at a time through `run_one`, in each of TRAFFIC_MODES
    (the first from an empty graph cache: every new shape captures); each
    result held to the eager run's (`same`), K1 counted (once an item,
    exactly).  `get_search()` is the search whose runner serves
    (None before a first call builds it).  The wall of each mode, its
    captures, their seconds and its replays."""
    res = {}
    for m in TRAFFIC_MODES:
        s = get_search()
        before = dict(s._runner.stats) if s is not None else {
            "captures": 0, "capture_s": 0.0, "replays": 0}
        outs = []
        fused_mixture_scores.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if m == "eager":
                stack.enter_context(frames_graphed(s, False))
            for x in items:
                outs.append(run_one(x))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = get_search()._runner.stats
        res[m] = {"wall_s": wall,
                  "k1_launches": fused_mixture_scores.launches,
                  **{k: st[k] - before[k]
                     for k in ("captures", "capture_s", "replays")},
                  "outs": outs}
    for m in TRAFFIC_MODES:
        res[m]["equal_to_eager"] = all(
            same(a, b) for a, b in zip(res[m]["outs"], res["eager"]["outs"]))
    for m in TRAFFIC_MODES:
        res[m].pop("outs")
    res["k1_exact"] = all(res[m]["k1_launches"] == len(items)
                          for m in TRAFFIC_MODES)
    return res


def replay_check(search, run) -> dict:
    """`run()` (a search's device-only `_scan`, its inputs on the card)
    once to warm up, then once under torch.cuda.set_sync_debug_mode
    ("error"): `replay_sync_free` (no host sync) and
    `replayed_without_capture` (no capture), as phase 32 reads them."""
    with torch.inference_mode():
        run()
        torch.cuda.synchronize()
        n = search._runner.stats["captures"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            run()
            ok = True
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    return {"replay_sync_free": ok,
            "replayed_without_capture": search._runner.stats["captures"] == n}


def search_windows(search, run) -> dict:
    """The device's work over one PROFILE_FRAMES window of a search's
    device-only `_scan` (`run`), graphed and eager (`busy_and_idle`):
    device events, busy ms and the idle share, each way."""
    out = {}
    for m in ("graphed", "eager"):
        with frames_graphed(search, m == "graphed"), torch.inference_mode():
            out[m] = busy_and_idle(run)
    return out


def phase_graphs_search(dev, fx, tmp: str, card: str) -> dict:
    """Cold, mixed traffic through the grammar Decoders (each of the
    slice's 16 utterances once, one at a time), `Decoder.align` (the 16
    with their transcripts: distinct lengths and state counts; then again
    with the state bucket off, STATE_BUCKET = 1, its graphed and eager
    cost beside the bucket's) and the phone loop (the 16): graphed cold,
    eager, graphed warm, each result held to the eager run's.  The
    graphs each search holds, their card memory, and one replay under the
    sync debug mode."""
    kw = fixture.write_model_dir(fx, os.path.join(tmp, "graphs_search"))
    mfcs = []
    for i, c in enumerate(fx.ceps):
        mfcs.append(os.path.join(tmp, "graphs_search", f"u{i}.mfc"))
        write_mfc(mfcs[-1], c)
    cells = {}
    for key in GRAMMARS:
        dec = Decoder(device=dev, hmm=kw["hmm"], dict=kw["dict"], **{
            key: os.path.join(tmp, "graphs_search", "grammar." + key)})
        search = dec.search

        def one(p):
            h = dec.decode_cep_file(p)
            return segs(h), [np.copy(a) for a in search._last[:4]]
        r = search_traffic(lambda: search, mfcs, one,
                           lambda a, b: a[0] == b[0]
                           and equal_arrays(a[1], b[1]))
        T = len(fx.ceps[0])
        with torch.inference_mode():
            sc = dec.scorer.score(torch.as_tensor(dec.fp.compute(fx.ceps[0]),
                                                  device=dev))
            padded = torch.cat([sc, sc.new_zeros(
                (-(-T // search.FRAME_BUCKET) * search.FRAME_BUCKET - T,
                 sc.shape[1]))])
        r.update(replay_check(search, lambda: search._scan(
            search._init_carry(), padded, 0, T)))
        r["window"] = search_windows(search, lambda: search._scan(
            search._init_carry(), sc[:PROFILE_FRAMES], 0, PROFILE_FRAMES))
        r["graphs_cached"] = len(search._runner.cache)
        r["graph_memory"] = release_graphs(search)
        cells[key] = r
    ad = Decoder(device=dev, **kw)
    feats = [ad.fp.compute(c) for c in fx.ceps]
    items = list(zip(feats, fx.transcripts))
    r = search_traffic(lambda: ad._aligner,
                       items, lambda x: ad.align(*x), same_alignment)
    al = ad._aligner
    b = al._build(fx.transcripts[0])
    hmm = al._pad_states(b[0], b[1], b[4], b[5])
    r.update(replay_check(al, lambda: al._scan(sc, *hmm)))
    r["window"] = search_windows(al, lambda: al._scan(
        sc[:PROFILE_FRAMES + 1], *hmm))
    r["graphs_cached"] = len(al._runner.cache)
    r["graph_memory"] = release_graphs(al)
    # The bucket's cost: the same traffic on the unpadded sentence HMMs
    # (one graph a state count).
    al.STATE_BUCKET = 1
    r["unpadded"] = search_traffic(lambda: al, items,
                                   lambda x: ad.align(*x), same_alignment)
    r["unpadded"]["graphs_cached"] = len(al._runner.cache)
    release_graphs(al)
    al.STATE_BUCKET = AlignSearch.STATE_BUCKET
    states = [len(al._build(w)[0]) for w in fx.transcripts]
    r.update({"state_bucket": al.STATE_BUCKET, "states": states,
              "padded_states": sorted({-(-n // al.STATE_BUCKET)
                                       * al.STATE_BUCKET for n in states})})
    cells["align"] = r
    loop = PhoneLoopSearch(fx.mdef, fx.tmat, ad.scorer, device=dev)
    r = search_traffic(lambda: loop, feats, loop._run, equal_arrays)
    r.update(replay_check(loop, lambda: loop._scan(sc)))
    r["window"] = search_windows(loop, lambda: loop._scan(
        sc[:PROFILE_FRAMES]))
    r["graphs_cached"] = len(loop._runner.cache)
    r["graph_memory"] = release_graphs(loop)
    cells["phone_loop"] = r
    frames = sum(len(c) for c in fx.ceps)
    out = {"phase": "graphs_search", "card": card, "utterances": len(mfcs),
           "frames": frames, "audio_s": frames / 100.0, "cells": cells}
    emit(out)
    bad = {k: v for k, v in cells.items()
           if not (v["replay_sync_free"] and v["replayed_without_capture"]
                   and v["k1_exact"]
                   and v["graphed_warm"]["captures"] == 0
                   and all(v[m]["equal_to_eager"] for m in TRAFFIC_MODES))}
    if cells["align"]["unpadded"]["graphed_warm"]["captures"] or not all(
            cells["align"]["unpadded"][m]["equal_to_eager"]
            for m in ("graphed_cold", "graphed_warm")):
        bad["align_unpadded"] = cells["align"]["unpadded"]
    if bad:
        raise AssertionError(f"graphs_search: graphed and eager differ: {bad}")
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


def phase_lattice(dev, search, fp, fx) -> dict:
    """Phase 4's batch with wide beams: each utterance's lattice and its
    rescoring."""
    if not native.loaded():
        raise AssertionError("the native runtime did not build or load")
    search = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, search.scorer,
                         device=dev, **WIDE_BEAMS)
    fused_mixture_scores.launches = 0
    hyps = search.decode_batch_cep(fx.ceps, fp)
    launches = fused_mixture_scores.launches
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
           "beams": WIDE_BEAMS, "k1_launches": launches,
           "viterbi_word_errors": sum(fixture.word_errors(r, h.words)
                                      for r, h in zip(fx.transcripts, hyps)),
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


# ----------------------------------------------------------------------
def phase_k1_wide(dev, exps: float) -> dict:
    """K1's depth loop at D=78 and D=150 (phase 3's checks and times)."""
    out = {}
    for d in D_LOOP:
        out[d] = check_k1(dev, floored=False, modes=MODES, exps_per_s=exps,
                          D=d)
        check_k1(dev, floored=True, modes=MODES, exps_per_s=exps,
                 timed=False, D=d)
    return out


def decode_ceps(dec, ceps) -> list:
    """Whole utterances of cepstra through a Decoder (any width: no mfc
    file, whose reader assumes 13 cepstra)."""
    out = []
    for c in ceps:
        dec.start_utt()
        dec.process_cep(c)
        out.append(dec.end_utt())
    return out


def phase_decoder_wide(dev, fx) -> dict:
    """The C2 case: a continuous model with D=78 through the Decoder."""
    with tempfile.TemporaryDirectory() as tmp:
        kw = fixture.write_model_dir(fx, tmp)
        t0 = time.perf_counter()
        dec = Decoder(device=dev, **kw)
        init_s = time.perf_counter() - t0
        if type(dec.scorer) is not ContinuousScorer or \
                dec.scorer.packed().dp != 160:
            raise AssertionError("the D=78 model did not load for K1")
        fused_mixture_scores.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hyps = decode_ceps(dec, fx.ceps[:DECODER_UTTS])
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        launches = fused_mixture_scores.launches
        cpu = decode_ceps(Decoder(device="cpu", **kw), fx.ceps[:1])[0]
    errs = sum(fixture.word_errors(r, h.words)
               for r, h in zip(fx.transcripts, hyps))
    out = {"phase": "decoder_wide", "S": fx.size.n_sen,
           "K": fx.size.n_density, "D": fx.gauden.veclen[0],
           "depth": dec.scorer.packed().dp, "utterances": len(hyps),
           "init_s": init_s, "decode_s": decode_s, "k1_launches": launches,
           "utt0_equal_to_cpu": segs(hyps[0]) == segs(cpu),
           "utt0_score_rel_diff": abs(hyps[0].score - cpu.score)
           / abs(cpu.score),
           "word_errors": errs,
           "ref_words": sum(len(r) for r in fx.transcripts[:len(hyps)])}
    emit(out)
    if launches != len(hyps) or not out["utt0_equal_to_cpu"] or \
            out["utt0_score_rel_diff"] > 1e-5:
        raise AssertionError(f"decoder_wide: {out}")
    return out


def grammar_pass(dec, search, mfcs) -> dict:
    """The utterances' files through the Decoder, one at a time: each
    one's host ms and CUDA-event ms, its segments and exit tapes."""
    out = {"host_ms": [], "dev_ms": [], "hyps": [], "exits": []}
    for p in mfcs:
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        h = dec.decode_cep_file(p)
        ev1.record()
        torch.cuda.synchronize()
        out["host_ms"].append(1e3 * (time.perf_counter() - t0))
        out["dev_ms"].append(ev0.elapsed_time(ev1))
        out["hyps"].append(h)
        out["exits"].append([np.copy(a) for a in search._last[:4]])
    return out


def grammar_stream(search, feats) -> dict:
    """One utterance through the FSG stream in CHUNK pushes, a partial
    after each: push -> partial ms (host clock; the partial reads the
    chunk's exits on the host, so it waits for the device), the final's
    segments and its exit tapes."""
    st = search.stream_start()
    lat, partials = [], []
    t_start = time.perf_counter()
    for i in range(0, len(feats), T_STREAM):
        t0 = time.perf_counter()
        search.stream_push(st, feats[i: i + T_STREAM])
        partials.append(search.stream_partial(st).words)
        lat.append(1e3 * (time.perf_counter() - t0))
    final = search.stream_end(st)
    return {"lat_ms": lat, "wall_s": time.perf_counter() - t_start,
            "partials": partials, "final": segs(final),
            "exits": [np.copy(a) for a in search._last[:4]]}


def summary(host_ms, dev_ms, frames: int) -> dict:
    return {"ms_per_utt_host": statistics.median(host_ms),
            "ms_per_utt_cuda_events": statistics.median(dev_ms),
            "host_ms_total": sum(host_ms),
            "ms_a_frame": sum(host_ms) / frames,
            "xRT": frames / 100.0 / (sum(host_ms) / 1e3)}


def phase_grammar(dev, fx, tmp: str, holds: Holds) -> dict:
    """The grammar path on the slice's model directory (written under
    `tmp`, which outlives the CPU holds): per grammar, 16 utterances
    through the Decoder, then the FSG stream of utterance 0 (the counted
    main path, graphed: the default); then the same 16 and the streams of
    utterances 0 .. STREAM_UTTS-1 eager (`_graphs = False`) and graphed
    again, in turns, every exit tape bit-equal."""
    out = {"phase": "grammar", "grammars": {}}
    launches = 0
    kw = fixture.write_model_dir(fx, os.path.join(tmp, "grammar"))
    mfcs = []
    for i, c in enumerate(fx.ceps):
        mfcs.append(os.path.join(tmp, "grammar", f"u{i}.mfc"))
        write_mfc(mfcs[-1], c)
    frames = sum(len(c) for c in fx.ceps)
    for key in GRAMMARS:
        g = {"hmm": kw["hmm"], "dict": kw["dict"],
             key: os.path.join(tmp, "grammar", "grammar." + key)}
        t0 = time.perf_counter()
        dec = Decoder(device=dev, **g)
        init_s = time.perf_counter() - t0
        search = dec.search
        # The main path, once, counted and timed.
        fused_mixture_scores.launches = 0
        main = grammar_pass(dec, search, mfcs)
        n = fused_mixture_scores.launches
        hyps, exits = main["hyps"], main["exits"]
        lat = dec.get_lattice()
        best, nb = lat.bestpath(), lat.nbest(5)
        # The grammar stream: utterance 0 in 50-frame pushes, counted.
        feats = dec.fp.compute(fx.ceps[0])
        fused_mixture_scores.launches = 0
        st = search.stream_start()
        partials = []
        for i in range(0, len(feats), T_STREAM):
            search.stream_push(st, feats[i: i + T_STREAM])
            partials.append(search.stream_partial(st).words)
        final = search.stream_end(st)
        ns = fused_mixture_scores.launches
        chunks = -(-len(feats) // T_STREAM)
        launches += n + ns
        # The CPU holds: utterance 0 end to end, and every utterance's
        # search on the card's senone scores against its exit tapes.
        paths = tuple(sorted(g.items()))
        holds.submit(f"grammar/{key}/e2e", grammar_e2e_task, paths, mfcs[0],
                     segs(hyps[0]))
        for i, c in enumerate(fx.ceps):
            feats = dec.fp.compute(c)
            with torch.inference_mode():
                scores = dec.scorer.score(
                    torch.as_tensor(feats, device=dev)).cpu().numpy()
            holds.submit(f"grammar/{key}/search", hold_grammar_task, paths,
                         feats, scores, exits[i], segs(hyps[i]))
        # Graphed against eager: the 16 utterances eager, then graphed
        # again (warm); streams of STREAM_UTTS utterances in turns.
        with frames_graphed(search, False):
            eager = grammar_pass(dec, search, mfcs)
        warm = grammar_pass(dec, search, mfcs)
        streams = {"graphed": [], "eager": []}
        for i in range(STREAM_UTTS):
            f = dec.fp.compute(fx.ceps[i])
            for m in ("graphed", "eager"):
                with frames_graphed(search, m == "graphed"):
                    streams[m].append(grammar_stream(search, f))
        stream_frames = sum(len(fx.ceps[i]) for i in range(STREAM_UTTS))
        both = {}
        for m, p in (("graphed", warm), ("eager", eager)):
            lat_ms = np.array([x for r in streams[m] for x in r["lat_ms"]])
            both[m] = {**summary(p["host_ms"], p["dev_ms"], frames),
                       "stream_push_partial_ms_p50":
                           float(np.percentile(lat_ms, 50)),
                       "stream_push_partial_ms_p99":
                           float(np.percentile(lat_ms, 99)),
                       "stream_xRT": stream_frames / 100.0
                       / sum(r["wall_s"] for r in streams[m])}
        errs = sum(fixture.word_errors(r, h.words)
                   for r, h in zip(fx.transcripts, hyps))
        r = {"links": search.n_link, "states": search.n_state,
             "channels": search.graph.n_chan,
             "rc_variants": search.graph.n_rcvar,
             "prune": search.prune, "init_s": init_s,
             "utterances": len(hyps), "k1_launches": n,
             **summary(main["host_ms"], main["dev_ms"], frames),
             "word_errors": errs,
             "ref_words": sum(len(t) for t in fx.transcripts),
             "lattice_nodes_alive": int(lat.alive.sum()),
             "bestpath_equal_viterbi": best.words == hyps[-1].words,
             "nbest": [h.text for h in nb],
             "cpu_hold_utterances": len(hyps),
             "stream_final_equal": segs(final) == segs(hyps[0]),
             "stream_partials": len(partials), "stream_chunks": chunks,
             "stream_k1_launches": ns,
             "block_frames": search.BLOCK,
             "graphs_cached": len(search._runner.cache),
             "graph_stats": dict(search._runner.stats),
             "exits_bit_equal": all(
                 equal_arrays(x, y) for p in (main, warm)
                 for x, y in zip(p["exits"], eager["exits"])),
             "segments_equal": all(
                 [segs(h) for h in p["hyps"]] == [segs(h) for h in
                                                   eager["hyps"]]
                 for p in (main, warm)),
             "stream_exits_bit_equal": all(
                 equal_arrays(x["exits"], y["exits"])
                 for x, y in zip(streams["graphed"], streams["eager"])),
             "stream_finals_equal": all(
                 (x["final"], x["partials"]) == (y["final"], y["partials"])
                 for x, y in zip(streams["graphed"], streams["eager"])),
             "graphed_warm": both["graphed"], "eager": both["eager"]}
        out["grammars"][key] = r
        if n != len(mfcs) or ns != chunks or \
                not r["stream_final_equal"] or not nb or \
                nb[0].words != best.words or not r["exits_bit_equal"] or \
                not r["segments_equal"] or not r["stream_exits_bit_equal"] \
                or not r["stream_finals_equal"] or r["graphs_cached"] != 1:
            emit(out)
            raise AssertionError(f"grammar {key}: {r}")
    out["k1_launches"] = launches
    emit(out)
    return out


def equal_arrays(a, b) -> bool:
    """Two lists of arrays equal bit for bit, type for type."""
    return len(a) == len(b) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))


def align_pass(dec, fx, utts) -> list:
    """Decoder.align of utterances `utts` with their transcripts: each
    one's host ms and result."""
    out = []
    for i in utts:
        feats = dec.fp.compute(fx.ceps[i])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = dec.align(feats, fx.transcripts[i])
        torch.cuda.synchronize()
        out.append((1e3 * (time.perf_counter() - t0), res))
    return out


def same_alignment(a, b) -> bool:
    """Two alignments' states, phone segments and scores equal."""
    return a[2] == b[2] and a[3] == b[3] and [
        (p.phone, p.start_frame, p.end_frame) for p in a[1]] == [
        (p.phone, p.start_frame, p.end_frame) for p in b[1]]


def phase_align_allphone(dev, fx) -> dict:
    """ALIGN_UTTS alignments through the Decoder (counted, graphed: the
    default) held to the CPU's, then eager (`_graphs = False`) and
    graphed again (warm), bit-equal; an -allphone decode against the
    CPU's."""
    with tempfile.TemporaryDirectory() as tmp:
        kw = fixture.write_model_dir(fx, tmp)
        gpu, cpu = Decoder(device=dev, **kw), Decoder(device="cpu", **kw)
        fused_mixture_scores.launches = 0
        main = align_pass(gpu, fx, range(ALIGN_UTTS))
        launches = fused_mixture_scores.launches
        rows = []
        for i, (ms, (ws, ps, states, score)) in enumerate(main):
            feats = gpu.fp.compute(fx.ceps[i])
            wc, pc, sc, scc = cpu.align(feats, fx.transcripts[i])
            rows.append({"frames": len(states), "ms": ms,
                         "states_equal": states == sc,
                         "phones_equal": [(p.phone, p.start_frame,
                                           p.end_frame) for p in ps]
                         == [(p.phone, p.start_frame, p.end_frame)
                             for p in pc],
                         "words": [w.word for w in ws] == fx.transcripts[i],
                         "score_rel_diff": abs(score - scc) / abs(scc)})
        aligner = gpu._aligner
        with frames_graphed(aligner, False):
            eager = align_pass(gpu, fx, range(ALIGN_UTTS))
        warm = align_pass(gpu, fx, range(ALIGN_UTTS))
        ap = {"hmm": kw["hmm"], "allphone": "uniform", "lw": 3.0}
        ga, ca = Decoder(device=dev, **ap), Decoder(device="cpu", **ap)
        feats = ga.fp.compute(fx.ceps[0])
        fused_mixture_scores.launches = 0
        t0 = time.perf_counter()
        h = ga.search.decode(feats)
        allphone_s = time.perf_counter() - t0
        launches += fused_mixture_scores.launches
        hc = ca.search.decode(feats)
    frames = sum(len(fx.ceps[i]) for i in range(ALIGN_UTTS))
    out = {"phase": "align_allphone", "align": rows, "k1_launches": launches,
           "state_bucket": aligner.STATE_BUCKET,
           "block_frames": aligner.BLOCK,
           "graphs_cached": len(aligner._runner.cache),
           "graph_stats": dict(aligner._runner.stats),
           "bit_equal_to_eager": all(
               same_alignment(x[1], y[1])
               for p in (main, warm) for x, y in zip(p, eager)),
           **{m: {"ms_per_utt": [x[0] for x in p],
                  "ms_a_frame": sum(x[0] for x in p) / frames}
              for m, p in (("graphed_cold", main), ("eager", eager),
                           ("graphed_warm", warm))},
           "allphone_phones": len(h.words), "allphone_s": allphone_s,
           "allphone_equal_to_cpu": segs(h) == segs(hc)}
    emit(out)
    if any(not (r["states_equal"] and r["phones_equal"] and r["words"]
                and r["score_rel_diff"] <= 1e-5) for r in rows) or \
            not out["allphone_equal_to_cpu"] or \
            not out["bit_equal_to_eager"] or launches != ALIGN_UTTS + 1:
        raise AssertionError(f"align_allphone: {out}")
    return out


def phase_ngram_options(dev, fx, spec, large, large_spec, holds: Holds
                        ) -> dict:
    """pl_window on the continuous slice, batch and stream; nlextree on the
    20,000-word tree; each batch held against the CPU search on the card's
    senone scores (`Holds`)."""
    out = {"phase": "ngram_options"}
    launches = 0
    fp = FeatPipeline(fx.feat_config(), device=dev)
    kw = {"pl_window": PL_WINDOW, "pl_weight": PL_WEIGHT}
    search = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                         ContinuousScorer(fx.gauden, fx.ln_mixw, device=dev),
                         device=dev, **kw)
    fused_mixture_scores.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hyps = search.decode_batch_cep(fx.ceps, fp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = fused_mixture_scores.launches
    tapes = [t.cpu().numpy() for t in search._last_batch[0]]
    submit_batch_holds(holds, "ngram_options/pl_window", spec, "cont", kw,
                       search, fp, fx, tapes, hyps, len(fx.ceps), e2e=False)
    # Two utterances streamed, K1 once a chunk; the frames before the last
    # pl_window - 1 look ahead over the same frames in the stream and in
    # the batch.
    feats_list = batch_features(search, fp, fx)
    fused_mixture_scores.launches = 0
    streams = []
    E, tail = search.E, PL_WINDOW - 1
    for i in range(2):
        final, partials, ms, st = run_stream(search, feats_list[i], 3000)
        T = search._last[6]
        h = hold_stream(search, final, partials, [t[:, : (T - tail) * E]
                                                  for t in tapes], i, hyps[i])
        streams.append(h)
    ns = fused_mixture_scores.launches
    chunks = sum(-(-len(feats_list[i]) // T_STREAM) for i in range(2))
    launches += n + ns
    errs = sum(fixture.word_errors(r, h.words)
               for r, h in zip(fx.transcripts, hyps))
    out["pl_window"] = {"window": PL_WINDOW, "weight": PL_WEIGHT,
                        "utterances": len(hyps), "k1_launches": n,
                        "decode_s": wall, "xRT": fx.audio_seconds / wall,
                        "word_errors": errs,
                        "cpu_hold_utterances": len(hyps), "streams": streams,
                        "stream_chunks": chunks, "stream_k1_launches": ns}

    # N tree copies on the 20,000-word tree.
    lfp = FeatPipeline(large.feat_config(), device=dev)
    tkw = {"lexmode": "tree", "nlextree": TREE_COPIES}
    tree = NgramSearch(large.lm, large.dict, large.mdef, large.tmat,
                       ContinuousScorer(large.gauden, large.ln_mixw,
                                        device=dev), device=dev, **tkw)
    if not (tree._tree and tree.nlextree == TREE_COPIES):
        raise AssertionError("the 20,000-word graph is not a tree")
    ceps = large.ceps[:COPIES_UTTS]
    sub = dataclasses.replace(large, ceps=ceps,
                              transcripts=large.transcripts[:COPIES_UTTS])
    fused_mixture_scores.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    thyps = tree.decode_batch_cep(ceps, lfp)
    torch.cuda.synchronize()
    twall = time.perf_counter() - t0
    tn = fused_mixture_scores.launches
    launches += tn
    ttapes = [t.cpu().numpy() for t in tree._last_batch[0]]
    submit_batch_holds(holds, "ngram_options/nlextree", large_spec, "cont",
                       tkw, tree, lfp, sub, ttapes, thyps, COPIES_UTTS,
                       e2e=False)
    audio = sum(len(c) for c in ceps) / 100.0
    out["nlextree"] = {
        "copies": TREE_COPIES, "channels": tree.graph.n_chan,
        "utterances": len(thyps), "k1_launches": tn, "decode_s": twall,
        "xRT": audio / twall,
        "word_errors": sum(fixture.word_errors(r, h.words)
                           for r, h in zip(sub.transcripts, thyps)),
        "ref_words": sum(len(r) for r in sub.transcripts),
        "cpu_hold_utterances": COPIES_UTTS}
    out["k1_launches"] = launches
    emit(out)
    bad = [h for h in streams if h["int_values_differing"]
           or h["float_max_rel_diff"] > 1e-5 or not h["final_equal"]]
    # One launch a batch, one a stream chunk.
    if bad or n != 1 or tn != 1 or ns != chunks:
        raise AssertionError(f"ngram_options: {out}")
    return out


# ----------------------------------------------------------------------
# The trainer.  Its CPU holds judge themselves: each returns `ok` and its
# measurements (`detail`) in the `Holds` schema.

def _train_verdict(ok: bool, detail: dict, t0: float, n: int) -> dict:
    return {"utterances": n, "int_values_differing": 0,
            "float_max_rel_diff": 0.0, "hyps_equal": True, "ok": bool(ok),
            "detail": detail, "seconds": time.perf_counter() - t0}


def _np_args(params, dtype=np.float32) -> tuple:
    return tuple(np.asarray(a, dtype) for a in (
        params.means, params.prec, params.lnw, params.log_tp))


def acc_error(got: dict, want: dict) -> dict:
    """Per accumulator, the least r with |got - want| <= r * (|want| +
    max|want| / 10): what the holds compare with bw.posterior_rtol."""
    out = {}
    for k in ("mixw", "mean", "var", "tmat"):
        g = np.asarray(got[k], np.float64)
        w = np.asarray(want[k], np.float64)
        out[k] = float(np.max(np.abs(g - w)
                              / (np.abs(w) + 0.1 * np.abs(w).max())))
    return out


def hold_train_pass(batch, args, card_llh, card_acc) -> dict:
    """A worker's hold of one forward-backward pass of the card: the same
    pass on the CPU (the port, float32)."""
    t0 = time.perf_counter()
    llh, acc = bw.forward_backward(batch, *args, device="cpu")
    llh, acc = llh.numpy(), host_acc(acc)
    rtol = bw.posterior_rtol(llh, batch.feats.shape[1])
    err = acc_error(card_acc, acc)
    llh_rel = float(np.max(np.abs(card_llh - llh) / np.abs(llh)))
    frames = int(card_acc["n_frames"]) == int(acc["n_frames"])
    return _train_verdict(
        llh_rel <= LLH_RTOL and max(err.values()) <= rtol and frames,
        {"llh_max_rel_diff": llh_rel, "acc_rel_err": err,
         "posterior_rtol": rtol, "n_frames_equal": frames,
         "within_rtol_1e-4": max(err.values()) <= 1e-4}, t0, len(llh))


def hold_train_viterbi(batch, args, card_scores, card_states) -> dict:
    """A worker's hold of the card's forced alignment: the CPU's scores,
    and every utterance whose path differs a near-tie (both paths scored
    in float64 within TIE_RTOL)."""
    t0 = time.perf_counter()
    scores, states = bw.viterbi_align(batch, *args, device="cpu")
    scores, states = scores.numpy(), states.numpy()
    differ = np.flatnonzero((states != card_states).any(1))
    tie_rel = []
    if len(differ):
        a64 = tuple(a.astype(np.float64) for a in args)
        a = bw.alignment_scores(batch, *a64, card_states,
                                device="cpu").numpy()
        c = bw.alignment_scores(batch, *a64, states, device="cpu").numpy()
        tie_rel = (np.abs(a - c) / np.abs(c))[differ].tolist()
    rel = float(np.max(np.abs(card_scores - scores) / np.abs(scores)))
    return _train_verdict(
        rel <= LLH_RTOL and all(r <= TIE_RTOL for r in tie_rel),
        {"score_max_rel_diff": rel, "utterances_differing": len(differ),
         "frames_differing": int((states != card_states).sum()),
         "near_tie_rel": tie_rel}, t0, len(scores))


def _mllt_objective64(A, stats) -> float:
    """MLLT's objective in float64 on the class stats, with the
    covariances `estimate_mllt` forms."""
    counts, sums, sqsums = stats
    ok = counts > 0
    mean = sums[ok] / counts[ok, None]
    cov = (sqsums[ok] / counts[ok, None, None]
           - np.einsum("ci,cj->cij", mean, mean)
           + 1e-6 * np.eye(sums.shape[1])[None])
    return float(mllt_objective(torch.as_tensor(A, dtype=torch.float64),
                                torch.as_tensor(cov),
                                torch.as_tensor(counts[ok])))


def hold_train_mllt(stats, card_A) -> dict:
    """A worker's hold of the card's MLLT: the CPU's A, row directions
    (the objective ignores the rows' lengths) and objectives."""
    t0 = time.perf_counter()
    A = estimate_mllt(*stats, device="cpu")

    def unit(M):
        M = np.asarray(M, np.float64)
        return M / np.linalg.norm(M, axis=1, keepdims=True)
    row = float(np.max(np.abs(unit(card_A) - unit(A))))
    obj = (_mllt_objective64(card_A, stats), _mllt_objective64(A, stats),
           _mllt_objective64(np.eye(A.shape[0]), stats))
    rel = abs(obj[0] - obj[1]) / abs(obj[1])
    return _train_verdict(
        row <= MLLT_ATOL and rel <= MLLT_OBJ_RTOL and obj[0] < obj[2],
        {"row_max_abs_diff": row,
         "raw_max_abs_diff": float(np.max(np.abs(card_A - A))),
         "objective_card_cpu_identity": obj, "objective_rel_diff": rel},
        t0, 0)


def train_decode_task(paths: tuple, mfcs: list, card_words: list) -> dict:
    """A worker's hold of decodes by the trained model: the CPU Decoder on
    the same directory and files, words equal (segments counted)."""
    t0 = time.perf_counter()
    cpu = _cached(paths, lambda: Decoder(device="cpu", **dict(paths)))
    hyps = [cpu.decode_cep_file(m) for m in mfcs]
    return _train_verdict(
        [h.words for h in hyps] == [w for w, _ in card_words],
        {"segments_differing": sum(segs(h) != s for h, (_, s)
                                   in zip(hyps, card_words))}, t0, len(mfcs))


def stage_pass(tr, dev) -> tuple:
    """One forward-backward at the trainer's parameters, after a pass that
    warms the card up, CUDA events around its stages: (llh, acc, {stage:
    ms})."""
    tr.accumulate()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    ev[0].record()
    p = bw.fb_forward(tr.dbatch, *device_params(tr.params, dev), device=dev)
    ev[1].record()
    bw.fb_backward(p)
    ev[2].record()
    llh, acc = bw.fb_accumulate(p)
    ev[3].record()
    torch.cuda.synchronize()
    return llh, acc, {k: ev[i].elapsed_time(ev[i + 1]) for i, k in enumerate(
        ("forward", "backward", "accumulate"))}


def profile_pass(tr, dev) -> dict:
    """One forward-backward under torch.profiler: device events, events a
    frame step (both directions), and the device's busy share of the
    pass's wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    args = device_params(tr.params, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bw.forward_backward(tr.dbatch, *args, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e6
    steps = 2 * (tr.batch.feats.shape[1] - 1)
    return {"device_events": len(ev), "events_per_frame_step": len(ev) / steps,
            "profiled_wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall}


def timed_em_steps(tr, n: int) -> list:
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.em_step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def fell(hist) -> bool:
    return any(b < a - EM_SLACK for a, b in zip(hist, hist[1:]))


def phase_train(dev, holds: Holds, tmp: str) -> dict:
    """The trainer at the hub4-class continuous width: TRAIN_UTTS
    utterances, a CI model (39 phones + SIL, 3 states: 120 senones) at
    K=32, EM on the card; its step 1, alignment and MLLT held against the
    CPU; the exported model decoded through Decoder(device="cuda")."""
    t0 = time.perf_counter()
    fx = fixture.build(SEED, size=dataclasses.replace(fixture.FULL,
                                                      n_utt=TRAIN_UTTS))
    feats = FeatPipeline(fx.feat_config(), device=dev).compute_batch(fx.ceps)
    phones, pron = fixture.train_corpus(fx)
    model = FlatModel.create(phones)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(model, pron, fx.transcripts, feats, K=TRAIN_K, device=dev)
    setup_s = time.perf_counter() - t0
    # Step 1's pass at the flat start, its stages timed, held on the CPU.
    llh1, acc1, stage_ms = stage_pass(tr, dev)
    holds.submit("train/step1", hold_train_pass, tr.batch, _np_args(tr.params),
                 llh1.cpu().numpy(), host_acc(acc1))
    step1 = float(llh1.sum()) / int(acc1["n_frames"])
    del acc1
    prof = profile_pass(tr, dev)
    walls = timed_em_steps(tr, TRAIN_STEPS)
    peak = peak_mb()
    hist = tr.history
    # The alignment at the final parameters, and MLLT on its senones.
    scores, states = bw.viterbi_align(tr.dbatch, *device_params(tr.params,
                                                                dev),
                                      device=dev)
    states = states.cpu().numpy()
    holds.submit("train/viterbi", hold_train_viterbi, tr.batch,
                 _np_args(tr.params), scores.cpu().numpy(), states)
    labels = np.concatenate([tr.batch.state_sen[b][states[b, :T]]
                             for b, T in enumerate(tr.batch.T)])
    stats = class_scatter_stats(np.concatenate(feats), labels, model.n_sen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    A = estimate_mllt(*stats, device=dev)
    mllt_s = time.perf_counter() - t1
    holds.submit("train/mllt", hold_train_mllt, stats, A)
    # The exported model beside the fixture's LM and dictionary, decoded.
    base = os.path.join(tmp, "train")
    hmm = os.path.join(base, "hmm")
    export_model(hmm, model, tr.params)
    with open(os.path.join(hmm, "noisedict"), "w") as fh:
        fh.write("<s> SIL\n</s> SIL\n<sil> SIL\n")
    kw = {"hmm": hmm, "lm": os.path.join(base, "lm.arpa"),
          "dict": os.path.join(base, "words.dict")}
    fx.lm.write_arpa(kw["lm"])
    with open(kw["dict"], "w") as fh:
        fh.writelines(f"{w} {' '.join(p)}\n" for w, p in pron.items())
    dec = Decoder(device=dev, **kw)
    mfcs = []
    for i, c in enumerate(fx.ceps[:TRAIN_DECODE_UTTS]):
        mfcs.append(os.path.join(base, f"u{i}.mfc"))
        write_mfc(mfcs[-1], c)
    fused_mixture_scores.launches = 0
    hyps = [dec.decode_cep_file(m) for m in mfcs]
    n = fused_mixture_scores.launches
    paths = tuple(sorted(kw.items()))
    for lo in range(0, len(mfcs), HOLD_UTTS):
        holds.submit("train/decode", train_decode_task, paths,
                     mfcs[lo: lo + HOLD_UTTS],
                     [(h.words, segs(h)) for h in hyps[lo: lo + HOLD_UTTS]])
    refs = fx.transcripts[:TRAIN_DECODE_UTTS]
    errs = sum(fixture.word_errors(r, h.words) for r, h in zip(refs, hyps))
    frames = int(tr.batch.T.sum())
    em_ms = 1e3 * statistics.median(walls)
    out = {"phase": "train", "utterances": len(feats), "frames": frames,
           "frames_padded": int(tr.batch.feats.shape[1]),
           "states_max": int(tr.batch.state_sen.shape[1]),
           "senones": model.n_sen, "K": TRAIN_K, "D": int(feats[0].shape[1]),
           "setup_s": setup_s, "history": hist, "step1_per_frame": step1,
           "em_step_ms": [1e3 * w for w in walls],
           "em_step_ms_median": em_ms, "pass_ms_cuda_events": stage_ms,
           "bw_frames_per_s": frames / (em_ms / 1e3),
           **prof, "peak_mb": peak, "viterbi_score_mean_per_frame":
           float(scores.sum()) / frames, "mllt_s": mllt_s,
           "decoded": len(hyps), "k1_launches": n, "word_errors": errs,
           "ref_words": sum(len(r) for r in refs),
           "wer": errs / sum(len(r) for r in refs)}
    emit(out)
    if fell(hist) or abs(hist[0] - step1) > 1e-6 * abs(step1) or \
            n != len(mfcs) or not all(np.isfinite(hist)):
        raise AssertionError(f"train: {out}")
    return out


@contextlib.contextmanager
def stage_seconds():
    """Host seconds of the CD pipeline's EM (the CI Trainer's steps and
    `em_loop`: the pass on the card and the host reestimation) and of its
    tying (`tie_states`, on the host), by wrapping them for the duration."""
    secs = {"em_s": 0.0, "tie_s": 0.0}

    def wrap(fn, key):
        @functools.wraps(fn)
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                secs[key] += time.perf_counter() - t0
        return timed
    saved = (pipeline.em_loop, pipeline.tie_states, Trainer.em_step)
    pipeline.em_loop = wrap(saved[0], "em_s")
    pipeline.tie_states = wrap(saved[1], "tie_s")
    Trainer.em_step = wrap(saved[2], "em_s")
    try:
        yield secs
    finally:
        pipeline.em_loop, pipeline.tie_states, Trainer.em_step = saved


def phase_train_pipeline(dev, fx, tmp: str) -> dict:
    """train_full_pipeline on the slice's 16 utterances, split to
    PIPE_GAUSS Gaussians, every EM on the card; its export read back."""
    phones, pron = fixture.train_corpus(fx)
    model = FlatModel.create(phones)
    feats = FeatPipeline(fx.feat_config(), device=dev).compute_batch(fx.ceps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with stage_seconds() as secs:
        inv, smap, tied, hist = pipeline.train_full_pipeline(
            model, pron, fx.transcripts, feats, gauss=PIPE_GAUSS,
            device=dev)
    wall = time.perf_counter() - t0
    d = os.path.join(tmp, "train_cd")
    pipeline.export_cd_model(d, inv, smap, tied)
    mdef = Mdef.read(os.path.join(d, "mdef"))
    g = read_gauden(os.path.join(d, "means"), os.path.join(d, "variances"))
    tm = TransitionMatrices.read(os.path.join(d, "transition_matrices"))
    n_tied = tied.means.shape[0]
    out = {"phase": "train_pipeline", "utterances": len(feats),
           "triphones": inv.n_tri, "untied_senones": inv.n_sen,
           "tied_senones": n_tied, "K": int(tied.means.shape[1]),
           "em_steps": {k: len(h) for k, h in hist.items()},
           "history": hist, "wall_s": wall, "em_s": secs["em_s"],
           "tie_s": secs["tie_s"], "peak_mb": peak_mb(),
           "readback": {"n_phone": mdef.n_phone, "n_sen": mdef.n_sen,
                        "n_mgau": g.n_mgau, "n_tmat": tm.n_tmat,
                        "bakis": bool(tm.check_bakis())}}
    emit(out)
    falls = [k for k, h in hist.items() if fell(h)]
    if falls or tied.means.shape[1] != PIPE_GAUSS or \
            mdef.n_phone != len(phones) + inv.n_tri or \
            mdef.n_sen != n_tied or g.n_mgau != n_tied or \
            not tm.check_bakis():
        raise AssertionError(f"train_pipeline: stages fell {falls}, {out}")
    return out


def phase_train_semicont(dev, fx, holds: Holds) -> dict:
    """SemiContTrainer at hub4wsj_sc_8k's codebook width (K=256) on the
    slice's 16 utterances: step 1 held against the CPU, then
    SEMI_TRAIN_STEPS EM steps."""
    phones, pron = fixture.train_corpus(fx)
    feats = FeatPipeline(fx.feat_config(), device=dev).compute_batch(fx.ceps)
    t0 = time.perf_counter()
    tr = SemiContTrainer(FlatModel.create(phones), pron, fx.transcripts,
                         feats, K=SEMI_TRAIN_K, device=dev)
    init_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    llh1, acc1, stage_ms = stage_pass(tr, dev)
    holds.submit("train_semicont/step1", hold_train_pass, tr.batch,
                 _np_args(tr.params), llh1.cpu().numpy(), host_acc(acc1))
    step1 = float(llh1.sum()) / int(acc1["n_frames"])
    del acc1
    walls = timed_em_steps(tr, SEMI_TRAIN_STEPS)
    frames = int(tr.batch.T.sum())
    out = {"phase": "train_semicont", "utterances": len(feats),
           "frames": frames, "K": SEMI_TRAIN_K, "kmeans_init_s": init_s,
           "history": tr.history, "pass_ms_cuda_events": stage_ms,
           "em_step_ms": [1e3 * w for w in walls],
           "bw_frames_per_s": frames / statistics.median(walls),
           "peak_mb": peak_mb()}
    emit(out)
    if fell(tr.history) or abs(tr.history[0] - step1) > 1e-6 * abs(step1):
        raise AssertionError(f"train_semicont: {out}")
    return out


# ----------------------------------------------------------------------
# The rest of the device code (phases 23-28): approximate and replayed
# scoring, the endpointer, time-parallel alignment and the multi-process
# dry run, at the continuous slice's width (fixture.build(0)).  The host
# builds of the selectors and of the subvq codebooks run in the hold
# workers from the start of the run (`submit_builds`).
def build_task(what: str, spec) -> tuple:
    """A worker's host build on fixture `spec`: "gs" the Gaussian
    selector's VQ (`approx.vq_codebook`), "kd" the BBI tree
    (`approx.bbi_tree`), "subvq" the sub-vector codebooks
    (`subvq.build_subvq`).  Returns (result, seconds)."""
    t0 = time.perf_counter()
    fx = _cached(spec, lambda: fixture.build(spec[0], model=spec[1],
                                             size=spec[2]))
    if what == "gs":
        out = approx.vq_codebook(fx.gauden, GS_CLUSTERS, SEED)
    elif what == "kd":
        out = approx.bbi_tree(fx.gauden, KD_DEPTH, KD_RADIUS)
    else:
        out = subvq.build_subvq(fx.gauden, n_sv=SUBVQ_NSV,
                                vqsize=SUBVQ_SIZE, n_iter=SUBVQ_ITER,
                                seed=SEED, n_restarts=SUBVQ_RESTARTS)
    return out, time.perf_counter() - t0


def submit_builds(holds: Holds, spec) -> dict:
    return {what: holds.pool.apply_async(build_task, (what, spec))
            for what in ("subvq", "gs", "kd")}


def magnitude_cpu(x, sc, rows: int = 250) -> np.ndarray:
    """M[t, s] = max_k |const| + |x|.|lin| + x^2.quad of a CPU
    ContinuousScorer, float64, in frame blocks."""
    S_, K_ = sc.n_sen, sc.n_density
    lin = sc.lin.double().reshape(S_ * K_, -1)
    quad = sc.quad.double().reshape(S_ * K_, -1)
    const = sc.const.double().reshape(1, S_ * K_).abs()
    out = []
    for lo in range(0, len(x), rows):
        xb = torch.as_tensor(x[lo: lo + rows]).double()
        out.append((const + xb.abs() @ lin.abs().T + (xb * xb) @ quad.T)
                   .view(-1, S_, K_).amax(-1).numpy())
    return np.concatenate(out)


def hold_masked_task(spec, what: str, built, x, card_scores, card_mask
                     ) -> dict:
    """A worker's hold of a masked selector on the card ("gs": kept
    clusters a frame, "kd": the kd-tree leaf a frame): the same selector
    on the CPU over the same codebook or tree.  The masks' differences are
    counted (the kd-tree's leaves compare the same f32 values and must be
    equal); where a frame's masks agree, the scores within D * 2^-22 * M
    plus 1e-5 relative (IEEE f32 products on both sides, sums, exp and log
    in another order)."""
    t0 = time.perf_counter()
    fx = _cached(spec, lambda: fixture.build(spec[0], model=spec[1],
                                             size=spec[2]))
    sc = _cached((spec, "cont-scorer"),
                 lambda: ContinuousScorer(fx.gauden, fx.ln_mixw,
                                          device="cpu"))
    xt = torch.as_tensor(x)
    with torch.inference_mode():
        if what == "gs":
            cpu = approx.GsSelectorScorer(sc, fx.gauden, codebook=built,
                                          device="cpu")
            mask = cpu.clusters(xt).numpy()
            agree = (mask == card_mask).all(1)
        else:
            cpu = approx.KdTreeSelectorScorer(sc, fx.gauden, KD_DEPTH,
                                              tree=built, device="cpu")
            mask = cpu.leaves(xt).numpy()
            agree = mask == card_mask
        want = cpu.score(xt).numpy().astype(np.float64)
    bound = (x.shape[1] * 2.0 ** -22 * magnitude_cpu(x, sc)
             + 1e-5 * np.abs(want))
    err = np.abs(card_scores - want)[agree]
    worst = float((err / bound[agree]).max(initial=0.0))
    n_diff = int((~agree).sum())
    return _train_verdict(worst <= 1.0 and (what == "gs" or n_diff == 0),
                          {"scorer": what, "frames": len(x),
                           "mask_frames_differing": n_diff,
                           "max_abs_err": float(err.max(initial=0.0)),
                           "worst_err_over_bound": worst}, t0, 0)


def hold_subvq_task(spec, svq, x, card_scores, card_sl, beam: float
                    ) -> dict:
    """A worker's hold of SubVQScorer on the card: the CPU's codeword
    densities, scores within 3 * 2^-20 * max|density| plus 1e-5 relative
    (f32 products and sums in another order, as
    tests/test_torch_subvq_senfh.py), and the shortlist's differences
    counted, each within twice that bound of the beam's edge."""
    t0 = time.perf_counter()
    fx = _cached(spec, lambda: fixture.build(spec[0], model=spec[1],
                                             size=spec[2]))
    sc = subvq.SubVQScorer(svq, fx.ln_mixw, device="cpu")
    xt = torch.as_tensor(x)
    with torch.inference_mode():
        tol = 3 * 2.0 ** -20 * float(sc.codeword_densities(xt).abs().max())
        want = sc.score(xt).numpy().astype(np.float64)
        sl = sc.shortlist(xt, beam).numpy()
        ga = sc.gaussian_approx(xt).numpy()
    card_sl = np.unpackbits(card_sl, count=sl.size).reshape(sl.shape) != 0
    err = np.abs(card_scores - want)
    worst = float((err / (tol + 1e-5 * np.abs(want))).max())
    differ = sl != card_sl
    edge = ga.max((1, 2), keepdims=True) - beam
    off_edge = int((differ & (np.abs(ga - edge) > 2 * tol)).sum())
    return _train_verdict(worst <= 1.0 and off_edge == 0,
                          {"frames": len(x), "max_abs_err": float(err.max()),
                           "worst_err_over_bound": worst,
                           "shortlist_entries_differing": int(differ.sum()),
                           "of_them_off_the_edge": off_edge,
                           "shortlist_entries": int(sl.sum())}, t0, 0)


def approx_frames(fx, dev, n: int = T_APPROX) -> np.ndarray:
    """The first n frames of the fixture's utterances joined (features
    computed on the card)."""
    fp = FeatPipeline(fx.feat_config(), device=dev)
    return np.concatenate(fp.compute_batch(fx.ceps))[:n]


def timed_scorer(sc, x) -> dict:
    """ms a call at x's shape (CUDA events, 3 calls after one warm-up) and
    the peak device MB of a call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        sc.score(x)
        torch.cuda.synchronize()
        peak = peak_mb()
        ms = cuda_ms(lambda: sc.score(x), reps=3)
    return {"ms": ms, "peak_mb": peak}


def decode_counted(search, fp, fx) -> tuple:
    """The batch through decode_batch_cep, counted: (hyps, host tapes, K1
    launches, wall s, WER dict)."""
    torch.cuda.synchronize()
    fused_mixture_scores.launches = 0
    t0 = time.perf_counter()
    hyps = search.decode_batch_cep(fx.ceps, fp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_mixture_scores.launches
    tapes = [t.cpu().numpy() for t in search._last_batch[0]]
    errs = sum(fixture.word_errors(r, h.words)
               for r, h in zip(fx.transcripts, hyps))
    n_ref = sum(len(r) for r in fx.transcripts)
    return hyps, tapes, launches, {
        "decode_s": wall, "xRT": fx.audio_seconds / wall,
        "word_errors": errs, "ref_words": n_ref, "wer": errs / n_ref}


def phase_approx(dev, fx, spec, holds: Holds, builds: dict) -> dict:
    """The batch through DownsampledScorer(ds=2) and CigmmsScorer
    (ci_pbeam=7) around ContinuousScorer (K1 once a batch), held against
    the CPU search on the card's senone scores; GS and KdTree at
    T=T_APPROX held against the CPU; every scorer's ms and peak MB."""
    fp = FeatPipeline(fx.feat_config(), device=dev)
    base = ContinuousScorer(fx.gauden, fx.ln_mixw, device=dev)
    out = {"phase": "approx", "decodes": {}, "T": T_APPROX}
    scorers = {}
    launches = 0
    for kind in ("ds2", "cigmms7"):
        sc = scorers[kind] = (
            approx.DownsampledScorer(base, 2) if kind == "ds2" else
            approx.CigmmsScorer(base, fx.mdef.cd2cisen, fx.mdef.n_ci_sen,
                                7.0, device=dev))
        search = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, sc, device=dev)
        hyps, tapes, n, r = decode_counted(search, fp, fx)
        launches += n
        out["decodes"][kind] = {"k1_launches": n, **r}
        if n != 1:
            emit(out)
            raise AssertionError(f"approx {kind}: K1 launched {n} times")
        submit_batch_holds(holds, f"approx/{kind}", spec, kind, {}, search,
                           fp, fx, tapes, hyps, len(fx.ceps), e2e=False)
        del search, tapes
    x_host = approx_frames(fx, dev)
    x = torch.as_tensor(x_host, device=dev)
    (cb, gs_s), (tree, kd_s) = builds["gs"].get(), builds["kd"].get()
    scorers["gs"] = approx.GsSelectorScorer(base, fx.gauden, codebook=cb,
                                            device=dev)
    scorers["kd"] = approx.KdTreeSelectorScorer(base, fx.gauden, KD_DEPTH,
                                                tree=tree, device=dev)
    with torch.inference_mode():
        for what, mask in (("gs", "clusters"), ("kd", "leaves")):
            sc = scorers[what]
            holds.submit(f"approx/{what}", hold_masked_task, spec, what,
                         cb if what == "gs" else tree, x_host,
                         sc.score(x).double().cpu().numpy(),
                         getattr(sc, mask)(x).cpu().numpy())
    out["host_build_s"] = {"gs": gs_s, "kd": kd_s}
    out["scorers"] = {k: timed_scorer(sc, x) for k, sc in scorers.items()}
    out["scorers"]["cont"] = timed_scorer(base, x)
    out["k1_launches"] = launches
    out["kd_leaf_shortlist_mean"] = float(
        scorers["kd"].leaf_keep.float().mean())
    emit(out)
    return out


def phase_subvq(dev, fx, spec, holds: Holds, builds: dict) -> dict:
    """build_subvq at the full width (in a hold worker), SubVQScorer and
    its shortlist on the card against the CPU, then the batch decoded with
    it as the scorer (held against the CPU search on its scores)."""
    svq, build_s = builds["subvq"].get()
    sc = subvq.SubVQScorer(svq, fx.ln_mixw, device=dev)
    x_host = approx_frames(fx, dev)
    x = torch.as_tensor(x_host, device=dev)
    with torch.inference_mode():
        scores = sc.score(x).double().cpu().numpy()
        sl = sc.shortlist(x, SUBVQ_BEAM).cpu().numpy()
    holds.submit("subvq/scores", hold_subvq_task, spec, svq, x_host, scores,
                 np.packbits(sl), SUBVQ_BEAM)
    timed = timed_scorer(sc, x)
    fp = FeatPipeline(fx.feat_config(), device=dev)
    search = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, sc, device=dev)
    torch.cuda.reset_peak_memory_stats()
    hyps, tapes, n, r = decode_counted(search, fp, fx)
    decode_peak = peak_mb()
    submit_batch_holds(holds, "subvq", spec, "cont", {}, search, fp,
                       fx, tapes, hyps, len(fx.ceps), e2e=False,
                       count_own=False)
    out = {"phase": "subvq", "n_sv": svq.n_sv, "vqsize": svq.vqsize,
           "n_iter": SUBVQ_ITER, "n_restarts": SUBVQ_RESTARTS,
           "defaults": {"n_iter": 20, "n_restarts": 3},
           "host_build_s": build_s, "T": T_APPROX, "beam": SUBVQ_BEAM,
           "shortlist_share": float(sl.mean()), **timed,
           "decode": {**r, "peak_mb": decode_peak}, "k1_launches": n}
    emit(out)
    if n:
        raise AssertionError(f"subvq: the decode launched K1 {n} times")
    return out


def phase_replay(dev, fx, tmp: str) -> dict:
    """Utterance 0's K1 scores written with write_senscr and decoded
    through ReplayScorer.from_file: the hypothesis of the live decode."""
    fp = FeatPipeline(fx.feat_config(), device=dev)
    sc = ContinuousScorer(fx.gauden, fx.ln_mixw, device=dev)
    search = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, sc, device=dev)
    feats = fp.compute(fx.ceps[0])
    fused_mixture_scores.launches = 0
    live = search.decode(feats)
    launches = fused_mixture_scores.launches
    with torch.inference_mode():
        scores = sc.score(torch.as_tensor(feats, device=dev)).cpu().numpy()
    path = os.path.join(tmp, "u0.sen")
    senfh.write_senscr(path, scores)
    search.scorer = senfh.ReplayScorer.from_file(path, device=dev)
    fused_mixture_scores.launches = 0
    t0 = time.perf_counter()
    replay = search.decode(feats)
    replay_s = time.perf_counter() - t0
    out = {"phase": "replay", "frames": len(feats), "n_sen": scores.shape[1],
           "file_bytes": os.path.getsize(path), "k1_launches": launches,
           "replay_k1_launches": fused_mixture_scores.launches,
           "replay_decode_s": replay_s, "words": " ".join(live.words),
           "words_equal": replay.words == live.words,
           "segments_equal": segs(replay) == segs(live)}
    emit(out)
    if not out["words_equal"] or launches != 1 or out["replay_k1_launches"]:
        raise AssertionError(f"replay: {out}")
    return out


def phase_endpoint(dev, fx) -> dict:
    """FrameClassifier fitted on the card to the utterances' frames,
    labelled SIL / speech by the card's AlignSearch (K1 once an
    utterance); the utterances joined end to end classified and segmented
    by Endpointer, held equal to the CPU's: the same classifier moved to
    the CPU, and the CPU's own fit on the same labels."""
    fp = FeatPipeline(fx.feat_config(), device=dev)
    aligner = AlignSearch(fx.dict, fx.mdef, fx.tmat,
                          ContinuousScorer(fx.gauden, fx.ln_mixw, device=dev),
                          device=dev)
    feats = fp.compute_batch(fx.ceps)
    fused_mixture_scores.launches = 0
    labels = []
    for f, words in zip(feats, fx.transcripts):
        _, phones, _, _ = aligner.align(f, words)
        lab = np.zeros(len(f), np.int64)
        for p in phones:
            if p.phone != "SIL":
                lab[p.start_frame: p.end_frame + 1] = ep.CLASS_SPEECH
        labels.append(lab)
    launches = fused_mixture_scores.launches
    x, y = np.concatenate(feats), np.concatenate(labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clf = ep.FrameClassifier.fit(x, y, 2, n_comp=EP_COMP, n_iter=EP_ITER,
                                 device=dev)
    fit_s = time.perf_counter() - t0
    moved = copy.deepcopy(clf).cpu()
    own = ep.FrameClassifier.fit(x, y, 2, n_comp=EP_COMP, n_iter=EP_ITER,
                                 device="cpu")
    ll, ll_cpu = clf.log_likelihoods(x), moved.log_likelihoods(x)
    xt = torch.as_tensor(x, device=dev)
    ll_ms = cuda_ms(lambda: clf.score(xt))
    classes = clf.classify(x)
    spans = {name: [(u.start_frame, u.end_frame)
                    for u in ep.Endpointer(**EP_SPANS).segment(c)]
             for name, c in (("card", classes),
                             ("cpu_same", moved.classify(x)),
                             ("cpu_fit", own.classify(x)))}
    means_rel = float(np.max(np.abs(clf.means - own.means)
                             / (np.abs(own.means) + 1e-3)))
    out = {"phase": "endpoint", "frames": len(x),
           "speech_share": float(y.mean()), "k1_launches": launches,
           "fit_s": fit_s, "log_likelihood_ms": ll_ms,
           "ll_max_abs_diff_vs_cpu": float(np.abs(ll - ll_cpu).max()),
           "classes_differing_vs_cpu_same": int(
               (classes != moved.classify(x)).sum()),
           "fit_means_max_rel_diff_vs_cpu": means_rel,
           "spans": len(spans["card"]), "first_spans": spans["card"][:4],
           "spans_equal_cpu_same": spans["card"] == spans["cpu_same"],
           "spans_equal_cpu_fit": spans["card"] == spans["cpu_fit"],
           "frame_accuracy": float((clf.classify(x, 1) == y).mean())}
    emit(out)
    if not (out["spans_equal_cpu_same"] and out["spans_equal_cpu_fit"]) or \
            launches != len(feats):
        raise AssertionError(f"endpoint: {out}")
    return out


def path_score(built, scores, states) -> float:
    """A state path's own score, re-summed on the host in float64."""
    (ss, sv, _, _, M, entry_lp, fexit, _, _) = built
    ll = np.where(sv[None], scores[:, ss], -1e30).astype(np.float64)
    tot = entry_lp[states[0]] + ll[0, states[0]]
    t = np.arange(1, len(states))
    tot += (M[states[:-1], states[1:]] + ll[t, states[1:]]).sum()
    return float(tot + fexit[states[-1]])


def phase_align_tp(dev, fx) -> dict:
    """align_time_parallel (n_chunks=ALIGN_TP_CHUNKS) of utterance 0 and of
    the first four utterances joined, K1 once each: the score against the
    card's sequential AlignSearch.align, and each path re-summed on the
    host; ms against the sequential alignment."""
    fp = FeatPipeline(fx.feat_config(), device=dev)
    aligner = AlignSearch(fx.dict, fx.mdef, fx.tmat,
                          ContinuousScorer(fx.gauden, fx.ln_mixw, device=dev),
                          device=dev)
    feats = fp.compute_batch(fx.ceps[:4])
    cases = {"utt0": (feats[0], fx.transcripts[0]),
             "joined4": (np.concatenate(feats), sum(fx.transcripts[:4], []))}
    out = {"phase": "align_tp", "n_chunks": ALIGN_TP_CHUNKS, "cases": {}}
    launches, ok = 0, True
    for name, (f, words) in cases.items():
        align_time_parallel(aligner, f, words, n_chunks=ALIGN_TP_CHUNKS)
        torch.cuda.synchronize()
        fused_mixture_scores.launches = 0
        t0 = time.perf_counter()
        states, score = align_time_parallel(aligner, f, words,
                                            n_chunks=ALIGN_TP_CHUNKS)
        torch.cuda.synchronize()
        tp_ms = 1e3 * (time.perf_counter() - t0)
        n = fused_mixture_scores.launches
        launches += n
        t0 = time.perf_counter()
        _, _, seq, seq_score = aligner.align(f, words)
        torch.cuda.synchronize()
        seq_ms = 1e3 * (time.perf_counter() - t0)
        built = aligner._build(words)
        with torch.inference_mode():
            scores = aligner.scorer.score(
                torch.as_tensor(f, device=dev)).cpu().numpy()
        own = path_score(built, scores, states)
        own_seq = path_score(built, scores, np.asarray(seq))
        T = len(f)
        # 2T float32 additions on each side, each within half an ulp of a
        # partial sum no larger than |score|.
        rtol = 4 * T * 2.0 ** -24
        r = {"T": T, "S": int(built[4].shape[0]),
             "P": int(_pred_table(built[4])[0].shape[1]), "k1_launches": n,
             "ms": tp_ms, "sequential_ms": seq_ms, "score": score,
             "sequential_score": seq_score,
             "score_rel_diff": abs(score - seq_score) / abs(seq_score),
             "path_resummed_rel_diff": abs(own - score) / abs(score),
             "sequential_path_resummed_rel_diff":
                 abs(own_seq - seq_score) / abs(seq_score),
             "rtol": rtol, "states_differing": int(
                 (states != np.asarray(seq)).sum())}
        out["cases"][name] = r
        ok &= (n == 1 and r["score_rel_diff"] <= rtol
               and r["path_resummed_rel_diff"] <= rtol)
    out["k1_launches"] = launches
    emit(out)
    if not ok:
        raise AssertionError(f"align_tp: {out}")
    return out


def phase_multi_rank(dev, fx) -> dict:
    """dryrun_multichip over a real NCCL group of one rank (two NCCL ranks
    cannot share one card, so the mesh is dp=1 x mp=1): its sharded EM
    step, partition contract and data-parallel decodes of the slice (mpx
    and tree, K1 twice each) and of the SMALL semi-continuous fixture
    (PsParityScorer), each held to the one-process run."""
    fused_mixture_scores.launches = 0
    t0 = time.perf_counter()
    res = dryrun_multichip(1, "cuda", fx=fx, rank=0,
                           coordinator=f"localhost:{free_port()}")
    out = {"phase": "multi_rank", "seconds": time.perf_counter() - t0,
           **res, "k1_launches": fused_mixture_scores.launches}
    emit(out)
    if out["backend"] != "nccl" or out["k1_launches"] != 4 or \
            (out["dp"], out["mp"]) != (1, 1) or \
            out["decode"]["semi"]["scorer"] != "PsParityScorer":
        raise AssertionError(f"multi_rank: {out}")
    return out


def first_difference(got, want) -> list:
    """The (t, s) index of the first score that differs, else []."""
    idx = (got != want).nonzero()
    return [int(v) for v in idx[0]] if len(idx) else []


def check_shards(sc, x, name: str) -> tuple:
    """The mp shards of `sc` (`shards`) scored on x and joined
    (`score_parts`, the body of `score_shards`) at each of SHARD_MPS,
    against the unsharded call, bit for bit; the ms of the unsharded call
    and of each of those shards' calls (CUDA events); K1's launches by
    the joined scoring."""
    want = sc.score(x)
    out, launches = {"unsharded_ms": cuda_ms(lambda: sc.score(x))}, 0
    for mp in SHARD_MPS:
        parts = shards(sc, mp)
        before = fused_mixture_scores.launches
        got = score_parts(parts, x)
        torch.cuda.synchronize()
        launches += fused_mixture_scores.launches - before
        first = first_difference(got, want)
        out[f"mp={mp}"] = {
            "equal": not first and got.shape == want.shape,
            "first_difference": first,
            "shard_ms": [cuda_ms(lambda p=p: p.score(x)) for p in parts]}
        if not out[f"mp={mp}"]["equal"]:
            emit({"phase": "senone_shards", "failed": name, **out})
            raise AssertionError(f"senone shards of {name} at mp={mp} "
                                 f"differ from the unsharded scores at "
                                 f"(t, s) = {first}")
    return out, launches


def phase_senone_shards(dev, cont, semi) -> dict:
    """Senone shards at mp = 2 and 3 (the reference dry run's mp axis on one
    card): K1 on senone shards of the FULL continuous scorer in each mode,
    and PsParityScorer's epilogue on slices of the mixture weights (8- and
    4-bit) at S=5150, K=256; each bit-equal to the unsharded scores."""
    x = torch.as_tensor(approx_frames(cont, dev, T_K1), device=dev)
    xs = torch.as_tensor(semi_inputs(semi, T_SEMI), device=dev)
    out = {"phase": "senone_shards", "T": T_K1, "S": cont.mdef.n_sen,
           "mps": list(SHARD_MPS), "k1": {}, "psparity": {}}
    launches = 0
    for mode in MODES:
        sc = ContinuousScorer(cont.gauden, cont.ln_mixw, precision=mode,
                              device=dev)
        out["k1"][mode], n = check_shards(sc, x, f"K1 {mode}")
        launches += n
    for bits, raw in zip((8, 4), sendumps(semi)):
        sc = PsParityScorer(semi.gauden, raw, semi.stream_slices(),
                            topn=TOPN, wrap_uint8=bits == 4, device=dev)
        out["psparity"][f"{bits}-bit"] = check_shards(
            sc, xs, f"PsParityScorer {bits}-bit")[0]
    out["k1_launches"] = launches
    emit(out)
    if launches != len(MODES) * sum(SHARD_MPS):
        raise AssertionError(f"senone_shards: K1 launched {launches} times")
    return out


def phase_tools(dev, fx, tmp: str) -> dict:
    """`tools fe` over a control file of seeded PCM on the card, held to
    `-platform cpu` within the decoder phase's cepstral bound; then
    `lmtool train` from the fixture's transcripts to ARPA and `tools
    lm2fst` of it (host only, timed)."""
    base = os.path.join(tmp, "tools")
    os.makedirs(base)
    names = []
    for i, secs in enumerate(TOOLS_PCM_S):
        names.append(f"pcm{i}")
        fixture.synthetic_pcm(SEED + 10 + i, seconds=secs).tofile(
            os.path.join(base, names[-1] + ".raw"))
    ctl = os.path.join(base, "pcm.ctl")
    with open(ctl, "w") as fh:
        fh.write("".join(n + "\n" for n in names))

    def run(cli, argv) -> tuple:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        return rc, buf.getvalue(), time.perf_counter() - t0

    fe_args = ["fe", "-c", ctl, "-di", base, "-ei", "raw", "-eo", "mfc"]
    card = run(tools, fe_args + ["-do", os.path.join(base, "card")])
    host = run(tools, fe_args + ["-do", os.path.join(base, "host"),
                                 "-platform", "cpu"])
    cpu_fe = Frontend(device="cpu")
    b = np.full(cpu_fe.nfilt, LOGMEL_TOL) @ np.abs(
        cpu_fe.dct.numpy().astype(np.float64))
    if cpu_fe.lifter is not None:
        b = b * np.abs(cpu_fe.lifter.numpy())
    worst, frames, shapes_equal = 0.0, 0, True
    for n in names:
        got = read_mfc(os.path.join(base, "card", n + ".mfc"))
        want = read_mfc(os.path.join(base, "host", n + ".mfc"))
        shapes_equal &= got.shape == want.shape and len(got) > 0
        if shapes_equal:
            frames += len(got)
            worst = max(worst, float((np.abs(got.astype(np.float64) - want)
                                      / b).max()))
    text = os.path.join(base, "corpus.txt")
    with open(text, "w") as fh:
        fh.write("".join(" ".join(t) + "\n" for t in fx.transcripts))
    arpa, fst = os.path.join(base, "lm.arpa"), os.path.join(base, "lm.fst")
    train = run(lmtool, ["train", "-text", text, "-lm", arpa, "-n", "3"])
    to_fst = run(tools, ["lm2fst", "-i", arpa, "-o", fst])
    with open(fst) as fh:
        arcs = sum(1 for _ in fh)
    out = {"phase": "tools", "files": len(names), "frames": frames,
           "fe_card_s": card[2], "fe_cpu_s": host[2],
           "fe_stdout_equal": card[1] == host[1],
           "cep_worst_err_over_bound": worst,
           "lmtool_train_s": train[2], "lmtool_stdout": train[1].strip(),
           "lm2fst_s": to_fst[2], "fst_lines": arcs}
    emit(out)
    if any(r[0] != 0 for r in (card, host, train, to_fst)) or \
            not (shapes_equal and out["fe_stdout_equal"]) or worst > 1.0 \
            or not arcs:
        raise AssertionError(f"tools: {out}")
    return out


def phase_mfu(card: str, k1: dict, semi: dict) -> dict:
    """The port's mfu report for K1 at the main path's T=9,600 and
    PsParityScorer at T=2000, from the times phases 3 and 5 took."""
    stages = [mfu.Stage(
        f"K1 {m} (T={T_MAIN}, S={S}, K={K}, D={D})", k1[m]["ms"] / 1e3,
        mfu.continuous_gmm_flops(T_MAIN, S, K, D),
        mfu.continuous_gmm_bytes(T_MAIN, S, K, D, True)
        - (2.0 * D * S * K * 2 if m == "bf16" else 0.0),
        precision=mfu.K1_PRECISION[m]) for m in MODES]
    for r in semi["psparity"]:
        stages.append(mfu.Stage(
            f"PsParityScorer {r['weights']} (T={T_SEMI}, S={semi['S']}, "
            f"K={semi['K']})", r["ms"] / 1e3, mfu.psparity_flops(
                T_SEMI, len(semi["streams"]), semi["K"], semi["streams"],
                semi["S"], TOPN), precision="f32"))
    out = {"phase": "mfu", "card": card, "report": mfu.report(stages),
           "stages": [{"name": s.name, "ms": 1e3 * s.seconds,
                       "mfu_bf16": s.mfu, "precision": s.precision,
                       "mfu_own_peak": s.adjusted_mfu,
                       "hbm_util": s.bw_util} for s in stages]}
    emit(out)
    return out


def main() -> int:
    _START[0] = time.perf_counter()
    info = phase_device()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    holds, ok = Holds(), False
    try:
        with tempfile.TemporaryDirectory() as tmp:
            result = run(info, dev, holds, tmp)
        ok = True
    finally:
        holds.close(ok)
    emit(result)
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


def run(info: dict, dev, holds: Holds, tmp: str) -> dict:
    """Every phase after the device's, in an order that hands the longest
    CPU holds to the workers first; returns the kernel table."""
    cont_spec = (SEED, "cont", fixture.FULL)
    builds = submit_builds(holds, cont_spec)
    phase_build()
    exps = info["exps_per_s"]
    check_k1(dev, floored=False, modes=MODES, exps_per_s=exps)
    check_k1(dev, floored=True, modes=MODES, exps_per_s=exps, timed=False)
    k1 = check_k1(dev, floored=False, modes=MODES, exps_per_s=exps, T=T_MAIN)
    check_k1(dev, floored=False, modes=MODES, exps_per_s=exps, D=D_WIDE)
    k1_stream = check_k1(dev, floored=False, modes=MODES, exps_per_s=exps,
                         T=T_STREAM)
    k1_loop = phase_k1_wide(dev, exps)
    cont = fixture.build(SEED)
    grammar = phase_grammar(dev, cont, tmp, holds)
    train = phase_train(dev, holds, tmp)
    phase_train_pipeline(dev, cont, tmp)
    phase_train_semicont(dev, cont, holds)
    rest = [phase_approx(dev, cont, cont_spec, holds, builds),
            phase_subvq(dev, cont, cont_spec, holds, builds),
            phase_replay(dev, cont, tmp), phase_endpoint(dev, cont),
            phase_align_tp(dev, cont), phase_multi_rank(dev, cont)]
    card = info["nvidia_smi"]
    _, (fx5k, search, fp, _, _) = phase_large_vocab(
        dev, card, "large_vocab_static", (SEED, "semi", fixture.LARGE_5K),
        "ps", "flat", "rows", hold_utts=None, holds=holds)
    graphs = {"static5k": graph_batch_cell(search, fp, fx5k, card)}
    graphs["static5k"]["graph_memory"] = release_graphs(search)
    del fx5k, search, fp
    large_spec = (SEED, "cont", fixture.LARGE)
    tree, (large, search, fp, tapes, hyps) = phase_large_vocab(
        dev, card, "large_vocab_tree", large_spec, "cont", "tree", "hashed",
        hold_utts=1, holds=holds)
    if tree["k1_launches"] != 1:
        raise AssertionError("the tree decode did not launch K1 once")
    feats = batch_features(search, fp, large)
    stream_tree = stream_phase("stream_tree", search, feats, tapes, hyps,
                               [0], [3000])
    graphs["tree20k"] = graph_batch_cell(search, fp, large, card)
    graphs["tree20k_stream"] = graph_stream_cell(search, feats, [0], card)
    graphs["tree20k_traffic"] = graph_traffic_cell(
        search, fp, traffic(large, SEED), card)
    del search, fp, tapes, hyps, feats
    options = phase_ngram_options(dev, cont, cont_spec, large, large_spec,
                                  holds)
    del large
    dec_wide = phase_decoder_wide(dev, fixture.build(SEED, ncep=NCEP_WIDE))
    sl, (search, fp, tapes, hyps) = phase_slice(dev, cont)
    feats = batch_features(search, fp, cont)
    stream = stream_phase("stream", search, feats, tapes, hyps,
                          range(STREAM_UTTS),
                          [2 * T_STREAM] + [3000] * (STREAM_UTTS - 1))
    graphs["slice"] = graph_batch_cell(search, fp, cont, card)
    graphs["slice_stream"] = graph_stream_cell(search, feats,
                                               range(STREAM_UTTS), card)
    graphs["slice"]["graph_memory"] = release_graphs(search)
    graphs["slice_traffic"] = decoder_traffic_cell(dev, cont, tmp, card)
    phase_graphs(graphs)
    lat = phase_lattice(dev, search, fp, cont)
    del search, fp, tapes, hyps
    align = phase_align_allphone(dev, cont)
    phase_graphs_search(dev, cont, tmp, card)
    semi = fixture.build(SEED, model="semi")
    semicont = phase_semicont_scorer(dev, semi)
    sharded = phase_senone_shards(dev, cont, semi)
    phase_semicont_slice(dev, semi)
    dec = phase_decoder(dev, {"cont": cont, "semi": semi})
    dec_stream = phase_decoder_stream(dev, {"cont": cont, "semi": semi})
    phase_tools(dev, cont, tmp)
    holds.finish()
    phase_mfu(card, k1, semicont)
    # The batch's shape (T=9,600) keys the row; the stream's (T=50, one
    # chunk) and the depth loop's (D=78, 150 at T=2000) ride beside it.
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return {"kernels": [{
        "name": "fused_gmm", "route": "cuda",
        "source": "cmusphinx_tpu_torch/csrc/fused_gmm.cu",
        "replaces": "cmusphinx_tpu/ops/pallas_gmm.py:74",
        "launches": sum(p["k1_launches"] for p in (
            sl, dec, tree, stream, stream_tree, dec_stream, lat, dec_wide,
            grammar, align, options, train, sharded, *rest)),
        **{k: k1["highest"][k] for k in keys},
        "stream_shape": {"T": T_STREAM, **{k: k1_stream["highest"][k]
                                           for k in keys}},
        "depth_loop": {f"D={d}": {m: {k: k1_loop[d][m][k] for k in keys}
                                  for m in MODES} for d in D_LOOP}}]}


if __name__ == "__main__":
    sys.exit(main())
