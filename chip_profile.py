#!/usr/bin/env python3
"""Where the time of a large-vocabulary decode goes, on one GPU.

Run from the repository root on a machine with a CUDA device:

    python3 chip_profile.py

It profiles the two large-vocabulary phases of `chip_smoke.py`:
`tree20k` (fixture.LARGE, 20,000 words: the prefix tree, K1, hashed LM
lookups) and `static5k` (fixture.LARGE_5K with PsParityScorer: the flat
composite-context step, `score_rows`).  The first line is nvidia-smi's
name, power limit and SM clock; then one JSON line a cell:

- `walls`: 3 unprofiled `decode_batch_cep` passes of the 16 utterances
  (host clock around synchronised work);
- one pass under `torch.profiler`: its device events, events a frame, and
  the events' summed time over the pass's wall (the profiler lists an op
  and its kernel each as a device event, so kernels are about half);
- each part of a frame step, in ms on the host clock around synchronised
  repetitions at the cell's shapes (B=16): the whole step, `hmm_step`,
  `topk2`, the LM lookup, `_bgla_rows` (tree), `_expand_block` of 10
  frames, the scorer over the batch; and the device events of one step.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.decode import NgramSearch
from cmusphinx_tpu_torch.decode.ngram_search import topk2
from cmusphinx_tpu_torch.frontend import FeatPipeline
from cmusphinx_tpu_torch.ops import ContinuousScorer, PsParityScorer
from cmusphinx_tpu_torch.ops.hmm import hmm_step

SEED = 0
TOPN = 4


def host_ms(fn, reps: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def device_events(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def profile_cell(dev, name: str, fx, scorer) -> dict:
    from torch.profiler import ProfilerActivity, profile
    fp = FeatPipeline(fx.feat_config(), device=dev)
    s = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, scorer, device=dev)
    s.decode_batch_cep(fx.ceps, fp)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        s.decode_batch_cep(fx.ceps, fp)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s.decode_batch_cep(fx.ceps, fp)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    ev = device_events(prof)
    busy_ms = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    c, T, _ = s._pad(fx.ceps)
    B, Tp, E, W = len(fx.ceps), int(c.shape[1]), s.E, s.vocab.n_word
    out = {"phase": name, "words": W, "channels": s.graph.n_chan,
           "graph": f"{s.graph.rc_mode}/{s.graph.lc_mode}/"
                    f"{s.graph.lex_mode}",
           "utterances": B, "frames_padded": Tp, "walls_s": walls,
           "profiled_wall_s": pwall, "device_events": len(ev),
           "device_events_per_frame": len(ev) / Tp,
           "device_event_ms": busy_ms,
           "device_event_share_of_wall": busy_ms / 1e3 / pwall}
    out["lm_backend_calls_in_5_passes"] = dict(s.dlm.calls)
    with torch.inference_mode():
        feats = fp._padded_kernel(c, T, True)
        scores = scorer.score(feats)
        out["scorer_ms"] = host_ms(lambda: scorer.score(feats), 5)
        blk = scores[:, :10]
        out["expand_10_frames_ms"] = host_ms(lambda: s._expand_block(blk),
                                             10)
        carry = s._init_static(B, Tp)
        sen = s._expand_block(blk)[0]
        out["hmm_step_ms"] = host_ms(
            lambda: hmm_step(carry[0], (carry[1],), sen, s._bands()))
        k = min(4 * E, W) if s._tree else E
        x = torch.randn(B, W, device=dev)
        out[f"topk2_{k}_of_{W}_ms"] = host_ms(lambda: topk2(x, k))
        h = torch.randint(0, fx.lm.n_words, (B, k), device=dev)
        if s._tree:
            out["score_tg_ms"] = host_ms(
                lambda: s.dlm.score_tg(h, h, h, lanes=k))
            out["bgla_rows_ms"] = host_ms(lambda: s._bgla_rows(h[:, 0]))
        else:
            hf = h.reshape(-1)
            out["score_rows_ms"] = host_ms(lambda: s.dlm.score_rows(hf, hf))
        step = s._step_tree if s._tree else s._step_static
        tape = tuple(a[:, 5] for a in s._tape(B, Tp))
        valid = torch.ones(B, dtype=torch.bool, device=dev)
        t5 = torch.full((), 5, dtype=torch.int64, device=dev)
        out["frame_step_ms"] = host_ms(lambda: step(carry, sen, t5, valid,
                                                    tape))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p2:
            step(carry, sen, t5, valid, tape)
            torch.cuda.synchronize()
        ev2 = device_events(p2)
        out["frame_step_device_events"] = len(ev2)
        out["frame_step_device_event_ms"] = sum(
            e.time_range.elapsed_us() for e in ev2) / 1e3
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: no CUDA device")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    fx = fixture.build(SEED, size=fixture.LARGE)
    sc = ContinuousScorer(fx.gauden, fx.ln_mixw, device=dev)
    print(json.dumps(profile_cell(dev, "tree20k", fx, sc)), flush=True)
    del fx, sc
    fx = fixture.build(SEED, model="semi", size=fixture.LARGE_5K)
    raw, meta = fixture.sendump_bytes(fx)
    sc = PsParityScorer(fx.gauden, raw, fx.stream_slices(), topn=TOPN,
                        wrap_uint8=meta["n_bits"] == 4, device=dev)
    print(json.dumps(profile_cell(dev, "static5k", fx, sc)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
