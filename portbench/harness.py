"""One run of one cell: generate (or find) the seed's task, load it
through the port's entry (`cmusphinx_tpu_torch.api.Decoder`), warm up,
measure the window, check what it produced against the plain reference,
and read the cell's metrics.

Everything the run is made of is found by name from `BENCHMARK.json`:
a cell's configuration `configs/<config>.json`, its acoustic-model kind
`kinds/<model>.py` (the configuration's "model": its generator, weight
files, reference scorer, score shape and counts), its mix
`traffic/<mix>.json`, and each metric's reader `metrics/<metric>.py`
(a `read(run)` that returns the number or None where it finds nothing to
read).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import pickle
import shutil
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import byname, drive, kinds, traffic
from . import trace as trace_mod
from .check import Check
from .gen import task as gen_task

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".cache")
OUT = os.path.join(HERE, ".out")
MODEL_CACHE_KEEP = 6
# Modules a run may not hold once its window has closed, by top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "cmusphinx_tpu")


def root_of(bench_path: str) -> str:
    return os.path.dirname(os.path.abspath(bench_path))


def load_spec(bench_path: str) -> dict:
    with open(bench_path) as fh:
        return json.load(fh)


def find(spec: dict, key: str, name: str) -> dict:
    for e in spec[key]:
        if e["name"] == name:
            return e
    raise KeyError(f"no {key[:-1]} named {name!r} in BENCHMARK.json")


def mix_path(root: str, spec: dict, mix: str) -> str:
    return os.path.join(root, spec["paths"][0], "traffic", mix + ".json")


def reader(metric: str) -> Callable:
    return byname.load("metrics", metric).read


def cell_metrics(spec: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of `cell` reports: its end-to-end metrics
    (trace 0) or its per-layer ones (trace 1)."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def listing(bench_path: str) -> List[str]:
    """Every cell with its configuration, mix and kind files and the
    readers of its metrics, as the harness resolves them."""
    spec, root = load_spec(bench_path), root_of(bench_path)
    lines = []
    for w in spec["workloads"]:
        cfg = find(spec, "configs", w["config"])
        with open(os.path.join(root, cfg["file"])) as fh:
            kind = kinds.path(json.load(fh)["model"])
        lines.append(f"cell {w['name']}: {cfg['file']} "
                     f"{os.path.relpath(mix_path(root, spec, w['traffic']), root)}"
                     f" {os.path.relpath(kind, root)}"
                     f"{'' if os.path.exists(kind) else ' (missing)'}")
        for trace in (False, True):
            for m in cell_metrics(spec, w["name"], trace):
                p = byname.path("metrics", m["name"])
                lines.append(f"  metric {m['name']}: "
                             f"{os.path.relpath(p, root)}"
                             f"{'' if os.path.exists(p) else ' (missing)'}")
    return lines


# ----------------------------------------------------------------------
def model_dir(cfg: dict, seed: int, lengths: List[int]):
    """The seed's model directory and pool, generated into the checkout's
    cache (keyed by configuration, seed and pool lengths) unless there.
    A configuration with a `structure_seed` keeps its structure (lexicon,
    LM, senone ties) once, in a directory of its own whose files each
    seed's directory links.  Returns (Decoder keyword arguments, pool
    cepstra, generator seconds)."""
    sseed = cfg.get("structure_seed")
    key = (f"{cfg['name']}-{sseed}-{seed}-"
           f"{len(lengths)}-{lengths[0]}-{lengths[-1]}")
    path = os.path.join(CACHE, "models", "seeds", key)
    kw = {"hmm": os.path.join(path, "hmm"),
          "lm": os.path.join(path, "lm.arpa"),
          "dict": os.path.join(path, "words.dict")}
    done = os.path.join(path, "done")
    t0 = time.perf_counter()
    if not os.path.exists(done):
        shutil.rmtree(path, ignore_errors=True)
        size = gen_task.Size.from_dict(cfg["size"])
        if sseed is None:
            task = gen_task.build(seed % (1 << 32), cfg["model"], size,
                                  lengths)
            gen_task.write_model_dir(task, path)
        else:
            sdir = _structure_dir(cfg, size, sseed)
            with open(os.path.join(sdir, "structure.pkl"), "rb") as fh:
                struct = pickle.load(fh)
            task = gen_task.with_seed(struct, seed % (1 << 32), lengths)
            gen_task.write_weights(task, path)
            for f in gen_task.STRUCTURE_FILES:
                _link(os.path.join(sdir, f), os.path.join(path, f))
        np.savez(os.path.join(path, "pool.npz"), *task.ceps)
        open(done, "w").close()
        _prune(os.path.dirname(path), keep=path)
    with np.load(os.path.join(path, "pool.npz")) as z:
        ceps = [z[f"arr_{i}"] for i in range(len(z.files))]
    os.utime(done)
    return kw, ceps, time.perf_counter() - t0


def _structure_dir(cfg: dict, size, sseed: int) -> str:
    """The configuration's structure: its files and the structure itself
    (`structure.pkl`, without the LM, which its file holds)."""
    shared = (getattr(size, f.name) for f in dataclasses.fields(size)
              if f.name != "own")
    key = f"{cfg['name']}-{sseed}-" + "-".join(
        f"{v[0]}_{v[1]}" if isinstance(v, tuple) else str(v) for v in shared)
    sdir = os.path.join(CACHE, "models", "structure", key)
    if not os.path.exists(os.path.join(sdir, "done")):
        shutil.rmtree(sdir, ignore_errors=True)
        struct = gen_task.structure(cfg["model"], size, sseed)
        gen_task.write_structure(struct, sdir)
        with open(os.path.join(sdir, "structure.pkl"), "wb") as fh:
            pickle.dump(dataclasses.replace(struct, lm=None), fh,
                        protocol=pickle.HIGHEST_PROTOCOL)
        open(os.path.join(sdir, "done"), "w").close()
    return sdir


def _link(src: str, dst: str) -> None:
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)


def _prune(parent: str, keep: str) -> None:
    """Keep the most recently used generated tasks only."""
    entries = sorted((os.path.getmtime(os.path.join(parent, d, "done"))
                      if os.path.exists(os.path.join(parent, d, "done"))
                      else 0.0, os.path.join(parent, d))
                     for d in os.listdir(parent))
    for _, p in entries[:-MODEL_CACHE_KEEP]:
        if p != keep:
            shutil.rmtree(p, ignore_errors=True)


@dataclass
class Run:
    """What a metric reader reads."""
    cell: dict
    config: dict
    mix: dict
    shape: dict
    setup_s: float
    window: drive.Window
    trace: Optional[trace_mod.Trace] = None
    slice: tuple = (0.0, 0.0)          # the traced slice, trace time (s)


@dataclass
class Result:
    line: dict
    checks: Dict[str, dict]        # the compared numbers, with limits
    numbers: Dict[str, float]      # every number the check read


def run_cell(bench_path: str, cell_name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             patch: Optional[Callable] = None,
             scorer: Optional[Callable] = None,
             decoder_args: Optional[dict] = None,
             log=lambda s: print(s, file=sys.stderr, flush=True)) -> Result:
    """One run.  `patch(decoder)` (tests: a planted fault),
    `scorer(decoder, kind)` (a scorer to put in the program's place: the
    control; `kind` the configuration's) and
    `decoder_args` (the control's program paths) are for the checks of the
    check; the benchmark's own runs pass none of them."""
    from cmusphinx_tpu_torch.api import Decoder

    spec, root = load_spec(bench_path), root_of(bench_path)
    cell = find(spec, "workloads", cell_name)
    cfg_entry = find(spec, "configs", cell["config"])
    with open(os.path.join(root, cfg_entry["file"])) as fh:
        cfg = json.load(fh)
    kind = kinds.load(cfg["model"])
    mix = traffic.load(mix_path(root, spec, cell["traffic"]))

    kw, ceps, gen_s = model_dir(cfg, seed, traffic.lengths(mix))
    log(f"portbench: task {cfg['name']} seed {seed}: {gen_s:.3f} s to "
        f"generate or load ({len(ceps)} utterances)")

    # ---- set-up: the Decoder, then the warm-up of this cell's shapes.
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dec = Decoder(device=device, **kw,
                  **{**cfg.get("decoder", {}), **(decoder_args or {})})
    decoder_s = time.perf_counter() - t0
    if scorer is not None:
        dec.search.scorer = scorer(dec, cfg["model"])
    tap = drive.Tap(dec.search.scorer)
    dec.search.scorer = tap
    if patch is not None:
        patch(dec)
    win = drive.BatchWindow(dec, tap, mix, seed, ceps, device)
    try:
        warm_captures = win.warm()
    except Exception as e:  # a program that fails here fails the window too
        log(f"portbench: the warm-up failed: {type(e).__name__}: {e}")
        warm_captures = -1
    prof = None
    if trace:
        drive.Profiled.warm(device)
        os.makedirs(OUT, exist_ok=True)
        prof = drive.Profiled(os.path.join(OUT, "trace.json"), device)
    drive.sync(device)
    setup_s = time.perf_counter() - t0
    log(f"portbench: setup_s {setup_s:.3f} (the Decoder {decoder_s:.3f}; "
        f"{warm_captures} captures in the warm-up)")
    tap.calls.clear()
    shape = kind.score_shape(dec)

    # ---- the window.
    w = win.run(seconds, prof)
    mem = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    found = sorted({m.split(".")[0] for m in list(sys.modules)}
                   & set(FORBIDDEN))
    if found:
        raise RuntimeError("the run loaded " + ", ".join(found))
    for e in w.errors[:5]:
        log(f"portbench: failed: {e}")

    # ---- the program's state freed, then the check.
    kept = list(tap.kept)
    plan = win.plan
    del dec, win, tap
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_chk = time.perf_counter()
    numbers = Check(kw, cfg, device).run(w, kept, ceps, plan)
    del kept
    limits = cfg["check"]
    correct = all(math.isfinite(numbers[k]) and numbers[k] <= limits[k]
                  for k in limits)
    # JSON has no infinity: a number that could not be read prints as the
    # largest float.
    checks = {k: {"value": min(numbers[k], sys.float_info.max),
                  "limit": limits[k]} for k in limits}
    log(f"portbench: check took {time.perf_counter() - t_chk:.3f} s; "
        "not compared: " + ", ".join(f"{k} {v!r}" for k, v in numbers.items()
                                     if k not in limits))

    # ---- metrics.
    run = Run(cell, cfg, mix, shape, setup_s, w)
    if trace:
        run.trace = trace_mod.load(prof.path)
        os.remove(prof.path)
        run.slice = run.trace.span(drive.SLICE_SPAN)
    metrics = {}
    for m in cell_metrics(spec, cell_name, trace):
        v = reader(m["name"])(run)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else str(device),
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(mem)}
    line = {"correct": bool(correct), "attempted": int(w.attempted),
            "failed": int(w.failed), "metrics": metrics, "device": dev}
    if trace:
        t0s, t1s = run.slice
        dev["busy_s"] = run.trace.busy_s(t0s, t1s)
        dev["window_s"] = t1s - t0s
        line["breakdown"] = {"device_ops": run.trace.top_ops(),
                             "idle_gaps": run.trace.idle_gaps(t0s, t1s)}
    line["check"] = checks
    return Result(line, checks, numbers)
