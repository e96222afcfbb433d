"""Dry run of the port's multi-process paths over `torch.distributed`.

The counterpart of the reference's `dryrun_multichip` (the JAX package's
`__graft_entry__.py`), on the port's own seeded fixture.  Every rank of
one process group calls `dryrun_multichip(n_ranks, device)`; it checks
three things, each against the one-process run on the same device, and
raises on any difference:

1. training: one `Trainer.em_step_sharded` step (utterances split over the
   ranks, accumulators reduced by `all_reduce`) against `em_step`;
2. the `-part`/`-npart` contract: each rank's accumulators over its
   `local_partition` of the corpus, summed over the ranks (and, on every
   rank, over a two-part split), against the single pass;
3. serving: a data-parallel batched decode, once on the mpx slice (the
   flat fanout/mpx graph) and once on the prefix tree: each rank decodes
   its share of the utterances, the tapes and segments are gathered, and
   every utterance's are held to the one-process batch decode (integers
   equal, floats within rtol 1e-5).

With torchrun (one card a process; NCCL):

    torchrun --nproc_per_node 4 -m cmusphinx_tpu_torch.parallel.dryrun

and on the CPU over gloo with `--device cpu`.  One process with nothing
configured makes a group of one on a free local port.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import fixture
from ..decode import NgramSearch
from ..frontend import FeatPipeline
from ..ops import ContinuousScorer
from ..train.sentence_hmm import FlatModel
from ..train.trainer import Trainer, host_acc
from .hosts import init_distributed, local_partition, partition_ctl

# Sharded EM against em_step (the two-rank CPU test's bounds) and summed
# partition accumulators against the single pass (the reference's).
LL_RTOL, PARAM_RTOL, PARAM_ATOL, ACC_TOL = 1e-5, 1e-4, 1e-5, 2e-5
TAPE_RTOL = 1e-5
# The reference dry run's prefix-tree configuration.
TREE = {"rcmode": "composite", "lcmode": "composite", "lexmode": "tree"}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def toy_corpus(n_utt: int, seed: int = 0):
    """The reference dry run's training corpus: a 3-phone flat model and
    n_utt utterances of seeded random 4-dim frames."""
    rng = np.random.RandomState(seed)
    model = FlatModel.create(["SIL", "A", "B"], n_state=3)
    pron = {"ab": ["A", "B"], "ba": ["B", "A"]}
    feats, trans = [], []
    for i in range(n_utt):
        trans.append(["ab"] if i % 2 == 0 else ["ba"])
        feats.append(rng.randn(18 + i % 3, 4).astype(np.float32))
    return model, pron, trans, feats


def _check_training(info, dev) -> dict:
    # One utterance more than two a rank: the last block pads a row.
    model, pron, trans, feats = toy_corpus(2 * info.num_processes + 1)
    tr = Trainer(model, pron, trans, feats, K=2, device=dev)
    one = Trainer(model, pron, trans, feats, K=2, device=dev)
    ll, want = tr.em_step_sharded(), one.em_step()
    p_diff = 0.0
    for name in ("means", "var", "lnw", "tp"):
        a, b = getattr(tr.params, name), getattr(one.params, name)
        p_diff = max(p_diff, float(np.max(np.abs(a - b) / (
            PARAM_ATOL + PARAM_RTOL * np.abs(b)))))
    out = {"utterances": len(feats), "ll": ll, "ll_single": want,
           "ll_rel_diff": abs(ll - want) / abs(want),
           "param_err_over_bound": p_diff}
    if out["ll_rel_diff"] > LL_RTOL or p_diff > 1.0:
        raise AssertionError(f"em_step_sharded != em_step: {out}")

    # The -part/-npart contract on the step's parameters.
    idx = list(range(len(feats)))

    def accumulate(sub):
        t = Trainer(model, pron, [trans[i] for i in sub],
                    [feats[i] for i in sub], K=2, device=dev)
        return host_acc(t.accumulate(tr.params)[1])

    keys = ("mixw", "mean", "var", "tmat")
    full = accumulate(idx)
    mine = accumulate(local_partition(idx, info))
    worst = 0.0
    for k in keys:
        t = torch.as_tensor(mine[k]).to(dev)
        dist.all_reduce(t)
        parts = sum(accumulate(partition_ctl(idx, p, 2))[k] for p in (1, 2))
        for got in (t.cpu().numpy(), parts):
            worst = max(worst, float(np.max(np.abs(got - full[k]) / (
                ACC_TOL + ACC_TOL * np.abs(full[k])))))
    part = {"share": len(local_partition(idx, info)),
            "acc_err_over_bound": worst}
    if worst > 1.0:
        raise AssertionError(f"partition accumulators != single pass: "
                             f"{part}")
    return {"em_step_sharded": out, "partition": part}


def _segs(h) -> list:
    return [(s.word, s.start_frame, s.end_frame) for s in h.segments]


def _check_decode(info, dev, fx, name: str, kw: dict) -> dict:
    sc = ContinuousScorer(fx.gauden, fx.ln_mixw, device=dev)
    fp = FeatPipeline(fx.feat_config(), device=dev)
    s = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, sc, device=dev, **kw)
    E = s.E
    want_hyps = s.decode_batch_cep(fx.ceps, fp)
    want = [t.cpu().numpy() for t in s._last_batch[0]]
    Ts = s._pad(fx.ceps)[2]
    mine = local_partition(list(range(len(fx.ceps))), info)
    t0 = time.perf_counter()
    hyps = s.decode_batch_cep([fx.ceps[i] for i in mine], fp)
    share_s = time.perf_counter() - t0
    tapes = [t.cpu().numpy() for t in s._last_batch[0]]
    rows = {i: ([t[j, : Ts[i] * E] for t in tapes], _segs(h))
            for j, (i, h) in enumerate(zip(mine, hyps))}
    gathered = [None] * info.num_processes
    dist.all_gather_object(gathered, rows)
    got = {k: v for g in gathered for k, v in g.items()}
    int_diff, rel, segs_equal = 0, 0.0, True
    for i in range(len(fx.ceps)):
        tape, segs = got[i]
        for a, b in zip(tape, (t[i, : Ts[i] * E] for t in want)):
            if a.dtype.kind == "f":
                rel = max(rel, float(np.max(np.abs(a - b) / np.maximum(
                    np.abs(b), 1e-30), initial=0.0)))
            else:
                int_diff += int((a != b).sum())
        segs_equal &= segs == _segs(want_hyps[i])
    g = s.graph
    out = {"graph": f"{g.rc_mode}/{g.lc_mode}/{g.lex_mode}",
           "utterances": len(got), "share": len(mine), "share_s": share_s,
           "int_values_differing": int_diff, "float_max_rel_diff": rel,
           "segments_equal": segs_equal}
    if len(got) != len(fx.ceps) or int_diff or rel > TAPE_RTOL or \
            not segs_equal:
        raise AssertionError(f"data-parallel {name} decode != one-process "
                             f"decode: {out}")
    return out


def dryrun_multichip(n_ranks: int, device: torch.device | str = "cuda", *,
                     fx=None, coordinator: Optional[str] = None,
                     rank: Optional[int] = None) -> dict:
    """Run the three checks on this rank of an `n_ranks` process group
    (joined by `init_distributed` from the arguments or torchrun's
    environment; NCCL for "cuda", gloo for "cpu").  `fx`: the fixture the
    decodes run on (default `fixture.build(0, size=fixture.SMALL)`).
    Returns the measurements; raises on any difference."""
    up = dist.is_initialized()
    if not up and n_ranks == 1 and coordinator is None and \
            not os.environ.get("MASTER_ADDR"):
        coordinator, rank = f"localhost:{free_port()}", 0
    info = init_distributed(coordinator, n_ranks, rank, device=device)
    if not info.initialized or info.num_processes != n_ranks:
        raise RuntimeError(f"dryrun_multichip({n_ranks}): joined {info}")
    try:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if torch.device(device).type == "cuda" else torch.device("cpu"))
        fx = fx if fx is not None else fixture.build(0, size=fixture.SMALL)
        out = {"ranks": n_ranks, "rank": info.process_id,
               "backend": dist.get_backend(), "device": str(dev),
               **_check_training(info, dev),
               "decode": {name: _check_decode(info, dev, fx, name, kw)
                          for name, kw in (("mpx", {}),
                                           ("tree", TREE))}}
        dist.barrier()
        return out
    finally:
        if not up:
            dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu "
                    "(gloo)")
    args = ap.parse_args(argv)
    out = dryrun_multichip(int(os.environ.get("WORLD_SIZE") or 1),
                           args.device)
    if out["rank"] == 0:
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
