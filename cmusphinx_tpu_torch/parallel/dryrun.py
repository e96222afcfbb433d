"""Dry run of the port's multi-process paths over `torch.distributed`.

The counterpart of the reference's `dryrun_multichip` (the JAX package's
`__graft_entry__.py`), on the port's own seeded fixtures.  Every rank of
one process group calls `dryrun_multichip(n_ranks, device)`.  The ranks
form the reference's mesh (`mesh`): `mp = 2` where the rank count is even,
else 1, and `dp = n // mp`; ranks `g*mp .. g*mp + mp - 1` are the `mp`
group of data-parallel index g.  It checks three things, each against the
one-process run on the same device, and raises on any difference:

1. training: one `Trainer.em_step_sharded` step (utterances split over the
   ranks, accumulators reduced by `all_reduce`) against `em_step`;
2. the `-part`/`-npart` contract: each rank's accumulators over its
   `local_partition` of the corpus, summed over the ranks (and, on every
   rank, over a two-part split), against the single pass;
3. serving: a batched decode over the mesh, on the continuous slice's mpx
   graph (the flat fanout/mpx graph) and prefix tree and on the
   semi-continuous slice (`PsParityScorer`): each dp group decodes its
   share of the utterances, its mp ranks with a `SenoneShardedScorer`
   (K1 on a senone shard, or the epilogue on a slice of the mixture
   weights, and an all_gather of the scores).  The share's senone scores
   equal the unsharded scorer's bit for bit; the ranks of a group give
   identical tapes; the tapes and segments are gathered, and every
   utterance's are held to the one-process batch decode (integers
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
from ..ops import ContinuousScorer, PsParityScorer
from ..ops.fused_gmm import fused_mixture_scores
from ..train.sentence_hmm import FlatModel
from ..train.trainer import Trainer, host_acc
from .hosts import HostInfo, init_distributed, local_partition, partition_ctl
from .senone_shard import SenoneShardedScorer

# Sharded EM against em_step (the two-rank CPU test's bounds) and summed
# partition accumulators against the single pass (the reference's).
LL_RTOL, PARAM_RTOL, PARAM_ATOL, ACC_TOL = 1e-5, 1e-4, 1e-5, 2e-5
TAPE_RTOL = 1e-5
# The reference dry run's prefix-tree configuration.
TREE = {"rcmode": "composite", "lcmode": "composite", "lexmode": "tree"}


def mesh(n_ranks: int) -> tuple:
    """The reference's mesh rule: (dp, mp), mp = 2 on an even count of
    ranks, else 1."""
    mp = 2 if n_ranks % 2 == 0 and n_ranks >= 2 else 1
    return n_ranks // mp, mp


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


def _scorer(fx, dev):
    """The slice's scorer: K1 for the continuous fixture, PsParityScorer
    over its sendump for the semi-continuous one."""
    if fx.model == "cont":
        return ContinuousScorer(fx.gauden, fx.ln_mixw, device=dev)
    raw, meta = fixture.sendump_bytes(fx)
    return PsParityScorer(fx.gauden, raw, fx.stream_slices(),
                          wrap_uint8=meta["n_bits"] == 4, device=dev)


def _check_decode(info, dev, fx, name: str, kw: dict, group) -> dict:
    """Decode `fx` over the mesh (`group`: this rank's mp group, None
    where mp = 1) and hold it to the one-process decode."""
    dp, mp = mesh(info.num_processes)
    full = _scorer(fx, dev)
    fp = FeatPipeline(fx.feat_config(), device=dev)
    s = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, full, device=dev,
                    **kw)
    E = s.E
    want_hyps = s.decode_batch_cep(fx.ceps, fp)
    want = [t.cpu().numpy() for t in s._last_batch[0]]
    Ts = s._pad(fx.ceps)[2]
    mine = local_partition(list(range(len(fx.ceps))),
                           HostInfo(info.process_id // mp, dp, True))
    ceps = [fx.ceps[i] for i in mine]
    scores_equal = None                # nothing sharded where mp = 1
    if mp > 1:
        s.scorer = SenoneShardedScorer(full, group, info.process_id % mp,
                                       mp)
        # The share's senone scores, sharded against unsharded.
        feats = s._pad(fp.compute_batch(ceps))[0]
        scores_equal = bool(torch.equal(s.scorer.score(feats),
                                        full.score(feats)))
    t0 = time.perf_counter()
    hyps = s.decode_batch_cep(ceps, fp)
    share_s = time.perf_counter() - t0
    tapes = [t.cpu().numpy() for t in s._last_batch[0]]
    rows = {i: ([t[j, : Ts[i] * E] for t in tapes], _segs(h))
            for j, (i, h) in enumerate(zip(mine, hyps))}
    gathered = [None] * info.num_processes
    dist.all_gather_object(gathered, rows)
    got, ranks_equal = {}, True
    for g in gathered:
        for k, (tape, segs) in g.items():
            if k in got:       # another rank of the mp group: identical
                ranks_equal &= segs == got[k][1] and all(
                    np.array_equal(a, b) for a, b in zip(tape, got[k][0]))
            got[k] = (tape, segs)
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
           "scorer": type(full).__name__, "utterances": len(got),
           "share": len(mine), "share_s": share_s,
           "senones": full.n_sen, "shard": (
               [s.scorer.lo, s.scorer.hi] if mp > 1 else [0, full.n_sen]),
           "scores_equal": scores_equal, "ranks_equal": ranks_equal,
           "int_values_differing": int_diff, "float_max_rel_diff": rel,
           "segments_equal": segs_equal}
    if len(got) != len(fx.ceps) or int_diff or rel > TAPE_RTOL or \
            not segs_equal or scores_equal is False or not ranks_equal:
        raise AssertionError(f"{name} decode over the mesh != one-process "
                             f"decode: {out}")
    return out


def dryrun_multichip(n_ranks: int, device: torch.device | str = "cuda", *,
                     fx=None, semi_fx=None, coordinator: Optional[str] = None,
                     rank: Optional[int] = None) -> dict:
    """Run the three checks on this rank of an `n_ranks` process group
    (joined by `init_distributed` from the arguments or torchrun's
    environment; NCCL for "cuda", gloo for "cpu").  `fx`, `semi_fx`: the
    continuous and semi-continuous fixtures the decodes run on (default
    `fixture.build(0, ..., size=fixture.SMALL)`).  Returns the
    measurements, with K1's launches on this rank; raises on any
    difference."""
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
        if semi_fx is None:
            semi_fx = fixture.build(0, model="semi", size=fixture.SMALL)
        dp, mp = mesh(n_ranks)
        # Every rank makes every group, in one order.
        groups = [dist.new_group(list(range(g * mp, g * mp + mp)))
                  for g in range(dp)] if mp > 1 else [None] * dp
        group = groups[info.process_id // mp]
        launches = fused_mixture_scores.launches
        out = {"ranks": n_ranks, "rank": info.process_id, "dp": dp,
               "mp": mp, "backend": dist.get_backend(), "device": str(dev),
               **_check_training(info, dev),
               "decode": {name: _check_decode(info, dev, f, name, kw, group)
                          for name, f, kw in (("mpx", fx, {}),
                                              ("tree", fx, TREE),
                                              ("semi", semi_fx, {}))}}
        out["k1_launches"] = fused_mixture_scores.launches - launches
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
