"""Port parity for the multi-process runtime (`parallel/hosts.py`:
`HostInfo`, `init_distributed`, `partition_ctl`, `local_partition`)
against the JAX package, the senone shards of `parallel/senone_shard.py`,
and the port's multi-process runs over gloo: `parallel/dryrun.py` on two
ranks (dp=1 x mp=2) and four (dp=2 x mp=2), and `cli/batch -npart 2` on
two ranks.

`score_shards` at mp = 2 and 3 equals the unsharded scorer bit for bit
(the plain ContinuousScorer in each -gmmprec mode; PsParityScorer with 8-
and 4-bit weights), at the SMALL and the FULL widths.

Partitions are integers and equal.  The dry run holds its own checks (see
its module: em_step_sharded against em_step within rtol 1e-5 and 1e-4 /
1e-5 on the parameters, summed accumulators within 2e-5, gathered tapes
with integers equal and floats within rtol 1e-5).  The two `cli/batch`
ranks' hypothesis files, joined, equal the one-process run's byte for
byte.  Multi-rank runs are their own processes with a timeout, so that a
hung rendezvous fails the test.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cmusphinx_tpu.parallel import hosts as jhosts
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.cli import batch
from cmusphinx_tpu_torch.frontend import FeatPipeline
from cmusphinx_tpu_torch.ops import ContinuousScorer, PsParityScorer
from cmusphinx_tpu_torch.parallel import (HostInfo, init_distributed,
                                          local_partition, partition_ctl)
from cmusphinx_tpu_torch.parallel.dryrun import free_port, mesh
from cmusphinx_tpu_torch.parallel.senone_shard import (score_shards,
                                                       shard_range, shards)
from cmusphinx_tpu_torch.utils.bio import write_mfc

ROOT = pathlib.Path(__file__).resolve().parent.parent
ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def test_partitions_match_reference():
    for n in (0, 1, 5, 11, 16):
        items = [f"u{i}" for i in range(n)]
        for npart in (1, 2, 3, 7):
            parts = [partition_ctl(items, p, npart)
                     for p in range(1, npart + 1)]
            assert parts == [jhosts.partition_ctl(items, p, npart)
                             for p in range(1, npart + 1)]
            assert sum(parts, []) == items
            for pid in range(npart):
                info, jinfo = (HostInfo(pid, npart, True),
                               jhosts.HostInfo(pid, npart, True))
                assert local_partition(items, info) == \
                    jhosts.local_partition(items, jinfo)
                assert info.is_primary == jinfo.is_primary == (pid == 0)
    for bad in (0, 4):
        with pytest.raises(ValueError):
            partition_ctl(list(range(5)), bad, 3)
    assert batch.partition_ctl is partition_ctl


def test_single_process_is_a_noop(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    info = init_distributed(device="cpu")
    assert info == HostInfo(0, 1, False) and info.is_primary
    assert not dist.is_initialized()
    # torchrun's variables for a run of one process without a coordinator.
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert init_distributed(device="cpu") == HostInfo(0, 1, False)
    assert local_partition(list(range(4))) == [0, 1, 2, 3]
    # Several processes need a coordinator.
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(device="cpu")


def test_environment_and_arguments_join_a_group(monkeypatch):
    """torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK join a gloo
    group of one; explicit arguments win over them; a group already up is
    joined as it is."""
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    try:
        info = init_distributed(device="cpu")
        assert info == HostInfo(0, 1, True)
        assert dist.get_backend() == "gloo"
        assert init_distributed("nowhere:1", 5, 3) == HostInfo(0, 1, True)
        assert local_partition(list(range(3))) == [0, 1, 2]
    finally:
        dist.destroy_process_group()
    monkeypatch.setenv("WORLD_SIZE", "7")        # the argument wins
    try:
        info = init_distributed(f"tcp://localhost:{free_port()}", 1, 0,
                                device="cpu")
        assert info == HostInfo(0, 1, True)
    finally:
        dist.destroy_process_group()


def _ranks(cmd, n: int, cwd, timeout: int = 180) -> list:
    """Run `cmd` as ranks 0..n-1 of one gloo group (torchrun's
    variables); returns their completed processes."""
    port = free_port()
    base = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    base.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                MASTER_ADDR="localhost", MASTER_PORT=str(port),
                WORLD_SIZE=str(n))
    procs = [subprocess.Popen(cmd, env=dict(base, RANK=str(r)), cwd=cwd,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            p.kill()
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    return outs


DECODES = (("mpx", "fanout/mpx/flat", "ContinuousScorer"),
           ("tree", "composite/composite/tree", "ContinuousScorer"),
           ("semi", "fanout/mpx/flat", "PsParityScorer"))


def _dryrun(n: int) -> list:
    outs = _ranks([sys.executable, "-m",
                   "cmusphinx_tpu_torch.parallel.dryrun", "--device", "cpu"],
                  n, ROOT)
    for _, out, _ in outs[1:]:
        assert out.strip() == ""          # only rank 0 prints
    return json.loads(outs[0][1].strip().splitlines()[-1])


def test_dryrun_two_gloo_ranks():
    """dp=1 x mp=2: both ranks decode every utterance, each scoring half
    of the senones."""
    res = _dryrun(2)
    assert (res["ranks"], res["rank"], res["backend"]) == (2, 0, "gloo")
    assert (res["dp"], res["mp"]) == (1, 2)
    assert res["em_step_sharded"]["utterances"] == 5
    assert res["partition"]["share"] == 3
    for name, graph, scorer in DECODES:
        d = res["decode"][name]
        assert (d["graph"], d["scorer"]) == (graph, scorer)
        assert d["utterances"] == d["share"] == 3
        assert d["shard"] == [0, d["senones"] // 2]
        assert d["scores_equal"] and d["ranks_equal"]
        assert d["int_values_differing"] == 0 and d["segments_equal"]


def test_dryrun_four_gloo_ranks():
    """dp=2 x mp=2: the utterances split over the two dp groups."""
    res = _dryrun(4)
    assert (res["ranks"], res["dp"], res["mp"]) == (4, 2, 2)
    assert res["em_step_sharded"]["utterances"] == 9
    for name, graph, scorer in DECODES:
        d = res["decode"][name]
        assert (d["graph"], d["scorer"]) == (graph, scorer)
        assert (d["utterances"], d["share"]) == (3, 2)
        assert d["scores_equal"] and d["ranks_equal"]
        assert d["int_values_differing"] == 0 and d["segments_equal"]


def test_mesh_and_shard_ranges():
    assert [mesh(n) for n in (1, 2, 3, 4, 6, 8)] == [
        (1, 1), (1, 2), (3, 1), (2, 2), (3, 2), (4, 2)]
    for S, mp in ((5150, 2), (5150, 3), (96, 3), (7, 4)):
        ranges = [shard_range(S, mp, r) for r in range(mp)]
        assert ranges[0][0] == 0 and ranges[-1][1] == S
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert {hi - lo for lo, hi in ranges[:-1]} == {-(-S // mp)}
    assert shard_range(5150, 3, 2) == (3434, 5150)
    with pytest.raises(ValueError, match="do not fill"):
        shard_range(4, 3, 0)


@pytest.fixture(scope="module")
def shard_cases():
    """Per width: the continuous and semi-continuous fixtures, 120 frames
    of each's features, and a 4-bit sendump over a 16-entry codebook of
    byte values up to 255 (so the uint8 wrap happens)."""
    out = {}
    for name, size in (("SMALL", fixture.SMALL), ("FULL", fixture.FULL)):
        fxs = {m: fixture.build(0, model=m, size=size)
               for m in ("cont", "semi")}
        x = {m: torch.as_tensor(np.concatenate(FeatPipeline(
            fx.feat_config(), device="cpu").compute_batch(fx.ceps[:2]))[:120])
             for m, fx in fxs.items()}
        raw8, _ = fixture.sendump_bytes(fxs["semi"])
        rng = np.random.RandomState(5)
        cb = np.sort(rng.choice(256, 16, replace=False)).astype(np.uint8)
        out[name] = (fxs, x, raw8, cb[rng.randint(16, size=raw8.shape)])
    return out


@pytest.mark.parametrize("mp", [2, 3])
@pytest.mark.parametrize("kind", ["highest", "high", "bf16", "ps8", "ps4"])
@pytest.mark.parametrize("width", ["SMALL", "FULL"])
def test_score_shards_equal_unsharded(width, kind, mp, shard_cases):
    fxs, x, raw8, raw4 = shard_cases[width]
    if kind.startswith("ps"):
        fx, feats = fxs["semi"], x["semi"]
        sc = PsParityScorer(fx.gauden, raw8 if kind == "ps8" else raw4,
                            fx.stream_slices(), wrap_uint8=kind == "ps4",
                            device="cpu")
    else:
        fx, feats = fxs["cont"], x["cont"]
        sc = ContinuousScorer(fx.gauden, fx.ln_mixw, precision=kind,
                              device="cpu")
    want = sc.score(feats)
    got = score_shards(sc, feats, mp)
    assert got.shape == want.shape == (120, fx.mdef.n_sen)
    assert torch.equal(got, want)
    # Each shard holds every buffer of the scorer, those on the senone
    # axis cut to its own senones.
    parts = shards(sc, mp)
    assert sum(p.n_sen for p in parts) == sc.n_sen
    whole = dict(sc.named_buffers())
    axis = {"mixw": 2} if kind.startswith("ps") else {
        "lin": 0, "quad": 0, "const": 0}
    for r, p in enumerate(parts):
        lo, hi = shard_range(sc.n_sen, mp, r)
        mine = dict(p.named_buffers())
        assert mine.keys() == whole.keys()
        for name, buf in mine.items():
            want_buf = whole[name]
            if name in axis:
                want_buf = want_buf.narrow(axis[name], lo, hi - lo)
            assert torch.equal(buf, want_buf), name
    # A batch axis passes through.
    assert torch.equal(score_shards(sc, feats.view(2, 60, -1), mp),
                       want.view(2, 60, -1))


def test_batch_cli_two_ranks_pick_their_parts(tmp_path):
    fx = fixture.build(0, size=fixture.SMALL)
    kw = fixture.write_model_dir(fx, str(tmp_path / "model"))
    ceps = tmp_path / "ceps"
    ceps.mkdir()
    for i, c in enumerate(fx.ceps):
        write_mfc(str(ceps / f"u{i}.mfc"), c)
    (tmp_path / "c.ctl").write_text("u0\nu1\nu2\n")
    argv = ["-hmm", kw["hmm"], "-lm", kw["lm"], "-dict", kw["dict"],
            "-ctl", str(tmp_path / "c.ctl"), "-cepdir", str(ceps),
            "-platform", "cpu", "-npart", "2"]
    assert batch.main(argv + ["-hyp", str(tmp_path / "one.hyp")]) == 0
    cmd = [sys.executable, "-c",
           "import os, sys; from cmusphinx_tpu_torch.cli import batch; "
           "sys.exit(batch.main(sys.argv[1:] + ['-hyp', 'rank' + "
           "os.environ['RANK'] + '.hyp']))"] + argv
    outs = _ranks(cmd, 2, tmp_path)
    parts = [(tmp_path / f"rank{r}.hyp").read_text() for r in (0, 1)]
    assert parts[0].count("\n") == 2 and parts[1].count("\n") == 1
    assert parts[0] + parts[1] == (tmp_path / "one.hyp").read_text()
    assert "u2: " in outs[1][1] and "u2: " not in outs[0][1]
