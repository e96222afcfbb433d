"""The one-copy tree step's channel update (`ops/tree_step.py`) on the CPU:
the wrappers' contract and where the search calls them.

- On CPU tensors `step_exits` and `prune_enter` run their plain version
  and launch nothing; `prune_enter` writes the new carry into the old one,
  on valid rows only.
- They raise on a wrong dtype, shape or device.
- Only the one-copy tree step (`ngram_steps.TreeStep`) calls them: the
  static step and the tree copies keep `ops/hmm.py`.
- `_block_len`: the static step's block at the semi cell's shapes is what
  it was; the one-copy tree counts its senone-sequence rows.

The kernels themselves, against this plain version bit for bit, are in
tests/test_torch_cuda.py; the search through the plain version against the
JAX package in tests/test_torch_tree.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.decode import NgramSearch
from cmusphinx_tpu_torch.decode.ngram_steps import (StaticStep,
                                                    TreeCopiesStep, TreeStep)
from cmusphinx_tpu_torch.frontend import FeatPipeline
from cmusphinx_tpu_torch.ops import ContinuousScorer, tree_step
from cmusphinx_tpu_torch.ops.hmm import NEG_INF


def planted(S, C, B, n_xs, R, n_ci, seed):
    """A tree step's inputs with planted ties: every score an integer in a
    narrow range (so adds tie), a quarter of the channels at NEG_INF, ages
    0, 1, 253, 254 and 255 among random ones; random tables, the first R
    channels the roots.  Returns (alpha0, ages, rows, tables, ent, corr,
    la_t), on the CPU."""
    rng = np.random.RandomState(seed)

    def ints(*shape, lo=-6, hi=0):
        return torch.as_tensor(rng.randint(lo, hi + 1, shape)
                               .astype(np.float32))

    alpha = ints(B, C, S, lo=-8)
    alpha[torch.as_tensor(rng.rand(B, C) < 0.25)] = NEG_INF
    ages = rng.randint(0, 256, (B, C, S))
    ages[rng.rand(B, C, S) < 0.2] = 255
    ages[rng.rand(B, C, S) < 0.2] = 254
    ages.flat[:5] = [0, 1, 253, 254, 255]
    is_entry = np.arange(C) < R
    has_prev = ~is_entry & (rng.rand(C) < 0.95)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32))

    bands = (ints(C, S, lo=-2), ints(C, S - 1, lo=-2),
             ints(C, max(S - 2, 0), lo=-2), ints(C, lo=-2),
             ints(C, lo=-2) if S >= 2 else torch.full((C,), NEG_INF))
    tab = tree_step.Tables(
        i32(rng.randint(0, n_xs, C)),
        i32(np.where(has_prev, rng.randint(0, C, C), 0)),
        torch.as_tensor(has_prev), torch.as_tensor(is_entry),
        i32(np.where(is_entry, np.arange(C), 0)),
        i32(rng.randint(0, n_ci, C)), ints(C, lo=-2, hi=2), ints(C, lo=-3),
        bands, True, -6.0, -5.0, -1.0)
    return (alpha, torch.as_tensor(ages.astype(np.uint8)),
            ints(B, n_xs, S, lo=-4), tab, ints(B, lo=-12, hi=-4),
            ints(B, R, lo=-2, hi=2), ints(B, n_ci, lo=-3))


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("S", [1, 3, 5])
def test_cpu_tensors_take_the_plain_version(S):
    alpha, ages, rows, tab, ent, corr, la = planted(S, 501, 3, 41, 9, 7, S)
    valid = torch.tensor([True, False, True])
    tree_step.launches.clear()
    st = tree_step.step_exits(alpha, ages, rows, tab)
    want = tree_step.step_exits_ref(alpha, ages, rows, tab)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(st, want))
    assert st.hist.dtype == torch.uint8 and (st.hist > 0).all()
    assert torch.equal(st.best, st.alpha.flatten(1).amax(1))
    a0, h0 = alpha.clone(), ages.clone()
    out = tree_step.prune_enter(a0, h0, st, ent, corr, la, valid, tab)
    assert out[0] is a0 and out[1] is h0
    ref = tree_step.prune_enter_ref(alpha.clone(), ages.clone(), st, ent,
                                    corr, la, valid, tab)
    assert torch.equal(_bits(out[0]), _bits(ref[0]))
    assert torch.equal(out[1], ref[1])
    # The invalid row keeps its carry; the valid ones moved.
    assert torch.equal(a0[1], alpha[1]) and torch.equal(h0[1], ages[1])
    assert not torch.equal(a0[0], alpha[0])
    # Entries at the roots carry age 0.
    assert (h0[0, tab.is_entry, 0] == 0).any()
    assert not tree_step.launches


def test_wrappers_raise_on_wrong_inputs():
    alpha, ages, rows, tab, ent, corr, la = planted(3, 101, 2, 17, 5, 4, 0)
    valid = torch.ones(2, dtype=torch.bool)
    st = tree_step.step_exits(alpha, ages, rows, tab)
    step = tree_step.step_exits
    with pytest.raises(TypeError):
        step(alpha.double(), ages, rows, tab)
    with pytest.raises(TypeError):
        step(alpha, ages.long(), rows, tab)
    with pytest.raises(ValueError):
        step(alpha, ages, rows[..., :2], tab)
    with pytest.raises(ValueError):
        step(alpha, ages, rows, tab._replace(xs=tab.xs[:-1]))
    with pytest.raises(TypeError):
        step(alpha, ages, rows, tab._replace(pc=tab.pc.long()))
    with pytest.raises(ValueError, match="no tree-step kernel"):
        step(alpha.to("meta"), ages.to("meta"), rows.to("meta"),
             tab._replace(**{k: v.to("meta") for k, v in tab._asdict().items()
                             if isinstance(v, torch.Tensor)},
                          bands=tuple(b.to("meta") for b in tab.bands)))
    with pytest.raises(ValueError, match="different devices"):
        step(alpha, ages, rows.to("meta"), tab)
    enter = tree_step.prune_enter
    with pytest.raises(TypeError):
        enter(alpha, ages, st, ent, corr, la, valid.int(), tab)
    with pytest.raises(ValueError):
        enter(alpha, ages, st, ent[:1], corr, la, valid, tab)
    with pytest.raises(ValueError):
        enter(alpha, ages, st, ent, corr[:1], la, valid, tab)
    with pytest.raises(ValueError):
        enter(alpha, ages, st._replace(ex=st.ex[:, :-1]), ent, corr, la,
              valid, tab)
    with pytest.raises(ValueError, match="different devices"):
        enter(alpha, ages, st, ent, corr, la.to("meta"), valid, tab)


@pytest.fixture(scope="module")
def medium():
    return fixture.build(0, size=fixture.MEDIUM)


@pytest.mark.parametrize("kw,calls", [
    ({"lexmode": "flat"}, 0), ({"lexmode": "tree", "nlextree": 2}, 0),
    ({"lexmode": "tree", "nlextree": 3, "pl_window": 3}, 0),
    ({"lexmode": "tree"}, 1), ({"lexmode": "tree", "pl_window": 3}, 1)])
def test_only_the_one_copy_tree_step_calls_the_wrappers(medium, kw, calls,
                                                         monkeypatch):
    """A block of frames of each step: `TreeStep` calls each wrapper once
    a frame, the static step and the tree copies never."""
    fx, K = medium, 4
    s = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                    ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu"),
                    device="cpu", **kw)
    seen = []
    for name in ("step_exits", "prune_enter"):
        real = getattr(tree_step, name)
        monkeypatch.setattr(tree_step, name, lambda *a, _r=real, _n=name:
                            seen.append(_n) or _r(*a))
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    x, T, _ = s._pad([fp.compute(c) for c in fx.ceps[:2]])
    B, F = x.shape[0], x.shape[1]
    scores = s.scorer.score(x)
    la = s._lookahead(scores, F) if s.pl_window else None
    carry = s.step.init_carry(B, F)
    tape = s._tape(B, F)
    with torch.inference_mode():
        s._block(carry, (scores[:, :K],
                         (torch.arange(F)[None] < T[:, None])[:, :K],
                         None if la is None else la[:, :K]),
                 torch.zeros((), dtype=torch.int64),
                 tuple(a[:, :K] for a in tape))
    assert seen == ["step_exits", "prune_enter"] * (K * calls)


def _block_len(B, n, n_chan, n_xs, comp, step):
    """`NgramSearch._block_len` with the frame step class `step` on a
    graph of these sizes (S = 3)."""
    stub = SimpleNamespace(
        FRAME_BUCKET=NgramSearch.FRAME_BUCKET, step=step,
        graph=SimpleNamespace(n_chan=n_chan, n_xs=n_xs, n_emit_state=3,
                              comp_mem=SimpleNamespace(size=comp)))
    return NgramSearch._block_len(stub, B, n)


def test_block_len_static_unchanged_tree_counts_its_rows():
    """The semi cell's flat graph (hub4wsj-sc-5k: 25,487 channels, 16,570
    senone-sequence rows, 300,390 composite members) keeps its blocks of
    5 frames a batch of 16 (and 50 a stream's chunk).  The 64k cell's tree
    (hub4cont-64k: 262,717 channels, 60,636 rows, 328,536 members) holds
    only its rows in one copy: blocks of 5 frames, where its expansion to
    every channel (the tree copies' block) allows 2."""
    semi, hub = (25487, 16570, 300390), (262717, 60636, 328536)
    assert [_block_len(16, n, *semi, StaticStep)
            for n in (200, 600, 1600)] == [5, 5, 5]
    assert _block_len(1, 50, *semi, StaticStep) == 50
    assert _block_len(16, 600, *hub, TreeStep) == 5
    assert _block_len(16, 600, *hub, TreeCopiesStep) == 2
    assert _block_len(1, 50, *hub, TreeStep) == 50


def test_every_library_builds_in_one_parallel_step(tmp_path, monkeypatch):
    """`cuda_libs.build_all`: the units of every library not built yet go
    to nvcc at once (K1's four, the tree step's one, the PTM parity
    kernel's one, the mpx step's one and the entries kernel's one), then
    each library is linked under its hashed name; a second call builds
    nothing."""
    from cmusphinx_tpu_torch.ops import cuda_libs
    monkeypatch.setattr(cuda_libs, "BUILD_DIR", tmp_path)
    started, waited, linked = [], [], []

    class Nvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            started.append(cmd)

        def communicate(self):
            waited.append(len(started))
            return ("", None)

    def link(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        open(out, "w").close()
        linked.append(cmd)
        return SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(cuda_libs.subprocess, "Popen", Nvcc)
    monkeypatch.setattr(cuda_libs.subprocess, "run", link)
    assert cuda_libs.build_all() >= 0.0
    units = sum(len(u) for _, u in cuda_libs.LIBRARIES.values())
    assert units == 8 and len(started) == units
    assert waited == [units] * units            # all started before a wait
    assert sorted(c[-1] for c in started) == sorted(
        str(src) for src, u in cuda_libs.LIBRARIES.values() for _ in u)
    assert len(linked) == len(cuda_libs.LIBRARIES)
    for name in cuda_libs.LIBRARIES:
        so = cuda_libs.library_path(name)
        assert so.parent == tmp_path and so.name.startswith(f"lib{name}-")
        assert so.exists() and so.with_suffix(".log").exists()
    started.clear()
    assert cuda_libs.build_all() == 0.0 and not started


def test_least_bytes_at_the_64k_cell():
    """The fewest bytes of the 64k cell's channel update (B=16, C=262,717,
    S=3, n_xs=60,636, R=1,523, 40 CI phones): 15 bytes a state (alpha0 and
    the ages read in each pass, the carry written once) with the rows,
    tables, exits and small arrays; the two kernels move 5 bytes a state
    more, less the second read of the rows, their indices and the
    bands."""
    B, C, S, n_xs = 16, 262717, 3, 60636
    least = tree_step.least_bytes(B, C, S, n_xs, 1523, 40, lookahead=True)
    assert least == 279_270_822
    second_read = 4 * B * n_xs * S + 4 * C * 3 * S
    assert least + 5 * B * C * S - second_read == 321_222_978
