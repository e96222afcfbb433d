"""The mpx step's channel update (`ops/mpx_step.py`) on the CPU: the
wrappers' contract and where the search calls them.

- On CPU tensors `step_exits` and `prune_enter` run their plain version
  and launch nothing; `prune_enter` writes the new carry into the old one,
  on valid rows only.
- The plain version equals the composition the mpx step ran before it
  (`hmm_step` through a `gather` of the senone rows, `_prune`, the
  propagation and entry routing, `hmm_enter`, the valid mask; int64
  payloads) bit for bit, with planted ties, NEG_INF states, padded rows,
  the phone-loop lookahead on and off, the beams on and off.
- They raise on a wrong dtype, shape or device.
- Only the mpx step (`MpxStep`) calls them: the static step, the tree
  and the tree copies never.
- `least_bytes` at the PTM cell's shape.

The kernels themselves, against this plain version bit for bit, are in
tests/test_torch_cuda.py; the search through the plain version against the
JAX package in tests/test_torch_ngram_search.py, test_torch_stream.py and
test_torch_graph.py.
"""

import numpy as np
import pytest
import torch

from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.decode import NgramSearch
from cmusphinx_tpu_torch.frontend import FeatPipeline
from cmusphinx_tpu_torch.ops import ContinuousScorer, mpx_step
from cmusphinx_tpu_torch.ops.hmm import NEG_INF, hmm_enter, hmm_step


def planted(S, C, B, n_xs, W, n_ci, seed, n_lc=13):
    """An mpx step's inputs with planted ties: every score an integer in a
    narrow range (so adds tie), a quarter of the channels and a twentieth
    of the senone rows at NEG_INF, random payloads and tables (a fifth of
    the channels entry channels).  Returns (carry, rows, tables, ent_w,
    ent_pay, la_t), on the CPU."""
    rng = np.random.RandomState(seed)

    def ints(*shape, lo=-6, hi=0):
        return torch.as_tensor(rng.randint(lo, hi + 1, shape)
                               .astype(np.float32))

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32))

    alpha = ints(B, C, S, lo=-8)
    alpha[torch.as_tensor(rng.rand(B, C) < 0.25)] = NEG_INF
    carry = (alpha, i32(rng.randint(-1, 600, (B, C, S))),
             i32(rng.randint(0, n_xs, (B, C, S))),
             i32(rng.randint(-1, 900, (B, C, S))),
             i32(rng.randint(-1, 900, (B, C, S))))
    rows = ints(B, n_xs, S, lo=-4)
    rows[torch.as_tensor(rng.rand(B, n_xs, S) < 0.05)] = NEG_INF
    is_entry = rng.rand(C) < 0.2
    has_prev = ~is_entry & (rng.rand(C) < 0.95)
    bands = (ints(C, S, lo=-2), ints(C, S - 1, lo=-2),
             ints(C, max(S - 2, 0), lo=-2), ints(C, lo=-2),
             ints(C, lo=-2) if S >= 2 else torch.full((C,), NEG_INF))
    tab = mpx_step.Tables(
        i32(rng.randint(0, n_xs, C)),
        i32(np.where(has_prev, rng.randint(0, C, C), 0)),
        torch.as_tensor(has_prev), torch.as_tensor(is_entry),
        i32(rng.randint(0, W, C)),
        i32(np.where(is_entry, rng.randint(0, n_lc, C) * n_ci, 0)),
        i32(rng.randint(0, n_ci, C)), i32(rng.randint(0, n_xs, n_lc * n_ci)),
        bands, True, -6.0, -5.0, -1.0)
    ent_w = ints(B, W, lo=-12, hi=-4)
    ent_w[torch.as_tensor(rng.rand(B, W) < 0.3)] = NEG_INF
    ent_pay = torch.stack([i32(rng.randint(-1, 600, (B, W))),
                           i32(rng.randint(0, n_ci, (B, W))),
                           i32(rng.randint(-1, 900, (B, W))),
                           i32(rng.randint(-1, 900, (B, W)))], -1)
    return carry, rows, tab, ent_w, ent_pay, ints(B, n_ci, lo=-3)


def previous_step(carry, rows, tab, ent_w, ent_pay, la_t, valid):
    """The channel update as the mpx step composed it before `mpx_step`:
    int64 payloads, the senone rows gathered to [B, C, S], `hmm_step`,
    `_prune`, the propagation and entry routing, `hmm_enter`, the valid
    mask.  Returns (the new carry, the pruned exits and their payloads)."""
    alpha0, hist0, xsr0, hw20, hw10 = (carry[0],) + tuple(
        p.long() for p in carry[1:])
    B = alpha0.shape[0]
    neg = NEG_INF
    sen_c = torch.gather(rows, 1, xsr0)
    alpha, (hist, xsr, hw2, hw1), ex, (exh, _, exh2, exh1) = hmm_step(
        alpha0, (hist0, xsr0, hw20, hw10), sen_c, tab.bands)
    if tab.prune:
        bestscr = alpha.flatten(1).amax(1).view(-1, 1)
        cmax = alpha.amax(-1)
        if la_t is not None:
            cmax = cmax + la_t[:, tab.ci_of.long()].view(B, -1)
        keep = cmax > bestscr + tab.log_beam
        alpha = torch.where(keep[..., None], alpha, neg)
        ex = torch.where(ex > bestscr + tab.log_wbeam, ex, neg)
    ebp_w, lcstar, eh2_w, eh1_w = ent_pay.long().unbind(-1)
    wo, pc, ie = tab.word_of.long(), tab.pc.long(), tab.is_entry
    ent_xs_c = tab.lcmap.long()[tab.lc_base.long() + lcstar[:, wo]]
    prop = torch.where(tab.has_prev, ex[:, pc] + tab.pip, neg)
    bprop = torch.where(tab.has_prev, exh[:, pc], -1)
    alpha, pays = hmm_enter(
        alpha, (hist, xsr, hw2, hw1), torch.where(ie, ent_w[:, wo], prop),
        (torch.where(ie, ebp_w[:, wo], bprop),
         torch.where(ie, ent_xs_c, tab.xs.long()),
         torch.where(ie, eh2_w[:, wo], exh2[:, pc]),
         torch.where(ie, eh1_w[:, wo], exh1[:, pc])))
    v = valid[:, None, None]
    new = tuple(torch.where(v, n, o) for n, o in zip(
        (alpha,) + pays, (alpha0, hist0, xsr0, hw20, hw10)))
    return new, (ex, exh, exh2, exh1)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b):
    """Equal bit for bit (floats) or in value (integers of any width)."""
    return all(torch.equal(_bits(x), _bits(y)) if x.dtype == torch.float32
               else torch.equal(x.long(), y.long())
               for x, y in zip(a, b, strict=True))


def _copy(carry):
    return tuple(t.clone() for t in carry)


@pytest.mark.parametrize("S", [1, 2, 3, 5])
def test_cpu_tensors_take_the_plain_version(S):
    carry, rows, tab, ent_w, ent_pay, la = planted(S, 501, 3, 41, 37, 7, S)
    valid = torch.tensor([True, False, True])
    mpx_step.launches.clear()
    st = mpx_step.step_exits(carry, rows, tab)
    want = mpx_step.step_exits_ref(carry, rows, tab)
    assert _same(st, want)
    assert st.exh3.dtype == torch.int32 and st.exh3.shape == (3, 501, 3)
    c0 = _copy(carry)
    out = mpx_step.prune_enter(c0, rows, st, ent_w, ent_pay, la, valid, tab)
    assert all(a is b for a, b in zip(out, c0))
    assert _same(out, mpx_step.prune_enter_ref(_copy(carry), rows, st, ent_w,
                                               ent_pay, la, valid, tab))
    # The invalid row keeps its carry; the valid ones moved.
    assert all(torch.equal(a[1], b[1]) for a, b in zip(c0, carry))
    assert not torch.equal(c0[0][0], carry[0][0])
    assert all(t.dtype == torch.int32 for t in c0[1:])
    assert not mpx_step.launches


@pytest.mark.parametrize("S", [1, 2, 3, 5])
@pytest.mark.parametrize("prune,lookahead", [(True, True), (True, False),
                                             (False, True), (False, False)])
def test_plain_version_equals_the_previous_composition(S, prune, lookahead):
    carry, rows, tab, ent_w, ent_pay, la = planted(S, 703, 4, 53, 41, 9,
                                                   10 * S + prune)
    tab = tab._replace(prune=prune)
    la = la if lookahead else None
    valid = torch.tensor([True, True, False, True])
    want, (ex, exh, exh2, exh1) = previous_step(carry, rows, tab, ent_w,
                                                ent_pay, la, valid)
    st = mpx_step.step_exits(carry, rows, tab)
    # The search applies the word-exit beam to the exits it reads out.
    got_ex = (torch.where(st.ex > st.best[:, None] + tab.log_wbeam, st.ex,
                          NEG_INF) if prune else st.ex)
    assert _same((got_ex, *st.exh3.unbind(-1)), (ex, exh, exh2, exh1))
    got = mpx_step.prune_enter(_copy(carry), rows, st, ent_w, ent_pay, la,
                               valid, tab)
    assert _same(got, want)
    # The planted ties are there: in the exits and in the transitions,
    # and entries won and lost.
    s = carry[0] + torch.gather(rows, 1, carry[2].long())
    assert torch.equal(st.best, hmm_step(carry[0], (), torch.gather(
        rows, 1, carry[2].long()), tab.bands)[0].flatten(1).amax(1))
    if S >= 2:
        assert (s[..., -1] + tab.bands[3] == s[..., -2] + tab.bands[4]).any()
        assert (s[..., 1:] + tab.bands[0][:, 1:]
                == s[..., :-1] + tab.bands[1]).sum() > 50
    stepped = hmm_step(carry[0], (), torch.gather(rows, 1, carry[2].long()),
                       tab.bands)[0]
    moved = got[0][..., 0] != stepped[..., 0]
    assert moved[:, tab.is_entry].any() and moved[:, ~tab.is_entry].any()


def test_wrappers_raise_on_wrong_inputs():
    carry, rows, tab, ent_w, ent_pay, la = planted(3, 101, 2, 17, 11, 4, 0)
    valid = torch.ones(2, dtype=torch.bool)
    st = mpx_step.step_exits(carry, rows, tab)
    step = mpx_step.step_exits
    wide = (carry[0],) + tuple(p.long() for p in carry[1:])
    with pytest.raises(TypeError):
        step(wide, rows, tab)
    with pytest.raises(TypeError):
        step((carry[0].double(),) + carry[1:], rows, tab)
    with pytest.raises(ValueError):
        step(carry[:4], rows, tab)
    with pytest.raises(ValueError):
        step(carry, rows[..., :2], tab)
    with pytest.raises(ValueError):
        step(carry, rows, tab._replace(word_of=tab.word_of[:-1]))
    with pytest.raises(TypeError):
        step(carry, rows, tab._replace(pc=tab.pc.long()))
    with pytest.raises(ValueError, match="contiguous"):
        step((carry[0].transpose(0, 1).contiguous().transpose(0, 1),)
             + carry[1:], rows, tab)
    with pytest.raises(ValueError, match="no mpx-step kernel"):
        step(tuple(t.to("meta") for t in carry), rows.to("meta"),
             tab._replace(**{k: v.to("meta") for k, v in tab._asdict().items()
                             if isinstance(v, torch.Tensor)},
                          bands=tuple(b.to("meta") for b in tab.bands)))
    with pytest.raises(ValueError, match="different devices"):
        step(carry, rows.to("meta"), tab)
    enter = mpx_step.prune_enter
    with pytest.raises(TypeError):
        enter(carry, rows, st, ent_w, ent_pay, la, valid.int(), tab)
    with pytest.raises(TypeError):
        enter(carry, rows, st, ent_w, ent_pay.long(), la, valid, tab)
    with pytest.raises(ValueError):
        enter(carry, rows, st, ent_w[:1], ent_pay, la, valid, tab)
    with pytest.raises(ValueError):
        enter(carry, rows, st, ent_w, ent_pay[:, :-1], la, valid, tab)
    with pytest.raises(ValueError):
        enter(carry, rows, st._replace(ex=st.ex[:, :-1]), ent_w, ent_pay, la,
              valid, tab)
    with pytest.raises(ValueError, match="la_t's rows"):
        enter(carry, rows, st, ent_w, ent_pay, la.t().contiguous().t(),
              valid, tab)
    with pytest.raises(ValueError, match="different devices"):
        enter(carry, rows, st, ent_w, ent_pay, la.to("meta"), valid, tab)


@pytest.fixture(scope="module")
def small():
    return fixture.build(0, size=fixture.SMALL)


@pytest.fixture(scope="module")
def medium():
    return fixture.build(0, size=fixture.MEDIUM)


@pytest.mark.parametrize("size,kw,calls", [
    ("small", {}, 1), ("small", {"pl_window": 3}, 1),
    ("small", {"rcmode": "composite", "lcmode": "mpx"}, 1),
    ("medium", {"lexmode": "flat"}, 0), ("medium", {"lexmode": "tree"}, 0),
    ("medium", {"lexmode": "tree", "nlextree": 2}, 0)])
def test_only_the_mpx_step_calls_the_wrappers(size, kw, calls, request,
                                              monkeypatch):
    """A block of frames of each step: `MpxStep` calls each wrapper once
    a frame (fanout and composite exits), the static step, the one-copy
    tree and the tree copies never."""
    fx, K = request.getfixturevalue(size), 4
    s = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                    ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu"),
                    device="cpu", **kw)
    assert (s.graph.lc_mode == "mpx") == bool(calls)
    if calls:
        assert (s.graph.n_rcvar > 1) == ("rcmode" not in kw)
    seen = []
    for name in ("step_exits", "prune_enter"):
        real = getattr(mpx_step, name)
        monkeypatch.setattr(mpx_step, name, lambda *a, _r=real, _n=name:
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


def test_least_bytes_at_the_ptm_cell():
    """The fewest bytes of the PTM cell's channel update (en-us-ptm-64k's
    flat graph with exact left contexts: B=16, C=349,257, S=3,
    n_xs=117,980, W=64,002 words, 40 CI phones): 60 bytes a state (the
    carry read in each pass and written once) with the rows, the tables,
    the exits and the small arrays."""
    B, C, S, n_xs, W, n_ci = 16, 349257, 3, 117980, 64002, 40
    least = mpx_step.least_bytes(B, C, S, n_xs, W, n_ci)
    assert least == 60 * B * C * S + 2 * (4 * B * n_xs * S
                                          + 4 * C * (3 * S - 1)) \
        + 20 * B * C + 9 * B + 18 * C + 4 * B * W
    assert least == 1_195_662_066
    assert mpx_step.least_bytes(B, C, S, n_xs, W, n_ci, lookahead=True) \
        == least + 4 * C + 4 * B * n_ci
