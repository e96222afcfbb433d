"""The N-gram search's block runner on the CPU: what makes a block of
frames capturable as a CUDA graph on the card, and its tapes against the
JAX package's.

- Every aten op of a block (`NgramSearch._block`) of each frame step (mpx,
  mpx with the phone-loop lookahead, static, tree, tree copies, tree
  copies with the lookahead), recorded by a `TorchDispatchMode`: none
  reads a device value on the host (`_local_scalar_dense`, `item`,
  `is_nonzero`, `nonzero`, `masked_select`, the `unique` ops, indexing by a
  boolean mask) or makes a tensor from host data (`lift_fresh`).  Two
  consecutive blocks run the same ops with the same shapes, types and
  scalar arguments: what a graph captured on one block needs to replay
  the next.
- The block runner with blocks of 37 frames (several a batch, the last
  one shorter; 37 + 13 a stream chunk) against the JAX package on the
  same fixtures: batch tapes and hypotheses, and streams' tapes and
  final hypotheses; integer tapes equal, float tapes within rtol 1e-5
  (the scorers' f32 sums in another order, as in the search tests).
- On the CPU nothing is captured.

The card's half (graphed against eager, bit-equal) is in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cmusphinx_tpu.decode.ngram_search import NgramSearch as JaxSearch
from cmusphinx_tpu.frontend.feat import FeatPipeline as JaxFeat
from cmusphinx_tpu.ops.gmm import ContinuousScorer as JaxScorer
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.decode import NgramSearch
from cmusphinx_tpu_torch.frontend import FeatPipeline
from cmusphinx_tpu_torch.ops import ContinuousScorer
from test_torch_ngram_search import assert_hyps_match, assert_tapes_match
from test_torch_stream import PUSH, _same, assert_flat_tapes_match

CASES = {
    "mpx": ("small", {}),
    "mpx_lookahead": ("small", {"pl_window": 5, "pl_weight": 2.0}),
    "static": ("medium", {"lexmode": "flat"}),
    "tree": ("medium", {"lexmode": "tree"}),
    "tree_copies": ("medium", {"lexmode": "tree", "nlextree": 2}),
    "tree_copies_lookahead": ("medium", {"lexmode": "tree", "nlextree": 3,
                                         "pl_window": 3}),
}
STEP = {"mpx": "_step_mpx", "mpx_lookahead": "_step_mpx",
        "static": "_step_static", "tree": "_step_tree",
        "tree_copies": "_step_tree_copies",
        "tree_copies_lookahead": "_step_tree_copies"}
# Frames a block in the dispatch test, and in the runner's tests (not a
# divisor of the 100-frame batch bucket nor of the 50-frame stream chunk).
K_DISPATCH, K_RUNNER = 6, 37
HOST_READS = {"aten::_local_scalar_dense", "aten::item", "aten::is_nonzero",
              "aten::nonzero", "aten::nonzero_static", "aten::masked_select",
              "aten::lift_fresh", "aten::lift_fresh_copy"}
INDEXING = {"aten::index", "aten::index_put", "aten::index_put_",
            "aten::_index_put_impl_"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The decode is many small ops a frame: intra-op threads only contend
    with the other test workers.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    return fixture.build(0, size=fixture.SMALL)


@pytest.fixture(scope="module")
def medium():
    return fixture.build(0, size=fixture.MEDIUM)


def _search(fx, kw):
    return NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                       ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu"),
                       device="cpu", **kw)


def _sig(x):
    """An op argument as the capture sees it: a tensor by its shape and
    type, anything else by value."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(y) for y in x)
    return x


class _Record(TorchDispatchMode):
    """Every aten op with its arguments' signatures."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops.append((func._schema.name, _sig(args),
                         _sig(tuple(sorted(kwargs.items())))))
        return func(*args, **kwargs)


def _host_reads(ops):
    """The ops that read a device value on the host."""
    bad = []
    for name, args, _ in ops:
        if name in HOST_READS or "unique" in name or (
                name in INDEXING and any(
                    isinstance(a, tuple) and a[2:] == (torch.bool,)
                    for a in args[1] if isinstance(a, tuple))):
            bad.append(name)
    return bad


def _batch_inputs(s, fx, n_utt=2):
    """The first n_utt utterances of fx as `_viterbi` sets them up: senone
    scores, valid mask, lookahead, initial carry and an empty tape."""
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    x, T, _ = s._pad([fp.compute(c) for c in fx.ceps[:n_utt]])
    B, F = x.shape[0], x.shape[1]
    valid = torch.arange(F)[None] < T[:, None]
    scores = s.scorer.score(x)
    la = s._lookahead(scores, F) if s.pl_window else None
    carry = s._init_static(B, F) if s._fast else s._init_hmmc(B)
    return scores, valid, la, carry, s._tape(B, F)


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_reads_nothing_on_the_host(case, request):
    size, kw = CASES[case]
    fx = request.getfixturevalue(size)
    s = _search(fx, kw)
    calls = []
    orig = getattr(s, STEP[case])

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    setattr(s, STEP[case], counted)
    K = K_DISPATCH
    with torch.inference_mode():
        scores, valid, la, carry, tape = _batch_inputs(s, fx)
        records = []
        for k0 in (0, K):
            sl = slice(k0, k0 + K)
            blk = (scores[:, sl], torch.full((), k0, dtype=torch.int64),
                   valid[:, sl], tuple(a[:, sl] for a in tape),
                   None if la is None else la[:, sl])
            with _Record() as rec:
                carry = s._block(carry, *blk)
            records.append(rec.ops)
    assert len(calls) == 2 * K                       # the case's own step
    first, second = records
    assert len(first) > 50 * K
    assert _host_reads(first) == [] and _host_reads(second) == []
    assert [op[0] for op in first] == [op[0] for op in second]
    assert first == second
    # Every frame writes its six rows of the block's tape, and the static
    # and tree steps their side-table rows at the device index.
    assert sum(op[0] == "aten::copy_" for op in first) >= 6 * K
    if s._fast:
        assert sum(op[0] == "aten::index_copy_" for op in first) >= K


@pytest.fixture(scope="module")
def reference(small, medium):
    """The JAX package's batch decode of each case (one decode per search:
    the reference's batch program is traced once)."""
    out = {}

    def get(case):
        if case not in out:
            size, kw = CASES[case]
            fx = small if size == "small" else medium
            js = JaxSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                           JaxScorer(fx.gauden, fx.ln_mixw, use_pallas=False),
                           **kw)
            hyps = js.decode_batch_cep(fx.ceps, JaxFeat(fx.feat_config()))
            out[case] = (js.E, hyps, [np.asarray(a)
                                      for a in js._last_batch[0]])
        return out[case]
    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_runner_batch_matches_reference(case, request, reference):
    size, kw = CASES[case]
    fx = request.getfixturevalue(size)
    s = _search(fx, kw)
    lens = []
    s._block_len = lambda B, n: lens.append(n) or K_RUNNER
    hyps = s.decode_batch_cep(fx.ceps, FeatPipeline(fx.feat_config(),
                                                    device="cpu"))
    E, jhyps, jtapes = reference(case)
    tapes = [a.numpy() for a in s._last_batch[0]]
    # Several blocks, the last one shorter.
    assert lens == [jtapes[0].shape[1] // E] and lens[0] % K_RUNNER
    assert lens[0] > 2 * K_RUNNER
    assert_tapes_match(tapes, jtapes, E)
    assert_hyps_match(hyps, jhyps)
    assert not s._graph_cache and s._graph_stats["captures"] == 0


@pytest.mark.parametrize("case", ["mpx_lookahead", "static", "tree_copies"])
def test_block_runner_stream_matches_reference(case, request):
    """One utterance streamed in 37-frame pushes from a 100-frame tape that
    grows: every chunk runs as a block of 37 frames and one of 13."""
    size, kw = CASES[case]
    fx = request.getfixturevalue(size)
    js = JaxSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                   JaxScorer(fx.gauden, fx.ln_mixw, use_pallas=False), **kw)
    s = _search(fx, kw)
    s._block_len = lambda B, n: K_RUNNER
    feats = FeatPipeline(fx.feat_config(), device="cpu").compute(fx.ceps[1])
    T, E = feats.shape[0], s.E
    jst, st = js.stream_start(max_frames=100), s.stream_start(max_frames=100)
    for i in range(0, T, PUSH):
        js.stream_push(jst, feats[i: i + PUSH])
        s.stream_push(st, feats[i: i + PUSH])
    _same(s.stream_end(st), js.stream_end(jst))
    assert st["t"] == T and st["max_frames"] == jst["max_frames"] > 100
    F = st["max_frames"]
    assert_flat_tapes_match(
        [a[0].reshape((F * E,) + tuple(a.shape[3:])).numpy()
         for a in st["tape"]],
        [np.asarray(a) for a in jst["carry"][-1]], E)
    assert not s._graph_cache


def test_default_blocks_cover_a_batch_and_a_chunk(small, medium,
                                                  monkeypatch):
    """`_block_len`: the mpx step runs the batch's 100-frame bucket and a
    stream's 50-frame chunk as one block; the static and tree steps hold
    at most EXPAND_BLOCK_BYTES of expanded scores a block, in a length
    that divides the bucket and the chunk, so that no batch or chunk has
    a shorter last block.  `_side_frames`: the side-tables hold the
    bucket times a power of two."""
    from cmusphinx_tpu_torch.decode import ngram_search
    s = _search(small, {})
    assert s._block_len(16, 600) == s.FRAME_BUCKET
    assert s._block_len(1, 1700) == s.FRAME_BUCKET
    assert s._block_len(1, s.CHUNK) == s.CHUNK
    t = _search(medium, {"lexmode": "tree"})
    g = t.graph
    per_frame = (g.n_chan * g.n_emit_state + g.comp_mem.size) * 4
    for B in (1, 4, 16):
        cap = ngram_search.EXPAND_BLOCK_BYTES // (per_frame * B)
        for n in (100, 600, 1700, t.CHUNK):
            K = t._block_len(B, n)
            assert n % K == 0 and K <= max(1, cap)
            assert K == max(d for d in range(1, min(cap, 100) + 1)
                            if (n % d, 100 % d) == (0, 0))
    monkeypatch.setattr(ngram_search, "EXPAND_BLOCK_BYTES", 8 * per_frame)
    assert [t._block_len(1, n) for n in (100, 600, t.CHUNK)] == [5, 5, 5]
    monkeypatch.setattr(ngram_search, "EXPAND_BLOCK_BYTES", per_frame // 2)
    assert t._block_len(1, 600) == 1
    assert [t._side_frames(n) for n in (1, 100, 200, 300, 600, 900, 1700)] \
        == [100, 100, 200, 400, 800, 1600, 3200]
