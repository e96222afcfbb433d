"""`PtmParityScorer` (pocketsphinx's PTM scorer, ptm_mgau.c) against the
plain float64 reference of `tests/ptm_reference.py`, on the CPU, and
`Decoder`'s choice of it from a model directory's files.

Tolerances:

- On an integer-exact model (integer means and features: every float32
  term and partial sum of the densities is an exact integer below 2^24)
  both compute the same integer densities, so stage (b), the top N, the
  norm and the 8-bit epilogue, must give the same integer score sums, bit
  for bit, planted ties included.
- On real-valued inputs the float32 densities differ from float64 by
  rounding, which moves a truncated density by one unit now and then, and
  rarely a shifted score: at most 1 in 1,000 (n, s) may differ, each by at
  most 2 quanta (2^SHIFT ln b) a stream (`PsParityScorer`'s bound).
- The kernel's layout (`ptm_parity.pack`), emulated here in numpy with
  the kernel's own arithmetic, gives the plain path's scores bit for bit:
  stage (a) is the same float32 sequence on both.
"""

import hashlib
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch import nn

from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.api import Decoder
from cmusphinx_tpu_torch.models.gauden import GaussianParams
from cmusphinx_tpu_torch.ops import ptm_parity
from cmusphinx_tpu_torch.ops.gmm import PsParityScorer, PtmParityScorer
from ptm_reference import PtmReference

C, F, L, K, S, N = 5, 3, 13, 8, 60, 50
SLICES = [np.arange(f * L, (f + 1) * L) for f in range(F)]


def model(rng, integer=False, ties=0, C=C, K=K):
    """C codebooks of K codewords, 3 streams of 13.  `integer`: integer
    means in [-2, 2].  `ties`: that many codewords of each codebook and
    stream duplicate codeword 0."""
    if integer:
        means = rng.randint(-2, 3, (C, F, K, L)).astype(np.float32)
        var = rng.uniform(0.5, 2.0, (C, F, K, L)).astype(np.float32)
    else:
        means = (rng.randn(C, F, K, L) * 1.5).astype(np.float32)
        var = rng.uniform(0.05, 1.0, (C, F, K, L)).astype(np.float32)
    for k in rng.choice(np.arange(1, K), size=ties, replace=False):
        means[:, :, k], var[:, :, k] = means[:, :, 0], var[:, :, 0]
    return GaussianParams(means=means, var=var,
                          prec=(0.5 / var).astype(np.float32),
                          lrd=np.zeros((C, F, K), np.float32),
                          veclen=[L] * F, n_mgau=C, n_feat=F, n_density=K)


def frames(rng, g, n, integer=False, near=0):
    """Features [n, 39], each stream near a codeword of a random codebook;
    frames < `near` sit on codeword 0 of codebook 0 (planted ties)."""
    cb, k = rng.randint(0, g.n_mgau, n), rng.randint(0, g.n_density, n)
    cb[:near], k[:near] = 0, 0
    parts = []
    for f in range(F):
        m = g.means[cb, f, k]
        if integer:
            parts.append(m + rng.randint(-1, 2, (n, L))
                         * (np.arange(n) >= near)[:, None])
        else:
            parts.append(m + rng.randn(n, L) * 0.7)
    return np.concatenate(parts, 1).astype(np.float32)


def scorer_and_reference(g, raw, sen2cb, topn=4, **kw):
    sc = PtmParityScorer(g, raw, SLICES, sen2cb, topn=topn, device="cpu", **kw)
    ref = PtmReference([g.means[:, f] for f in range(F)],
                       [g.var[:, f] for f in range(F)], raw,
                       np.maximum(sen2cb, 0), [s.tolist() for s in SLICES],
                       topn=topn)
    return sc, ref


def quanta(scores, scale):
    """Scores -> the integer sums they were made from."""
    return np.rint(-np.asarray(scores, np.float64) / scale).astype(np.int64)


@pytest.mark.parametrize("topn", [1, 2, 4])
def test_stage_b_bit_exact_on_integer_inputs(topn):
    rng = np.random.RandomState(topn)
    g = model(rng, integer=True, ties=3)
    raw = rng.randint(0, 160, (F, K, S)).astype(np.uint8)
    sen2cb = rng.randint(0, C, S)
    sc, ref = scorer_and_reference(g, raw, sen2cb, topn)
    x = frames(rng, g, N, integer=True, near=8)
    d = sc.int_densities(torch.as_tensor(x))
    for f in range(F):
        want = torch.stack([ref.densities(torch.as_tensor(
            r, dtype=torch.float64), f) for r in x])
        assert torch.equal(d[f].long(), want)
        # Frames on codeword 0 see the planted ties.
        assert (d[f][:8, 0, 1:] == d[f][:8, 0, :1]).sum() >= 8 * 3
    got = sc.score(torch.as_tensor(x)).numpy()
    want = ref(x).numpy()
    assert np.array_equal(quanta(got, sc.scale), quanta(want, ref.scale))
    assert np.isfinite(got).all() and (got <= 0).all()


@pytest.mark.parametrize("seed", [11, 12])
def test_whole_scorer_within_bound(seed):
    rng = np.random.RandomState(seed)
    g = model(rng)
    raw = rng.randint(0, 160, (F, K, S)).astype(np.uint8)
    sc, ref = scorer_and_reference(g, raw, rng.randint(0, C, S))
    x = frames(rng, g, N)
    q = np.abs(quanta(sc.score(torch.as_tensor(x)).numpy(), sc.scale)
               - quanta(ref(x).numpy(), ref.scale))
    assert (q > 0).mean() <= 1e-3
    assert q.max() <= 2 * F


def _epilogue_case(topn):
    """A scorer of 2 codebooks, 1 stream of 1 dimension, K = 6, and one
    frame's int densities [1, 2, 6] given by hand."""
    g = GaussianParams(means=np.zeros((2, 1, 6, 1), np.float32),
                       var=np.ones((2, 1, 6, 1), np.float32),
                       prec=np.full((2, 1, 6, 1), 0.5, np.float32),
                       lrd=np.zeros((2, 1, 6), np.float32), veclen=[1],
                       n_mgau=2, n_feat=1, n_density=6)
    raw = np.arange(6 * 4, dtype=np.uint8).reshape(1, 6, 4) * 3
    return PtmParityScorer(g, raw, [np.arange(1)], np.array([0, 0, 1, 1]),
                           topn=topn, device="cpu")


def test_ties_go_to_the_lower_index():
    sc = _epilogue_case(topn=1)
    d = torch.tensor([[[-9000, -5000, -7000, -3000, -3000, -8000],
                       [-4000, -2000, -2000, -2000, -6000, -9000]]],
                     dtype=torch.int32)
    out = quanta(sc.epilogue([d]).numpy(), sc.scale)[0]
    # Codebook 0's best is codeword 3 (not 4), codebook 1's codeword 1.
    w = sc.mixw[0].numpy()
    norm = max(-3000 >> 10, -2000 >> 10)
    assert out.tolist() == [w[3, 0] + norm - (-3000 >> 10),
                            w[3, 1] + norm - (-3000 >> 10),
                            w[1, 2], w[1, 3]]
    vals, idx = PsParityScorer.topn_select(d.view(2, 6), 4)
    assert idx.tolist() == [[3, 4, 1, 2], [1, 2, 3, 0]]


def test_norm_is_taken_across_all_codebooks():
    """A codebook far below the best gets fsc = min(norm - score, 96):
    its senones sit below the best codebook's by up to MAX_NEG_ASCR."""
    sc = _epilogue_case(topn=1)
    w = sc.mixw[0].numpy()
    for gap, fsc in ((20, 20), (500, 96)):
        d = torch.full((1, 2, 6), -10 ** 6, dtype=torch.int32)
        d[0, 0, 2] = -1024
        d[0, 1, 5] = -1024 - (gap << 10)
        out = quanta(sc.epilogue([d]).numpy(), sc.scale)[0]
        assert out.tolist() == [w[2, 0], w[2, 1], w[5, 2] + fsc,
                                w[5, 3] + fsc]


def test_four_bit_sendump_raises():
    rng = np.random.RandomState(3)
    g = model(rng)
    raw = rng.randint(0, 16, (F, K, S)).astype(np.uint8)
    with pytest.raises(ValueError, match="8-bit"):
        PtmParityScorer(g, raw, SLICES, rng.randint(0, C, S), n_bits=4,
                        device="cpu")


def emulate_kernel(sc, packed, x):
    """The kernel's two passes in numpy, on its packed operands: float32
    densities in its order, the top N by its insertion, the packed
    scratch, the per-frame norm and selection words, the 4-senone groups
    read through `mixp`, the log-add clamped at `dmax`."""
    book, cols = packed.book.numpy(), packed.cols.numpy()
    Lw, n = packed.width, x.shape[0]
    Cb, Fs, Kd = sc.n_cb, sc.n_feat, sc.n_density
    top = np.zeros((n, Cb, Fs, 4), np.int64)
    for f in range(Fs):
        m, p = book[:, f, :, :Lw], book[:, f, :, Lw: 2 * Lw]
        d = np.broadcast_to(book[:, f, :, 2 * Lw], (n, Cb, Kd)).copy()
        for j in range(Lw):
            diff = x[:, cols[f, j], None, None] - m[None, :, :, j]
            d = d - diff * diff * p[None, :, :, j]
        di = np.clip(d, -2e9, 0).astype(np.int32).astype(np.int64)
        v = np.full((n, Cb, sc.topn), np.iinfo(np.int32).min, np.int64)
        ids = np.zeros_like(v)
        for k in range(Kd):               # the kernel's insertion
            dk = di[:, :, k]
            for r in range(sc.topn - 1, -1, -1):
                down = (dk > v[:, :, r - 1] if r > 0
                        else np.zeros_like(dk, bool))
                put = ~down & (dk > v[:, :, r])
                v[:, :, r] = np.where(down, v[:, :, r - 1],
                                      np.where(put, dk, v[:, :, r]))
                ids[:, :, r] = np.where(down, ids[:, :, r - 1],
                                        np.where(put, k, ids[:, :, r]))
        top[:, :, f, :sc.topn] = (v >> sc.SHIFT) * 256 + ids
    mixp = packed.mixp.numpy().reshape(-1).astype(np.int64)
    gcb, orig = packed.gcb.numpy(), packed.orig.numpy()
    table = packed.table.numpy().astype(np.int64)
    out = np.zeros((n, sc.n_sen), np.float32)
    g4 = np.arange(len(gcb))
    for t in range(n):
        norm = (top[t, :, :, 0] >> 8).max(0)                      # [F]
        fsc = np.minimum(norm[None, :, None] - (top[t] >> 8), sc.MAX_NEG_ASCR)
        rowoff = (np.arange(Fs)[None, :, None] * Kd + (top[t] & 255)) \
            * packed.n_slot
        sel = (fsc << 24) | rowoff                                 # [C, F, 4]
        acc = np.zeros((len(gcb), 4), np.int64)
        for f in range(Fs):
            fd = None
            for r in range(sc.topn):
                w = sel[gcb, f, r]
                y = mixp[(w & 0xFFFFFF)[:, None] + 4 * g4[:, None]
                         + np.arange(4)] + (w >> 24)[:, None]
                if fd is None:
                    fd = y
                else:
                    fd = np.minimum(fd, y) - table[
                        np.minimum(np.abs(fd - y), packed.dmax)]
            acc += fd
        s = orig.reshape(-1, 4)
        out[t, s[s >= 0]] = (-acc[s >= 0].astype(np.float32)
                             * np.float32(sc.scale))
    return out


@pytest.mark.parametrize("topn", [2, 4])
def test_kernel_layout_gives_the_plain_scores(topn):
    rng = np.random.RandomState(20 + topn)
    g = model(rng, ties=2)
    raw = rng.randint(0, 256, (F, K, S)).astype(np.uint8)
    sen2cb = rng.randint(0, C, S)
    sen2cb[:4] = -1                      # senones no phone uses
    sc = PtmParityScorer(g, raw, SLICES, sen2cb, topn=topn, device="cpu")
    packed = ptm_parity.pack(sc)
    assert packed.width == 13 and packed.n_slot % 4 == 0
    assert sorted(packed.orig[packed.orig >= 0].tolist()) == list(range(S))
    assert packed.table[packed.dmax:].eq(0).all() and packed.dmax <= 31
    x = frames(rng, g, 20, near=3)
    want = sc.score(torch.as_tensor(x)).numpy()
    assert np.array_equal(emulate_kernel(sc, packed, x), want)


def test_scoring_is_a_named_span():
    """`ptm.score` names the scorer's work in a profiler trace (inside the
    search's `ngram.score`), so that its gaps are named in `idle_gaps`."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(6)
    g = model(rng)
    raw = rng.randint(0, 160, (F, K, S)).astype(np.uint8)
    sc = PtmParityScorer(g, raw, SLICES, rng.randint(0, C, S), device="cpu")
    x = torch.as_tensor(frames(rng, g, 10))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sc.score(x)
    assert "ptm.score" in {e.name for e in prof.events()}


def test_kernel_takes_only_what_it_is_built_for():
    rng = np.random.RandomState(5)
    g = model(rng)
    raw = rng.randint(0, 160, (F, K, S)).astype(np.uint8)
    sc = PtmParityScorer(g, raw, SLICES, rng.randint(0, C, S), topn=5,
                         device="cpu")
    with pytest.raises(ValueError, match="top 5 > 4"):
        ptm_parity.pack(sc)
    with pytest.raises(ValueError, match="CUDA"):
        ptm_parity.score(torch.zeros(2, 39), sc, None)


def test_the_wrapper_passes_the_kernels_parameters_in_order():
    """`ptm_parity.PARAMS`, which orders the wrapper's ctypes call, names
    the C entry point's parameters in the source's order, with their
    kinds: pointers, ints, the float scale, the stream."""
    src = open(ptm_parity.cuda_libs.LIBRARIES["ptm_parity"][0]).read()
    sig = src[src.index('extern "C" int ptm_parity_launch('):]
    sig = sig[sig.index("(") + 1: sig.index(")")]
    params = [p.split()[-1].lstrip("*") for p in sig.split(",")]
    kinds = [p.split()[-2] for p in sig.split(",")]
    assert tuple(params) == ptm_parity.PARAMS
    np_, ni = ptm_parity.N_POINTERS, ptm_parity.N_INTS
    assert all(k.endswith("*") for k in kinds[:np_])
    assert kinds[np_: np_ + ni] == ["int"] * ni
    assert kinds[np_ + ni:] == ["float", "void*"]


# A seeded semi-continuous model whose `PsParityScorer` scores were hashed
# on the tree before `PtmParityScorer` shared its helpers.
PSPARITY_SHA256 = ("71dcce28681ee77ffd79da4e4f0772ae"
                   "c242f12b834093987dd84f3ff85029c2")


def test_psparity_scores_are_the_pinned_ones():
    rng = np.random.RandomState(31)
    K1 = 32
    means = (rng.randn(1, F, K1, L) * 1.5).astype(np.float32)
    var = rng.uniform(0.05, 1.0, (1, F, K1, L)).astype(np.float32)
    g = GaussianParams(means=means, var=var,
                       prec=(0.5 / var).astype(np.float32),
                       lrd=(-0.5 * (np.log(var).sum(-1)
                            + L * np.log(2 * np.pi))).astype(np.float32),
                       veclen=[L] * F, n_mgau=1, n_feat=F, n_density=K1)
    raw = rng.randint(0, 160, (F, K1, 200)).astype(np.uint8)
    k = rng.randint(0, K1, 80)
    x = np.concatenate([means[0, f, k] + rng.randn(80, L) * 0.7
                        for f in range(F)], 1).astype(np.float32)
    sc = PsParityScorer(g, raw, SLICES, device="cpu")
    out = sc.score(torch.as_tensor(x))
    assert hashlib.sha256(out.numpy().tobytes()).hexdigest() == PSPARITY_SHA256


class ReferenceScorer(nn.Module):
    """The plain reference in the program's scorer's place."""

    def __init__(self, ref, n_sen):
        super().__init__()
        self.ref, self.n_sen = ref, n_sen

    def score(self, feats):
        x = feats.reshape(-1, feats.shape[-1]).numpy()
        out = self.ref(x).float()
        return out.reshape(*feats.shape[:-1], self.n_sen)

    forward = score


@pytest.fixture(scope="module")
def ptm8_dir():
    fx = fixture.build(0, model="ptm8", size=fixture.SMALL)
    tmp = tempfile.mkdtemp()
    return fx, fixture.write_model_dir(fx, tmp)


def test_decoder_picks_the_ptm_parity_scorer(ptm8_dir):
    """A 3-stream 8-bit PTM directory: `Decoder` scores it with
    `PtmParityScorer` from the files alone, and its batch decode gives the
    words of the same search fed the reference's scores."""
    fx, kw = ptm8_dir
    d = Decoder(device="cpu", **kw)
    sc = d.scorer
    assert isinstance(sc, PtmParityScorer)
    assert (sc.n_cb, sc.n_feat, sc.n_density) == (fx.mdef.n_ciphone, 3, 8)
    assert sc.sen2cb.tolist() == np.maximum(fx.mdef.sen2cimap, 0).tolist()
    got = [h.words for h in d.search.decode_batch_cep(fx.ceps, d.fp)]
    g = fx.gauden
    ref = PtmReference([g.means[:, f, :, :L] for f in range(F)],
                       [g.var[:, f, :, :L] for f in range(F)],
                       fixture.sendump_bytes(fx)[0],
                       np.maximum(fx.mdef.sen2cimap, 0),
                       [s.tolist() for s in d.fp.stream_slices()])
    d.search.scorer = ReferenceScorer(ref, sc.n_sen)
    want = [h.words for h in d.search.decode_batch_cep(fx.ceps, d.fp)]
    assert got == want == fx.transcripts


def test_parity_no_on_a_ptm_sendump_raises(ptm8_dir):
    _, kw = ptm8_dir
    with pytest.raises(ValueError, match="PTM"):
        Decoder(device="cpu", parity=False, **kw)


def test_least_bytes_at_the_cell_shape():
    """The kernel's bound at portbench's en-us-ptm-64k shape (40 codebooks,
    3 streams of 13, 128 codewords, 5,126 senones, a batch's 9,600
    frames): features and scores, weights and codebooks once each, the
    bytes `portbench/kinds/ptm.py` counts."""
    sc = SimpleNamespace(veclen=[13] * 3, n_feat=3, n_cb=40, n_density=128,
                         n_sen=5126)
    n = ptm_parity.least_bytes(9600, sc)
    assert n == (4 * 9600 * 39 + 4 * 9600 * 5126 + 3 * 128 * 5126
                 + 4 * 40 * 128 * (2 * 39 + 3)) == 201_963_264


# Known defect, kept in sight (PERF.md §7): on these SMALL `ptm8` seeds
# the one-copy prefix tree serves a word that the transcript does not hold
# (one utterance each: the listed one), where the flat lexicon, with
# composite or exact (`mpx`) left contexts, and the tree with a second copy
# (`nlextree` 2, the second-best history-distinct entry) decode every
# utterance to its transcript.  The one-copy tree enters every root from
# one best word exit a frame; the other searches keep the entry that the
# right word needs.  When the tree keeps it too, the first assertion fails:
# make it an equality then.
TREE_MISSES = [(21, 0), (39, 2)]


@pytest.mark.parametrize("seed,utt", TREE_MISSES)
def test_the_one_copy_tree_misses_a_word_on_ptm_acoustics(seed, utt):
    fx = fixture.build(seed, model="ptm8", size=fixture.SMALL)
    kw = fixture.write_model_dir(fx, tempfile.mkdtemp())

    def words(**mode):
        d = Decoder(device="cpu", **kw, **mode)
        return [h.words for h in d.search.decode_batch_cep(fx.ceps, d.fp)]

    tree = words(lexmode="tree", lcmode="composite", rcmode="composite")
    assert [i for i, (h, r) in enumerate(zip(tree, fx.transcripts))
            if h != r] == [utt]
    for mode in (dict(lexmode="flat", lcmode="composite"),
                 dict(lexmode="flat", lcmode="mpx"),
                 dict(lexmode="tree", lcmode="composite", nlextree=2)):
        assert words(rcmode="composite", **mode) == fx.transcripts, mode
