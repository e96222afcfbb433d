"""The port on the GPU: kernel K1 against its plain version, a
one-utterance decode through it, the other scorers, the frontend, the
Decoder, the LM backends, the large-vocabulary searches, the streaming
decode and the lattice results on the card against their CPU runs, the
one-copy tree step's and the mpx step's two kernels against their plain
versions (the mpx step's whole decodes and streams against the CPU's on
the same senone scores), the PTM parity kernel against the CPU bit for
bit and through `Decoder`, K1 on senone shards against the unsharded call, `tools fe` on the card
against `-platform cpu`, every search's frame loop through captured
CUDA graphs against its eager blocks (bit-equal), and the frame loop's
span holding its graphs' kernels in a profiler trace.  Skips where there
is no CUDA device.

Tolerances against the CPU run: `PsParityScorer`'s epilogue bit-exact on
the same int32 densities, and the whole scorer bit-exact on an
integer-exact model with planted ties; its densities and the float
scorers within D * 2^-22 * M (plus 1e-5 relative for exp/log); the
frontend within 1e-4 per log-mel value carried through |dct| and the
lifter (as tests/test_torch_fe.py states it); every LM backend
bit-exact; the large-vocabulary decodes with integer tapes equal and float
tapes within rtol 1e-5 (K1's 3xTF32 products against the CPU's plain IEEE
f32 scorer); K1 against its plain version and float64 as stated at
`SAME_BOUND`; the trainer's forward-backward with each utterance's
log-likelihood within rtol 1e-5 and its accumulators within
`bw.posterior_rtol` of the CPU's and of a float64 pass (the card's atomics
sum in another order), Viterbi states equal but for near-ties (both paths
scoring within 1e-6 relative in float64).

On a machine with the card (which has no JAX):
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import copy
import faulthandler
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.models.gauden import GaussianParams
from cmusphinx_tpu_torch.decode import NgramSearch, ngram_search
from cmusphinx_tpu_torch.decode.ngram_steps import LexTreeStep, StaticStep
from cmusphinx_tpu_torch.frontend import FeatPipeline
from cmusphinx_tpu_torch.ops import (ContinuousScorer, InterpolatedScorer,
                                     PsParityScorer, PtmParityScorer,
                                     PTMScorer, SemiContinuousScorer)
from cmusphinx_tpu_torch.ops.fused_gmm import (fused_mixture_scores,
                                               fused_mixture_scores_ref)
from cmusphinx_tpu_torch.ops.hmm import hmm_step
from cmusphinx_tpu_torch.train import bw
from cmusphinx_tpu_torch.train.sentence_hmm import FlatModel
from cmusphinx_tpu_torch.train.trainer import Trainer
from test_torch_lm_entries import CASES as LM_CASES
from test_torch_lm_entries import case_inputs as lm_case_inputs
from test_torch_mpx_step import planted as planted_mpx
from test_torch_tree_step import planted

pytestmark = pytest.mark.cuda

# A kernel waiting on a wrong mbarrier phase (K1's ring, its depth loop)
# hangs rather than fails: past this limit a test ends the process with a
# traceback (the first K1 test also builds the kernel, ~1 min).
TEST_TIMEOUT_S = 300


@pytest.fixture(autouse=True)
def _hang_timeout():
    faulthandler.dump_traceback_later(TEST_TIMEOUT_S, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _magnitude(x, lin, quad, const):
    x = x.double()
    lin, quad = lin.double().flatten(0, 1), quad.double().flatten(0, 1)
    S, K = const.shape
    m = (const.double().abs().reshape(1, -1) + x.abs() @ lin.abs().T
         + (x * x) @ quad.T)
    return m.view(-1, S, K).amax(-1)


# K1 against its plain version: the same arithmetic up to the order of the
# f32 sums (D * 2^-22 * M) in "high" and "bf16"; in "highest" the kernel's
# 3xTF32 products against the plain IEEE f32 ones, within the sum of the
# two sides' float64 bounds (2 * D * 2^-22 * M).
SAME_BOUND = {"highest": 2.0, "high": 1.0, "bf16": 1.0}
MODE_BOUND = {"highest": None, "high": 2.0 ** -14, "bf16": 2.0 ** -6}


def _k1_model(rng, S, K, D, floored=False):
    if floored:
        means = (rng.randn(S, 1, K, D) * np.r_[np.full(13, 3.0),
                                               np.full(D - 13, 0.3)])
        var = np.exp(rng.randn(S, 1, K, D) * 2.0 - 1.5)
        var[rng.rand(S, 1, K, D) < 0.05] = 1e-6
        var = np.maximum(var, 1e-4)
    else:
        means = rng.randn(S, 1, K, D)
        var = 0.2 + rng.rand(S, 1, K, D)
    means, var = means.astype(np.float32), var.astype(np.float32)
    g = GaussianParams(means=means, var=var, prec=(0.5 / var).astype(np.float32),
                       lrd=(-0.5 * (np.log(var).sum(-1) + D * np.log(2 * np.pi))
                            ).astype(np.float32),
                       veclen=[D], n_mgau=S, n_feat=1, n_density=K)
    lnw = np.log(rng.dirichlet(np.ones(K), size=S)).astype(np.float32)
    return g, lnw, means, var


@pytest.mark.parametrize("S,K,D,T", [(301, 32, 39, 517), (37, 4, 13, 129),
                                     (19, 1, 51, 64), (5, 256, 39, 300),
                                     (1000, 8, 39, 1), (23, 8, 64, 130),
                                     (301, 32, 78, 517), (57, 4, 65, 200),
                                     (41, 32, 150, 300), (5, 256, 78, 70),
                                     (29, 8, 200, 130), (13, 8, 400, 64)])
@pytest.mark.parametrize("mode", ["highest", "high", "bf16"])
def test_k1_matches_plain_version(cuda, mode, S, K, D, T):
    rng = np.random.RandomState(S + K + D + T)
    g, lnw, _, _ = _k1_model(rng, S, K, D)
    sc = ContinuousScorer(g, lnw, precision=mode, device=cuda)
    x = torch.as_tensor(rng.randn(T, D).astype(np.float32), device=cuda)
    before = fused_mixture_scores.launches
    got = fused_mixture_scores(x, sc.lin, sc.quad, sc.const, mode,
                               packed=sc.packed())
    torch.cuda.synchronize()
    assert fused_mixture_scores.launches == before + 1
    assert got.shape == (T, S) and bool(torch.isfinite(got).all())
    want = fused_mixture_scores_ref(x, sc.lin, sc.quad, sc.const, mode)
    M = _magnitude(x, sc.lin.float(), sc.quad.float(), sc.const)
    err = (got.double() - want.double()).abs()
    bound = SAME_BOUND[mode] * D * 2.0 ** -22 * M
    assert bool((err <= bound).all()), float((err / bound).max())
    # The kernel runs on packed parameters only: no packing in the wrapper.
    with pytest.raises(ValueError, match="packed"):
        fused_mixture_scores(x, sc.lin, sc.quad, sc.const, mode)
    assert fused_mixture_scores.launches == before + 1
    assert fused_mixture_scores(x[:0], sc.lin, sc.quad, sc.const, mode,
                                packed=sc.packed()).shape == (0, S)


def test_k1_follows_a_scorer_moved_to_the_card(cuda):
    rng = np.random.RandomState(5)
    g, lnw, _, _ = _k1_model(rng, 40, 8, 13)
    sc = ContinuousScorer(g, lnw, device="cpu")
    x = torch.as_tensor(rng.randn(50, 13).astype(np.float32))
    want = sc.score(x)
    sc.to(cuda)
    p = sc.packed()
    assert sc.packed() is p and p.tiles.device.type == "cuda"
    M = _magnitude(x, sc.lin.cpu(), sc.quad.cpu(), sc.const.cpu())
    bound = SAME_BOUND["highest"] * 13 * 2.0 ** -22 * M
    assert bool(((sc.score(x.to(cuda)).cpu() - want).abs() <= bound).all())
    with torch.no_grad():
        sc.const.add_(1.0)
    got = sc.score(x.to(cuda)).cpu()
    assert sc.packed() is not p
    want = fused_mixture_scores_ref(x, sc.lin.cpu(), sc.quad.cpu(),
                                    sc.const.cpu())
    M = _magnitude(x, sc.lin.cpu(), sc.quad.cpu(), sc.const.cpu())
    bound = SAME_BOUND["highest"] * 13 * 2.0 ** -22 * M
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("D", [39, 78, 150])
@pytest.mark.parametrize("mode", ["highest", "high", "bf16"])
def test_k1_floored_within_mode_bound(cuda, mode, D):
    rng = np.random.RandomState(7)
    S, K, T = 700, 32, 300
    g, lnw, means, var = _k1_model(rng, S, K, D, floored=True)
    sc = ContinuousScorer(g, lnw, precision=mode, device=cuda)
    f32 = ContinuousScorer(g, lnw, device=cuda)
    pick = rng.randint(S, size=T), rng.randint(K, size=T)
    x = torch.as_tensor((means[pick[0], 0, pick[1]] + rng.randn(T, D)
                         * np.sqrt(var[pick[0], 0, pick[1]])).astype(np.float32),
                        device=cuda)
    got = sc.score(x).double()
    lin, quad, const = (t.double() for t in (f32.lin, f32.quad, f32.const))
    M = _magnitude(x, lin, quad, const)
    xd = x.double()
    ll = (const.reshape(1, -1) + xd @ lin.flatten(0, 1).T
          - (xd * xd) @ quad.flatten(0, 1).T).view(T, S, K)
    err = (got - torch.logsumexp(ll, -1)).abs()
    bound = (MODE_BOUND[mode] or D * 2.0 ** -22) * M
    assert bool((err <= bound).all()), float((err / bound).max())


def test_one_utterance_decode_through_k1(cuda):
    fx = fixture.build(0, size=fixture.SMALL)
    sc = ContinuousScorer(fx.gauden, fx.ln_mixw, device=cuda)
    s = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, sc, device=cuda)
    fp = FeatPipeline(fx.feat_config(), device=cuda)
    before = fused_mixture_scores.launches
    hyp = s.decode_batch_cep(fx.ceps[:1], fp)[0]
    assert fused_mixture_scores.launches > before
    assert hyp.words == fx.transcripts[0]
    sc.kernel = False
    plain = s.decode_batch_cep(fx.ceps[:1], fp)[0]
    assert plain.words == hyp.words


def test_k1_depth_loop_geometry(cuda):
    """The depth loop's plan: resident A with fewer frames a block as D
    grows, A staged chunk by chunk past what the shared memory holds (the
    D = 200 and 400 cases of test_k1_matches_plain_version run it)."""
    from cmusphinx_tpu_torch.ops.fused_gmm import depth, plan
    want = {("highest", 78): (128, False), ("high", 78): (192, False),
            ("bf16", 78): (192, False), ("highest", 150): (64, False),
            ("high", 150): (128, False), ("bf16", 150): (192, False),
            ("highest", 200): (128, True), ("high", 400): (192, True)}
    for (mode, D), got in want.items():
        assert plan(mode, depth(D)) == got, (mode, D)


def test_decoder_wide_features_on_card(cuda, tmp_path):
    """A continuous model over 26 cepstra (1s_c_d_dd, D = 78) loads and
    decodes through the Decoder on the card, K1's depth loop scoring it;
    the words equal the CPU Decoder's and the transcripts."""
    from cmusphinx_tpu_torch.api import Decoder
    fx = fixture.build(0, size=fixture.SMALL, ncep=26)
    assert fx.gauden.veclen == [78]
    kw = fixture.write_model_dir(fx, str(tmp_path))
    gpu, cpu = Decoder(device=cuda, **kw), Decoder(device="cpu", **kw)
    assert gpu.scorer.packed().dp == 160
    before = fused_mixture_scores.launches
    for i, c in enumerate(fx.ceps):
        words = []
        for d in (gpu, cpu):
            d.start_utt()
            d.process_cep(c)               # 26 cepstra: no mfc file
            words.append(d.end_utt().words)
        assert words[0] == words[1] == fx.transcripts[i]
    assert fused_mixture_scores.launches - before == len(fx.ceps)


# ---- the semi-continuous scorers, PTM, interpolation, frontend, Decoder --

def _semi_model(rng, lens, K, integer):
    F, L = len(lens), max(lens)
    means = np.zeros((1, F, K, L), np.float32)
    var = np.ones((1, F, K, L), np.float32)
    for f, ln in enumerate(lens):
        means[0, f, :, :ln] = (rng.randint(-2, 3, (K, ln)) if integer
                               else rng.randn(K, ln) * 1.5)
        var[0, f, :, :ln] = rng.uniform(0.5, 2.0, (K, ln))
        for k in (3, 7, 11):                   # planted exact ties
            means[0, f, k], var[0, f, k] = means[0, f, 0], var[0, f, 0]
    prec = (0.5 / var).astype(np.float32)
    lrd = np.zeros((1, F, K), np.float32)
    for f, ln in enumerate(lens):
        prec[0, f, :, ln:] = 0.0
        lrd[0, f] = -0.5 * (np.log(var[0, f, :, :ln]).sum(-1)
                            + ln * np.log(2 * np.pi))
    g = GaussianParams(means=means, var=var, prec=prec, lrd=lrd,
                       veclen=list(lens), n_mgau=1, n_feat=F, n_density=K)
    sl, pos = [], 0
    for ln in lens:
        sl.append(np.arange(pos, pos + ln))
        pos += ln
    T = 300
    parts = []
    for f, ln in enumerate(lens):
        k = rng.randint(K, size=T)
        k[:20] = 0
        m = means[0, f, k, :ln]
        parts.append(m + (rng.randint(-1, 2, (T, ln)) if integer
                          else rng.randn(T, ln) * 0.7))
    return g, sl, np.concatenate(parts, 1).astype(np.float32)


@pytest.mark.parametrize("lens,wrap", [([13, 13, 13], False),
                                       ([12, 24, 3, 12], True)])
def test_psparity_on_card_matches_cpu(cuda, lens, wrap):
    rng = np.random.RandomState(1)
    for integer in (True, False):
        g, sl, x = _semi_model(rng, lens, 64, integer)
        raw = rng.randint(0, 256, (len(lens), 64, 500)).astype(np.uint8)
        cpu = PsParityScorer(g, raw, sl, topn=4, wrap_uint8=wrap, device="cpu")
        gpu = PsParityScorer(g, raw, sl, topn=4, wrap_uint8=wrap, device=cuda)
        xc = torch.as_tensor(x)
        d_gpu = gpu.int_densities(xc.to(cuda))
        d_cpu = cpu.int_densities(xc)
        # Stage (b): bit-exact on the same int32 densities, ties included.
        got = gpu.epilogue(d_gpu).cpu()
        assert torch.equal(got, cpu.epilogue([d.cpu() for d in d_gpu]))
        if integer:
            for a, b in zip(d_gpu, d_cpu):
                assert torch.equal(a.cpu(), b)
            assert torch.equal(got, cpu.score(xc))
        else:
            for a, b in zip(d_gpu, d_cpu):
                assert int((a.cpu().long() - b.long()).abs().max()) <= 2


# The PTM parity kernel against the plain path on the host CPU: stage (a)
# is the same float32 sequence on both (no fused multiply-add) and stage
# (b) integer arithmetic, so the scores are equal bit for bit, on an
# integer-exact model and on real-valued inputs alike.
@pytest.mark.parametrize("topn", [1, 4])
@pytest.mark.parametrize("integer", [True, False], ids=["integer", "real"])
def test_ptm_parity_kernel_matches_cpu(cuda, integer, topn):
    from cmusphinx_tpu_torch.ops import ptm_parity
    from test_torch_ptm_parity import SLICES, frames, model
    rng = np.random.RandomState(7 + topn)
    g = model(rng, integer=integer, ties=3, C=9, K=16)
    raw = rng.randint(0, 256, (3, 16, 700)).astype(np.uint8)
    sen2cb = rng.randint(-1, 9, 700)
    cpu = PtmParityScorer(g, raw, SLICES, sen2cb, topn=topn, device="cpu")
    gpu = PtmParityScorer(g, raw, SLICES, sen2cb, topn=topn, device=cuda)
    x = torch.as_tensor(frames(rng, g, 300, integer=integer, near=8))
    before = ptm_parity.launches["score"]
    got = gpu.score(x.to(cuda).view(3, 100, -1))
    torch.cuda.synchronize()
    assert ptm_parity.launches["score"] - before == 1
    assert torch.equal(got.cpu().view(300, -1), cpu.score(x))
    assert torch.equal(got.view(300, -1), gpu.score_ref(x.to(cuda)))


def test_decoder_on_card_runs_the_ptm_kernel(cuda, tmp_path):
    """A 3-stream 8-bit PTM directory on the card: `PtmParityScorer`, one
    kernel launch a batch, the CPU Decoder's words."""
    from cmusphinx_tpu_torch.api import Decoder
    from cmusphinx_tpu_torch.ops import ptm_parity
    fx = fixture.build(0, model="ptm8", size=fixture.SMALL)
    kw = fixture.write_model_dir(fx, str(tmp_path))
    gpu, cpu = Decoder(device=cuda, **kw), Decoder(device="cpu", **kw)
    assert isinstance(gpu.scorer, PtmParityScorer)
    before = ptm_parity.launches["score"]
    got = [h.words for h in gpu.search.decode_batch_cep(fx.ceps, gpu.fp)]
    assert ptm_parity.launches["score"] - before == 1
    want = [h.words for h in cpu.search.decode_batch_cep(fx.ceps, cpu.fp)]
    assert got == want == fx.transcripts


def test_float_scorers_on_card_match_cpu(cuda):
    rng = np.random.RandomState(2)
    g, sl, x = _semi_model(rng, [13, 13, 13], 64, integer=False)
    lnw = np.log(rng.dirichlet(np.ones(64), size=(3, 200))
                 ).transpose(0, 2, 1).astype(np.float32)
    xc = torch.as_tensor(x)
    for topn in (0, 4):
        a = SemiContinuousScorer(g, lnw, sl, topn=topn, device=cuda)
        b = SemiContinuousScorer(g, lnw, sl, topn=topn, device="cpu")
        got, want = a.score(xc.to(cuda)).cpu(), b.score(xc)
        assert bool(((got - want).abs() <= 1e-3 + 1e-5 * want.abs()).all())
    # PTM, continuous top-N and CD/CI interpolation on a small model.
    C, K, D, S = 6, 8, 13, 40
    means = rng.randn(C, 1, K, D).astype(np.float32)
    var = (0.3 + rng.rand(C, 1, K, D)).astype(np.float32)
    gp = GaussianParams(means=means, var=var, prec=(0.5 / var).astype(np.float32),
                        lrd=(-0.5 * (np.log(var).sum(-1) + D * np.log(2 * np.pi))
                             ).astype(np.float32),
                        veclen=[D], n_mgau=C, n_feat=1, n_density=K)
    lnw = np.log(rng.dirichlet(np.ones(K), size=S)).astype(np.float32)
    sen2cb = rng.randint(C, size=S)
    xp = torch.as_tensor((means[rng.randint(C, size=90), 0, 0]
                          + rng.randn(90, D) * 0.5).astype(np.float32))
    lam = rng.rand(S).astype(np.float32)
    cd2ci = np.r_[np.arange(12), rng.randint(12, size=S - 12)]
    for dev_scorers in [
            lambda dev: PTMScorer(gp, lnw, sen2cb, topn=2, device=dev),
            lambda dev: InterpolatedScorer(
                PTMScorer(gp, lnw, sen2cb, device=dev), cd2ci, 12, lam,
                device=dev)]:
        got = dev_scorers(cuda).score(xp.to(cuda)).cpu()
        want = dev_scorers("cpu").score(xp)
        assert bool(((got - want).abs() <= 1e-3 + 1e-5 * want.abs()).all())
    gc = GaussianParams(means=means[:1].repeat(S, 0), var=var[:1].repeat(S, 0),
                        prec=(0.5 / var[:1].repeat(S, 0)).astype(np.float32),
                        lrd=np.zeros((S, 1, K), np.float32), veclen=[D],
                        n_mgau=S, n_feat=1, n_density=K)
    before = fused_mixture_scores.launches
    got = ContinuousScorer(gc, lnw, topn=3, device=cuda).score(xp.to(cuda))
    assert fused_mixture_scores.launches == before     # top-N: plain path
    want = ContinuousScorer(gc, lnw, topn=3, device="cpu").score(xp)
    assert bool(((got.cpu() - want).abs() <= 1e-3 + 1e-5 * want.abs()).all())


def test_frontend_on_card_matches_cpu(cuda):
    from cmusphinx_tpu_torch.frontend import Frontend
    rng = np.random.RandomState(3)
    t = np.arange(9600) / 16000
    sig = (3000 * np.sin(2 * np.pi * 440 * t) + rng.randn(9600) * 300
           ).astype(np.float32)
    for params in ({}, {"transform": "dct", "nfilt": 20, "lowerf": 1,
                        "upperf": 4000},
                   {"transform": "htk", "lifter": 22}, {"logspec": True}):
        cpu = Frontend(device="cpu", **params)
        gpu = Frontend(device=cuda, **params)
        want, got = cpu.process(sig), gpu.process(sig)
        b = np.full(cpu.nfilt, 1e-4)
        if not cpu.logspec:
            b = b @ np.abs(cpu.dct.numpy().astype(np.float64))
            if cpu.lifter is not None:
                b = b * np.abs(cpu.lifter.numpy())
        assert got.shape == want.shape
        assert np.all(np.abs(got.astype(np.float64) - want) <= b)


@pytest.mark.parametrize("model", ["cont", "semi"])
def test_decoder_on_card_matches_cpu(cuda, model, tmp_path):
    from cmusphinx_tpu_torch.utils.bio import write_mfc
    from cmusphinx_tpu_torch.api import Decoder
    fx = fixture.build(0, model=model, size=fixture.SMALL)
    kw = fixture.write_model_dir(fx, str(tmp_path))
    gpu, cpu = Decoder(device=cuda, **kw), Decoder(device="cpu", **kw)
    before = fused_mixture_scores.launches
    for i, c in enumerate(fx.ceps):
        path = str(tmp_path / f"u{i}.mfc")
        write_mfc(path, c)
        h = gpu.decode_cep_file(path)
        assert h.words == cpu.decode_cep_file(path).words == fx.transcripts[i]
    launched = fused_mixture_scores.launches - before
    assert (launched > 0) == (model == "cont")


# ---- the LM backends and the large-vocabulary searches (MEDIUM) ----------

def _lm_queries(lm, n=700):
    rng = np.random.RandomState(4)
    V = lm.n_words
    w1, w2 = rng.randint(-1, V, (2, n))
    w3 = rng.randint(0, V, n)
    tg_b = np.repeat(np.arange(len(lm.bg_wid)), np.diff(lm.tg_ptr))
    bg_w1 = np.repeat(np.arange(V), np.diff(lm.bg_ptr))
    k = rng.randint(0, len(lm.tg_wid), n // 2)
    w1[: n // 2], w2[: n // 2] = bg_w1[tg_b[k]], lm.bg_wid[tg_b[k]]
    w3[: n // 2] = lm.tg_wid[k]
    return [torch.as_tensor(a) for a in (w1, w2, w3)]


@pytest.mark.parametrize("size", ["SMALL", "MEDIUM"])
def test_lm_backends_on_card_match_cpu(cuda, size):
    from cmusphinx_tpu_torch.models.ngram_device import DeviceNgram
    lm = fixture.build(0, size=getattr(fixture, size)).lm
    cpu, gpu = DeviceNgram(lm, device="cpu"), DeviceNgram(lm, device=cuda)
    for d in (cpu, gpu):
        if not d.hashed:
            d._build_hash(lm, d.bg_ptr.device)
    q = _lm_queries(lm)
    qg = [a.to(cuda) for a in q]
    pairs = [(gpu.score_tg_hashed(*qg), cpu.score_tg_hashed(*q)),
             (gpu.score_rows(qg[0], qg[1]), cpu.score_rows(q[0], q[1])),
             (gpu.score_bg(qg[1], qg[2]), cpu.score_bg(q[1], q[2]))]
    if cpu.probe:
        pairs.append((gpu.score_tg_probe(*qg), cpu.score_tg_probe(*q)))
    if cpu.tg_dense is not None:
        pairs.append((gpu.score_tg(*qg), cpu.score_tg(*q)))
    for d in (cpu, gpu):
        d.probe = d.hashed = False
        d.tg_dense = None
    pairs.append((gpu.score_tg(*qg), cpu.score_tg(*q)))      # CSR
    assert gpu.calls["csr"] == 1
    for got, want in pairs:
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("lexmode,kw", [
    ("flat", {}), ("tree", {}), ("tree", {"nlextree": 2}),
    ("flat", {"pl_window": 5, "pl_weight": 2.0}),
    ("tree", {"nlextree": 3, "pl_window": 3})])
def test_large_vocab_decode_on_card_matches_cpu(cuda, lexmode, kw):
    fx = fixture.build(0, size=fixture.MEDIUM)
    runs = []
    for dev in (cuda, "cpu"):
        s = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                        ContinuousScorer(fx.gauden, fx.ln_mixw, device=dev),
                        device=dev, lexmode=lexmode, **kw)
        assert isinstance(s.step, StaticStep if lexmode == "flat"
                          else LexTreeStep)
        hyps = s.decode_batch_cep(fx.ceps, FeatPipeline(fx.feat_config(),
                                                        device=dev))
        runs.append((hyps, [a.cpu().numpy() for a in s._last_batch[0]]))
    (gh, gt), (ch, ct) = runs
    for a, b in zip(gt, ct):
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
        else:
            np.testing.assert_array_equal(a, b)
    assert [h.words for h in gh] == [h.words for h in ch]
    # The lookahead from this fixture's CI phones prunes words away (in
    # both packages alike); the other cases recognize every transcript.
    if "pl_window" not in kw:
        assert [h.words for h in gh] == fx.transcripts


# ---- the grammar, alignment and allphone searches ------------------------

class _Given(torch.nn.Module):
    """A scorer that returns the senone scores it was given."""

    def __init__(self, scores):
        super().__init__()
        self.scores = scores

    def score(self, feats):
        return self.scores


@pytest.mark.parametrize("key", ["jsgf", "fsg"])
def test_grammar_on_card_matches_cpu(cuda, key, tmp_path):
    """The fixture's grammar through the Decoder on the card and on the
    CPU: words, segments and scores (each with its own scorer: scores
    within rtol 1e-5); the CPU search fed the card's senone scores: exit
    tapes (integers equal, floats within rtol 1e-5), the lattice's
    bestpath and N-best; K1 launched once an utterance."""
    import os
    from cmusphinx_tpu_torch.utils.bio import write_mfc
    from cmusphinx_tpu_torch.api import Decoder
    fx = fixture.build(0, size=fixture.SMALL)
    kw = fixture.write_model_dir(fx, str(tmp_path))
    g = {"hmm": kw["hmm"], "dict": kw["dict"],
         key: os.path.join(str(tmp_path), "grammar." + key)}
    gpu, cpu = Decoder(device=cuda, **g), Decoder(device="cpu", **g)
    for i, c in enumerate(fx.ceps):
        path = str(tmp_path / f"u{i}.mfc")
        write_mfc(path, c)
        before = fused_mixture_scores.launches
        h, hc = gpu.decode_cep_file(path), cpu.decode_cep_file(path)
        assert fused_mixture_scores.launches == before + 1
        assert h.words == hc.words == fx.transcripts[i]
        assert [(x.start_frame, x.end_frame) for x in h.segments] == \
            [(x.start_frame, x.end_frame) for x in hc.segments]
        assert h.score == pytest.approx(hc.score, rel=1e-5)
        feats = cpu.fp.compute(c)
        with torch.inference_mode():
            scores = gpu.scorer.score(torch.as_tensor(feats, device=cuda))
        gpu.search.decode(feats)
        own, cpu.search.scorer = cpu.search.scorer, _Given(scores.cpu())
        cpu.search.decode(feats)
        cpu.search.scorer = own
        for a, b in zip(gpu.search._last[:4], cpu.search._last[:4]):
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
            else:
                np.testing.assert_array_equal(a, b)
        lat, latc = gpu.get_lattice(), cpu.get_lattice()
        assert lat.bestpath().words == latc.bestpath().words == h.words
        assert [x.words for x in lat.nbest(5)] == \
            [x.words for x in latc.nbest(5)]


def test_align_and_allphone_on_card_match_cpu(cuda, tmp_path):
    from cmusphinx_tpu_torch.api import Decoder
    fx = fixture.build(0, size=fixture.SMALL)
    kw = fixture.write_model_dir(fx, str(tmp_path))
    gpu, cpu = Decoder(device=cuda, **kw), Decoder(device="cpu", **kw)
    for i, c in enumerate(fx.ceps):
        feats = cpu.fp.compute(c)
        ws, ps, st, sc = gpu.align(feats, fx.transcripts[i])
        wc, pc, stc, scc = cpu.align(feats, fx.transcripts[i])
        assert st == stc and [w.word for w in ws] == fx.transcripts[i]
        assert [(p.phone, p.start_frame, p.end_frame) for p in ps] == \
            [(p.phone, p.start_frame, p.end_frame) for p in pc]
        assert sc == pytest.approx(scc, rel=1e-5)
    ap = {"hmm": kw["hmm"], "allphone": "uniform", "lw": 3.0}
    ga, ca = Decoder(device=cuda, **ap), Decoder(device="cpu", **ap)
    feats = cpu.fp.compute(fx.ceps[0])
    assert ga.search.decode(feats).words == ca.search.decode(feats).words


# ---- streaming and the lattice results on the card ------------------------

@pytest.mark.parametrize("lexmode", ["flat", "tree"])
def test_stream_on_card_matches_batch(cuda, lexmode):
    """A stream (37-frame pushes, a tape that grows from 100 frames) on the
    card against the card's batch decode of the same features and against
    the CPU's stream: integer tapes equal, float tapes within rtol 1e-5,
    K1 launched once a chunk."""
    size = fixture.SMALL if lexmode == "flat" else fixture.MEDIUM
    fx = fixture.build(0, size=size)
    feats = FeatPipeline(fx.feat_config(), device="cpu").compute(fx.ceps[1])
    T = feats.shape[0]
    out = {}
    for dev in (cuda, "cpu"):
        s = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                        ContinuousScorer(fx.gauden, fx.ln_mixw, device=dev),
                        device=dev, lexmode=lexmode)
        before = fused_mixture_scores.launches
        st = s.stream_start(max_frames=100)
        for i in range(0, T, 37):
            s.stream_push(st, feats[i: i + 37])
            s.stream_partial(st)
        hyp = s.stream_end(st)
        launched = fused_mixture_scores.launches - before
        assert st["max_frames"] > 100
        stream = [np.asarray(a) for a in s._last[:6]]
        batch = s.decode(feats)
        E = s.E
        btapes = [a[0, : T * E].cpu().numpy() for a in s._last_batch[0]]
        out[str(dev)] = (hyp, stream, launched)
        for a, b in zip(stream, btapes):
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
            else:
                np.testing.assert_array_equal(a, b)
        assert hyp.words == batch.words == fx.transcripts[1]
    (gh, gt, gl), (ch, ct, cl) = out[str(cuda)], out["cpu"]
    assert gl >= -(-T // 50) and cl == 0
    for a, b in zip(gt, ct):
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0)
        else:
            np.testing.assert_array_equal(a, b)
    assert gh.words == ch.words


def test_native_runtime_loads(cuda):
    from cmusphinx_tpu_torch.utils import native
    assert native.loaded() and native.library_path().exists()


def test_bestpath_on_card_tapes_matches_cpu(cuda):
    """Bestpath, N-best and posteriors from the card's tapes against the
    CPU's on the SMALL fixture with wide beams (lattices of 100+ nodes)."""
    fx = fixture.build(0, size=fixture.SMALL)
    wide = {"beam": 1e-120, "wbeam": 1e-100, "lw": 2.0}
    res = []
    for dev in (cuda, "cpu"):
        s = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                        ContinuousScorer(fx.gauden, fx.ln_mixw, device=dev),
                        device=dev, **wide)
        fp = FeatPipeline(fx.feat_config(), device=dev)
        hyps = s.decode_batch_cep(fx.ceps, fp, bestpath=True)
        lat = s.get_lattice()
        res.append((hyps, lat, lat.nbest(10, start_lmwid=s.start_lmwid),
                    lat.posterior(0.05)))
    (gh, gl, gn, gp), (ch, cl, cn, cp) = res
    for a, b in zip(gh, ch, strict=True):
        assert a.words == b.words
        assert [(x.start_frame, x.end_frame) for x in a.segments] == \
            [(x.start_frame, x.end_frame) for x in b.segments]
        assert a.score == pytest.approx(b.score, rel=1e-5)
    assert [(n.word, n.sf, n.ef) for n in gl.nodes] == \
        [(n.word, n.sf, n.ef) for n in cl.nodes]
    assert len(gl.nodes) > 100
    assert [h.words for h in gn] == [h.words for h in cn]
    m = np.isfinite(cp)
    np.testing.assert_allclose(gp[m], cp[m], rtol=0, atol=1e-4)


def _trained(K=4, steps=2):
    """A CPU Trainer over fixture.SMALL's CI phones after `steps` EM
    steps."""
    fx = fixture.build(0, size=fixture.SMALL)
    phones, pron = fixture.train_corpus(fx)
    feats = FeatPipeline(fx.feat_config(), device="cpu").compute_batch(
        fx.ceps)
    tr = Trainer(FlatModel.create(phones), pron, fx.transcripts, feats, K=K,
                 device="cpu")
    for _ in range(steps):
        tr.em_step()
    return tr


def _args(p, dtype=np.float32):
    return tuple(a.astype(dtype) for a in (p.means, p.prec, p.lnw, p.log_tp))


def _hold_acc(got, want, rtol):
    for k in ("mixw", "mean", "var", "tmat"):
        w = want[k].double().cpu().numpy()
        np.testing.assert_allclose(got[k].double().cpu().numpy(), w,
                                   rtol=rtol, atol=0.1 * rtol * np.abs(w).max(),
                                   err_msg=k)
    assert int(got["n_frames"]) == int(want["n_frames"])


def test_train_forward_backward_and_viterbi_on_card_match_cpu(cuda):
    tr = _trained()
    B, Tmax = tr.batch.feats.shape[:2]
    for kw in ({}, {"weights": np.linspace(0.25, 1.0, B)}):
        gl, ga = bw.forward_backward(tr.batch, *_args(tr.params), device=cuda,
                                     **kw)
        cl, ca = bw.forward_backward(tr.batch, *_args(tr.params),
                                     device="cpu", **kw)
        np.testing.assert_allclose(gl.cpu().numpy(), cl.numpy(), rtol=1e-5)
        _hold_acc(ga, ca, bw.posterior_rtol(cl, Tmax))
    gs, gst = bw.viterbi_align(tr.batch, *_args(tr.params), device=cuda)
    cs, cst = bw.viterbi_align(tr.batch, *_args(tr.params), device="cpu")
    np.testing.assert_allclose(gs.cpu().numpy(), cs.numpy(), rtol=1e-5)
    differ = [b for b in range(B) if not torch.equal(gst[b].cpu(), cst[b])]
    if differ:
        f64 = _args(tr.params, np.float64)
        a = bw.alignment_scores(tr.batch, *f64, gst.cpu(), device="cpu")
        c = bw.alignment_scores(tr.batch, *f64, cst, device="cpu")
        np.testing.assert_allclose(a[differ].numpy(), c[differ].numpy(),
                                   rtol=1e-6)
    assert len(differ) <= 1, differ


def test_train_accumulators_on_card_against_float64(cuda):
    tr = _trained()
    Tmax = tr.batch.feats.shape[1]
    gl, ga = bw.forward_backward(tr.batch, *_args(tr.params), device=cuda)
    dl, da = bw.forward_backward(tr.batch, *_args(tr.params, np.float64),
                                 device="cpu")
    assert da["mixw"].dtype == torch.float64
    np.testing.assert_allclose(gl.cpu().double().numpy(), dl.numpy(),
                               rtol=1e-5)
    _hold_acc(ga, da, bw.posterior_rtol(dl, Tmax))


def test_train_em_step_at_k32_on_card(cuda):
    fx = fixture.build(0, size=fixture.SMALL)
    phones, pron = fixture.train_corpus(fx)
    feats = FeatPipeline(fx.feat_config(), device="cpu").compute_batch(
        fx.ceps)
    trs = [Trainer(FlatModel.create(phones), pron, fx.transcripts, feats,
                   K=32, device=dev) for dev in (cuda, "cpu")]
    assert trs[0].dbatch.feats.device.type == torch.device(cuda).type
    rtol = bw.posterior_rtol(trs[1].accumulate()[0],
                             trs[1].batch.feats.shape[1])
    g, c = (tr.em_step() for tr in trs)
    assert g == pytest.approx(c, rel=1e-5)
    for k in ("means", "var", "lnw", "tp"):
        a, b = getattr(trs[0].params, k), getattr(trs[1].params, k)
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=0.1 * rtol * np.abs(b).max(),
                                   err_msg=k)



# ---- approximate and replayed scoring, the endpointer, time-parallel
# alignment and the multi-process dry run on the card ----------------------

def _small_feats():
    fx = fixture.build(0, size=fixture.SMALL)
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    return fx, np.concatenate([fp.compute(c) for c in fx.ceps])


def test_products_run_in_ieee_f32(cuda):
    """TF32 stays off for every plain f32 product of the port (the package
    switches it off at import): the flags, and a product whose TF32
    rounding (2^-11 relative) would show against float64."""
    import cmusphinx_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    g = torch.Generator().manual_seed(0)
    a = torch.randn(256, 39, generator=g) * 30 + 100
    b = torch.randn(39, 512, generator=g)
    got = (a.to(cuda) @ b.to(cuda)).cpu().double()
    want = a.double() @ b.double()
    bound = 39 * 2.0 ** -23 * (a.double().abs() @ b.double().abs())
    assert bool(((got - want).abs() <= bound).all())


def test_approx_scorers_on_card_match_cpu(cuda):
    from cmusphinx_tpu_torch.ops import approx
    fx, x = _small_feats()
    gpu = ContinuousScorer(fx.gauden, fx.ln_mixw, device=cuda)
    cpu = ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu")
    xg, xc = torch.as_tensor(x, device=cuda), torch.as_tensor(x)
    M = _magnitude(xc, cpu.lin, cpu.quad, cpu.const).numpy()
    D = x.shape[1]
    m = fx.mdef
    # Around K1: its 3xTF32 products against the CPU's IEEE f32 ones.
    for g, c in ((approx.DownsampledScorer(gpu, 3),
                  approx.DownsampledScorer(cpu, 3)),
                 (approx.CigmmsScorer(gpu, m.cd2cisen, m.n_ci_sen, 7.0,
                                      device=cuda),
                  approx.CigmmsScorer(cpu, m.cd2cisen, m.n_ci_sen, 7.0,
                                      device="cpu"))):
        fused_mixture_scores.launches = 0
        out = g.score(xg)
        assert out.device.type == "cuda" and fused_mixture_scores.launches == 1
        err = np.abs(out.cpu().double().numpy() - c.score(xc).numpy())
        assert np.all(err <= SAME_BOUND["highest"] * D * 2.0 ** -22 * M)
    # The masked selectors: IEEE f32 both sides, where the masks agree.
    codebook = approx.vq_codebook(fx.gauden, 16)
    for g, c, mask in (
            (approx.GsSelectorScorer(gpu, fx.gauden, codebook=codebook,
                                     device=cuda),
             approx.GsSelectorScorer(cpu, fx.gauden, codebook=codebook,
                                     device="cpu"), "clusters"),
            (approx.KdTreeSelectorScorer(gpu, fx.gauden, depth=4,
                                         radius=1.5, device=cuda),
             approx.KdTreeSelectorScorer(cpu, fx.gauden, depth=4,
                                         radius=1.5, device="cpu"),
             "leaves")):
        km, kc = getattr(g, mask)(xg).cpu(), getattr(c, mask)(xc)
        agree = (km == kc) if km.dim() == 1 else (km == kc).all(1)
        if mask == "leaves":
            assert bool(agree.all())
        assert int((~agree).sum()) <= 2
        out = g.score(xg)
        assert out.device.type == "cuda"
        err = np.abs(out.cpu().double().numpy() - c.score(xc).numpy())
        ok = agree.numpy()
        assert np.all(err[ok] <= D * 2.0 ** -22 * M[ok])


def test_subvq_and_replay_on_card_match_cpu(cuda, tmp_path):
    from cmusphinx_tpu_torch.ops.subvq import SubVQScorer, build_subvq
    from cmusphinx_tpu_torch.utils.senfh import ReplayScorer, write_senscr
    fx, x = _small_feats()
    svq = build_subvq(fx.gauden, vqsize=16, n_iter=4, n_restarts=1)
    g = SubVQScorer(svq, fx.ln_mixw, device=cuda)
    c = SubVQScorer(svq, fx.ln_mixw, device="cpu")
    xg, xc = torch.as_tensor(x, device=cuda), torch.as_tensor(x)
    dens = c.codeword_densities(xc)
    tol = 3 * 2.0 ** -20 * float(dens.abs().max())
    out = g.score(xg)
    assert out.device.type == "cuda"
    np.testing.assert_allclose(out.cpu().numpy(), c.score(xc).numpy(),
                               rtol=0, atol=tol)
    sl, slc = g.shortlist(xg, 10.0).cpu(), c.shortlist(xc, 10.0)
    assert int((sl != slc).sum()) <= 2
    path = str(tmp_path / "u.sen")
    write_senscr(path, c.score(xc).numpy())
    r = ReplayScorer.from_file(path, device=cuda)
    out = r.score(torch.zeros((2, len(x) + 5, 39), device=cuda))
    assert out.device.type == "cuda" and out.shape == (2, len(x) + 5,
                                                       svq.map.shape[0])
    np.testing.assert_array_equal(
        out[1].cpu().numpy(),
        ReplayScorer.from_file(path, device="cpu").score(
            torch.zeros((len(x) + 5, 39))).numpy())


def test_frame_classifier_on_card_matches_cpu(cuda):
    from cmusphinx_tpu_torch.frontend.ep import Endpointer, FrameClassifier
    fx, x = _small_feats()
    labels = (x[:, 0] > np.median(x[:, 0])).astype(np.int64)
    g = FrameClassifier.fit(x, labels, 2, n_comp=4, n_iter=6, device=cuda)
    c = FrameClassifier.fit(x, labels, 2, n_comp=4, n_iter=6, device="cpu")
    assert g.lin.device.type == "cuda"
    np.testing.assert_allclose(g.means, c.means, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g.var, c.var, rtol=1e-4)
    same = copy.deepcopy(c).to(cuda)        # the CPU's buffers, moved
    ll, llc = same.log_likelihoods(x), c.log_likelihoods(x)
    xd = x.astype(np.float64)
    M = (np.abs(c.const.double().numpy())[None] + np.abs(xd) @ np.abs(
        c.lin.double().numpy()) + (xd * xd) @ c.quad.double().numpy())
    M = M.reshape(len(x), 2, 4).max(-1)
    assert np.all(np.abs(ll.astype(np.float64) - llc)
                  <= x.shape[1] * 2.0 ** -22 * M)
    classes = same.classify(x)
    np.testing.assert_array_equal(classes, c.classify(x))
    assert [(u.start_frame, u.end_frame) for u in
            Endpointer().segment(classes)] == \
        [(u.start_frame, u.end_frame) for u in
         Endpointer().segment(c.classify(x))]


def test_align_time_parallel_on_card_matches_cpu(cuda):
    from cmusphinx_tpu_torch.decode.align import AlignSearch
    from cmusphinx_tpu_torch.decode.align_tp import align_time_parallel
    fx, _ = _small_feats()
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    feats = np.concatenate([fp.compute(c) for c in fx.ceps])
    words = sum(fx.transcripts, [])
    ga = AlignSearch(fx.dict, fx.mdef, fx.tmat,
                     ContinuousScorer(fx.gauden, fx.ln_mixw, device=cuda),
                     device=cuda)
    ca = AlignSearch(fx.dict, fx.mdef, fx.tmat,
                     ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu"),
                     device="cpu")
    fused_mixture_scores.launches = 0
    st, sc = align_time_parallel(ga, feats, words, n_chunks=8)
    assert fused_mixture_scores.launches == 1
    st2, sc2 = align_time_parallel(ga, feats, words, n_chunks=8,
                                   devices=[cuda, cuda])
    np.testing.assert_array_equal(st, st2)
    assert sc == sc2
    _, _, seq, seq_score = ga.align(feats, words)
    rel = 4 * len(feats) * 2.0 ** -24
    assert sc == pytest.approx(seq_score, rel=rel)
    stc, scc = align_time_parallel(ca, feats, words, n_chunks=8)
    assert sc == pytest.approx(scc, rel=rel)
    assert len(st) == len(feats)


def test_dryrun_over_nccl_one_rank(cuda):
    from cmusphinx_tpu_torch.parallel.dryrun import dryrun_multichip
    out = dryrun_multichip(1, "cuda")
    assert out["backend"] == "nccl" and out["ranks"] == 1
    assert out["decode"]["tree"]["int_values_differing"] == 0
    assert (out["dp"], out["mp"]) == (1, 1)
    assert out["decode"]["semi"]["segments_equal"]


@pytest.mark.parametrize("S,K,D,T", [(5150, 32, 39, 300), (301, 32, 39, 517),
                                     (37, 4, 13, 129), (57, 4, 65, 200),
                                     (41, 32, 150, 300)])
@pytest.mark.parametrize("mode", ["highest", "high", "bf16"])
def test_k1_on_senone_shards_equals_its_columns(cuda, mode, S, K, D, T):
    """K1 over a senone shard (its own packed tiles, the shard's first
    senone at the start of a tile) gives the unsharded call's columns bit
    for bit, and score_shards the whole."""
    from cmusphinx_tpu_torch.parallel.senone_shard import score_shards
    rng = np.random.RandomState(S + K + D + T + 1)
    g, lnw, _, _ = _k1_model(rng, S, K, D)
    sc = ContinuousScorer(g, lnw, precision=mode, device=cuda)
    x = torch.as_tensor(rng.randn(T, D).astype(np.float32), device=cuda)
    want = sc.score(x)
    for mp in (2, 3):
        before = fused_mixture_scores.launches
        got = score_shards(sc, x, mp)
        torch.cuda.synchronize()
        assert fused_mixture_scores.launches == before + mp
        assert torch.equal(got, want), (mp, float((got - want).abs().max()))


def test_tools_fe_on_card_matches_cpu(cuda, tmp_path, monkeypatch, capsys):
    from cmusphinx_tpu_torch.cli import tools
    from cmusphinx_tpu_torch.frontend import Frontend
    from cmusphinx_tpu_torch.utils.bio import read_mfc
    for i in range(3):
        fixture.synthetic_pcm(i, seconds=0.6 + 0.4 * i).tofile(
            str(tmp_path / f"p{i}.raw"))
    (tmp_path / "c.ctl").write_text("p0\np1\np2\n")
    monkeypatch.chdir(tmp_path)
    lines = {}
    for plat, out in (("cuda", "card"), ("cpu", "host")):
        assert tools.main(["fe", "-c", "c.ctl", "-do", out, "-platform",
                           plat]) == 0
        lines[plat] = capsys.readouterr().out
    assert lines["cuda"] == lines["cpu"] and "processed 3 files" in \
        lines["cpu"]
    fe = Frontend(device="cpu")
    b = np.full(fe.nfilt, 1e-4) @ np.abs(fe.dct.numpy().astype(np.float64))
    if fe.lifter is not None:
        b = b * np.abs(fe.lifter.numpy())
    for i in range(3):
        got = read_mfc(str(tmp_path / "card" / f"p{i}.mfc"))
        want = read_mfc(str(tmp_path / "host" / f"p{i}.mfc"))
        assert got.shape == want.shape and len(got)
        assert np.all(np.abs(got.astype(np.float64) - want) <= b)


# ---- the N-gram frame loop as captured CUDA graphs -------------------------

GRAPH_CASES = {
    "mpx": ("SMALL", {}),
    "mpx_lookahead": ("SMALL", {"pl_window": 5, "pl_weight": 2.0}),
    "static": ("MEDIUM", {"lexmode": "flat"}),
    "tree": ("MEDIUM", {"lexmode": "tree"}),
    "tree_copies": ("MEDIUM", {"lexmode": "tree", "nlextree": 2}),
    "tree_copies_lookahead": ("MEDIUM", {"lexmode": "tree", "nlextree": 3,
                                         "pl_window": 3}),
}


def _card_search(cuda, fx, **kw):
    return NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                       ContinuousScorer(fx.gauden, fx.ln_mixw, device=cuda),
                       device=cuda, **kw)


def _run(s, graphs: bool, fn):
    """fn() with the search's frame loop graphed or eager; returns (its
    result, the LM calls it made)."""
    s._runner.graphs = graphs
    s.dlm.calls.clear()
    try:
        out = fn()
    finally:
        s._runner.graphs = True
    torch.cuda.synchronize()
    return out, dict(s.dlm.calls)


def _stream(s, feats, push=37, max_frames=100):
    st = s.stream_start(max_frames=max_frames)
    for i in range(0, len(feats), push):
        s.stream_push(st, feats[i: i + push])
    hyp = s.stream_end(st)
    return hyp, [t.clone() for t in st["tape"]], st["max_frames"]


def _assert_same_hyps(a, b):
    for x, y in zip(a, b, strict=True):
        assert x.words == y.words and x.score == y.score
        assert [(s.word, s.start_frame, s.end_frame) for s in x.segments] \
            == [(s.word, s.start_frame, s.end_frame) for s in y.segments]


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graphed_frame_loop_bit_equal_to_eager(cuda, case):
    """Each step kind on the card: the batch, a batch whose blocks of 37
    frames leave a shorter last one, and a stream (37-frame pushes from a
    100-frame tape that grows) through captured graphs against the eager
    loop (`_runner.graphs = False`): tapes bit-equal, hypotheses and scores
    equal, `DeviceNgram.calls` equal; the graphed runs captured blocks
    and replayed them."""
    size, kw = GRAPH_CASES[case]
    fx = fixture.build(0, size=getattr(fixture, size))
    s = _card_search(cuda, fx, **kw)
    fp = FeatPipeline(fx.feat_config(), device=cuda)

    def batch():
        hyps = s.decode_batch_cep(fx.ceps, fp)
        return hyps, [t.clone() for t in s._last_batch[0]]

    for block in (None, 37):
        if block:
            s._block_len = lambda B, n: block
        (gh, gt), gcalls = _run(s, True, batch)
        (eh, et), ecalls = _run(s, False, batch)
        _assert_same_hyps(gh, eh)
        assert all(torch.equal(a, b) for a, b in zip(gt, et))
        assert gcalls == ecalls and sum(ecalls.values()) > 0
    assert s.graph_stats["captures"] >= 3   # 100 frames; 37, the last
    feats = FeatPipeline(fx.feat_config(), device="cpu").compute(fx.ceps[1])
    (gh, gt, gF), gcalls = _run(s, True, lambda: _stream(s, feats))
    (eh, et, eF), ecalls = _run(s, False, lambda: _stream(s, feats))
    _assert_same_hyps([gh], [eh])
    assert gF == eF > 100 and gcalls == ecalls
    assert all(torch.equal(a, b) for a, b in zip(gt, et))
    assert len(s._runner.cache) <= ngram_search.GRAPH_CACHE
    assert s.graph_stats["replays"] > 0


@pytest.mark.parametrize("case", ["mpx", "static", "tree"])
def test_graphed_mixed_lengths_share_graphs(cuda, case):
    """Utterances one at a time in nine 100-frame buckets: the mpx step
    replays one graph for all of them (its key holds no frame count), the
    static and tree steps one a side-table size (100 frames times a power
    of two: 100 .. 1600); each decode bit-equal to the eager loop's."""
    size, kw = GRAPH_CASES[case]
    fx = fixture.build(0, size=getattr(fixture, size))
    s = _card_search(cuda, fx, **kw)
    fp = FeatPipeline(fx.feat_config(), device=cuda)
    pool = np.concatenate(fx.ceps * (-(-900 // sum(map(len, fx.ceps))) + 1))
    ceps = [pool[7 * b: 100 * b + 50 + 7 * b] for b in range(9)]
    for c in ceps:
        (gh, gt), _ = _run(s, True, lambda: (
            s.decode_batch_cep([c], fp), [t.clone() for t in s._last_batch[0]]))
        (eh, et), _ = _run(s, False, lambda: (
            s.decode_batch_cep([c], fp), [t.clone() for t in s._last_batch[0]]))
        _assert_same_hyps(gh, eh)
        assert all(torch.equal(a, b) for a, b in zip(gt, et))
    want = 1 if case == "mpx" else len({s._side_frames(len(c)) for c in ceps})
    assert s.graph_stats["captures"] == len(s._runner.cache) == want
    assert s._runner.pool is not None


@pytest.mark.parametrize("case", ["mpx", "tree"])
def test_graphed_streams_interleaved(cuda, case):
    """Two streams in flight on one search, pushed in turn, each equal
    (tapes bit-equal, final hypotheses) to its run alone."""
    size, kw = GRAPH_CASES[case]
    fx = fixture.build(0, size=getattr(fixture, size))
    s = _card_search(cuda, fx, **kw)
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    feats = [fp.compute(fx.ceps[i]) for i in (0, 1)]
    alone = [_stream(s, f, max_frames=3000) for f in feats]
    sts = [s.stream_start(max_frames=3000) for _ in feats]
    for i in range(0, max(len(f) for f in feats), 37):
        for st, f in zip(sts, feats):
            s.stream_push(st, f[i: i + 37])
    for st, (hyp, tape, _) in zip(sts, alone):
        _assert_same_hyps([s.stream_end(st)], [hyp])
        assert all(torch.equal(a, b) for a, b in zip(st["tape"], tape))


def test_graphed_decode_keeps_earlier_tapes(cuda):
    """A tape returned by one decode is not overwritten by the next decode
    of the same shapes (the same graphs replayed)."""
    fx = fixture.build(0, size=fixture.MEDIUM)
    s = _card_search(cuda, fx, lexmode="tree")
    fp = FeatPipeline(fx.feat_config(), device=cuda)
    s.decode_batch_cep(fx.ceps[:2], fp)
    first = s._last_batch[0]
    kept = [t.clone() for t in first]
    n = s.graph_stats["captures"]
    s.decode_batch_cep(fx.ceps[1:3], fp)
    torch.cuda.synchronize()
    assert s.graph_stats["captures"] == n     # replayed, not recaptured
    assert not all(torch.equal(a, b) for a, b in zip(s._last_batch[0], kept))
    assert all(torch.equal(a, b) for a, b in zip(first, kept))


def test_graphed_replays_make_no_host_sync(cuda):
    """Once captured, the frame loop of a batch (`_viterbi`) replays under
    torch.cuda.set_sync_debug_mode("error")."""
    fx = fixture.build(0, size=fixture.MEDIUM)
    for kw in ({"lexmode": "tree", "pl_window": 3}, {"lexmode": "flat"}):
        s = _card_search(cuda, fx, **kw)
        fp = FeatPipeline(fx.feat_config(), device=cuda)
        with torch.inference_mode():
            c, T, _ = s._pad(fx.ceps)
            valid = (torch.arange(c.shape[1], device=cuda)[None, :]
                     < T[:, None])
            scores = s.scorer.score(fp._padded_kernel(c, T, True))
            want = s._viterbi(scores, valid)
            torch.cuda.synchronize()
            n = s.graph_stats["captures"]
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = s._viterbi(scores, valid)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert n >= 1 and s.graph_stats["captures"] == n
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_frame_loop_span_holds_its_graph_kernels(cuda, tmp_path):
    """Under the profiler, a fresh search's first decode captures inside
    `frame_loop.capture` spans nested in `frame_loop`; a graphed decode's
    `frame_loop` span holds kernels of its replays, found through the
    correlation id that a kernel shares with its `cudaGraphLaunch`, and
    starts before the first of them on the trace's one clock."""
    fx = fixture.build(0, size=fixture.MEDIUM)
    s = _card_search(cuda, fx, lexmode="tree")
    fp = FeatPipeline(fx.feat_config(), device=cuda)

    def spans(path, activities):
        with profile(activities=activities) as p:
            s.decode_batch_cep(fx.ceps, fp)
            torch.cuda.synchronize()
        p.export_chrome_trace(str(path))
        with open(path) as fh:
            return json.load(fh)["traceEvents"]

    ev = spans(tmp_path / "first.json", [ProfilerActivity.CPU])
    ann = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
           if e.get("cat") == "user_annotation"]
    (l0, l1, _), = [a for a in ann if a[2] == "frame_loop"]
    caps = [a for a in ann if a[2] == "frame_loop.capture"]
    assert caps and all(l0 <= a <= b <= l1 for a, b, _ in caps)
    assert len(caps) == s.graph_stats["captures"]

    ev = spans(tmp_path / "replay.json",
               [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    (l0, l1), = [(e["ts"], e["ts"] + e["dur"]) for e in ev
                 if e.get("cat") == "user_annotation"
                 and e["name"] == "frame_loop"]
    graph_launch = {e["args"]["correlation"] for e in ev
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and e["name"].startswith("cudaGraphLaunch")
                    and l0 <= e["ts"] <= l1}
    kernels = [e["ts"] for e in ev if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in graph_launch]
    assert graph_launch and kernels
    assert l0 < min(kernels)
    assert s.graph_stats["captures"] == len(caps)


# ---- the one-copy tree step's kernels (ops/tree_step.py) -------------------

def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_bits(a, b):
    return all(x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
               for x, y in zip(a, b, strict=True))


def _held_to_plain(monkeypatch):
    """Make every call of the tree step's two kernels also run their plain
    version on the card, on copies of the same inputs, and assert the
    results bit-equal; returns the calls' log (valid rows of each
    `prune_enter`)."""
    from cmusphinx_tpu_torch.ops import tree_step
    kernel_a, kernel_b = tree_step.step_exits, tree_step.prune_enter
    log = []

    def step_exits(alpha0, hist0, rows, tab):
        got = kernel_a(alpha0, hist0, rows, tab)
        assert _same_bits(got, tree_step.step_exits_ref(alpha0, hist0, rows,
                                                        tab))
        return got

    def prune_enter(alpha0, hist0, st, ent, corr, la_t, valid, tab):
        want = tree_step.prune_enter_ref(alpha0.clone(), hist0.clone(), st,
                                         ent, corr, la_t, valid, tab)
        got = kernel_b(alpha0, hist0, st, ent, corr, la_t, valid, tab)
        assert _same_bits(got, want)
        log.append(valid.cpu())
        return got

    monkeypatch.setattr(tree_step, "step_exits", step_exits)
    monkeypatch.setattr(tree_step, "prune_enter", prune_enter)
    return log


@pytest.mark.parametrize("kw", [{}, {"treela": "ug"}, {"prune": False},
                                {"treela": "ug", "prune": False},
                                {"pl_window": 3}])
def test_tree_step_kernels_bit_equal_to_plain_on_decodes(cuda, kw,
                                                         monkeypatch):
    """The MEDIUM tree fixture decoded on the card, eager: at every frame
    the two kernels' results (the stepped alpha, ages, exits and best
    scores; the new carry) equal the plain version's bit for bit, rows past
    an utterance's end (not valid) included, with the bigram and the
    unigram lookahead, the beams on and off, and the phone-loop
    lookahead."""
    fx = fixture.build(0, size=fixture.MEDIUM)
    s = _card_search(cuda, fx, lexmode="tree", **kw)
    log = _held_to_plain(monkeypatch)
    s._runner.graphs = False
    s.decode_batch_cep(fx.ceps, FeatPipeline(fx.feat_config(), device=cuda))
    torch.cuda.synchronize()
    valid = torch.stack(log)
    assert len(log) == s._last_batch[0][0].shape[1] // s.E
    assert valid.any() and not valid.all()


@pytest.mark.parametrize("S", [1, 2, 3, 4, 5])
def test_tree_step_kernels_bit_equal_to_plain_on_planted_ties(cuda, S):
    """Both kernels against their plain version on the card, bit for bit,
    on `planted` inputs (ties in the exits and in every transition,
    channels at NEG_INF, ages 254 and 255, one row not valid), with the
    beams on and off, with and without the bigram corrections and the
    phone-loop lookahead (taken as a strided slice, as a block passes
    it)."""
    from cmusphinx_tpu_torch.ops import tree_step
    B, C, n_xs, R, n_ci = 4, 3001, 257, 37, 11
    alpha, ages, rows, tab, ent, corr, la = (
        x.to(cuda) if isinstance(x, torch.Tensor) else x
        for x in planted(S, C, B, n_xs, R, n_ci, S))
    tab = tree_step.Tables(*(x.to(cuda) if isinstance(x, torch.Tensor)
                             else x for x in tab[:8]),
                           tuple(b.to(cuda) for b in tab.bands), *tab[9:])
    valid = torch.tensor([True, False, True, True], device=cuda)
    got = tree_step.step_exits(alpha, ages, rows, tab)
    want = tree_step.step_exits_ref(alpha, ages, rows, tab)
    assert _same_bits(got, want)
    # The planted ties are there: the exits and the transitions tie.
    s = alpha + rows[:, tab.xs]
    if S >= 2:
        e_l = s[..., -1] + tab.bands[3]
        assert (e_l == s[..., -2] + tab.bands[4]).sum() > 100
        assert (s[..., 1:] + tab.bands[0][:, 1:]
                == s[..., :-1] + tab.bands[1]).sum() > 100
    assert (want.hist == 255).any() and (ages == 254).any()
    la_block = torch.stack([la, la], 1)[:, 1]             # strided rows
    for prune, c, l in [(True, corr, la_block), (True, None, None),
                        (False, corr, None), (False, None, la_block)]:
        t = tab._replace(prune=prune)
        outs = []
        for fn in (tree_step.prune_enter, tree_step.prune_enter_ref):
            a0, h0 = alpha.clone(), ages.clone()
            outs.append(fn(a0, h0, got, ent, c, l, valid, t))
        assert _same_bits(outs[0], outs[1])
        assert _same_bits((outs[0][0][1], outs[0][1][1]), (alpha[1], ages[1]))
        assert not torch.equal(outs[0][0], alpha)


def test_tree_step_launches_two_a_frame_across_replays(cuda):
    """`tree_step.launches`, a counter of the N-gram search's block runner:
    two launches (one of each kernel) a padded frame step of the batch,
    in the first decode (which captures its graphs), in the next (which
    only replays them) and eager."""
    from cmusphinx_tpu_torch.ops import tree_step
    fx = fixture.build(0, size=fixture.MEDIUM)
    s = _card_search(cuda, fx, lexmode="tree")
    fp = FeatPipeline(fx.feat_config(), device=cuda)
    counts = []
    for graphs in (True, True, False):
        s._runner.graphs = graphs
        tree_step.launches.clear()
        n = s.graph_stats["captures"]
        s.decode_batch_cep(fx.ceps, fp)
        torch.cuda.synchronize()
        frames = s._last_batch[0][0].shape[1] // s.E
        counts.append((dict(tree_step.launches), frames,
                       s.graph_stats["captures"] - n))
    s._runner.graphs = True
    (first, F, caps), (second, F2, caps2), (eager, F3, _) = counts
    assert F == F2 == F3 > 0 and caps > 0 and caps2 == 0
    for c in (first, second, eager):
        assert c == {"step_exits": F, "prune_enter": F}



# ---- the mpx step's kernels (ops/mpx_step.py) ------------------------------

MPX_CASES = {"mpx": {}, "mpx_lookahead": {"pl_window": 5, "pl_weight": 2.0},
             "mpx_composite": {"rcmode": "composite", "lcmode": "mpx"},
             "mpx_noprune": {"prune": False}}


class _HostScores(torch.nn.Module):
    """A CPU scorer's scores on the device its input is on: the card's and
    the CPU's searches then read the same scores."""

    def __init__(self, host):
        super().__init__()
        self.host = host

    def score(self, x):
        return self.host.score(x.cpu()).to(x.device)


def _held_to_plain_mpx(monkeypatch):
    """Make every call of the mpx step's two kernels also run their plain
    version on the card, on copies of the same inputs, and assert the
    results bit-equal; returns the calls' log (valid rows of each
    `prune_enter`)."""
    from cmusphinx_tpu_torch.ops import mpx_step
    kernel_a, kernel_b = mpx_step.step_exits, mpx_step.prune_enter
    log = []

    def step_exits(carry, rows, tab):
        got = kernel_a(carry, rows, tab)
        assert _same_bits(got, mpx_step.step_exits_ref(carry, rows, tab))
        return got

    def prune_enter(carry, rows, st, ent_w, ent_pay, la_t, valid, tab):
        want = mpx_step.prune_enter_ref(tuple(t.clone() for t in carry),
                                        rows, st, ent_w, ent_pay, la_t,
                                        valid, tab)
        got = kernel_b(carry, rows, st, ent_w, ent_pay, la_t, valid, tab)
        assert _same_bits(got, want)
        log.append(valid.cpu())
        return got

    monkeypatch.setattr(mpx_step, "step_exits", step_exits)
    monkeypatch.setattr(mpx_step, "prune_enter", prune_enter)
    return log


@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("case", sorted(MPX_CASES))
def test_mpx_step_kernels_bit_equal_to_plain_on_decodes(cuda, case, B,
                                                        monkeypatch):
    """The SMALL fixture decoded on the card, eager, with fanout (Vr > 1)
    and composite (Vr = 1) exits, the phone-loop lookahead, the beams off,
    one utterance and a batch of 16: at every frame the two kernels'
    results (the exits, their payloads and the best scores; the new carry)
    equal the plain version's bit for bit, rows past an utterance's end
    (not valid) included."""
    fx = fixture.build(0, size=fixture.SMALL)
    s = _card_search(cuda, fx, **MPX_CASES[case])
    assert s.graph.lc_mode == "mpx"
    assert (s.graph.n_rcvar == 1) == (case == "mpx_composite")
    log = _held_to_plain_mpx(monkeypatch)
    s._runner.graphs = False
    s.decode_batch_cep(fx.ceps[:B], FeatPipeline(fx.feat_config(),
                                                 device=cuda))
    torch.cuda.synchronize()
    valid = torch.stack(log)
    assert len(log) == s._last_batch[0][0].shape[1] // s.E
    assert valid.any() and (B == 1 or not valid.all())


@pytest.mark.parametrize("S", [1, 2, 3, 4, 5])
def test_mpx_step_kernels_bit_equal_to_plain_on_planted_ties(cuda, S):
    """Both kernels against their plain version on the card, bit for bit,
    on `planted` inputs (ties in the exits and in every transition,
    channels and senone rows at NEG_INF, one row not valid), with the
    beams on and off, with and without the phone-loop lookahead (taken as
    a strided slice, as a block passes it)."""
    from cmusphinx_tpu_torch.ops import mpx_step
    B, C, n_xs, W, n_ci = 4, 3001, 257, 401, 11
    carry, rows, tab, ent_w, ent_pay, la = planted_mpx(S, C, B, n_xs, W,
                                                       n_ci, S)
    carry = tuple(t.to(cuda) for t in carry)
    rows, ent_w, ent_pay, la = (t.to(cuda) for t in (rows, ent_w, ent_pay,
                                                     la))
    tab = mpx_step.Tables(*(x.to(cuda) for x in tab[:8]),
                          tuple(b.to(cuda) for b in tab.bands), *tab[9:])
    valid = torch.tensor([True, False, True, True], device=cuda)
    got = mpx_step.step_exits(carry, rows, tab)
    assert _same_bits(got, mpx_step.step_exits_ref(carry, rows, tab))
    stepped = hmm_step(carry[0], (), torch.gather(
        rows, 1, carry[2].long()), tab.bands)[0]
    la_block = torch.stack([la, la], 1)[:, 1]             # strided rows
    for prune, l in [(True, la_block), (True, None), (False, None),
                     (False, la_block)]:
        t = tab._replace(prune=prune)
        outs = [fn(tuple(c.clone() for c in carry), rows, got, ent_w,
                   ent_pay, l, valid, t)
                for fn in (mpx_step.prune_enter, mpx_step.prune_enter_ref)]
        assert _same_bits(outs[0], outs[1])
        assert _same_bits([c[1] for c in outs[0]], [c[1] for c in carry])
        assert not torch.equal(outs[0][0], carry[0])
        entered = outs[0][0][..., 0] != stepped[..., 0]
        assert entered[:, tab.is_entry].any()
        assert entered[:, ~tab.is_entry].any()


@pytest.mark.parametrize("case", ["mpx", "mpx_composite", "mpx_lookahead"])
def test_mpx_step_decodes_and_streams_equal_eager_and_cpu(cuda, case):
    """The same senone scores (the CPU scorer's) through the mpx step on
    the card, graphed and eager, and on the CPU: the batch's tapes
    bit-equal across the three, and a stream's (37-frame pushes) tapes and
    final hypothesis equal the CPU stream's."""
    fx = fixture.build(0, size=fixture.SMALL)
    host = ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu")
    kw = MPX_CASES[case]
    card = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, _HostScores(host),
                       device=cuda, **kw)
    cpu = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, host, device="cpu",
                      **kw)
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    feats = [fp.compute(c) for c in fx.ceps]
    hyps, tapes = [], []
    for s, graphs in ((card, True), (card, False), (cpu, False)):
        s._runner.graphs = graphs
        hyps.append(s.decode_batch(feats))
        tapes.append([t.cpu() for t in s._last_batch[0]])
    card._runner.graphs = True
    assert card.graph_stats["captures"] > 0
    for h, t in zip(hyps[1:], tapes[1:]):
        _assert_same_hyps(hyps[0], h)
        assert _same_bits(tapes[0], t)
    (gh, gt, _), (ch, ct, _) = (_stream(s, feats[1]) for s in (card, cpu))
    _assert_same_hyps([gh], [ch])
    assert _same_bits([t.cpu() for t in gt], ct)


def test_mpx_step_launches_two_a_frame_across_replays(cuda):
    """`mpx_step.launches`, a counter of the N-gram search's block runner:
    two launches (one of each kernel) a padded frame step of an mpx batch,
    in the first decode (which captures its graphs), in the next (which
    only replays them) and eager, and a stream's 50 a chunk; none in the
    static and tree decodes, whose own kernels do not count here."""
    from cmusphinx_tpu_torch.ops import mpx_step, tree_step
    fx = fixture.build(0, size=fixture.SMALL)
    s = _card_search(cuda, fx)
    fp = FeatPipeline(fx.feat_config(), device=cuda)
    counts = []
    for graphs in (True, True, False):
        s._runner.graphs = graphs
        mpx_step.launches.clear()
        tree_step.launches.clear()
        n = s.graph_stats["captures"]
        s.decode_batch_cep(fx.ceps, fp)
        torch.cuda.synchronize()
        frames = s._last_batch[0][0].shape[1] // s.E
        counts.append((dict(mpx_step.launches), frames,
                       s.graph_stats["captures"] - n, dict(tree_step.launches)))
    s._runner.graphs = True
    (first, F, caps, t1), (second, F2, caps2, t2), (eager, F3, _, t3) = counts
    assert F == F2 == F3 > 0 and caps > 0 and caps2 == 0
    assert t1 == t2 == t3 == {}
    for c in (first, second, eager):
        assert c == {"step_exits": F, "prune_enter": F}
    feats = FeatPipeline(fx.feat_config(), device="cpu").compute(fx.ceps[1])
    mpx_step.launches.clear()
    _stream(s, feats)
    chunks = -(-len(feats) // s.CHUNK)
    assert dict(mpx_step.launches) == {"step_exits": chunks * s.CHUNK,
                                       "prune_enter": chunks * s.CHUNK}
    medium = fixture.build(0, size=fixture.MEDIUM)
    fp = FeatPipeline(medium.feat_config(), device=cuda)
    for kw in ({"lexmode": "flat"}, {"lexmode": "tree"}):
        mpx_step.launches.clear()
        _card_search(cuda, medium, **kw).decode_batch_cep(medium.ceps[:4], fp)
        torch.cuda.synchronize()
        assert not mpx_step.launches

_FAILED_CAPTURE = """
import sys, torch
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.decode import NgramSearch
from cmusphinx_tpu_torch.frontend import FeatPipeline
from cmusphinx_tpu_torch.ops import ContinuousScorer
fx = fixture.build(0, size=fixture.SMALL)
feats = FeatPipeline(fx.feat_config(), device="cpu").compute(fx.ceps[0])
host = ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu")

class HostScores(torch.nn.Module):
    # The CPU scorer's scores moved to the card (no kernel build).
    def score(self, x):
        return host.score(x.cpu()).to(x.device)

s = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, HostScores(),
                device="cuda")
ro = s.step.ro
entries = ro.entries
def reads_host(*a, **k):
    out = entries(*a, **k)
    float(out[0].amax())
    return out
ro.entries = reads_host
try:
    h = s.decode(feats)
except RuntimeError as e:
    print("raised:", str(e).splitlines()[0][:200])
    print("cached:", len(s._runner.cache))
    sys.exit(0)
print("decoded without raising:", h.words)
sys.exit(1)
"""


def test_graph_capture_with_a_host_read_raises(cuda, tmp_path):
    """A host read inside a block fails its capture, and the decode
    raises: no eager fallback, nothing cached.  In a process of its own,
    so that the failed capture leaves this one's card state alone."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _FAILED_CAPTURE], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "raised:" in r.stdout and "cached: 0" in r.stdout


# ---- the grammar, phone-loop and alignment frame loops as CUDA graphs ------

def _grammar_search(cuda, fx, kind, **kw):
    """An FsgSearch on the card over the fixture's grammar (`kind`: jsgf or
    fsg), scoring with K1."""
    import io
    from cmusphinx_tpu_torch.decode.fsg_search import FsgSearch
    from cmusphinx_tpu_torch.models.fsg import FsgModel
    from cmusphinx_tpu_torch.models.jsgf import JsgfGrammar
    if kind == "jsgf":
        g = JsgfGrammar.parse(fixture.grammar_jsgf(fx)).build_fsg()
    else:
        buf = io.StringIO()
        fixture.grammar_fsg(fx).write(buf)
        g = FsgModel.read_fp(io.StringIO(buf.getvalue()))
    return FsgSearch(g, fx.dict, fx.mdef, fx.tmat,
                     ContinuousScorer(fx.gauden, fx.ln_mixw, device=cuda),
                     device=cuda, **kw)


def _both(s, fn):
    """fn() with the search's frame loop graphed, then eager
    (`_runner.graphs = False`)."""
    out = []
    for graphs in (True, False):
        s._runner.graphs = graphs
        try:
            out.append(fn())
        finally:
            s._runner.graphs = True
        torch.cuda.synchronize()
    return out


def _fsg_decode(s, feats):
    h = s.decode(feats)
    return _segs(h), [np.copy(a) for a in s._last[:4]]


def _fsg_stream(s, feats, push=37):
    st = s.stream_start()
    partials = []
    for i in range(0, len(feats), push):
        s.stream_push(st, feats[i: i + push])
        partials.append(_segs(s.stream_partial(st)))
    final = _segs(s.stream_end(st))
    return partials, final, [np.copy(a) for a in s._last[:4]]


def _segs(h):
    return (h.words, h.score, [(x.word, x.start_frame, x.end_frame)
                               for x in h.segments])


def _equal_arrays(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("kind,prune", [("jsgf", False), ("jsgf", True),
                                        ("fsg", False), ("fsg", True)])
def test_graphed_grammar_bit_equal_to_eager(cuda, kind, prune):
    """Each utterance's batch decode and its stream (37-frame pushes, a
    partial after each) through captured graphs against the eager blocks:
    exit tapes bit-equal, hypotheses, scores and partials equal.  The
    batch (100-frame bucket) and the stream (50-frame chunks) share one
    graph: the block length is all its key holds."""
    fx = fixture.build(0, size=fixture.SMALL)
    s = _grammar_search(cuda, fx, kind, prune=prune)
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    for c, words in zip(fx.ceps, fx.transcripts):
        feats = fp.compute(c)
        (gh, gx), (eh, ex) = _both(s, lambda: _fsg_decode(s, feats))
        assert gh == eh and gh[0] == words and _equal_arrays(gx, ex)
        (gp, gf, gt), (ep, ef, et) = _both(s, lambda: _fsg_stream(s, feats))
        assert gp == ep and gf == ef and _equal_arrays(gt, et)
    assert s.graph_stats["captures"] == len(s._runner.cache) == 1
    assert s.graph_stats["replays"] > 0


def test_graphed_grammar_lengths_share_one_graph(cuda):
    """Nine utterance lengths (one in each 100-frame bucket) decoded one at
    a time replay one graph; each decode bit-equal to the eager blocks."""
    fx = fixture.build(0, size=fixture.SMALL)
    s = _grammar_search(cuda, fx, "jsgf", prune=True)
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    pool = np.concatenate(fx.ceps * (-(-900 // sum(map(len, fx.ceps))) + 1))
    for b in range(9):
        feats = fp.compute(pool[7 * b: 100 * b + 50 + 7 * b])
        (gh, gx), (eh, ex) = _both(s, lambda: _fsg_decode(s, feats))
        assert gh == eh and _equal_arrays(gx, ex)
        assert gx[0].shape[0] == len(feats)
    assert s.graph_stats["captures"] == len(s._runner.cache) == 1


def test_graphed_grammar_streams_interleaved(cuda):
    """Two grammar streams in flight on one search, pushed in turn, each
    equal (exit tapes bit-equal, final hypotheses) to its run alone."""
    fx = fixture.build(0, size=fixture.SMALL)
    s = _grammar_search(cuda, fx, "fsg")
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    feats = [fp.compute(fx.ceps[i]) for i in (0, 2)]
    alone = [_fsg_stream(s, f) for f in feats]
    sts = [s.stream_start() for _ in feats]
    for i in range(0, max(len(f) for f in feats), 37):
        for st, f in zip(sts, feats):
            s.stream_push(st, f[i: i + 37])
    for st, (_, final, tape) in zip(sts, alone):
        assert _segs(s.stream_end(st)) == final
        assert _equal_arrays([np.copy(a) for a in s._last[:4]], tape)


def test_graphed_phone_loop_and_alignment_bit_equal_to_eager(cuda):
    """The phone loop's rows and each alignment (states, segments, score)
    through captured graphs against the eager blocks, bit-equal; the
    phone loop takes one graph, the aligner one a state bucket."""
    from cmusphinx_tpu_torch.decode.align import AlignSearch
    from cmusphinx_tpu_torch.decode.phone_loop import PhoneLoopSearch
    fx = fixture.build(0, size=fixture.SMALL)
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    sc = ContinuousScorer(fx.gauden, fx.ln_mixw, device=cuda)
    loop = PhoneLoopSearch(fx.mdef, fx.tmat, sc, device=cuda)
    al = AlignSearch(fx.dict, fx.mdef, fx.tmat, sc, device=cuda)
    buckets = set()
    for c, words in zip(fx.ceps, fx.transcripts):
        feats = fp.compute(c)
        g, e = _both(loop, lambda: loop._run(feats))
        assert _equal_arrays(g, e) and g[0].shape == (len(feats),)
        for w in (words, words + words):
            g, e = _both(al, lambda: al.align(feats, w))
            assert g[2] == e[2] and g[3] == e[3]
            assert [(p.phone, p.start_frame, p.end_frame) for p in g[1]] \
                == [(p.phone, p.start_frame, p.end_frame) for p in e[1]]
            buckets.add(-(-len(al._build(w)[0]) // al.STATE_BUCKET))
    assert loop.graph_stats["captures"] == 1
    assert al.graph_stats["captures"] == len(buckets)


def test_graphed_alignment_buckets_share_graphs(cuda, tmp_path):
    """A corpus of transcripts of several lengths through one Decoder's
    `align`: one graph a state bucket (the Decoder keeps its aligner), each
    alignment bit-equal to the eager blocks'."""
    from cmusphinx_tpu_torch.api import Decoder
    fx = fixture.build(0, size=fixture.SMALL)
    d = Decoder(device=cuda, **fixture.write_model_dir(fx, str(tmp_path)))
    t = fx.transcripts
    corpus = [t[0], t[1], t[0] + t[1], t[1] + t[2], t[0] + t[1] + t[2],
              t[2] + t[2] + t[1], t[2] * 4, t[0] * 5]
    feats = d.fp.compute(np.concatenate(fx.ceps * 2))
    buckets = set()
    for words in corpus:
        d.align(feats, words)
        al = d._aligner
        g, e = _both(al, lambda: d.align(feats, words))
        assert d._aligner is al
        assert g[2] == e[2] and g[3] == e[3]
        S = len(al._build(words)[0])
        buckets.add(-(-S // al.STATE_BUCKET))
    assert len({len(al._build(w)[0]) for w in corpus}) > len(buckets) > 1
    assert al.graph_stats["captures"] == len(buckets)


def test_graphed_searches_replay_without_host_sync(cuda):
    """Once captured, a grammar batch (`FsgSearch._scan` over the
    100-frame bucket) and stream chunk, a phone-loop pass and an alignment
    (their `_scan`s) replay under torch.cuda.set_sync_debug_mode("error"),
    their device outputs equal to the first run's."""
    from cmusphinx_tpu_torch.decode.align import AlignSearch
    from cmusphinx_tpu_torch.decode.phone_loop import PhoneLoopSearch
    fx = fixture.build(0, size=fixture.SMALL)
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    feats = torch.as_tensor(fp.compute(fx.ceps[1]), device=cuda)
    fsg = _grammar_search(cuda, fx, "jsgf", prune=True)
    loop = PhoneLoopSearch(fx.mdef, fx.tmat, fsg.scorer, device=cuda)
    al = AlignSearch(fx.dict, fx.mdef, fx.tmat, fsg.scorer, device=cuda)
    T = feats.shape[0]
    with torch.inference_mode():
        sc = fsg.scorer.score(feats)
        padded = torch.cat([sc, sc.new_zeros((200 - T, sc.shape[1]))])
        b = al._build(fx.transcripts[1])
        hmm = al._pad_states(b[0], b[1], b[4], b[5])
        runs = {
            "fsg_batch": (fsg, lambda: fsg._scan(fsg._init_carry(), padded,
                                                 0, T)),
            "fsg_chunk": (fsg, lambda: fsg._scan(fsg._init_carry(),
                                                 sc[:50], 100, 50)),
            "phone_loop": (loop, lambda: loop._scan(sc)),
            "align": (al, lambda: al._scan(sc, *hmm)),
        }
        def flat(out):
            return [y for x in out
                    for y in (x if isinstance(x, tuple) else (x,))]
        for name, (s, run) in runs.items():
            want = [x.clone() for x in flat(run())]
            torch.cuda.synchronize()
            n_cap = s.graph_stats["captures"]
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = flat(run())
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            assert s.graph_stats["captures"] == n_cap >= 1, name
            assert all(torch.equal(x, y) for x, y in zip(got, want)), name


_FAILED_SEARCH_CAPTURE = """
import sys, torch
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.decode.align import AlignSearch
from cmusphinx_tpu_torch.decode.fsg_search import FsgSearch
from cmusphinx_tpu_torch.decode.phone_loop import PhoneLoopSearch
from cmusphinx_tpu_torch.frontend import FeatPipeline
from cmusphinx_tpu_torch.models.jsgf import JsgfGrammar
from cmusphinx_tpu_torch.ops import ContinuousScorer
fx = fixture.build(0, size=fixture.SMALL)
feats = FeatPipeline(fx.feat_config(), device="cpu").compute(fx.ceps[0])
host = ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu")

class HostScores(torch.nn.Module):
    # The CPU scorer's scores moved to the card (no kernel build).
    def score(self, x):
        return host.score(x.cpu()).to(x.device)

searches = {
    "fsg": FsgSearch(JsgfGrammar.parse(fixture.grammar_jsgf(fx)).build_fsg(),
                     fx.dict, fx.mdef, fx.tmat, HostScores(), device="cuda"),
    "phone_loop": PhoneLoopSearch(fx.mdef, fx.tmat, HostScores(),
                                  device="cuda"),
    "align": AlignSearch(fx.dict, fx.mdef, fx.tmat, HostScores(),
                         device="cuda"),
}
calls = {"fsg": lambda s: s.decode(feats),
         "phone_loop": lambda s: s.phone_scores(feats),
         "align": lambda s: s.align(feats, fx.transcripts[0])}
s = searches[sys.argv[1]]
block = s._block
def reads_host(carry, *a):
    out = block(carry, *a)
    float(out[0].amax())
    return out
s._block = reads_host
try:
    calls[sys.argv[1]](s)
except RuntimeError as e:
    print("raised:", str(e).splitlines()[0][:200])
    print("cached:", len(s._runner.cache))
    sys.exit(0)
print("ran without raising")
sys.exit(1)
"""


@pytest.mark.parametrize("name", ["fsg", "phone_loop", "align"])
def test_graphed_search_capture_with_a_host_read_raises(cuda, name):
    """A host read planted in a grammar, phone-loop or alignment block
    fails its capture, and the call raises: no eager fallback, nothing
    cached.  In a process of its own, as the N-gram search's test."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _FAILED_SEARCH_CAPTURE, name],
                       cwd=root, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "raised:" in r.stdout and "cached: 0" in r.stdout


# ---- the cross-word entry readout's kernel (ops/lm_entries.py) -------------

def _lm_case_on_card(cuda, case):
    """A case of tests/test_torch_lm_entries.py on the card: the LM without
    a dense table, the readout's tables with the successor lists built
    there, and the exits."""
    from cmusphinx_tpu_torch.models.ngram_device import DeviceNgram
    from cmusphinx_tpu_torch.ops import lm_entries
    medium = fixture.build(0, size=fixture.MEDIUM) if case == "medium" \
        else None
    lm, _, _, _, tab, ex = lm_case_inputs(case, medium)
    dlm = DeviceNgram(lm, device=cuda, dense3_limit=0)
    words = [getattr(tab, k).to(cuda) for k in ("lmwid_c", "firstci",
                                                "is_filler", "fil_pen",
                                                "rssid")]
    succ = lm_entries.successors(dlm, words[0])
    assert all(torch.equal(a.cpu(), b) for a, b in zip(succ, tab.succ))
    return dlm, tab._replace(**dict(zip(
        ("lmwid_c", "firstci", "is_filler", "fil_pen", "rssid"), words)),
        succ=succ), tuple(x.to(cuda) for x in ex)


def _kernel_against_plain(dlm, tab, ex):
    """The kernel and the plain version on the same exits, with and
    without the payloads: bit-equal, one launch each."""
    from cmusphinx_tpu_torch.ops import lm_entries
    for args in (ex[:6], ex):
        lm_entries.launches.clear()
        got = lm_entries.entries(dlm, tab, *args)
        torch.cuda.synchronize()
        assert dict(lm_entries.launches) == {"entries": 1}
        want = lm_entries.entries_ref(dlm, tab, *args)
        assert _same_bits(got, want)
    return got


@pytest.mark.parametrize("case", LM_CASES)
def test_lm_entries_kernel_bit_equal_to_plain(cuda, case):
    """The kernel against `entries_ref` on the card, bit for bit, on the
    CPU tests' planted cases (<s> and -1 histories, fillers, variants
    through `rssid`, dead lanes and rows, ties across the exits, shared
    and clamped LM ids, the MEDIUM fixture's LM; 40 exits, more than a
    block stages at once); the successor lists built on the card equal
    the CPU's."""
    _kernel_against_plain(*_lm_case_on_card(cuda, case))


def _cell_lm(rng, V=64001, start=0):
    """A trigram LM at the PTM cell's size: word `start` (<s>) precedes
    every one of the other 64,000 words, each other word 0-7 words, each
    bigram 0-3 trigram successors; scores drawn from the seed.  Built
    without a loop over the entries."""
    from cmusphinx_tpu_torch.models.ngram import NgramModel

    def lists(n_rows, most, forbid=None):
        cnt = rng.randint(0, most + 1, n_rows)
        if forbid is not None:
            cnt[forbid] = 0
        row = np.repeat(np.arange(n_rows), cnt)
        # Distinct within a row: a random start, then steps that sum to
        # less than V.
        steps = rng.randint(1, V // (most + 1), len(row))
        cs = np.concatenate([[0], np.cumsum(steps)])
        first = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        within = cs[1:] - np.repeat(cs[first], cnt)
        wid = (np.repeat(rng.randint(0, V, n_rows), cnt) + within) % V
        o = np.lexsort((wid, row))
        return np.concatenate([[0], np.cumsum(cnt)]), wid[o]

    m = NgramModel()
    m.n = 3
    m.words = [f"w{i}" for i in range(V)]
    m.words[start] = "<s>"
    m.wid = {w: i for i, w in enumerate(m.words)}
    m.ug_prob = rng.uniform(-14, -3, V).astype(np.float32)
    m.ug_bo = rng.uniform(-3, 0, V).astype(np.float32)
    ptr, wid = lists(V, 7, forbid=start)
    # <s>'s own list: every other word.
    cnt = np.diff(ptr)
    cnt[start] = V - 1
    m.bg_ptr = np.concatenate([[0], np.cumsum(cnt)])
    m.bg_wid = np.concatenate([wid[: ptr[start]],
                               np.delete(np.arange(V), start),
                               wid[ptr[start]:]]).astype(np.int32)
    NB = len(m.bg_wid)
    m.bg_prob = rng.uniform(-10, -1, NB).astype(np.float32)
    m.bg_bo = rng.uniform(-2, 0, NB).astype(np.float32)
    m.tg_ptr, m.tg_wid = lists(NB, 3)
    m.tg_wid = m.tg_wid.astype(np.int32)
    m.tg_prob = rng.uniform(-8, -0.5, len(m.tg_wid)).astype(np.float32)
    return m


def test_lm_entries_kernel_at_the_ptm_cell_shape(cuda):
    """The kernel at the PTM cell's shape (B=16, E=32, W=64,002: 64,000
    words in another order than the LM's and two fillers; composite exits,
    Vr=1) over a synthetic LM with one successor list of 64,000 (<s>'s) and
    lists of 0-7 elsewhere, a quarter of the exits <s> histories and half
    trigram contexts: bit-equal to the plain version, with and without the
    payloads."""
    from cmusphinx_tpu_torch.models.ngram_device import DeviceNgram
    from cmusphinx_tpu_torch.ops import lm_entries
    rng = np.random.RandomState(21)
    lm = _cell_lm(rng)
    V, B, E, n_ci = lm.n_words, 16, 32, 40
    assert int(np.diff(lm.bg_ptr).max()) == 64000
    lmwid = np.concatenate([rng.permutation(np.arange(1, V)), [-1, -1]])
    W = len(lmwid)
    assert W == 64002
    dlm = DeviceNgram(lm, device=cuda, dense3_limit=0)

    def dev(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a)).to(dtype).to(cuda)

    lmwid_c = dev(np.maximum(lmwid, 0))
    tab = lm_entries.Tables(
        lmwid_c, dev(rng.randint(0, n_ci, W)), dev(lmwid < 0, torch.bool),
        dev(rng.uniform(-12, -6, W), torch.float32),
        dev(np.zeros((W, n_ci))), lm_entries.successors(dlm, lmwid_c),
        float(np.float32(6.5)), float(np.float32(np.log(0.65))))
    h2 = rng.randint(0, V, (B, E))
    h1 = rng.randint(-1, V, (B, E))
    tg_b = np.repeat(np.arange(len(lm.bg_wid)), np.diff(lm.tg_ptr))
    bg_w1 = np.repeat(np.arange(V), np.diff(lm.bg_ptr))
    pick = rng.choice(tg_b, (B, E // 2))
    h1[:, ::2], h2[:, ::2] = bg_w1[pick], lm.bg_wid[pick]
    h2[:, 1::4] = 0
    ok = rng.rand(B, E) < 0.9
    slot_rc = rng.uniform(-3000, -2900, (B, E, 1)).astype(np.float32)
    ex = (torch.tensor(150, device=cuda), dev(ok, torch.bool),
          dev(rng.randint(0, W, (B, E))), dev(h1), dev(h2),
          dev(slot_rc, torch.float32), dev(rng.randint(0, n_ci, W)))
    ent_w, ent_pay = _kernel_against_plain(dlm, tab, ex)
    assert (ent_w > -1e29).all()
    starts = ent_pay[..., 2] == 0
    assert starts.any() and not starts.all()


def _force_score_rows(monkeypatch):
    """Searches built after this use the LM's score_rows backend however
    small the LM (no dense table)."""
    from cmusphinx_tpu_torch.models.ngram_device import DeviceNgram
    monkeypatch.setattr(ngram_search, "DeviceNgram",
                        lambda lm, device: DeviceNgram(lm, device=device,
                                                       dense3_limit=0))


def _decodes_and_launches(card, cpu, feats):
    """The same features through the card's search graphed (capturing,
    then replaying) and eager and through the CPU's: hypotheses equal,
    tapes bit-equal; `lm_entries.launches` one a padded frame step in each
    card decode."""
    from cmusphinx_tpu_torch.ops import lm_entries
    hyps, tapes = [], []
    for s, graphs in ((card, True), (card, True), (card, False),
                      (cpu, False)):
        s._runner.graphs = graphs
        lm_entries.launches.clear()
        hyps.append(s.decode_batch(feats))
        if s is card:
            torch.cuda.synchronize()
            frames = s._last_batch[0][0].shape[1] // s.E
            assert dict(lm_entries.launches) == {"entries": frames}
        tapes.append([t.cpu() for t in s._last_batch[0]])
    card._runner.graphs = True
    for h, t in zip(hyps[1:], tapes[1:]):
        _assert_same_hyps(hyps[0], h)
        assert _same_bits(tapes[0], t)
    return hyps[0]


@pytest.mark.parametrize("case", ["ptm_small", "medium_composite",
                                  "medium_fanout", "static5k"])
def test_lm_entries_decodes_equal_graphed_eager_and_cpu(cuda, case,
                                                        monkeypatch,
                                                        tmp_path):
    """Decodes whose readout takes the kernel (the score_rows backend):
    the PTM SMALL fixture's mpx step (fanout exits; its LM forced off the
    dense table) and the MEDIUM fixture's mpx steps (composite, fanout)
    on the CPU scorer's scores, and the 5k flat static step (semi) on the
    CPU's PsParityScorer's: graphed, eager and CPU tapes bit-equal, the
    kernel once a padded step; a stream's tapes (37-frame pushes) equal
    the CPU stream's, the kernel once a padded frame of its chunks.  A
    MEDIUM tree decode launches none."""
    from cmusphinx_tpu_torch.api import Decoder
    from cmusphinx_tpu_torch.decode.ngram_steps import MpxStep
    from cmusphinx_tpu_torch.ops import lm_entries
    kw, n_utt = {}, None
    if case == "ptm_small":
        fx = fixture.build(0, model="ptm8", size=fixture.SMALL)
        host_dec = Decoder(device="cpu", **fixture.write_model_dir(
            fx, str(tmp_path)))
        host, fp = host_dec.scorer, host_dec.fp
        kw = {"rcmode": "fanout", "lcmode": "mpx"}
        _force_score_rows(monkeypatch)
    elif case == "static5k":
        fx = fixture.build(0, model="semi", size=fixture.LARGE_5K)
        raw, meta = fixture.sendump_bytes(fx)
        host = PsParityScorer(fx.gauden, raw, fx.stream_slices(), topn=4,
                              wrap_uint8=meta["n_bits"] == 4, device="cpu")
        fp = FeatPipeline(fx.feat_config(), device="cpu")
        n_utt = 3
    else:
        fx = fixture.build(0, size=fixture.MEDIUM)
        host = ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu")
        fp = FeatPipeline(fx.feat_config(), device="cpu")
        kw = {"rcmode": case.split("_")[1], "lcmode": "mpx"}
    card = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, _HostScores(host),
                       device=cuda, **kw)
    cpu = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, host, device="cpu",
                      **kw)
    assert card.dlm.tg_dense is None and card.step.ro.lm_tab.succ is not None
    assert isinstance(card.step, StaticStep if case == "static5k"
                      else MpxStep)
    feats = [fp.compute(c) for c in fx.ceps[:n_utt]]
    hyps = _decodes_and_launches(card, cpu, feats)
    assert all(h.segments for h in hyps)
    lm_entries.launches.clear()
    (gh, gt, _), (ch, ct, _) = (_stream(s, feats[1]) for s in (card, cpu))
    _assert_same_hyps([gh], [ch])
    assert _same_bits([t.cpu() for t in gt], ct)
    chunks = -(-len(feats[1]) // card.CHUNK)
    assert dict(lm_entries.launches) == {"entries": chunks * card.CHUNK}
    if case == "medium_composite":
        tree = _card_search(cuda, fx, lexmode="tree")
        lm_entries.launches.clear()
        tree.decode_batch_cep(fx.ceps[:4], FeatPipeline(fx.feat_config(),
                                                        device=cuda))
        torch.cuda.synchronize()
        assert not lm_entries.launches
