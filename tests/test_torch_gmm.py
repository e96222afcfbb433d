"""Port parity: the continuous GMM scorer and K1's plain version
(cmusphinx_tpu_torch.ops.fused_gmm / .gmm) against cmusphinx_tpu.

The bounds scale with the magnitude of the terms that cancel.  With
M[t,s] = max_k(|const| + sum_d |x_d lin_d| + sum_d x_d^2 quad_d):

- two evaluations that round their operands identically (the plain
  version against the Pallas kernel in one mode) differ only in the order
  of their f32 sums: within D * 2^-22 * M;
- "highest" against a float64 evaluation: within D * 2^-22 * M;
- "high" (bf16 hi+lo, 3 products) against float64: within 2^-14 * M;
- "bf16" against float64: within 2^-6 * M.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmusphinx_tpu.models.gauden import GaussianParams
from cmusphinx_tpu.models.ngram_device import DeviceNgram as JaxNgram
from cmusphinx_tpu.ops.gmm import ContinuousScorer as JaxScorer
from cmusphinx_tpu.ops.gmm import density_logliks as jax_density_logliks
from cmusphinx_tpu.ops.pallas_gmm import fused_mixture_scores as pallas_scores
from cmusphinx_tpu_torch import convert, fixture
from cmusphinx_tpu_torch.models.ngram_device import DeviceNgram
from cmusphinx_tpu_torch.ops.fused_gmm import (fused_mixture_scores,
                                               fused_mixture_scores_ref)
from cmusphinx_tpu_torch.ops.gmm import ContinuousScorer, density_logliks

MODES = ["highest", "high", "bf16"]
MODE_BOUND = {"highest": None, "high": 2.0 ** -14, "bf16": 2.0 ** -6}


def _gauden(rng, S, K, D, floored=False):
    if floored:
        # Trained-model-like: realistic cepstral means, variances spread
        # over decades and floored at 1e-4 (prec up to 5e3).
        means = (rng.randn(S, 1, K, D) * np.r_[np.full(13, 3.0),
                                               np.full(D - 13, 0.3)]
                 ).astype(np.float32)
        var = np.exp(rng.randn(S, 1, K, D) * 2.0 - 1.5)
        var[rng.rand(S, 1, K, D) < 0.05] = 1e-6
        var = np.maximum(var, 1e-4).astype(np.float32)
    else:
        means = rng.randn(S, 1, K, D).astype(np.float32)
        var = (0.3 + rng.rand(S, 1, K, D)).astype(np.float32)
    prec = (1.0 / (2.0 * var)).astype(np.float32)
    lrd = (-0.5 * (np.log(var).sum(-1) + D * np.log(2 * np.pi))
           ).astype(np.float32)
    g = GaussianParams(means=means, var=var, prec=prec, lrd=lrd, veclen=[D],
                       n_mgau=S, n_feat=1, n_density=K)
    lnw = np.log(rng.dirichlet(np.ones(K), size=S)).astype(np.float32)
    x = (means[rng.randint(S, size=40), 0, 0]
         + rng.randn(40, D) * 0.5).astype(np.float32)
    return g, lnw, x


def _params(g, lnw):
    """f32 lin/quad [S, K, D] and const [S, K] as the port builds them."""
    sc = ContinuousScorer(g, lnw, device="cpu")
    return sc.lin.numpy(), sc.quad.numpy(), sc.const.numpy()


def _magnitude(x, lin, quad, const):
    x = x.astype(np.float64)
    S, K, D = lin.shape
    m = (np.abs(const.reshape(1, S * K)).astype(np.float64)
         + np.abs(x) @ np.abs(lin.reshape(S * K, D).T.astype(np.float64))
         + (x * x) @ quad.reshape(S * K, D).T.astype(np.float64))
    return m.reshape(-1, S, K).max(-1)


def _exact(x, lin, quad, const):
    x = x.astype(np.float64)
    S, K, D = lin.shape
    ll = (const.reshape(1, S * K).astype(np.float64)
          + x @ lin.reshape(S * K, D).T.astype(np.float64)
          - (x * x) @ quad.reshape(S * K, D).T.astype(np.float64))
    ll = ll.reshape(-1, S, K)
    m = ll.max(-1, keepdims=True)
    return (m + np.log(np.exp(ll - m).sum(-1, keepdims=True)))[..., 0]


def _within(got, want, bound):
    err = np.abs(got.astype(np.float64) - want)
    assert np.all(err <= bound), (
        f"max err {err.max():.3g}, worst err/bound {(err / bound).max():.3g}")


def _run_ref(x, lin, quad, const, mode):
    ptype = torch.bfloat16 if mode == "bf16" else torch.float32
    return fused_mixture_scores_ref(
        torch.as_tensor(x), torch.as_tensor(lin).to(ptype),
        torch.as_tensor(quad).to(ptype), torch.as_tensor(const), mode).numpy()


@pytest.mark.parametrize("mode", MODES)
def test_plain_k1_matches_pallas_interpret_unaligned(mode):
    rng = np.random.RandomState(0)
    S, K, D, T = 37, 8, 13, 50          # tile-unaligned
    g, lnw, _ = _gauden(rng, S, K, D)
    x = rng.randn(T, D).astype(np.float32)
    lin, quad, const = _params(g, lnw)
    jsc = JaxScorer(g, lnw, use_pallas=False)
    want = np.asarray(pallas_scores(
        jnp.asarray(x), jsc.lin, jsc.quad, jsc.const, n_sen=S, n_density=K,
        block_t=16, block_s=16, interpret=True, precision=mode))
    got = _run_ref(x, lin, quad, const, mode)
    M = _magnitude(x, lin, quad, const)
    _within(got, want, D * 2.0 ** -22 * M)
    bound = MODE_BOUND[mode]
    _within(got, _exact(x, lin, quad, const),
            (bound if bound else D * 2.0 ** -22) * M)


@pytest.mark.parametrize("floored", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_scorer_matches_reference_scorer(mode, floored):
    rng = np.random.RandomState(1 + floored)
    S, K, D = 24, 4, 39
    g, lnw, x = _gauden(rng, S, K, D, floored)
    jsc = JaxScorer(g, lnw, use_pallas=False, precision=mode)
    tsc = ContinuousScorer(g, lnw, precision=mode, device="cpu")
    want = np.asarray(jsc.score(jnp.asarray(x)))
    got = tsc.score(torch.as_tensor(x)).numpy()
    assert got.shape == (len(x), S) and np.isfinite(got).all()
    lin, quad, const = _params(g, lnw)
    M = _magnitude(x, lin, quad, const)
    # The reference's "high" on the CPU is plain f32 (XLA's CPU backend
    # ignores the precision request), so the port's bf16x3 sits within
    # the mode's own bound of it.
    bound = D * 2.0 ** -22 + (MODE_BOUND[mode] if mode == "high" else 0.0)
    _within(got, want, bound * M)
    if mode != "bf16":
        _within(got, _exact(x, lin, quad, const),
                (MODE_BOUND[mode] or D * 2.0 ** -22) * M)


def test_batched_score_and_wrapper_on_cpu():
    rng = np.random.RandomState(3)
    g, lnw, x = _gauden(rng, 16, 4, 13)
    sc = ContinuousScorer(g, lnw, device="cpu")
    xb = torch.as_tensor(np.stack([x, x[::-1].copy()]))
    out = sc.score(xb)
    assert out.shape == (2, len(x), 16)
    np.testing.assert_array_equal(out[1].numpy(),
                                  sc.score(xb[1]).numpy())
    before = fused_mixture_scores.launches
    empty = fused_mixture_scores(torch.zeros((0, 13)), sc.lin, sc.quad,
                                 sc.const)
    assert tuple(empty.shape) == (0, 16)
    assert fused_mixture_scores.launches == before   # CPU: no kernel
    with pytest.raises(TypeError):
        fused_mixture_scores(xb[0].double(), sc.lin, sc.quad, sc.const)
    with pytest.raises(TypeError):
        fused_mixture_scores(xb[0], sc.lin, sc.quad, sc.const, "bf16")
    with pytest.raises(ValueError):
        fused_mixture_scores(xb[0][:, :5], sc.lin, sc.quad, sc.const)
    with pytest.raises(ValueError):
        ContinuousScorer(g, lnw, precision="fp8", device="cpu")


def test_density_logliks_matches_reference():
    rng = np.random.RandomState(4)
    means = rng.randn(8, 13).astype(np.float32)
    prec = (0.5 / (0.3 + rng.rand(8, 13))).astype(np.float32)
    lrd = rng.randn(8).astype(np.float32)
    x = rng.randn(20, 13).astype(np.float32)
    want = np.asarray(jax_density_logliks(*map(jnp.asarray,
                                               (x, means, prec, lrd))))
    got = density_logliks(*map(torch.as_tensor, (x, means, prec, lrd)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode", MODES)
def test_convert_continuous_round_trip(mode):
    rng = np.random.RandomState(5)
    g, lnw, x = _gauden(rng, 12, 4, 39)
    jsc = JaxScorer(g, lnw, use_pallas=False, precision=mode)
    direct = ContinuousScorer(g, lnw, precision=mode, device="cpu")
    lin, quad, const = convert.continuous_from_jax(
        np.asarray(jsc.lin), np.asarray(jsc.quad), np.asarray(jsc.const),
        jsc.n_sen, jsc.n_density)
    assert lin.shape == (12, 4, 39) and const.shape == (12, 4)
    carried = ContinuousScorer.from_params(lin, quad, const, precision=mode,
                                           device="cpu")
    for name in ("lin", "quad", "const"):
        a, b = getattr(direct, name), getattr(carried, name)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), name
    np.testing.assert_array_equal(carried.score(torch.as_tensor(x)).numpy(),
                                  direct.score(torch.as_tensor(x)).numpy())


def test_convert_ngram_round_trip():
    fx = fixture.build(0, size=fixture.SMALL)
    jd = JaxNgram(fx.lm)
    carried = convert.ngram_from_jax(np.asarray(jd.tg_dense), device="cpu")
    direct = DeviceNgram(fx.lm, device="cpu")
    assert carried.V == direct.V == fx.lm.n_words
    assert torch.equal(carried.tg_dense, direct.tg_dense)


# ---- top-N continuous scoring, PTM and CD/CI interpolation -----------
# Same bounds as above: the plain f32 path against the reference within
# D * 2^-22 * M.  Masking keeps every density >= the N-th largest, and the
# log-sum-exp adds at most ~1e-6 relative.

@pytest.mark.parametrize("topn", [1, 2, 3])
@pytest.mark.parametrize("mode", ["highest", "high"])
def test_continuous_topn_matches_reference(mode, topn):
    rng = np.random.RandomState(60 + topn)
    S, K, D = 20, 4, 39
    g, lnw, x = _gauden(rng, S, K, D)
    # Planted tie: senone 0's first two Gaussians are identical.
    for a in (g.means, g.var, g.prec):
        a[0, 0, 1] = a[0, 0, 0]
    g.lrd[0, 0, 1] = g.lrd[0, 0, 0]
    want = np.asarray(JaxScorer(g, lnw, topn=topn, use_pallas=False,
                                precision=mode).score(jnp.asarray(x)))
    sc = ContinuousScorer(g, lnw, topn=topn, precision=mode, device="cpu")
    got = sc.score(torch.as_tensor(x)).numpy()
    lin, quad, const = _params(g, lnw)
    M = _magnitude(x, lin, quad, const)
    bound = D * 2.0 ** -22 + (MODE_BOUND[mode] if mode == "high" else 0.0)
    _within(got, want, bound * M + 1e-6 * np.abs(want))
    before = fused_mixture_scores.launches
    full = ContinuousScorer(g, lnw, precision=mode, device="cpu")
    assert np.all(got <= full.score(torch.as_tensor(x)).numpy() + 1e-5)
    assert fused_mixture_scores.launches == before


def _ptm_case(rng, C=5, K=4, S=23, D=13, T=30):
    means = rng.randn(C, 1, K, D).astype(np.float32)
    var = (0.3 + rng.rand(C, 1, K, D)).astype(np.float32)
    g = GaussianParams(means=means, var=var,
                       prec=(1.0 / (2.0 * var)).astype(np.float32),
                       lrd=(-0.5 * (np.log(var).sum(-1) + D * np.log(2 * np.pi))
                            ).astype(np.float32),
                       veclen=[D], n_mgau=C, n_feat=1, n_density=K)
    lnw = np.log(rng.dirichlet(np.ones(K), size=S)).astype(np.float32)
    sen2cb = rng.randint(C, size=S).astype(np.int32)
    x = (means[rng.randint(C, size=T), 0, 0] + rng.randn(T, D) * 0.5
         ).astype(np.float32)
    return g, lnw, sen2cb, x


@pytest.mark.parametrize("topn", [0, 2])
def test_ptm_matches_reference(topn):
    from cmusphinx_tpu.ops.gmm import PTMScorer as JaxPTM
    from cmusphinx_tpu_torch.ops.gmm import PTMScorer
    rng = np.random.RandomState(70 + topn)
    g, lnw, sen2cb, x = _ptm_case(rng)
    want = np.asarray(JaxPTM(g, lnw, sen2cb, topn=topn).score(jnp.asarray(x)))
    sc = PTMScorer(g, lnw, sen2cb, topn=topn, device="cpu")
    got = sc.score(torch.as_tensor(x)).numpy()
    assert got.shape == (30, 23)
    C, K, D = sc.lin.shape
    lin = sc.lin.numpy()[sen2cb]                    # per senone [S, K, D]
    quad = sc.quad.numpy()[sen2cb]
    const = sc.const.numpy()[sen2cb] + lnw
    M = _magnitude(x, lin, quad, const)
    _within(got, want, D * 2.0 ** -22 * M + 1e-6 * np.abs(want))
    # The batch is a leading dimension.
    xb = torch.as_tensor(np.stack([x, x[::-1].copy()]))
    np.testing.assert_array_equal(sc.score(xb)[0].numpy(), got)


def test_convert_ptm_round_trip():
    from cmusphinx_tpu.ops.gmm import PTMScorer as JaxPTM
    from cmusphinx_tpu_torch.ops.gmm import PTMScorer
    rng = np.random.RandomState(72)
    g, lnw, sen2cb, x = _ptm_case(rng)
    jsc = JaxPTM(g, lnw, sen2cb)
    kw = convert.ptm_from_jax(np.asarray(jsc.lin), np.asarray(jsc.quad),
                              np.asarray(jsc.const), np.asarray(jsc.lnw),
                              np.asarray(jsc.sen2cb), jsc.n_cb, jsc.n_density)
    carried = PTMScorer.from_params(**kw, device="cpu")
    direct = PTMScorer(g, lnw, sen2cb, device="cpu")
    for name, buf in direct.state_dict().items():
        assert torch.equal(buf, carried.state_dict()[name]), name


@pytest.mark.parametrize("lam", [0.7, "per_senone", 1.0])
def test_interpolated_matches_reference(lam):
    from cmusphinx_tpu.ops.gmm import InterpolatedScorer as JaxInterp
    from cmusphinx_tpu_torch.ops.gmm import InterpolatedScorer
    rng = np.random.RandomState(80)
    S, K, D, n_ci = 24, 4, 13, 6
    g, lnw, x = _gauden(rng, S, K, D)
    cd2ci = np.r_[np.arange(n_ci), rng.randint(n_ci, size=S - n_ci - 1), -1]
    if lam == "per_senone":
        lam = rng.rand(S).astype(np.float32)
    inner_j = JaxScorer(g, lnw, use_pallas=False)
    inner_t = ContinuousScorer(g, lnw, device="cpu")
    want = np.asarray(JaxInterp(inner_j, cd2ci, n_ci, lam).score(
        jnp.asarray(x)))
    sc = InterpolatedScorer(inner_t, cd2ci, n_ci, lam, device="cpu")
    got = sc.score(torch.as_tensor(x)).numpy()
    inner = inner_t.score(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got[:, :n_ci], inner[:, :n_ci])
    lin, quad, const = _params(g, lnw)
    M = _magnitude(x, lin, quad, const)
    bound = D * 2.0 ** -22 * np.maximum(M, M[:, cd2ci]) + 1e-6 * np.abs(want)
    _within(got, want, bound)


# ---- K1's packed operands (fused_gmm.pack_params) ----------------------
# The kernel multiplies A = [x | x^2], split per mode, by the packed
# B = [lin | -quad] on the tensor cores and adds const.  Its host half is
# held here: the packing, the splits, and their arithmetic in float64.
# The split products lose at most (M as above): "highest" (tf32 hi.lo +
# lo.hi + hi.hi) 3 * 2^-22 * M, "high" (the same in bf16) 3 * 2^-18 * M,
# "bf16" (operands rounded to bf16) 2^-8 * M; each is inside its mode's
# bound against float64.  Against the plain version the packed evaluation
# differs by the f32 sums of the plain side (D * 2^-22 * M) and, in
# "highest", also by the split (the sum of the two sides' float64 bounds).
SPLIT_BOUND = {"highest": 3 * 2.0 ** -22, "high": 3 * 2.0 ** -18,
               "bf16": 2.0 ** -8}


def _unchunk(raw, n, dp, nparts, dt):
    """Bytes [blocks, ...] of the depth loop's chunked layout (per block of
    n rows: chunks of 32, each chunk's parts, each [n/8][32/epc] core
    matrices) -> the parts [blocks * n, dp] in float64."""
    from cmusphinx_tpu_torch.ops.fused_gmm import CHUNK_DP
    nb = raw.shape[0]
    epc = 16 // dt.itemsize
    v = raw.contiguous().view(dt).reshape(nb, dp // CHUNK_DP, nparts, n // 8,
                                          CHUNK_DP // epc, 8, epc)
    return [v[:, :, i].permute(0, 2, 4, 1, 3, 5).reshape(nb * n, dp).double()
            for i in range(nparts)]


def _unpack(p):
    """Packed tiles -> the B parts [R, Dp] and const [R], in float64."""
    from cmusphinx_tpu_torch.ops.fused_gmm import NARROW_DP, TILE_N
    n, dp, nt = p.n_tile, p.dp, p.tiles.shape[0]
    assert n == TILE_N[p.precision]
    dt = torch.float32 if p.precision == "highest" else torch.bfloat16
    es = dt.itemsize
    epc, pb = 16 // es, n * dp * es
    nparts = 1 if p.precision == "bf16" else 2
    parts = []
    if dp > NARROW_DP:
        parts = _unchunk(p.tiles, n, dp, nparts, dt)
    for i in range(nparts if dp <= NARROW_DP else 0):
        raw = p.tiles[:, i * pb: (i + 1) * pb].contiguous().view(dt)
        parts.append(raw.reshape(nt, n // 8, dp // epc, 8, epc)
                     .permute(0, 1, 3, 2, 4).reshape(nt * n, dp).double())
    assert p.tiles.shape == (nt, nparts * pb)
    assert p.const.shape == (nt * n,) and p.const.dtype == torch.float32
    return parts, p.const.double()


def _packed_densities(x, p):
    """The kernel's arithmetic from the packed operands, in float64:
    densities [T, S_pad, Kp]."""
    from cmusphinx_tpu_torch.ops.fused_gmm import split_parts
    x = torch.as_tensor(x)
    a = torch.zeros(x.shape[0], p.dp)
    a[:, :p.D], a[:, p.D: 2 * p.D] = x, x * x
    A = [q.double() for q in split_parts(a, p.precision)]
    B, c = _unpack(p)
    if len(B) == 2:
        d = A[0] @ B[1].T + A[1] @ B[0].T + A[0] @ B[0].T
    else:
        d = A[0] @ B[0].T
    return (d + c).view(x.shape[0], -1, p.kp)


def _pack(g, lnw, mode):
    from cmusphinx_tpu_torch.ops.fused_gmm import pack_params
    sc = ContinuousScorer(g, lnw, precision=mode, device="cpu")
    return sc, pack_params(sc.lin, sc.quad, sc.const, mode)


@pytest.mark.parametrize("S,K,D", [(37, 4, 13), (21, 1, 39), (11, 32, 39),
                                   (9, 12, 51), (3, 256, 13), (13, 32, 78),
                                   (5, 8, 150)])
@pytest.mark.parametrize("mode", MODES)
def test_pack_params_pads_and_matches_plain_version(mode, S, K, D):
    from cmusphinx_tpu_torch.ops.fused_gmm import PAD_CONST
    rng = np.random.RandomState(S + K + D)
    g, lnw, x = _gauden(rng, S, K, D)
    sc, p = _pack(g, lnw, mode)
    kp = max(8, 1 << (K - 1).bit_length())
    # Up to D = 64 the depth is 2D rounded to 16; past it, to whole chunks
    # of 32 (the depth loop's).
    dp = -(-2 * D // 16) * 16 if D <= 64 else -(-2 * D // 32) * 32
    assert (p.kp, p.dp, p.S, p.K, p.D) == (kp, dp, S, K, D)
    assert p.tiles.dtype == torch.uint8 and p.tiles.is_contiguous()
    rows = p.tiles.shape[0] * p.n_tile
    assert S * kp <= rows < S * kp + p.n_tile
    B, c = _unpack(p)
    # Pads: densities k >= K and rows past S*Kp have zero operands and the
    # pad const; depth columns past 2D are zero.
    real = torch.zeros(rows, dtype=torch.bool)
    real[: S * kp] = (torch.arange(kp) < K).repeat(S)
    for b in B:
        assert not b[~real].any() and not b[:, 2 * D:].any()
    assert bool((c[~real] == float(np.float32(PAD_CONST))).all())
    assert torch.equal(c[real].float(), sc.const.reshape(-1))
    hi = B[0][real]
    want = torch.cat([sc.lin.double(), -sc.quad.double()], -1).reshape(-1, 2 * D)
    lim = 2.0 ** -11 if mode == "highest" else 2.0 ** -8  # hi: half a unit
    assert bool(((hi[:, :2 * D] - want).abs() <= lim * want.abs()).all())
    # The pads change no score.
    dens = _packed_densities(x, p)
    full = torch.logsumexp(dens, -1)[:, :S]
    assert torch.equal(full, torch.logsumexp(dens[:, :S, :K], -1))
    # The packed arithmetic against the plain version.
    ref = fused_mixture_scores_ref(torch.as_tensor(x), sc.lin, sc.quad,
                                   sc.const, mode).numpy()
    M = _magnitude(x, sc.lin.float().numpy(), sc.quad.float().numpy(),
                   sc.const.numpy())
    same = D * 2.0 ** -22 * (2 if mode == "highest" else 1)
    _within(ref, full.numpy(), same * M)


@pytest.mark.parametrize("mode", ["highest", "high"])
def test_split_parts_reconstruct(mode):
    from cmusphinx_tpu_torch.ops.fused_gmm import split_parts, tf32_round
    rng = np.random.RandomState(9)
    a = torch.as_tensor((rng.randn(20000) * 10.0 ** rng.uniform(-6, 6, 20000)
                         ).astype(np.float32))
    hi, lo = split_parts(a, mode)
    err = (hi.double() + lo.double() - a.double()).abs()
    bound = 2.0 ** -22 if mode == "highest" else 2.0 ** -16
    assert bool((err <= bound * a.double().abs()).all())
    if mode == "highest":
        for part in (hi, lo):          # tf32: the low 13 mantissa bits clear
            assert not (part.view(torch.int32) & 0x1FFF).any()
            assert torch.equal(tf32_round(part), part)
        # Round to nearest: hi is within half a tf32 unit of a.
        assert bool(((hi - a).abs() <= 2.0 ** -11 * a.abs()).all())
    else:
        assert hi.dtype == lo.dtype == torch.bfloat16


@pytest.mark.parametrize("mode", MODES)
def test_split_arithmetic_within_mode_bound_floored(mode):
    rng = np.random.RandomState(11)
    S, K, D = 40, 32, 39
    g, lnw, x = _gauden(rng, S, K, D, floored=True)
    _, p = _pack(g, lnw, mode)
    lin, quad, const = _params(g, lnw)
    got = torch.logsumexp(_packed_densities(x, p), -1)[:, :S].numpy()
    M = _magnitude(x, lin, quad, const)
    assert SPLIT_BOUND[mode] <= (MODE_BOUND[mode] or D * 2.0 ** -22)
    _within(got, _exact(x, lin, quad, const), SPLIT_BOUND[mode] * M)


def test_scorer_packs_for_the_kernel_only_and_follows_its_buffers():
    from cmusphinx_tpu_torch.ops.fused_gmm import pack_params
    rng = np.random.RandomState(12)
    g, lnw, x = _gauden(rng, 9, 4, 13)
    xt = torch.as_tensor(x)
    # CPU tensors, top-N and the plain scorer never reach K1: no packing.
    for kw in ({}, {"topn": 2}, {"kernel": False}):
        sc = ContinuousScorer(g, lnw, device="cpu", **kw)
        sc.score(xt)
        assert sc._packed is None
    sc = ContinuousScorer(g, lnw, device="cpu")
    p = sc.packed()
    assert sc.packed() is p                              # packed once
    fresh = pack_params(sc.lin, sc.quad, sc.const, "highest")
    assert torch.equal(p.tiles, fresh.tiles) and torch.equal(p.const, fresh.const)
    state = {k: v.clone() for k, v in sc.state_dict().items()}
    with torch.no_grad():
        sc.lin.mul_(2.0)                                 # edited in place
    p2 = sc.packed()
    assert p2 is not p and not torch.equal(p2.tiles, p.tiles)
    sc.load_state_dict(state)                            # copied back in place
    p3 = sc.packed()
    assert p3 is not p2 and torch.equal(p3.tiles, p.tiles)
    sc.quad = sc.quad.clone()                            # replaced
    assert sc.packed() is not p3
    sc.to("cpu")                                         # moved: dropped
    assert sc._packed is None


def test_k1_takes_features_up_to_max_d():
    """K1 has no widest depth any more: every D packs, the narrow
    instantiations' depth up to D = 64, the depth loop's chunks past it."""
    from cmusphinx_tpu_torch.ops import fused_gmm
    rng = np.random.RandomState(13)
    assert not hasattr(fused_gmm, "MAX_D")
    for D, dp in ((64, 128), (65, 160), (78, 160), (150, 320), (400, 800)):
        g, lnw, x = _gauden(rng, 5, 4, D)
        sc = ContinuousScorer(g, lnw, device="cpu")
        assert sc.score(torch.as_tensor(x)).shape == (len(x), 5)
        p = sc.packed()
        assert p.dp == dp == fused_gmm.depth(D)
        assert p.tiles.shape[1] == (2 * 64 * dp * 4)      # highest: 2 tf32 parts


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("S,K,D", [(13, 32, 78), (5, 8, 150), (7, 256, 65)])
def test_depth_loop_chunk_is_one_narrow_tile(mode, S, K, D):
    """Past NARROW_DP each chunk of a packed tile is one ring stage: the
    bytes of the narrow layout of that CHUNK_DP-deep slice of B, every part
    in turn, so that one bulk copy brings it in."""
    from cmusphinx_tpu_torch.ops.fused_gmm import (CHUNK_DP, _core_layout,
                                                   split_parts)
    rng = np.random.RandomState(S + K + D)
    g, lnw, _ = _gauden(rng, S, K, D)
    _, p = _pack(g, lnw, mode)
    B, _ = _unpack(p)
    dt = torch.float32 if mode == "highest" else torch.bfloat16
    nch = p.dp // CHUNK_DP
    chunk = p.tiles.shape[1] // nch
    for c in range(nch):
        want = torch.cat([_core_layout(b[:, c * CHUNK_DP: (c + 1) * CHUNK_DP]
                                       .to(dt), p.n_tile) for b in B], 1)
        assert torch.equal(p.tiles[:, c * chunk: (c + 1) * chunk], want)
    # The parts are the mode's split of [lin | -quad]: re-splitting the hi
    # part changes nothing.
    assert torch.equal(split_parts(B[0].float(), mode)[0].double(), B[0])
