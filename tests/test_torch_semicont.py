"""Port parity: the semi-continuous scorers (cmusphinx_tpu_torch.ops.gmm
`PsParityScorer`, `SemiContinuousScorer`, `logadd8_table`) against
cmusphinx_tpu.ops.gmm on the same seeded inputs.

Tolerances:

- `PsParityScorer` stage (b), the epilogue on int32 densities: bit-exact.
  It is held on integer-exact models (integer means and features, so every
  f32 product and partial sum of the density GEMM is an exact integer
  below 2^24 in any order): both packages then truncate identical
  densities, and the whole scorer must match bit for bit.
- Stage (a), the f32 densities in the logmath domain: within
  D * 2^-22 * M, with M = |const| + sum|x lin| + sum x^2 prec (float64);
  after truncation to int32, within floor of that bound plus one unit.
- The whole `PsParityScorer` on real-valued inputs: at most 1 in 1000
  (t, s) may differ, each by at most 2 quanta (2^shift ln(base)) per
  stream.  (Measured on these seeds: none differ.)
- `SemiContinuousScorer`: within sum over streams of D * 2^-22 * M_max
  (the frame's largest density magnitude, which the max-normalisation
  carries into the score) plus 1e-5 |score|, for exp, log and the weight
  GEMM.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmusphinx_tpu.models.gauden import GaussianParams
from cmusphinx_tpu.ops.gmm import PsParityScorer as JaxPs
from cmusphinx_tpu.ops.gmm import SemiContinuousScorer as JaxSemi
from cmusphinx_tpu.ops.gmm import density_logliks as jax_density_logliks
from cmusphinx_tpu.ops.gmm import logadd8_table as jax_logadd8_table
from cmusphinx_tpu_torch import convert
from cmusphinx_tpu_torch.ops.gmm import (PsParityScorer, SemiContinuousScorer,
                                         logadd8_table)

LAYOUTS = {"svspec_3x13": [13, 13, 13], "s2_4x": [12, 24, 3, 12]}


def _slices(lens):
    out, pos = [], 0
    for ln in lens:
        out.append(np.arange(pos, pos + ln, dtype=np.int32))
        pos += ln
    return out


def _model(rng, lens, K, integer=False, ties=0):
    """A single codebook set with streams of widths `lens`.  `integer`:
    integer means in [-2, 2] and variances in [0.5, 2].  `ties`: that many
    codewords of each stream duplicate codeword 0 (planted exact ties)."""
    F, L = len(lens), max(lens)
    means = np.zeros((1, F, K, L), np.float32)
    var = np.ones((1, F, K, L), np.float32)
    for f, ln in enumerate(lens):
        if integer:
            means[0, f, :, :ln] = rng.randint(-2, 3, (K, ln))
            var[0, f, :, :ln] = rng.uniform(0.5, 2.0, (K, ln))
        else:
            means[0, f, :, :ln] = rng.randn(K, ln) * 1.5
            var[0, f, :, :ln] = rng.uniform(0.05, 1.0, (K, ln))
        for k in rng.choice(np.arange(1, K), size=ties, replace=False):
            means[0, f, k], var[0, f, k] = means[0, f, 0], var[0, f, 0]
    prec = (0.5 / var).astype(np.float32)
    lrd = np.zeros((1, F, K), np.float32)
    for f, ln in enumerate(lens):
        lrd[0, f] = -0.5 * (np.log(var[0, f, :, :ln]).sum(-1)
                            + ln * np.log(2 * np.pi))
        prec[0, f, :, ln:] = 0.0
    return GaussianParams(means=means, var=var, prec=prec, lrd=lrd,
                          veclen=list(lens), n_mgau=1, n_feat=F, n_density=K)


def _frames(rng, g, T, integer=False, near=0):
    """Features [T, sum(lens)]: each stream near a random codeword; frames
    < `near` sit exactly on codeword 0 (where planted ties are maximal)."""
    parts = []
    for f, ln in enumerate(g.veclen):
        k = rng.randint(g.n_density, size=T)
        k[:near] = 0
        m = g.means[0, f, k, :ln]
        if integer:
            x = m + rng.randint(-1, 2, (T, ln)) * (np.arange(T) >= near)[:, None]
        else:
            x = m + rng.randn(T, ln) * 0.7
        parts.append(x)
    return np.concatenate(parts, 1).astype(np.float32)


def _magnitude(x, means, prec, lrd):
    """M[t, k] = |const| + sum|x lin| + sum x^2 prec, float64."""
    x, m, p = (np.asarray(a, np.float64) for a in (x, means, prec))
    const = np.asarray(lrd, np.float64) - (p * m * m).sum(-1)
    return np.abs(const)[None] + np.abs(x) @ np.abs(2 * p * m).T + (x * x) @ p.T


def _pair(g, raw, lens, topn, wrap):
    sl = _slices(lens)
    return (JaxPs(g, raw, sl, topn=topn, wrap_uint8=wrap),
            PsParityScorer(g, raw, sl, topn=topn, wrap_uint8=wrap,
                           device="cpu"))


def test_logadd8_table_matches_reference():
    for base, shift in [(1.0001, 10), (1.0003, 8), (1.001, 10)]:
        np.testing.assert_array_equal(logadd8_table(base, shift),
                                      jax_logadd8_table(base, shift))


@pytest.mark.parametrize("topn", [1, 2, 4])
@pytest.mark.parametrize("wrap", [False, True], ids=["8bit", "4bit_wrap"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_psparity_epilogue_bit_exact(layout, wrap, topn):
    """Integer-exact model with planted ties: identical int32 densities in
    both packages, so the scores must be equal bit for bit."""
    lens = LAYOUTS[layout]
    rng = np.random.RandomState(sorted(LAYOUTS).index(layout) * 4 + topn)
    g = _model(rng, lens, K=32, integer=True, ties=3)
    # 4-bit models wrap at 256: bytes up to 255 make the wrap happen.
    raw = rng.randint(0, 256 if wrap else 160,
                      (len(lens), 32, 70)).astype(np.uint8)
    jsc, tsc = _pair(g, raw, lens, topn, wrap)
    x = _frames(rng, g, 60, integer=True, near=10)
    xt = torch.as_tensor(x)
    d_int = tsc.int_densities(xt)
    for f, d in enumerate(tsc.stream_densities(xt)):
        diff = (x[:, _slices(lens)[f], None].astype(np.float64)
                - np.asarray(jsc.means[f], np.float64).T[None])
        exact = (np.asarray(jsc.lrd[f], np.float64)[None]
                 - (np.asarray(jsc.prec[f], np.float64).T[None]
                    * diff ** 2).sum(1))
        assert np.abs(exact).max() < 2 ** 24
        np.testing.assert_array_equal(d.numpy(), exact)
        # The planted ties are exact, and frames on codeword 0 select them.
        assert (d_int[f][:10, 0:1] == d_int[f][:10]).sum() >= 10 * 4
    got = tsc.epilogue(d_int).numpy()
    want = np.asarray(jsc.score(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsc.score(xt).numpy(), want)
    assert np.isfinite(want).all()


def test_topn_select_ties_and_duplicates():
    d = torch.tensor([[5, 9, 9, 1, 9, 3],
                      [-7, -7, -7, -7, -8, -2]], dtype=torch.int32)
    vals, idx = PsParityScorer.topn_select(d, 4)
    assert vals.tolist() == [[9, 9, 9, 5], [-2, -7, -7, -7]]
    assert idx.tolist() == [[1, 2, 4, 0], [5, 0, 1, 2]]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_psparity_densities_within_bound(layout):
    """Stage (a) on real-valued inputs, and the whole scorer."""
    lens = LAYOUTS[layout]
    rng = np.random.RandomState(11 + sorted(LAYOUTS).index(layout))
    K, S, T = 64, 300, 200
    g = _model(rng, lens, K)
    raw = rng.randint(0, 160, (len(lens), K, S)).astype(np.uint8)
    jsc, tsc = _pair(g, raw, lens, 4, False)
    x = _frames(rng, g, T)
    sl = _slices(lens)
    d_t = tsc.stream_densities(torch.as_tensor(x))
    for f in range(len(lens)):
        want = np.asarray(jax_density_logliks(
            jnp.asarray(x[:, sl[f]]), jsc.means[f], jsc.prec[f], jsc.lrd[f]))
        bound = len(sl[f]) * 2.0 ** -22 * _magnitude(
            x[:, sl[f]], jsc.means[f], jsc.prec[f], jsc.lrd[f])
        got = d_t[f].numpy()
        assert np.all(np.abs(got.astype(np.float64) - want) <= bound)
        di = np.abs(np.trunc(np.clip(got, -2e9, 0)).astype(np.int64)
                    - np.trunc(np.clip(want, -2e9, 0)).astype(np.int64))
        assert np.all(di <= np.floor(bound) + 1)
    q = (np.abs(tsc.score(torch.as_tensor(x)).numpy()
                - np.asarray(jsc.score(jnp.asarray(x)))) / tsc.scale)
    assert (q > 0).mean() <= 1e-3
    assert q.max() <= 2 * len(lens) + 1e-3


def test_psparity_batched_and_stream_checks():
    rng = np.random.RandomState(21)
    lens = LAYOUTS["svspec_3x13"]
    g = _model(rng, lens, K=16)
    raw = rng.randint(0, 160, (3, 16, 40)).astype(np.uint8)
    tsc = PsParityScorer(g, raw, _slices(lens), device="cpu")
    x = torch.as_tensor(_frames(rng, g, 30))
    xb = torch.stack([x, x.flip(0)])
    out = tsc.score(xb)
    assert out.shape == (2, 30, 40)
    assert torch.equal(out[1], tsc.score(x.flip(0)))
    with pytest.raises(ValueError):
        PsParityScorer(g, raw, _slices(lens)[:2], device="cpu")


def test_convert_psparity_round_trip():
    rng = np.random.RandomState(22)
    lens = LAYOUTS["s2_4x"]
    g = _model(rng, lens, K=16)
    raw = rng.randint(0, 256, (4, 16, 50)).astype(np.uint8)
    sl = _slices(lens)
    jsc = JaxPs(g, raw, sl, topn=3, wrap_uint8=True)
    direct = PsParityScorer(g, raw, sl, topn=3, wrap_uint8=True,
                            device="cpu")
    kw = convert.psparity_from_jax(
        [np.asarray(a) for a in jsc.means], [np.asarray(a) for a in jsc.prec],
        [np.asarray(a) for a in jsc.lrd], [np.asarray(a) for a in jsc.mixw],
        np.asarray(jsc._tbl_steps))
    np.testing.assert_array_equal(kw["table8"], logadd8_table())
    carried = PsParityScorer.from_params(
        **kw, stream_slices=sl, topn=3, shift=jsc.shift, scale=jsc.scale,
        wrap_uint8=True, device="cpu")
    for name, buf in direct.state_dict().items():
        assert torch.equal(buf, carried.state_dict()[name]), name
    x = torch.as_tensor(_frames(rng, g, 20))
    assert torch.equal(carried.score(x), direct.score(x))


def _semi_bound(g, x, sl, scores):
    b = 0.0
    for f in range(g.n_feat):
        ln = g.veclen[f]
        M = _magnitude(x[:, sl[f]], g.means[0, f, :, :ln],
                       g.prec[0, f, :, :ln], g.lrd[0, f])
        b = b + ln * 2.0 ** -22 * M.max(1, keepdims=True)
    return b + 1e-5 * np.abs(scores)


@pytest.mark.parametrize("topn", [0, 2, 4])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_semicontinuous_matches_reference(layout, topn):
    lens = LAYOUTS[layout]
    rng = np.random.RandomState(31 + topn + 7 * sorted(LAYOUTS).index(layout))
    K, S = 32, 120
    g = _model(rng, lens, K, ties=2)
    lnw = np.log(rng.dirichlet(np.ones(K), size=(len(lens), S))
                 ).transpose(0, 2, 1).astype(np.float32)
    sl = _slices(lens)
    x = _frames(rng, g, 80, near=8)
    want = np.asarray(JaxSemi(g, lnw, sl, topn=topn).score(jnp.asarray(x)))
    got = SemiContinuousScorer(g, lnw, sl, topn=topn,
                               device="cpu").score(torch.as_tensor(x)).numpy()
    assert got.shape == (80, S) and np.isfinite(got).all()
    assert np.all(np.abs(got.astype(np.float64) - want)
                  <= _semi_bound(g, x, sl, want))


def test_mask_topn_keeps_ties_past_n():
    from cmusphinx_tpu.ops.gmm import _mask_topn as jax_mask_topn
    from cmusphinx_tpu_torch.ops.gmm import _mask_topn
    d = np.array([[1.0, 5.0, 3.0, 5.0, 3.0, 3.0, 0.5],
                  [2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    for n in (0, 1, 2, 3, 7, 9):
        got = _mask_topn(torch.as_tensor(d), n).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jax_mask_topn(jnp.asarray(d), n)))
    # Top-3 of row 0 is {5, 5, 3}: every 3 survives, so 5 values stay.
    assert np.isfinite(_mask_topn(torch.as_tensor(d), 3).numpy()[0]).sum() == 5


def test_convert_semicontinuous_round_trip():
    rng = np.random.RandomState(41)
    lens = LAYOUTS["svspec_3x13"]
    g = _model(rng, lens, K=16)
    lnw = np.log(rng.dirichlet(np.ones(16), size=(3, 30))
                 ).transpose(0, 2, 1).astype(np.float32)
    sl = _slices(lens)
    jsc = JaxSemi(g, lnw, sl, topn=2)
    kw = convert.semicont_from_jax([np.asarray(a) for a in jsc.means],
                                   [np.asarray(a) for a in jsc.prec],
                                   [np.asarray(a) for a in jsc.lrd],
                                   np.asarray(jsc.w))
    carried = SemiContinuousScorer.from_params(**kw, stream_slices=sl,
                                               topn=2, device="cpu")
    direct = SemiContinuousScorer(g, lnw, sl, topn=2, device="cpu")
    for name, buf in direct.state_dict().items():
        assert torch.equal(buf, carried.state_dict()[name]), name
    x = torch.as_tensor(_frames(rng, g, 20))
    assert torch.equal(carried.score(x), direct.score(x))
