"""Port parity: the batch feature kernel (cmusphinx_tpu_torch.frontend.feat)
against cmusphinx_tpu.frontend.feat.FeatPipeline on the same cepstra.

Tolerance: atol 1e-5.  The CMN mean and the LDA product sum float32
values in another order in XLA and in torch, which moves the last bits;
every other step is elementwise and exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmusphinx_tpu.frontend.feat import FeatPipeline as JaxFeat
from cmusphinx_tpu.utils.bio import write_s3_header
from cmusphinx_tpu.utils.config import Config
from cmusphinx_tpu_torch.frontend.feat import FEAT_ARGS, FeatPipeline

DIMS = {"1s_c_d_dd": 39, "s3_1x39": 39, "s2_4x": 51}


def _ceps(seed, lens=(37, 120, 93)):
    rng = np.random.RandomState(seed)
    return [(rng.randn(n, 13) * 2.0 + rng.randn(13) * 3.0).astype(np.float32)
            for n in lens]


def _write_lda(path, rows, cols, seed):
    mat = np.random.RandomState(seed).randn(rows, cols).astype(np.float32)
    mat /= np.sqrt(cols)
    with open(path, "wb") as fh:
        write_s3_header(fh, "0.1")
        fh.write(np.array([1, rows, cols], "<u4").tobytes())
        fh.write(mat.astype("<f4").tobytes())
    return mat


@pytest.mark.parametrize("lda", [False, True])
@pytest.mark.parametrize("agc", ["none", "max"])
@pytest.mark.parametrize("feat", sorted(DIMS))
def test_padded_kernel_matches_reference(feat, agc, lda, tmp_path):
    params = {"feat": feat, "agc": agc}
    if lda:
        _write_lda(tmp_path / "lda", 32, DIMS[feat], seed=5)
        params.update(lda=str(tmp_path / "lda"), ldadim=29)
    jfp = JaxFeat(Config(FEAT_ARGS), **params)
    tfp = FeatPipeline(Config(FEAT_ARGS), device="cpu", **params)
    assert tfp.out_dim == jfp.out_dim
    assert [s.tolist() for s in tfp.stream_slices()] == \
        [s.tolist() for s in jfp.stream_slices()]
    ceps = _ceps(sorted(DIMS).index(feat) * 4 + (agc == "max") * 2 + lda)
    Ts = [len(c) for c in ceps]
    Tp = 200
    cpad = np.zeros((len(ceps), Tp, 13), np.float32)
    for i, c in enumerate(ceps):
        cpad[i, : len(c)] = c
    got = tfp._padded_kernel(torch.as_tensor(cpad),
                             torch.as_tensor(Ts)).numpy()
    assert got.shape == (len(ceps), Tp, jfp.out_dim)
    for i, T in enumerate(Ts):
        want = np.asarray(jfp._padded_kernel(jnp.asarray(cpad[i]),
                                             jnp.int32(T), True))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cmn,varnorm", [("prior", False), ("none", False),
                                         ("current", True)])
def test_cmn_modes_match_reference(cmn, varnorm):
    params = {"feat": "1s_c_d_dd", "cmn": cmn, "varnorm": varnorm}
    jfp = JaxFeat(Config(FEAT_ARGS), **params)
    tfp = FeatPipeline(Config(FEAT_ARGS), device="cpu", **params)
    ceps = _ceps(7)
    want = jfp.compute_batch(ceps)
    got = tfp.compute_batch(ceps)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_unknown_feature_type_raises():
    with pytest.raises(ValueError):
        FeatPipeline(device="cpu", feat="nope")


@pytest.mark.parametrize("params", [
    {"feat": "1s_c_d_dd", "svspec": "0-12/13-25/26-38"},
    {"feat": "s2_4x", "agc": "max"},
    {"feat": "1s_c_d_dd", "cmn": "prior", "cmninit": "56,-3,1"},
    {"feat": "1s_c_d_dd", "batch_cmn": False},
], ids=["svspec", "s2_4x_agc", "prior_cmninit", "no_batch_cmn"])
def test_compute_matches_reference(params):
    params = dict(params)
    batch_cmn = params.pop("batch_cmn", True)
    jfp = JaxFeat(Config(FEAT_ARGS), **params)
    tfp = FeatPipeline(Config(FEAT_ARGS), device="cpu", **params)
    for c in _ceps(9, lens=(1, 37, 250)):
        want = np.asarray(jfp.compute(c, batch_cmn))
        got = tfp.compute(c, batch_cmn)
        assert got.shape == want.shape == (len(c), jfp.out_dim)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    empty = tfp.compute(np.zeros((0, 13), np.float32))
    assert empty.shape == np.asarray(
        jfp.compute(np.zeros((0, 13), np.float32))).shape == (0, jfp.out_dim)


def test_batch_prior_cmn_rule():
    """ROADMAP C1: the batch path with prior CMN subtracts the configured
    `cmninit`, whatever the live path has done since.  That is the
    reference's answer wherever the reference is deterministic: a fresh
    pipeline, and a frame bucket traced before any live call (its jitted
    kernel keeps the mean it was traced with).  Where the reference's
    answer depends on which bucket was traced first (a live utterance
    before the first batch call of a bucket: it then takes the live mean),
    the port keeps `cmninit`; its value there is pinned here."""
    from cmusphinx_tpu.utils.config import Config as JaxConfig
    from cmusphinx_tpu_torch.utils.config import Config as TConfig
    from cmusphinx_tpu.frontend.feat import FEAT_ARGS as JAX_FEAT_ARGS
    rng = np.random.RandomState(0)
    live = (rng.randn(300, 13) * 2 + 20).astype(np.float32)
    batch = (rng.randn(200, 13) * 2 + 20).astype(np.float32)
    params = {"feat": "1s_c_d_dd", "cmn": "prior", "cmninit": "8.0"}

    def pair():
        return (JaxFeat(JaxConfig(JAX_FEAT_ARGS), **params),
                FeatPipeline(TConfig(FEAT_ARGS), device="cpu", **params))

    # A fresh pipeline, and a bucket traced before the live call.
    j, t = pair()
    fresh = t.compute(batch)
    np.testing.assert_allclose(fresh, np.asarray(j.compute(batch)), rtol=0,
                               atol=1e-5)
    j.normalize_live(live, True)
    t.normalize_live(live, True)
    assert float(j._cmn_mean[0]) == float(t._cmn_mean[0]) != 8.0
    np.testing.assert_allclose(t.compute(batch), np.asarray(j.compute(batch)),
                               rtol=0, atol=1e-5)
    # The live call first: the reference subtracts the live mean, the port
    # still cmninit, as from a fresh pipeline.
    j, t = pair()
    j.normalize_live(live, True)
    t.normalize_live(live, True)
    got, ref = t.compute(batch), np.asarray(j.compute(batch))
    np.testing.assert_array_equal(got, fresh)
    assert abs(float(got[0, 0]) - 10.551) < 5e-3
    assert abs(float(ref[0, 0]) - 6.101) < 5e-3
