"""Port parity: the dense trigram table and `score_tg`
(cmusphinx_tpu_torch.models.ngram_device) against
cmusphinx_tpu.models.ngram_device.DeviceNgram, exactly, on an LM that
`lm.estimate.train_lm` builds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmusphinx_tpu.lm.estimate import train_lm
from cmusphinx_tpu.models.ngram_device import DeviceNgram as JaxNgram
from cmusphinx_tpu_torch.models.ngram_device import DeviceNgram, build_dense3


@pytest.fixture(scope="module")
def lm():
    rng = np.random.RandomState(0)
    vocab = [f"w{i}" for i in range(30)]
    sents = [[vocab[k] for k in rng.randint(0, 30, rng.randint(1, 7))]
             for _ in range(300)]
    return train_lm(sents, n=3)


def test_dense_table_equals_reference(lm):
    jd = JaxNgram(lm)
    assert jd.tg_dense is not None
    np.testing.assert_array_equal(build_dense3(lm), np.asarray(jd.tg_dense))
    td = DeviceNgram(lm, device="cpu")
    assert td.V == jd.V
    np.testing.assert_array_equal(td.tg_dense.numpy(), np.asarray(jd.tg_dense))


def test_score_tg_equals_reference(lm):
    jd, td = JaxNgram(lm), DeviceNgram(lm, device="cpu")
    rng = np.random.RandomState(1)
    V = lm.n_words
    w1 = rng.randint(-1, V, (40, 7)).astype(np.int32)
    w2 = rng.randint(-1, V, (40, 7)).astype(np.int32)
    w3 = rng.randint(0, V, (40, 7)).astype(np.int32)
    want = np.asarray(jd.score_tg(jnp.asarray(w1), jnp.asarray(w2),
                                  jnp.asarray(w3)))
    got = td.score_tg(*map(torch.as_tensor, (w1, w2, w3))).numpy()
    np.testing.assert_array_equal(got, want)
    # Broadcasting as the decoder uses it: [E, 1] histories x [1, W] words.
    got_b = td.score_tg(torch.as_tensor(w1[:, :1]), torch.as_tensor(w2[:, :1]),
                        torch.arange(V)[None, :]).numpy()
    want_b = np.asarray(jd.score_tg(jnp.asarray(w1[:, :1]),
                                    jnp.asarray(w2[:, :1]),
                                    jnp.arange(V)[None, :]))
    np.testing.assert_array_equal(got_b, want_b)
    # And against the host scalar backoff chain.
    host = np.array([lm.tg_score(int(a), int(b), int(c)) for a, b, c in
                     zip(w1[:, 0], np.maximum(w2[:, 0], 0), w3[:, 0])],
                    np.float32)
    got_h = td.score_tg(torch.as_tensor(w1[:, 0]),
                        torch.as_tensor(np.maximum(w2[:, 0], 0)),
                        torch.as_tensor(w3[:, 0])).numpy()
    np.testing.assert_allclose(got_h, host, rtol=1e-6, atol=1e-6)


def test_large_vocabulary_is_not_ported_yet(lm):
    """An LM above `dense3_limit` (which raised before the sparse backends
    were ported) now takes the probe backend, with the dense table's
    scores."""
    dense = DeviceNgram(lm, device="cpu")
    td = DeviceNgram(lm, device="cpu", dense3_limit=1024)
    assert td.tg_dense is None and td.probe
    w1, w2, w3 = _queries(lm, np.random.RandomState(2), 300)
    q = [torch.as_tensor(a) for a in (w1, w2, w3)]
    np.testing.assert_array_equal(td.score_tg(*q).numpy(),
                                  dense.score_tg(*q).numpy())
    assert td.calls == {"probe": 1} and dense.calls == {"dense": 1}


# ---- the sparse backends ------------------------------------------------

def _queries(lm, rng, n):
    """(w1, w2, w3) int32 query lanes: random ones (with -1 histories and
    mostly absent bigrams), trigrams of the LM, and bigrams of the LM with
    a random third word (a backoff through bo(w1, w2))."""
    V = lm.n_words
    w1 = rng.randint(-1, V, n).astype(np.int32)
    w2 = rng.randint(-1, V, n).astype(np.int32)
    w3 = rng.randint(0, V, n).astype(np.int32)
    bg_w1 = np.repeat(np.arange(V), np.diff(lm.bg_ptr))
    tg_b = np.repeat(np.arange(len(lm.bg_wid)), np.diff(lm.tg_ptr))
    k = rng.randint(0, len(lm.tg_wid), n // 3)
    w1[: n // 3], w2[: n // 3] = bg_w1[tg_b[k]], lm.bg_wid[tg_b[k]]
    w3[: n // 3] = lm.tg_wid[k]
    b = rng.randint(0, len(lm.bg_wid), n // 3)
    w1[n // 3: 2 * n // 3] = bg_w1[b]
    w2[n // 3: 2 * n // 3] = lm.bg_wid[b]
    w1[-5:], w2[-3:] = -1, -1
    return w1, w2, w3


@pytest.fixture(scope="module", params=["SMALL", "MEDIUM"])
def sized(request):
    """The fixture LMs: SMALL's (probe backend) and MEDIUM's (hashed)."""
    from cmusphinx_tpu_torch import fixture
    lm = fixture.build(0, size=getattr(fixture, request.param)).lm
    return request.param, lm, JaxNgram(lm), DeviceNgram(lm, device="cpu")


def test_sparse_backends_equal_reference(sized):
    name, lm, jd, td = sized
    assert (td.probe, td.hashed) == (jd.probe, jd.hashed) == \
        ((True, False) if name == "SMALL" else (False, True))
    assert (td.tg_dense is None) == (jd.tg_dense is None) == (name != "SMALL")
    w1, w2, w3 = _queries(lm, np.random.RandomState(3), 600)
    j = [jnp.asarray(a) for a in (w1, w2, w3)]
    t = [torch.as_tensor(a) for a in (w1, w2, w3)]
    np.testing.assert_array_equal(td.score_tg(*t).numpy(),
                                  np.asarray(jd.score_tg(*j)))
    np.testing.assert_array_equal(td.score_bg(t[1], t[2]).numpy(),
                                  np.asarray(jd.score_bg(j[1], j[2])))
    np.testing.assert_array_equal(td.score_rows(t[0], t[1]).numpy(),
                                  np.asarray(jd.score_rows(j[0], j[1])))
    if name == "SMALL":
        np.testing.assert_array_equal(td.score_tg_probe(*t).numpy(),
                                      np.asarray(jd.score_tg_probe(*j)))
    else:
        np.testing.assert_array_equal(td.score_tg_hashed(*t).numpy(),
                                      np.asarray(jd.score_tg_hashed(*j)))
        for a in ("_hbg", "_htg"):
            np.testing.assert_array_equal(getattr(td, a).numpy(),
                                          np.asarray(getattr(jd, a)))
    # CSR, with the other backends turned off on both sides.
    for d in (jd, td):
        d.probe, d.hashed, d.tg_dense = False, False, None
    assert td.backend(600) == "csr"
    np.testing.assert_array_equal(td.score_tg(*t).numpy(),
                                  np.asarray(jd.score_tg(*j)))


def test_sparse_backends_equal_one_another(sized):
    name, lm, _, _ = sized
    td = DeviceNgram(lm, device="cpu")
    if not td.hashed:
        td._build_hash(lm, "cpu")
    w1, w2, w3 = _queries(lm, np.random.RandomState(4), 900)
    t = [torch.as_tensor(a) for a in (w1, w2, w3)]
    want = np.array([lm.tg_score(int(a), int(b), int(c)) if b >= 0
                     else lm.ug_score(int(c)) for a, b, c in zip(w1, w2, w3)],
                    np.float32)
    got = {"hashed": td.score_tg_hashed(*t),
           "rows": td.score_rows(t[0], t[1])[torch.arange(len(w3)), t[2]]}
    if td.probe:
        got["probe"] = td.score_tg_probe(*t)
    if td.tg_dense is not None:
        got["dense"] = td.score_tg(*t)
    td.probe = td.hashed = False
    td.tg_dense = None
    got["csr"] = td.score_tg(*t)
    assert len(got) == (5 if name == "SMALL" else 3)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), got["csr"].numpy(), err_msg=k)
    # The host scalar backoff chain sums in float64.
    np.testing.assert_allclose(got["csr"].numpy(), want, rtol=1e-6, atol=1e-6)
    assert td.calls["csr"] == 1
