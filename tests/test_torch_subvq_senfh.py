"""Port parity for sub-vector quantization (`ops/subvq.py`) and senone
score files (`utils/senfh.py`) against the JAX package on the seeded SMALL
fixture.

Tolerances:
- `build_subvq` (host float64 k-means, `np.random.RandomState` seeded the
  same): equal, every array;
- the subvq text file and the senone score file: byte-equal to the
  reference writer's, and read back equal by both readers;
- `SubVQScorer`: codeword densities and scores within 2^-20 of the
  magnitude of the summed terms (f32 products summed in another order);
  `shortlist` equal (a Gaussian within that bound of the beam's edge
  could flip; none does on this fixture);
- the replay decode: hypotheses equal to the live decode's and to the
  reference's replay (tapes as tests/test_torch_ngram_search).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmusphinx_tpu.decode.ngram_search import NgramSearch as JaxSearch
from cmusphinx_tpu.ops import subvq as jsubvq
from cmusphinx_tpu.utils import senfh as jsenfh
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.decode import NgramSearch
from cmusphinx_tpu_torch.frontend import FeatPipeline
from cmusphinx_tpu_torch.ops import ContinuousScorer, subvq
from cmusphinx_tpu_torch.utils import senfh
from test_torch_host import assert_same
from test_torch_ngram_search import assert_hyps_match
from test_torch_stream import assert_flat_tapes_match


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small():
    fx = fixture.build(0, size=fixture.SMALL)
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    feats = [fp.compute(c) for c in fx.ceps]
    svq = subvq.build_subvq(fx.gauden, n_sv=3, vqsize=16, n_iter=6, seed=2,
                            n_restarts=2)
    return fx, feats, svq


def test_build_subvq_and_files_match_reference(small, tmp_path):
    fx, _, svq = small
    want = jsubvq.build_subvq(fx.gauden, n_sv=3, vqsize=16, n_iter=6,
                              seed=2, n_restarts=2)
    assert_same(want, svq)
    assert svq.map.shape == (fx.size.n_sen, fx.size.n_density, 3)
    # Gaussians absent from a codebook (map -1) round-trip too.
    svq.map[0, 1, 2] = -1
    try:
        ours, theirs = tmp_path / "p.subvq", tmp_path / "j.subvq"
        subvq.write_subvq(str(ours), svq)
        jsubvq.write_subvq(str(theirs), svq)
        assert ours.read_bytes() == theirs.read_bytes()
        assert_same(jsubvq.read_subvq(str(ours)), subvq.read_subvq(str(ours)))
    finally:
        svq.map[0, 1, 2] = want.map[0, 1, 2]


def test_subvq_scorer_matches_reference(small, tmp_path):
    fx, feats, svq = small
    x = np.concatenate(feats)
    # One Gaussian absent from its codebook: it never wins.
    path = tmp_path / "m.subvq"
    subvq.write_subvq(str(path), svq)
    svq = subvq.read_subvq(str(path))
    svq.map[3, 0, 1] = -1
    ts = subvq.SubVQScorer(svq, fx.ln_mixw, device="cpu")
    js = jsubvq.SubVQScorer(svq, fx.ln_mixw)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    dens = ts.codeword_densities(xt).numpy()
    want = np.asarray(js.codeword_densities(xj))
    np.testing.assert_allclose(dens, want, rtol=2.0 ** -20,
                               atol=2.0 ** -20 * np.abs(want).max())
    ga = ts.gaussian_approx(xt).numpy()
    jga = np.asarray(js.gaussian_approx(xj))
    tol = 2.0 ** -20 * 3 * np.abs(want).max()
    ok = jga > -1e29
    np.testing.assert_allclose(ga[ok], jga[ok], rtol=0, atol=tol)
    assert (ga[3, 3, 0] < -1e29) and not ok[:, 3, 0].any()
    got = ts.score(xt).numpy()
    np.testing.assert_allclose(got, np.asarray(js.score(xj)), rtol=0,
                               atol=tol)
    assert got.shape == (len(x), fx.size.n_sen)
    for beam in (5.0, 20.0):
        sl = ts.shortlist(xt, beam).numpy()
        jsl = np.asarray(js.shortlist(xj, beam))
        assert int((sl != jsl).sum()) == 0
        assert sl.any((1, 2)).all() and not sl.all()
    # Frame blocks and a batch axis change nothing.
    b = torch.as_tensor(np.stack([x[:70], x[70:140]]))
    ts._rows = lambda: 17
    np.testing.assert_array_equal(ts.score(b)[1].numpy(), got[70:140])
    np.testing.assert_array_equal(ts.shortlist(b, 5.0)[0].numpy(),
                                  ts.shortlist(xt[:70], 5.0).numpy())


def test_senscr_files_and_replay_match_reference(small, tmp_path):
    rng = np.random.RandomState(2)
    scores = -np.abs(rng.randn(20, 50)).astype(np.float32) * 5
    ours, theirs = str(tmp_path / "p.sen"), str(tmp_path / "j.sen")
    senfh.write_senscr(ours, scores, mdef_file="m")
    jsenfh.write_senscr(theirs, scores, mdef_file="m")
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    back, logbase = senfh.read_senscr(ours)
    jback, jlogbase = jsenfh.read_senscr(ours)
    np.testing.assert_array_equal(back, jback)
    assert logbase == jlogbase
    rs = senfh.ReplayScorer.from_file(ours, device="cpu")
    jrs = jsenfh.ReplayScorer.from_file(ours)
    for T in (12, 20, 27):
        out = rs.score(torch.zeros((T, 13)))
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jrs.score(np.zeros((T, 13), np.float32))))
    # Under a batch, every row replays the stream.
    out = rs.score(torch.zeros((3, 25, 13))).numpy()
    assert out.shape == (3, 25, 50)
    np.testing.assert_array_equal(out[2], out[0])


def test_replay_decode_matches_live(small, tmp_path):
    """Utterance 0's scores written with write_senscr and decoded through
    ReplayScorer.from_file: the live decode's hypothesis, and the
    reference's replay of the same file."""
    fx, feats, _ = small
    sc = ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu")
    s = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, sc, device="cpu")
    live = s.decode(feats[0])
    path = str(tmp_path / "u0.sen")
    senfh.write_senscr(path, sc.score(torch.as_tensor(feats[0])).numpy())
    s.scorer = senfh.ReplayScorer.from_file(path, device="cpu")
    replay = s.decode(feats[0])
    assert replay.words == live.words == fx.transcripts[0]
    T, E = len(feats[0]), s.E
    tape = [a[0, : T * E].numpy() for a in s._last_batch[0]]
    js = JaxSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                   jsenfh.ReplayScorer.from_file(path))
    assert_hyps_match([replay], [js.decode(feats[0])])
    assert_flat_tapes_match(tape, [np.asarray(a)[: T * E]
                                   for a in js._last[:6]], E)
    # The batch path pads the utterance: the replay fills its rows.
    hyps = s.decode_batch_cep(fx.ceps[:1],
                              FeatPipeline(fx.feat_config(), device="cpu"))
    assert hyps[0].words == replay.words
