"""Port parity for the word-lattice results layer: `get_lattice`,
bestpath rescoring, posteriors, N-best and the lattice files
(cmusphinx_tpu_torch.decode.lattice, the native runtime in
cmusphinx_tpu_torch/csrc/sphinx_runtime.cc) against the JAX package.

The SMALL continuous fixture is decoded with wide beams and a low LM
weight (beam 1e-120, wbeam 1e-100, lw 2), so each lattice holds some 110
to 170 word instances and ten distinct paths.  Tolerances:
- nodes equal on (word, sf, ef); vit_score, entry_score and the rc scores
  within rtol 1e-5 (the tapes' float tolerance);
- bestpath hypotheses equal in words and segments, scores within rtol 1e-5;
- posteriors within 1e-4 absolute, where finite; -inf at the same nodes;
- nbest(10) equal in words and order, scores within rtol 1e-5;
- get_prob within rtol 1e-5;
- the port's native and pure-Python paths: as the reference's own test
  holds its two (test_native.py): bestpath words equal, scores within
  1e-3; posteriors within 1e-4; N-best words and order equal;
- lattice files: each package's `write` and `write_htk` byte-equal on the
  same nodes, and read back into the same nodes and links.
"""

import numpy as np
import pytest
import torch

from cmusphinx_tpu.api import Decoder as JaxDecoder
from cmusphinx_tpu.decode import lattice as jax_lattice
from cmusphinx_tpu.decode.ngram_search import NgramSearch as JaxSearch
from cmusphinx_tpu.ops.gmm import ContinuousScorer as JaxScorer
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.api import Decoder
from cmusphinx_tpu_torch.decode import NgramSearch
from cmusphinx_tpu_torch.decode import lattice as port_lattice
from cmusphinx_tpu_torch.frontend import FeatPipeline
from cmusphinx_tpu_torch.ops import ContinuousScorer
from cmusphinx_tpu_torch.utils import native
from cmusphinx_tpu_torch.utils.bio import write_mfc

WIDE = {"beam": 1e-120, "wbeam": 1e-100, "lw": 2.0}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fx():
    return fixture.build(0, size=fixture.SMALL)


@pytest.fixture(scope="module")
def searches(fx):
    js = JaxSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                   JaxScorer(fx.gauden, fx.ln_mixw, use_pallas=False), **WIDE)
    ts = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                     ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu"),
                     device="cpu", **WIDE)
    feats = FeatPipeline(fx.feat_config(), device="cpu").compute_batch(fx.ceps)
    return js, ts, feats


@pytest.fixture(scope="module")
def lattices(searches):
    """Per utterance: (port lattice, reference lattice), each after its
    package's `decode`."""
    js, ts, feats = searches
    out = []
    for f in feats:
        ts.decode(f)
        js.decode(f)
        out.append((ts.get_lattice(), js.get_lattice()))
    return out


def _same(h, j, rel=1e-5):
    assert h.words == j.words
    assert [(s.word, s.start_frame, s.end_frame) for s in h.segments] == \
        [(s.word, s.start_frame, s.end_frame) for s in j.segments]
    assert h.score == pytest.approx(j.score, rel=rel)


def _node_table(lat):
    return [(n.word, n.sf, n.ef) for n in lat.nodes]


def test_lattice_nodes_match_reference(lattices):
    assert native.loaded()
    for lat, jlat in lattices:
        assert len(lat.nodes) > 100
        assert _node_table(lat) == _node_table(jlat)
        assert [(n.lmwid, n.kidx, n.is_filler, n.is_finish) for n in lat.nodes] \
            == [(n.lmwid, n.kidx, n.is_filler, n.is_finish) for n in jlat.nodes]
        assert [n.succs for n in lat.nodes] == [n.succs for n in jlat.nodes]
        for name in ("vit_score", "entry_score", "fil_pen"):
            np.testing.assert_allclose(
                [getattr(n, name) for n in lat.nodes],
                [getattr(n, name) for n in jlat.nodes], rtol=1e-5, atol=0)
        np.testing.assert_allclose(np.stack([n.rc_score for n in lat.nodes]),
                                   np.stack([n.rc_score for n in jlat.nodes]),
                                   rtol=1e-5, atol=0)
        assert (lat.n_frames, lat.sil_ci, lat.finish_lmwid) == \
            (jlat.n_frames, jlat.sil_ci, jlat.finish_lmwid)


def test_bestpath_posterior_nbest_match_reference(lattices, searches):
    js, ts, _ = searches
    assert ts.start_lmwid == js.start_lmwid
    for lat, jlat in lattices:
        for lw in (None, 9.5):
            _same(lat.bestpath(lw=lw, start_lmwid=ts.start_lmwid),
                  jlat.bestpath(lw=lw, start_lmwid=js.start_lmwid))
        for ascale in (0.05, 1.0):
            p, q = lat.posterior(ascale), np.asarray(jlat.posterior(ascale))
            assert np.array_equal(np.isfinite(p), np.isfinite(q))
            m = np.isfinite(q)
            np.testing.assert_allclose(p[m], q[m], rtol=0, atol=1e-4)
        nb = lat.nbest(10, start_lmwid=ts.start_lmwid)
        jnb = jlat.nbest(10, start_lmwid=js.start_lmwid)
        assert len(nb) == 10
        assert [h.words for h in nb] == [h.words for h in jnb]
        np.testing.assert_allclose([h.score for h in nb],
                                   [h.score for h in jnb], rtol=1e-5)


def test_native_matches_python(lattices, searches, monkeypatch):
    js, ts, _ = searches
    lat = lattices[0][0]
    want = (lat.bestpath(lw=9.5, start_lmwid=ts.start_lmwid),
            lat.posterior(0.05), lat.nbest(5, start_lmwid=ts.start_lmwid))
    monkeypatch.setattr(port_lattice, "_native", None)
    got = (lat.bestpath(lw=9.5, start_lmwid=ts.start_lmwid),
           lat.posterior(0.05), lat.nbest(5, start_lmwid=ts.start_lmwid))
    assert got[0].words == want[0].words
    assert got[0].score == pytest.approx(want[0].score, abs=1e-3)
    m = np.isfinite(got[1])
    np.testing.assert_allclose(want[1][m], got[1][m], rtol=1e-4, atol=1e-4)
    assert [h.words for h in got[2]] == [h.words for h in want[2]]
    # The host LM: the native trigram core and the Python one.
    rng = np.random.RandomState(4)
    V = ts.lm.n_words
    w = [rng.randint(lo, V, 300).astype(np.int32) for lo in (-1, 0, 0)]
    np.testing.assert_allclose(
        native.tg_score_batch(native.LmArrays(ts.lm), *w),
        [ts.lm.tg_score(int(a), int(b), int(c)) for a, b, c in zip(*w)],
        rtol=1e-6, atol=1e-6)


def test_bestpath_decode_batch_matches_reference(searches):
    js, ts, feats = searches
    got = ts.decode_batch(feats, bestpath=True)
    want = js.decode_batch(feats, bestpath=True)
    for h, j in zip(got, want, strict=True):
        _same(h, j)
    plain = ts.decode_batch(feats)
    assert [h.words for h in got] == [h.words for h in plain]
    # -bestpath from the configuration, and on one utterance.
    ts.config["bestpath"] = True
    try:
        _same(ts.decode(feats[1]), js.decode(feats[1], bestpath=True))
    finally:
        ts.config["bestpath"] = False
    # The last utterance of the batch is what get_lattice reads.
    ts.decode_batch(feats)
    assert _node_table(ts.get_lattice()) == _node_table(
        ts._lattice_from_tape(tuple(a[-1] for a in ts._batch_host_tapes())
                              + (len(feats[-1]),)))


def _jax_nodes(lat):
    return [jax_lattice.LatNode(
        id=n.id, word=n.word, kidx=n.kidx, lmwid=n.lmwid,
        is_filler=n.is_filler, fil_pen=n.fil_pen, sf=n.sf, ef=n.ef,
        vit_score=n.vit_score, rc_score=n.rc_score.copy(),
        entry_score=n.entry_score, is_finish=n.is_finish)
        for n in lat.nodes]


def test_lattice_files_match_reference(lattices, searches, tmp_path):
    js, ts, _ = searches
    lat = lattices[1][0]
    jlat = jax_lattice.Lattice(_jax_nodes(lat), lat.firstci, lat.lastci,
                               lat.lm, lat.lw, lat.log_wip, lat.sil_ci,
                               lat.finish_lmwid, lat.n_frames)
    for kind in ("write", "write_htk"):
        a, b = tmp_path / f"port.{kind}", tmp_path / f"jax.{kind}"
        getattr(lat, kind)(str(a), uttid="u1")
        getattr(jlat, kind)(str(b), uttid="u1")
        assert a.read_bytes() == b.read_bytes()
    # Read back by each package: the same nodes and links, and the file's
    # own bestpath.
    links = sorted((n.id, j) for n in lat.nodes for j in n.succs)
    for mod in (port_lattice, jax_lattice):
        r = mod.read_lattice(str(tmp_path / "port.write"), ts.lm, lw=9.5,
                             log_wip=ts.log_wip)
        assert _node_table(r) == _node_table(lat)
        assert sorted(r._explicit) == links
        h = mod.read_htk_lattice(str(tmp_path / "port.write_htk"), ts.lm,
                                 lw=9.5, log_wip=ts.log_wip)
        assert [n.word for n in h.nodes] == [n.word for n in lat.nodes]
        assert sorted(h._explicit) == links
    pr = port_lattice.read_lattice(str(tmp_path / "port.write"), ts.lm,
                                   lw=9.5, log_wip=ts.log_wip)
    jr = jax_lattice.read_lattice(str(tmp_path / "port.write"), ts.lm,
                                  lw=9.5, log_wip=ts.log_wip)
    _same(pr.bestpath(start_lmwid=ts.start_lmwid),
          jr.bestpath(start_lmwid=ts.start_lmwid))
    assert [h.words for h in pr.nbest(5, start_lmwid=ts.start_lmwid)] == \
        [h.words for h in jr.nbest(5, start_lmwid=ts.start_lmwid)]
    np.testing.assert_allclose(pr.posterior(), jr.posterior(), atol=1e-4)
    ps, qs = pr.sausage(), jr.sausage()
    assert [[w for w, _ in x] for x in ps] == [[w for w, _ in x] for x in qs]
    np.testing.assert_allclose([q for x in ps for _, q in x],
                               [q for x in qs for _, q in x], atol=1e-4)
    assert [w for w, *_ in pr.word_confidence(lat.bestpath().segments)] == \
        [w for w, *_ in jr.word_confidence(lat.bestpath().segments)]


def test_decoder_results_match_reference(fx, tmp_path):
    """`get_lattice`, `nbest` and `get_prob` through both packages'
    Decoder, after a batch utterance and after a streamed one."""
    kw = fixture.write_model_dir(fx, str(tmp_path))
    td = Decoder(device="cpu", **WIDE, **kw)
    jd = JaxDecoder(**WIDE, **kw)
    path = str(tmp_path / "u.mfc")
    write_mfc(path, fx.ceps[2])
    for d in (td, jd):
        d.decode_cep_file(path)
    _same(td.hyp(), jd.hyp())
    assert _node_table(td.get_lattice()) == _node_table(jd.get_lattice())
    assert [h.words for h in td.nbest(10)] == [h.words for h in jd.nbest(10)]
    assert td.get_prob() == pytest.approx(jd.get_prob(), rel=1e-5)
    assert 0.0 < td.get_prob() <= 1.0
    for d in (td, jd):
        d.start_utt(streaming=True)
        for part in np.array_split(fx.ceps[2], 4):
            d.process_cep(part)
        d.end_utt()
    _same(td.hyp(), jd.hyp())
    assert [h.words for h in td.nbest(10)] == [h.words for h in jd.nbest(10)]
    assert td.get_prob() == pytest.approx(jd.get_prob(), rel=1e-5)
