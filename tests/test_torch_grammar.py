"""Port parity for the grammar search: `FsgSearch` (decode, stream,
backtrace), `FsgLattice` (bestpath, N-best, posteriors, write) and the
`Decoder` with -fsg / -jsgf / -srgs / -cfg, against the JAX package, on
the seeded fixtures' grammars (`fixture.grammar_fsg`, `grammar_jsgf`, and
a CFG and an SRGS grammar of the transcripts made here).

Both searches take the same senone scores (an identity scorer fed the
port's CPU scores), so their arithmetic is the same float32 operations in
the same order: the integer tapes (`wexh`, the exits' backpointers) must be
equal, the float tapes (`wex`, `wexsil`, `exv`) within rtol 1e-5 (equal in
practice), hypotheses equal in words and segments, scores within rtol
1e-5.  Through the `Decoder`, each package scores with its own CPU
scorer: words and segments equal, scores within rtol 1e-5 (the scorers'
float32 sums in another order).

Each search gets its own copy of a grammar: `FsgSearch` adds silence loops
and alternates to the `FsgModel` it is given.
"""

import io
import os

import numpy as np
import pytest
import torch

from cmusphinx_tpu.api import Decoder as JaxDecoder
from cmusphinx_tpu.decode.fsg_search import FsgSearch as JaxFsg
from cmusphinx_tpu.models.cfg import Cfg as JaxCfg
from cmusphinx_tpu.models.fsg import FsgModel as JaxFsgModel
from cmusphinx_tpu.models.jsgf import JsgfGrammar as JaxJsgf
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.api import Decoder
from cmusphinx_tpu_torch.decode.fsg_search import FSG_ARGS, FsgSearch
from cmusphinx_tpu_torch.frontend import FeatPipeline
from cmusphinx_tpu_torch.models.cfg import Cfg
from cmusphinx_tpu_torch.models.fsg import FsgModel
from cmusphinx_tpu_torch.models.jsgf import JsgfGrammar
from cmusphinx_tpu_torch.ops import ContinuousScorer
from cmusphinx_tpu_torch.utils.bio import write_mfc

PUSH = 37


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The search is many small ops a frame: intra-op threads only contend
    with the other test workers.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Identity:
    """A scorer whose "features" are the senone scores themselves."""

    def score(self, x):
        return x


@pytest.fixture(scope="module")
def small():
    return _scored(fixture.build(0, size=fixture.SMALL))


@pytest.fixture(scope="module")
def medium():
    return _scored(fixture.build(0, size=fixture.MEDIUM))


def _scored(fx):
    """The fixture and each utterance's senone scores (the port's CPU
    scorer on its CPU features)."""
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    sc = ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu")
    return fx, [sc.score(torch.as_tensor(fp.compute(c))).numpy()
                for c in fx.ceps]


def _cfg_text(fx):
    lines = ["1.0 $START 1 $SENT"]
    for t in fixture.grammar_parts(fx)[0]:
        lines.append(f"1.0 $SENT {len(t)} " + " ".join(t))
    return "\n".join(lines) + "\n"


def _srgs_text(fx):
    items = "".join(f"<item>{' '.join(t)}</item>"
                    for t in fixture.grammar_parts(fx)[0])
    return ('<?xml version="1.0"?>\n<grammar xmlns="http://www.w3.org/2001/'
            '06/grammar" version="1.0" root="utt">\n<rule id="utt" '
            f'scope="public"><one-of>{items}</one-of></rule>\n</grammar>\n')


def _grammars(kind, fx, tmp):
    """(the port's FsgModel, the reference's) for one kind of grammar,
    each from its own package's reader."""
    if kind == "fsg":
        buf = io.StringIO()
        fixture.grammar_fsg(fx).write(buf)
        return (FsgModel.read_fp(io.StringIO(buf.getvalue())),
                JaxFsgModel.read_fp(io.StringIO(buf.getvalue())))
    if kind == "jsgf":
        text = fixture.grammar_jsgf(fx)
        return (JsgfGrammar.parse(text).build_fsg(),
                JaxJsgf.parse(text).build_fsg())
    if kind == "cfg":
        path = os.path.join(tmp, "g.cfg")
        with open(path, "w") as fh:
            fh.write(_cfg_text(fx))
        return Cfg.read_simple(path).to_fsg(), JaxCfg.read_simple(path).to_fsg()
    text = _srgs_text(fx)
    return Cfg.parse_srgs(text).to_fsg(), JaxCfg.parse_srgs(text).to_fsg()


def _searches(fx, kind, tmp, **kw):
    port, ref = _grammars(kind, fx, tmp)
    ts = FsgSearch(port, fx.dict, fx.mdef, fx.tmat, Identity(), device="cpu",
                   **kw)
    js = JaxFsg(ref, fx.dict, fx.mdef, fx.tmat, Identity(), **kw)
    assert ts.n_link == js.n_link and ts.words == js.words
    return ts, js


def _same(h, j):
    assert h.words == j.words
    assert [(s.word, s.start_frame, s.end_frame) for s in h.segments] == \
        [(s.word, s.start_frame, s.end_frame) for s in j.segments]
    assert h.score == pytest.approx(j.score, rel=1e-5)


def assert_exits_match(got, want):
    """(wex, wexh, wexsil, exv[, T]) of the port against the reference's."""
    for name, a, b in zip(("wex", "wexh", "wexsil", "exv"), got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=name)
        else:
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("kind,size", [("fsg", "small"), ("jsgf", "small"),
                                       ("cfg", "small"), ("srgs", "small"),
                                       ("fsg", "medium")])
def test_fsg_search_matches_reference(kind, size, request, tmp_path):
    fx, scores = request.getfixturevalue(size)
    ts, js = _searches(fx, kind, str(tmp_path))
    assert ts.graph.n_chan == js.graph.n_chan and not ts.prune
    np.testing.assert_array_equal(ts._W_np, np.asarray(js._W))
    np.testing.assert_array_equal(ts._ent0, js._ent0)
    for i, sc in enumerate(scores):
        h = ts.decode(torch.as_tensor(sc))
        _same(h, js.decode(sc))
        assert_exits_match(ts._last, js._last)
        assert ts._last[4] == js._last[4] == len(sc)
        # The grammar accepts the transcript, and the search finds it
        # (the loop's words are the vocabulary's too).
        assert h.words == fx.transcripts[i]
    assert ts.decode(torch.zeros((0, scores[0].shape[1]))).words == []


def test_fsg_search_pruned_matches_reference(small, tmp_path):
    """With the beam on (the Decoder's default, from NGRAM_ARGS)."""
    fx, scores = small
    ts, js = _searches(fx, "jsgf", str(tmp_path), prune=True, beam=1e-30)
    assert ts.prune
    for sc in scores:
        _same(ts.decode(torch.as_tensor(sc)), js.decode(sc))
        assert_exits_match(ts._last, js._last)


def test_fsg_lattice_matches_reference(small, tmp_path):
    fx, scores = small
    ts, js = _searches(fx, "jsgf", str(tmp_path))
    for i, sc in enumerate(scores):
        ts.decode(torch.as_tensor(sc))
        js.decode(sc)
        lat, jlat = ts.get_lattice(), js.get_lattice()
        assert lat.nodes == jlat.nodes and len(lat.nodes) > 100
        assert lat.edge_w.keys() == jlat.edge_w.keys()
        np.testing.assert_allclose(list(lat.edge_w.values()),
                                   list(jlat.edge_w.values()), rtol=1e-5)
        np.testing.assert_array_equal(lat.alive, jlat.alive)
        bp = lat.bestpath()
        _same(bp, jlat.bestpath())
        assert bp.words == fx.transcripts[i]
        nb, jnb = lat.nbest(5), jlat.nbest(5)
        assert [h.words for h in nb] == [h.words for h in jnb]
        for a, b in zip(nb, jnb):
            _same(a, b)
        assert nb[0].score == pytest.approx(bp.score, rel=1e-6)
        post, jpost = lat.posterior(), jlat.posterior()
        fin = np.isfinite(jpost)
        np.testing.assert_array_equal(np.isfinite(post), fin)
        np.testing.assert_allclose(post[fin], jpost[fin], rtol=1e-6, atol=1e-6)
        lat.write(str(tmp_path / "port.lat"))
        jlat.write(str(tmp_path / "jax.lat"))
        assert (tmp_path / "port.lat").read_text() == \
            (tmp_path / "jax.lat").read_text()


def test_fsg_stream_matches_reference(small, tmp_path):
    """Partials after every 37-frame push and the final, against the
    reference's stream and the port's whole-utterance decode."""
    fx, scores = small
    ts, js = _searches(fx, "fsg", str(tmp_path))
    for i, sc in enumerate(scores):
        tst, jst = ts.stream_start(), js.stream_start()
        assert ts.stream_partial(tst).words == []
        for k in range(0, len(sc), PUSH):
            ts.stream_push(tst, sc[k: k + PUSH])
            js.stream_push(jst, sc[k: k + PUSH])
            assert tst["t"] == jst["t"]
            _same(ts.stream_partial(tst), js.stream_partial(jst))
        final = ts.stream_end(tst)
        _same(final, js.stream_end(jst))
        assert_exits_match(ts._last, js._last)
        assert final.words == fx.transcripts[i]
        _same(final, ts.decode(torch.as_tensor(sc)))
    with pytest.raises(ValueError, match="max_frames"):
        ts.stream_push(ts.stream_start(max_frames=10), scores[0][:60])


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, small):
    fx, _ = small
    root = tmp_path_factory.mktemp("grammar")
    kw = fixture.write_model_dir(fx, str(root))
    mfcs = []
    for i, c in enumerate(fx.ceps):
        mfcs.append(str(root / f"u{i}.mfc"))
        write_mfc(mfcs[-1], c)
    with open(root / "g.cfg", "w") as fh:
        fh.write(_cfg_text(fx))
    with open(root / "g.srgs", "w") as fh:
        fh.write(_srgs_text(fx))
    return fx, kw, mfcs, root


@pytest.mark.parametrize("key", ["fsg", "jsgf", "srgs", "cfg"])
def test_decoder_grammar_matches_reference(model_dir, key):
    """The Decoder picks the grammar search and, as the reference's does,
    takes `prune` (True) from NGRAM_ARGS, registered before FSG_ARGS,
    where FsgSearch alone defaults it to False."""
    fx, kw, mfcs, root = model_dir
    path = str(root / {"fsg": "grammar.fsg", "jsgf": "grammar.jsgf",
                       "srgs": "g.srgs", "cfg": "g.cfg"}[key])
    g = {"hmm": kw["hmm"], "dict": kw["dict"], key: path}
    td, jd = Decoder(device="cpu", **g), JaxDecoder(**g)
    assert isinstance(td.search, FsgSearch)
    assert td.search.prune is True
    assert bool(jd.search.config["prune"]) is True
    assert [a.default for a in FSG_ARGS if a.name == "prune"] == [False]
    for path, words in zip(mfcs, fx.transcripts):
        got = td.decode_cep_file(path)
        _same(got, jd.decode_cep_file(path))
        assert got.words == words
    lat, jlat = td.get_lattice(), jd.get_lattice()
    _same(lat.bestpath(), jlat.bestpath())
    assert [h.words for h in lat.nbest(3)] == [h.words for h in jlat.nbest(3)]


def test_decoder_search_selection_order(model_dir):
    """-allphone before -fsg before -jsgf before -srgs/-cfg before -lm, as
    the reference chooses (ps_reinit)."""
    fx, kw, mfcs, root = model_dir
    base = {"hmm": kw["hmm"], "dict": kw["dict"], "lm": kw["lm"]}
    fsg, jsgf = str(root / "grammar.fsg"), str(root / "grammar.jsgf")
    for extra in ({"jsgf": jsgf, "fsg": fsg}, {"jsgf": jsgf},
                  {"cfg": str(root / "g.cfg")}):
        td, jd = Decoder(device="cpu", **base, **extra), JaxDecoder(**base,
                                                                    **extra)
        assert type(td.search).__name__ == type(jd.search).__name__ == \
            "FsgSearch"
        assert td.search.n_link == jd.search.n_link
        assert td.search.n_state == jd.search.n_state
    td = Decoder(device="cpu", allphone="uniform", **base, jsgf=jsgf)
    assert type(td.search).__name__ == "NgramSearch"
    assert td.search.vocab.n_word < 20
