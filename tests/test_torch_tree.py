"""Port parity for the prefix-tree lexicon (`TreeStep`,
`_setup_tree_bgla`, `_bgla_rows`) against the JAX package on the MEDIUM
fixture: the batched path against the reference's `_make_core_tree_batched`
and one utterance against its unbatched one-copy `_make_core_tree`, with
the bigram lookahead (`treela=bg`) and without (`ug`); the exit shortlist
scored through the hashed LM tables.  And the `Decoder` with
`lexmode=tree` against the JAX `Decoder` on a MEDIUM model directory.
Tolerances as in test_torch_static."""

import dataclasses

import numpy as np
import pytest
import torch

from cmusphinx_tpu.api import Decoder as JaxDecoder
from cmusphinx_tpu.decode.ngram_search import NgramSearch as JaxSearch
from cmusphinx_tpu.frontend.feat import FeatPipeline as JaxFeat
from cmusphinx_tpu.ops.gmm import ContinuousScorer as JaxScorer
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.utils.bio import write_mfc
from cmusphinx_tpu_torch.api import Decoder
from cmusphinx_tpu_torch.decode import NgramSearch
from cmusphinx_tpu_torch.decode.ngram_steps import TreeCopiesStep, TreeStep
from cmusphinx_tpu_torch.frontend import FeatPipeline
from cmusphinx_tpu_torch.ops import ContinuousScorer
from test_torch_ngram_search import (assert_hyps_match,
                                     assert_search_matches_reference)

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The decode is many small ops a frame: intra-op threads only contend
    with the other test workers.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def medium():
    return fixture.build(0, size=fixture.MEDIUM)


@pytest.mark.parametrize("treela", ["bg", "ug"])
def test_tree_search_matches_reference(medium, treela):
    fx = medium
    js = JaxSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                   JaxScorer(fx.gauden, fx.ln_mixw, use_pallas=False),
                   lexmode="tree", treela=treela)
    ts = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                     ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu"),
                     device="cpu", lexmode="tree", treela=treela)
    g = ts.graph
    assert (g.rc_mode, g.lc_mode, g.lex_mode) == ("composite", "composite",
                                                  "tree")
    st = ts.step
    assert isinstance(st, TreeStep)
    assert g.exit_base >= 0 and st.use_bgla == (treela == "bg")
    assert st._n_roots == js._n_roots
    np.testing.assert_array_equal(st._entc0.numpy(), np.asarray(js._entc0))
    np.testing.assert_array_equal(st._la_delta_c.numpy(),
                                  np.asarray(js._la_delta_c))
    if st.use_bgla:
        np.testing.assert_array_equal(st._corr0.numpy(),
                                      np.asarray(js._corr0_j))
        assert st._bgla_maxrow == js._bgla_maxrow > 0
    jfp, fp = JaxFeat(fx.feat_config()), FeatPipeline(fx.feat_config(),
                                                      device="cpu")
    hyps, _ = assert_search_matches_reference(fx, js, ts, jfp, fp)
    assert ts.dlm.calls["hashed"] > 0 and ts.dlm.calls["rows"] == 0
    assert [h.words for h in hyps] == fx.transcripts
    # The utterances cut into their leading silence: words entered at
    # frame 0 exit with the initial (<s>, -1) history, so their smear is
    # cancelled through the <s> correction row `_corr0`.
    cut = dataclasses.replace(fx, ceps=[c[12:] for c in fx.ceps])
    _, (tw, _, tprev, *_) = assert_search_matches_reference(cut, js, ts,
                                                            jfp, fp)
    initial = (tprev == -1) & (tw >= 0)
    assert (initial & ~ts.vocab.is_filler[np.maximum(tw, 0)]).sum() > 10


@pytest.mark.parametrize("n", [2, 3])
def test_tree_copies_match_reference(medium, n):
    """N tree copies (`nlextree`, `TreeCopiesStep`): the batch and one
    utterance against the reference's N-copy `_make_core_tree`, tapes,
    chase arrays and hypotheses."""
    fx = medium
    kw = {"lexmode": "tree", "nlextree": n}
    js = JaxSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                   JaxScorer(fx.gauden, fx.ln_mixw, use_pallas=False), **kw)
    ts = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                     ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu"),
                     device="cpu", **kw)
    assert ts.nlextree == js.nlextree == n and ts.step.use_bgla
    assert isinstance(ts.step, TreeCopiesStep)
    jfp, fp = JaxFeat(fx.feat_config()), FeatPipeline(fx.feat_config(),
                                                      device="cpu")
    hyps, (tw, *_) = assert_search_matches_reference(fx, js, ts, jfp, fp)
    assert [h.words for h in hyps] == fx.transcripts
    # The copies hold distinct histories: the carry has N of them.
    assert ts.step.init_carry(1, 100)[0].shape[1] == n


def test_tree_decoder_matches_reference(medium, tmp_path):
    fx = medium
    kw = fixture.write_model_dir(fx, str(tmp_path))
    td = Decoder(device="cpu", lexmode="tree", **kw)
    jd = JaxDecoder(lexmode="tree", **kw)
    assert td.search.graph.lex_mode == jd.search.graph.lex_mode == "tree"
    for i, c in enumerate(fx.ceps):
        path = str(tmp_path / f"u{i}.mfc")
        write_mfc(path, c)
        got = td.decode_cep_file(path)
        assert_hyps_match([got], [jd.decode_cep_file(path)])
        assert got.words == fx.transcripts[i]
