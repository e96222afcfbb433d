"""Port parity for the multiplexed-left-context search (`MpxStep`) on the
large-vocabulary graphs of the MEDIUM fixture, whose LM is above the
dense-table limit: composite right contexts with mpx left contexts (the
composite xs rows of `_xs_rows`), and the fanout/mpx graph, both taking
their cross-word LM scores from `score_rows`.  Tolerances as in
test_torch_static."""

import pytest
import torch

from cmusphinx_tpu.decode.ngram_search import NgramSearch as JaxSearch
from cmusphinx_tpu.frontend.feat import FeatPipeline as JaxFeat
from cmusphinx_tpu.ops.gmm import ContinuousScorer as JaxScorer
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.decode import NgramSearch
from cmusphinx_tpu_torch.decode.ngram_steps import MpxStep
from cmusphinx_tpu_torch.frontend import FeatPipeline
from cmusphinx_tpu_torch.ops import ContinuousScorer
from test_torch_ngram_search import assert_search_matches_reference

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


@pytest.mark.parametrize("rc", ["composite", "fanout"])
def test_mpx_search_over_sparse_lm_matches_reference(medium, rc):
    fx = medium
    js = JaxSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                   JaxScorer(fx.gauden, fx.ln_mixw, use_pallas=False),
                   rcmode=rc, lcmode="mpx")
    ts = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                     ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu"),
                     device="cpu", rcmode=rc, lcmode="mpx")
    g = ts.graph
    assert (g.rc_mode, g.lc_mode, g.lex_mode) == (rc, "mpx", "flat")
    assert isinstance(ts.step, MpxStep)
    assert (g.n_xs > g.n_sing) == (rc == "composite")
    assert ts.dlm.tg_dense is None
    hyps, _ = assert_search_matches_reference(
        fx, js, ts, JaxFeat(fx.feat_config()),
        FeatPipeline(fx.feat_config(), device="cpu"), single=2)
    assert ts.dlm.calls["rows"] > 0
    assert [h.words for h in hyps] == fx.transcripts
