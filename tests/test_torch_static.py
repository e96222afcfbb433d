"""Port parity for the static-senone search (composite left contexts, flat
lexicon: `StaticStep`, `score_rows`) against the JAX
package on the MEDIUM fixture (1,200 words, an LM above the dense-table
limit), with the reference scoring through `ContinuousScorer(use_pallas=
False)`: both the batched path (`decode_batch_cep`) and one utterance
through `decode`.  Integer tapes, chase arrays and hypotheses must be
equal; float tapes (`tsc`, `trc`) within rtol 1e-5 (the two packages sum
float32 senone scores in another order; see test_torch_ngram_search).

Also: `topk2` on both of its paths, the `auto` mode choice, and that no
search holds a [W, W] table."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmusphinx_tpu.decode.ngram_search import NgramSearch as JaxSearch
from cmusphinx_tpu.decode.ngram_search import topk2 as jax_topk2
from cmusphinx_tpu.frontend.feat import FeatPipeline as JaxFeat
from cmusphinx_tpu.ops.gmm import ContinuousScorer as JaxScorer
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.decode import NgramSearch
from cmusphinx_tpu_torch.decode.ngram_search import topk2
from cmusphinx_tpu_torch.decode.ngram_steps import StaticStep
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
    fx = fixture.build(0, size=fixture.MEDIUM)
    return dict(fx=fx, jsc=JaxScorer(fx.gauden, fx.ln_mixw, use_pallas=False),
                jfp=JaxFeat(fx.feat_config()),
                sc=ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu"),
                fp=FeatPipeline(fx.feat_config(), device="cpu"))


def _searches(m, **modes):
    fx = m["fx"]
    return (JaxSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, m["jsc"], **modes),
            NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, m["sc"],
                        device="cpu", **modes))


@pytest.mark.parametrize("modes,rc", [({}, "composite"),
                                      ({"rcmode": "fanout",
                                        "lcmode": "composite"}, "fanout")])
def test_static_search_matches_reference(medium, modes, rc):
    js, ts = _searches(medium, **modes)
    g = ts.graph
    assert (g.rc_mode, g.lc_mode, g.lex_mode) == (rc, "composite", "flat")
    assert isinstance(ts.step, StaticStep)
    assert (g.n_rcvar > 1) == (rc == "fanout")
    assert ts.dlm.tg_dense is None and js.dlm.tg_dense is None
    hyps, _ = assert_search_matches_reference(medium["fx"], js, ts,
                                           medium["jfp"], medium["fp"])
    assert ts.dlm.calls["rows"] > 0
    assert [h.words for h in hyps] == medium["fx"].transcripts


def test_auto_picks_the_reference_modes(medium):
    fx = medium["fx"]
    js, ts = _searches(medium)
    got = (ts.graph.rc_mode, ts.graph.lc_mode, ts.graph.lex_mode)
    assert got == (js.graph.rc_mode, js.graph.lc_mode, js.graph.lex_mode) \
        == ("composite", "composite", "flat")
    assert ts.E == js.E and ts.step._chain_shift == js._chain_shift
    assert (ts.dlm.probe, ts.dlm.hashed) == (js.dlm.probe, js.dlm.hashed) \
        == (False, True)
    # Below 1000 words: fanout + mpx; tree needs composite contexts.
    small = fixture.build(0, size=fixture.SMALL)
    s = NgramSearch(small.lm, small.dict, small.mdef, small.tmat, medium["sc"],
                    device="cpu")
    assert (s.graph.rc_mode, s.graph.lc_mode, s.graph.lex_mode) == \
        ("fanout", "mpx", "flat")
    with pytest.raises(ValueError, match="composite"):
        NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat, medium["sc"],
                    device="cpu", rcmode="fanout", lexmode="tree")


def test_no_search_holds_a_word_by_word_table(medium):
    for modes in ({}, {"rcmode": "fanout", "lcmode": "mpx"}):
        _, ts = _searches(medium, **modes)
        W = ts.vocab.n_word
        shapes = [tuple(b.shape) for b in ts.buffers()]
        assert shapes and (W, W) not in shapes, modes


def _topk_case(rng, lead, M, k, bs):
    """Scores on a coarse grid, so values tie within and across blocks, and
    the k-th value spread over more than k blocks."""
    x = rng.choice(np.array([-3.0, -2.0, -1.0, 0.0, -1e30], np.float32),
                   lead + (M,)).astype(np.float32)
    nb = -(-M // bs)
    x[..., ::bs] = 0.5                        # one tied maximum in every block
    x[..., (nb - 1) * bs:] = -1e30            # a ragged all-masked last block
    return x


@pytest.mark.parametrize("M,k", [(300, 8), (5000, 4), (20000, 32),
                                 (70001, 128)])
def test_topk2_matches_reference(M, k):
    rng = np.random.RandomState(M)
    x = _topk_case(rng, (3,), M, k, 128)
    two_stage = M > 4 * k * 128
    assert two_stage == (M in (5000, 20000, 70001))
    jv, ji = jax_topk2(jnp.asarray(x), k)
    tv, ti = topk2(torch.as_tensor(x), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if two_stage:
        assert (x[0] == 0.5).sum() > k        # the k-th value ties


def test_topk2_takes_tied_values_in_block_index_order():
    """The selected blocks are re-ranked in index order: the last of the
    top-5 values, a 0.0 tied in five blocks, comes from the lowest block,
    not from the block with the largest maximum."""
    x = np.full((1, 5000), -5.0, np.float32)
    for blk, top in ((10, 3.0), (2, 2.0), (7, 1.0), (12, 0.5)):
        x[0, blk * 128] = top
        x[0, blk * 128 + 1: blk * 128 + 40] = 0.0
    x[0, 128 + 5] = 0.0                       # block 1: its maximum is 0.0
    jv, ji = jax_topk2(jnp.asarray(x), 5)
    tv, ti = topk2(torch.as_tensor(x), 5)
    assert ti.tolist() == np.asarray(ji).tolist() == \
        [[1280, 256, 896, 1536, 133]]
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
