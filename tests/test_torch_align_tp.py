"""Port parity for the time-parallel forced alignment
(`decode/align_tp.py`: `align_time_parallel`, `_pred_table`) against the
JAX package and the port's sequential `AlignSearch.align`, on the seeded
SMALL fixture.

Tolerances: fed the same senone scores (an identity scorer), the score
equals the reference's `align_time_parallel` exactly (max and one f32
addition a term on both sides, the same float64 combine) and the
sequential aligner's within rtol 4 T 2^-24 (the chunks add the same terms
in another grouping: 2T float32 additions a side, each within half an ulp
of a partial sum no larger than |score|); the states equal the
reference's, and the sequential aligner's but for ties: a path that
differs must score, re-summed on the host in float64, within that bound of
the sequential score.  The chunks split over two CPU devices (`devices`)
give the same result.
"""

import numpy as np
import pytest
import torch

from cmusphinx_tpu.decode import align_tp as jalign_tp
from cmusphinx_tpu.decode.align import AlignSearch as JaxAlign
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.decode import align_tp
from cmusphinx_tpu_torch.decode.align import AlignSearch
from cmusphinx_tpu_torch.frontend import FeatPipeline
from cmusphinx_tpu_torch.ops import ContinuousScorer
from test_torch_grammar import Identity


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
    sc = ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu")
    scores = [sc.score(torch.as_tensor(fp.compute(c))).numpy()
              for c in fx.ceps]
    # The three utterances joined into one, with their transcripts.
    scores.append(np.concatenate(scores))
    words = fx.transcripts + [sum(fx.transcripts, [])]
    return fx, scores, words


def path_score(built, scores, states) -> float:
    """A state path's own score, re-summed on the host in float64."""
    (ss, sv, _, _, M, entry_lp, fexit, _, _) = built
    ll = np.where(sv[None], scores[:, ss], -1e30).astype(np.float64)
    tot = entry_lp[states[0]] + ll[0, states[0]]
    for t in range(1, len(states)):
        tot += M[states[t - 1], states[t]] + ll[t, states[t]]
    return float(tot + fexit[states[-1]])


def test_pred_table_matches_reference(small):
    fx, _, words = small
    M = AlignSearch(fx.dict, fx.mdef, fx.tmat, Identity(),
                    device="cpu")._build(words[-1])[4]
    for a, b in zip(align_tp._pred_table(M), jalign_tp._pred_table(M)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_chunks", [1, 3, 8])
def test_time_parallel_matches_reference_and_sequential(small, n_chunks):
    fx, scores, words = small
    ta = AlignSearch(fx.dict, fx.mdef, fx.tmat, Identity(), device="cpu")
    ja = JaxAlign(fx.dict, fx.mdef, fx.tmat, Identity())
    for sc, w in zip(scores, words):
        states, score = align_tp.align_time_parallel(
            ta, torch.as_tensor(sc), w, n_chunks=n_chunks)
        jstates, jscore = jalign_tp.align_time_parallel(ja, sc, w,
                                                        n_chunks=n_chunks)
        assert score == jscore
        np.testing.assert_array_equal(states, jstates)
        assert states.dtype == np.int64 and len(states) == len(sc)
        _, _, seq, seq_score = ta.align(torch.as_tensor(sc), w)
        rel = 4 * len(sc) * 2.0 ** -24
        assert score == pytest.approx(seq_score, rel=rel)
        if list(states) != seq:
            assert path_score(ta._build(w), sc, states) == pytest.approx(
                seq_score, rel=rel)


def test_time_parallel_over_two_devices(small):
    fx, scores, words = small
    ta = AlignSearch(fx.dict, fx.mdef, fx.tmat, Identity(), device="cpu")
    sc, w = scores[-1], words[-1]
    one = align_tp.align_time_parallel(ta, torch.as_tensor(sc), w,
                                       n_chunks=5)
    two = align_tp.align_time_parallel(ta, torch.as_tensor(sc), w,
                                       n_chunks=5,
                                       devices=["cpu", torch.device("cpu")])
    np.testing.assert_array_equal(one[0], two[0])
    assert one[1] == two[1]
    # More devices than chunks: the spare ones take none.
    three = align_tp.align_time_parallel(ta, torch.as_tensor(sc[:4]), w[:1],
                                         n_chunks=8, devices=["cpu"] * 5)
    want = jalign_tp.align_time_parallel(
        JaxAlign(fx.dict, fx.mdef, fx.tmat, Identity()), sc[:4], w[:1],
        n_chunks=8)
    np.testing.assert_array_equal(three[0], want[0])
    assert three[1] == want[1]
