"""Port parity for the approximate scorers (`ops/approx.py`:
`DownsampledScorer`, `CigmmsScorer`, `GsSelectorScorer`,
`KdTreeSelectorScorer`) against the JAX package on the seeded SMALL
fixture, and for decodes through them.

Tolerances:
- scores: two f32 evaluations of the same densities that differ only in
  the order of their sums, within D * 2^-22 * M[t, s] (M: the magnitude
  of the terms that cancel, max_k |const| + |x|.|lin| + x^2.quad; as
  tests/test_torch_gmm.py);
- integers equal: the selector's VQ assignment and centroids (host
  float64, blocked by rows), the kd-tree's nodes, leaf shortlists and each
  frame's leaf, and the frames' kept clusters (counted, and held at 0
  differences on this fixture; scores are compared where they agree);
- decodes through `DownsampledScorer`: tapes as tests/test_torch_ngram_search
  (integers equal, floats within rtol 1e-5), hypotheses equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmusphinx_tpu.decode.ngram_search import NgramSearch as JaxSearch
from cmusphinx_tpu.frontend.feat import FeatPipeline as JaxFeat
from cmusphinx_tpu.ops import approx as japprox
from cmusphinx_tpu.ops.gmm import ContinuousScorer as JaxScorer
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.decode import NgramSearch
from cmusphinx_tpu_torch.frontend import FeatPipeline
from cmusphinx_tpu_torch.ops import ContinuousScorer, approx
from test_torch_ngram_search import assert_hyps_match, assert_tapes_match
from test_torch_stream import PUSH, _same, assert_flat_tapes_match


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
    x = np.concatenate([fp.compute(c) for c in fx.ceps])
    return fx, x


def scorers(fx, precision="highest"):
    return (ContinuousScorer(fx.gauden, fx.ln_mixw, precision=precision,
                             device="cpu"),
            JaxScorer(fx.gauden, fx.ln_mixw, use_pallas=False,
                      precision=precision))


def magnitude(x, sc):
    """M[t, s] of a ContinuousScorer's parameters, float64."""
    S, K = sc.n_sen, sc.n_density
    lin = sc.lin.double().reshape(S * K, -1).numpy()
    quad = sc.quad.double().reshape(S * K, -1).numpy()
    const = sc.const.double().reshape(1, S * K).numpy()
    x = x.astype(np.float64)
    return (np.abs(const) + np.abs(x) @ np.abs(lin).T + (x * x) @ quad.T
            ).reshape(len(x), S, K).max(-1)


def assert_scores_close(got, want, x, sc, rows=None):
    bound = x.shape[1] * 2.0 ** -22 * magnitude(x, sc)
    err = np.abs(got.astype(np.float64) - want)
    if rows is not None:
        err, bound = err[rows], bound[rows]
    assert np.all(err <= bound), float((err / bound).max())


def test_downsampled_and_cigmms_match_reference(small):
    fx, x = small
    sc, js = scorers(fx)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    for ds in (1, 2, 3):
        tds, jds = approx.DownsampledScorer(sc, ds), \
            japprox.DownsampledScorer(js, ds)
        got = tds.score(xt).numpy()
        assert got.shape == (len(x), fx.size.n_sen)
        assert_scores_close(got, np.asarray(jds.score(xj)), x, sc)
        # Every utterance of a batch starts its own phase: [B, T, D] acts
        # on dim -2, each row as if alone.
        b = torch.as_tensor(np.stack([x[:100], x[50:150]]))
        rows = tds.score(b)
        for i in range(2):
            np.testing.assert_array_equal(rows[i].numpy(),
                                          tds.score(b[i]).numpy())
    with pytest.raises(ValueError):
        approx.DownsampledScorer(sc, 0)
    m = fx.mdef
    for beam in (3.0, 7.0):
        tc = approx.CigmmsScorer(sc, m.cd2cisen, m.n_ci_sen, beam,
                                 device="cpu")
        jc = japprox.CigmmsScorer(js, m.cd2cisen, m.n_ci_sen, beam)
        got, want = tc.score(xt).numpy(), np.asarray(jc.score(xj))
        assert_scores_close(got, want, x, sc)
        # The bypass took effect, the same senones in both.
        plain = sc.score(xt).numpy()
        bypassed = got != plain
        assert bypassed.any()
        np.testing.assert_array_equal(bypassed,
                                      want != np.asarray(js.score(xj)))
        b = torch.as_tensor(np.stack([x[:60], x[60:120]]))
        np.testing.assert_array_equal(tc.score(b)[1].numpy(),
                                      tc.score(b[1]).numpy())


def _jax_clusters(jg, x):
    """The reference's kept clusters a frame (its `score`'s first lines)."""
    xx = jnp.asarray(x)[:, : jg._D]
    d2 = ((xx[:, None, :] - jg._cent[None]) ** 2).sum(-1)
    thr = -jax.lax.top_k(-d2, jg.top_c)[0][:, -1:]
    return np.asarray(d2 <= thr)


@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_gs_selector_matches_reference(small, precision, monkeypatch):
    fx, x = small
    sc, js = scorers(fx, precision)
    # Blocks of 7 rows: the blocked distances give the reference's
    # assignment and centroids.
    monkeypatch.setattr(approx, "_KMEANS_ROWS", 7)
    for top_c in (1, 2):
        tg = approx.GsSelectorScorer(sc, fx.gauden, n_clusters=16,
                                     top_c=top_c, seed=3, device="cpu")
        jg = japprox.GsSelectorScorer(js, fx.gauden, n_clusters=16,
                                      top_c=top_c, seed=3)
        np.testing.assert_array_equal(tg.assign.numpy(),
                                      np.asarray(jg._assign))
        np.testing.assert_array_equal(tg.cent.numpy(), np.asarray(jg._cent))
        keep = tg.clusters(torch.as_tensor(x)).numpy()
        want_keep = _jax_clusters(jg, x)
        differ = (keep != want_keep).any(1)
        assert not differ.any(), int(differ.sum())
        got = tg.score(torch.as_tensor(x)).numpy()
        want = np.asarray(jg.score(jnp.asarray(x)))
        assert_scores_close(got, want, x, sc, rows=~differ)
    # A codebook given skips the k-means.
    again = approx.GsSelectorScorer(
        sc, fx.gauden, top_c=2, codebook=(tg.assign.numpy(),
                                          tg.cent.numpy()), device="cpu")
    np.testing.assert_array_equal(again.score(torch.as_tensor(x)).numpy(),
                                  got)


def _jax_leaves(jk, x):
    idx = np.ones(len(x), np.int64)
    nd, nt = np.asarray(jk._node_dim), np.asarray(jk._node_thr)
    for _ in range(jk.depth):
        idx = 2 * idx + (x[np.arange(len(x)), nd[idx]] > nt[idx])
    return idx - jk._n_nodes


@pytest.mark.parametrize("kw", [{"depth": 4, "radius": 1.5},
                                {"depth": 3, "radius": 1e6, "maxbbi": 7},
                                {"depth": 5, "radius": 2.0, "maxbbi": 60}])
def test_kdtree_selector_matches_reference(small, kw):
    fx, x = small
    sc, js = scorers(fx)
    tk = approx.KdTreeSelectorScorer(sc, fx.gauden, device="cpu", **kw)
    jk = japprox.KdTreeSelectorScorer(js, fx.gauden, **kw)
    np.testing.assert_array_equal(tk.node_dim.numpy(),
                                  np.asarray(jk._node_dim))
    np.testing.assert_array_equal(tk.node_thr.numpy(),
                                  np.asarray(jk._node_thr))
    np.testing.assert_array_equal(tk.leaf_keep.numpy(),
                                  np.asarray(jk._leaf_keep))
    leaves = tk.leaves(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(leaves, _jax_leaves(jk, x))
    assert len(set(leaves)) > 1
    got = tk.score(torch.as_tensor(x)).numpy()
    assert_scores_close(got, np.asarray(jk.score(jnp.asarray(x))), x, sc)
    if kw.get("maxbbi"):
        assert tk.leaf_keep.sum((1, 2)).max() <= kw["maxbbi"]
    # A tree given skips the build.
    again = approx.KdTreeSelectorScorer(
        sc, fx.gauden, depth=kw["depth"], tree=approx.bbi_tree(fx.gauden, **kw),
        device="cpu")
    np.testing.assert_array_equal(again.score(torch.as_tensor(x)).numpy(),
                                  got)
    b = torch.as_tensor(np.stack([x[:80], x[80:160]]))
    np.testing.assert_array_equal(tk.score(b)[1].numpy(),
                                  tk.score(b[1]).numpy())


def _searches(fx, ds):
    sc, js = scorers(fx)
    ts = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                     approx.DownsampledScorer(sc, ds), device="cpu")
    jsr = JaxSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                    japprox.DownsampledScorer(js, ds))
    return ts, jsr


def test_downsampled_batch_decode_matches_reference(small):
    fx, _ = small
    ts, jsr = _searches(fx, 2)
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    hyps = ts.decode_batch_cep(fx.ceps, fp)
    jhyps = jsr.decode_batch_cep(fx.ceps, JaxFeat(fx.feat_config()))
    assert_tapes_match([a.numpy() for a in ts._last_batch[0]],
                       [np.asarray(a) for a in jsr._last_batch[0]], ts.E)
    assert_hyps_match(hyps, jhyps)
    assert [h.words for h in hyps] == fx.transcripts


def test_downsampled_stream_matches_reference(small):
    """A ds=3 stream in 37-frame pushes: the scorer runs once a 50-frame
    chunk, so its phase restarts each chunk in both packages; the port's
    stream is held to the reference's stream.  The reference's own batch
    decode of the same features scores on another phase (ROADMAP C7): the
    port's batch is held to the reference's batch, and the two streams'
    tapes differ from the batches' from frame 50 on."""
    fx, _ = small
    ts, jsr = _searches(fx, 3)
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    E = ts.E
    feats = fp.compute(fx.ceps[1])
    T = len(feats)
    jst, tst = jsr.stream_start(), ts.stream_start()
    for i in range(0, T, PUSH):
        jsr.stream_push(jst, feats[i: i + PUSH])
        ts.stream_push(tst, feats[i: i + PUSH])
        _same(ts.stream_partial(tst), jsr.stream_partial(jst))
    final, jfinal = ts.stream_end(tst), jsr.stream_end(jst)
    _same(final, jfinal)
    stream = ts._last[:6]
    assert_flat_tapes_match(stream, [a[: T * E] for a in jsr._last[:6]], E)
    # The batches, each package's own, held to each other.
    batch, jbatch = ts.decode(feats), jsr.decode(feats)
    _same(batch, jbatch)
    btape = [a[0, : T * E].numpy() for a in ts._last_batch[0]]
    assert_flat_tapes_match(btape, [a[: T * E] for a in jsr._last[:6]], E)
    # C7: stream and batch agree on the first chunk, differ after it.
    first = 50 * E
    assert_flat_tapes_match([a[:first] for a in stream],
                            [a[:first] for a in btape], E)
    assert any(not np.array_equal(a[first:], b[first:])
               for a, b in zip(stream, btape))
