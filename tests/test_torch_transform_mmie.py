"""Port parity for the transforms (`train/transform.py`), MMIE
(`train/mmie.py`) and VTLN (`train/vtln.py`) against the JAX package, on
the inputs of tests/test_transform_mmie.py and tests/test_vtln.py.

Tolerances: LDA, `map_adapt`, `deleted_interpolation`, `mixw_interp`,
`ebw_update` and `lattice_den_batch` equal (numpy copies); MLLT's A
(Adam over autograd against optax over jax.grad, float32) within atol 1e-3
row by row once each row is scaled to unit length, and the objective of
each package at each A (identity, the reference's, the port's) within rtol
1e-5.  The objective does not change when a row of A is scaled (log|det A|
gains log s, each class's diagonal entry s^2), and Adam turns the float32
noise of the gradient along those directions into steps of the learning
rate's size: the rows' lengths drift apart (0.4 % in 300 steps at lr
5e-3) while their directions and the objective agree.  The MMIE objective
within rtol 1e-5 and its accumulators as tests/test_torch_train.py holds
them; VTLN the same best warp with per-warp totals within rtol 1e-5 (each
package aligning against a template from its own frontend).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmusphinx_tpu.frontend.fe import FE_ARGS as J_FE_ARGS
from cmusphinx_tpu.frontend.feat import FEAT_ARGS as J_FEAT_ARGS
from cmusphinx_tpu.train import mmie as j_mmie
from cmusphinx_tpu.train import transform as j_tf
from cmusphinx_tpu.train import vtln as j_vtln
from cmusphinx_tpu.train.bw import pack_batch as j_pack_batch
from cmusphinx_tpu.train.sentence_hmm import FlatModel as JFlatModel
from cmusphinx_tpu.train.sentence_hmm import build_sentence_hmm as j_build
from cmusphinx_tpu.train.trainer import HmmParams as JHmmParams
from cmusphinx_tpu.utils.config import Config as JConfig
from cmusphinx_tpu_torch.convert import hmm_params_from_jax
from cmusphinx_tpu_torch.frontend.fe import FE_ARGS
from cmusphinx_tpu_torch.frontend.feat import FEAT_ARGS
from cmusphinx_tpu_torch.train import bw, mmie
from cmusphinx_tpu_torch.train import transform as t_tf
from cmusphinx_tpu_torch.train import vtln
from cmusphinx_tpu_torch.train.sentence_hmm import FlatModel
from cmusphinx_tpu_torch.train.trainer import HmmParams
from cmusphinx_tpu_torch.utils.config import Config
from test_torch_host import assert_same
from test_torch_train import assert_acc, port_batch
from test_transform_mmie import _toy_corpus as mmie_corpus
from test_transform_mmie import _two_class_data
from test_vtln import SR, _TemplateAligner, _tones

MLLT_ATOL, OBJ_RTOL, VTLN_RTOL = 1e-3, 1e-5, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # Many small torch ops: more intra-op threads only contend with the
    # other test workers.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def unit_rows(A):
    """A with each row scaled to unit length (the MLLT objective's
    invariance)."""
    A = np.asarray(A, np.float64)
    return A / np.linalg.norm(A, axis=1, keepdims=True)


def _rotated_stats():
    """tests/test_transform_mmie.py's MLLT data: two rotated diagonal
    classes; returns their scatter stats and covariances."""
    rng = np.random.default_rng(1)
    d = 3
    q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    feats, labels = [], []
    for c, scales in enumerate([[1.0, 0.2, 0.05], [0.1, 1.5, 0.3]]):
        x = rng.normal(size=(500, d)) * np.asarray(scales)
        feats.append((x @ q.T) + 3.0 * c)
        labels.append(np.full(500, c, np.int64))
    stats = j_tf.class_scatter_stats(np.concatenate(feats).astype(np.float32),
                                     np.concatenate(labels), 2)
    counts, sums, sqsums = stats
    mean_c = sums / counts[:, None]
    cov = (sqsums / counts[:, None, None]
           - np.einsum("ci,cj->cij", mean_c, mean_c))
    return stats, cov.astype(np.float32), counts.astype(np.float32)


def test_lda_and_scatter_stats_equal_reference():
    feats, labels = _two_class_data(np.random.default_rng(0))
    stats = j_tf.class_scatter_stats(feats, labels, 2)
    assert_same(stats, t_tf.class_scatter_stats(feats, labels, 2))
    assert_same(j_tf.estimate_lda(*stats, dim_out=2),
                t_tf.estimate_lda(*stats, dim_out=2))


def test_mllt_matches_reference():
    stats, cov, counts = _rotated_stats()
    want = j_tf.estimate_mllt(*stats, n_iter=300, lr=5e-3)
    got = t_tf.estimate_mllt(*stats, n_iter=300, lr=5e-3, device="cpu")
    assert got.dtype == np.float32 and got.shape == (3, 3)
    np.testing.assert_allclose(unit_rows(got), unit_rows(want),
                               atol=MLLT_ATOL)
    for A in (np.eye(3, dtype=np.float32), want, got):
        j_obj = float(j_tf.mllt_objective(jnp.asarray(A), jnp.asarray(cov),
                                          jnp.asarray(counts)))
        t_obj = float(t_tf.mllt_objective(torch.tensor(A),
                                          torch.as_tensor(cov),
                                          torch.as_tensor(counts)))
        np.testing.assert_allclose(t_obj, j_obj, rtol=OBJ_RTOL)
    # The estimate improves on the identity, as the reference's does.
    ident = float(t_tf.mllt_objective(torch.eye(3), torch.as_tensor(cov),
                                      torch.as_tensor(counts)))
    assert float(t_tf.mllt_objective(torch.as_tensor(got),
                                     torch.as_tensor(cov),
                                     torch.as_tensor(counts))) < ident - 1.0
    rng = np.random.RandomState(0)
    means = rng.randn(4, 2, 3).astype(np.float32)
    var = rng.rand(4, 2, 3).astype(np.float32) + 0.1
    assert_same(j_tf.apply_mllt_to_model(want, means, var),
                t_tf.apply_mllt_to_model(want, means, var))


def test_map_adapt_deleted_interpolation_mixw_interp_equal_reference():
    rng = np.random.RandomState(2)
    S, K, D = 3, 4, 5
    args = (rng.randn(S, K, D).astype(np.float32),
            rng.rand(S, K, D).astype(np.float32) + 0.5,
            np.log(rng.dirichlet(np.ones(K), S)).astype(np.float32),
            np.full((2, 3, 4), 0.25, np.float32))
    acc = {"mixw": rng.rand(S, K) * 20, "mean": rng.randn(S, K, D) * 10}
    for kw in ({"tau": 10.0}, {"tau": 3.0, "adapt_mixw": False}):
        assert_same(j_tf.map_adapt(JHmmParams(*args), acc, **kw),
                    t_tf.map_adapt(hmm_params_from_jax(*args), acc, **kw))
    cd = [rng.multinomial(300, rng.dirichlet(np.ones(K)), S).astype(float)
          for _ in range(3)]
    ci = [rng.multinomial(300, rng.dirichlet(np.ones(K)), S).astype(float)
          for _ in range(3)]
    sen2ci = np.asarray([0, 1, 0])
    assert_same(j_tf.deleted_interpolation(cd, ci, sen2ci),
                t_tf.deleted_interpolation(cd, ci, sen2ci))
    for lam in (0.3, np.asarray([0.1, 0.5, 0.9])):
        assert_same(j_tf.mixw_interp(cd[0], ci[0], lam),
                    t_tf.mixw_interp(cd[0], ci[0], lam))


@pytest.fixture(scope="module")
def mmie_case():
    """tests/test_transform_mmie.py's MMIE setup: numerator and
    denominator batches (every utterance against both words at weight
    0.5) and the perturbed start parameters."""
    rng = np.random.default_rng(3)
    model = JFlatModel.create(["A", "B", "SIL"], n_state=3)
    pron = {"aa": ["A"], "bb": ["B"]}
    true = JHmmParams(
        means=rng.normal(size=(model.n_sen, 1, 2)).astype(np.float32) * 3.0,
        var=np.ones((model.n_sen, 1, 2), np.float32) * 0.2,
        lnw=np.zeros((model.n_sen, 1), np.float32), tp=model.init_tmat())
    feats, trans = mmie_corpus(rng, model, pron, [["aa"], ["bb"]], true)
    start = JHmmParams(
        means=true.means + rng.normal(size=true.means.shape).astype(
            np.float32),
        var=np.ones_like(true.var), lnw=true.lnw, tp=true.tp)
    num = j_pack_batch([j_build(t, pron, model, optional_sil=False)
                        for t in trans], feats)
    den_h, den_f = [], []
    for f in feats:
        for w in ("aa", "bb"):
            den_h.append(j_build([w], pron, model, optional_sil=False))
            den_f.append(f)
    den = j_pack_batch(den_h, den_f)
    return num, den, np.full(len(den_h), 0.5, np.float32), start


def test_accumulate_mmie_and_ebw_match_reference(mmie_case, monkeypatch):
    num, den, w, start = mmie_case
    # The reference's passes compiled whole, as its Trainer runs them.
    monkeypatch.setattr(j_mmie, "forward_backward",
                        jax.jit(j_mmie.forward_backward))
    jn, jd, jobj = j_mmie.accumulate_mmie(num, den, w, start)
    port = HmmParams(start.means, start.var, start.lnw, start.tp)
    tn, td, tobj = mmie.accumulate_mmie(port_batch(num), port_batch(den), w,
                                        port, device="cpu")
    np.testing.assert_allclose(tobj, jobj, rtol=OBJ_RTOL)
    for got, want, batch in ((tn, jn, num), (td, jd, den)):
        rtol = bw.posterior_rtol(np.full(1, abs(jobj)), batch.feats.shape[1])
        for k in ("mixw", "mean", "var", "tmat"):
            assert_acc(got[k], want[k], rtol, k)
    # The EBW update is a numpy copy: equal on the same accumulators.
    assert_same(j_mmie.ebw_update(start, jn, jd, E=2.0),
                mmie.ebw_update(port, jn, jd, E=2.0))


def test_lattice_den_batch_equals_reference():
    class _Node:
        def __init__(self, word, sf, ef):
            self.word, self.sf, self.ef = word, sf, ef

    class _Lat:
        def __init__(self, nodes, post):
            self.nodes = nodes
            self._post = post

        def posterior(self, ascale):
            return np.log(self._post)

    pron = {"aa": ["A"], "bb": ["B"]}
    feats = np.random.default_rng(0).normal(size=(30, 2)).astype(np.float32)
    lat = _Lat([_Node("aa", 0, 9), _Node("bb", 5, 14),
                _Node("<sil>", 15, 20), _Node("aa", 10, 29)],
               np.asarray([0.9, 0.4, 0.5, 1e-6]))
    jb, jw = j_mmie.lattice_den_batch(
        lat, feats, pron, JFlatModel.create(["A", "B", "SIL"]))
    tb, tw = mmie.lattice_den_batch(
        lat, feats, pron, FlatModel.create(["A", "B", "SIL"]))
    np.testing.assert_array_equal(tw, jw)
    assert len(tw) == 3
    for k in jb.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(tb, k), getattr(jb, k), k)


def _cfgs():
    """The reference VTLN test's configuration in each package."""
    kw = dict(samprate=SR, dither=False, feat="1s_c_d_dd", cmn="none")
    j = JConfig(J_FE_ARGS, J_FEAT_ARGS)
    j.update(**kw)
    t = Config(FE_ARGS, FEAT_ARGS)
    t.update(**kw)
    return j, t


def test_vtln_matches_reference():
    from cmusphinx_tpu.frontend import Frontend as JFrontend
    from cmusphinx_tpu.frontend.feat import FeatPipeline as JFeat
    from cmusphinx_tpu_torch.frontend import FeatPipeline, Frontend
    jcfg, tcfg = _cfgs()
    base = [500.0, 1500.0, 2500.0]
    jal = _TemplateAligner(np.asarray(JFeat(jcfg).compute(
        np.asarray(JFrontend(jcfg).process(_tones(base))))).mean(0))
    al = _TemplateAligner(FeatPipeline(tcfg, device="cpu").compute(
        Frontend(tcfg, device="cpu").process(_tones(base))).mean(0))
    grid = [0.9, 0.95, 1.0, 1.05, 1.1]
    for scale in (1.0, 0.9, 1.1):
        utts = [_tones([f * scale for f in base])]
        jb, jt = j_vtln.estimate_vtln(utts, [["x"]], jal, jcfg, warps=grid)
        tb, tt = vtln.estimate_vtln(utts, [["x"]], al, tcfg, warps=grid,
                                    device="cpu")
        assert tb == jb and list(tt) == list(jt)
        np.testing.assert_allclose([tt[k] for k in tt], [jt[k] for k in jt],
                                   rtol=VTLN_RTOL)
    spk = vtln.estimate_vtln_per_speaker(
        ["low", "one", "low"],
        [_tones([f * 0.9 for f in base]), _tones(base),
         _tones([f * 0.9 for f in base])], [["x"]] * 3, al, tcfg,
        warps=[0.9, 1.0, 1.1], device="cpu")
    assert spk == {"low": 0.9, "one": 1.0}
