"""Port parity for the training pipeline (`train/pipeline.py`,
`train/dtree.py`, `train/semicont.py`, `train/model_io.py`) against the JAX
package, and the slice end to end: a model trained by the port, exported,
then decoded by both packages' `Decoder`s.

Tolerances: stage histories within rtol 1e-4 and the tied senone map equal
(the toy corpus of tests/test_train.py); `split_gaussians` and
`kmeans_init` bit-equal (numpy copies); semi-continuous histories within
rtol 1e-4; exported files byte-equal from the same parameters; decoded
hypotheses equal.
"""

import os

import numpy as np
import pytest
import torch

from cmusphinx_tpu.api import Decoder as JaxDecoder
from cmusphinx_tpu.train import pipeline as j_pipeline
from cmusphinx_tpu.train import semicont as j_semicont
from cmusphinx_tpu.train.trainer import Trainer as JTrainer
from cmusphinx_tpu_torch.api import Decoder
from cmusphinx_tpu_torch.convert import hmm_params_from_jax
from cmusphinx_tpu_torch.train import pipeline, semicont
from cmusphinx_tpu_torch.train.model_io import export_model
from cmusphinx_tpu_torch.train.sentence_hmm import FlatModel
from cmusphinx_tpu_torch.train.trainer import Trainer
from cmusphinx_tpu_torch.utils.bio import write_mfc
from test_semicont import _corpus as semi_corpus
from test_torch_train import small_corpus
from test_train import PRON, _toy_corpus

HIST_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # Many small torch ops: more intra-op threads only contend with the
    # other test workers.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("tying", ["agglom", "dtree"])
def test_full_pipeline_matches_reference(tying):
    model, feats, trans = _toy_corpus(n_utt=8)
    kw = dict(gauss=2, ci_iters=5, cd_iters=4, tied_iters=4, tying=tying)
    ji, jsmap, jtied, jh = j_pipeline.train_full_pipeline(
        model, PRON, trans, feats, **kw)
    ti, tsmap, ttied, th = pipeline.train_full_pipeline(
        FlatModel.create(model.phones), PRON, trans, feats, device="cpu",
        **kw)
    assert list(th) == list(jh) == ["ci", "cd_untied", "tied", "split_2"]
    for k in jh:
        np.testing.assert_allclose(th[k], jh[k], rtol=HIST_RTOL, err_msg=k)
    np.testing.assert_array_equal(tsmap, jsmap)
    assert ti.tris == ji.tris
    assert ttied.means.shape == jtied.means.shape == (
        int(tsmap.max()) + 1, 2, 4)
    if tying == "dtree":
        # An unseen triphone descends both forests to the same senone.
        b, lc, rc, wp = model.phone_id["A"], model.phone_id["B"], \
            model.phone_id["B"], 1
        assert (b, lc, rc, wp) not in ti.tri_id
        for s in range(3):
            assert (ti.forest.senone(b, s, lc, rc, wp)
                    == ji.forest.senone(b, s, lc, rc, wp))


def test_split_gaussians_bit_equal():
    model, feats, trans = _toy_corpus()
    jt = JTrainer(model, PRON, trans, feats, K=2)
    jt.em_step()
    p = jt.params
    want = j_pipeline.split_gaussians(p)
    got = pipeline.split_gaussians(hmm_params_from_jax(p.means, p.var,
                                                       p.lnw, p.tp))
    for k in ("means", "var", "lnw", "tp"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.means.shape[1] == 4


def test_kmeans_init_bit_equal():
    rng = np.random.RandomState(3)
    X = [np.concatenate([rng.randn(200, 4) + c for c in (-5, 0, 5)]),
         rng.randn(50, 4).astype(np.float32)]
    for K, seed, max_obs in ((3, 1, 200_000), (8, 0, 300)):
        want = j_semicont.kmeans_init(X, K, seed=seed, max_obs=max_obs)
        got = semicont.kmeans_init(X, K, seed=seed, max_obs=max_obs)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_semicont_matches_reference(tmp_path):
    model, pron, texts, feats = semi_corpus()
    jt = j_semicont.SemiContTrainer(model, pron, texts, feats, K=8, seed=0)
    tt = semicont.SemiContTrainer(FlatModel.create(model.phones), pron,
                                  texts, feats, K=8, seed=0, device="cpu")
    for k in ("means", "var", "lnw", "tp"):
        np.testing.assert_array_equal(getattr(tt.params, k),
                                      getattr(jt.params, k))
    jh = [jt.em_step() for _ in range(6)]
    th = [tt.em_step() for _ in range(6)]
    np.testing.assert_allclose(th, jh, rtol=HIST_RTOL)
    assert th[-1] > th[0]
    assert np.array_equal(tt.params.means[0], tt.params.means[-1])
    # The export from the same parameters: byte-equal files.
    p = jt.params
    tt.params = hmm_params_from_jax(p.means, p.var, p.lnw, p.tp)
    j_semicont.export_semicont(str(tmp_path / "ref"), model, jt, feat="1s_c")
    semicont.export_semicont(str(tmp_path / "port"),
                             FlatModel.create(model.phones), tt, feat="1s_c")
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert "sendump" in names
    for n in names:
        assert (tmp_path / "ref" / n).read_bytes() == \
            (tmp_path / "port" / n).read_bytes(), n


def test_trained_model_decodes_alike_in_both_packages(tmp_path):
    """The slice end to end on fixture.SMALL: the port trains a CI model
    (K=4, 4 EM steps) on the CPU and exports it beside the fixture's LM
    and dictionary; both packages' Decoders decode its utterances from
    that directory with equal hypotheses."""
    fx, phones, pron, trans, feats = small_corpus()
    model = FlatModel.create(phones)
    tr = Trainer(model, pron, trans, feats, K=4, device="cpu")
    hist = [tr.em_step() for _ in range(4)]
    assert all(b >= a - 1e-4 for a, b in zip(hist, hist[1:])), hist
    hmm = str(tmp_path / "hmm")
    export_model(hmm, model, tr.params)
    with open(os.path.join(hmm, "noisedict"), "w") as fh:
        fh.write("<s> SIL\n</s> SIL\n<sil> SIL\n")
    lm, dic = str(tmp_path / "lm.arpa"), str(tmp_path / "words.dict")
    fx.lm.write_arpa(lm)
    with open(dic, "w") as fh:
        fh.writelines(f"{w} {' '.join(p)}\n" for w, p in pron.items())
    port = Decoder(hmm=hmm, lm=lm, dict=dic, device="cpu")
    ref = JaxDecoder(hmm=hmm, lm=lm, dict=dic)
    words = []
    for i, cep in enumerate(fx.ceps):
        path = str(tmp_path / f"u{i}.mfc")
        write_mfc(path, cep)
        got, want = port.decode_cep_file(path), ref.decode_cep_file(path)
        assert got.words == want.words, i
        words.append(got.words)
    assert any(words)
