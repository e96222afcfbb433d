"""Port parity for the trainer's hot loop and EM (`train/bw.py`,
`train/trainer.py`) against the JAX package, on the same numpy inputs:
the toy two-phone corpus of tests/test_train.py and the seeded SMALL
fixture (its CI phones, dictionary and features) at K=4.

Tolerances: each utterance's log-likelihood within rtol 1e-5; the
accumulators within `bw.posterior_rtol` (1e-4, or the float32 rounding of
the log-domain recursion where |llh| * sqrt(Tmax) makes it larger:
5.5e-5 -> 1e-4 on the toy corpus, 1.4e-2 on SMALL at D=39, where the
reference's own float32 accumulators are 5e-3 from float64), with an
absolute floor of a tenth of that times each array's largest magnitude
(the mean sums cancel: features of both signs); besides, the port within
half of that bound of a float64 pass; `n_frames`
equal; Viterbi states equal and scores within rtol 1e-6 on the toy corpus,
1e-5 on SMALL (as the log-likelihood: sums of the same per-frame state
likelihoods, whose products sum in another order than XLA's; 2.7e-6
measured at |score| ~ 8,800); EM histories within rtol 1e-4 over 5 free
steps on the toy corpus, and on SMALL, where two float32 trajectories part
by 3e-4 in 5 steps (the accumulators' 7e-4 compounds), step by step from
the reference's parameters; checkpoints and exported model files exact.
"""

import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmusphinx_tpu.train import bw as j_bw
from cmusphinx_tpu.train import model_io as j_model_io
from cmusphinx_tpu.train.sentence_hmm import FlatModel as JFlatModel
from cmusphinx_tpu.train.trainer import Trainer as JTrainer
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.convert import hmm_params_from_jax
from cmusphinx_tpu_torch.frontend import FeatPipeline
from cmusphinx_tpu_torch.train import bw, model_io
from cmusphinx_tpu_torch.train.sentence_hmm import FlatModel
from cmusphinx_tpu_torch.train.trainer import HmmParams, Trainer
from test_train import PRON, _toy_corpus

ROOT = pathlib.Path(__file__).resolve().parent.parent
LLH_RTOL, VITERBI_RTOL, HIST_RTOL = 1e-5, 1e-6, 1e-4
# The reference's passes, compiled whole as its Trainer compiles them.
ref_fb = jax.jit(j_bw.forward_backward)
ref_viterbi = jax.jit(j_bw.viterbi_align)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # Many small torch ops: more intra-op threads only contend with the
    # other test workers.
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_acc(got, want, rtol, name=""):
    """Accumulator arrays within rtol, floored at rtol / 10 of the array's
    largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=0.1 * rtol * float(np.max(np.abs(want), initial=0.0)),
        err_msg=name)



def small_corpus():
    """fixture.SMALL as a training corpus: FlatModel over its CI phones,
    pronunciations from its dictionary, features from the port's CPU
    FeatPipeline."""
    fx = fixture.build(0, size=fixture.SMALL)
    phones, pron = fixture.train_corpus(fx)
    feats = FeatPipeline(fx.feat_config(), device="cpu").compute_batch(
        fx.ceps)
    return fx, phones, pron, fx.transcripts, feats


@pytest.fixture(scope="module", params=["toy", "small"])
def corpus(request):
    """(reference Trainer after two EM steps, port FlatModel, pron,
    transcripts, feats)."""
    if request.param == "toy":
        jmodel, feats, trans = _toy_corpus()
        phones, pron, K = jmodel.phones, PRON, 2
    else:
        _, phones, pron, trans, feats = small_corpus()
        jmodel, K = JFlatModel.create(phones), 4
    jt = JTrainer(jmodel, pron, trans, feats, K=K)
    jt.em_step()
    jt.em_step()
    jt.corpus = request.param
    return jt, FlatModel.create(phones), pron, trans, feats


def port_batch(jbatch) -> bw.UttBatch:
    return bw.UttBatch(**{k: getattr(jbatch, k)
                          for k in jbatch.__dataclass_fields__})


def ref_args(p):
    return tuple(jnp.asarray(a) for a in (p.means, p.prec, p.lnw, p.log_tp))


def port_args(p):
    return (p.means, p.prec, p.lnw, p.log_tp)


def test_gmm_and_state_logliks_match_reference(corpus):
    """The densities behind the pass: all senones (`gmm_logliks`) and the
    states of each utterance's sentence HMM (`state_logliks`), batched over
    utterances, against the reference's per-utterance forms; within rtol
    1e-5 of each value's magnitude."""
    jt = corpus[0]
    p, batch = jt.params, jt.batch
    args = [torch.as_tensor(a) for a in (p.means, p.prec, p.lnw)]
    comp, tot = bw.gmm_logliks(torch.as_tensor(batch.feats), *args)
    scomp, sll = bw.state_logliks(torch.as_tensor(batch.feats),
                                  torch.as_tensor(batch.state_sen), *args)
    for b in range(batch.feats.shape[0]):
        x = jnp.asarray(batch.feats[b])
        want = j_bw.gmm_logliks(x, *ref_args(p)[:3])
        swant = j_bw.state_logliks(x, jnp.asarray(batch.state_sen[b]),
                                   *ref_args(p)[:3])
        for got, ref in ((comp[b], want[0]), (tot[b], want[1]),
                         (scomp[b], swant[0]), (sll[b], swant[1])):
            ref = np.asarray(ref)
            np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                       atol=LLH_RTOL * np.abs(ref).max())


@pytest.mark.parametrize("option", ["plain", "weights", "phseg"])
def test_forward_backward_matches_reference(corpus, option):
    jt = corpus[0]
    batch, p = jt.batch, jt.params
    B, Tmax = batch.feats.shape[:2]
    kw = {}
    if option == "weights":
        kw["weights"] = np.linspace(0.25, 1.0, B).astype(np.float32)
    if option == "phseg":
        # The Viterbi alignment's own phones, with its first frames free.
        _, states = ref_viterbi(batch, *ref_args(p))
        states = np.asarray(states)
        seg = np.full((B, Tmax), -1, np.int32)
        for b in range(B):
            T = int(batch.T[b])
            seg[b, 3:T] = batch.state_phone[b][states[b, 3:T]]
        kw["phseg"] = seg
    jl, ja = ref_fb(batch, *ref_args(p), **kw)
    tl, ta = bw.forward_backward(port_batch(batch), *port_args(p),
                                 device="cpu", **kw)
    dl, da = bw.forward_backward(
        port_batch(batch), *(a.astype(np.float64) for a in port_args(p)),
        device="cpu", **kw)
    rtol = bw.posterior_rtol(jl, Tmax)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LLH_RTOL)
    assert int(ta["n_frames"]) == int(ja["n_frames"]) == int(batch.T.sum())
    keys = ["tmat"] if option == "phseg" else ["mixw", "mean", "var", "tmat"]
    for k in keys:
        assert_acc(ta[k], ja[k], rtol, k)
        assert_acc(ta[k].double(), da[k], rtol / 2, k)
    if option != "phseg":
        return
    # The reference's Gaussian accumulators under a phone segmentation are
    # NaN (0 * inf at the frames a state is ruled out); the port's are
    # finite, and every frame's occupancy sums to one.
    assert np.isnan(np.asarray(ja["mixw"])).any()
    for k in ("mixw", "mean", "var"):
        assert np.isfinite(ta[k].numpy()).all(), k
    np.testing.assert_allclose(float(ta["mixw"].sum()), batch.T.sum(),
                               rtol=rtol)
    # All -1 is exactly the unconstrained pass.
    free = np.full((B, Tmax), -1, np.int32)
    l0, a0 = bw.forward_backward(port_batch(batch), *port_args(p),
                                 device="cpu")
    l1, a1 = bw.forward_backward(port_batch(batch), *port_args(p),
                                 phseg=free, device="cpu")
    assert torch.equal(l0, l1) and torch.equal(a0["mixw"], a1["mixw"])
    # The rasterizer of a phone segmentation, as the reference's.
    from cmusphinx_tpu.decode.align import PhoneSeg as JSeg
    from cmusphinx_tpu_torch.decode.align import PhoneSeg
    segs = [("A", 0, 2, "ab", 0), ("B", 3, 5, "ab", 0), ("Q", 6, 6, "x", 1)]
    ids = {"A": 1, "B": 2}
    got = bw.phseg_to_frames([PhoneSeg(*a) for a in segs], 9, ids)
    np.testing.assert_array_equal(
        got, j_bw.phseg_to_frames([JSeg(*a) for a in segs], 9, ids))
    np.testing.assert_array_equal(got, [1, 1, 1, 2, 2, 2, -1, -1, -1])


def test_viterbi_align_matches_reference(corpus):
    jt = corpus[0]
    js, jst = ref_viterbi(jt.batch, *ref_args(jt.params))
    ts, tst = bw.viterbi_align(port_batch(jt.batch), *port_args(jt.params),
                               device="cpu")
    rtol = VITERBI_RTOL if jt.corpus == "toy" else LLH_RTOL
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=rtol)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    # The best path's own score, summed along it, is the Viterbi score.
    again = bw.alignment_scores(port_batch(jt.batch), *port_args(jt.params),
                                tst, device="cpu")
    np.testing.assert_allclose(again.numpy(), ts.numpy(), rtol=LLH_RTOL)


def test_trainer_history_matches_reference(corpus):
    jt0, model, pron, trans, feats = corpus
    K = jt0.params.means.shape[1]
    jt = JTrainer(JFlatModel.create(model.phones), pron, trans, feats, K=K)
    tt = Trainer(model, pron, trans, feats, K=K, device="cpu")
    np.testing.assert_array_equal(tt.params.means, jt.params.means)
    lockstep = jt0.corpus == "small"
    jh, th = [], []
    for _ in range(5):
        if lockstep:
            tt.params = hmm_params_from_jax(jt.params.means, jt.params.var,
                                            jt.params.lnw, jt.params.tp)
        jh.append(jt.em_step())
        th.append(tt.em_step())
    np.testing.assert_allclose(th, jh, rtol=HIST_RTOL)
    assert all(b >= a - 1e-4 for a, b in zip(th, th[1:])), th


def test_checkpoint_loads_across_packages(tmp_path):
    model, feats, trans = _toy_corpus()
    tt = Trainer(FlatModel.create(model.phones), PRON, trans, feats, K=2,
                 ckpt_dir=str(tmp_path / "port"), device="cpu")
    jt = JTrainer(model, PRON, trans, feats, K=2,
                  ckpt_dir=str(tmp_path / "ref"))
    tt.em_step()
    jt.em_step()
    for path, src, loader in (
            (tmp_path / "port" / "ckpt_001.npz", tt, JTrainer),
            (tmp_path / "ref" / "ckpt_001.npz", jt, Trainer)):
        params, it, hist = loader.load_checkpoint(str(path))
        assert it == 1 and hist == src.history
        for k in ("means", "var", "lnw", "tp"):
            np.testing.assert_array_equal(getattr(params, k),
                                          getattr(src.params, k))


def test_export_model_bytes_equal(tmp_path):
    jmodel, feats, trans = _toy_corpus()
    jt = JTrainer(jmodel, PRON, trans, feats, K=2)
    jt.em_step()
    p = jt.params
    port = hmm_params_from_jax(p.means, p.var, p.lnw, p.tp)
    j_model_io.export_model(str(tmp_path / "ref"), jmodel, p)
    model_io.export_model(str(tmp_path / "port"),
                          FlatModel.create(jmodel.phones), port)
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 6
    for n in names:
        assert (tmp_path / "ref" / n).read_bytes() == \
            (tmp_path / "port" / n).read_bytes(), n


def test_hmm_params_from_jax(corpus):
    jt = corpus[0]
    p = jt.params
    port = hmm_params_from_jax(p.means, p.var, p.lnw,
                               p.tp.astype(np.float64))
    assert isinstance(port, HmmParams)
    for k in ("means", "var", "lnw", "tp"):
        a = getattr(port, k)
        assert a.dtype == np.float32 and a.flags.c_contiguous, k
        np.testing.assert_array_equal(a, getattr(p, k).astype(np.float32))
    np.testing.assert_array_equal(port.prec, p.prec)
    np.testing.assert_array_equal(port.log_tp, p.log_tp)
    jl, _ = ref_fb(jt.batch, *ref_args(p))
    tl, _ = bw.forward_backward(port_batch(jt.batch), *port_args(port),
                                device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LLH_RTOL)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model, feats, trans = _toy_corpus(n_utt=2)
    with pytest.raises((RuntimeError, AssertionError)):
        Trainer(FlatModel.create(model.phones), PRON, trans, feats)


_SHARDED = r"""
import multiprocessing, sys
import numpy as np
import torch
sys.path.insert(0, {tests!r})
from cmusphinx_tpu_torch.train.sentence_hmm import FlatModel
from cmusphinx_tpu_torch.train.trainer import Trainer

def corpus():
    # tests/test_train.py's toy corpus, 7 utterances: 2 ranks pad one row.
    rng = np.random.RandomState(0)
    pron = {{"ab": ["A", "B"], "ba": ["B", "A"]}}
    centers = {{"SIL": 0.0, "A": 3.0, "B": -3.0}}
    feats, trans = [], []
    for i in range(7):
        words = ["ab", "ba"][i % 2 : i % 2 + 1] * (1 + i % 2)
        seq = ["SIL"]
        for w in words:
            seq += pron[w] + ["SIL"]
        feats.append(np.concatenate([rng.randn(6, 4).astype(np.float32) * 0.3
                                     + centers[p] for p in seq]))
        trans.append(words)
    return FlatModel.create(["SIL", "A", "B"]), pron, trans, feats

def rank(r, port, q):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}",
                            world_size=2, rank=r)
    try:
        tr = Trainer(*corpus(), K=2, device="cpu")
        ll = [tr.em_step_sharded(), tr.em_step_sharded()]
        q.put((r, ll, tr.params.means, tr.params.var, tr.params.lnw,
               tr.params.tp))
    finally:
        dist.destroy_process_group()

if __name__ == "__main__":
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    ps = [ctx.Process(target=rank, args=(r, int(sys.argv[1]), q))
          for r in range(2)]
    for p in ps:
        p.start()
    got = dict((o[0], o[1:]) for o in (q.get(timeout=90) for _ in ps))
    for p in ps:
        p.join(timeout=30)
        assert p.exitcode == 0, p.exitcode
    tr = Trainer(*corpus(), K=2, device="cpu")
    want = ([tr.em_step(), tr.em_step()], tr.params.means, tr.params.var,
            tr.params.lnw, tr.params.tp)
    for r in (0, 1):
        np.testing.assert_allclose(got[r][0], want[0], rtol=1e-5)
        for a, b in zip(got[r][1:], want[1:]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    for a, b in zip(got[0], got[1]):
        np.testing.assert_array_equal(a, b)
    print("SHARDED OK", got[0][0])
"""


def test_em_step_sharded_two_gloo_ranks_equals_em_step(tmp_path):
    """em_step_sharded on 2 gloo ranks (one T=0 padding row) equals
    em_step; every rank ends with the same parameters.  Its own process,
    with a timeout, so that a hung rendezvous fails the test."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "sharded.py"
    script.write_text(_SHARDED.format(tests=str(ROOT / "tests")))
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(script), str(port)], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "SHARDED OK" in r.stdout
