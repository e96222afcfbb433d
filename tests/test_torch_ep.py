"""Port parity for the GMM frame classifier and endpointer
(`frontend/ep.py`: `FrameClassifier`, `Endpointer`) against the JAX
package.

Tolerances:
- the buffers built from the same means, variances and weights: equal
  (the same numpy float32 arithmetic);
- class log-likelihoods: within D * 2^-22 * M (M: the magnitude of the
  summed terms, as tests/test_torch_gmm.py), f32 products summed in
  another order;
- `fit`'s parameters after its EM steps (float32 on both sides, sums in
  another order, compounded over the steps): within rtol 1e-4 (means,
  variances) and 1e-4 absolute (log weights);
- classes, voted classes and endpointer spans: equal.
"""

import numpy as np
import pytest
import torch

from cmusphinx_tpu.frontend import ep as jep
from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.frontend import FeatPipeline, ep


def synthetic(seed=0, D=4):
    """The reference test's data: silence near 0, speech near +4, and a
    stream of 100 sil, 120 speech, 80 sil, 60 speech, 100 sil frames."""
    rng = np.random.default_rng(seed)
    sil = rng.normal(size=(400, D)).astype(np.float32)
    sp = (rng.normal(size=(400, D)) + 4.0).astype(np.float32)
    feats = np.concatenate([sil, sp])
    labels = np.concatenate([np.zeros(400, np.int64),
                             np.full(400, ep.CLASS_SPEECH, np.int64)])
    stream = np.concatenate([
        rng.normal(size=(100, D)), rng.normal(size=(120, D)) + 4.0,
        rng.normal(size=(80, D)), rng.normal(size=(60, D)) + 4.0,
        rng.normal(size=(100, D))]).astype(np.float32)
    return feats, labels, stream


def fixture_frames():
    """The SMALL fixture's frames, labelled speech where c0 is above its
    median (a stand-in for an alignment's labels)."""
    fx = fixture.build(0, size=fixture.SMALL)
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    x = np.concatenate([fp.compute(c) for c in fx.ceps])
    return x, (x[:, 0] > np.median(x[:, 0])).astype(np.int64)


def magnitude(clf, x):
    x = x.astype(np.float64)
    lin = clf.lin.double().numpy()
    quad = clf.quad.double().numpy()
    m = (np.abs(clf.const.double().numpy())[None] + np.abs(x) @ np.abs(lin)
         + (x * x) @ quad)
    return m.reshape(len(x), clf.n_class, clf.n_comp).max(-1)


def assert_ll_close(clf, jclf, x):
    got, want = clf.log_likelihoods(x), jclf.log_likelihoods(x)
    bound = x.shape[1] * 2.0 ** -22 * magnitude(clf, x)
    assert got.shape == want.shape == (len(x), clf.n_class)
    assert np.all(np.abs(got.astype(np.float64) - want) <= bound)


@pytest.mark.parametrize("data", ["synthetic", "fixture"])
def test_fit_and_log_likelihoods_match_reference(data):
    if data == "synthetic":
        feats, labels, _ = synthetic()
        kw = {"n_class": 2, "n_comp": 2, "n_iter": 5}
    else:
        feats, labels = fixture_frames()
        # A third class with no frames keeps its seeding.
        kw = {"n_class": 3, "n_comp": 4, "n_iter": 8, "seed": 3}
    clf = ep.FrameClassifier.fit(feats, labels, device="cpu", **kw)
    jclf = jep.FrameClassifier.fit(feats, labels, **kw)
    np.testing.assert_allclose(clf.means, jclf.means, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(clf.var, jclf.var, rtol=1e-4)
    np.testing.assert_allclose(clf.lnw, jclf.lnw, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(clf.logprior.numpy(),
                                  np.asarray(jclf._logprior))
    # The same parameters give the reference's buffers exactly.
    same = ep.FrameClassifier(jclf.means, jclf.var, jclf.lnw,
                              np.exp(np.asarray(jclf._logprior,
                                                np.float64)), device="cpu")
    for name in ("lin", "quad", "const"):
        np.testing.assert_array_equal(getattr(same, name).numpy(),
                                      np.asarray(getattr(jclf, "_" + name)))
    assert_ll_close(same, jclf, feats)
    for w in (1, 5):
        np.testing.assert_array_equal(same.classify(feats, w),
                                      jclf.classify(feats, w))


def test_classify_and_segment_match_reference():
    feats, labels, stream = synthetic()
    clf = ep.FrameClassifier.fit(feats, labels, n_class=2, n_comp=2,
                                 n_iter=5, device="cpu")
    jclf = jep.FrameClassifier.fit(feats, labels, n_class=2, n_comp=2,
                                   n_iter=5)
    assert (clf.classify(feats, voting_window=1) == labels).mean() > 0.95
    classes = clf.classify(stream)
    np.testing.assert_array_equal(classes, jclf.classify(stream))
    for kw in ({}, {"end_window": 30, "pad_before": 5, "pad_after": 5},
               {"begin_window": 3, "begin_threshold": 3, "end_window": 10}):
        utts = ep.Endpointer(**kw).segment(classes)
        want = jep.Endpointer(**kw).segment(classes)
        assert [(u.start_frame, u.end_frame) for u in utts] == \
            [(u.start_frame, u.end_frame) for u in want]
    utts = ep.Endpointer(end_window=30, pad_before=5,
                         pad_after=5).segment(classes)
    assert len(utts) == 2 and abs(utts[0].start_frame - 95) < 15
    # A classifier given no priors weighs its classes equally.
    flat = ep.FrameClassifier(clf.means, clf.var, clf.lnw, device="cpu")
    np.testing.assert_allclose(flat.logprior.numpy(), np.log([0.5, 0.5]))


def test_score_is_batched_device_op():
    feats, labels, _ = synthetic()
    clf = ep.FrameClassifier.fit(feats, labels, n_class=2, n_comp=2,
                                 n_iter=2, device="cpu")
    with torch.inference_mode():
        ll = clf(torch.as_tensor(feats))
    assert ll.shape == (len(feats), 2) and ll.dtype == torch.float32
    np.testing.assert_array_equal(ll.numpy(), clf.log_likelihoods(feats))
