"""The PTM kind (`kinds/ptm.py`) of pocketsphinx's default en-us model: its
tiny cell runs `correct` on the CPU through the program's
`PtmParityScorer` and its TF32 control and planted faults do not; its
reference reads the program's senone-to-codebook map from the mdef; its
counts at the cell's shape; and `run.py --list` names its cell's files."""

import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT
from portbench import control, counters, faults, harness, kinds, traffic
from portbench.reference import model as ref_model
from portbench.reference import scores as ref_scores

ptm = kinds.load("ptm")
CELL = {"kind": "ptm", "C": 40, "S": 5126, "K": 128,
        "veclens": [13, 13, 13], "topn": 4}


@pytest.mark.parametrize("mode", ["sound", "tf32"])
def test_tiny_cell_is_correct_and_its_tf32_control_is_not(tiny_bench, mode,
                                                          tmp_path,
                                                          monkeypatch):
    # The traced run's trace in the test's own directory: the harness's
    # fixed `.out/trace.json` is shared with other workers' traced runs.
    monkeypatch.setattr(harness, "OUT", str(tmp_path / "out"))
    r = harness.run_cell(tiny_bench, "tiny-ptm.batch", 2**31 + 7, 2.0,
                         mode == "sound", device="cpu", log=lambda s: None,
                         **control.options(mode))
    line = r.line
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["check"]) == {"score_miss_share", "word_gap", "missing"}
    if mode == "sound":
        assert line["correct"], r.numbers
        assert r.numbers["score_miss_share"] == 0.0
    else:
        assert not line["correct"]
        assert r.numbers["score_miss_share"] > \
            line["check"]["score_miss_share"]["limit"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_faults_are_not_correct(tiny_bench, fault):
    r = harness.run_cell(tiny_bench, "tiny-ptm.batch", 4, 2.0, False,
                         device="cpu", log=lambda s: None,
                         patch=faults.FAULTS[fault])
    assert not r.line["correct"], (fault, r.numbers)


def test_reference_reads_the_programs_codebooks(tiny_bench):
    """The kind's reference and the program's `Decoder` score the tiny
    model alike: the same codebook a senone, the same shape, and the same
    integer score sums on the reference's own features."""
    import json
    from cmusphinx_tpu_torch.api import Decoder
    from cmusphinx_tpu_torch.ops.gmm import PtmParityScorer
    cfg = json.load(open(os.path.join(os.path.dirname(tiny_bench),
                                      "portbench/configs/tiny-ptm.json")))
    mix = traffic.load(harness.mix_path(os.path.dirname(tiny_bench),
                                        harness.load_spec(tiny_bench),
                                        "tiny-batch"))
    kw, ceps, _ = harness.model_dir(cfg, 11, traffic.lengths(mix))
    dec = Decoder(device="cpu", **kw, **cfg["decoder"])
    sc = dec.scorer
    assert isinstance(sc, PtmParityScorer)
    m = ref_model.read_model(kw["hmm"], kw["lm"], kw["dict"], "ptm")
    assert sc.sen2cb.tolist() == m.weights["sen2cb"].tolist()
    assert ptm.score_shape(dec) == {**CELL, "C": 11, "S": 96, "K": 16}
    x = ref_scores.features(ceps[0])
    want = ref_scores.reference_scorer(m, "cpu")(x)
    got = sc.score(x.float()).double()
    q = ((got - want).abs() / sc.scale).round()
    assert (q > 0).double().mean() <= 1e-3


@pytest.mark.parametrize("T", [50, 9600])
def test_counts_at_the_cells_shape(T):
    """By hand, per stream: 2 T d K C + 4 N T K C + 3 T N S operations;
    the weights, codebooks, features and output bytes once."""
    flops = 3 * (2 * T * 13 * 128 * 40 + 4 * 4 * T * 128 * 40
                 + 3 * T * 4 * 5126)
    nbytes = (3 * 128 * 5126 + 4 * 40 * 128 * (2 * 39 + 3) + 4 * T * 39
              + 4 * T * 5126)
    assert ptm.score_flops(CELL, T) == flops
    assert ptm.score_bytes(CELL, T) == nbytes
    assert counters.score_least_s(CELL, T) == max(
        flops / counters.PEAK_TF32, nbytes / counters.HBM_BW)
    # A batch's least time: the [T, S] float32 output, ~0.060 ms.
    if T == 9600:
        assert counters.score_least_s(CELL, T) == nbytes / counters.HBM_BW
        assert 59e-6 < nbytes / counters.HBM_BW < 61e-6


def test_list_names_the_cells_files():
    p = subprocess.run([sys.executable, "portbench/run.py", "--list"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    out = p.stdout
    assert ("cell en-us-ptm-64k.batch: portbench/configs/en-us-ptm-64k.json "
            "portbench/traffic/batch16.json portbench/kinds/ptm.py\n") in out
    assert ("  metric ptm_score_roofline.batch: "
            "portbench/metrics/ptm_score_roofline.batch.py\n") in out
    assert "(missing)" not in out


def test_the_configuration_is_the_published_width():
    import json
    cfg = json.load(open(os.path.join(ROOT, "portbench/configs/"
                                      "en-us-ptm-64k.json")))
    assert cfg["model"] == "ptm"
    size = cfg["size"]
    assert (size["n_phone"] + 1, size["n_sen"],
            size["n_density_ptm_stream"]) == (40, 5126, 128)
    assert cfg["published"]["n_sen"] == size["n_sen"]
    assert set(cfg["reduced"]) == {"n_codebook", "n_ci_senone"}
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    entry = harness.find(spec, "configs", "en-us-ptm-64k")
    assert set(entry["reduced"]) == set(cfg["reduced"])
    assert np.isclose(cfg["check"]["score_miss_share"], 2e-3)
