"""Whole runs on the CPU at the test size (the harness's device choice
opened for the tests alone), the command without a card, and a cell and a
metric added by files alone."""

import filecmp
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, make_bench
from portbench import harness
from portbench.gen import task as gen_task


@pytest.mark.parametrize("cell,trace", [("tiny-cont.batch", False),
                                        ("tiny-cont.batch", True),
                                        ("tiny-semi.batch", False),
                                        ("tiny-semi.batch", True)])
def test_tiny_cells_run_and_are_correct(tiny_bench, cell, trace):
    r = harness.run_cell(tiny_bench, cell, 2**31 + 7, 2.0, trace,
                         device="cpu", log=lambda s: None)
    line = r.line
    assert line["correct"], r.numbers
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "check"
    score = "score_gap" if "cont" in cell else "score_miss_share"
    assert set(line["check"]) == {score, "word_gap", "missing"}
    names = {m["name"] for m in harness.cell_metrics(
        harness.load_spec(tiny_bench), cell, trace)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert "setup_s" in line["metrics"]
    json.dumps(line)


def test_same_seed_same_inputs(tiny_bench):
    spec = harness.load_spec(tiny_bench)
    cfg = json.load(open(os.path.join(os.path.dirname(tiny_bench),
                                      "portbench/configs/tiny-cont.json")))
    a = harness.model_dir(cfg, 11, [100, 150])[1]
    shutil.rmtree(os.path.join(harness.CACHE, "models"))
    b = harness.model_dir(cfg, 11, [100, 150])[1]
    assert all((x == y).all() for x, y in zip(a, b))
    assert spec["paths"] == ["portbench"]


def test_seeds_share_the_structure_and_match_a_whole_build(tiny_bench,
                                                           tmp_path):
    """A seed's directory from the cached structure holds the files a whole
    build of that seed writes; two seeds link one copy of the structure."""
    cfg = json.load(open(os.path.join(os.path.dirname(tiny_bench),
                                      "portbench/configs/tiny-cont.json")))
    lengths = [100, 150]
    kw_a, ceps, _ = harness.model_dir(cfg, 11, lengths)
    kw_b = harness.model_dir(cfg, 12, lengths)[0]
    size = gen_task.Size.from_dict(cfg["size"])
    whole = gen_task.build(11, "cont", size, lengths, cfg["structure_seed"])
    gen_task.write_model_dir(whole, str(tmp_path / "whole"))
    a = os.path.dirname(kw_a["lm"])
    b = os.path.dirname(kw_b["lm"])
    for f in gen_task.STRUCTURE_FILES + ("hmm/means", "hmm/variances",
                                         "hmm/mixture_weights"):
        assert filecmp.cmp(os.path.join(a, f), tmp_path / "whole" / f,
                           shallow=False), f
    for f in gen_task.STRUCTURE_FILES:
        assert os.path.samefile(os.path.join(a, f), os.path.join(b, f)), f
    assert all((x == y).all() for x, y in zip(ceps, whole.ceps))


def test_without_a_card_the_command_fails():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "hub4cont-64k.batch", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_without_the_program_a_run_fails(tmp_path):
    bench = make_bench(str(tmp_path))
    code = ("import sys; sys.path[:] = [p for p in sys.path if 'repo' not in p];"
            f"sys.path.insert(0, {str(tmp_path)!r});"
            "from portbench import harness;"
            f"harness.run_cell({bench!r}, 'tiny-cont.batch', 1, 1.0, False, device='cpu')")
    p = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "cmusphinx_tpu_torch" in p.stderr


def test_a_cell_and_a_metric_added_by_files_alone(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", ".out",
                                                  "__pycache__"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    (tmp_path / "portbench/traffic/dummy-mix.json").write_text(
        json.dumps({"kind": "batch", "pool": 4, "frames": [100, 200],
                    "batch": 2, "profile_batches": 1, "check_batches": 1}))
    (tmp_path / "portbench/metrics/dummy_ms.batch.py").write_text(
        "def read(run):\n    return None\n")
    spec["workloads"].append({"name": "hub4cont-64k.dummy",
                              "config": "hub4cont-64k",
                              "traffic": "dummy-mix", "chips": 1,
                              "why": "a dummy"})
    spec["per_layer"].append({"name": "dummy_ms.batch", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "device", "moves": "batch_xrt",
                              "workloads": ["hub4cont-64k.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    p = subprocess.run([sys.executable, "portbench/run.py", "--list"],
                       cwd=str(tmp_path), capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr
    out = p.stdout
    assert ("cell hub4cont-64k.dummy: portbench/configs/hub4cont-64k.json "
            "portbench/traffic/dummy-mix.json") in out
    assert "metric dummy_ms.batch: portbench/metrics/dummy_ms.batch.py\n" in out
    assert "(missing)" not in out
