"""On the card: each cell of BENCHMARK.json, one short run through the
command, correct and with its metrics.  Skips without a card.

    python -m pytest -m cuda portbench/tests/test_portbench_cuda.py
"""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT
from portbench import harness


def cells():
    return [w["name"] for w in harness.load_spec(
        os.path.join(ROOT, "BENCHMARK.json"))["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_cell_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", "77", "--seconds", "5", "--trace",
                        "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["check"]
    assert "setup_s" in line["metrics"]
    assert line["device"]["platform"] == "gpu"
