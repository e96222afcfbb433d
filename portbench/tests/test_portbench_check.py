"""The check's own tests: the controls (the reference's scorer in TF32
in the program's place; the program's own `-gmmprec high`, the next
precision below the continuous configuration's `highest`) and each fault a
cell can have turn `correct` false, at the test size on the CPU."""

import pytest

from portbench import control, faults, harness


@pytest.mark.parametrize("cell,mode", [("tiny-cont.batch", "tf32"),
                                       ("tiny-cont.batch", "high"),
                                       ("tiny-semi.batch", "tf32")])
def test_control_is_not_correct(tiny_bench, cell, mode):
    r = harness.run_cell(tiny_bench, cell, 3, 2.0, False, device="cpu",
                         log=lambda s: None, **control.options(mode))
    assert not r.line["correct"]
    name = "score_gap" if "cont" in cell else "score_miss_share"
    assert r.numbers[name] > r.checks[name]["limit"]


@pytest.mark.parametrize("cell,fault", [
    ("tiny-cont.batch", "unchanged_state"),
    ("tiny-cont.batch", "half_batch"),
    ("tiny-cont.batch", "altered_token"),
    ("tiny-semi.batch", "altered_token"),
    ("tiny-semi.batch", "unchanged_state"),
    ("tiny-semi.batch", "half_batch"),
])
def test_faults_are_not_correct(tiny_bench, cell, fault):
    r = harness.run_cell(tiny_bench, cell, 4, 2.0, False, device="cpu",
                         log=lambda s: None, patch=faults.FAULTS[fault])
    assert not r.line["correct"], (fault, r.numbers)
