"""Shared fixtures of the benchmark's own tests, which run on the CPU
(`python -m pytest portbench/tests`) but for those marked `cuda`.

`tiny_bench` is a copy of BENCHMARK.json and the harness's data files in a
temporary root, with tiny cells beside the real ones: `tiny-cont.batch`
and `tiny-semi.batch` (SMALL-sized models, a pool of 8 utterances)."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where "
        "torch.cuda.is_available() is false")


def make_bench(root: str) -> str:
    """A temporary root holding BENCHMARK.json and portbench's data files,
    with the tiny cells added by files and entries alone."""
    src = os.path.join(ROOT, "portbench")
    dst = os.path.join(root, "portbench")
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        ".cache", ".out", "__pycache__", "tests"))
    for m in ("cont", "semi"):
        shutil.copy(os.path.join(DATA, f"tiny-{m}.json"),
                    os.path.join(dst, "configs"))
    shutil.copy(os.path.join(DATA, "tiny-batch.json"),
                os.path.join(dst, "traffic"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    for m in ("cont", "semi"):
        spec["configs"].append({"name": f"tiny-{m}", "source": "test",
                                "file": f"portbench/configs/tiny-{m}.json",
                                "reduced": [], "why": "test"})
    cells = {"tiny-cont.batch": ("tiny-cont", "tiny-batch"),
             "tiny-semi.batch": ("tiny-semi", "tiny-batch")}
    for name, (c, t) in cells.items():
        spec["workloads"].append({"name": name, "config": c, "traffic": t,
                                  "chips": 1, "why": "test"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m and any(
                    x.endswith("." + name.split(".")[1]) for x in m["workloads"]):
                m["workloads"].append(name)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as fh:
        json.dump(spec, fh, indent=1)
    return path


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """The tiny benchmark; its generated tasks cached in the test's own
    directory."""
    from portbench import harness
    monkeypatch.setattr(harness, "CACHE", str(tmp_path / "cache"))
    return make_bench(str(tmp_path))
