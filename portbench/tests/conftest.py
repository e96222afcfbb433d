"""Shared fixtures of the benchmark's own tests, which run on the CPU
(`python -m pytest portbench/tests`) but for those marked `cuda`.

`tiny_bench` is a copy of BENCHMARK.json and the harness's data files in a
temporary root, with tiny cells beside the real ones: `tiny-<kind>.batch`
for each acoustic-model kind of `portbench/kinds/` (SMALL-sized models,
`data/tiny-<kind>.json`, a pool of 8 utterances)."""

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


def kind_names():
    """The acoustic-model kinds of `portbench/kinds/`."""
    d = os.path.join(ROOT, "portbench", "kinds")
    return sorted(f[:-3] for f in os.listdir(d)
                  if f.endswith(".py") and f != "__init__.py")


def make_bench(root: str, extra=()) -> str:
    """A temporary root holding BENCHMARK.json and portbench's data files,
    with the tiny cells added by files and entries alone: one a kind of
    `portbench/kinds/`, and one a name of `extra`, whose kind file
    (`data/<name>.py`) is added to the root's `kinds/` too."""
    src = os.path.join(ROOT, "portbench")
    dst = os.path.join(root, "portbench")
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        ".cache", ".out", "__pycache__", "tests"))
    for m in extra:
        shutil.copy(os.path.join(DATA, f"{m}.py"), os.path.join(dst, "kinds"))
    names = kind_names() + list(extra)
    for m in names:
        shutil.copy(os.path.join(DATA, f"tiny-{m}.json"),
                    os.path.join(dst, "configs"))
    shutil.copy(os.path.join(DATA, "tiny-batch.json"),
                os.path.join(dst, "traffic"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    for m in names:
        spec["configs"].append({"name": f"tiny-{m}", "source": "test",
                                "file": f"portbench/configs/tiny-{m}.json",
                                "reduced": [], "why": "test"})
    cells = {f"tiny-{m}.batch": (f"tiny-{m}", "tiny-batch") for m in names}
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
