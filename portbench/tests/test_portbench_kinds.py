"""Acoustic-model kinds found by the configuration's name
(`portbench/kinds/<model>.py`): the kinds generate and count what the
harness did before they were modules of their own (hashes and counts
recorded on that tree, `data/pinned.json`); an unknown kind fails naming
the path it looked for; the kind comes from the configuration, never from
which files a model directory holds; and a third kind (`data/ptm1.py`) is
added to a temporary root by files alone and runs a tiny cell there."""

import filecmp
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import DATA, ROOT, make_bench
from portbench import counters, harness, kinds, traffic
from portbench.gen import task as gen_task
from portbench.reference import model as ref_model
from portbench.reference import scores as ref_scores

PINNED = json.load(open(os.path.join(DATA, "pinned.json")))
SEEDS = [11, 2**31 + 7]


def tiny_cfg(model: str, structure: bool) -> dict:
    cfg = json.load(open(os.path.join(DATA, f"tiny-{model}.json")))
    if not structure:
        del cfg["structure_seed"]
    return cfg


def lengths():
    return traffic.lengths(traffic.load(os.path.join(DATA, "tiny-batch.json")))


def sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def structure_hash(task) -> str:
    h = hashlib.sha256()
    for part in (task.model, task.phones, task.mdef_lines, task.words,
                 task.prons, task.sents, sorted(task.tri.items())):
        h.update(repr(part).encode())
    h.update(np.ascontiguousarray(task.tp, np.float64).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("structure", [True, False],
                         ids=["structure_seed", "whole"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("model", ["cont", "semi"])
def test_generated_files_are_the_pinned_ones(tmp_path, monkeypatch, model,
                                             seed, structure):
    """Every file of the seed's model directory, its pool and its structure
    hash as they did before the move."""
    monkeypatch.setattr(harness, "CACHE", str(tmp_path))
    cfg = tiny_cfg(model, structure)
    kw = harness.model_dir(cfg, seed, lengths())[0]
    d = os.path.dirname(kw["lm"])
    got = {os.path.relpath(os.path.join(dp, f), d): sha(os.path.join(dp, f))
           for dp, _, fs in os.walk(d) for f in fs if f != "done"}
    size = gen_task.Size.from_dict(cfg["size"])
    task = (gen_task.structure(model, size, cfg["structure_seed"])
            if structure else
            gen_task.build(seed % (1 << 32), model, size, lengths()))
    got["structure"] = structure_hash(task)
    want = PINNED["files"][
        f"{model}-{'structure' if structure else 'whole'}-{seed}"]
    assert got == want


@pytest.mark.parametrize("case", sorted(PINNED["counts"]))
def test_counts_are_the_pinned_ones(case):
    """Operations, bytes and least times at both cells' real shapes."""
    c = PINNED["counts"][case]
    shape, T = c["shape"], c["T"]
    kind = kinds.load(shape["kind"])
    assert kind.score_flops(shape, T) == c["flops"]
    assert kind.score_bytes(shape, T) == c["bytes"]
    assert counters.score_flops(shape, T) == c["flops"]
    assert counters.score_bytes(shape, T) == c["bytes"]
    assert counters.score_least_s(shape, T) == c["least_s"]


@pytest.mark.parametrize("model", ["cont", "semi"])
def test_score_shape_is_the_pinned_one(tmp_path, monkeypatch, model):
    """The shapes the kind reads from the program's decoder."""
    from cmusphinx_tpu_torch.api import Decoder
    monkeypatch.setattr(harness, "CACHE", str(tmp_path))
    cfg = tiny_cfg(model, True)
    kw = harness.model_dir(cfg, SEEDS[0], lengths())[0]
    dec = Decoder(device="cpu", **kw, **cfg["decoder"])
    assert kinds.load(model).score_shape(dec) == PINNED["shapes"][model]


def test_an_unknown_kind_fails_naming_its_path(tiny_bench):
    with pytest.raises(LookupError, match=re.escape(kinds.path("nosuch"))):
        kinds.load("nosuch")
    with pytest.raises(LookupError, match=re.escape(kinds.path("nosuch"))):
        gen_task.build(0, "nosuch", gen_task.Size.from_dict(
            tiny_cfg("cont", True)["size"]), [100])
    cfg_path = os.path.join(os.path.dirname(tiny_bench),
                            "portbench/configs/tiny-cont.json")
    cfg = json.load(open(cfg_path))
    cfg["model"] = "nosuch"
    json.dump(cfg, open(cfg_path, "w"))
    with pytest.raises(LookupError, match=re.escape(kinds.path("nosuch"))):
        harness.run_cell(tiny_bench, "tiny-cont.batch", 1, 1.0, False,
                         device="cpu", log=lambda s: None)
    # It failed at once: nothing was generated.
    assert not os.path.exists(os.path.join(harness.CACHE, "models"))


@pytest.mark.parametrize("model,other", [("cont", "n_density_semi"),
                                         ("semi", "n_density")])
def test_a_size_key_of_another_kind_is_refused(model, other):
    """A configuration carries its kind's own size keys and no other's:
    a key that nothing would read fails before anything is generated."""
    size = dict(tiny_cfg(model, True)["size"], **{other: 8})
    with pytest.raises(ValueError, match=other):
        gen_task.structure(model, gen_task.Size.from_dict(size), 7)


def test_size_splits_the_shared_keys_from_the_kinds():
    size = gen_task.Size.from_dict(tiny_cfg("semi", True)["size"])
    assert size.own == {"n_density_semi": 32}
    assert size.pron_len == (2, 4) and size.n_word == 20


def test_the_kind_comes_from_the_configuration(tmp_path, monkeypatch):
    """A continuous model directory that also holds a stray sendump is read
    and scored as the configuration's continuous model."""
    monkeypatch.setattr(harness, "CACHE", str(tmp_path / "cache"))
    kw = harness.model_dir(tiny_cfg("cont", True), SEEDS[0], lengths())[0]
    semi = harness.model_dir(tiny_cfg("semi", True), SEEDS[0], lengths())[0]
    stray = str(tmp_path / "stray")
    shutil.copytree(os.path.dirname(kw["hmm"]), stray)
    shutil.copy(os.path.join(semi["hmm"], "sendump"),
                os.path.join(stray, "hmm"))
    x = ref_scores.features(np.random.RandomState(0).randn(50, 13))
    scores = []
    for hmm in (kw["hmm"], os.path.join(stray, "hmm")):
        m = ref_model.read_model(hmm, kw["lm"], kw["dict"], "cont")
        assert m.kind == "cont" and set(m.weights) == {"ln_mixw"}
        scores.append(ref_scores.reference_scorer(m, "cpu")(x))
    assert (scores[0] == scores[1]).all()


def in_root(root: str, code: str) -> dict:
    """Run `code` in a process whose `portbench` is the one under `root`
    (the program from the repository), and return the JSON it prints
    last."""
    src = f"import sys, json\nsys.path.append({ROOT!r})\n" + code
    p = subprocess.run([sys.executable, "-c", src], cwd=root,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_third_kind_runs_a_tiny_cell_from_files_alone(tmp_path):
    """`ptm1` added as `kinds/ptm1.py` with its configuration and cell:
    the program serves it (`PTMScorer`), the run is correct, and the
    reference in TF32 in the program's place is not."""
    root = str(tmp_path)
    bench = make_bench(root, extra=("ptm1",))
    out = in_root(root, f"""
from portbench import control, harness
harness.CACHE = {os.path.join(root, 'cache')!r}
def run(**kw):
    r = harness.run_cell({bench!r}, "tiny-ptm1.batch", 2**31 + 7, 2.0,
                         False, device="cpu", log=lambda s: None, **kw)
    return {{"line": r.line, "numbers": r.numbers}}
print(json.dumps({{"sound": run(), "tf32": run(**control.options("tf32"))}}))
""")
    line = out["sound"]["line"]
    assert line["correct"], out["sound"]["numbers"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["check"]) == {"score_gap", "word_gap", "missing"}
    assert not out["tf32"]["line"]["correct"]
    assert out["tf32"]["numbers"]["score_gap"] > \
        out["tf32"]["line"]["check"]["score_gap"]["limit"]


@pytest.mark.parametrize("seed", [0, 5])
def test_third_kind_model_files_equal_the_programs(tmp_path, seed):
    from cmusphinx_tpu_torch import fixture
    from test_portbench_gen import FILES
    root = str(tmp_path / "root")
    make_bench(root, extra=("ptm1",))
    size = {k: getattr(fixture.SMALL, k) for k in (
        "n_phone", "n_sen", "n_density_ptm", "n_word", "pron_len", "n_sent",
        "sent_len")}
    frozen = str(tmp_path / "frozen")
    in_root(root, f"""
from portbench.gen import task as gen_task
task = gen_task.build({seed}, "ptm1", gen_task.Size.from_dict({size!r}), [120, 160])
gen_task.write_model_dir(task, {frozen!r})
print("{{}}")
""")
    fx = fixture.build(seed, model="ptm", size=fixture.SMALL)
    fixture.write_model_dir(fx, str(tmp_path / "program"))
    for f in FILES + ["hmm/mixture_weights"]:
        assert filecmp.cmp(tmp_path / "program" / f, os.path.join(frozen, f),
                           shallow=False), f
