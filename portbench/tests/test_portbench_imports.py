"""What the benchmark's modules import, by whole top-level name: no JAX
and not the JAX package anywhere (`cmusphinx_tpu_torch` begins with
`cmusphinx_tpu` and is another package); the reference, the generator
and the yardstick nothing of the program either."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
JAX = {"jax", "jaxlib", "flax", "cmusphinx_tpu"}
PROGRAM = "cmusphinx_tpu_torch"
# Modules that take nothing of the program: the reference, the generator,
# the kinds and their loader, the traffic, the counters and the trace
# reduction.
INDEPENDENT = ("reference", "gen", "kinds", "byname.py", "traffic.py",
               "counters.py", "trace.py", "check.py", "layers.py", "metrics")


def sources():
    for d, _, files in os.walk(PKG):
        if "/." in d or "__pycache__" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_no_jax(path):
    assert not set(top_names(path)) & JAX


@pytest.mark.parametrize("path", sorted(
    p for p in sources()
    if os.path.relpath(p, PKG).split(os.sep)[0] in INDEPENDENT),
    ids=lambda p: os.path.relpath(p, PKG))
def test_reference_takes_nothing_of_the_program(path):
    assert PROGRAM not in set(top_names(path))
