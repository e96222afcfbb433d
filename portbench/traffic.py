"""The one traffic generator: a mix's parameters (`traffic/<mix>.json`) and
the seed -> the pool's utterance lengths and the order of the work.

Keys of a mix:

- `kind`: `batch` (a closed loop of one client that decodes batches back
  to back, as a corpus run would feed a batching decoder);
- `pool`, `frames` [lo, hi]: the pool's utterances, `pool` lengths spaced
  evenly from lo to hi frames (10 ms each), the same for every seed;
- `batch` (utterances a batch; each pass over the pool is a new seeded
  permutation cut into batches, the first pass starting with the batch
  that holds the pool's longest utterance), `profile_batches` (batches the
  traced run profiles, from the third on; every run decodes at least
  those and the two before them), `check_batches` (batches whose scores
  and hypotheses are checked: the first, and others drawn from the seed
  among those every run decodes).
"""

from __future__ import annotations

import json
from typing import List

import numpy as np

FRAME_S = 0.01
# The traced run profiles batches from this one on.
PROFILE_FROM = 2


def load(path: str) -> dict:
    with open(path) as fh:
        mix = json.load(fh)
    if mix.get("kind") != "batch":
        raise ValueError(f"{path}: kind must be batch")
    return mix


def lengths(mix: dict) -> List[int]:
    lo, hi = mix["frames"]
    return [int(x) for x in np.round(np.linspace(lo, hi, int(mix["pool"])))]


def rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), salt])


def batch_plan(mix: dict, seed: int, n_batches: int) -> List[List[int]]:
    """Batches of pool indices: passes over the pool, each a permutation
    cut into batches of `batch`; the first pass's batch that holds the
    longest utterance goes first."""
    g, n, B = rng(seed, 1), int(mix["pool"]), int(mix["batch"])
    out: List[List[int]] = []
    while len(out) < n_batches:
        perm = [int(i) for i in g.permutation(n)]
        cut = [perm[i: i + B] for i in range(0, n - B + 1, B)]
        if not out:
            cut.sort(key=lambda b: n - 1 not in b)
        out += cut
    return out[:n_batches]


def decoded(mix: dict) -> int:
    """Batches that every run decodes: up to the last profiled one."""
    return PROFILE_FROM + int(mix["profile_batches"])


def check_batches(mix: dict, seed: int, plan: List[List[int]]) -> List[int]:
    """Indices into the plan of the checked batches: the first (it holds
    the pool's longest utterance), then others drawn among the batches
    every run decodes."""
    rest = list(range(1, min(decoded(mix), len(plan))))
    k = int(mix["check_batches"]) - 1
    picked = rng(seed, 2).choice(rest, size=min(k, len(rest)), replace=False)
    return [0] + sorted(int(i) for i in picked)
