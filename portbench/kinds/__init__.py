"""Acoustic-model kinds, one module a kind: `kinds/<name>.py`, found by
the name a configuration gives under "model".  A kind holds everything of
the benchmark that differs by the acoustic model:

- `SIZE_KEYS`: its own keys of the configuration's `size` (the structure's
  keys are `gen.task.Size`'s);
- `FEAT_PARAMS`: the lines of the model directory's feat.params;
- `acoustic(rng, size, structure)`: the acoustic model of the seed, a
  `gen.task.Acoustic` drawn from `rng` (the structure gives the mdef lines
  and the triphones' senones);
- `write_weights(am, hmm)`: its weight files in the model directory `hmm`;
- `read_weights(hmm, model)`: the reference's reading of those files, a
  dict that becomes `model.weights` (`model`: the `reference.model.Model`
  read so far: mdef, Gaussians, feat.params);
- `reference_scorer(model, device, precision)`: the plain reference's
  senone scorer, features [N, D] -> scores [N, S], in float64 (`f64`) or
  as the TF32 control (`tf32`);
- `score_shape(decoder)`: the program's scorer's shapes, a dict whose
  "kind" is the kind's name, and `score_flops(shape, T)`,
  `score_bytes(shape, T)`: the operations and bytes of scoring T frames.
"""

from __future__ import annotations

from types import ModuleType

from .. import byname


def path(name: str) -> str:
    return byname.path("kinds", name)


def load(name: str) -> ModuleType:
    """The kind `name`; a name with no file fails, naming the path."""
    return byname.load("kinds", name)
