"""Host-only code shared with the JAX package, reached without importing JAX.

The port reuses the reference package's host-side readers and builders
instead of copying them: the model readers and writers (`models.mdef`,
`dict`, `dict2pid`, `tmat`, `gauden`, `ngram`, `sendump`, `mllr`,
`lmset`), the configuration and binary-I/O helpers (`utils.config`,
`utils.bio`), the LM estimator (`lm.estimate`) and the lexicon-graph
builder (`decode.lexgraph`).  All of them are numpy-only, so the port runs
on a machine that has no JAX.

The coupling, written down:

- `cmusphinx_tpu/__init__.py`, `models/__init__.py`, `utils/__init__.py` and
  `lm/__init__.py` import nothing from JAX, so those modules import plainly.
  (`utils/logmath.py` imports JAX only inside two functions that the port
  never calls.)
- `cmusphinx_tpu/decode/__init__.py` imports `fsg_search` and
  `ngram_search`, which import JAX.  `decode/lexgraph.py` itself does not,
  so it is loaded here by file path under its own module name; its relative
  imports (`..models.*`) then resolve to the jax-free model modules.  If the
  JAX package already loaded it in this process, that module is reused.
- `Hypothesis`/`Segment` (`decode/fsg_search.py`), `NGRAM_ARGS`
  (`decode/ngram_search.py`), `FEAT_ARGS` (`frontend/feat.py`), `FE_ARGS`
  and the filterbank builders (`frontend/fe.py`) and `DECODER_ARGS`
  (`api.py`) sit in modules that import JAX; the port keeps its own
  copies of them.

A change to any of these reference modules that adds a JAX import breaks
the port; `tests/test_torch_nojax.py` catches that.
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys

import cmusphinx_tpu
from cmusphinx_tpu.lm.estimate import train_lm
from cmusphinx_tpu.models.dict import Dictionary
from cmusphinx_tpu.models.dict2pid import Dict2Pid
from cmusphinx_tpu.models.gauden import GaussianParams, read_gauden
from cmusphinx_tpu.models.lmset import NgramModelSet
from cmusphinx_tpu.models.mdef import BAD_SENID, Mdef
from cmusphinx_tpu.models.mllr import MllrTransform
from cmusphinx_tpu.models.ngram import NgramModel
from cmusphinx_tpu.models.sendump import (read_mixture_weights, read_sendump,
                                          write_sendump)
from cmusphinx_tpu.models.tmat import TransitionMatrices
from cmusphinx_tpu.utils.bio import (S3File, read_mfc, write_mfc,
                                     write_s3_header)
from cmusphinx_tpu.utils.config import Arg, Config
from cmusphinx_tpu.utils.logmath import LOG_ZERO


def _load_lexgraph():
    name = "cmusphinx_tpu.decode.lexgraph"
    mod = sys.modules.get(name)
    if mod is None:
        path = (pathlib.Path(cmusphinx_tpu.__file__).parent
                / "decode" / "lexgraph.py")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
    return mod


_lexgraph = _load_lexgraph()
WordGraph = _lexgraph.WordGraph
build_word_graph = _lexgraph.build_word_graph

__all__ = [
    "Arg", "BAD_SENID", "Config", "Dict2Pid", "Dictionary", "GaussianParams",
    "LOG_ZERO", "Mdef", "MllrTransform", "NgramModel", "NgramModelSet",
    "S3File", "TransitionMatrices", "WordGraph", "build_word_graph",
    "read_gauden", "read_mfc", "read_mixture_weights", "read_sendump",
    "train_lm", "write_mfc", "write_s3_header", "write_sendump",
]
