"""cmusphinx_tpu_torch — the PyTorch + CUDA port of cmusphinx_tpu.

The JAX package `cmusphinx_tpu` stays the reference; this package holds the
port, slice by slice (ROADMAP.md).  It imports torch and never JAX, and
nothing of the reference package: it carries its own copies of the numpy-only
host code — the model readers and writers (`models/`), binary I/O,
configuration and log-domain constants (`utils/`), the LM estimator
(`lm/estimate.py`) and the lexicon-graph builder (`decode/lexgraph.py`).

Ported so far: the batched N-gram decode path `NgramSearch.decode_batch_cep`
with a continuous-density acoustic model — the batch feature kernel, the
continuous GMM scorer (CUDA kernel K1 in `csrc/fused_gmm.cu`), the HMM
frame step, the dense trigram table and the flat fanout/mpx Viterbi search
with its device backtrace.
"""

import torch

# GMM log-densities are sensitive to precision: the expanded quadratic form
# cancels terms of the size of prec*mean^2 (~1e6 nats on trained models with
# floored variances), so TF32's 10-bit mantissa would cost whole nats and
# flip Viterbi paths (the reference asks for Precision.HIGHEST for the same
# reason, cmusphinx_tpu/ops/gmm.py).  Every f32 product runs in IEEE f32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
