"""Acoustic-model training: Baum-Welch EM, CD pipeline, transforms, MMIE.

The port of `cmusphinx_tpu/train/`, module for module: the parameters and
accumulators are numpy on the host, each EM step's forward-backward runs on
the device (`device`, default "cuda")."""

from .bw import UttBatch, forward_backward, pack_batch, viterbi_align
from .mmie import accumulate_mmie, ebw_update, lattice_den_batch
from .sentence_hmm import FlatModel, SentHmm, build_sentence_hmm
from .trainer import HmmParams, Trainer, flat_start, reestimate
from .transform import (apply_mllt_to_model, class_scatter_stats,
                        deleted_interpolation, estimate_lda, estimate_mllt,
                        map_adapt, mixw_interp)
