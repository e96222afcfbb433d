from .fused_gmm import fused_mixture_scores, fused_mixture_scores_ref
from .gmm import (GEMM_PRECISIONS, ContinuousScorer, InterpolatedScorer,
                  PsParityScorer, PtmParityScorer, PTMScorer,
                  SemiContinuousScorer, density_logliks, logadd8_table)
from .hmm import NEG_INF, hmm_enter, hmm_init_state, hmm_step
