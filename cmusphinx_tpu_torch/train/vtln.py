"""VTLN warp-factor estimation by forced-alignment likelihood.

Capability parity with the trainer's VTLN stage (reference:
SphinxTrain/scripts_pl/12.vtln_align/slave_align.pl:156-170 — loop the
warp grid CFG_VTLN_START..END..STEP (defaults 0.80..1.45 by 0.05),
recompute features with each warp applied, force-align the transcripts,
and keep the argmax-likelihood warp per speaker).  The warp *application*
lives in frontend/fe.py (fe_warp_{inverse_linear,affine,
piecewise_linear}.c parity); this module adds the missing *estimation*.

Candidate warps only change the mel filterbank matrix, so each warp is a
frontend + feature pass on `device` (the port's `Frontend` and
`FeatPipeline`, default "cuda") and one alignment an utterance through the
given aligner; the per-warp totals reduce on the host (the grid is tiny).
Ported from `cmusphinx_tpu/train/vtln.py`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.log import E_INFO


def default_warp_grid(start: float = 0.80, end: float = 1.45,
                      step: float = 0.05) -> np.ndarray:
    """The reference's CFG_VTLN_START/END/STEP defaults."""
    return np.round(np.arange(start, end + 1e-9, step), 2)


def estimate_vtln(raw_utts: Sequence[np.ndarray],
                  transcripts: Sequence[Sequence[str]],
                  aligner, cfg, warps: Optional[Sequence[float]] = None,
                  warp_type: str = "inverse_linear",
                  device: torch.device | str = "cuda"
                  ) -> Tuple[float, Dict[float, float]]:
    """Estimate one speaker's warp factor.

    raw_utts: raw audio sample arrays for the speaker's utterances.
    transcripts: word sequences per utterance.
    aligner: anything whose .align(feats, words) returns (wsegs, phsegs,
        states, score), such as decode.align.AlignSearch over the current
        model.
    cfg: frontend Config (FE_ARGS + FEAT_ARGS, feat.params applied);
        its warp settings are overridden per grid point.
    Returns (best_warp, {warp: total alignment log-likelihood}).
    """
    from ..frontend import FeatPipeline, Frontend
    if warps is None:
        warps = default_warp_grid()
    totals: Dict[float, float] = {}
    for warp in warps:
        c = cfg.copy()
        c.update(warp_type=warp_type, warp_params=f"{float(warp):g}")
        fe = Frontend(c, device=device)
        fp = FeatPipeline(c, device=device)
        total = 0.0
        for raw, words in zip(raw_utts, transcripts):
            feats = fp.compute(fe.process(np.asarray(raw, np.float32)))
            _, _, _, score = aligner.align(feats, list(words))
            total += float(score)
        totals[float(warp)] = total
        E_INFO("vtln warp %.2f: total alignment ll %.2f", warp, total)
    best = max(totals, key=totals.get)
    return best, totals


def estimate_vtln_per_speaker(utt_speaker: Sequence[str],
                              raw_utts: Sequence[np.ndarray],
                              transcripts: Sequence[Sequence[str]],
                              aligner, cfg,
                              warps: Optional[Sequence[float]] = None,
                              device: torch.device | str = "cuda"
                              ) -> Dict[str, float]:
    """Group utterances by speaker id and estimate each speaker's warp
    (the per-speaker ctl grouping slave_align.pl performs via the vtlnctl
    file).  Returns {speaker: warp}."""
    groups: Dict[str, List[int]] = {}
    for i, spk in enumerate(utt_speaker):
        groups.setdefault(spk, []).append(i)
    out: Dict[str, float] = {}
    for spk, idx in groups.items():
        best, _ = estimate_vtln([raw_utts[i] for i in idx],
                                [transcripts[i] for i in idx],
                                aligner, cfg, warps=warps, device=device)
        out[spk] = best
        E_INFO("vtln speaker %s -> warp %.2f", spk, best)
    return out
