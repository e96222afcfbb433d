"""Continuous decoder CLI (pocketsphinx_continuous capability, file mode).

Port of `cmusphinx_tpu/cli/continuous.py`.  Reference:
pocketsphinx/src/programs/continuous.c — live decoding with cont_ad VAD
segmentation.  `-infile` mode (the reference supports it too) segments a
long recording with the VAD and streams each speech segment through the
decoder (`SpeechPipeline`):

    python -m cmusphinx_tpu_torch.cli.continuous -hmm DIR -lm LM -dict DICT \
        -infile audio.raw [-partials yes] [-platform cpu]

It decodes on the card unless `-platform cpu` is given.
"""

from __future__ import annotations

import sys

from ..api import DECODER_ARGS, Decoder
from ..decode.ngram_search import NGRAM_ARGS
from ..frontend.fe import FE_ARGS
from ..frontend.feat import FEAT_ARGS
from ..frontend.source import RawFileSource, WavFileSource
from ..pipeline import SpeechPipeline
from ..utils.config import Arg, Config
from .batch import device_of, parse_argv

CONT_ARGS = [
    Arg("infile", str, "",
        "Audio file to transcribe (16-bit headerless PCM, or .wav)"),
    Arg("vad_delta", float, 9.0, "Speech onset threshold over noise floor (dB)"),
    Arg("partials", bool, False,
        "Print streaming partial hypotheses during speech segments "
        "(gst-plugin partial-result bus messages)"),
    Arg("platform", str, "", "Device: 'cpu', else the CUDA card"),
]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kv = parse_argv(argv)
    cfg = Config(DECODER_ARGS, FE_ARGS, FEAT_ARGS, NGRAM_ARGS).register(CONT_ARGS)
    cfg.update(**kv)
    if not str(cfg["infile"]):
        raise SystemExit("-infile is required (no audio capture device)")
    dec = Decoder(cfg, device=device_of(cfg))
    sr = float(cfg["samprate"])
    path = str(cfg["infile"])
    src = (WavFileSource(path) if path.endswith(".wav")
           else RawFileSource(path, sample_rate=sr))

    def on_partial(text, t):
        if bool(cfg["partials"]) and text:
            print(f"  partial @{t:7.2f}s: {text}", flush=True)

    n_segments = 0

    def on_result(hyp, t0, t1):
        nonlocal n_segments
        n_segments += 1
        print(f"[{t0:8.2f} - {t1:8.2f}] {hyp.text}", flush=True)

    pipe = SpeechPipeline(dec, on_partial=on_partial, on_result=on_result,
                          vad_delta=float(cfg["vad_delta"]),
                          sample_rate=src.sample_rate)
    pipe.run(src)
    src.close()
    if n_segments == 0:
        print("(no speech detected)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
