"""Batch decoder CLI (pocketsphinx_batch capability).

Port of `cmusphinx_tpu/cli/batch.py` (`BATCH_ARGS`, `parse_argv`, `main`).
Reference:
pocketsphinx/src/programs/batch.c — control-file driven batch decode with
hypothesis/hypseg/lattice output and an xRT report (:759-777 "AVERAGE
xRT").  Usage:

    python -m cmusphinx_tpu_torch.cli.batch -hmm DIR -lm LM -dict DICT \
        -ctl FILE -cepdir DIR [-cepext .mfc | -adcin yes] \
        [-hyp FILE] [-hypseg FILE] [-outlatdir DIR] [-bestpath yes] \
        [-nbest N -nbestdir DIR] [-part i -npart N] [-platform cpu]

It decodes on the card unless `-platform cpu` is given.  `-part`/`-npart`
select one partition of the control file.  With `-npart N` and no `-part`,
a process of a multi-process run (torchrun's environment, see
`parallel.hosts.init_distributed`: NCCL on the card, gloo with `-platform
cpu`) takes partition rank+1 of N; a single process decodes the whole
file, as the reference does on one host.
"""

from __future__ import annotations

import os
import sys
import time

import torch.distributed as dist

from ..api import DECODER_ARGS, Decoder
from ..decode.ngram_search import NGRAM_ARGS
from ..frontend.fe import FE_ARGS
from ..frontend.feat import FEAT_ARGS
from ..parallel.hosts import init_distributed, partition_ctl
from ..utils.config import Arg, Config
from ..utils.log import E_ERROR, E_INFO, err_set_debug_level, err_set_logfile
from ..utils.profile import Profile

BATCH_ARGS = [
    Arg("ctl", str, "", "Control file listing utterances to be processed"),
    Arg("cepdir", str, "", "Input files directory"),
    Arg("cepext", str, ".mfc", "Input files extension"),
    Arg("adcin", bool, False, "Input is raw audio data (headerless 16-bit PCM)"),
    Arg("hyp", str, "", "Recognition output file name"),
    Arg("hypseg", str, "", "Recognition output with segmentation file name"),
    Arg("outlatdir", str, "", "Directory for dumping word lattices"),
    Arg("nbestdir", str, "", "Directory for writing N-best hypothesis lists"),
    Arg("nbest", int, 0, "Number of N-best hypotheses to write per utterance"),
    Arg("part", int, 0,
        "Process only partition `part` of `npart` of the control file "
        "(1-based; bw/sphinx3 -part semantics, corpus.c).  With 0, each "
        "process of a multi-process run takes partition rank+1"),
    Arg("npart", int, 0, "Total number of control-file partitions"),
    Arg("platform", str, "", "Device: 'cpu', else the CUDA card"),
    Arg("logfn", str, "", "Log file (err.h err_set_logfile)"),
    Arg("debug", int, 0, "Debug level (err.h err_set_debug_level)"),
]

def parse_argv(argv):
    """Sphinx-style `-key value` argument parsing."""
    kv = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith("-"):
            raise SystemExit(f"unexpected argument {a!r}")
        key = a.lstrip("-")
        if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
            kv[key] = argv[i + 1]
            i += 2
        elif (i + 1 < len(argv) and len(argv[i + 1]) > 1
              and argv[i + 1][1].isdigit()):
            kv[key] = argv[i + 1]  # negative number value
            i += 2
        else:
            kv[key] = "yes"
            i += 1
    return kv


def device_of(cfg: Config) -> str:
    """The reference's `-platform` flag: `cpu` selects the CPU, any other
    value or none the CUDA card."""
    return "cpu" if str(cfg["platform"]).lower() == "cpu" else "cuda"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kv = parse_argv(argv)
    cfg = Config(DECODER_ARGS, FE_ARGS, FEAT_ARGS, NGRAM_ARGS).register(BATCH_ARGS)
    cfg.update(**kv)
    if not str(cfg["ctl"]):
        raise SystemExit("-ctl is required")
    if str(cfg["logfn"]):
        err_set_logfile(str(cfg["logfn"]))
    err_set_debug_level(int(cfg["debug"]))
    # Corpus partitioning (bw -part/-npart; a multi-process run picks its
    # own part), before the Decoder: a rank's card is chosen on joining.
    npart, part = int(cfg["npart"]), int(cfg["part"])
    joined = False
    if npart > 1 and part == 0:
        up = dist.is_initialized()
        info = init_distributed(device=device_of(cfg))
        joined = info.initialized and not up
        if info.num_processes > 1:
            part = info.process_id + 1
    prof = Profile()
    with prof.timer("init"):
        dec = Decoder(cfg, device=device_of(cfg))
    if getattr(dec, "search", None) is not None and \
            hasattr(dec.search, "graph"):
        g = dec.search.graph
        E_INFO("search graph: %d channels, %d words, rc_mode=%s",
               g.n_chan, g.n_word, getattr(g, "rc_mode", "?"))

    with open(str(cfg["ctl"])) as fh:
        ctl = [l.strip() for l in fh if l.strip()]
    if npart > 1 and part > 0:
        ctl = partition_ctl(ctl, part, npart)
        E_INFO("processing partition %d/%d: %d utterances",
               part, npart, len(ctl))
    hyp_fh = open(str(cfg["hyp"]), "w") if str(cfg["hyp"]) else None
    seg_fh = open(str(cfg["hypseg"]), "w") if str(cfg["hypseg"]) else None
    total_audio = total_wall = 0.0
    n_done = prof.counter("utts")
    n_words = prof.counter("words")
    skipped = []  # per-utterance error isolation (sphinx3 utt.c: warn+continue)
    for utt in ctl:
        path = os.path.join(str(cfg["cepdir"]), utt + str(cfg["cepext"]))
        t0 = time.time()
        try:
            with prof.timer("decode"):
                if bool(cfg["adcin"]):
                    hyp = dec.decode_raw(path)
                    n_frames = len(dec.seg()) and dec.seg()[-1].end_frame + 1
                else:
                    hyp = dec.decode_cep_file(path)
                    n_frames = dec.seg()[-1].end_frame + 1 if dec.seg() else 0
        except KeyboardInterrupt:
            raise
        except Exception as e:
            # One bad utterance must not abort the corpus run: the
            # reference's batch driver logs the failure and moves on
            # (sphinx3 libAPI/utt.c).
            E_ERROR("%s: decode failed, skipping: %s: %s",
                    utt, type(e).__name__, e)
            skipped.append(utt)
            dec.abort_utt()  # reset mid-utterance state for the next utt
            continue
        dt = time.time() - t0
        audio_s = n_frames * 0.01
        total_audio += audio_s
        total_wall += dt
        n_done.increment()
        n_words.increment(len(hyp.words))
        E_INFO("%s: %d frames, %.2fs wall%s", utt, n_frames, dt,
               f" ({dt / audio_s:.2f} xRT)" if audio_s else "")
        print(f"{utt}: {hyp.text}", flush=True)
        if hyp_fh:
            hyp_fh.write(f"{hyp.text} ({utt} {hyp.score:.0f})\n")
        if seg_fh:
            parts = [utt, "S", "0", "T", f"{hyp.score:.0f}"]
            for s in hyp.segments:
                parts += [str(s.start_frame), f"{s.score:.0f}", s.word]
            seg_fh.write(" ".join(parts) + "\n")
        if str(cfg["outlatdir"]):
            lat = dec.get_lattice()
            lat.write(os.path.join(str(cfg["outlatdir"]), utt + ".lat"),
                      uttid=utt)
        if str(cfg["nbestdir"]) and int(cfg["nbest"]):
            with open(os.path.join(str(cfg["nbestdir"]), utt + ".nbest"),
                      "w") as fh:
                for h in dec.nbest(int(cfg["nbest"])):
                    fh.write(f"{h.text} ({h.score:.0f})\n")
    if hyp_fh:
        hyp_fh.close()
    if seg_fh:
        seg_fh.close()
    if total_audio:
        print(f"TOTAL {total_audio:.2f} seconds speech, "
              f"{total_wall:.2f} seconds wall")
        print(f"AVERAGE {total_wall / total_audio:.2f} xRT")
        print(f"STATS {prof.report(audio_seconds=total_audio)}")
    if skipped:
        E_ERROR("%d/%d utterances FAILED and were skipped: %s",
                len(skipped), len(ctl), " ".join(skipped))
        print(f"SKIPPED {len(skipped)}: {' '.join(skipped)}")
    if joined:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
