"""Batch decoder CLI (pocketsphinx_batch capability).

Port of `cmusphinx_tpu/cli/batch.py` (`BATCH_ARGS`, `parse_argv`, `main`)
and of `cmusphinx_tpu/parallel/hosts.py`'s `partition_ctl`.  Reference:
pocketsphinx/src/programs/batch.c — control-file driven batch decode with
hypothesis/hypseg/lattice output and an xRT report (:759-777 "AVERAGE
xRT").  Usage:

    python -m cmusphinx_tpu_torch.cli.batch -hmm DIR -lm LM -dict DICT \
        -ctl FILE -cepdir DIR [-cepext .mfc | -adcin yes] \
        [-hyp FILE] [-hypseg FILE] [-outlatdir DIR] [-bestpath yes] \
        [-nbest N -nbestdir DIR] [-part i -npart N] [-platform cpu]

It decodes on the card unless `-platform cpu` is given.  `-part`/`-npart`
select one partition of the control file; a run of several processes that
picks its partition itself (`-npart N` without `-part`) is ROADMAP A17 and
raises NotImplementedError; a single process decodes the whole file, as the
reference does on one host.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Sequence

from ..api import DECODER_ARGS, Decoder
from ..decode.ngram_search import NGRAM_ARGS
from ..frontend.fe import FE_ARGS
from ..frontend.feat import FEAT_ARGS
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
        "(1-based; bw/sphinx3 -part semantics, corpus.c).  With 0, a "
        "multi-process run would select its own partition (not ported "
        "yet, ROADMAP A17)"),
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


def partition_ctl(items: Sequence, part: int, npart: int) -> List:
    """The bw/sphinx3 `-part i -npart N` ctl split (corpus.c
    corpus_set_partition: contiguous blocks, remainder spread over the
    first parts; 1-based part ids like the reference flags)."""
    if not (1 <= part <= npart):
        raise ValueError(f"part must be in [1, {npart}], got {part}")
    n = len(items)
    base, rem = divmod(n, npart)
    sizes = [base + (1 if i < rem else 0) for i in range(npart)]
    lo = sum(sizes[: part - 1])
    return list(items[lo : lo + sizes[part - 1]])


def _num_processes() -> int:
    """The size of the run, as torch.distributed's launchers give it."""
    return int(os.environ.get("WORLD_SIZE") or 1)


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
    # Corpus partitioning (bw -part/-npart).
    npart, part = int(cfg["npart"]), int(cfg["part"])
    if npart > 1 and part == 0 and _num_processes() > 1:
        raise NotImplementedError(
            "a multi-process run choosing its own -part is not ported yet "
            "(ROADMAP A17); give each process -part explicitly")
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
