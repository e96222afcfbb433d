"""Frontend / grammar / inspection CLI tools.

Subcommands mirror the sphinxbase utilities (reference:
sphinxbase/src/sphinx_fe batch wave->cep, sphinx_cepview, sphinx_jsgf2fsg,
sphinx_pitch):

    python -m cmusphinx_tpu_torch.cli.tools fe -i in.raw -o out.mfc [-samprate N] ...
    python -m cmusphinx_tpu_torch.cli.tools fe -c ctl -di rawdir -do cepdir \
        -ei raw -eo mfc
    python -m cmusphinx_tpu_torch.cli.tools cepview -f file.mfc [-d 13]
    python -m cmusphinx_tpu_torch.cli.tools jsgf2fsg -jsgf g.gram -fsg out.fsg \
        [-toprule name]
    python -m cmusphinx_tpu_torch.cli.tools pitch -i in.raw -o out.f0

`-platform cpu` runs `fe` on the CPU; any other value, or none, on the
CUDA card (`cli/batch.device_of`).  The other subcommands run on the
host.
"""

from __future__ import annotations

import os
import sys

from ..frontend.fe import FE_ARGS, Frontend
from ..frontend.pitch import yin_pitch
from ..models.jsgf import JsgfGrammar
from ..utils.bio import read_mfc, read_raw_audio, write_mfc
from ..utils.config import Config
from .batch import device_of, parse_argv


def _fe_one(fe: Frontend, inpath: str, outpath: str) -> int:
    raw = read_raw_audio(inpath)
    cep = fe.process(raw)                 # on the host, to be written
    write_mfc(outpath, cep)
    return len(cep)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 1
    cmd, kv = argv[0], parse_argv(argv[1:])
    device = device_of({"platform": kv.pop("platform", "")})
    if cmd == "fe":
        cfg = Config(FE_ARGS)
        cfg.update(**{k: v for k, v in kv.items() if k in cfg})
        fe = Frontend(cfg, device=device)
        if "c" in kv:  # control-file batch (sphinx_fe -c)
            n = 0
            for line in open(kv["c"]):
                utt = line.strip()
                if not utt:
                    continue
                src = os.path.join(kv.get("di", ""), utt + "." + kv.get("ei", "raw"))
                dst = os.path.join(kv.get("do", ""), utt + "." + kv.get("eo", "mfc"))
                os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
                nf = _fe_one(fe, src, dst)
                print(f"{utt}: {nf} frames")
                n += 1
            print(f"processed {n} files")
        else:
            nf = _fe_one(fe, kv["i"], kv["o"])
            print(f"{kv['i']} -> {kv['o']}: {nf} frames")
    elif cmd == "cepview":
        ncep = int(kv.get("d", 13))
        cep = read_mfc(kv["f"], ncep=ncep)
        for t, row in enumerate(cep):
            print(f"{t:5d} " + " ".join(f"{v:8.3f}" for v in row))
    elif cmd == "jsgf2fsg":
        gram = JsgfGrammar.parse_file(kv["jsgf"])
        fsg = gram.build_fsg(kv.get("toprule"))
        with open(kv["fsg"], "w") as fh:
            fsg.write(fh)
        print(f"{kv['jsgf']} -> {kv['fsg']}: {fsg.n_state} states, "
              f"{len(fsg.links)} transitions")
    elif cmd == "pitch":
        raw = read_raw_audio(kv["i"])
        f0 = yin_pitch(raw, sample_rate=float(kv.get("samprate", 16000)))
        with open(kv["o"], "w") as fh:
            for t, v in enumerate(f0):
                fh.write(f"{t * 0.01:.2f} {v:.1f}\n")
        voiced = (f0 > 0).mean() if len(f0) else 0
        print(f"{kv['i']} -> {kv['o']}: {len(f0)} frames, "
              f"{100 * voiced:.0f}% voiced")
    elif cmd == "htk2s3":
        # htk2s3conv capability: HTK MMF -> Sphinx-3 model directory.
        from ..models.htk import convert_htk
        m = convert_htk(kv["i"], kv["o"], feat=kv.get("feat", "1s_c_d_dd"))
        print(f"{kv['i']} -> {kv['o']}: {m.n_ciphone} CI phones, "
              f"{m.n_phone - m.n_ciphone} triphones, {m.n_sen} senones, "
              f"{m.n_tmat} tmats")
    elif cmd == "cfg2fsg":
        # sphinx3 cfg2fsg capability: CFG or SRGS grammar -> FSG file.
        from ..models.cfg import Cfg
        if kv.get("srgs"):
            g = Cfg.parse_srgs_file(kv["srgs"])
            src = kv["srgs"]
        else:
            g = Cfg.read_simple(kv["cfg"])
            src = kv["cfg"]
        fsg = g.to_fsg(max_expansion=int(kv.get("maxexp", 2)))
        with open(kv["fsg"], "w") as fh:
            fsg.write(fh)
        print(f"{src} -> {kv['fsg']}: {fsg.n_state} states, "
              f"{len(fsg.links)} transitions")
    elif cmd == "mdef_convert":
        # pocketsphinx_mdef_convert capability: text <-> binary BMDF.
        from ..models.mdef import Mdef
        m = Mdef.read(kv["i"])
        if kv.get("text"):
            m.write_text(kv["o"])
        else:
            m.write_binary(kv["o"])
        print(f"{kv['i']} -> {kv['o']}: {m.n_ciphone} CI phones, "
              f"{m.n_phone - m.n_ciphone} triphones, {m.n_sen} senones")
    elif cmd == "lm_convert":
        # sphinx_lm_convert capability: ARPA <-> DMP by extension/-ofmt.
        from ..models.ngram import NgramModel
        lm = NgramModel.read(kv["i"])
        ofmt = kv.get("ofmt") or ("dmp" if kv["o"].lower().endswith(
            (".dmp",)) else "arpa")
        if ofmt == "dmp":
            lm.write_dmp(kv["o"])
        else:
            lm.write_arpa(kv["o"])
        print(f"{kv['i']} -> {kv['o']} ({ofmt}); counts={lm.counts()}")
    elif cmd == "lm_eval":
        # sphinx_lm_eval capability: perplexity over a transcript file.
        from ..models.ngram import NgramModel
        lm = NgramModel.read(kv["lm"])
        sents = []
        for line in open(kv["text"]):
            ws = [w for w in line.split() if w not in ("<s>", "</s>")]
            if ws:
                sents.append(ws)
        ppl, nw, oov = lm.perplexity(sents)
        print(f"perplexity {ppl:.4f} over {len(sents)} sentences "
              f"({nw} words, {oov} OOV)")
    elif cmd == "lm2fst":
        # lm_attfsm / sphinx_lm_fst capability.
        from ..models.fst import write_lm_fst
        from ..models.ngram import NgramModel
        lm = NgramModel.read(kv["i"])
        write_lm_fst(lm, kv["o"], symfile=kv.get("syms"))
        print(f"{kv['i']} -> {kv['o']} (ATT FSM)")
    elif cmd == "am2fst":
        # sphinx_am_fst capability: mdef+tmat -> HMM-level FST.
        from ..models.mdef import Mdef
        from ..models.tmat import TransitionMatrices
        from ..models.fst import write_am_fst
        mdef = Mdef.read(kv["mdef"])
        tmat = TransitionMatrices.read(kv["tmat"])
        write_am_fst(mdef, tmat, kv["fst"],
                     isymfile=kv.get("isym"), osymfile=kv.get("osym"),
                     triphones=bool(kv.get("triphones")))
        print(f"{kv['mdef']} -> {kv['fst']}")
    elif cmd == "fsg2fst":
        from ..models.fsg import FsgModel
        from ..models.fst import write_fsg_fst
        fsg = FsgModel.read(kv["i"])
        write_fsg_fst(fsg, kv["o"], symfile=kv.get("syms"))
        print(f"{kv['i']} -> {kv['o']} (ATT FSM)")
    elif cmd == "compile_gra":
        # logios MakeGra capability: Phoenix .gra task grammar ->
        # sampled corpus / n-gram LM / FSG (the MakeGra -> MakeLM
        # language-compilation pipeline; compile_gra.pl + cfg2ngram):
        #   compile_gra -gra F [-forms F] [-corpus out.txt -n 200]
        #               [-lm out.arpa] [-fsg out.fsg]
        from ..models.cfg import cfg_to_ngram, sample_sentences
        from ..models.phoenix import PhoenixGrammar, read_forms
        g = PhoenixGrammar.parse_file(kv["gra"])
        forms = read_forms(kv["forms"]) if kv.get("forms") else None
        cfg_g = g.to_cfg(forms)
        print(f"{kv['gra']}: {len(g.nets)} nets, {len(g.macros)} macros, "
              f"{len(cfg_g.rules)} CFG rules")
        if kv.get("corpus"):
            sents = sample_sentences(cfg_g, int(kv.get("n", 200)))
            with open(kv["corpus"], "w") as fh:
                for s in sents:
                    fh.write(" ".join(s) + "\n")
            print(f"sampled {len(sents)} sentences -> {kv['corpus']}")
        if kv.get("lm"):
            m = cfg_to_ngram(cfg_g, samples=int(kv.get("samples", 5000)))
            m.write_arpa(kv["lm"])
            print(f"estimated LM -> {kv['lm']} (counts {m.counts()})")
        if kv.get("fsg"):
            fsg = cfg_g.to_fsg(max_expansion=int(kv.get("maxexp", 2)))
            with open(kv["fsg"], "w") as fh:
                fsg.write(fh)
            print(f"FSG -> {kv['fsg']} ({fsg.n_state} states)")
    elif cmd in ("dag", "astar", "conf"):
        # Offline lattice rescoring tools (sphinx3_dag / sphinx3_astar /
        # sphinx3_conf capability; sphinx3 dag.c:1466, astar.c, conf):
        #   dag   -lat F -lm LM [-lw W] [-wip P]       -> bestpath hyp
        #   astar -lat F -lm LM [-n N]                 -> N-best list
        #   conf  -lat F -lm LM [-ascale A]            -> word confidences
        import math as _m
        from ..decode.lattice import read_htk_lattice, read_lattice
        from ..models.ngram import NgramModel
        lw = float(kv.get("lw", 9.5))
        if kv["lat"].lower().endswith((".slf", ".htk")):
            # HTK SLF lattices (CLP / htk2dag capability); -lm optional —
            # without it the file's own a=/l= link scores drive rescoring.
            lm = NgramModel.read(kv["lm"]) if kv.get("lm") else None
            lat = read_htk_lattice(kv["lat"], lm,
                                   lw=lw if lm is not None else 1.0,
                                   log_wip=(_m.log(float(kv.get("wip", 0.65)))
                                            if lm is not None else 0.0))
            lm = lat.lm
        else:
            lm = NgramModel.read(kv["lm"])
            lat = read_lattice(kv["lat"], lm, lw=lw,
                               log_wip=_m.log(float(kv.get("wip", 0.65))))
        start = lm.word_id("<s>")
        if cmd == "dag":
            hyp = lat.bestpath(lw=lw, start_lmwid=start)
            print(f"BSTPTH: {hyp.text}")
            print(f"BSTXCT: {hyp.score:.2f}")
        elif cmd == "astar":
            for h in lat.nbest(int(kv.get("n", 10)), lw=lw,
                               start_lmwid=start):
                print(f"{h.text} ({h.score:.2f})")
        else:
            hyp = lat.bestpath(lw=lw, start_lmwid=start)
            confs = lat.word_confidence(hyp.segments,
                                        ascale=1.0 / float(kv.get("ascale", 20)))
            for word, sf, ef, lp in confs:
                print(f"{word} {sf} {ef} {lp:.4f}")
    else:
        print(__doc__)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
