"""Top-level decoder API (port of `cmusphinx_tpu/api.py`: `DECODER_ARGS` and
`Decoder` with every search of the reference: N-gram, batch and streaming,
with its results; grammar (-fsg, -jsgf, -srgs, -cfg); allphone; forced
alignment by `align`).

    d = Decoder(hmm=".../model_dir", lm=".../lm.arpa", dict=".../words.dict",
                device="cuda")
    d.start_utt(streaming=True)
    for chunk in audio:
        d.process_raw(chunk)       # decoded as it arrives
        print(d.hyp().text)        # partial hypothesis
    d.end_utt()
    print(d.hyp().text, d.get_prob(), [h.text for h in d.nbest(5)])

Without `streaming` the audio or cepstra are buffered and decoded whole
at `end_utt`.  A streaming utterance runs the frontend (`FrontendStream`),
the live feature path (prior-mode CMN and AGC, `FeatPipeline.
normalize_live`) and the search's stream (`NgramSearch.stream_*`) chunk by
chunk.

The acoustic scorer is chosen from the model directory the way
acmod_init_am does (acmod.c:78), in the reference's order: a `sendump`
gives the bit-faithful `PsParityScorer` (or, with `-parity no`,
`SemiContinuousScorer`), and where its codebooks are one a CI phone (more
than one: pocketsphinx's PTM models, after s2_semi_mgau_init declines) the
bit-faithful `PtmParityScorer` (its kernel on CUDA; `-parity no` raises);
otherwise `mixture_weights` with one codebook set
gives `SemiContinuousScorer`, one codebook per senone `ContinuousScorer`
(kernel K1 on CUDA), one per CI phone `PTMScorer`; `-lambda` wraps it in
`InterpolatedScorer`.  `device` says where the scorer, the feature
pipeline, the frontend and the search live: the card ("cuda") unless the
caller asks for "cpu".

The search is chosen in the reference's order (ps_reinit): -allphone,
-fsg, -jsgf, -srgs or -cfg, -lmctl, -lm.  `FSG_ARGS` are registered after
`NGRAM_ARGS`, and `Config.register` keeps the first default it sees, so
the grammar search takes the N-gram table's defaults where the two share a
name (`prune` is then True), as in the reference.  Streaming through the
`Decoder` stays N-gram only, as in the reference; the grammar search's own
stream (`FsgSearch.stream_*`) is reached on the search.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from .models.cfg import Cfg
from .models.dict import Dictionary
from .models.fsg import FsgModel
from .models.gauden import read_gauden
from .models.jsgf import JsgfGrammar
from .models.lmset import NgramModelSet
from .models.mdef import Mdef
from .models.mllr import MllrTransform
from .models.ngram import NgramModel
from .models.sendump import read_mixture_weights, read_sendump
from .models.tmat import TransitionMatrices
from .utils.bio import read_mfc
from .utils.config import Arg, Config
from .decode.align import AlignSearch, allphone_search
from .decode.fsg_search import FSG_ARGS, FsgSearch
from .decode.ngram_search import NGRAM_ARGS, NgramSearch
from .decode.results import Hypothesis, Segment
from .frontend.fe import FE_ARGS, Frontend, FrontendStream
from .frontend.feat import FEAT_ARGS, FeatPipeline
from .ops.gmm import (ContinuousScorer, InterpolatedScorer, PsParityScorer,
                      PtmParityScorer, PTMScorer, SemiContinuousScorer)

DECODER_ARGS = [
    Arg("hmm", str, "", "Directory containing acoustic model files"),
    Arg("mdef", str, "", "Model definition input file"),
    Arg("mean", str, "", "Mixture gaussian means input file"),
    Arg("var", str, "", "Mixture gaussian variances input file"),
    Arg("tmat", str, "", "HMM state transition matrix input file"),
    Arg("mixw", str, "", "Senone mixture weights input file"),
    Arg("sendump", str, "", "Senone dump (compressed mixture weights) input file"),
    Arg("featparams", str, "", "File containing feature extraction parameters"),
    Arg("dict", str, "", "Main pronunciation dictionary input file"),
    Arg("fdict", str, "", "Noise word pronunciation dictionary input file"),
    Arg("lm", str, "", "Word trigram language model input file"),
    Arg("lmctl", str, "", "Specify a set of language models"),
    Arg("lmname", str, "", "Which language model in -lmctl to use initially"),
    Arg("fsg", str, "", "Sphinx format finite state grammar file"),
    Arg("jsgf", str, "", "JSGF grammar file"),
    Arg("srgs", str, "", "SRGS XML grammar file (libcfg s3_cfg_srgs)"),
    Arg("cfg", str, "",
        "Plain CFG production file (libcfg s3_cfg_read_simple format)"),
    Arg("cfg_maxexp", int, 2,
        "Max recursive expansions per nonterminal in CFG->FSG conversion"),
    Arg("allphone", str, "",
        "Perform phoneme decoding with phonetic lm (sphinx3 mode 1 / "
        "ps -allphone); value is a phone N-gram LM path or 'uniform'"),
    Arg("toprule", str, "", "Start rule for JSGF (first public rule is default)"),
    Arg("varfloor", float, 0.0001, "Mixture gaussian variance floor"),
    Arg("mllr", str, "", "MLLR transform to apply to acoustic model means"),
    Arg("lambda", str, "",
        "CD/CI senone interpolation weights file (sphinx3 -lambda, "
        "libam/interp.c): .npy or one-float-per-line text of per-senone "
        "lambdas from deleted interpolation"),
    Arg("parity", bool, True,
        "Use the bit-faithful reference senone scorer for sendump models"),
    Arg("topn", int, 4, "Number of top Gaussians to use in scoring"),
    Arg("gmmprec", str, "highest",
        "Continuous-GMM GEMM precision: highest (6-pass f32), high "
        "(3-pass bf16x3, the recommended serving mode - hypothesis-"
        "identical on the eval models), or bf16 (one MXU pass; UNSAFE "
        "for floored-variance models - verify WER per model, see "
        "ops/gmm.py GEMM_PRECISIONS and evals/run_pallas_e2e.py)"),
    Arg("samprate", float, 16000.0, "Sampling rate"),
]


class Decoder:
    """Speech decoder over one acoustic model + the N-gram search."""

    def __init__(self, config: Optional[Config] = None, *,
                 device: torch.device | str = "cuda", **kwargs):
        cfg = (config.copy() if config else
               Config(DECODER_ARGS, FE_ARGS, FEAT_ARGS, NGRAM_ARGS))
        cfg.register(DECODER_ARGS).register(FE_ARGS).register(FEAT_ARGS)
        cfg.register(NGRAM_ARGS)
        cfg.register(FSG_ARGS)
        cfg.update(**kwargs)
        self.config = cfg
        self.device = torch.device(device)
        hmm = str(cfg["hmm"])

        def model_file(key: str, name: str) -> str:
            v = str(cfg[key])
            if v:
                return v
            p = os.path.join(hmm, name)
            return p if hmm and os.path.exists(p) else ""

        # feat.params layering (ps_init_defaults pocketsphinx.c:98-156).
        fparams = model_file("featparams", "feat.params")
        if fparams:
            cfg.update_from_file(fparams)
            cfg.update(**kwargs)  # explicit args win over feat.params

        mdef_path = model_file("mdef", "mdef")
        if not mdef_path:
            raise ValueError("must specify -hmm or -mdef")
        self.mdef = Mdef.read(mdef_path)
        self.tmat = TransitionMatrices.read(model_file("tmat",
                                                       "transition_matrices"))
        gauden = read_gauden(model_file("mean", "means"),
                             model_file("var", "variances"),
                             varfloor=float(cfg["varfloor"]))

        if str(cfg["mllr"]):
            # ps_mllr / acmod_update_mllr capability: adapt means on load.
            MllrTransform.read(str(cfg["mllr"])).apply(gauden)

        self.fe = Frontend(cfg, device=self.device)
        self.fp = FeatPipeline(cfg, device=self.device)
        self.scorer = self._init_scorer(cfg, gauden, model_file)
        if str(cfg["lambda"]):
            # Decode-time CD/CI interpolation (sphinx3 interp_all).
            lpath = str(cfg["lambda"])
            lam = (np.load(lpath) if lpath.endswith(".npy") else
                   np.loadtxt(lpath, dtype=np.float32, ndmin=1))
            self.scorer = InterpolatedScorer(
                self.scorer, self.mdef.cd2cisen, self.mdef.n_ci_sen, lam,
                device=self.device)

        fdict = model_file("fdict", "noisedict")
        self.dict = Dictionary.read(str(cfg["dict"]) or None, self.mdef,
                                    filler_path=fdict or None)

        # Search module (ps_reinit search selection :257-280).
        self.search = None
        self._aligner = None
        if str(cfg["allphone"]):
            # Phoneme decoding with a phone N-gram LM or a uniform one.
            spec = str(cfg["allphone"])
            plm = None if spec == "uniform" else NgramModel.read(spec)
            self.search = allphone_search(self.mdef, self.tmat, self.scorer,
                                          lm=plm, config=cfg,
                                          device=self.device)
        elif str(cfg["fsg"]):
            self.search = self._fsg_search(FsgModel.read(str(cfg["fsg"])))
        elif str(cfg["jsgf"]):
            gram = JsgfGrammar.parse_file(str(cfg["jsgf"]))
            self.search = self._fsg_search(
                gram.build_fsg(str(cfg["toprule"]) or None))
        elif str(cfg["srgs"]) or str(cfg["cfg"]):
            # CFG/SRGS grammar -> its regular approximation, an FSG.
            g = (Cfg.parse_srgs_file(str(cfg["srgs"])) if str(cfg["srgs"])
                 else Cfg.read_simple(str(cfg["cfg"])))
            self.search = self._fsg_search(
                g.to_fsg(max_expansion=int(cfg["cfg_maxexp"])))
        elif str(cfg["lmctl"]):
            self.lmset = NgramModelSet.read_lmctl(str(cfg["lmctl"]))
            if str(cfg["lmname"]):
                self.lmset.select(str(cfg["lmname"]))
            self.search = self._ngram_search(self.lmset.lm())
        elif str(cfg["lm"]):
            self.search = self._ngram_search(NgramModel.read(str(cfg["lm"])))

        self._raw_chunks: List = []
        self._hyp: Optional[Hypothesis] = None
        self._in_utt = False
        self._stream = None

    def _ngram_search(self, lm: NgramModel) -> NgramSearch:
        return NgramSearch(lm, self.dict, self.mdef, self.tmat, self.scorer,
                           config=self.config, device=self.device)

    def _fsg_search(self, fsg: FsgModel) -> FsgSearch:
        return FsgSearch(fsg, self.dict, self.mdef, self.tmat, self.scorer,
                         config=self.config, device=self.device)

    # ------------------------------------------------------------------
    def _init_scorer(self, cfg, gauden, model_file):
        """The scorer the model selects.  `-gmmprec` reaches (and is checked
        by) ContinuousScorer only; the other scorers ignore it unchecked, as
        the reference does: no up-front check for every scorer type (a
        deliberate divergence from that advice, ROADMAP A-x)."""
        sendump = model_file("sendump", "sendump")
        mixw_path = model_file("mixw", "mixture_weights")
        slices = self.fp.stream_slices()
        dev = self.device
        if sendump:
            ptm = gauden.n_mgau == self.mdef.n_ciphone > 1
            if ptm and not bool(cfg["parity"]):
                raise ValueError(
                    f"a sendump model with {gauden.n_mgau} codebooks, one a "
                    "CI phone (PTM), is scored by the parity scorer only: "
                    "-parity no has no float scorer for it")
            if bool(cfg["parity"]):
                raw, meta = read_sendump(sendump, return_raw=True)
                if ptm:
                    return PtmParityScorer(
                        gauden, raw, slices, sen2cb=self.mdef.sen2cimap,
                        topn=int(cfg["topn"]), n_bits=meta["n_bits"],
                        device=dev)
                return PsParityScorer(gauden, raw, slices,
                                      topn=int(cfg["topn"]),
                                      wrap_uint8=meta["n_bits"] == 4,
                                      device=dev)
            lnw = read_sendump(sendump)
            return SemiContinuousScorer(gauden, lnw, slices,
                                        topn=int(cfg["topn"]), device=dev)
        if not mixw_path:
            raise ValueError("model has neither sendump nor mixture_weights")
        lnw = read_mixture_weights(mixw_path)
        if gauden.n_mgau == 1:
            return SemiContinuousScorer(gauden, lnw, slices,
                                        topn=int(cfg["topn"]), device=dev)
        if gauden.n_feat == 1 and gauden.n_mgau == lnw.shape[-1]:
            # One codebook per senone: continuous.
            return ContinuousScorer(gauden, lnw[0].T,
                                    precision=str(cfg["gmmprec"]), device=dev)
        if gauden.n_mgau == self.mdef.n_ciphone:
            sen2cb = np.asarray(self.mdef.sen2cimap, np.int32)
            return PTMScorer(gauden, lnw[0].T, sen2cb, device=dev)
        raise ValueError(
            f"cannot infer scorer type: n_mgau={gauden.n_mgau}, "
            f"n_feat={gauden.n_feat}, n_sen={lnw.shape[-1]}")

    # ------------------------------------------------------------------
    # Utterance API (ps_start_utt / ps_process_raw / ps_end_utt).
    def start_utt(self, streaming: bool = False) -> None:
        """Begin an utterance.  With streaming=True the decoder advances on
        every process_raw/process_cep call, its carry on the device between
        chunks, and `hyp()` returns partial hypotheses mid-utterance.
        Streaming uses prior-mode CMN (cmn_prior.c live semantics), since
        batch CMN needs the whole utterance."""
        if self._in_utt:
            raise RuntimeError("utterance already started")
        self._raw_chunks = []
        self._hyp = None
        self._in_utt = True
        self._stream = None
        if streaming:
            if not isinstance(self.search, NgramSearch):
                raise ValueError("streaming decode requires an N-gram search")
            self._stream = self.search.stream_start()
            self._festream = FrontendStream(self.fe)
            self._cep_buf = np.zeros((0, 0), np.float32)
            self._cep_done = 0  # cep frames already emitted as features

    def _stream_feats(self, cep: np.ndarray, endutt: bool) -> None:
        """Emit dynamic-feature frames whose delta context is complete.

        New cepstra are normalized on arrival (fp.normalize_live) and
        appended to a context buffer; the features are computed over
        [done-win, avail+win), so every emitted frame has its full delta
        window: replicate padding applies only at the utterance's ends."""
        fp = self.fp
        cep = fp.normalize_live(cep, endutt)
        if cep.size:
            self._cep_buf = (cep if self._cep_buf.size == 0
                             else np.concatenate([self._cep_buf, cep]))
        win = max(fp.window, 1)
        total = self._cep_buf.shape[0]
        avail = total if endutt else max(total - win, self._cep_done)
        if avail <= self._cep_done:
            return
        lo = max(self._cep_done - win, 0)
        feats = fp.dynamic_live(self._cep_buf[lo: total if endutt
                                              else avail + win])
        out = feats[self._cep_done - lo: avail - lo]
        self._cep_done = avail
        if out.shape[0]:
            self.search.stream_push(self._stream, out)

    def process_raw(self, data: np.ndarray) -> None:
        if not self._in_utt:
            raise RuntimeError("call start_utt first")
        data = np.asarray(data, np.float32).ravel()
        if self._stream is None:
            self._raw_chunks.append(data)
            return
        # FrontendStream carries the pre-emphasis prior and the sample
        # remainder across chunks, so chunked audio gives the cepstra of
        # one fe.process call on all of it.
        cep = self._festream.process(data)
        if cep.shape[0]:
            self._stream_feats(cep, endutt=False)

    def process_cep(self, cep: np.ndarray) -> None:
        if not self._in_utt:
            raise RuntimeError("call start_utt first")
        cep = np.asarray(cep, np.float32)
        if self._stream is None:
            self._raw_chunks.append(("cep", cep))
        else:
            self._stream_feats(cep, endutt=False)

    def abort_utt(self) -> None:
        """Discard any utterance in progress and reset to IDLE; safe to call
        in any state."""
        self._in_utt = False
        self._stream = None
        self._raw_chunks = []
        self._hyp = None

    def end_utt(self) -> Hypothesis:
        if not self._in_utt:
            raise RuntimeError("no utterance in progress")
        self._in_utt = False
        if self._stream is not None:
            tail = self._festream.end_utt()
            if tail.shape[0]:
                self._stream_feats(tail, endutt=True)
            elif self._cep_done < self._cep_buf.shape[0]:
                self._stream_feats(
                    np.zeros((0, self._cep_buf.shape[1]), np.float32),
                    endutt=True)
            self._hyp = self.search.stream_end(self._stream)
            self._stream = None
            return self._hyp
        ceps = []
        raws = [c for c in self._raw_chunks if not isinstance(c, tuple)]
        if raws:
            samples = np.concatenate(raws) if len(raws) > 1 else raws[0]
            ceps.append(self.fe.process(samples))
        ceps.extend(c[1] for c in self._raw_chunks if isinstance(c, tuple))
        if not ceps:
            self._hyp = Hypothesis([], float("-inf"), [])
            return self._hyp
        cep = np.concatenate(ceps) if len(ceps) > 1 else ceps[0]
        self._hyp = self.search.decode(self.fp.compute(cep))
        return self._hyp

    # ------------------------------------------------------------------
    def decode_raw(self, path: str) -> Hypothesis:
        """Decode a whole headerless 16-bit PCM file (ps_decode_raw)."""
        with open(path, "rb") as fh:
            data = np.frombuffer(fh.read(), np.int16)
        self.start_utt()
        self.process_raw(data.astype(np.float32))
        return self.end_utt()

    def decode_cep_file(self, path: str) -> Hypothesis:
        self.start_utt()
        self.process_cep(read_mfc(path))
        return self.end_utt()

    # Results (ps_get_hyp / ps_seg / ps_nbest / ps_get_lattice / ps_get_prob).
    def hyp(self) -> Optional[Hypothesis]:
        """Current hypothesis: partial while a streaming utterance is in
        progress (ps_get_hyp mid-utterance), final after end_utt."""
        if self._in_utt and self._stream is not None:
            return self.search.stream_partial(self._stream)
        return self._hyp

    def seg(self) -> List[Segment]:
        return self._hyp.segments if self._hyp else []

    def nbest(self, n: int = 10) -> List[Hypothesis]:
        lat = self.get_lattice()
        return lat.nbest(n, start_lmwid=self.search.start_lmwid)

    def get_lattice(self):
        return self.search.get_lattice()

    def get_prob(self) -> float:
        """Posterior probability of the best hypothesis (ps_get_prob): the
        geometric mean over its segments of their nodes' posteriors, with
        acoustic scores scaled by 1/ascale."""
        lat = self.search.get_lattice()
        post = lat.posterior(ascale=1.0 / float(self.config["ascale"]))
        best = self._hyp
        if not best or not best.segments:
            return 0.0
        p = 0.0
        for seg in best.segments:
            for n in lat.nodes:
                if (n.word == seg.word and n.sf == seg.start_frame
                        and n.ef == seg.end_frame):
                    p += float(post[n.id])
                    break
        return float(np.exp(p / max(len(best.segments), 1)))

    def add_word(self, word: str, phones: List[str]) -> int:
        """Runtime word addition (ps_add_word).  Takes effect at the next
        search (re)initialization."""
        return self.dict.add_word(word, phones)

    def set_lm(self, name: str) -> None:
        """Switch to a named LM from -lmctl; rebuilds the search module."""
        self.search = self._ngram_search(self.lmset.select(name))

    def align(self, feats_or_raw: np.ndarray, words: List[str],
              raw: bool = False):
        """Forced alignment (state_align / sphinx3_align capability) of
        features, or of PCM samples with raw=True: returns (word segments,
        phone segments, state ids, score)."""
        if raw:
            cep = self.fe.process(np.asarray(feats_or_raw, np.float32))
            feats = self.fp.compute(cep)
        else:
            feats = np.asarray(feats_or_raw)
        # One aligner a Decoder, so that its captured graphs (one a state
        # bucket) serve every call; built anew if a model part was replaced.
        al = self._aligner
        if al is None or any(a is not b for a, b in zip(
                (al.dict, al.mdef, al.tmat, al.scorer),
                (self.dict, self.mdef, self.tmat, self.scorer))):
            al = self._aligner = AlignSearch(self.dict, self.mdef, self.tmat,
                                             self.scorer, device=self.device)
        return al.align(feats, words)
