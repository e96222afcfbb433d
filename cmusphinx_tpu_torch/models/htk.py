"""HTK MMF acoustic-model converter: HTK -> Sphinx-3 model directory.

Capability parity with htk2s3conv (reference: htk2s3conv/htk_converter.py
+ htk_models.py parse of HTK Master Model Files), re-implemented from the
HTK format itself: ~o global options, ~v/~s/~m/~t macros, ~h HMM
definitions with <NUMSTATES>/<STATE>/<NUMMIXES>/<MIXTURE>/<MEAN>/
<VARIANCE>/<GCONST>/<TRANSP>, triphone names `lc-base+rc`.

Conversion drops HTK's nonemitting entry/exit states (s3 transition
matrices are [n_emit, n_emit+1], tmat.c topology), interns shared states
as senones, pads ragged mixture counts with zero-weight components, and
emits a Sphinx-3 model directory (text mdef + means/variances/
mixture_weights/transition_matrices) loadable by this framework's own
readers and the reference decoders.
"""

from __future__ import annotations

import math
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from .mdef import BAD_SENID, Mdef

_TOKEN = re.compile(r'"[^"]*"|<[^>]+>|\S+')


class _Tok:
    def __init__(self, text: str):
        self.toks = _TOKEN.findall(text)
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of MMF")
        self.i += 1
        return t

    def is_kw(self, kw: str) -> bool:
        t = self.peek()
        return t is not None and t.upper() == kw.upper()

    def expect(self, kw: str) -> None:
        t = self.next()
        if t.upper() != kw.upper():
            raise ValueError(f"expected {kw}, got {t}")

    def floats(self, n: int) -> np.ndarray:
        return np.asarray([float(self.next()) for _ in range(n)], np.float64)


class HtkState:
    def __init__(self, weights, means, variances, gconsts):
        self.weights = np.asarray(weights, np.float64)     # [K]
        self.means = np.asarray(means, np.float64)         # [K, D]
        self.variances = np.asarray(variances, np.float64) # [K, D]

    def key(self) -> bytes:
        return (self.weights.tobytes() + self.means.tobytes()
                + self.variances.tobytes())


class HtkHmm:
    def __init__(self, name: str, states: List[HtkState],
                 transp: np.ndarray):
        self.name = name
        self.states = states       # emitting states only
        self.transp = transp       # full HTK [N, N]


class HtkModelSet:
    """Parsed MMF: hmms by name + global options."""

    def __init__(self):
        self.hmms: Dict[str, HtkHmm] = {}
        self.vecsize = 0
        self.parmkind = ""

    # ------------------------------------------------------------------
    @classmethod
    def read(cls, path: str) -> "HtkModelSet":
        text = open(path, errors="replace").read()
        # Strip comments (lines starting with //ish are rare in MMFs; HTK
        # has none standard, so no comment handling needed).
        tk = _Tok(text)
        ms = cls()
        macros_s: Dict[str, HtkState] = {}
        macros_t: Dict[str, np.ndarray] = {}
        macros_v: Dict[str, np.ndarray] = {}

        def parse_mixtures(tk) -> HtkState:
            nmix = 1
            if tk.is_kw("<NUMMIXES>"):
                tk.next()
                nmix = int(tk.next())
            weights, means, variances = [], [], []
            if tk.is_kw("<MIXTURE>"):
                while tk.is_kw("<MIXTURE>"):
                    tk.next()
                    tk.next()  # mixture index (1-based)
                    weights.append(float(tk.next()))
                    m, v = parse_gaussian(tk)
                    means.append(m)
                    variances.append(v)
            else:
                weights.append(1.0)
                m, v = parse_gaussian(tk)
                means.append(m)
                variances.append(v)
            # HTK may omit low-weight mixtures; pad to nmix with zeros.
            D = len(means[0])
            while len(weights) < nmix:
                weights.append(0.0)
                means.append(np.zeros(D))
                variances.append(np.ones(D))
            return HtkState(weights, means, variances, None)

        def parse_gaussian(tk) -> Tuple[np.ndarray, np.ndarray]:
            mean = var = None
            while True:
                t = tk.peek()
                if t is None:
                    break
                u = t.upper()
                if u == "<MEAN>":
                    tk.next()
                    n = int(tk.next())
                    mean = tk.floats(n)
                elif u == "<VARIANCE>":
                    tk.next()
                    n = int(tk.next())
                    var = tk.floats(n)
                elif u == "~V":
                    tk.next()
                    name = tk.next().strip('"')
                    var = macros_v[name]
                elif u == "<GCONST>":
                    tk.next()
                    tk.next()  # recomputed, not stored
                else:
                    break
            if mean is None:
                raise ValueError("mixture without <MEAN>")
            if var is None:
                raise ValueError("mixture without <VARIANCE>")
            return mean, var

        def parse_state(tk) -> HtkState:
            if tk.is_kw("~S"):
                tk.next()
                return macros_s[tk.next().strip('"')]
            return parse_mixtures(tk)

        def parse_hmm(name: str) -> HtkHmm:
            tk.expect("<BEGINHMM>")
            tk.expect("<NUMSTATES>")
            N = int(tk.next())
            states: List[Optional[HtkState]] = [None] * (N - 2)
            transp = None
            while not tk.is_kw("<ENDHMM>"):
                if tk.is_kw("<STATE>"):
                    tk.next()
                    idx = int(tk.next())  # 2..N-1
                    states[idx - 2] = parse_state(tk)
                elif tk.is_kw("<TRANSP>"):
                    tk.next()
                    n = int(tk.next())
                    transp = tk.floats(n * n).reshape(n, n)
                elif tk.is_kw("~T"):
                    tk.next()
                    transp = macros_t[tk.next().strip('"')]
                else:
                    raise ValueError(f"unexpected token {tk.peek()} in HMM")
            tk.expect("<ENDHMM>")
            if any(s is None for s in states) or transp is None:
                raise ValueError(f"HMM {name} incomplete")
            return HtkHmm(name, states, transp)

        while tk.peek() is not None:
            t = tk.next().upper()
            if t == "~O":
                while tk.peek() and tk.peek().startswith("<"):
                    u = tk.next().upper()
                    if u == "<VECSIZE>":
                        ms.vecsize = int(tk.next())
                    elif u == "<STREAMINFO>":
                        ns = int(tk.next())
                        for _ in range(ns):
                            tk.next()
                    elif u in ("<MFCC>", "<MFCC_D_A>", "<MFCC_E_D_A>",
                               "<MFCC_D_A_0>", "<MFCC_0_D_A>", "<USER>",
                               "<DIAGC>", "<NULLD>", "<PLP>", "<FBANK>"):
                        ms.parmkind = u.strip("<>")
                    else:
                        ms.parmkind = u.strip("<>")
            elif t == "~V":
                name = tk.next().strip('"')
                tk.expect("<VARIANCE>")
                n = int(tk.next())
                macros_v[name] = tk.floats(n)
            elif t == "~S":
                name = tk.next().strip('"')
                macros_s[name] = parse_mixtures(tk)
            elif t == "~T":
                name = tk.next().strip('"')
                tk.expect("<TRANSP>")
                n = int(tk.next())
                macros_t[name] = tk.floats(n * n).reshape(n, n)
            elif t == "~H":
                name = tk.next().strip('"')
                ms.hmms[name] = parse_hmm(name)
            elif t == "~M":
                # mixture macro: parse and discard name binding (rare).
                tk.next().strip('"')
                parse_gaussian(tk)
            else:
                raise ValueError(f"unsupported MMF macro {t}")
        return ms

    # ------------------------------------------------------------------
    def convert(self, outdir: str, varfloor: float = 1e-4,
                feat: str = "1s_c_d_dd") -> Mdef:
        """Emit a Sphinx-3 model directory; returns the built Mdef."""
        from ..train.model_io import _write_s3

        # Phone naming: `lc-base+rc` triphones, plain names are CI.
        def split_name(n: str):
            m = re.match(r"^(?:([^-+]+)-)?([^-+]+)(?:\+([^-+]+))?$", n)
            if not m:
                return None, n, None
            return m.group(1), m.group(2), m.group(3)

        ci_names: List[str] = []
        for name in self.hmms:
            lc, b, rc = split_name(name)
            for p in ([b] if lc is None and rc is None else [lc, b, rc]):
                if p and p not in ci_names:
                    ci_names.append(p)
        ci_names.sort()
        # SIL must exist for the decoders; HTK models use "sil".
        rename = {}
        if "SIL" not in ci_names:
            for cand in ("sil", "Sil"):
                if cand in ci_names:
                    rename[cand] = "SIL"
        ci_names = sorted(rename.get(n, n) for n in ci_names)
        ci_id = {n: i for i, n in enumerate(ci_names)}

        def phid(n: Optional[str]) -> int:
            return ci_id[rename.get(n, n)] if n else -1

        n_state = max(len(h.states) for h in self.hmms.values())
        if any(len(h.states) != n_state for h in self.hmms.values()):
            raise ValueError("ragged state counts not supported")

        # Intern states -> senones; CI phones' senones come first
        # (s3 mdef convention: CI senones are the first n_tied_ci_state).
        sen_index: Dict[bytes, int] = {}
        senones: List[HtkState] = []

        def sen_of(st: HtkState) -> int:
            k = st.key()
            i = sen_index.get(k)
            if i is None:
                i = len(senones)
                sen_index[k] = i
                senones.append(st)
            return i

        order = sorted(self.hmms,
                       key=lambda n: (split_name(n)[0] is not None, n))
        sseqs: List[Tuple[int, ...]] = []
        tmats: List[np.ndarray] = []
        phones: List[Tuple[str, int, int]] = []  # (name, ssid, tmat)
        tmat_index: Dict[bytes, int] = {}
        sseq_index: Dict[Tuple[int, ...], int] = {}
        for name in order:
            h = self.hmms[name]
            seq = tuple(sen_of(s) for s in h.states)
            sid = sseq_index.setdefault(seq, len(sseq_index))
            if sid == len(sseqs):
                sseqs.append(seq)
            tp = h.transp
            key = tp.tobytes()
            tid = tmat_index.setdefault(key, len(tmat_index))
            if tid == len(tmats):
                # strip HTK entry/exit: rows 1..N-2, cols 1..N-1.
                tmats.append(tp[1:-1, 1:])
            phones.append((name, sid, tid))

        n_ci_sen = 0
        for name, sid, _ in phones:
            if split_name(name)[0] is None and split_name(name)[2] is None:
                n_ci_sen = max(n_ci_sen, max(sseqs[sid]) + 1)

        # Build the Mdef object.
        m = Mdef()
        m.n_ciphone = len(ci_names)
        m.ciname = list(ci_names)
        m.ciphone_id = dict(ci_id)
        m.sil = ci_id.get("SIL", -1)
        m.n_emit_state = n_state
        m.n_sen = len(senones)
        m.n_ci_sen = n_ci_sen or len(senones)
        m.n_tmat = len(tmats)
        m.n_sseq = len(sseqs)
        # phone rows: all CI phones first (even context-only ones get the
        # base phone's model if defined, else the first sseq), then tris.
        ssid_of_ci = {}
        tmat_of_ci = {}
        for name, sid, tid in phones:
            lc, b, rc = split_name(name)
            if lc is None and rc is None:
                ssid_of_ci[phid(b)] = sid
                tmat_of_ci[phid(b)] = tid
        phone_ssid, phone_tmat, ctxs = [], [], []
        for i, n in enumerate(ci_names):
            phone_ssid.append(ssid_of_ci.get(i, 0))
            phone_tmat.append(tmat_of_ci.get(i, 0))
            ctxs.append((i, -1, -1, -1))
        for name, sid, tid in phones:
            lc, b, rc = split_name(name)
            if lc is None and rc is None:
                continue
            pid = len(phone_ssid)
            bi = phid(b)
            # HTK triphones carry no word-position; register as internal
            # ('i'); phone_id's wpos fallback covers b/e/s lookups.
            m._tri_index[(bi, phid(lc), phid(rc), 0)] = pid
            phone_ssid.append(sid)
            phone_tmat.append(tid)
            ctxs.append((bi, phid(lc), phid(rc), 0))
        m.n_phone = len(phone_ssid)
        m.phone_ssid = np.asarray(phone_ssid, np.int32)
        m.phone_tmat = np.asarray(phone_tmat, np.int32)
        m.phone_ctx = np.asarray(ctxs, np.int32)
        m.sseq = np.full((m.n_sseq, n_state), BAD_SENID, np.uint16)
        for i, seq in enumerate(sseqs):
            m.sseq[i, : len(seq)] = seq
        m.ci_filler = np.asarray(
            [n == "SIL" or (n.startswith("+") and n.endswith("+"))
             for n in ci_names], bool)
        m._build_senone_maps()

        # Gaussian/mixw arrays: [n_sen, 1, K, D] padded over K.
        K = max(s.means.shape[0] for s in senones)
        D = self.vecsize or senones[0].means.shape[1]
        means = np.zeros((len(senones), 1, K, D), np.float32)
        variances = np.ones((len(senones), 1, K, D), np.float32)
        mixw = np.zeros((len(senones), 1, K), np.float32)
        for i, s in enumerate(senones):
            k = s.means.shape[0]
            means[i, 0, :k] = s.means
            variances[i, 0, :k] = np.maximum(s.variances, varfloor)
            mixw[i, 0, :k] = s.weights
        tmat = np.zeros((len(tmats), n_state, n_state + 1), np.float32)
        for i, tp in enumerate(tmats):
            tmat[i] = tp

        os.makedirs(outdir, exist_ok=True)
        m.write_text(os.path.join(outdir, "mdef"))
        S = len(senones)
        _write_s3(os.path.join(outdir, "means"), "1.0", [means],
                  [S, 1, K, D, S * K * D])
        _write_s3(os.path.join(outdir, "variances"), "1.0", [variances],
                  [S, 1, K, D, S * K * D])
        _write_s3(os.path.join(outdir, "mixture_weights"), "1.0", [mixw],
                  [S, 1, K, S * K])
        M = len(tmats)
        _write_s3(os.path.join(outdir, "transition_matrices"), "1.0",
                  [tmat], [M, n_state, n_state + 1,
                           M * n_state * (n_state + 1)])
        with open(os.path.join(outdir, "feat.params"), "w") as fh:
            fh.write(f"-feat {feat}\n-cmn current\n-agc none\n")
        return m


def convert_htk(mmf_path: str, outdir: str, varfloor: float = 1e-4,
                feat: str = "1s_c_d_dd") -> Mdef:
    """htk2s3conv one-call: HTK MMF -> Sphinx-3 model directory."""
    return HtkModelSet.read(mmf_path).convert(outdir, varfloor=varfloor,
                                              feat=feat)


# ---------------------------------------------------------------------------
def write_mmf(path: str, mdef, gauden, mixw: np.ndarray,
              tmat_probs: np.ndarray, parmkind: str = "USER") -> None:
    """Export a CONTINUOUS Sphinx-3 model as an HTK MMF (the reverse of
    HtkModelSet.read/convert — sphinx -> HTK interchange, complementing the
    htk2s3conv direction).

    mdef: Mdef; gauden: GaussianParams (single stream); mixw: LINEAR
    mixture weights [n_sen, K]; tmat_probs: [n_tmat, n_state, n_state+1]
    probabilities.  Triphones are named `lc-base+rc`; CI phones keep their
    plain names.  Each phone's states are written inline (no ~s/~t macros
    — sharing is reconstructed by value interning on re-import).
    """
    if gauden.n_feat != 1:
        raise ValueError("MMF export needs a single-stream model")
    D = int(gauden.veclen[0])
    K = gauden.n_density
    S = mdef.n_emit_state
    N = S + 2
    bad = int(np.int32(np.uint16(0xFFFF)))

    def fvec(v):
        return " ".join(f"{x:.7e}" for x in np.asarray(v, np.float64))

    with open(path, "w") as fh:
        fh.write(f"~o <VecSize> {D} <{parmkind}>\n")
        for p in range(mdef.n_phone):
            b, lc, rc, _ = mdef.phone_ctx[p]
            base = mdef.ciname[b]
            if lc >= 0 or rc >= 0:
                name = (f"{mdef.ciname[lc] if lc >= 0 else ''}-{base}"
                        f"+{mdef.ciname[rc] if rc >= 0 else ''}")
            else:
                name = base
            sen = mdef.sseq[mdef.phone_ssid[p]][:S]
            fh.write(f'~h "{name}"\n<BeginHMM>\n<NumStates> {N}\n')
            for s in range(S):
                sid = int(sen[s])
                if sid == bad:
                    continue
                fh.write(f"<State> {s + 2}\n<NumMixes> {K}\n")
                for k in range(K):
                    fh.write(f"<Mixture> {k + 1} {mixw[sid, k]:.7e}\n")
                    fh.write(f"<Mean> {D}\n"
                             f"{fvec(gauden.means[sid, 0, k, :D])}\n")
                    fh.write(f"<Variance> {D}\n"
                             f"{fvec(gauden.var[sid, 0, k, :D])}\n")
            tm = tmat_probs[int(mdef.phone_tmat[p])]
            full = np.zeros((N, N), np.float64)
            full[0, 1] = 1.0
            full[1:-1, 1:] = tm[:, : N - 1]
            fh.write(f"<TransP> {N}\n")
            for r in range(N):
                fh.write(fvec(full[r]) + "\n")
            fh.write("<EndHMM>\n")
