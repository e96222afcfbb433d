"""Dynamic features: cepstra -> feature vectors (batch path).

Port of `cmusphinx_tpu/frontend/feat.py` (`FEAT_ARGS`, the feature types,
`stream_slices`, `_padded_kernel`, `_dynamic`, `compute`,
`compute_batch`, and the live path `normalize_live` / `compute_live`).
In the batch path utterances arrive
zero-padded to a common length with their true lengths, and the batch is
an explicit leading dimension.  Matches feat_s2mfc2feat_block_utt with
beginutt = endutt = 1: replicate-pad by the window first, then CMN over the
padded block of T + 2·window frames (the padding frames count in the CMN
statistics), AGC max, deltas, LDA.

Feature layouts (GMMs are trained against these exact orders):

- ``1s_c_d_dd`` (39): [c, d, dd], window 3
- ``1s_c_d_ld_dd`` (52): [c, d, longd, dd], window 4
- ``s3_1x39`` (39): [c1-12, d1-12, c0 dc0 ddc0, dd1-12], window 3
- ``s2_4x`` (12/24/3/12 in 4 streams), window 4
- ``1s_c``/``cep`` (13), ``1s_c_d`` (26), ``a,b,c`` pass-through widths

Deltas: d[t] = c[t+2] - c[t-2]; dd[t] = (c[t+3]-c[t-1]) - (c[t+1]-c[t-3]);
long d[t] = c[t+4] - c[t-4].

The live path (streaming) normalizes each block of cepstra on arrival
with prior-mode CMN (cmn_prior.c: subtract the running mean, refresh it
past 800 frames and at the end of an utterance) and AGC on c0 (emax: the
mean of past utterances' maxima, halved in weight at 8 utterances).  Its
state carries across utterances.  It runs on the host in numpy, as the
reference's does, and so gives the reference's values exactly.

The batch path with prior CMN subtracts the configured `cmninit`, never
the live mean (a deliberate divergence, ROADMAP C1).  The reference
subtracts the live mean as it was when its jitted kernel for the frame
bucket was first traced: the same call on the same state gives either
answer, depending on which bucket a live utterance preceded.  The two
agree wherever the reference is deterministic (a fresh pipeline; a bucket
traced before any live call); tests/test_torch_feat.py holds both cases
and pins the port's value on the other.
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..utils.bio import S3File
from ..utils.config import Arg, Config

FEAT_ARGS = [
    Arg("feat", str, "1s_c_d_dd", "Feature stream type"),
    Arg("ceplen", int, 13, "Number of components in the input feature vector"),
    Arg("cmn", str, "current", "Cepstral mean normalization scheme (current, prior, none)"),
    Arg("cmninit", str, "8.0", "Initial values (comma-separated) for cepstral mean when 'prior' is used"),
    Arg("varnorm", bool, False, "Variance normalize each utterance"),
    Arg("agc", str, "none", "Automatic gain control for c0 (max, emax, noise, none)"),
    Arg("agcthresh", float, 2.0, "Initial threshold for automatic gain control"),
    Arg("lda", str, "", "File containing transformation (LDA/MLLT) matrix"),
    Arg("ldadim", int, 0, "Dimensionality of output of feature transformation (0 to use entire matrix)"),
    Arg("svspec", str, "", 'Subvector specification, e.g. "24,0-11/25,12-23/26-38"'),
]

FEAT_DCEP_WIN = 2


def parse_subvecs(spec: str) -> List[List[int]]:
    """Parse an svspec string like ``0-12/13-25/26-38`` into per-stream
    index lists (feat_parse_subvecs)."""
    out: List[List[int]] = []
    for sub in spec.split("/"):
        idxs: List[int] = []
        for part in sub.split(","):
            part = part.strip()
            if not part:
                continue
            m = re.match(r"^(\d+)-(\d+)$", part)
            if m:
                idxs.extend(range(int(m.group(1)), int(m.group(2)) + 1))
            else:
                idxs.append(int(part))
        if idxs:
            out.append(idxs)
    if not out:
        raise ValueError(f"bad subvector spec {spec!r}")
    return out


class FeatPipeline(nn.Module):
    """Cepstra [B, T, ncep] -> features [B, T, D] (+ stream structure).
    The LDA matrix, when configured, is a buffer on `device`."""

    def __init__(self, config: Optional[Config] = None, *,
                 device: torch.device | str = "cuda", **kwargs):
        super().__init__()
        cfg = (config.copy() if config else Config(FEAT_ARGS)).register(FEAT_ARGS)
        cfg.update(**kwargs)
        self.config = cfg
        self.device = torch.device(device)
        self.cepsize = int(cfg["ceplen"])
        self.feat_type = str(cfg["feat"]).lower()
        self.cmn_type = str(cfg["cmn"]).lower()
        self.varnorm = bool(cfg["varnorm"])
        self.agc_type = str(cfg["agc"]).lower()
        self._setup_type()
        init = [float(x) for x in str(cfg["cmninit"]).split(",") if x.strip()]
        cmn_mean = np.zeros(self.cepsize, np.float32)
        cmn_mean[: len(init)] = init[: self.cepsize]
        self.register_buffer("cmn_mean", torch.as_tensor(cmn_mean,
                                                         device=self.device))
        self.register_buffer("lda", None)
        self.out_dim = self.dim
        lda_path = str(cfg.get("lda") or "")
        if lda_path:
            self.load_lda(lda_path, int(cfg.get("ldadim") or 0))
        sv = str(cfg.get("svspec") or "")
        self.subvecs = parse_subvecs(sv) if sv else None
        if self.subvecs is not None:
            self.stream_lens = [len(s) for s in self.subvecs]

        # Live-mode CMN state.  Prior-mode CMN primes both the sum and the
        # frame count with the init mean's virtual window (cmn_prior.c:
        # sum = mean * CMN_WIN; nframe = CMN_WIN).
        self._cmn_mean = cmn_mean.copy()
        self._cmn_sum = self._cmn_mean * 500.0
        self._cmn_nframe = 500
        self._agc_max = 5.0 if self.cmn_type != "none" else 10.0
        self._agc_obs_max = -np.inf
        self._agc_obs_sum = 0.0
        self._agc_obs_utt = 0

    def _setup_type(self) -> None:
        t, n = self.feat_type, self.cepsize
        if t == "s2_4x":
            self.window, self.stream_lens = 4, [12, 24, 3, 12]
        elif t == "s3_1x39":
            self.window, self.stream_lens = 3, [39]
        elif t in ("1s_c_d_dd", "1s_12c_12d_3p_12dd"):
            self.window, self.stream_lens = FEAT_DCEP_WIN + 1, [n * 3]
        elif t == "1s_c_d_ld_dd":
            self.window, self.stream_lens = FEAT_DCEP_WIN * 2, [n * 4]
        elif t == "1s_c_d":
            self.window, self.stream_lens = FEAT_DCEP_WIN, [n * 2]
        elif t in ("1s_c", "cep"):
            self.window, self.stream_lens = 0, [n]
        elif re.match(r"^\d+(,\d+)*$", t):
            self.window = 0
            self.stream_lens = [int(x) for x in t.split(",")]
        else:
            raise ValueError(f"unknown feature type {self.feat_type!r}")
        self.dim = sum(self.stream_lens)

    def stream_slices(self) -> List[np.ndarray]:
        """Index arrays into the flat feature vector for each stream."""
        if self.subvecs is not None:
            return [np.asarray(s, np.int32) for s in self.subvecs]
        out, pos = [], 0
        for ln in self.stream_lens:
            out.append(np.arange(pos, pos + ln, dtype=np.int32))
            pos += ln
        return out

    def load_lda(self, path: str, ldadim: int = 0) -> None:
        """Read an LDA/MLLT matrix file (feat/lda.c feat_read_lda)."""
        with S3File.open(path) as s3:
            n = int(s3.read_uint32(1)[0])
            rows = int(s3.read_uint32(1)[0])
            cols = int(s3.read_uint32(1)[0])
            mat = s3.read_float32(n * rows * cols).reshape(n, rows, cols)[0]
        if mat.shape[1] != self.dim:
            raise ValueError(f"LDA input dim {mat.shape[1]} != feature dim {self.dim}")
        self.out_dim = ldadim if ldadim > 0 else mat.shape[0]
        self.lda = torch.as_tensor(mat[: self.out_dim].astype(np.float32),
                                   device=self.device)

    # ------------------------------------------------------------------
    def _padded_kernel(self, cep_pad: torch.Tensor, T: torch.Tensor,
                       batch_cmn: bool = True) -> torch.Tensor:
        """[B, Tp, ncep] zero-padded cepstra + true lengths T [B] ->
        [B, Tp, D] features.  Rows >= T replicate the final frame."""
        w = self.window
        B, Tp, _ = cep_pad.shape
        dev = cep_pad.device
        T = T.to(device=dev, dtype=torch.int64)
        pos = torch.arange(Tp + 2 * w, device=dev)
        idx = torch.minimum((pos - w).clamp_min(0)[None, :],
                            (T - 1)[:, None])                  # [B, Tp+2w]
        pad = torch.gather(cep_pad, 1,
                           idx[..., None].expand(-1, -1, cep_pad.shape[2]))
        nvalid = (T + 2 * w).to(torch.float32)[:, None, None]
        mask = (pos[None, :] < (T + 2 * w)[:, None])[..., None]   # [B, Tp+2w, 1]
        if self.cmn_type == "current" and batch_cmn:
            zero = torch.zeros((), dtype=pad.dtype, device=dev)
            mean = torch.where(mask, pad, zero).sum(1, keepdim=True) / nvalid
            if self.varnorm:
                var = torch.where(mask, (pad - mean).square(), zero).sum(
                    1, keepdim=True) / nvalid
                pad = (pad - mean) / torch.sqrt(var)
            else:
                pad = pad - mean
        elif self.cmn_type == "prior":
            pad = pad - self.cmn_mean
        if self.agc_type == "max":
            ninf = torch.tensor(float("-inf"), dtype=pad.dtype, device=dev)
            c0max = torch.where(mask[..., 0], pad[..., 0], ninf).amax(1)
            pad = pad.clone()
            pad[..., 0] -= c0max[:, None]
        feats = self._dynamic(pad)
        if self.lda is not None:
            feats = feats @ self.lda.T
        return feats

    def _dynamic(self, pad: torch.Tensor) -> torch.Tensor:
        """Window-padded cepstra [B, T+2w, n] -> the configured layout."""
        w = self.window
        if w == 0 and self.feat_type not in ("s2_4x", "s3_1x39"):
            return pad
        T = pad.shape[1] - 2 * w
        cep = pad[:, w: w + T]

        def sh(k):  # frame t+k for t in [0, T)
            return pad[:, w + k: w + k + T]

        t = self.feat_type
        if t in ("1s_c_d_dd", "1s_12c_12d_3p_12dd"):
            d = sh(2) - sh(-2)
            dd = (sh(3) - sh(-1)) - (sh(1) - sh(-3))
            return torch.cat([cep, d, dd], -1)
        if t == "1s_c_d_ld_dd":
            d = sh(2) - sh(-2)
            ld = sh(4) - sh(-4)
            dd = (sh(3) - sh(-1)) - (sh(1) - sh(-3))
            return torch.cat([cep, d, ld, dd], -1)
        if t == "1s_c_d":
            return torch.cat([cep, sh(2) - sh(-2)], -1)
        if t == "s3_1x39":
            d = sh(2) - sh(-2)
            dd = (sh(3) - sh(-1)) - (sh(1) - sh(-3))
            pow_ = torch.stack([cep[..., 0], d[..., 0], dd[..., 0]], -1)
            return torch.cat([cep[..., 1:], d[..., 1:], pow_, dd[..., 1:]], -1)
        if t == "s2_4x":
            d = sh(2) - sh(-2)
            ld = sh(4) - sh(-4)
            dd = (sh(3) - sh(-1)) - (sh(1) - sh(-3))
            pow_ = torch.stack([cep[..., 0], d[..., 0], dd[..., 0]], -1)
            return torch.cat([cep[..., 1:], d[..., 1:], ld[..., 1:], pow_,
                              dd[..., 1:]], -1)
        raise ValueError(self.feat_type)

    def dynamic_live(self, cep: np.ndarray) -> np.ndarray:
        """An unpadded block of normalized cepstra [T, n] -> features
        [T, out_dim] on the host: replicate-pad by the window here, deltas,
        LDA (the reference's `_dynamic(cep, padded=False)` and its numpy
        LDA product)."""
        cep = np.asarray(cep, np.float32)
        if cep.shape[0] == 0:
            return np.zeros((0, self.out_dim), np.float32)
        w = self.window
        pad = np.concatenate([np.repeat(cep[:1], w, 0), cep,
                              np.repeat(cep[-1:], w, 0)])
        with torch.inference_mode():
            feats = self._dynamic(torch.as_tensor(pad)[None])[0].numpy()
        if self.lda is not None:
            feats = feats @ self.lda.cpu().numpy().T
        return feats

    def compute_live(self, cep: np.ndarray, beginutt: bool,
                     endutt: bool) -> np.ndarray:
        """Live/streaming path with prior CMN and emax AGC (stateful)."""
        return self.dynamic_live(self.normalize_live(cep, endutt))

    def normalize_live(self, cep: np.ndarray, endutt: bool) -> np.ndarray:
        """Stateful per-chunk normalization for streaming: prior-mode CMN
        (cmn_prior.c: subtract the running mean, refresh it past CMN_WIN_HWM
        and at utterance end) and AGC on c0.  Shared by compute_live and the
        incremental Decoder streaming path so both see identical CMN/AGC
        state evolution."""
        cep = np.asarray(cep, np.float32).copy()
        # cmn_prior (cmn_prior.c): accumulate raw cepstra, subtract current mean.
        if self.cmn_type != "none":
            self._cmn_sum += cep.sum(axis=0)
            self._cmn_nframe += len(cep)
            cep -= self._cmn_mean
            if self._cmn_nframe > 800:  # CMN_WIN_HWM
                self._cmn_mean = (self._cmn_sum / self._cmn_nframe).astype(np.float32)
                self._cmn_sum *= 500.0 / self._cmn_nframe
                self._cmn_nframe = 500
            elif endutt and self._cmn_nframe > 0:
                self._cmn_mean = (self._cmn_sum / self._cmn_nframe).astype(np.float32)
        if self.agc_type in ("emax", "max", "noise") and len(cep):
            self._agc_obs_max = max(self._agc_obs_max, float(cep[:, 0].max()))
            cep[:, 0] -= self._agc_max
            if endutt and np.isfinite(self._agc_obs_max):
                self._agc_obs_sum += self._agc_obs_max
                self._agc_obs_utt += 1
                self._agc_max = self._agc_obs_sum / self._agc_obs_utt
                if self._agc_obs_utt == 8:
                    self._agc_obs_sum /= 2
                    self._agc_obs_utt = 4
                self._agc_obs_max = -np.inf
        return cep

    @torch.inference_mode()
    def compute(self, cep: np.ndarray, batch_cmn: bool = True) -> np.ndarray:
        """Single-utterance batch path: [T, ncep] -> [T, D] (numpy).
        `batch_cmn=False` skips `current` CMN (prior CMN still applies)."""
        cep = np.asarray(cep, np.float32)
        T = cep.shape[0]
        if T == 0:
            return np.zeros((0, self.out_dim), np.float32)
        out = self._padded_kernel(torch.as_tensor(cep[None]).to(self.device),
                                  torch.tensor([T]), batch_cmn)
        return out[0].cpu().numpy()

    def compute_batch(self, ceps) -> List[np.ndarray]:
        """List of [T_i, ncep] -> list of [T_i, D] (one batched call)."""
        if not len(ceps):
            return []
        Ts = [int(c.shape[0]) for c in ceps]
        Tp = max(max(Ts), 1)
        cpad = np.zeros((len(ceps), Tp, int(ceps[0].shape[1])), np.float32)
        for i, c in enumerate(ceps):
            cpad[i, : Ts[i]] = c
        out = self._padded_kernel(
            torch.as_tensor(cpad, device=self.device),
            torch.as_tensor(Ts, device=self.device)).cpu().numpy()
        return [out[i, : Ts[i]] for i in range(len(ceps))]
