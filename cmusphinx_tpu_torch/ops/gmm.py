"""GMM senone scoring (port of `cmusphinx_tpu/ops/gmm.py`: `GEMM_PRECISIONS`,
`density_logliks`, `_mask_topn`, `SemiContinuousScorer`,
`ContinuousScorer`, `PTMScorer`, `logadd8_table`, `PsParityScorer`,
`InterpolatedScorer`), and `PtmParityScorer`, the scorer of pocketsphinx's
default PTM model, which the JAX package does not have.

The log Gaussian density `lrd - sum_d prec (x - mean)^2` expands to
`const + x . lin - (x*x) . prec`: two GEMMs over all codewords and frames.

Precision matters here: the expanded quadratic form cancels terms of the
size of prec·mean², which reach ~1e6 nats on trained models with floored
variances, so every plain f32 product runs in IEEE f32 (TF32 is switched
off in the package's `__init__`), and K1 computes `highest` as 3xTF32
products, held to the same f32 bound.  `-gmmprec` trades precision for
speed: `highest` (f32), `high` (bf16 hi+lo split, 3 products) and `bf16`
(bf16 parameters, one product, f32 sums — rejected for trained models,
see PERF.md).

Every scorer is an `nn.Module` whose parameters are buffers on `device`
(the card unless the caller asks for "cpu"); `score` takes features
`[..., T, D]` and returns `[..., T, S]`.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch
from torch import nn

from ..models.gauden import GaussianParams
from ..utils.profile import span
from . import ptm_parity
from .fused_gmm import (PRECISIONS, _REF_CHUNK_BYTES, Packed,
                        fused_mixture_scores, fused_mixture_scores_ref,
                        pack_params)
from .fused_gmm import mask_topn as _mask_topn

GEMM_PRECISIONS = PRECISIONS
_INT32_MIN = torch.iinfo(torch.int32).min
# Bytes of the PTM parity scorer's largest temporary a frame chunk.
_PTM_CHUNK_BYTES = 64 << 20


def density_logliks(x: torch.Tensor, means: torch.Tensor, prec: torch.Tensor,
                    lrd: torch.Tensor) -> torch.Tensor:
    """x [T, D]; means/prec [K, D]; lrd [K] -> [T, K] log densities."""
    lin = 2.0 * prec * means
    const = lrd - (prec * means * means).sum(-1)
    return const[None, :] + x @ lin.T - (x * x) @ prec.T


def _flat(feats: torch.Tensor) -> torch.Tensor:
    return feats.reshape(-1, feats.shape[-1])


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def _senone_part(scorer: nn.Module, lo: int, hi: int, axes: dict
                 ) -> nn.Module:
    """A scorer of `scorer`'s class for senones [lo, hi): its plain
    attributes and every buffer, those named in `axes` sliced on their
    device along their senone axis, the rest shared."""
    part = type(scorer).__new__(type(scorer))
    nn.Module.__init__(part)
    part.__dict__.update((k, v) for k, v in vars(scorer).items()
                         if not k.startswith("_"))
    for name, buf in scorer.named_buffers(recurse=False):
        if name in axes:
            buf = buf.narrow(axes[name], lo, hi - lo).clone(
                memory_format=torch.contiguous_format)
        part.register_buffer(name, buf)
    part.n_sen = hi - lo
    return part


class _StreamParams(nn.Module):
    """Per-stream codebook buffers `means{f}`, `prec{f}`, `lrd{f}` (streams
    have different widths) and the stream slices into the feature vector."""

    def _set_streams(self, means, prec, lrd, stream_slices, device) -> None:
        self.n_feat = len(means)
        if len(stream_slices) != self.n_feat:
            raise ValueError(
                f"{len(stream_slices)} streams but model has {self.n_feat}")
        for f in range(self.n_feat):
            for name, a in (("means", means[f]), ("prec", prec[f]),
                            ("lrd", lrd[f])):
                self.register_buffer(f"{name}{f}",
                                     torch.as_tensor(_f32(a)).to(device))
            self.register_buffer(f"slice{f}", torch.as_tensor(
                np.asarray(stream_slices[f], np.int64)).to(device),
                persistent=False)

    def stream_densities(self, feats: torch.Tensor) -> List[torch.Tensor]:
        """feats [N, D] -> per stream the f32 log densities [N, K]."""
        return [density_logliks(feats[:, getattr(self, f"slice{f}")],
                                getattr(self, f"means{f}"),
                                getattr(self, f"prec{f}"),
                                getattr(self, f"lrd{f}"))
                for f in range(self.n_feat)]


def _codebooks(gauden: GaussianParams):
    """The single codebook set of a semi-continuous model, trimmed to each
    stream's veclen: means, prec, lrd lists."""
    means, prec, lrd = [], [], []
    for f in range(gauden.n_feat):
        ln = gauden.veclen[f]
        means.append(gauden.means[0, f, :, :ln])
        prec.append(gauden.prec[0, f, :, :ln])
        lrd.append(gauden.lrd[0, f])
    return means, prec, lrd


class SemiContinuousScorer(_StreamParams):
    """Semi-continuous / tied-codebook senone scorer: one shared codebook per
    feature stream; senones mix the same K densities with their weights.

    Per stream, with the frame's density max m:
    score = log(max(sum_k exp(d_k - m) w[k, s], 1e-37)) + m, summed over
    streams.  `w` [n_feat, K, S] holds the linear weights, exp'd in float64
    and rounded to f32 as the reference does."""

    def __init__(self, gauden: GaussianParams, ln_mixw: np.ndarray,
                 stream_slices: Sequence[np.ndarray], topn: int = 0, *,
                 device: torch.device | str = "cuda"):
        super().__init__()
        if gauden.n_mgau != 1:
            raise ValueError("semi-continuous scorer needs a single codebook set")
        w = np.exp(np.asarray(ln_mixw).astype(np.float64)).astype(np.float32)
        self._setup(*_codebooks(gauden), w, stream_slices, topn, device)

    @classmethod
    def from_params(cls, means, prec, lrd, w, stream_slices, topn: int = 0, *,
                    device: torch.device | str = "cuda"
                    ) -> "SemiContinuousScorer":
        """Build from per-stream means/prec/lrd and linear weights w
        [n_feat, K, S] (see `convert.semicont_from_jax`)."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self._setup(means, prec, lrd, w, stream_slices, topn, device)
        return self

    def _setup(self, means, prec, lrd, w, stream_slices, topn, device):
        self._set_streams(means, prec, lrd, stream_slices, device)
        self.register_buffer("w", torch.as_tensor(_f32(w)).to(device))
        self.n_density, self.n_sen = self.w.shape[1], self.w.shape[2]
        self.topn = int(topn)

    def score(self, feats: torch.Tensor) -> torch.Tensor:
        """feats [..., T, D] -> ln senone scores [..., T, S]."""
        out = None
        for f, d in enumerate(self.stream_densities(_flat(feats))):
            d = _mask_topn(d, self.topn)
            m = d.amax(-1, keepdim=True)
            p = torch.exp(d - m) @ self.w[f]
            s = torch.log(p.clamp_min(1e-37)) + m
            out = s if out is None else out + s
        return out.reshape(*feats.shape[:-1], self.n_sen)

    forward = score


class ContinuousScorer(nn.Module):
    """Fully-continuous per-senone GMM scorer: one codebook per senone.

    Buffers: `lin`, `quad` [S, K, D] (bf16 in bf16 mode, else f32) and
    `const` [S, K] f32, so score[t,s] = logsumexp_k(const[s,k] +
    x_t.lin[s,k] - x_t^2.quad[s,k]).  With `topn == 0`, `score` sends CUDA
    tensors to the K1 kernel, on the same parameters packed for it
    (`packed`), and CPU tensors to its plain version.  With `topn > 0`
    (keep each senone's top-N densities, reference eval_topn semantics) it
    takes the plain path on any device, as the reference does.  With
    `kernel=False` it calls the plain version on any device (the reference
    decode that the kernel is held against)."""

    def __init__(self, gauden: GaussianParams, ln_mixw: np.ndarray, *,
                 topn: int = 0, precision: str = "highest",
                 device: torch.device | str = "cuda", kernel: bool = True):
        super().__init__()
        if gauden.n_feat != 1:
            raise ValueError("continuous scorer expects a single feature stream")
        S, K = gauden.n_mgau, gauden.n_density
        means = gauden.means[:, 0]               # [S, K, D]
        prec = gauden.prec[:, 0]
        lrd = gauden.lrd[:, 0]                   # [S, K]
        lnw = ln_mixw.reshape(S, K) if ln_mixw.ndim != 2 else ln_mixw
        const = lrd + lnw - (prec * means * means).sum(-1)
        self._setup(2.0 * prec * means, prec, const, topn, precision, device,
                    kernel)

    @classmethod
    def from_params(cls, lin: np.ndarray, quad: np.ndarray, const: np.ndarray,
                    *, topn: int = 0, precision: str = "highest",
                    device: torch.device | str = "cuda",
                    kernel: bool = True) -> "ContinuousScorer":
        """Build from senone-major lin/quad [S, K, D] and const [S, K]
        (see `convert.continuous_from_jax`)."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self._setup(lin, quad, const, topn, precision, device, kernel)
        return self

    def _setup(self, lin, quad, const, topn, precision, device, kernel):
        if precision not in GEMM_PRECISIONS:
            raise ValueError(f"precision must be one of "
                             f"{sorted(GEMM_PRECISIONS)}, got {precision!r}")
        self.precision = precision
        self.topn = int(topn)
        self.kernel = bool(kernel)
        ptype = torch.bfloat16 if precision == "bf16" else torch.float32

        def param(a):
            return torch.as_tensor(_f32(a)).to(device=device, dtype=ptype)

        self.register_buffer("lin", param(lin))
        self.register_buffer("quad", param(quad))
        self.register_buffer("const", torch.as_tensor(_f32(const)).to(device))
        self.n_sen, self.n_density = self.lin.shape[0], self.lin.shape[1]
        self._packed = None
        if self.kernel and not self.topn and self.lin.device.type == "cuda":
            self.packed()

    def _buffers_now(self):
        """lin, quad and const with their in-place edit counts."""
        return [(t, -1 if t.is_inference() else t._version)
                for t in (self.lin, self.quad, self.const)]

    def packed(self) -> Packed:
        """K1's operands (`fused_gmm.pack_params`) of the current lin, quad
        and const: packed once, and again only after one of them was
        replaced or edited in place (`load_state_dict`, `copy_`)."""
        now = self._buffers_now()
        if self._packed is None or any(
                a is not b or u != v
                for (a, u), (b, v) in zip(self._packed[0], now)):
            self._packed = (now, pack_params(self.lin, self.quad, self.const,
                                             self.precision))
        return self._packed[1]

    def senones(self, lo: int, hi: int) -> "ContinuousScorer":
        """The scorer of senones [lo, hi) alone (a senone shard): lin, quad
        and const sliced on their device, so K1 packs and scores only
        them."""
        part = _senone_part(self, lo, hi, {"lin": 0, "quad": 0, "const": 0})
        part._packed = None
        return part

    def _apply(self, *args, **kwargs):
        # The buffers move or change type (`.to`, `.cuda`): the packed
        # operands are dropped here and made again where they are used.
        self._packed = None
        return super()._apply(*args, **kwargs)

    def score(self, feats: torch.Tensor) -> torch.Tensor:
        """feats [..., T, D] -> [..., T, S]."""
        x = _flat(feats).contiguous()
        if self.topn:
            out = fused_mixture_scores_ref(x, self.lin, self.quad, self.const,
                                           self.precision, topn=self.topn)
        elif self.kernel:
            packed = self.packed() if x.device.type == "cuda" else None
            out = fused_mixture_scores(x, self.lin, self.quad, self.const,
                                       self.precision, packed=packed)
        else:
            out = fused_mixture_scores_ref(x, self.lin, self.quad, self.const,
                                           self.precision)
        return out.reshape(*feats.shape[:-1], self.n_sen)

    forward = score


class PTMScorer(nn.Module):
    """Phonetically-tied-mixture scorer: one codebook per CI phone; each
    senone mixes its phone's codebook (`sen2cb` [S] maps senone ->
    codebook).  Densities [N, C, K] are computed once per frame and gathered
    to [N, S, K] by `sen2cb`, in frame chunks that bound that gather's
    memory."""

    def __init__(self, gauden: GaussianParams, ln_mixw: np.ndarray,
                 sen2cb: np.ndarray, topn: int = 0, *,
                 device: torch.device | str = "cuda"):
        super().__init__()
        if gauden.n_feat != 1:
            raise ValueError("PTM scorer expects a single feature stream")
        means = gauden.means[:, 0]       # [C, K, D]
        prec = gauden.prec[:, 0]
        lrd = gauden.lrd[:, 0]
        const = lrd - (prec * means * means).sum(-1)          # [C, K]
        self._setup(2.0 * prec * means, prec, const, ln_mixw, sen2cb, topn,
                    device)

    @classmethod
    def from_params(cls, lin, quad, const, lnw, sen2cb, topn: int = 0, *,
                    device: torch.device | str = "cuda") -> "PTMScorer":
        """Build from codebook-major lin/quad [C, K, D], const [C, K], lnw
        [S, K] and sen2cb [S] (see `convert.ptm_from_jax`)."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self._setup(lin, quad, const, lnw, sen2cb, topn, device)
        return self

    def _setup(self, lin, quad, const, lnw, sen2cb, topn, device):
        self.register_buffer("lin", torch.as_tensor(_f32(lin)).to(device))
        self.register_buffer("quad", torch.as_tensor(_f32(quad)).to(device))
        self.register_buffer("const", torch.as_tensor(_f32(const)).to(device))
        self.register_buffer("lnw", torch.as_tensor(_f32(lnw)).to(device))
        self.register_buffer("sen2cb", torch.as_tensor(
            np.asarray(sen2cb, np.int64)).to(device))
        self.n_cb, self.n_density, _ = self.lin.shape
        self.n_sen = self.lnw.shape[0]
        self.topn = int(topn)

    def score(self, feats: torch.Tensor) -> torch.Tensor:
        x = _flat(feats)
        C, K = self.n_cb, self.n_density
        lin2 = self.lin.reshape(C * K, -1)
        quad2 = self.quad.reshape(C * K, -1)
        const1 = self.const.reshape(1, C * K)
        out = torch.empty((x.shape[0], self.n_sen), dtype=torch.float32,
                          device=x.device)
        rows = max(1, _REF_CHUNK_BYTES // (self.n_sen * K * 4))
        for lo in range(0, x.shape[0], rows):
            xb = x[lo: lo + rows]
            ll = (const1 + xb @ lin2.T - (xb * xb) @ quad2.T).view(-1, C, K)
            ll = _mask_topn(ll, self.topn)
            out[lo: lo + rows] = torch.logsumexp(
                ll[:, self.sen2cb, :] + self.lnw, dim=-1)
        return out.reshape(*feats.shape[:-1], self.n_sen)

    forward = score


def logadd8_table(base: float = 1.0001, shift: int = 10) -> np.ndarray:
    """The reference's 8-bit shifted logadd table (logmath.c:90-160 built with
    logmath_init(base, SENSCR_SHIFT, TRUE)): table[d] = shifted-round of
    log_base(1 + base^-(d<<shift)) evaluated at the first full-domain index
    mapping to d."""
    ln_b = math.log(base)
    d = np.arange(256, dtype=np.int64)
    i = (d << shift).astype(np.float64)
    k = np.floor((np.log1p(np.power(base, -i)) / ln_b) + 0.5 * (1 << shift))
    return (k.astype(np.int64) >> shift).astype(np.int32)


class PsParityScorer(_StreamParams):
    """Bit-faithful emulation of the reference semi-continuous scorer
    (s2_semi_mgau.c eval_topn/eval_cb/mgau_norm/get_scores_8b_feat), in two
    stages that are held to their own bounds:

    (a) `int_densities`: per stream, the f32 log densities in the quantized
        logmath domain (`stream_densities`), clipped to [-2e9, 0] and
        truncated toward zero to int32.  The f32 GEMM's summation order
        differs between backends, so this stage agrees with another
        backend within D·2^-22·M (M the magnitude of the summed terms),
        to within one integer unit after truncation.
    (b) `epilogue`: on int32 densities, bit-exact: per stream the top-N by
        iterative argmax with a single-index mask (ties to the lowest
        index, equal values kept as separate entries), the arithmetic
        right shift and normalisation, the MAX_NEG_ASCR clamp, the mixture
        weight gather, the uint8 wrap of 4-bit models, the N-way 8-bit
        logadd by a gather from `table8`; then the sum over streams and
        `-acc · float32(scale)`.

    Returns natural-log senone scores [..., T, S], frame-relative (<= 0).
    """

    MAX_NEG_ASCR = 96    # tied_mgau_common.h:85
    MAX_NEG_MIXW = 159   # tied_mgau_common.h:84

    def __init__(self, gauden: GaussianParams, raw_mixw: np.ndarray,
                 stream_slices: Sequence[np.ndarray], topn: int = 4,
                 logbase: float = 1.0001, shift: int = 10,
                 wrap_uint8: bool = False, *,
                 device: torch.device | str = "cuda"):
        super().__init__()
        if gauden.n_mgau != 1:
            raise ValueError("parity scorer needs a single codebook set")
        ln_b = math.log(logbase)
        inv = 1.0 / ln_b
        means, prec, lrd = [], [], []
        for f in range(gauden.n_feat):
            ln = gauden.veclen[f]
            means.append(gauden.means[0, f, :, :ln])
            # Logmath-domain precomputation with the reference's per-dim
            # integer truncation (gauden_dist_precompute ms_gauden.c:332-351).
            # The reference passes the *linear* precision 1/(2 var) to
            # logmath_ln_to_log, which only scales by 1/ln(base).
            v = gauden.var[0, f, :, :ln].astype(np.float64)
            prec.append(np.trunc((1.0 / (2.0 * v)) * inv))
            lrd.append(np.trunc(np.log(1.0 / np.sqrt(2.0 * np.pi * v)) * inv
                                ).sum(axis=-1))
        self._setup(means, prec, lrd, np.asarray(raw_mixw).astype(np.int32),
                    logadd8_table(logbase, shift), stream_slices, topn, shift,
                    float((1 << shift) * ln_b), wrap_uint8, device)

    @classmethod
    def from_params(cls, means, prec, lrd, mixw, table8, stream_slices, *,
                    topn: int, shift: int, scale: float, wrap_uint8: bool,
                    device: torch.device | str = "cuda") -> "PsParityScorer":
        """Build from the logmath-domain per-stream means/prec/lrd, the raw
        mixture-weight bytes [n_feat, K, S] and the logadd table (see
        `convert.psparity_from_jax`)."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self._setup(means, prec, lrd, mixw, table8, stream_slices, topn,
                    shift, scale, wrap_uint8, device)
        return self

    def _setup(self, means, prec, lrd, mixw, table8, stream_slices, topn,
               shift, scale, wrap_uint8, device):
        self._set_streams(means, prec, lrd, stream_slices, device)
        # Bytes are used as-is: MAX_NEG_MIXW clamping happens only when
        # quantizing float mixture_weights, not on sendump load.
        self.register_buffer("mixw", torch.as_tensor(
            np.ascontiguousarray(mixw, np.int32)).to(device))     # [F, K, S]
        self.register_buffer("table8", torch.as_tensor(
            np.asarray(table8, np.int32)).to(device))
        self.n_density, self.n_sen = self.mixw.shape[1], self.mixw.shape[2]
        self.topn = int(topn)
        self.shift = int(shift)
        self.scale = float(scale)
        # 4-bit models precompute w_den = mixw_cb + density in a uint8 array
        # (get_scores_4b_feat_*), so the sum wraps at 256; 8-bit models
        # promote to int and do not.
        self.wrap_uint8 = bool(wrap_uint8)

    # -- stage (a) -------------------------------------------------------
    def int_densities(self, feats: torch.Tensor) -> List[torch.Tensor]:
        """feats [N, D] -> per stream int32 densities [N, K].  Saturate
        before the cast (the reference's float->int32 overflow lands at
        INT_MIN on x86; such values never reach the top-N); the cast
        truncates toward zero as C does."""
        return [d.clamp(-2.0e9, 0.0).to(torch.int32)
                for d in self.stream_densities(feats)]

    # -- stage (b) -------------------------------------------------------
    @staticmethod
    def topn_select(d: torch.Tensor, n: int):
        """Top-n values [N, n] and indices [N, n] (int64) of int32 d [N, K]
        by n rounds of max + first-index argmax, masking one index a round:
        ties go to the lowest index and duplicates stay separate entries
        (the reference's insertion sort, s2_semi_mgau.c:81-118)."""
        vals, idxs = [], []
        for _ in range(n):
            v, am = d.max(dim=1)
            vals.append(v)
            idxs.append(am)
            d = d.scatter(1, am[:, None], _INT32_MIN)
        return torch.stack(vals, 1), torch.stack(idxs, 1)

    def epilogue(self, d_ints: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-stream int32 densities [N, K] -> senone scores [N, S]."""
        acc = None
        for f, d in enumerate(d_ints):
            vals, idx = self.topn_select(d, self.topn)        # [N, n]
            norm = vals[:, :1] >> self.shift
            fsc = -((vals >> self.shift) - norm)              # [N, n] >= 0
            fsc = fsc.clamp_max(self.MAX_NEG_ASCR)
            w = self.mixw[f]                                  # [K, S]
            tmp = None
            for j in range(self.topn):
                y = w.index_select(0, idx[:, j]) + fsc[:, j: j + 1]
                if self.wrap_uint8:
                    y = y & 0xFF
                if tmp is None:
                    tmp = y
                    continue
                dd = (tmp - y).abs().clamp_max(255)
                tmp = torch.minimum(tmp, y) - self.table8[dd]
            acc = tmp if acc is None else acc + tmp
        return -acc.to(torch.float32) * float(np.float32(self.scale))

    def senones(self, lo: int, hi: int) -> "PsParityScorer":
        """The scorer of senones [lo, hi) alone (a senone shard): mixw
        sliced on its device; the codebooks, their top-N and the
        normaliser are per codebook, so the shard shares them and its
        scores are the whole scorer's columns, bit for bit."""
        return _senone_part(self, lo, hi, {"mixw": 2})

    def score(self, feats: torch.Tensor) -> torch.Tensor:
        out = self.epilogue(self.int_densities(_flat(feats)))
        return out.reshape(*feats.shape[:-1], self.n_sen)

    forward = score


class PtmParityScorer(nn.Module):
    """Bit-faithful emulation of pocketsphinx's phonetically-tied-mixture
    scorer (ptm_mgau.c: eval_topn, ptm_mgau_codebook_norm,
    ptm_mgau_senone_eval), the scorer of its default US English model.
    One codebook of K Gaussians a CI phone and stream; each senone mixes
    its CI phone's codebook (`sen2cb`, the mdef's sen2cimap) with 8-bit
    weights over the codebook's top N in each stream.  With logbase b,
    SHIFT and MAX_NEG_ASCR = 96:

    (a) densities, for frame n, codebook c, stream f, codeword k:
        d = int32-truncate(clamp(lrd' - sum_j prec'_j (x_j - mu_j)^2,
        -2e9, 0)) with prec' = trunc(1/(2 var) / ln b) and lrd' = sum_j
        trunc(ln(1/sqrt(2 pi var_j)) / ln b), in float32, one dimension
        after another as the reference's loop: diff, its square, times
        prec', subtracted, each rounded (no fused multiply-add).
    (b) the top N of each (n, c, f), ties to the lower index, equal values
        kept as separate entries (`PsParityScorer.topn_select`); the norm
        of each (n, f), the max over c of top_0 >> SHIFT; fsc_r =
        min(norm - (top_r >> SHIFT), MAX_NEG_ASCR); for senone s with cb =
        sen2cb[s], per stream y_r = mixw[f, idx_r, s] + fsc_r, fden = y_0,
        then fden = min(fden, y_r) - table8[min(|fden - y_r|, 255)]; the sum
        over streams times -float32(2^SHIFT ln b).

    Returns natural-log senone scores [..., T, S], frame-relative (<= 0).
    Stage (b) is exact integer arithmetic; stage (a) is the same float32
    sequence on every device, so the CUDA kernel (`ops/ptm_parity.py`)
    and the plain path agree bit for bit.

    Departures from ptm_mgau.c: the norm is taken over all codebooks (the
    batch decode scores every senone, pocketsphinx's `-compallsen yes`,
    where every codebook is active; without it the reference takes the
    norm over the active codebooks only); ties go to the lower index
    (eval_topn keeps the previous frame's order among equal scores, a
    history a batch decode does not have); a 4-bit sendump raises
    `ValueError` rather than guess the cluster codebook; senones that no
    phone uses (sen2cimap -1) are scored with codebook 0, a score nothing
    reads.

    CUDA tensors go to the one kernel of `ops/ptm_parity.py` (which raises
    on a model it was not built for, `ptm_parity.check`), CPU tensors to
    the plain path (`score_ref`), in frame chunks that bound its memory.
    """

    MAX_NEG_ASCR = 96    # tied_mgau_common.h:85
    LOGBASE = 1.0001     # the reference's -logbase
    SHIFT = 10           # SENSCR_SHIFT, the 8-bit weights' and scores' shift

    def __init__(self, gauden: GaussianParams, raw_mixw: np.ndarray,
                 stream_slices: Sequence[np.ndarray], sen2cb: np.ndarray,
                 topn: int = 4, n_bits: int = 8, *,
                 device: torch.device | str = "cuda"):
        super().__init__()
        if n_bits != 8:
            raise ValueError(
                f"PTM parity scorer reads 8-bit sendumps only, got "
                f"{n_bits}-bit (a 4-bit PTM sendump needs its cluster "
                "codebook)")
        raw = np.asarray(raw_mixw)
        C, F, K = gauden.n_mgau, gauden.n_feat, gauden.n_density
        if raw.ndim != 3 or raw.shape[:2] != (F, K):
            raise ValueError(f"mixture weights must be [{F}, {K}, S], got "
                             f"{raw.shape}")
        if len(stream_slices) != F:
            raise ValueError(f"{len(stream_slices)} streams but model has {F}")
        sen2cb = np.asarray(sen2cb, np.int64)
        if sen2cb.shape != (raw.shape[2],):
            raise ValueError(f"sen2cb must be [{raw.shape[2]}], got "
                             f"{sen2cb.shape}")
        if sen2cb.max(initial=0) >= C or sen2cb.min(initial=0) < -1:
            raise ValueError(f"sen2cb must index the {C} codebooks")
        if not 1 <= int(topn) <= K:
            raise ValueError(f"topn must be in [1, {K}], got {topn}")
        ln_b = math.log(self.LOGBASE)
        inv = 1.0 / ln_b
        means, prec, lrd = [], [], []
        for f in range(F):
            ln = gauden.veclen[f]
            if len(stream_slices[f]) != ln:
                raise ValueError(f"stream {f} has {len(stream_slices[f])} "
                                 f"features but the model {ln}")
            v = gauden.var[:, f, :, :ln].astype(np.float64)     # [C, K, L]
            means.append(_f32(gauden.means[:, f, :, :ln]))
            prec.append(_f32(np.trunc((1.0 / (2.0 * v)) * inv)))
            lrd.append(_f32(np.trunc(np.log(1.0 / np.sqrt(2.0 * np.pi * v))
                                     * inv).sum(axis=-1)))
        for f in range(F):
            for name, a in (("means", means[f]), ("prec", prec[f]),
                            ("lrd", lrd[f])):
                self.register_buffer(f"{name}{f}",
                                     torch.as_tensor(a).to(device))
            self.register_buffer(f"slice{f}", torch.as_tensor(
                np.asarray(stream_slices[f], np.int64)).to(device),
                persistent=False)
        self.register_buffer("mixw", torch.as_tensor(
            np.ascontiguousarray(raw, np.int32)).to(device))      # [F, K, S]
        self.register_buffer("sen2cb", torch.as_tensor(
            np.maximum(sen2cb, 0)).to(device))
        self.register_buffer("table8", torch.as_tensor(
            logadd8_table(self.LOGBASE, self.SHIFT)).to(device))
        self.n_cb, self.n_feat, self.n_density = C, F, K
        self.n_sen = raw.shape[2]
        self.veclen = [int(gauden.veclen[f]) for f in range(F)]
        self.topn = int(topn)
        self.scale = float((1 << self.SHIFT) * ln_b)
        self._packed = None

    # -- stage (a) -------------------------------------------------------
    def int_densities(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x [N, D] -> per stream the int32 densities [N, C, K]."""
        out = []
        for f in range(self.n_feat):
            xs = x[:, getattr(self, f"slice{f}")].float()
            mu, pr = getattr(self, f"means{f}"), getattr(self, f"prec{f}")
            d = getattr(self, f"lrd{f}").expand(x.shape[0], -1, -1)
            for j in range(self.veclen[f]):
                diff = xs[:, j, None, None] - mu[:, :, j]
                d = d - diff * diff * pr[:, :, j]
            out.append(d.clamp(-2.0e9, 0.0).to(torch.int32))
        return out

    # -- stage (b) -------------------------------------------------------
    def epilogue(self, d_ints: Sequence[torch.Tensor]) -> torch.Tensor:
        """Per-stream int32 densities [N, C, K] -> senone scores [N, S]."""
        acc = None
        for f, d in enumerate(d_ints):
            N, C, K = d.shape
            vals, idx = PsParityScorer.topn_select(d.reshape(N * C, K),
                                                   self.topn)
            vals = vals.view(N, C, -1) >> self.SHIFT
            idx = idx.view(N, C, -1)
            norm = vals[:, :, 0].amax(1)                        # [N]
            fsc = (norm[:, None, None] - vals).clamp_max(self.MAX_NEG_ASCR)
            ii, ff = idx[:, self.sen2cb], fsc[:, self.sen2cb]   # [N, S, n]
            w = self.mixw[f]                                    # [K, S]
            tmp = None
            for r in range(self.topn):
                y = torch.gather(w, 0, ii[:, :, r]) + ff[:, :, r]
                if tmp is None:
                    tmp = y
                    continue
                dd = (tmp - y).abs().clamp_max(255)
                tmp = torch.minimum(tmp, y) - self.table8[dd]
            acc = tmp if acc is None else acc + tmp
        return -acc.to(torch.float32) * float(np.float32(self.scale))

    def score_ref(self, x: torch.Tensor) -> torch.Tensor:
        """The plain path: x [N, D] -> [N, S], in frame chunks whose
        largest temporaries ([n, C, K] float32, [n, S, N] int64) stay near
        `_PTM_CHUNK_BYTES`."""
        per_row = max(self.n_cb * self.n_density * 4,
                      self.n_sen * self.topn * 8)
        rows = max(1, _PTM_CHUNK_BYTES // per_row)
        return torch.cat([self.epilogue(self.int_densities(x[lo: lo + rows]))
                          for lo in range(0, x.shape[0], rows)]
                         or [x.new_zeros((0, self.n_sen))])

    def packed(self):
        """The kernel's operands (`ptm_parity.pack`), made once."""
        if self._packed is None:
            self._packed = ptm_parity.pack(self)
        return self._packed

    def _apply(self, *args, **kwargs):
        self._packed = None
        return super()._apply(*args, **kwargs)

    def score(self, feats: torch.Tensor) -> torch.Tensor:
        x = _flat(feats)
        with span("ptm.score"):
            if x.device.type == "cuda":
                out = ptm_parity.score(x, self, self.packed())
            else:
                out = self.score_ref(x)
        return out.reshape(*feats.shape[:-1], self.n_sen)

    forward = score


class InterpolatedScorer(nn.Module):
    """Decode-time CD/CI senone interpolation (sphinx3 interp_all): every CD
    senone's score becomes logaddexp(score[cd] + log(lambda[cd]),
    score[ci(cd)] + log(1 - lambda[cd])); CI senones pass through.

    scorer: any senone scorer; cd2cisen [S]: parent CI senone per senone;
    lam: scalar or [S] weights, clipped to [1e-6, 1-1e-6] in f32 with their
    logs taken in numpy, as the reference does."""

    def __init__(self, scorer: nn.Module, cd2cisen: np.ndarray,
                 n_ci_sen: int, lam, *,
                 device: torch.device | str = "cuda"):
        super().__init__()
        self.inner = scorer
        self.n_sen = scorer.n_sen
        lam = np.broadcast_to(np.asarray(lam, np.float32),
                              (self.n_sen,)).copy()
        lam = np.clip(lam, 1e-6, 1.0 - 1e-6)
        self.register_buffer("log_cd", torch.as_tensor(np.log(lam)).to(device))
        self.register_buffer("log_ci", torch.as_tensor(np.log1p(-lam)).to(device))
        self.register_buffer("ci", torch.as_tensor(
            np.asarray(cd2cisen, np.int64)).to(device))
        self.register_buffer("is_cd", torch.as_tensor(
            np.arange(self.n_sen) >= int(n_ci_sen)).to(device))

    def score(self, feats: torch.Tensor) -> torch.Tensor:
        s = self.inner.score(feats)
        mixed = torch.logaddexp(s + self.log_cd, s[..., self.ci] + self.log_ci)
        return torch.where(self.is_cd, mixed, s)

    forward = score
