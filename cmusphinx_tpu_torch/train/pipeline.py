"""Multi-stage training pipeline: CI -> split -> CD-untied -> tied CD.

Capability parity with the SphinxTrain pipeline stages (reference:
scripts_pl/20.ci_hmm -> 30.cd_hmm_untied -> 40.buildtrees/45.prunetree ->
50.cd_hmm_tied, SURVEY.md §2.4): Gaussian splitting (inc_comp), triphone
inventory generation (mk_mdef_gen with word-position contexts), untied CD
initialization from CI parameters (init_mixw/cp_parm), and senone tying.

Tying here is occupancy-weighted agglomerative clustering of untied
triphone states per (base phone, state position) group, merging the pair
with the smallest Gaussian log-likelihood loss until a senone budget or
loss threshold is hit — same capability as bldtree/prunetree/tiestate's
decision trees (the reference clusters with entropy of discrete pdfs;
unseen-triphone generalization via trees is a follow-up).

The VTLN stage (12.vtln_align) lives in train/vtln.py and is re-exported
here: run `estimate_vtln_per_speaker` over raw audio + transcripts with an
aligner on the current model, then retrain with each speaker's features
computed at their warp (`warp_params` in the frontend config).

Ported from `cmusphinx_tpu/train/pipeline.py`: every EM loop runs its
forward-backward on `device` (default "cuda"); the inventory, the senone
tying and the model export are host copies (tests/test_torch_host.py
holds them to the originals).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .bw import forward_backward, pack_batch
from .sentence_hmm import FlatModel
from .trainer import (HmmParams, Trainer, VAR_FLOOR, device_params, host_acc,
                      reestimate)
from .vtln import estimate_vtln, estimate_vtln_per_speaker  # noqa: F401 (stage 12)


# ----------------------------------------------------------------------
def split_gaussians(params: HmmParams, perturb: float = 0.2) -> HmmParams:
    """Double every senone's component count (inc_comp capability): each
    component splits into mean +/- perturb*sigma with halved weight."""
    S, K, D = params.means.shape
    sd = np.sqrt(params.var)
    m1 = params.means + perturb * sd
    m2 = params.means - perturb * sd
    means = np.concatenate([m1, m2], axis=1)
    var = np.concatenate([params.var, params.var], axis=1)
    lnw = np.concatenate([params.lnw, params.lnw], axis=1) - np.log(2.0)
    return HmmParams(means=means.astype(np.float32),
                     var=var.astype(np.float32),
                     lnw=lnw.astype(np.float32), tp=params.tp)


# ----------------------------------------------------------------------
@dataclass
class TriphoneInventory:
    """CD-untied model: triphones seen in training with word-position
    contexts (mk_mdef_gen capability); SIL is the cross-word context."""
    base: FlatModel                  # CI inventory (phones, topology)
    tris: List[Tuple[int, int, int, int]]   # (b, lc, rc, wpos) ids
    tri_id: Dict[Tuple[int, int, int, int], int]
    n_state: int

    WPOS = "bies"  # begin/internal/end/single

    @classmethod
    def from_corpus(cls, model: FlatModel, pron: Dict[str, List[str]],
                    transcripts: Sequence[Sequence[str]],
                    sil: str = "SIL") -> "TriphoneInventory":
        pid = model.phone_id
        silp = pid[sil]
        seen = {}
        for words in transcripts:
            for w in words:
                ps = [pid[p] for p in pron[w]]
                n = len(ps)
                for i, b in enumerate(ps):
                    lc = ps[i - 1] if i > 0 else silp
                    rc = ps[i + 1] if i < n - 1 else silp
                    if n == 1:
                        wp = 3
                    elif i == 0:
                        wp = 0
                    elif i == n - 1:
                        wp = 2
                    else:
                        wp = 1
                    seen.setdefault((b, lc, rc, wp), len(seen))
        tris = sorted(seen, key=seen.get)
        return cls(base=model, tris=tris,
                   tri_id={t: i for i, t in enumerate(tris)},
                   n_state=model.n_state)

    @property
    def n_tri(self) -> int:
        return len(self.tris)

    @property
    def n_sen(self) -> int:
        """CI senones first, then untied CD senones (s3 layout)."""
        return self.base.n_sen + self.n_tri * self.n_state

    def senone(self, tri: int, state: int) -> int:
        return self.base.n_sen + tri * self.n_state + state

    def lookup(self, b: int, lc: int, rc: int, wp: int) -> Optional[int]:
        return self.tri_id.get((b, lc, rc, wp))

    # Sentence-HMM construction helper: a FlatModel-compatible view where
    # `phone` = triphone index offset so build_sentence_hmm can be reused.
    def make_cd_model(self) -> "CdModelView":
        return CdModelView(self)


class CdModelView:
    """Duck-typed FlatModel for build_sentence_hmm over triphones.

    Words' phones are resolved to triphones with contexts at sentence-HMM
    build time via `resolve_pron`; each triphone gets its base phone's
    transition matrix (SphinxTrain ties tmats to the base phone)."""

    def __init__(self, inv: TriphoneInventory):
        self.inv = inv
        self.n_state = inv.n_state
        self.n_sen = inv.n_sen
        self.n_tmat = inv.base.n_tmat
        # phone ids here are "resolved units": either CI phone (silence)
        # or base.n_phones + tri index.
        self.n_ci = len(inv.base.phones)
        self.phone_id = dict(inv.base.phone_id)  # silence lookups

    def senone(self, unit: int, state: int) -> int:
        if unit < self.n_ci:
            return self.inv.base.senone(unit, state)
        return self.inv.senone(unit - self.n_ci, state)

    def tmat_of(self, unit: int) -> int:
        if unit < self.n_ci:
            return unit
        return self.inv.tris[unit - self.n_ci][0]

    def init_tmat(self) -> np.ndarray:
        return self.inv.base.init_tmat()

    def resolve_pron(self, pron: Dict[str, List[str]]) -> Dict[str, List[int]]:
        """Word -> resolved unit-id sequence (triphones w/ SIL contexts)."""
        pid = self.inv.base.phone_id
        silp = pid["SIL"]
        out = {}
        for w, ps in pron.items():
            ids = [pid[p] for p in ps]
            n = len(ids)
            units = []
            for i, b in enumerate(ids):
                lc = ids[i - 1] if i > 0 else silp
                rc = ids[i + 1] if i < n - 1 else silp
                wp = 3 if n == 1 else (0 if i == 0 else (2 if i == n - 1 else 1))
                t = self.inv.lookup(b, lc, rc, wp)
                units.append(self.n_ci + t if t is not None else b)
            out[w] = units
        return out


def cd_sentence_hmm(words, resolved_pron, view: CdModelView, sil="SIL"):
    """build_sentence_hmm over resolved triphone units."""
    from .sentence_hmm import SentHmm, build_sentence_hmm

    class _M:
        n_state = view.n_state
        phone_id = {**{f"u{u}": u for w, us in resolved_pron.items()
                       for u in us},
                    sil: view.phone_id[sil]}

        @staticmethod
        def senone(p, s):
            return view.senone(p, s)

    pron2 = {w: [f"u{u}" for u in us] for w, us in resolved_pron.items()}
    h = build_sentence_hmm(words, pron2, _M, sil=sil)
    # Remap tmats: build_sentence_hmm used unit ids as tmat ids.
    h.etmat = np.asarray([view.tmat_of(u) for u in h.etmat], np.int32)
    h.ftm = np.asarray([view.tmat_of(u) for u in h.ftm], np.int32)
    return h


def init_cd_params(ci: HmmParams, model: FlatModel,
                   inv: TriphoneInventory) -> HmmParams:
    """Copy each triphone state's parameters from its CI phone
    (cp_parm / init_mixw capability)."""
    n = inv.n_state
    S_cd = inv.n_sen
    K, D = ci.means.shape[1], ci.means.shape[2]
    means = np.zeros((S_cd, K, D), np.float32)
    var = np.zeros((S_cd, K, D), np.float32)
    lnw = np.zeros((S_cd, K), np.float32)
    means[: model.n_sen] = ci.means
    var[: model.n_sen] = ci.var
    lnw[: model.n_sen] = ci.lnw
    for t, (b, lc, rc, wp) in enumerate(inv.tris):
        for s in range(n):
            src = model.senone(b, s)
            dst = inv.senone(t, s)
            means[dst] = ci.means[src]
            var[dst] = ci.var[src]
            lnw[dst] = ci.lnw[src]
    return HmmParams(means=means, var=var, lnw=lnw, tp=ci.tp)


# ----------------------------------------------------------------------
def tie_states(inv: TriphoneInventory, params: HmmParams,
               occ: np.ndarray, max_senones_per_group: int = 4,
               min_occ: float = 1.0) -> Tuple[np.ndarray, HmmParams]:
    """Senone tying (bldtree/prunetree/tiestate capability) by
    occupancy-weighted agglomerative clustering.

    For each (base phone, state) group of untied CD senones, repeatedly
    merge the senone pair with the smallest weighted log-likelihood loss
    (single-Gaussian approximation of each senone) until the group has at
    most `max_senones_per_group` clusters.  Low-occupancy senones merge
    first.  Returns (senone map old->new, tied parameters).
    """
    n = inv.n_state
    nb = len(inv.base.phones)
    # Single-Gaussian sufficient stats per senone from current params + occ.
    S = inv.n_sen
    occ_s = occ.sum(-1) if occ.ndim == 2 else occ            # [S]
    w = np.exp(params.lnw)
    mu = (w[..., None] * params.means).sum(1)                # [S, D]
    second = (w[..., None] * (params.var + params.means ** 2)).sum(1)
    sg_var = np.maximum(second - mu ** 2, VAR_FLOOR)

    def merge_loss(i, j):
        oi, oj = max(occ_s[i], 1e-3), max(occ_s[j], 1e-3)
        om = oi + oj
        mum = (oi * mu[i] + oj * mu[j]) / om
        varm = (oi * (sg_var[i] + mu[i] ** 2) + oj * (sg_var[j] + mu[j] ** 2)
                ) / om - mum ** 2
        varm = np.maximum(varm, VAR_FLOOR)
        # L = 0.5 * sum_d [om*log varm - oi*log vi - oj*log vj]
        return 0.5 * float(om * np.log(varm).sum()
                           - oi * np.log(sg_var[i]).sum()
                           - oj * np.log(sg_var[j]).sum())

    smap = np.arange(S, dtype=np.int64)
    groups: Dict[Tuple[int, int], List[int]] = {}
    for t, (b, lc, rc, wp) in enumerate(inv.tris):
        for s in range(n):
            groups.setdefault((b, s), []).append(inv.senone(t, s))
    for key, sens in groups.items():
        clusters = [[s] for s in sens]
        reps = list(sens)
        while len(clusters) > max_senones_per_group:
            best, bl = None, np.inf
            for i in range(len(reps)):
                for j in range(i + 1, len(reps)):
                    l = merge_loss(reps[i], reps[j])
                    if l < bl:
                        best, bl = (i, j), l
            i, j = best
            # merge j into i (rep stays i's — approximation)
            clusters[i].extend(clusters[j])
            del clusters[j], reps[j]
        for cl in clusters:
            # representative = highest-occupancy member
            rep = max(cl, key=lambda s: occ_s[s])
            for s in cl:
                smap[s] = rep
    # Compact: renumber kept senones; CI senones stay.
    kept = sorted(set(smap.tolist()) | set(range(inv.base.n_sen)))
    newid = {s: i for i, s in enumerate(kept)}
    smap_final = np.asarray([newid[smap[s]] for s in range(S)], np.int64)
    tied = HmmParams(means=params.means[kept], var=params.var[kept],
                     lnw=params.lnw[kept], tp=params.tp)
    return smap_final, tied


# ----------------------------------------------------------------------
def em_loop(batch, params: HmmParams, n_iters: int = 8,
            conv_ratio: float = 1e-4, verbose: bool = False,
            device: torch.device | str = "cuda"
            ) -> Tuple[HmmParams, np.ndarray, List[float]]:
    """Generic EM loop over a packed batch, its forward-backward on
    `device`; returns (params, last senone occupancies, per-frame
    log-likelihood history)."""
    batch = batch.to(device)
    hist: List[float] = []
    occ = None
    prev = None
    for it in range(n_iters):
        llh, acc = forward_backward(batch, *device_params(params, device),
                                    device=device)
        acc = host_acc(acc)
        ll = float(llh.cpu().numpy().sum()) / max(int(acc["n_frames"]), 1)
        occ = acc["mixw"]
        params = reestimate(params, acc)
        hist.append(ll)
        if verbose:
            print(f"    em iter {it}: per-frame ll {ll:.3f}", flush=True)
        if prev is not None and ll >= prev and \
                (ll - prev) / max(abs(prev), 1.0) < conv_ratio:
            break
        prev = ll
    return params, occ, hist


def train_full_pipeline(model: FlatModel, pron: Dict[str, List[str]],
                        transcripts: Sequence[Sequence[str]],
                        feats: Sequence[np.ndarray], gauss: int = 2,
                        ci_iters: int = 12, cd_iters: int = 8,
                        tied_iters: int = 8,
                        max_senones_per_group: int = 4,
                        tying: str = "agglom",
                        n_tied_senones: int = 0,
                        verbose: bool = False,
                        device: torch.device | str = "cuda"):
    """The 20.ci_hmm -> 30.cd_hmm_untied -> tie -> 50.cd_hmm_tied ->
    split-to-N stages, every EM iteration on `device`.  Returns (inv,
    smap, tied params, history dict).

    tying="dtree" uses linguistic-question decision trees
    (40.buildtrees/45.prunetree/tiestate capability, train/dtree.py) with a
    global senone budget `n_tied_senones`; the resulting SenoneForest is
    attached as `inv.forest` so unseen triphones can be assigned senones.
    tying="agglom" is occupancy-weighted agglomerative merging (seen
    triphones only)."""
    from .sentence_hmm import build_sentence_hmm
    from .trainer import flat_start

    feats = [np.asarray(f) for f in feats]
    hist = {}
    # Stage 1: CI, 1 Gaussian.
    tr = Trainer(model, pron, transcripts, feats, K=1, device=device)
    hist["ci"] = tr.train(max_iter=ci_iters, conv_ratio=1e-4)
    ci = tr.params
    if verbose:
        print(f"  CI: {len(hist['ci'])} iters, ll {hist['ci'][-1]:.3f}")

    # Stage 2: CD untied, 1 Gaussian, init from CI.
    inv = TriphoneInventory.from_corpus(model, pron, transcripts)
    view = inv.make_cd_model()
    rp = view.resolve_pron(pron)
    hmms = [cd_sentence_hmm(t, rp, view) for t in transcripts]
    cd_batch = pack_batch(hmms, feats)
    cd = init_cd_params(ci, model, inv)
    cd, occ, hist["cd_untied"] = em_loop(cd_batch, cd, cd_iters,
                                         verbose=verbose, device=device)
    if verbose:
        print(f"  CD-untied: {inv.n_tri} triphones, {inv.n_sen} senones, "
              f"ll {hist['cd_untied'][-1]:.3f}")

    # Stage 3: tie states, remap, retrain.
    if tying == "dtree":
        from .dtree import tie_states_dtree
        budget = n_tied_senones or (model.n_sen
                                    + max_senones_per_group * model.n_sen)
        smap, tied, forest = tie_states_dtree(
            inv, cd, occ, total_leaves=budget - model.n_sen)
        inv.forest = forest
    else:
        smap, tied = tie_states(inv, cd, occ,
                                max_senones_per_group=max_senones_per_group)
    tied_batch = pack_batch(hmms, feats)
    tied_batch.state_sen = smap[tied_batch.state_sen].astype(np.int32)
    tied, _, hist["tied"] = em_loop(tied_batch, tied, tied_iters,
                                    verbose=verbose, device=device)
    if verbose:
        print(f"  tied: {tied.means.shape[0]} senones, "
              f"ll {hist['tied'][-1]:.3f}")

    # Stage 4: mixture splitting to the target Gaussian count.
    K = 1
    while K < gauss:
        tied = split_gaussians(tied)
        K *= 2
        tied, _, h = em_loop(tied_batch, tied, tied_iters, verbose=verbose,
                             device=device)
        hist[f"split_{K}"] = h
        if verbose:
            print(f"  {K} Gaussians: ll {h[-1]:.3f}")
    return inv, smap, tied, hist


def export_cd_model(dirpath: str, inv: TriphoneInventory, smap: np.ndarray,
                    params: HmmParams, feat: str = "1s_c_d_dd") -> None:
    """Write a decodable tied-CD model directory: triphone text mdef with
    the tied senone map + s3 parameter files (model_def_io capability)."""
    import os
    from .model_io import write_gauden, write_mixture_weights, write_tmat

    os.makedirs(dirpath, exist_ok=True)
    model = inv.base
    n = inv.n_state
    npho = len(model.phones)
    n_tied = params.means.shape[0]
    with open(os.path.join(dirpath, "mdef"), "w") as fh:
        fh.write("0.3\n")
        fh.write(f"{npho} n_base\n{inv.n_tri} n_tri\n")
        fh.write(f"{(npho + inv.n_tri) * (n + 1)} n_state_map\n")
        fh.write(f"{n_tied} n_tied_state\n")
        fh.write(f"{model.n_sen} n_tied_ci_state\n")
        fh.write(f"{npho} n_tied_tmat\n")
        fh.write("#\n# Columns definitions\n")
        fh.write("#base lft  rt p attrib tmat      ... state id's ...\n")
        for i, p in enumerate(model.phones):
            attrib = "filler" if p == "SIL" or (
                p.startswith("+") and p.endswith("+")) else "n/a"
            states = " ".join(str(int(smap[model.senone(i, s)]))
                              for s in range(n))
            fh.write(f"{p:>8s} {'-':>4s} {'-':>4s} {'-':>2s} "
                     f"{attrib:>8s} {i:>4d}    {states} N\n")
        for t, (b, lc, rc, wp) in enumerate(inv.tris):
            states = " ".join(str(int(smap[inv.senone(t, s)]))
                              for s in range(n))
            fh.write(f"{model.phones[b]:>8s} {model.phones[lc]:>4s} "
                     f"{model.phones[rc]:>4s} {TriphoneInventory.WPOS[wp]:>2s} "
                     f"{'n/a':>8s} {b:>4d}    {states} N\n")
    write_gauden(os.path.join(dirpath, "means"),
                 os.path.join(dirpath, "variances"), params)
    write_mixture_weights(os.path.join(dirpath, "mixture_weights"), params)
    write_tmat(os.path.join(dirpath, "transition_matrices"), params)
    with open(os.path.join(dirpath, "feat.params"), "w") as fh:
        fh.write(f"-feat {feat}\n-cmn current\n-agc none\n")
