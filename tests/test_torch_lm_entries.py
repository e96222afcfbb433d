"""The cross-word entry readout (`ops/lm_entries.py`) on the CPU: the
plain version, the search-word successor lists the kernel reads, and where
the search calls the wrapper.

- `entries_ref` equals the composition the steps ran before it
  (`Readout.entries`' score rows, column gather, bonus, candidates, `amax`
  and `argmax`, and the mpx step's payload gather) bit for bit, and so does
  a numpy emulation of the kernel's algorithm over the successor lists
  (each history's backed-off score, its bigram successors, bo(h1, h2),
  its trigram successors, the first maximum over the exits), on planted
  cases: <s> histories (the longest list), -1 histories, fillers, right
  context variants through `rssid`, dead lanes, a row whose candidates
  are all NEG_INF, ties across the exits, two search words of one LM id,
  a word clamped from LM id -1, and the MEDIUM fixture's own vocabulary
  and LM; the lists equal a brute-force inverse of the search words' LM
  ids.
- On CPU tensors `entries` runs the plain version and launches nothing;
  it raises on a wrong dtype, shape or device.
- The mpx and static steps call the wrapper once a frame on the
  `score_rows` backend; the dense backend and the tree steps never.
- `least_bytes` at the PTM cell's shape.

The kernel itself, against this plain version bit for bit, is in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from cmusphinx_tpu_torch import fixture
from cmusphinx_tpu_torch.decode import NgramSearch
from cmusphinx_tpu_torch.decode.ngram_search import NgramVocab
from cmusphinx_tpu_torch.frontend import FeatPipeline
from cmusphinx_tpu_torch.models.ngram import NgramModel
from cmusphinx_tpu_torch.models.ngram_device import DeviceNgram
from cmusphinx_tpu_torch.ops import ContinuousScorer, lm_entries
from cmusphinx_tpu_torch.ops.hmm import NEG_INF

LW32, WIP32 = float(np.float32(6.5)), float(np.float32(np.log(0.65)))


def small_lm(rng, V=40, start=0, maxb=5, maxt=3):
    """A trigram LM of V words whose word `start` (<s>) precedes every
    other word and the rest 0-`maxb` words; each bigram has 0-`maxt`
    trigram successors.  Scores are multiples of 1/4 in a narrow range,
    so sums tie."""
    m = NgramModel()
    m.n = 3
    m.words = [f"w{i}" for i in range(V)]
    m.words[start] = "<s>"
    m.wid = {w: i for i, w in enumerate(m.words)}

    def q(*shape):
        return (rng.randint(-24, -1, shape) / 4.0).astype(np.float32)

    m.ug_prob, m.ug_bo = q(V), q(V)
    rows = [np.sort(rng.choice(V, rng.randint(0, maxb + 1), replace=False))
            for _ in range(V)]
    rows[start] = np.array([w for w in range(V) if w != start])
    m.bg_ptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    m.bg_wid = np.concatenate(rows).astype(np.int32)
    NB = len(m.bg_wid)
    m.bg_prob, m.bg_bo = q(NB), q(NB)
    trows = [np.sort(rng.choice(V, rng.randint(0, maxt + 1), replace=False))
             for _ in range(NB)]
    m.tg_ptr = np.concatenate([[0], np.cumsum([len(r) for r in trows])])
    m.tg_wid = np.concatenate(trows).astype(np.int32)
    m.tg_prob = q(len(m.tg_wid))
    return m


def brute_lists(lm, lmwid_c):
    """Each LM word's bigram successors and each bigram row's trigram
    successors as (search word, score) lists, by loops."""
    inverse = {}
    for w, i in enumerate(lmwid_c.tolist()):
        inverse.setdefault(i, []).append(w)

    def expand(ptr, wid, prob, rows):
        return [sorted((w, float(prob[j])) for j in range(ptr[r], ptr[r + 1])
                       for w in inverse.get(int(wid[j]), ()))
                for r in range(rows)]

    return (expand(lm.bg_ptr, lm.bg_wid, lm.bg_prob, lm.n_words),
            expand(lm.tg_ptr, lm.tg_wid, lm.tg_prob, len(lm.bg_wid)))


def csr_lists(ptr, w, p):
    ptr, w, p = ptr.numpy(), w.numpy(), p.numpy()
    return [list(zip(w[a:b].tolist(), p[a:b].astype(float).tolist()))
            for a, b in zip(ptr[:-1], ptr[1:])]


def previous_entries(dlm, ro, t, ok, wsel, h1, h2, slot_rc, lastci):
    """The readout as `Readout.entries` and the mpx step composed it
    before `lm_entries`: (ent_w, ebp_w, ent_pay)."""
    B, E = h1.shape
    W = ro["lmwid_c"].shape[0]
    rows = dlm.score_rows(h1.reshape(-1), h2.reshape(-1))
    lmw = rows[:, ro["lmwid_c"]].view(B, E, W)
    bonus = torch.where(ro["is_filler"], ro["fil_pen"],
                        LW32 * lmw + WIP32)
    if slot_rc.shape[2] == 1:
        ac = slot_rc
    else:
        ac = torch.gather(slot_rc, 2, ro["rssid"][wsel[..., None],
                                                  ro["firstci"]])
    cand = torch.where(ok[..., None], ac + bonus, NEG_INF)
    ent_w = cand.amax(1)
    estar = cand.argmax(1)
    ebp_w = torch.where(ent_w > NEG_INF * 0.5, t * E + estar, -1)
    eh = torch.gather(torch.stack([lastci[wsel], h2, h1], -1), 1,
                      estar[..., None].expand(B, W, 3))
    ent_pay = torch.cat([ebp_w[..., None], eh], -1).to(torch.int32)
    return ent_w, ebp_w, ent_pay


def emulate(lm, tab, t, ok, wsel, h1, h2, slot_rc, lastci):
    """The kernel's algorithm in numpy float32 over the successor lists:
    for each exit the backed-off base ug_bo(h2) + ug(w) (+ bo(h1, h2)),
    h2's bigram successors (+ bo(h1, h2)), then the (h1, h2) trigram
    successors; the bonus, the candidate, the first maximum over e."""
    f32 = np.float32
    sc = tab.succ
    sbg_ptr, sbg_w, sbg_p = (x.numpy() for x in sc[:3])
    stg_ptr, stg_w, stg_p = (x.numpy() for x in sc[3:])
    lid = tab.lmwid_c.numpy()
    fil, fpen = tab.is_filler.numpy(), tab.fil_pen.numpy()
    rss, fci = tab.rssid.numpy(), tab.firstci.numpy()
    ok, wsel, h1, h2, rc = (x.numpy() for x in (ok, wsel, h1, h2, slot_rc))
    B, E = ok.shape
    W = len(lid)
    tri = lm.n >= 3 and len(lm.tg_wid) > 0
    ug = lm.ug_prob[lid]
    best = np.full((B, W), f32(NEG_INF), f32)
    estar = np.zeros((B, W), np.int64)
    for b in range(B):
        for e in range(E):
            cand = np.full(W, f32(NEG_INF), f32)
            if ok[b, e]:
                x2, x1 = h2[b, e], h1[b, e]
                v = ug + lm.ug_bo[x2] if x2 >= 0 else ug.copy()
                bo12, r = f32(0.0), -1
                if tri and x1 >= 0 and x2 >= 0:
                    row = lm.bg_wid[lm.bg_ptr[x1]: lm.bg_ptr[x1 + 1]]
                    hit = np.nonzero(row == x2)[0]
                    if len(hit):
                        r = lm.bg_ptr[x1] + hit[0]
                        bo12 = lm.bg_bo[r]
                if x2 >= 0:
                    k = slice(sbg_ptr[x2], sbg_ptr[x2 + 1])
                    v[sbg_w[k]] = sbg_p[k]
                if tri:
                    v = v + bo12
                if r >= 0:
                    k = slice(stg_ptr[r], stg_ptr[r + 1])
                    v[stg_w[k]] = stg_p[k]
                bonus = np.where(fil, fpen, f32(LW32) * v + f32(WIP32))
                ac = (rc[b, e, 0] if rc.shape[2] == 1
                      else rc[b, e][rss[wsel[b, e], fci]])
                cand = (ac + bonus).astype(f32)
            up = (cand > best[b]) | (e == 0)
            best[b] = np.where(up, cand, best[b])
            estar[b] = np.where(up, e, estar[b])
    ebp = np.where(best > f32(NEG_INF) * f32(0.5), int(t) * E + estar, -1)
    be = np.arange(B)[:, None], estar
    pay = np.stack([ebp, lastci.numpy()[wsel[be]], h2[be], h1[be]],
                   -1).astype(np.int32)
    return torch.as_tensor(best), torch.as_tensor(ebp), torch.as_tensor(pay)


CASES = ["start", "no_history", "fillers", "variants", "dead_lanes",
         "all_dead_row", "ties", "shared_lmid", "clamped", "medium"]


@pytest.fixture(scope="module")
def medium():
    return fixture.build(0, size=fixture.MEDIUM)


def case_inputs(case, medium=None):
    """A case's (NgramModel, search words' LM ids clamped [W], its
    `DeviceNgram` on the CPU without a dense table, the readout's tables
    by name, `Tables`, the exits (t, ok, wsel, h1, h2, slot_rc, lastci)):
    B=3 rows of E=40 exits (more than the kernel stages at once); `medium`
    the MEDIUM fixture (the "medium" case)."""
    rng = np.random.RandomState(CASES.index(case) + 11)
    B, E, n_ci = 3, 40, 7
    Vr = 3 if case in ("variants", "medium") else 1
    if case == "medium":
        lm = medium.lm
        v = NgramVocab(lm, medium.dict)
        lmwid, is_fil = v.lmwid.astype(np.int64), v.is_filler
    else:
        lm = small_lm(rng)
        V = lm.n_words
        # Search words in another order than the LM's, a few LM ids twice.
        lmwid = rng.permutation(np.concatenate([
            np.arange(1, V), rng.choice(np.arange(1, V), 6, replace=False),
            [-1, -1]])).astype(np.int64)
        is_fil = lmwid < 0
        if case == "clamped":
            is_fil[np.nonzero(lmwid < 0)[0][0]] = False
        if case == "fillers":
            is_fil |= rng.rand(len(lmwid)) < 0.3
    W, V = len(lmwid), lm.n_words
    start = lm.word_id("<s>") if lm.word_id("<s>") >= 0 else 0
    h2 = rng.randint(-1, V, (B, E))
    h1 = rng.randint(-1, V, (B, E))
    # Half the exits' histories are trigram contexts.
    tg_b = np.repeat(np.arange(len(lm.bg_wid)), np.diff(lm.tg_ptr))
    bg_w1 = np.repeat(np.arange(V), np.diff(lm.bg_ptr))
    pick = rng.choice(tg_b, (B, E // 2))
    h1[:, : E // 2], h2[:, : E // 2] = bg_w1[pick], lm.bg_wid[pick]
    if case == "start":
        h2[:, ::2] = start
        h1[:, ::4] = -1
    if case == "no_history":
        h2[:, ::3] = -1
        h1[:, 1::3] = -1
    ok = rng.rand(B, E) < (0.4 if case == "dead_lanes" else 0.9)
    if case == "all_dead_row":
        ok[1] = False
    slot_rc = (rng.randint(-40, -20, (B, E, Vr)) / 2.0).astype(np.float32)
    slot_rc[rng.rand(B, E, Vr) < 0.1] = NEG_INF
    if case == "ties":
        h2[:, 1:6], h1[:, 1:6] = h2[:, :1], h1[:, :1]
        slot_rc[:, 1:6] = slot_rc[:, :1]
    wsel = rng.randint(0, W, (B, E))
    fil_pen = (rng.randint(-30, -10, W) / 2.0).astype(np.float32)
    firstci = rng.randint(0, n_ci, W)
    rssid = rng.randint(0, Vr, (W, n_ci))
    lastci = rng.randint(0, n_ci, W)
    lmwid_c = np.maximum(lmwid, 0)
    dlm = DeviceNgram(lm, device="cpu", dense3_limit=0)
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64))
    ro = {"lmwid_c": i64(lmwid_c), "is_filler": torch.as_tensor(is_fil),
          "fil_pen": torch.as_tensor(fil_pen), "firstci": i64(firstci),
          "rssid": i64(rssid)}
    tab = lm_entries.Tables(ro["lmwid_c"], ro["firstci"], ro["is_filler"],
                            ro["fil_pen"], ro["rssid"],
                            lm_entries.successors(dlm, ro["lmwid_c"]),
                            LW32, WIP32)
    exits = (torch.tensor(7), torch.as_tensor(ok), i64(wsel), i64(h1),
             i64(h2), torch.as_tensor(slot_rc), i64(lastci))
    return lm, lmwid_c, dlm, ro, tab, exits


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("case", CASES)
def test_entries_ref_and_the_kernels_lists_equal_the_previous_readout(
        case, request):
    lm, lmwid_c, dlm, ro, tab, ex = case_inputs(
        case, request.getfixturevalue("medium") if case == "medium" else None)
    t, ok, wsel, h1, h2, slot_rc, lastci = ex
    # The lists: a brute-force inverse of the search words' LM ids.
    bg, tg = brute_lists(lm, lmwid_c)
    assert csr_lists(*tab.succ[:3]) == bg
    assert csr_lists(*tab.succ[3:]) == tg
    ent_w, ebp_w, ent_pay = previous_entries(dlm, ro, t, ok, wsel, h1, h2,
                                             slot_rc, lastci)
    got_w, got_ebp = lm_entries.entries_ref(dlm, tab, *ex[:6])
    got_w2, got_pay = lm_entries.entries_ref(dlm, tab, *ex)
    for a, b in ((got_w, ent_w), (got_w2, ent_w), (got_ebp, ebp_w),
                 (got_pay, ent_pay)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    emu_w, emu_ebp, emu_pay = emulate(lm, tab, *ex)
    assert torch.equal(_bits(emu_w), _bits(ent_w))
    assert torch.equal(emu_ebp, ebp_w) and torch.equal(emu_pay, ent_pay)
    # The case plants what it names.
    B, E = ok.shape
    cand_rows = ent_w > NEG_INF * 0.5
    assert cand_rows.any()
    if case == "start":
        start = lm.word_id("<s>")
        n = int(np.diff(lm.bg_ptr)[start])
        assert n == int(np.diff(lm.bg_ptr).max()) == lm.n_words - 1
        assert (ent_pay[..., 2] == start).any()
    if case == "no_history":
        assert (ent_pay[..., 2] == -1).any() and (ent_pay[..., 3] == -1).any()
    if case in ("fillers", "clamped", "medium"):
        assert (ro["is_filler"] & cand_rows).any()
    if case == "variants":
        assert slot_rc.shape[2] == 3
    if case == "dead_lanes":
        assert (~ok).sum() > ok.sum() // 2
    if case == "all_dead_row":
        assert (ent_w[1] == NEG_INF).all() and (ebp_w[1] == -1).all()
        assert (ent_pay[1, :, 0] == -1).all()
        assert torch.equal(ent_pay[1, :, 2], h2[1, :1].int().expand(
            ent_pay.shape[1]))
    if case == "ties":
        assert ((ebp_w == t * E) & ok[:, :1] & ok[:, 1:2]).any()
    if case == "shared_lmid":
        ids, n = np.unique(lmwid_c, return_counts=True)
        assert (n[ids > 0] > 1).any()
    if case == "clamped":
        w = np.nonzero((lmwid_c == 0) & ~ro["is_filler"].numpy())[0]
        assert len(w) and (cand_rows[:, w]).any()


def test_cpu_tensors_take_the_plain_version():
    lm, _, dlm, ro, tab, ex = case_inputs("variants")
    lm_entries.launches.clear()
    for args in (ex[:6], ex):
        got = lm_entries.entries(dlm, tab, *args)
        want = lm_entries.entries_ref(dlm, tab, *args)
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))
    assert not lm_entries.launches


def test_wrapper_raises_on_wrong_inputs():
    _, _, dlm, ro, tab, ex = case_inputs("start")
    t, ok, wsel, h1, h2, slot_rc, lastci = ex
    f = lm_entries.entries
    with pytest.raises(TypeError):
        f(dlm, tab, t, ok.int(), wsel, h1, h2, slot_rc)
    with pytest.raises(TypeError):
        f(dlm, tab, t, ok, wsel.int(), h1, h2, slot_rc)
    with pytest.raises(TypeError):
        f(dlm, tab, t.int(), ok, wsel, h1, h2, slot_rc)
    with pytest.raises(ValueError):
        f(dlm, tab, t, ok, wsel, h1[:, :-1], h2, slot_rc)
    with pytest.raises(ValueError):
        f(dlm, tab, t, ok, wsel, h1, h2, slot_rc[:, :-1])
    with pytest.raises(ValueError):
        f(dlm, tab, t, ok, wsel, h1, h2, slot_rc, lastci[:-1])
    with pytest.raises(TypeError):
        f(dlm, tab._replace(fil_pen=tab.fil_pen.double()), *ex)
    with pytest.raises(ValueError, match="contiguous"):
        f(dlm, tab, t, ok, wsel.t().contiguous().t(), h1, h2, slot_rc)
    with pytest.raises(ValueError, match="different devices"):
        f(dlm, tab, t, ok, wsel, h1, h2.to("meta"), slot_rc)
    meta = [x.to("meta") for x in ex]
    with pytest.raises(ValueError, match="no lm-entries kernel"):
        f(dlm, tab._replace(**{k: getattr(tab, k).to("meta") for k in (
            "lmwid_c", "firstci", "is_filler", "fil_pen", "rssid")}), *meta)


@pytest.fixture(scope="module")
def small():
    return fixture.build(0, size=fixture.SMALL)


@pytest.mark.parametrize("size,kw,calls", [
    ("medium", {"lexmode": "flat"}, 1),
    ("medium", {"lexmode": "flat", "rcmode": "fanout"}, 1),
    ("medium", {"lexmode": "flat", "lcmode": "mpx"}, 1),
    ("medium", {"lexmode": "flat", "lcmode": "mpx", "rcmode": "fanout"}, 1),
    ("medium", {"lexmode": "tree"}, 0),
    ("medium", {"lexmode": "tree", "nlextree": 2}, 0),
    ("small", {}, 0)])
def test_only_flat_steps_on_score_rows_call_the_wrapper(size, kw, calls,
                                                        request, monkeypatch):
    """A block of frames of each step: the mpx and static steps over the
    MEDIUM fixture's LM (no dense table) call the wrapper once a frame, in
    the mpx step with the payloads; the tree steps never, nor the SMALL
    fixture's steps (dense table: the plain version), whose entries still
    equal the wrapper's."""
    fx, K = request.getfixturevalue(size), 3
    s = NgramSearch(fx.lm, fx.dict, fx.mdef, fx.tmat,
                    ContinuousScorer(fx.gauden, fx.ln_mixw, device="cpu"),
                    device="cpu", **kw)
    assert (s.dlm.tg_dense is None) == (size == "medium")
    assert (s.step.ro.lm_tab.succ is None) == (calls == 0)
    seen, real = [], lm_entries.entries
    monkeypatch.setattr(lm_entries, "entries", lambda *a: seen.append(
        a[-1] is not None and a[-1].shape == (s.vocab.n_word,)) or real(*a))
    fp = FeatPipeline(fx.feat_config(), device="cpu")
    x, T, _ = s._pad([fp.compute(c) for c in fx.ceps[:2]])
    B, F = x.shape[0], x.shape[1]
    scores = s.scorer.score(x)
    carry = s.step.init_carry(B, F)
    tape = s._tape(B, F)
    with torch.inference_mode():
        s._block(carry, (scores[:, :K],
                         (torch.arange(F)[None] < T[:, None])[:, :K], None),
                 torch.zeros((), dtype=torch.int64),
                 tuple(a[:, :K] for a in tape))
    mpx = s.graph.lc_mode == "mpx"
    assert seen == [mpx] * (K * calls)


def test_least_bytes_at_the_ptm_cell():
    """The fewest bytes of the PTM cell's readout (B=16, E=32, W=64,002
    words, composite right contexts: Vr=1, 40 CI phones, the mpx step's
    payloads): the word tables and unigram scores, the exits, the
    outputs, and 8 bytes a successor entry in the words."""
    B, E, W, n_ci = 16, 32, 64002, 40
    least = lm_entries.least_bytes(B, E, W, 1, n_ci, payload=True)
    assert least == W * 25 + B * E * 29 + B * W * 20
    assert least == 22_095_538
    assert lm_entries.least_bytes(B, E, W, 1, n_ci, True, 64000) \
        == least + 512_000
    assert lm_entries.least_bytes(B, E, W, 3, n_ci, False) \
        == W * 25 + B * E * (37 + 320) + B * W * 12
