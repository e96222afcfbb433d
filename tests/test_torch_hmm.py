"""Port parity: HMM Viterbi step and entry (cmusphinx_tpu_torch.ops.hmm)
against cmusphinx_tpu.ops.hmm, exactly, ties included.

Scores are drawn from a small set of values so that the candidates into a
state tie often: the tie order (self loop, then j-1, then j-2; the last
state on exit ties; entry only when strictly better) decides the payloads.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmusphinx_tpu.ops import hmm as jhmm
from cmusphinx_tpu_torch.ops import hmm as thmm


def _inputs(rng, N, S, n_payload=3):
    grid = np.array([-4.0, -2.0, -1.0, 0.0, thmm.NEG_INF], np.float32)
    alpha = rng.choice(grid, (N, S)).astype(np.float32)
    sen = rng.choice(grid[:4], (N, S)).astype(np.float32)
    tp = np.full((N, S, S + 1), thmm.NEG_INF, np.float32)
    for j in range(S):
        for k in range(j, min(j + 3, S + 1)):
            tp[:, j, k] = rng.choice(grid[:4], N)
    pays = tuple(rng.randint(-1, 50, (N, S)).astype(np.int32)
                 for _ in range(n_payload))
    return alpha, sen, tp, pays


def _bands(tp):
    """`hmm_step`'s transition argument: the flat bands as tensors."""
    return tuple(torch.as_tensor(b) for b in thmm.hmm_bands(tp))


def test_neg_inf_is_the_reference_sentinel():
    assert thmm.NEG_INF == float(jhmm.NEG_INF)


@pytest.mark.parametrize("S", [1, 2, 3, 5])
def test_hmm_step_matches_reference_with_ties(S):
    rng = np.random.RandomState(S)
    N, B = 64, 3
    batch = [_inputs(rng, N, S) for _ in range(B)]
    # The port takes a leading batch dimension; the reference one [N, S].
    ta, tpays, ex, exp = thmm.hmm_step(
        torch.as_tensor(np.stack([b[0] for b in batch])),
        tuple(torch.as_tensor(np.stack([b[3][i] for b in batch]))
              for i in range(3)),
        torch.as_tensor(np.stack([b[1] for b in batch])),
        _bands(batch[0][2]))
    for i, (alpha, sen, _, pays) in enumerate(batch):
        ja, jpays, jex, jexp = jhmm.hmm_step(
            jnp.asarray(alpha), tuple(map(jnp.asarray, pays)),
            jnp.asarray(sen), jnp.asarray(batch[0][2]))
        np.testing.assert_array_equal(ta[i].numpy(), np.asarray(ja))
        np.testing.assert_array_equal(ex[i].numpy(), np.asarray(jex))
        for a, b in zip(tpays, jpays):
            np.testing.assert_array_equal(a[i].numpy(), np.asarray(b))
        for a, b in zip(exp, jexp):
            np.testing.assert_array_equal(a[i].numpy(), np.asarray(b))


def test_hmm_step_ties_pick_self_then_prev_then_skip():
    # All three candidates into state 2 tie: the self loop's payload wins.
    alpha = torch.zeros((1, 3))
    sen = torch.zeros((1, 3))
    tp = np.zeros((1, 3, 4), np.float32)
    pay = torch.tensor([[10, 11, 12]])
    _, (p,), ex, (ep,) = thmm.hmm_step(alpha, (pay,), sen, _bands(tp))
    assert p.tolist() == [[10, 11, 12]]
    assert ep.tolist() == [12]
    # Without the self loop, j-1 beats the tied skip.
    tp[0, 2, 2] = thmm.NEG_INF
    _, (p,), _, _ = thmm.hmm_step(alpha, (pay,), sen, _bands(tp))
    assert p.tolist()[0][2] == 11


@pytest.mark.parametrize("S", [1, 3])
def test_hmm_enter_matches_reference(S):
    rng = np.random.RandomState(10 + S)
    N = 50
    alpha, _, _, pays = _inputs(rng, N, S)
    grid = np.array([-4.0, -2.0, -1.0, 0.0, thmm.NEG_INF], np.float32)
    entry = rng.choice(grid, N).astype(np.float32)
    eps = tuple(rng.randint(-1, 50, N).astype(np.int32) for _ in range(3))
    ja, jp = jhmm.hmm_enter(jnp.asarray(alpha), tuple(map(jnp.asarray, pays)),
                            jnp.asarray(entry), tuple(map(jnp.asarray, eps)))
    ta, tp_ = thmm.hmm_enter(torch.as_tensor(alpha),
                             tuple(map(torch.as_tensor, pays)),
                             torch.as_tensor(entry),
                             tuple(map(torch.as_tensor, eps)))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for a, b in zip(tp_, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # The inputs are left as they were.
    np.testing.assert_array_equal(
        thmm.hmm_enter(torch.as_tensor(alpha), (), torch.as_tensor(entry),
                       ())[0][:, 1:].numpy(), alpha[:, 1:])


def test_hmm_init_state():
    a, (p, q) = thmm.hmm_init_state(4, 3, 2, device="cpu")
    ja, (jp, jq) = jhmm.hmm_init_state(4, 3, 2)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    assert p.dtype == torch.int32


# ---- against the reference's batch-major form -------------------------
# The reference lays the static-senone searches out [B, S, C]; the port
# keeps one [B, C, S] step for every search.  Held against each other on
# transposed inputs.

def _bm_inputs(rng, B, C, S, pay_dtype):
    """[B, S, C] scores and payloads on a coarse grid (planted ties), and
    [C, S, S+1] Bakis transition matrices."""
    grid = np.array([-4.0, -2.0, -1.0, 0.0, thmm.NEG_INF], np.float32)
    alpha = rng.choice(grid, (B, S, C)).astype(np.float32)
    sen = rng.choice(grid[:4], (B, S, C)).astype(np.float32)
    tp = np.full((C, S, S + 1), thmm.NEG_INF, np.float32)
    for j in range(S):
        for k in range(j, min(j + 3, S + 1)):
            tp[:, j, k] = rng.choice(grid[:4], C)
    hi = 256 if pay_dtype == np.uint8 else 5000
    pays = (rng.randint(0, hi, (B, S, C)).astype(pay_dtype),
            rng.randint(-1, 60, (B, S, C)).astype(np.int32))
    return alpha, sen, tp, pays


def _cm(a):
    """[B, S, C] numpy -> the port's [B, C, S] tensor."""
    return torch.as_tensor(np.ascontiguousarray(np.swapaxes(a, 1, 2)))


def _bm(t):
    """The port's [B, C, S] tensor -> [B, S, C] numpy."""
    return t.transpose(1, 2).numpy()


def test_hmm_bands_match_reference():
    rng = np.random.RandomState(7)
    for S in (1, 2, 3, 5):
        tp = rng.randn(9, S, S + 1).astype(np.float32)
        d0, d1, d2, el, ep = thmm.hmm_bands(tp)
        r0, r1, r2, rel, rep = jhmm.hmm_bands(tp)
        # The reference's flat state-major [S*N] bands, channel-major.
        for a, b in ((d0, r0), (d1, r1), (d2, r2)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b.reshape(-1, 9).T)
        np.testing.assert_array_equal(el, rel)
        np.testing.assert_array_equal(ep, rep)


@pytest.mark.parametrize("pay_dtype", [np.int32, np.uint8])
@pytest.mark.parametrize("S", [1, 2, 3, 5])
def test_hmm_step_bm_matches_reference_with_ties(S, pay_dtype):
    rng = np.random.RandomState(20 + S)
    B, C = 3, 40
    alpha, sen, tp, pays = _bm_inputs(rng, B, C, S, pay_dtype)
    ja, jp, jex, jexp = jhmm.hmm_step_bm(
        jnp.asarray(alpha), tuple(map(jnp.asarray, pays)), jnp.asarray(sen),
        tuple(map(jnp.asarray, jhmm.hmm_bands(tp))))
    ta, tp_, tex, texp = thmm.hmm_step(
        _cm(alpha), tuple(map(_cm, pays)), _cm(sen), _bands(tp))
    np.testing.assert_array_equal(_bm(ta), np.asarray(ja))
    np.testing.assert_array_equal(tex.numpy(), np.asarray(jex))
    for a, b in zip(tp_, jp):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(_bm(a), np.asarray(b))
    for a, b in zip(texp, jexp):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("pay_dtype", [np.int32, np.uint8])
def test_hmm_enter_bm_matches_reference(pay_dtype):
    rng = np.random.RandomState(30)
    B, C, S = 2, 50, 3
    alpha, _, _, pays = _bm_inputs(rng, B, C, S, pay_dtype)
    grid = np.array([-4.0, -2.0, -1.0, 0.0, thmm.NEG_INF], np.float32)
    entry = rng.choice(grid, (B, C)).astype(np.float32)
    eps = (rng.randint(0, 200, (B, C)).astype(pay_dtype),
           rng.randint(-1, 60, (B, C)).astype(np.int32))
    ja, jp = jhmm.hmm_enter_bm(jnp.asarray(alpha),
                               tuple(map(jnp.asarray, pays)),
                               jnp.asarray(entry), tuple(map(jnp.asarray, eps)))
    ta, tp_ = thmm.hmm_enter(_cm(alpha), tuple(map(_cm, pays)),
                             torch.as_tensor(entry),
                             tuple(map(torch.as_tensor, eps)))
    np.testing.assert_array_equal(_bm(ta), np.asarray(ja))
    for a, b in zip(tp_, jp):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(_bm(a), np.asarray(b))
