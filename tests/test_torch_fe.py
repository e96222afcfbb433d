"""Port parity: the waveform frontend (cmusphinx_tpu_torch.frontend.fe)
against cmusphinx_tpu.frontend.fe.Frontend on the same seeded audio.

The host tables (mel filterbank, DCT, inverse DCT, window, lifter) are
copies and must be equal.  The per-frame math differs only in the FFT
(pocketfft here, XLA's FFT in the reference) and in the order of f32
sums, which the log of the mel energies turns into an absolute error.
Tolerance: 1e-4 on each log-mel value (measured: <= 1.6e-5, quiet and
tonal frames included), carried through the linear maps as bounds:
|d cep_i| <= sum_j 1e-4 |dct[j, i]|, times |lifter_i|; smoothspec through
|idct| as well.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cmusphinx_tpu.frontend.fe import FE_ARGS as JAX_FE_ARGS
from cmusphinx_tpu.frontend.fe import Frontend as JaxFrontend
from cmusphinx_tpu.utils.config import Config
from cmusphinx_tpu_torch.frontend.fe import FE_ARGS, Frontend

LOGMEL_TOL = 1e-4

CONFIGS = {
    "legacy": {},
    "dct": {"transform": "dct"},
    "htk_lifter": {"transform": "htk", "lifter": 22},
    "logspec": {"logspec": True},
    "smoothspec": {"smoothspec": True, "transform": "dct"},
    "remove_dc": {"remove_dc": True},
    "warp_piecewise": {"warp_type": "piecewise_linear", "warp_params": "1.1"},
    "warp_affine": {"warp_type": "affine", "warp_params": "0.9 30"},
    "hub4_params": {"nfilt": 20, "lowerf": 1, "upperf": 4000,
                    "transform": "dct", "wlen": 0.025},
    "8k_doublebw": {"samprate": 8000, "nfft": 256, "upperf": 3500,
                    "doublebw": True},
}


def _table(args):
    """An argument table's values (the port's `Arg` is its own class)."""
    return [dataclasses.astuple(a) for a in args]


def signals(seed: int = 0, sr: int = 16000):
    rng = np.random.RandomState(seed)
    t = np.arange(int(sr * 0.6)) / sr
    return {
        "silence": np.zeros(9000, np.float32),
        "tones": (3000 * np.sin(2 * np.pi * 440 * t)
                  + 1000 * np.sin(2 * np.pi * 1800 * t)).astype(np.float32),
        "noise": (rng.randn(9000) * 500).astype(np.float32),
        "quiet": rng.randint(-2, 3, 9000).astype(np.float32),
        "short": (rng.randn(300) * 100).astype(np.float32),
        "empty": np.zeros(0, np.float32),
    }


def bound(fe: Frontend) -> np.ndarray:
    """Per-output-dimension error bound for `fe`'s configuration."""
    b = np.full(fe.nfilt, LOGMEL_TOL)
    if fe.logspec:
        return b
    b = b @ np.abs(fe.dct.numpy().astype(np.float64))
    if fe.smoothspec:
        return b @ np.abs(fe.idct.numpy().astype(np.float64))
    if fe.lifter is not None:
        b = b * np.abs(fe.lifter.numpy())
    return b


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_frontend_matches_reference(name):
    params = CONFIGS[name]
    jfe = JaxFrontend(Config(JAX_FE_ARGS), **params)
    tfe = Frontend(Config(FE_ARGS), device="cpu", **params)
    np.testing.assert_array_equal(tfe.filters.numpy(),
                                  jfe.filters.astype(np.float32))
    np.testing.assert_array_equal(tfe.dct.numpy(), jfe.dct.astype(np.float32))
    np.testing.assert_array_equal(tfe.window.numpy(),
                                  jfe.window.astype(np.float32))
    assert tfe.output_dim == jfe.output_dim
    b = bound(tfe)
    for sig, x in signals(sorted(CONFIGS).index(name),
                          int(tfe.sampling_rate)).items():
        want = jfe.process(x)
        got = tfe.process(x)
        assert got.shape == want.shape, (sig, got.shape, want.shape)
        assert got.shape[0] == tfe.n_frames(len(x))
        err = np.abs(got.astype(np.float64) - want)
        assert np.all(err <= b), (sig, float(err.max()))


def test_frontend_batch_and_dither():
    x = signals(3)["noise"]
    params = {"dither": True, "seed": 7}
    jfe = JaxFrontend(Config(JAX_FE_ARGS), **params)
    tfe = Frontend(Config(FE_ARGS), device="cpu", **params)
    xb = np.stack([x, x[::-1].copy()])
    want, got = jfe.process(xb), tfe.process(xb)
    assert got.shape == want.shape == (2, tfe.n_frames(len(x)), 13)
    assert np.all(np.abs(got - want) <= bound(tfe))
    # The seeded host dither is the reference's, draw for draw.
    np.testing.assert_array_equal(tfe.process(x), tfe.process(x))
    plain = Frontend(Config(FE_ARGS), device="cpu")
    assert not np.array_equal(plain.process(x), tfe.process(x))
    for include_tail in (True, False):
        assert (tfe.process(x, include_tail).shape
                == jfe.process(x, include_tail).shape)


def test_frontend_rejects_bad_config():
    assert _table(FE_ARGS) == _table(JAX_FE_ARGS)
    with pytest.raises(ValueError):
        Frontend(Config(FE_ARGS), device="cpu", nfft=256)   # frame > nfft
    with pytest.raises(ValueError):
        Frontend(Config(FE_ARGS), device="cpu", transform="dft")
