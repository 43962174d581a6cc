"""The port's spectral onset detector and the ``detect_onsets`` dispatcher
against the JAX package's, on the CPU: ``peak_pick`` exactly, the spectral
detector's peaks equal and its normalised flux within 1e-5 of its scale,
and both routes of the dispatcher."""

import numpy as np
import pytest

import onset_fingerprinting_tpu.detect as jdet
import onset_fingerprinting_torch.detect as pdet
from onset_fingerprinting_tpu.detect.spectral import peak_pick as jpick
from onset_fingerprinting_torch.detect.spectral import peak_pick


def clicks(n_clicks=6, sr=96000, spacing=0.25, seed=0, channels=None):
    """Decaying noise bursts every ``spacing`` s over low noise."""
    rng = np.random.default_rng(seed)
    n = int(sr * spacing * (n_clicks + 1))
    shape = (n,) if channels is None else (n, channels)
    x = rng.normal(0, 1e-3, shape)
    for i in range(n_clicks):
        at = int(sr * spacing * (i + 0.7)) + int(rng.integers(0, 200))
        burst = rng.normal(0, 0.5, 2000) * np.exp(-np.arange(2000) / 300)
        x[at:at + 2000] += burst if channels is None else burst[:, None]
    return x.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_peak_pick_equals_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.random(400) ** 6
    x[:5] = 0.0
    x[rng.integers(0, 400, 20)] = 0.0
    for args in ((3, 1, 3, 2, 0.01, 4), (10, 10, 20, 5, 0.0, 0),
                 (1, 1, 1, 1, 0.1, 30)):
        np.testing.assert_array_equal(peak_pick(x, *args), jpick(x, *args))


@pytest.mark.parametrize("n_fft,hop", [(256, 32), (512, 64)])
def test_detect_onsets_spectral_equals_jax(n_fft, hop):
    x = clicks(seed=n_fft)
    peaks, oe = pdet.detect_onsets_spectral(x, n_fft, hop, return_oe=True,
                                            device="cpu")
    jpeaks, joe = jdet.detect_onsets_spectral(x, n_fft, hop, return_oe=True)
    assert len(peaks) == 6
    np.testing.assert_array_equal(peaks, jpeaks)
    assert oe.dtype == np.float64 and oe.shape == joe.shape
    assert np.abs(oe - joe).max() <= 1e-5 * np.abs(joe).max()


def test_dispatcher_spectral_route():
    x = clicks(seed=5)
    np.testing.assert_array_equal(
        pdet.detect_onsets(x, method="spectral", device="cpu"),
        jdet.detect_onsets(x, method="spectral"))


def test_dispatcher_amp_route():
    """``"amp"`` reaches the amplitude detector (K1's plain version on the
    CPU) with the JAX dispatcher's result; a short 8 kHz recording keeps
    the plain detector's per-sample loop small."""
    sr = 8000
    x = clicks(n_clicks=3, sr=sr, spacing=0.5, seed=7, channels=2)
    kw = dict(sr=sr, cooldown=200, hipass_freq=1000.0)
    ch, on, rel = pdet.detect_onsets(x, method="amp", device="cpu", **kw)
    jch, jon, jrel = jdet.detect_onsets(x, method="amp", **kw)
    assert len(on) >= 3
    np.testing.assert_array_equal(np.asarray(ch), np.asarray(jch))
    np.testing.assert_array_equal(np.asarray(on), np.asarray(jon))
