"""The port's spectral ops (``onset_fingerprinting_torch.ops.stft``) against
the JAX package's on the same numpy inputs, on the CPU.  Bar: within 1e-5 of
the JAX result's scale (max |JAX|); ``power_to_db`` within 1e-4 dB; the
float64 numpy helpers equal."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the JAX package's ops/__init__ exports a function named stft
J = importlib.import_module("onset_fingerprinting_tpu.ops.stft")
P = importlib.import_module("onset_fingerprinting_torch.ops.stft")


def close(port, ref, rel=1e-5):
    port = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(port - ref).max())
    assert err <= rel * scale, (err, scale)


def signal(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 0.3, shape).astype(
        np.float32)


@pytest.mark.parametrize("n,fftbins", [(256, True), (255, False),
                                       (64, True)])
def test_hann(n, fftbins):
    close(P.hann(n, fftbins), J.hann(n, fftbins))


def test_frame_and_pad_center():
    x = signal((3, 1000))
    np.testing.assert_array_equal(P.frame(torch.tensor(x), 128, 32).numpy(),
                                  np.asarray(J.frame(jnp.asarray(x), 128, 32)))
    np.testing.assert_array_equal(
        P._pad_center(torch.tensor(x[:, :100]), 131).numpy(),
        np.asarray(J._pad_center(jnp.asarray(x[:, :100]), 131)))


@pytest.mark.parametrize("n_fft,hop,center", [(256, 32, True),
                                              (128, 64, False),
                                              (512, 100, True)])
def test_stft(n_fft, hop, center):
    x = signal((2, 3, 4000), seed=n_fft)
    port = P.stft(torch.tensor(x), n_fft, hop, center)
    ref = J.stft(jnp.asarray(x), n_fft, hop, center)
    assert port.dtype == torch.complex64
    close(port, ref)


def test_stft_custom_window():
    x = signal(3000, seed=3)
    w = np.hanning(200).astype(np.float32)
    w = np.pad(w, 28)
    close(P.stft(torch.tensor(x), 256, 32, window=torch.tensor(w)),
          J.stft(jnp.asarray(x), 256, 32, window=jnp.asarray(w)))


@pytest.mark.parametrize("method", ["zerozero", "prezero", "pre"])
@pytest.mark.parametrize("hop_edge_padding", [False, True])
@pytest.mark.parametrize("n_fft,onset", [(512, 160), (256, 40)])
def test_onset_stft(method, hop_edge_padding, n_fft, onset):
    x = signal((5, 1200), seed=onset)
    kw = dict(frame_length=256, hop_length=64, n_fft=n_fft,
              hop_edge_padding=hop_edge_padding, method=method)
    close(P.onset_stft(torch.tensor(x), onset, **kw),
          J.onset_stft(jnp.asarray(x), onset, **kw))


def test_onset_stft_unknown_method():
    with pytest.raises(ValueError, match="unknown padding"):
        P.onset_stft(torch.zeros(600), 10, method="both")


@pytest.mark.parametrize("hop_edge_padding", [False, True])
def test_window_contribution_weights(hop_edge_padding):
    w = np.hanning(256)
    np.testing.assert_array_equal(
        P.window_contribution_weights(w, 64, hop_edge_padding),
        J.window_contribution_weights(w, 64, hop_edge_padding))


def test_mel_helpers_equal():
    f = np.array([0.0, 50.0, 999.0, 1000.0, 4000.0, 48000.0])
    np.testing.assert_array_equal(P.hz_to_mel(f), J.hz_to_mel(f))
    m = np.linspace(0, 80, 17)
    np.testing.assert_array_equal(P.mel_to_hz(m), J.mel_to_hz(m))
    for args in ((96000, 512, 40), (44100, 256, 20, 100.0, 8000.0)):
        np.testing.assert_array_equal(P.mel_filterbank(*args),
                                      J.mel_filterbank(*args))
    np.testing.assert_array_equal(P.dct_ii_ortho(14, 40),
                                  J.dct_ii_ortho(14, 40))
    freqs = np.fft.rfftfreq(256, 1 / 96000)
    np.testing.assert_array_equal(P.a_weighting(freqs), J.a_weighting(freqs))
    np.testing.assert_array_equal(P.a_weighting(freqs, None),
                                  J.a_weighting(freqs, None))


def test_power_to_db_takes_the_batch_max():
    """``top_db`` clamps against the maximum over the whole batch: the quiet
    row's floor is the loud row's max - 80 dB, not its own."""
    rng = np.random.default_rng(1)
    S = (rng.random((3, 20, 30)) ** 4).astype(np.float32)
    S[1] *= 1e-9
    S[2, 0, 0] = 0.0
    port = P.power_to_db(torch.tensor(S)).numpy()
    ref = np.asarray(J.power_to_db(jnp.asarray(S)))
    assert np.abs(port - ref).max() <= 1e-4
    assert port[1].max() == pytest.approx(port.max() - 80.0, abs=1e-4)
    for kw in (dict(ref=2.0, top_db=None), dict(amin=1e-6, top_db=40.0)):
        np.testing.assert_allclose(P.power_to_db(torch.tensor(S), **kw),
                                   J.power_to_db(jnp.asarray(S), **kw),
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("kw", [dict(), dict(n_mels=20, n_mfcc=10,
                                             fmin=50.0, fmax=20000.0)])
def test_cspec_to_mfcc(kw):
    x = signal((4, 2048), seed=5)
    spec = J.onset_stft(jnp.asarray(x), 16, 256, 64, 512)
    port = P.cspec_to_mfcc(torch.tensor(np.asarray(spec)), sr=96000, **kw)
    close(port, J.cspec_to_mfcc(spec, sr=96000, **kw))


def test_spectral_flux():
    mag = np.abs(signal((2, 129, 50), seed=7))
    close(P.spectral_flux(torch.tensor(mag)),
          J.spectral_flux(jnp.asarray(mag)))
