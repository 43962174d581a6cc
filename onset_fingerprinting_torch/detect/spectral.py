"""Spectral (STFT-flux) onset detection (port of
``onset_fingerprinting_tpu.detect.spectral``).

The reference's librosa-based offline detector (reference:
detection.py:89-128): A-weighted magnitude STFT → positive spectral flux →
percentile normalisation → peak picking.  The STFT and the flux run on the
device (cuFFT on the card); the percentile and the peak pick are a host
pass over the 1-D flux, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from onset_fingerprinting_torch.device import resolve_device
from onset_fingerprinting_torch.ops.stft import (
    a_weighting,
    spectral_flux,
    stft,
)


def peak_pick(x: np.ndarray, pre_max: int, post_max: int, pre_avg: int,
              post_avg: int, delta: float, wait: int) -> np.ndarray:
    """librosa.util.peak_pick-compatible greedy peak selection.

    ``x[n]`` is a peak iff it is nonzero, equals ``max(x[n-pre_max :
    n+post_max])``, is at least ``mean(x[n-pre_avg : n+post_avg]) + delta``,
    and follows the last reported peak by more than ``wait`` samples.  The
    nonzero condition is librosa's (its candidates are ``x * (x ==
    mov_max)`` read through ``np.nonzero``), so silence at the array edges
    neither reports nor advances the ``wait`` chain.
    """
    x = np.asarray(x, dtype=np.float64)
    n = len(x)
    pre_max, post_max = int(pre_max), int(post_max)
    pre_avg, post_avg = int(pre_avg), int(post_avg)
    peaks = []
    last = -1 - wait
    for i in range(n):
        if x[i] == 0.0 or i <= last + wait:
            continue
        lo = max(0, i - pre_max)
        hi = min(n, i + post_max)
        if hi <= lo or x[i] < np.max(x[lo:hi]):
            continue
        lo = max(0, i - pre_avg)
        hi = min(n, i + post_avg)
        if x[i] < np.mean(x[lo:hi]) + delta:
            continue
        peaks.append(i)
        last = i
    return np.asarray(peaks, dtype=np.int64)


def spectral_flux_envelope(x: torch.Tensor, n_fft: int = 256, hop: int = 32,
                           sr: int = 96000) -> torch.Tensor:
    """The A-weighted positive spectral flux of ``x [N]`` on its device,
    before normalisation: ``[frames - 1]``."""
    D = stft(x, n_fft=n_fft, hop_length=hop).abs()
    aw = a_weighting(np.fft.rfftfreq(n_fft, 1.0 / sr))[:, None]
    scale = ((aw - aw.min()) / np.abs(aw.min())).astype(np.float32)
    return spectral_flux(D * torch.as_tensor(scale, device=x.device))


def detect_onsets_spectral(x: np.ndarray, n_fft: int = 256, hop: int = 32,
                           sr: int = 96000, return_oe: bool = False,
                           device=None):
    """A-weighted spectral-flux onset detector (detection.py:89-128 of the
    reference), the STFT and flux on ``device`` (None = the card).

    Returns onset sample indices (peak frame × hop); with ``return_oe`` also
    the normalised flux envelope (float64 numpy).
    """
    xt = torch.as_tensor(np.asarray(x, np.float32),
                         device=resolve_device(device))
    oe = spectral_flux_envelope(xt, n_fft, hop, sr).cpu().numpy()
    oe = oe.astype(np.float64)
    oe /= np.percentile(oe, 99.9)
    peaks = peak_pick(
        oe,
        pre_max=0.12 * sr // hop,
        post_max=0.01 * sr // hop,
        pre_avg=0.12 * sr // hop,
        post_avg=0.01 * sr // hop + 1,
        delta=0.1,
        wait=sr * 0.07 // hop,
    )
    peaks = peaks * hop
    return (peaks, oe) if return_oe else peaks
