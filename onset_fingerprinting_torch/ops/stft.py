"""Spectral ops: STFT, mel/MFCC features, A-weighting, spectral flux (port of
``onset_fingerprinting_tpu.ops.stft``, JAX stft.py:15-211).

The reference computes these with librosa (reference: detection.py:89-128,
the spectral detector; data.py:562-681, the onset-anchored STFT and MFCC).
The JAX package computes the FFT with XLA's FFT, not in Pallas; here it is
``torch.fft.rfft`` (cuFFT on the card).  The STFT frames a reflect-padded
signal itself and applies a periodic Hann window, as the JAX package does,
rather than calling ``torch.stft``.  The mel filterbank (Slaney scale and
norm), the orthonormal DCT-II and the A-weighting are float64 numpy helpers
cast once to float32, copies of the JAX package's.  Tensors stay on the
device they come on.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def hann(n: int, fftbins: bool = True, device=None) -> torch.Tensor:
    """Periodic (fftbins) or symmetric Hann window, float32."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(2 * math.pi * i / (n if fftbins else n - 1))


def frame(x: torch.Tensor, frame_length: int, hop_length: int
          ) -> torch.Tensor:
    """``[..., N] → [..., n_frames, frame_length]`` sliding frames."""
    return x.unfold(-1, frame_length, hop_length)


def _pad_center(x: torch.Tensor, size: int) -> torch.Tensor:
    n = x.shape[-1]
    left = (size - n) // 2
    return F.pad(x, (left, size - n - left))


def _rfft_frames(frames: torch.Tensor, window: torch.Tensor, n_fft: int
                 ) -> torch.Tensor:
    """Windowed frames ``[..., frames, n] → [..., bins, frames]``."""
    return torch.fft.rfft(frames * window, n=n_fft, dim=-1).transpose(-2, -1)


def stft(x: torch.Tensor, n_fft: int = 256, hop_length: int = 32,
         center: bool = True, window: torch.Tensor | None = None
         ) -> torch.Tensor:
    """Librosa-style complex STFT: ``[..., N] → [..., bins, frames]``."""
    if window is None:
        window = hann(n_fft, device=x.device)
    if center:
        lead = x.shape[:-1]
        x = F.pad(x.reshape(-1, x.shape[-1]), (n_fft // 2, n_fft // 2),
                  mode="reflect").reshape(*lead, -1)
    return _rfft_frames(frame(x, n_fft, hop_length), window, n_fft)


def onset_stft(audio: torch.Tensor, onset: int, frame_length: int = 256,
               hop_length: int = 64, n_fft: int = 512,
               hop_edge_padding: bool = False, method: str = "zerozero"
               ) -> torch.Tensor:
    """Onset-anchored STFT with three padding policies (data.py:593-654 of
    the reference).

    ``method``:
      - 'zerozero': zero-pad both sides of the onset window,
      - 'prezero': real preceding audio in front, zeros behind,
      - 'pre':     real preceding audio in front, no back padding.
    """
    y = audio[..., onset:onset + frame_length]
    pad_length = (frame_length - hop_length if hop_edge_padding
                  else frame_length // 2)
    window = hann(frame_length, device=audio.device)
    if n_fft > frame_length:
        window = _pad_center(window, n_fft)
    zeros = y.new_zeros(y.shape[:-1] + (pad_length,))
    pre = audio[..., max(onset - pad_length, 0):onset]
    if method == "zerozero":
        y = torch.cat([zeros, y, zeros], dim=-1)
    elif method == "prezero":
        y = torch.cat([pre, y, zeros], dim=-1)
    elif method == "pre":
        y = torch.cat([pre, y], dim=-1)
    else:
        raise ValueError(f"unknown padding method {method}")
    frames = frame(y, frame_length, hop_length)
    if n_fft > frame_length:
        frames = _pad_center(frames, n_fft)
    return _rfft_frames(frames, window, n_fft)


def _trapezoid(y: np.ndarray) -> float:
    # numpy >= 2 names it trapezoid; older numpy only trapz
    fn = getattr(np, "trapezoid", None) or np.trapz
    return float(fn(y))


def window_contribution_weights(window: np.ndarray, hop_length: int,
                                hop_edge_padding: bool = False
                                ) -> np.ndarray:
    """Per-frame weights ∝ how much of the signal of interest contributed to
    each STFT frame given windowing (data.py:562-578 of the reference)."""
    window = np.asarray(window)
    w = []
    start_idx = len(window) // 2 if not hop_edge_padding else hop_length
    for i in range(start_idx, len(window) + hop_length, hop_length):
        w.append(_trapezoid(window[:i]))
    w += w[-2::-1]
    return np.array(w) / max(w)


# ---------------------------------------------------------------------------
# Mel / MFCC (librosa-compatible: Slaney mel scale + norm, DCT-II ortho)
# ---------------------------------------------------------------------------

def hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz,
        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
        mels)


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 40, fmin: float = 0.0,
                   fmax=None) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank ``[n_mels, 1 +
    n_fft//2]``."""
    if fmax is None:
        fmax = sr / 2
    fftfreqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                    n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def power_to_db(S: torch.Tensor, ref: float = 1.0, amin: float = 1e-10,
                top_db: float = 80.0) -> torch.Tensor:
    """Power to dB.  The ``top_db`` floor is taken from the maximum over the
    whole tensor, batch included, as librosa and the JAX package do."""
    log_spec = 10.0 * torch.log10(torch.clamp_min(S, amin))
    log_spec = log_spec - float(10.0 * np.log10(np.float32(max(amin, ref))))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def dct_ii_ortho(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II matrix ``[n_out, n_in]``."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    basis = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))
    basis *= np.sqrt(2.0 / n_in)
    basis[0] *= 1.0 / np.sqrt(2.0)
    return basis.astype(np.float32)


def cspec_to_mfcc(S: torch.Tensor, sr: int, fmin: float = 0.0, fmax=None,
                  n_mels: int = 40, n_mfcc: int = 14) -> torch.Tensor:
    """Complex spectrogram ``[..., bins, frames]`` → MFCCs ``[..., n_mfcc,
    frames]`` (data.py:657-680 of the reference)."""
    n_fft = 2 * (S.shape[-2] - 1)
    mel_fb = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels, fmin, fmax),
                             device=S.device)
    power = S.abs() ** 2
    db = power_to_db(torch.einsum("mf,...ft->...mt", mel_fb, power))
    dct = torch.as_tensor(dct_ii_ortho(n_mfcc, n_mels), device=S.device)
    return torch.einsum("km,...mt->...kt", dct, db)


def a_weighting(frequencies: np.ndarray, min_db: float = -80.0
                ) -> np.ndarray:
    """IEC 61672 A-weighting in dB (librosa.A_weighting equivalent, used by
    the spectral detector at detection.py:105 of the reference)."""
    f = np.asarray(frequencies, dtype=np.float64)
    f_sq = f**2
    const = np.array([12194.217, 20.598997, 107.65265, 737.86223]) ** 2
    num = const[0] * f_sq**2
    den = ((f_sq + const[0]) * (f_sq + const[1])
           * np.sqrt((f_sq + const[2]) * (f_sq + const[3])))
    weights = 2.0 + 20.0 * (np.log10(np.maximum(num, 1e-30))
                            - np.log10(np.maximum(den, 1e-30)))
    if min_db is not None:
        weights = np.maximum(min_db, weights)
    return weights


def spectral_flux(mag: torch.Tensor) -> torch.Tensor:
    """Positive first-difference flux over frames: ``[..., bins, frames] →
    [..., frames-1]``, the mean across bins (detection.py:108-110 of the
    reference)."""
    d = mag[..., :, 1:] - mag[..., :, :-1]
    return torch.clamp_min(d, 0.0).mean(dim=-2)
