"""Cross-correlation ops (port of the parts of
``onset_fingerprinting_tpu.ops.xcorr`` that the CCCNN head uses).

``batch_full_correlate`` is the rFFT form; ``batch_self_correlate_dft`` is
self-correlation as plain matrix products with constant DFT matrices (the
serving head's ``cc_impl='dft'``), and ``self_and_pair_correlate_dft`` adds
channel-pair cross-correlation on the same forward products (the
``cc_pairs`` head).  The products are ``torch.matmul`` in
float32: PyTorch's default (``torch.backends.cuda.matmul.allow_tf32`` is
False) keeps them full float32 on the card, no TF32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _fft_len(n: int) -> int:
    l = 1
    while l < 2 * n - 1:
        l *= 2
    return l


def batch_full_correlate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched full CC over the last axis via rFFT: ``[..., n] × [..., n] →
    [..., 2n-1]``; index ``n-1+l`` is ``sum_m a[m+l] b[m]``
    (``np.correlate(mode='full')`` order)."""
    n = a.shape[-1]
    L = _fft_len(n)
    fa = torch.fft.rfft(a, n=L)
    fb = torch.fft.rfft(b, n=L)
    r = torch.fft.irfft(fa * torch.conj(fb), n=L)
    return torch.cat([r[..., L - (n - 1):], r[..., :n]], dim=-1)


def _dft_matrices(n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Forward cos/−sin matrices ``[n, F]`` (only the first n rows: a
    zero-padded signal reads no others) and the cosine inverse ``[F,
    2n-1]`` with columns pre-permuted to full-CC lag order.  ``L`` is the
    smallest multiple of 16 that is ≥ 2n-1."""
    L = ((2 * n - 1 + 15) // 16) * 16
    f = L // 2 + 1
    ang = 2.0 * np.pi * np.outer(np.arange(n), np.arange(f)) / L
    dft_re = np.cos(ang).astype(np.float32)
    dft_im = (-np.sin(ang)).astype(np.float32)
    w = np.full(f, 2.0, np.float32)
    w[0] = 1.0
    if L % 2 == 0:
        w[-1] = 1.0
    j = (np.arange(2 * n - 1) + L - (n - 1)) % L
    inv = (
        np.cos(2.0 * np.pi * np.outer(np.arange(f), j) / L) * w[:, None] / L
    ).astype(np.float32)
    return dft_re, dft_im, inv


def _dft_inv_sin(n: int) -> np.ndarray:
    """Sine inverse ``[F, 2n-1]`` for CROSS-correlation by DFT (the cross
    spectrum is complex), columns in full-CC lag order."""
    L = ((2 * n - 1 + 15) // 16) * 16
    f = L // 2 + 1
    w = np.full(f, 2.0, np.float32)
    w[0] = 1.0
    if L % 2 == 0:
        w[-1] = 1.0
    j = (np.arange(2 * n - 1) + L - (n - 1)) % L
    return (
        -np.sin(2.0 * np.pi * np.outer(np.arange(f), j) / L) * w[:, None] / L
    ).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_tensors(n: int, device: torch.device):
    """``(dft_re, dft_im, inv_cos, inv_sin)`` on ``device``."""
    return tuple(torch.as_tensor(m, device=device)
                 for m in (*_dft_matrices(n), _dft_inv_sin(n)))


def batch_self_correlate_dft(a: torch.Tensor, sum_axis: int | None = None
                             ) -> torch.Tensor:
    """``batch_full_correlate(a, a)`` as two forward matrix products and one
    inverse.  ``sum_axis`` sums over that axis on the power spectrum,
    before the (linear) inverse — equal to summing the result, with
    K-fold less inverse work."""
    re_m, im_m, inv, _ = _dft_tensors(a.shape[-1], a.device)
    re = torch.matmul(a, re_m)
    im = torch.matmul(a, im_m)
    power = re * re + im * im
    if sum_axis is not None:
        power = power.sum(dim=sum_axis)
    return torch.matmul(power, inv)


def self_and_pair_correlate_dft(feats: torch.Tensor, pi, pj
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel self-CC plus channel-pair cross-CC, sharing one set of
    forward DFT products (xcorr.py:149-178 of the JAX package).

    :param feats: ``[B, C, K, V]`` per-channel feature maps
    :param pi, pj: ``[P]`` channel indices of each pair
    :returns: ``(self_cc [B, C, 2V-1], pair_cc [B, P, 2V-1])``, both summed
        over the K maps on the spectrum, before the inverse.  Pair index
        ``V-1+l`` holds ``sum_m feats[:, pi][..., m+l] feats[:, pj][..., m]``.
    """
    re_m, im_m, inv_cos, inv_sin = _dft_tensors(feats.shape[-1],
                                                feats.device)
    re = torch.matmul(feats, re_m)  # [B, C, K, F]
    im = torch.matmul(feats, im_m)
    self_cc = torch.matmul((re * re + im * im).sum(dim=2), inv_cos)
    re_i, im_i = re[:, pi], im[:, pi]  # [B, P, K, F]
    re_j, im_j = re[:, pj], im[:, pj]
    cross_re = (re_i * re_j + im_i * im_j).sum(dim=2)  # [B, P, F]
    cross_im = (im_i * re_j - re_i * im_j).sum(dim=2)
    pair_cc = (torch.matmul(cross_re, inv_cos)
               + torch.matmul(cross_im, inv_sin))
    return self_cc, pair_cc
