"""Cross-correlation ops (port of the parts of
``onset_fingerprinting_tpu.ops.xcorr`` that the CCCNN head uses).

``batch_full_correlate`` is the rFFT form; ``batch_self_correlate_dft`` is
self-correlation as plain matrix products with constant DFT matrices (the
serving head's ``cc_impl='dft'``), and ``self_and_pair_correlate_dft`` adds
channel-pair cross-correlation on the same forward products (the
``cc_pairs`` head).

Both DFT heads take the JAX package's ``precision`` (xcorr.py:149-216
there), chosen per call:

- ``"highest"`` (the default): float32 operands, float32 products.  On
  the card a float32 ``torch.matmul`` is cuBLAS's, which runs in TF32
  wherever the process turned TF32 on (``torch.backends.cuda.matmul.
  allow_tf32``, ``torch.set_float32_matmul_precision("high")``): these
  functions leave that to their caller.  The CCCNN's float32 head runs
  its products and its dense layer under ``ops.conv_stack.
  exact_f32_matmul()``: full float32 whatever the process set.
- ``"default"``: the TPU's one-pass semantics.  Both operands of every
  product (the two forward transforms, the inverse of the power spectrum,
  the pair inverses) are rounded to bfloat16, the sums accumulate in
  float32 and the result is float32.  On the card that is one bf16 × bf16
  → f32 GEMM on the tensor cores (``torch.mm(..., out_dtype=float32)``);
  on the CPU its plain version rounds both operands to bfloat16 and back
  and multiplies in float32.  A bf16 CCCNN runs its head this way, as
  the JAX package's does (models/cccnn.py:479-497 there).

``batch_cross_correlate_dft`` is the cross twin of the self head (four
forward products, the complex cross spectrum, two inverse products).

The rest is what the locator needs: ``full_correlate`` and the lag
pickers, among them the contribution-normalised legal-lag picker
``cross_correlation_lag`` and its fixed-shape device twin
``cross_correlation_lag_jax`` (named after the JAX function it mirrors);
and the block-streaming cross-correlation ``StreamingCC``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from onset_fingerprinting_torch.device import resolve_device

#: the DFT heads' precisions (module docstring)
PRECISIONS = ("highest", "default")


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
    """``(dft_re, dft_im, inv_cos, inv_sin)`` on ``device``: normal tensors
    even when first asked for under ``inference_mode`` (an inference tensor
    in the cache could not be saved for a later backward)."""
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(m, device=device)
                     for m in (*_dft_matrices(n), _dft_inv_sin(n)))


def dft_matmul(a: torch.Tensor, m: torch.Tensor, precision: str = "highest"
               ) -> torch.Tensor:
    """``a [..., n] @ m [n, k]`` → float32 ``[..., k]`` at ``precision``
    (module docstring).  Differentiable: at ``"default"`` the backward is
    the two transposed products at the same one-pass bf16 precision, as
    JAX's vjp of a DEFAULT-precision dot is."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    if precision == "highest":
        return torch.matmul(a.to(torch.float32), m)
    out = _Bf16Matmul.apply(a.reshape(-1, a.shape[-1]), m)
    return out.reshape(*a.shape[:-1], m.shape[-1])


def _mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [n, k] @ b [k, m]`` with both operands rounded to bfloat16,
    summed in float32: one bf16 GEMM on the card, its emulation on the
    CPU."""
    bf = torch.bfloat16
    if a.device.type == "cpu":
        return torch.matmul(a.to(bf).to(torch.float32),
                            b.to(bf).to(torch.float32))
    return torch.mm(a.to(bf), b.to(bf), out_dtype=torch.float32)


class _Bf16Matmul(torch.autograd.Function):
    """:func:`_mm_bf16` with its vjp at the same precision."""

    @staticmethod
    def forward(ctx, a, m):
        ctx.save_for_backward(a, m)
        return _mm_bf16(a, m)

    @staticmethod
    def backward(ctx, g):
        a, m = ctx.saved_tensors
        ga = _mm_bf16(g, m.t()) if ctx.needs_input_grad[0] else None
        gm = _mm_bf16(a.t(), g) if ctx.needs_input_grad[1] else None
        return ga, gm


def batch_self_correlate_dft(a: torch.Tensor, sum_axis: int | None = None,
                             precision: str = "highest") -> torch.Tensor:
    """``batch_full_correlate(a, a)`` as two forward matrix products and one
    inverse (:func:`self_power_dft`, then :func:`self_cc_from_power`).
    ``sum_axis`` sums over that axis on the power spectrum, before the
    (linear) inverse — equal to summing the result, with K-fold less
    inverse work."""
    return self_cc_from_power(self_power_dft(a, sum_axis, precision),
                              a.shape[-1], precision)


def self_power_dft(a: torch.Tensor, sum_axis: int | None = None,
                   precision: str = "highest") -> torch.Tensor:
    """The power spectrum ``[..., F]`` of ``a [..., n]`` zero-padded to the
    DFT's length: the two forward products, summed over ``sum_axis``."""
    re_m, im_m, _, _ = _dft_tensors(a.shape[-1], a.device)
    re = dft_matmul(a, re_m, precision)
    im = dft_matmul(a, im_m, precision)
    power = re * re + im * im
    return power if sum_axis is None else power.sum(dim=sum_axis)


def self_cc_from_power(power: torch.Tensor, n: int,
                       precision: str = "highest") -> torch.Tensor:
    """The inverse product: a power spectrum of :func:`self_power_dft` over
    signals of ``n`` samples → their self-correlation ``[..., 2n-1]``."""
    _, _, inv, _ = _dft_tensors(n, power.device)
    return dft_matmul(power, inv, precision)


def self_and_pair_correlate_dft(feats: torch.Tensor, pi, pj,
                                precision: str = "highest"
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
    re = dft_matmul(feats, re_m, precision)  # [B, C, K, F]
    im = dft_matmul(feats, im_m, precision)
    self_cc = dft_matmul((re * re + im * im).sum(dim=2), inv_cos, precision)
    re_i, im_i = re[:, pi], im[:, pi]  # [B, P, K, F]
    re_j, im_j = re[:, pj], im[:, pj]
    cross_re = (re_i * re_j + im_i * im_j).sum(dim=2)  # [B, P, F]
    cross_im = (im_i * re_j - re_i * im_j).sum(dim=2)
    pair_cc = (dft_matmul(cross_re, inv_cos, precision)
               + dft_matmul(cross_im, inv_sin, precision))
    return self_cc, pair_cc


def batch_cross_correlate_dft(a: torch.Tensor, b: torch.Tensor,
                              precision: str = "highest",
                              sum_axis: int | None = None) -> torch.Tensor:
    """Batched cross-correlation ``batch_full_correlate(a, b)`` as matrix
    products (JAX xcorr.py:114): the cross spectrum ``F(a)·conj(F(b))`` is
    complex, so four forward products and two inverse ones (cosine on the
    real part, sine on the imaginary part).  ``precision`` and ``sum_axis``
    (summed before the inverse, by linearity) as the self head's; index
    ``n-1+l`` holds ``Σ_m a[m+l]·b[m]``."""
    dft_re, dft_im, inv_cos, inv_sin = _dft_tensors(a.shape[-1], a.device)
    a_re = dft_matmul(a, dft_re, precision)
    a_im = dft_matmul(a, dft_im, precision)
    b_re = dft_matmul(b, dft_re, precision)
    b_im = dft_matmul(b, dft_im, precision)
    cross_re = a_re * b_re + a_im * b_im
    cross_im = a_im * b_re - a_re * b_im
    if sum_axis is not None:
        cross_re = cross_re.sum(dim=sum_axis)
        cross_im = cross_im.sum(dim=sum_axis)
    return (dft_matmul(cross_re, inv_cos, precision)
            + dft_matmul(cross_im, inv_sin, precision))


def full_correlate(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``np.correlate(a, b, mode='full')`` for equal-length inputs (the
    rFFT form): index ``n-1`` is lag 0, index ``n-1+l`` is ``sum_m a[m+l]
    b[m]``."""
    return batch_full_correlate(a, b)


def find_lag(a, b) -> int:
    """The argmax lag between two signals (multilateration.py:878-887 of
    the reference)."""
    cc = full_correlate(torch.as_tensor(a, dtype=torch.float32),
                        torch.as_tensor(b, dtype=torch.float32))
    return int(torch.argmax(cc)) - (len(a) - 1)


def find_lag_jax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`find_lag` on the device, batched over leading axes, without a
    host read: int32 lags."""
    cc = batch_full_correlate(a, b)
    return (torch.argmax(cc, dim=-1) - (a.shape[-1] - 1)).to(torch.int32)


def find_lag_multi(a, b, top_n: int = 3):
    """The ``top_n`` CC peak lags and their squared heights
    (multilateration.py:890-899 of the reference)."""
    from scipy.signal import find_peaks

    cc = full_correlate(torch.as_tensor(a, dtype=torch.float32),
                        torch.as_tensor(b, dtype=torch.float32)).cpu().numpy()
    peaks, _ = find_peaks(cc)
    peaks = peaks[np.argsort(-cc[peaks])][:top_n]
    return peaks - len(a) + 1, cc[peaks] ** 2


def _contribution_normalizer(n: int, cutoff: int) -> np.ndarray:
    norm = np.arange(n) + 1.0
    norm[:cutoff] = cutoff
    return norm


def cross_correlation_lag(
    x: np.ndarray,
    y: np.ndarray,
    onsets: Optional[tuple[int, int]] = None,
    legal_lags: Optional[tuple[int, int]] = None,
    d: int = 0,
    normalization_cutoff: int = 10,
    onset_tolerance: int = 50,
    take_abs: bool = False,
) -> Optional[int]:
    """Host (numpy, float64) refined-lag picker (detection.py:195-268 of
    the reference): each CC lag is divided by its number of contributing
    samples, the lags are restricted to ``onsets`` ± ``onset_tolerance``
    or to ``legal_lags``, and the re-centred argmax lag comes back, or None
    when the window is empty."""
    x = np.diff(np.asarray(x, dtype=np.float64), d)
    y = np.diff(np.asarray(y, dtype=np.float64), d)
    if take_abs:
        x, y = np.abs(x), np.abs(y)
    n = len(x)
    cc = np.correlate(x, y, "full")
    norm = _contribution_normalizer(n, normalization_cutoff)
    cc[:n] /= norm
    cc[n:] /= norm[n - 2:: -1]
    if legal_lags is not None:
        cc = cc[n - legal_lags[1]: n - legal_lags[0]]
        max_adjust = legal_lags[1]
    elif onsets is not None:
        current_lag = onsets[1] - onsets[0]
        center = n - current_lag
        cc = cc[center - onset_tolerance: center + onset_tolerance]
        max_adjust = current_lag + onset_tolerance
    else:
        max_adjust = n - 1
    if len(cc) == 0:
        return None
    return -(int(np.argmax(cc)) - max_adjust)


def cross_correlation_lag_jax(
    x: torch.Tensor,
    y: torch.Tensor,
    onsets: torch.Tensor,
    d: int = 0,
    normalization_cutoff: int = 10,
    onset_tolerance: int = 50,
    take_abs: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape device twin of :func:`cross_correlation_lag` (no host
    read): ``onsets`` is an int ``[2]`` tensor; returns ``(lag int32,
    valid)``, ``valid`` False where the tolerance window leaves the CC's
    support (the host version's None)."""
    if d > 0:
        x = torch.diff(x, d)
        y = torch.diff(y, d)
    if take_abs:
        x, y = x.abs(), y.abs()
    masked, _, valid = masked_normalized_cc(
        x, y, onsets[1] - onsets[0], normalization_cutoff, onset_tolerance)
    # the full CC's index n - lag holds lag
    lag = x.shape[-1] - torch.argmax(masked)
    return lag.to(torch.int32), valid


def masked_normalized_cc(x: torch.Tensor, y: torch.Tensor,
                         current_lag: torch.Tensor,
                         normalization_cutoff: int = 10,
                         onset_tolerance: int = 50):
    """The contribution-normalised full CC of ``x`` and ``y`` (``[n]``
    each), ``-inf`` outside the ``2·onset_tolerance`` indices around
    ``current_lag``: what :func:`cross_correlation_lag_jax` takes the first
    argmax of.  Returns ``(masked [2n-1], normaliser [2n-1] float32,
    valid)``, ``valid`` False where the window leaves the CC's support."""
    n = x.shape[-1]
    cc = batch_full_correlate(x, y)
    norm = _contribution_normalizer(n, normalization_cutoff)
    full_norm = torch.as_tensor(
        np.concatenate([norm, norm[n - 2:: -1]]).astype(np.float32),
        device=cc.device)
    cc = cc / full_norm
    center = n - current_lag
    idx = torch.arange(2 * n - 1, device=cc.device)
    window = (idx >= center - onset_tolerance) & (
        idx < center + onset_tolerance)
    valid = (center - onset_tolerance >= 0) & (
        center + onset_tolerance <= 2 * n - 1)
    return torch.where(window, cc, -torch.inf), full_norm, valid


# ---------------------------------------------------------------------------
# Streaming cross-correlation (state batched over pairs)
# ---------------------------------------------------------------------------

class StreamingCC(NamedTuple):
    """Block-streaming full cross-correlation of the last ``n`` samples of
    two streams, any leading batch dims (JAX xcorr.py:332-340)."""

    buf_a: torch.Tensor  # [..., n]
    buf_b: torch.Tensor  # [..., n]


def streaming_cc_init(n: int, batch_shape: tuple = (), device=None
                      ) -> StreamingCC:
    """Zeroed windows on ``device`` (None = the card)."""
    z = torch.zeros(tuple(batch_shape) + (n,), dtype=torch.float32,
                    device=resolve_device(device))
    return StreamingCC(z, z)


def streaming_cc_update(state: StreamingCC, block_a: torch.Tensor,
                        block_b: torch.Tensor
                        ) -> tuple[StreamingCC, torch.Tensor]:
    """Shift in a ``[..., block]`` of new samples and return the full CC
    ``[..., 2n-1]`` over the current windows: an exact recompute every
    block (the reference's online_cc drifts, c/cross_corr.c:257-273)."""
    b = block_a.shape[-1]
    buf_a = torch.cat([state.buf_a[..., b:], block_a.to(torch.float32)], -1)
    buf_b = torch.cat([state.buf_b[..., b:], block_b.to(torch.float32)], -1)
    return StreamingCC(buf_a, buf_b), batch_full_correlate(buf_a, buf_b)


def streaming_cc_scan(state: StreamingCC, blocks_a: torch.Tensor,
                      blocks_b: torch.Tensor
                      ) -> tuple[StreamingCC, torch.Tensor]:
    """Many updates in turn: ``blocks_* [nb, ..., block]`` → ``(state, ccs
    [nb, ..., 2n-1])``, the reference harness's offline sweep
    (c/test.py:36-38)."""
    ccs = []
    for a, b in zip(blocks_a, blocks_b):
        state, cc = streaming_cc_update(state, a, b)
        ccs.append(cc)
    return state, torch.stack(ccs)
