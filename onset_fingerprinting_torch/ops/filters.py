"""Stateful IIR filters, the EMA smoother and the sliding-window filters
(port of ``onset_fingerprinting_tpu.ops.filters``).

Filter design stays on the host (scipy) with float32 coefficients, like the
reference's ``ButterworthFilter`` (detection.py:492-497); the application is
a direct-form-II-transposed loop over samples equal to
``scipy.signal.lfilter(b, a, x, axis=0, zi=zi)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy import signal as _sig


class IIRState(NamedTuple):
    b: torch.Tensor  # [order + 1] numerator
    a: torch.Tensor  # [order + 1] denominator (a[0] == 1)
    zi: torch.Tensor  # [order, C] carried filter state


def butterworth(
    cutoff: float,
    n_channels: int,
    order: int = 2,
    sr: int = 44100,
    btype: str = "high",
    device=None,
) -> IIRState:
    """Design a Butterworth filter on the host, zero initial state."""
    b, a = _sig.butter(order, cutoff, btype=btype, analog=False, output="ba",
                       fs=sr)
    return IIRState(
        torch.as_tensor(np.float32(b), device=device),
        torch.as_tensor(np.float32(a), device=device),
        torch.zeros((order, n_channels), dtype=torch.float32, device=device),
    )


def iir_apply(state: IIRState, x: torch.Tensor
              ) -> tuple[torch.Tensor, IIRState]:
    """Apply the IIR filter along axis 0 of ``x [T, C]``, carrying state:

        y[t]   = b0 x[t] + z0[t-1]
        z_i[t] = b_{i+1} x[t] + z_{i+1}[t-1] - a_{i+1} y[t]
    """
    b, a, zi = state
    order = zi.shape[0]
    bl = [float(v) for v in b.cpu()]
    al = [float(v) for v in a.cpu()]
    z = list(zi.to(torch.float32).unbind(0))
    x = x.to(torch.float32)
    ys = []
    for xt in x.unbind(0):
        y = bl[0] * xt + z[0]
        z = [
            (bl[i + 1] * xt + z[i + 1] if i + 1 < order else bl[i + 1] * xt)
            - al[i + 1] * y
            for i in range(order)
        ]
        ys.append(y)
    y = torch.stack(ys) if ys else x.clone()
    return y, IIRState(b, a, torch.stack(z) if z else zi)


def ema_smooth(x: torch.Tensor, alpha: float, y0: torch.Tensor
               ) -> torch.Tensor:
    """Exponential moving average along axis 0, float32 (used by onset
    backtracking, detection.py:722-724 of the reference): one step per
    sample, vectorised over the other axes."""
    alpha = float(np.float32(alpha))
    beta = float(np.float32(1) - np.float32(alpha))
    x = x.to(torch.float32)
    y = y0.to(torch.float32)
    ys = torch.empty_like(x)
    for t in range(x.shape[0]):
        y = torch.add(alpha * x[t], beta * y, out=ys[t])
    return ys


def _sliding_windows(x: torch.Tensor, size: int) -> torch.Tensor:
    """``[T, ...] → [T, size, ...]`` edge-replicated centred windows (a
    view of the padded signal)."""
    pad_l = size // 2
    pad_r = size - 1 - pad_l
    xp = torch.cat([x[:1].expand(pad_l, *x.shape[1:]), x,
                    x[-1:].expand(pad_r, *x.shape[1:])])
    return xp.unfold(0, size, 1).movedim(-1, 1)


def sliding_mean(x: torch.Tensor, size: int) -> torch.Tensor:
    """Centred sliding mean along axis 0, edge-replicated."""
    return _sliding_windows(x, size).mean(dim=1)


def binary_opening_1d(x: torch.Tensor, size: int) -> torch.Tensor:
    """1-D binary opening (erosion then dilation) with an all-ones
    structure, borders False (scipy.ndimage.binary_opening, detection.py:482
    of the reference)."""
    pad = (size // 2, size - 1 - size // 2)
    xe = torch.nn.functional.pad(x.to(torch.bool).to(torch.uint8), pad)
    eroded = xe.unfold(0, size, 1).amin(dim=-1)
    ed = torch.nn.functional.pad(eroded, pad)
    return ed.unfold(0, size, 1).amax(dim=-1).to(torch.bool)


def median_filter_1d(x: torch.Tensor, size: int) -> torch.Tensor:
    """Median filter along axis 0, edge-replicated (scipy.ndimage.
    median_filter with mode='nearest', detection.py:421 of the reference);
    an even ``size`` averages the two middle values, as ``jnp.median``."""
    w = torch.sort(_sliding_windows(x, size), dim=1).values
    mid = size // 2
    if size % 2:
        return w[:, mid]
    return (w[:, mid - 1] + w[:, mid]) / 2


def sliding_max(x: torch.Tensor, size: int) -> torch.Tensor:
    """Centred sliding maximum along axis 0, edge-replicated
    (``maximum_filter1d``, detection.py:875 of the reference)."""
    return _sliding_windows(x, size).amax(dim=1)
