"""Attack/release envelope followers and EMA min/max trackers (port of
``onset_fingerprinting_tpu.ops.envelope``; reference:
envelope_follower.c:6-57, ctypes wrappers detection.py:504-592).

- AR envelope: a one-pole smoother whose coefficient switches between
  ``attack`` and ``release`` on the sign of ``x - y + 1e-10``
  (envelope_follower.c:17-22).  The coefficients are the reciprocals of the
  nominal times (an attack of 3 → 1/3), as the reference passes them.
- Min/max tracker: a running min/max that decays exponentially toward the
  signal, with a hard floor ``minmin`` on the minimum
  (envelope_follower.c:40-52).

All take ``[T, C]`` blocks with carried ``[C]`` state, float32, one step per
sample vectorised over channels (the JAX package's ``lax.scan``).  The
fused detector (K1) computes these inside its kernel; these are the
stand-alone forms.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from onset_fingerprinting_torch.device import resolve_device

_F32 = torch.float32


def ar_envelope(x: torch.Tensor, y0: torch.Tensor, attack: float,
                release: float) -> torch.Tensor:
    """The AR envelope over ``x [T, C]`` from the state ``y0 [C]``: ``[T,
    C]``; its last row is the next block's ``y0``."""
    attack = float(np.float32(attack))
    release = float(np.float32(release))
    eps = float(np.float32(1e-10))
    x = x.to(_F32)
    y = y0.to(_F32)
    ys = torch.empty_like(x)
    for t in range(x.shape[0]):
        diff = x[t] - y + eps
        coef = torch.where(diff > 0, attack, release)
        y = torch.addcmul(y, coef, diff, out=ys[t])
    return ys


def ar_envelope_block(x: torch.Tensor, y_prev: torch.Tensor, attack: float,
                      release: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-streaming form: ``(envelope [T, C], new_state [C])``."""
    ys = ar_envelope(x, y_prev, attack, release)
    return ys, ys[-1]


class MinMaxState(NamedTuple):
    """Per-channel running min/max (envelope_follower.c:27-57)."""

    min_val: torch.Tensor  # [C]
    max_val: torch.Tensor  # [C]


def minmax_init(n_channels: int, min0: float = 0.0, max0: float = 10.0,
                device=None) -> MinMaxState:
    """The initial tracker state on ``device`` (None = the card); defaults
    as detection.py:703-708 of the reference."""
    dev = resolve_device(device)
    return MinMaxState(torch.full((n_channels,), min0, dtype=_F32, device=dev),
                       torch.full((n_channels,), max0, dtype=_F32, device=dev))


def minmax_envelope(x: torch.Tensor, state: MinMaxState,
                    alpha_min: float = 1e-4, alpha_max: float = 1e-5,
                    minmin: float = 0.0) -> MinMaxState:
    """The tracker over a ``[T, C]`` block: the post-block state (the
    reference kernel exposes only the final values)."""
    am = np.float32(alpha_min)
    ax = np.float32(alpha_max)
    iam, iax = float(np.float32(1) - am), float(np.float32(1) - ax)
    am, ax, mm = float(am), float(ax), float(np.float32(minmin))
    x = x.to(_F32)
    mn, mx = state.min_val, state.max_val
    for t in range(x.shape[0]):
        xt = x[t]
        mn = torch.where(xt < mm, mm,
                         torch.where(xt < mn, xt, mn * iam + xt * am))
        mx = torch.where(xt > mx, xt, mx * iax + xt * ax)
    return MinMaxState(mn, mx)
