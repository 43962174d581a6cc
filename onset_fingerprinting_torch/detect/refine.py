"""Onset refinement by cross-correlation (port of
``onset_fingerprinting_tpu.detect.refine``; reference: detection.py:271-484
and multilateration.py:457-501).

The host functions (``adjust_onset_rel``, ``adjust_onset``,
``filter_data``, ``fix_onsets``, ``detect_onset_region``) are numpy and
scipy, as in the JAX package: the mining path's CC alignment of each hit's
onsets across channels.

The device functions keep the JAX names (``cc_refine_lag_jax``,
``cc_refine_adjust_jax``): fixed shapes, no host read, so the locator's
``cc_refine`` step stays capturable in a CUDA graph.  ``cc_refine_terms``
returns what ``cc_refine_adjust_jax`` decides from (the masked CC, its
argmax, the heuristic's energies), which the locate kernel's refinement
check compares with.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from scipy.ndimage import median_filter

from onset_fingerprinting_torch.ops.filters import median_filter_1d
from onset_fingerprinting_torch.ops.xcorr import (
    cross_correlation_lag,
    cross_correlation_lag_jax,
    masked_normalized_cc,
)


def _cc_section(window: torch.Tensor, pos0, lookaround: int) -> torch.Tensor:
    """The reference's section prep (multilateration.py:465-474): zero the
    audio before the seed, median filter, keep only downward motion,
    rectify.  ``[W, 2]`` → ``[W - 1, 2]``."""
    row = torch.arange(window.shape[0], device=window.device)[:, None]
    x = torch.where(row >= pos0 - lookaround, window.to(torch.float32), 0.0)
    x = median_filter_1d(x, 5)
    d = torch.diff(x, dim=0)
    return torch.abs(torch.where(d >= 0, 0.0, d))


def _in_bounds(window, pos0, pos1, lookaround):
    return (pos0 >= lookaround) & (pos1 > pos0) & (
        pos1 < window.shape[0] - 1)


def cc_refine_lag_jax(window: torch.Tensor, pos0: torch.Tensor,
                      pos1: torch.Tensor, lookaround: int = 60,
                      onset_tolerance: int = 50,
                      normalization_cutoff: int = 10):
    """Lag refinement of an onset pair over a fixed live-audio window
    ``[W, 2]`` (chronological; audio before ``pos0 - lookaround`` is
    zeroed, as the reference trims its section).  ``pos0``/``pos1`` are the
    window positions of the seed and the new onset.  Returns ``(refined
    lag pos1' − pos0, valid)``."""
    d = _cc_section(window, pos0, lookaround)
    lag, cc_valid = cross_correlation_lag_jax(
        d[:, 0], d[:, 1], torch.stack([pos0, pos1]),
        onset_tolerance=onset_tolerance,
        normalization_cutoff=normalization_cutoff)
    return lag, cc_valid & _in_bounds(window, pos0, pos1, lookaround)


class RefineTerms(NamedTuple):
    """What :func:`cc_refine_adjust_jax` decides from: the rectified
    section ``x``, ``y`` (``[W - 1]`` each), the masked, normalised CC
    ``cc`` and its normaliser ``norm`` (``[2W - 3]``), the CC's first
    argmax ``arg``, the shift ``ld`` it implies (the new lag less the old),
    the energies ``da``, ``db`` of the heuristic, and ``valid``."""
    x: torch.Tensor
    y: torch.Tensor
    cc: torch.Tensor
    norm: torch.Tensor
    arg: torch.Tensor
    ld: torch.Tensor
    da: torch.Tensor
    db: torch.Tensor
    valid: torch.Tensor


def cc_refine_terms(window: torch.Tensor, pos0: torch.Tensor,
                    pos1: torch.Tensor, lookaround: int = 60,
                    onset_tolerance: int = 50,
                    normalization_cutoff: int = 10) -> RefineTerms:
    """The terms of :func:`cc_refine_adjust_jax` over one pair's window
    ``[W, 2]``: the CC and the reference's energy heuristic
    (adjust_onset, detection.py:299-352), which weighs exponentially the
    rectified energy between each onset's old and CC-implied position.
    The shift is at most ``onset_tolerance`` (the CC search window), so
    the weights have a fixed length."""
    d = _cc_section(window, pos0, lookaround)
    x, y = d[:, 0], d[:, 1]
    cc, norm, cc_valid = masked_normalized_cc(
        x, y, pos1 - pos0, normalization_cutoff, onset_tolerance)
    arg = torch.argmax(cc)
    # the CC's index n - lag holds lag; |ld| <= onset_tolerance
    ld = (pos1 - pos0) - (x.shape[0] - arg).to(torch.int32)
    k = torch.arange(onset_tolerance + 1, device=window.device)
    n = torch.abs(ld)
    act = k < n
    denom = torch.clamp(n - 1, min=1).to(torch.float32)
    # the host adjust_onset: the x window weighted exp(linspace(0, -e, n))
    # descending from its start, the y window the same weights reversed.
    # Past n the ascending weights overflow to inf: selected away, not
    # multiplied by 0 (which gives NaN; XLA rewrites the JAX function's
    # product by the 0/1 mask into this select)
    w_desc = torch.where(act, torch.exp(-math.e * k / denom), 0.0)
    w_asc = torch.where(act, torch.exp(-math.e * (n - 1 - k) / denom), 0.0)
    sx = torch.minimum(pos0, pos0 + ld)
    sy = torch.minimum(pos1, pos1 - ld)
    last = x.shape[0] - 1
    xa = x[torch.clamp(sx + k, 0, last)]
    ya = y[torch.clamp(sy + k, 0, last)]
    da = torch.sum(xa * w_desc) / torch.clamp(torch.max(x), min=1e-20)
    db = torch.sum(ya * w_asc) / torch.clamp(torch.max(y), min=1e-20)
    return RefineTerms(x, y, cc, norm, arg, ld, da, db,
                       cc_valid & _in_bounds(window, pos0, pos1, lookaround))


def cc_refine_adjust_jax(window: torch.Tensor, pos0: torch.Tensor,
                         pos1: torch.Tensor, lookaround: int = 60,
                         onset_tolerance: int = 50,
                         normalization_cutoff: int = 10):
    """CC refinement plus the reference's energy heuristic
    (:func:`cc_refine_terms`): the onset of the pair with more energy
    between its old and CC-implied position moves to the CC lag.  Returns
    ``(c_seed, c_new, valid)``, the corrections to add to the seed and the
    new onset; one of them is 0."""
    t = cc_refine_terms(window, pos0, pos1, lookaround, onset_tolerance,
                        normalization_cutoff)
    move_seed = (t.da > t.db) & (pos0 + t.ld >= 0)
    c_seed = torch.where(move_seed, t.ld, 0).to(torch.int32)
    c_new = torch.where(move_seed, 0, -t.ld).to(torch.int32)
    return c_seed, c_new, t.valid


def adjust_onset_rel(onsets: list[int], relx: np.ndarray, rely: np.ndarray,
                     new_lag: int) -> tuple[int, int]:
    """Move whichever onset of a pair gains more relative-envelope height at
    the CC-suggested lag (detection.py:271-296).  Returns the new onsets."""
    oa, ob = onsets[0], onsets[1]
    lag_diff = (ob - oa) - new_lag
    da = relx[oa + lag_diff] - relx[oa]
    db = rely[ob - lag_diff] - rely[ob]
    if da > db:
        oa += lag_diff
    else:
        ob -= lag_diff
    return oa, ob


def adjust_onset(onsets: list[int], x: np.ndarray, y: np.ndarray,
                 new_lag: int) -> tuple[int, int]:
    """Which onset of a pair to move to a CC-suggested lag, by
    exponentially weighted signal energy between the old and new positions
    (detection.py:299-352).  Returns corrections ``(ca, cb)`` to add to the
    two onsets."""
    oa, ob = onsets[0], onsets[1]
    lag_diff = (ob - oa) - new_lag
    exp = np.exp(np.linspace(0, -np.e, abs(lag_diff)))
    n = len(x)
    if lag_diff < 0:
        x_start, x_end = max(oa + lag_diff, 0), min(oa, n)
        y_start, y_end = min(ob, n), min(ob - lag_diff, n)
    else:
        x_start, x_end = oa, min(oa + lag_diff, n)
        y_start, y_end = max(ob - lag_diff, 0), min(ob, n)
    da = np.sum(x[x_start:x_end] * exp[-(x_end - x_start):]) / x.max()
    if y_end == y_start:
        db = 0.0
    else:
        db = (np.sum(y[y_start:y_end] * exp[-(y_end - y_start):][::-1])
              / y.max())
    if da > db:
        if oa + lag_diff < 0:
            return 0, -lag_diff
        return lag_diff, 0
    return 0, -lag_diff


def filter_data(x: np.ndarray, direction: str) -> np.ndarray:
    """Null samples moving against the expected transient direction
    (detection.py:355-370)."""
    diff = np.diff(x, 1, axis=0, prepend=x[:1])
    if direction == "up":
        x[diff < 0] = 0
    elif direction == "down":
        x[diff > 0] = 0
    else:
        raise ValueError(f"Unknown onset direction {direction!r}")
    return x


def fix_onsets(
    audio: np.ndarray,
    onsets: np.ndarray,
    filter_size: int = 5,
    d: int = 0,
    onset_direction: Optional[str] = None,
    take_abs: bool = False,
    zero_left: bool = False,
    normalization_cutoff: int = 10,
    onset_tolerance: int = 30,
    shift_onsets: int = 0,
) -> np.ndarray:
    """Make per-hit onsets consistent across channels (detection.py:373-451).

    For each onset group: median-filter + optionally direction-null/abs a
    window around the group, then CC-align every channel against the earliest
    channel, moving whichever onset the energy heuristic prefers.
    """
    lookaround = normalization_cutoff + onset_tolerance
    onsets = onsets.copy() + shift_onsets
    for og in onsets:
        idx = np.argsort(og)
        a, b = og[idx[0]], og[idx[-1]]
        section = audio[a - lookaround : b + lookaround]
        section = np.diff(median_filter(section, filter_size, axes=0), d, axis=0)
        if onset_direction == "up":
            section[section < 0] = 0
        elif onset_direction == "down":
            section[section > 0] = 0
        if take_abs:
            section = np.abs(section)
        local = og - (a - lookaround)

        for i in idx[1:]:
            pair = [local[idx[0]], local[i]]
            x = section[:, idx[0]]
            y = section[:, i]
            if zero_left:
                x[: pair[0]] = 0.0
                y[: pair[1]] = 0.0
            new_lag = cross_correlation_lag(
                x,
                y,
                pair,
                normalization_cutoff=normalization_cutoff,
                onset_tolerance=onset_tolerance,
            )
            if new_lag is not None:
                ca, cb = adjust_onset(pair, x, y, new_lag)
                og[idx[0]] += ca
                og[i] += cb
                local[idx[0]] += ca
                local[i] += cb
    return onsets


def detect_onset_region(
    audio: np.ndarray,
    detected_onset: int,
    n: int = 256,
    median_filter_size: int = 5,
    threshold_factor: float = 0.5,
) -> int:
    """Find the start of the loud region around an onset
    (detection.py:454-484)."""
    from scipy.ndimage import binary_opening
    from scipy.signal import medfilt

    start_idx = max(detected_onset - n // 2, 0)
    end_idx = min(detected_onset + n // 2, len(audio))
    region = np.abs(audio[start_idx:end_idx])
    filtered = medfilt(region, kernel_size=median_filter_size)
    mask = filtered > threshold_factor * np.max(filtered)
    mask = binary_opening(mask, structure=np.ones(5))
    return start_idx + int(np.argmax(mask))
