"""Lag maps: the expected TDOA in samples between sensor pairs over a grid
of candidate strike points (port of ``onset_fingerprinting_tpu.locate.
geometry``; reference: multilateration.py:902-1101).

cm (``scale=1``) or mm (``scale=10``) grids over the drum, NaN outside the
tolerance-padded circle, computed in float32 with the JAX functions' order
of operations, so the maps equal theirs value for value.
"""

from __future__ import annotations

import numpy as np
import torch

from onset_fingerprinting_torch.core.coords import (
    DIAMETER,
    MEDIUM,
    speed_of_sound,
)


def _grid(r: int):
    """``meshgrid(arange(-r, r+1), arange(-r, r+1))`` in numpy's 'xy'
    order: ``i`` varies along columns, ``j`` along rows."""
    a = torch.arange(-r, r + 1)
    j, i = torch.meshgrid(a, a, indexing="ij")
    return i, j


def lag_map_2d(mic_a, mic_b, d: float = DIAMETER, sr: int = 96000,
               scale: float = 1, medium: str = MEDIUM, tol: float = 1,
               c: float | None = None) -> torch.Tensor:
    """Expected sample-lag map for a 2D sensor pair
    (multilateration.py:902-942): ``round((‖p − a‖ − ‖p − b‖) / c · sr)``,
    NaN outside the drum + ``tol`` cm."""
    if c is None:
        c = speed_of_sound(100 * scale, medium=medium)
    r = int(np.round(d * scale / 2))
    i, j = _grid(r)
    outside = i ** 2 + j ** 2 > (r + tol * scale) ** 2
    lag_a = torch.sqrt((i - mic_a[0]) ** 2 + (j - mic_a[1]) ** 2) / c
    lag_b = torch.sqrt((i - mic_b[0]) ** 2 + (j - mic_b[1]) ** 2) / c
    lag_map = torch.round((lag_a - lag_b) * sr).to(torch.float32)
    return torch.where(outside, torch.nan, lag_map)


def lag_map_3d(mic_a, mic_b, d: float = DIAMETER, sr: int = 96000,
               scale: float = 1, medium: str = MEDIUM, tol: float = 1,
               c: float | None = None) -> torch.Tensor:
    """Expected sample-lag map for 3D sensors over the z = 0 playing surface
    (multilateration.py:945-1001)."""
    if c is None:
        c = speed_of_sound(100 * scale, medium=medium)
    n = int(np.round(d, 1) * scale)
    r = n // 2
    i, j = _grid(r)
    outside = i ** 2 + j ** 2 > (r + tol * scale) ** 2
    lag_a = torch.sqrt(
        (i - mic_a[0]) ** 2 + (j - mic_a[1]) ** 2 + mic_a[2] ** 2) / c
    lag_b = torch.sqrt(
        (i - mic_b[0]) ** 2 + (j - mic_b[1]) ** 2 + mic_b[2] ** 2) / c
    lag_map = torch.round((lag_a - lag_b) * sr).to(torch.float32)
    return torch.where(outside, torch.nan, lag_map)


def attenuate_intensity(source_loc, mic_loc, reflectivity,
                        intensity_at_source):
    """Angle-dependent intensity attenuation from a surface source to a mic
    (multilateration.py:1018-1040), float32.  Returns ``(amplitude,
    angle°)``."""
    sx = torch.as_tensor(source_loc[0], dtype=torch.float32).reshape(-1)
    sy = torch.as_tensor(source_loc[1], dtype=torch.float32).reshape(-1)
    dx = mic_loc[0] - sx
    dy = mic_loc[1] - sy
    dz = torch.full_like(dx, float(mic_loc[2] - source_loc[2]))
    vec = torch.stack([dx, dy, dz], dim=-1).to(torch.float32)
    distance = torch.linalg.vector_norm(vec, dim=-1)
    unit = vec / torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    thetas = torch.arccos(unit @ torch.tensor([0.0, 0.0, 1.0]))
    amp = (intensity_at_source
           * (1 + reflectivity * (1 - torch.abs(torch.cos(thetas))))
           / distance)
    return amp, torch.rad2deg(thetas)


def lag_intensity_map(mic_a, mic_b, reflectivity: float = 0.5,
                      d: float = DIAMETER, sr: int = 96000, scale: float = 1,
                      medium: str = MEDIUM):
    """Lag map plus each mic's dB intensity map
    (multilateration.py:1043-1101)."""
    n = int(np.round(d, 1) * scale)
    r = n // 2
    i, j = _grid(r)
    c = speed_of_sound(100 * scale, medium=medium)

    def mic_db(mic):
        amp, _ = attenuate_intensity((i, j, 0.0), mic, reflectivity, 1.0)
        return 10 * torch.log10(amp.reshape(i.shape))

    lag_a = torch.sqrt(
        (i - mic_a[0]) ** 2 + (j - mic_a[1]) ** 2 + mic_a[2] ** 2) / c
    lag_b = torch.sqrt(
        (i - mic_b[0]) ** 2 + (j - mic_b[1]) ** 2 + mic_b[2] ** 2) / c
    lag_difference = torch.round((lag_a - lag_b) * sr)
    return (lag_difference.to(torch.float32),
            mic_db(mic_a).to(torch.float32), mic_db(mic_b).to(torch.float32))
