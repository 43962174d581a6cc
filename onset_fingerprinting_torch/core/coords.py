"""Coordinate transforms and the sound-propagation medium model (port of
``onset_fingerprinting_tpu.core.coords``; reference:
onset_fingerprinting/multilateration.py:10-157).

The JAX functions compute in float32 on Python floats and arrays alike;
these do the same on float32 tensors, so that the sensor positions and lag
maps built from them carry the same float32 values.  Python floats and
numpy arrays come in as float32 tensors; tensors keep their dtype.

- 2D polar: ``phi`` in degrees, counter-clockwise from East (+x), wrapped
  to ``[0, 360)``.
- 3D spherical, the reference's drum-centric convention
  (multilateration.py:92-95, 119-122): ``theta >= 0`` is elevation above
  the x-y plane (inclination ``90 - theta``); a negative theta is the
  inclination itself.
"""

from __future__ import annotations

import math

import torch

TEMPERATURE = 20.0
HUMIDITY = 0.5
#: 14" drum diameter in centimeters (multilateration.py:12)
DIAMETER = 14 * 2.54
#: wave speed through a drumhead membrane, m/s (multilateration.py:15)
C_DRUMHEAD = 82.0
MEDIUM = "air"
STRIKE_FORCE = 1.0


def _t(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(
        v, dtype=torch.float32)


def speed_of_sound(
    scale: float = 1.0,
    temperature: float = TEMPERATURE,
    humidity: float = HUMIDITY,
    medium: str = MEDIUM,
) -> float:
    """Speed of sound in m/s (times ``scale``); the air model and the
    drumhead constant of multilateration.py:23-39."""
    if medium == "air":
        return scale * (331.3 + 0.606 * temperature) * (1 + 0.0124 * humidity)
    return scale * C_DRUMHEAD


def cartesian_to_polar(x, y, r=None):
    """(x, y) → (r, phi°); ``r`` normalises the returned radius."""
    x, y = _t(x), _t(y)
    radius = torch.sqrt(x ** 2 + y ** 2)
    if r is not None:
        radius = radius / r
    phi = torch.remainder(torch.atan2(y, x), 2 * math.pi)
    return radius, torch.rad2deg(phi)


def polar_to_cartesian(r, phi):
    """(r, phi°) → (x, y)."""
    phi = torch.deg2rad(_t(phi))
    return r * torch.cos(phi), r * torch.sin(phi)


def spherical_to_cartesian(r, phi, theta):
    """Drum-convention spherical → cartesian (multilateration.py:75-102)."""
    phi = torch.deg2rad(_t(phi))
    theta = _t(theta)
    incl = torch.deg2rad(torch.where(theta < 0, -theta, 90.0 - theta))
    x = r * torch.cos(phi) * torch.sin(incl)
    y = r * torch.sin(phi) * torch.sin(incl)
    z = r * torch.cos(incl)
    return x, y, z


def cartesian_to_spherical(x, y, z):
    """Cartesian → drum-convention spherical (multilateration.py:105-123)."""
    x, y, z = _t(x), _t(y), _t(z)
    r = torch.sqrt(x ** 2 + y ** 2 + z ** 2)
    phi = torch.remainder(torch.atan2(y, x), 2 * math.pi)
    theta = torch.rad2deg(torch.arccos(z / r))
    theta = torch.where(theta < 0, -theta, 90.0 - theta)
    return r, torch.rad2deg(phi), theta


def cartesian_to_cylindrical(x, y, z, r=None):
    """Cartesian → (r, phi°, z) (multilateration.py:126-144)."""
    x, y = _t(x), _t(y)
    radius = torch.sqrt(x ** 2 + y ** 2)
    if r is not None:
        radius = radius / r
    phi = torch.remainder(torch.atan2(y, x), 2 * math.pi)
    return radius, torch.rad2deg(phi), z


def cylindrical_to_cartesian(r, phi, z):
    """(r, phi°, z) → cartesian (multilateration.py:147-157)."""
    phi = torch.deg2rad(_t(phi))
    return r * torch.cos(phi), r * torch.sin(phi), z
