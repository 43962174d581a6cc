"""Audio augmentations, batched over rows (port of
``onset_fingerprinting_tpu.data.augment``, JAX augment.py:20-165).

The reference's audiomentations pipeline (reference: data.py:18-28, 408:
AddGaussianNoise, AirAbsorption, SevenBandParametricEQ, TanhDistortion under
``SomeOf((0, 3))``).  The JAX package writes each augmentation for one
example and ``vmap``s it over a batch (datasets.py:222-229); here each takes
the batch ``[..., N]`` at once and treats every leading index as one
example: its draws, ``tanh_distortion``'s RMS and ``some_of``'s choice are
per row.

Each augmentation is split into its draws (``draws(generator, audio)``,
from an explicit ``torch.Generator`` on the audio's device) and a
deterministic ``apply(audio, draws, sr)``, so a test can feed the JAX
package's ``jax.random`` draws into the apply.  Calling one, ``aug(generator,
audio, sr, **params)``, is the JAX signature with the key replaced by the
generator.

The two recursions (the seven biquads' DF2T and the air absorption's
one-pole low-pass, ``lax.scan`` over samples in JAX) run one step per sample
across all rows: a Python loop of element-wise ops, as no TPU kernel
computes them.  Their coefficients are float32, as in JAX, and their state
is float64: the 50 Hz band's poles sit ~3e-3 inside the unit circle, where
a float32 state drifts ~1e-4 of the signal's scale from the exact filter
over 300 samples and ~2e-4 over a 2064-sample frame (the JAX package's
does too), so two float32 orders of rounding cannot agree closer than that.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch


def _uniform(generator, shape, lo, hi, audio) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=audio.device,
                   dtype=torch.float32)
    return lo + (hi - lo) * u


class Augmentation:
    """``draws`` then ``apply``; parameters are the dataclass fields."""

    def draws(self, generator: torch.Generator, audio: torch.Tensor):
        raise NotImplementedError

    def apply(self, audio: torch.Tensor, draws, sr: int = 96000
              ) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, generator: torch.Generator, audio: torch.Tensor,
                 sr: int = 96000, **params) -> torch.Tensor:
        aug = dataclasses.replace(self, **params) if params else self
        return aug.apply(audio, aug.draws(generator, audio), sr)


@dataclass(frozen=True)
class GaussianNoise(Augmentation):
    """Additive white noise with a random amplitude (audiomentations
    AddGaussianNoise defaults).  Draws: ``(amp [...], noise [..., N])``."""

    min_amplitude: float = 0.001
    max_amplitude: float = 0.015

    def draws(self, generator, audio):
        amp = _uniform(generator, audio.shape[:-1], self.min_amplitude,
                       self.max_amplitude, audio)
        noise = torch.randn(audio.shape, generator=generator,
                            device=audio.device, dtype=audio.dtype)
        return amp, noise

    def apply(self, audio, draws, sr=96000):
        amp, noise = draws
        return audio + amp[..., None] * noise


def _biquad_peak_coeffs(f0, gain_db: torch.Tensor, q: float, sr: int):
    """RBJ peaking-EQ biquad coefficients, float32: ``(b [3, ...], a [3,
    ...])`` for per-row gains ``[...]``."""
    a = 10.0 ** (gain_db / 40.0)
    # float32 throughout, in the JAX package's order: (2π·f0)/sr
    w0 = torch.tensor(np.float32(2 * math.pi) * np.float32(f0)
                      / np.float32(sr), device=gain_db.device)
    alpha = torch.sin(w0) / (2 * q)
    cosw = torch.cos(w0)
    b0 = 1 + alpha * a
    b1 = (-2 * cosw).expand_as(a)
    b2 = 1 - alpha * a
    a0 = 1 + alpha / a
    a1 = (-2 * cosw).expand_as(a)
    a2 = 1 - alpha / a
    return (torch.stack([b0, b1, b2]) / a0,
            torch.stack([torch.ones_like(a0), a1 / a0, a2 / a0]))


def _biquad_apply(b: torch.Tensor, a: torch.Tensor, x: torch.Tensor
                  ) -> torch.Tensor:
    """One biquad along the last axis of ``x [..., N]`` (transposed direct
    form II) in ``x``'s dtype, the coefficients ``[3, ...]`` per row, one
    step per sample:
    the input products for all samples first, then four ops per step."""
    xs = x.movedim(-1, 0).contiguous()
    bx = b[:, None] * xs  # [3, N, ...]
    ys = torch.empty_like(xs)
    z0 = xs.new_zeros(xs.shape[1:])
    z1 = xs.new_zeros(xs.shape[1:])
    for t in range(xs.shape[0]):
        y = torch.add(bx[0, t], z0, out=ys[t])
        z0 = torch.addcmul(bx[1, t] + z1, a[1], y, value=-1)
        z1 = torch.addcmul(bx[2, t], a[2], y, value=-1)
    return ys.movedim(0, -1)


_EQ_BANDS = np.array([50.0, 150.0, 400.0, 1000.0, 2500.0, 6300.0, 16000.0])


@dataclass(frozen=True)
class SevenBandEQ(Augmentation):
    """Seven-band parametric EQ with random per-band gains (audiomentations
    SevenBandParametricEQ equivalent).  Draws: ``gains [..., 7]`` dB."""

    min_gain_db: float = -10.0
    max_gain_db: float = 10.0

    def draws(self, generator, audio):
        return _uniform(generator, audio.shape[:-1] + (7,),
                        self.min_gain_db, self.max_gain_db, audio)

    def apply(self, audio, draws, sr=96000):
        y = audio.double()
        for i, f0 in enumerate(_EQ_BANDS):
            if f0 >= sr / 2:
                continue
            b, a = _biquad_peak_coeffs(f0, draws[..., i], 1.0, sr)
            y = _biquad_apply(b.double(), a.double(), y)
        return y.to(audio.dtype)


@dataclass(frozen=True)
class AirAbsorption(Augmentation):
    """Distance-dependent high-frequency damping (audiomentations
    AirAbsorption equivalent): a one-pole low-pass whose cutoff falls with
    the simulated distance.  Draws: ``distance [...]`` m."""

    min_distance: float = 10.0
    max_distance: float = 50.0

    def draws(self, generator, audio):
        return _uniform(generator, audio.shape[:-1], self.min_distance,
                        self.max_distance, audio)

    def apply(self, audio, draws, sr=96000):
        # empirical: ~20 kHz at 10 m shrinking toward ~3 kHz at 100 m
        cutoff = 20000.0 * torch.exp(-draws / 50.0) + 2000.0
        alpha = (1.0 - torch.exp(-2 * math.pi * cutoff / sr)).double()
        xs = audio.movedim(-1, 0).double().contiguous()
        ys = torch.empty_like(xs)
        y = xs.new_zeros(xs.shape[1:])
        for t in range(xs.shape[0]):
            y = torch.addcmul(y, alpha, xs[t] - y, out=ys[t])
        return ys.movedim(0, -1).to(audio.dtype)


@dataclass(frozen=True)
class TanhDistortion(Augmentation):
    """Soft-clipping distortion with a random drive, RMS-matched per row
    like audiomentations TanhDistortion.  Draws: ``distortion [...]``."""

    min_distortion: float = 0.005
    max_distortion: float = 0.1

    def draws(self, generator, audio):
        return _uniform(generator, audio.shape[:-1], self.min_distortion,
                        self.max_distortion, audio)

    def apply(self, audio, draws, sr=96000):
        gain = (1.0 + 30.0 * draws)[..., None]
        rms_in = torch.sqrt((audio ** 2).mean(-1, keepdim=True) + 1e-12)
        y = torch.tanh(gain * audio)
        rms_out = torch.sqrt((y ** 2).mean(-1, keepdim=True) + 1e-12)
        return y * (rms_in / rms_out)


gaussian_noise = GaussianNoise()
seven_band_eq = SevenBandEQ()
air_absorption = AirAbsorption()
tanh_distortion = TanhDistortion()

AUGMENTATIONS: Sequence[Augmentation] = (
    gaussian_noise,
    air_absorption,
    seven_band_eq,
    tanh_distortion,
)


def some_of_draws(generator: torch.Generator, audio: torch.Tensor,
                  augmentations: Sequence[Augmentation] = AUGMENTATIONS,
                  max_k: int = 3):
    """``some_of``'s draws: per row a count ``k`` in ``[0, max_k]`` and a
    random order of the augmentations, the first ``k`` of which are chosen
    (``chosen [..., n]`` bool), then every augmentation's draws."""
    n = len(augmentations)
    lead = audio.shape[:-1]
    k = torch.randint(0, max_k + 1, lead, generator=generator,
                      device=audio.device)
    order = torch.rand(lead + (n,), generator=generator,
                       device=audio.device).argsort(dim=-1)
    chosen = torch.zeros(lead + (n,), dtype=torch.bool, device=audio.device)
    rank = torch.arange(min(max_k, n), device=audio.device)
    chosen.scatter_(-1, order[..., :max_k], rank < k[..., None])
    return chosen, [aug.draws(generator, audio) for aug in augmentations]


def some_of_apply(audio: torch.Tensor, chosen: torch.Tensor, draws,
                  sr: int = 96000,
                  augmentations: Sequence[Augmentation] = AUGMENTATIONS
                  ) -> torch.Tensor:
    """Every augmentation in turn on the running result, each row keeping
    it where chosen (as the JAX package blends by a mask)."""
    y = audio
    for i, (aug, d) in enumerate(zip(augmentations, draws)):
        y = torch.where(chosen[..., i, None], aug.apply(y, d, sr), y)
    return y


def some_of(generator: torch.Generator, audio: torch.Tensor, sr: int = 96000,
            augmentations: Sequence[Augmentation] = AUGMENTATIONS,
            max_k: int = 3) -> torch.Tensor:
    """A random subset of up to ``max_k`` augmentations per row
    (audiomentations ``SomeOf((0, 3))``, data.py:408 of the reference)."""
    chosen, draws = some_of_draws(generator, audio, augmentations, max_k)
    return some_of_apply(audio, chosen, draws, sr, augmentations)
