"""The traffic generator: audio and its truth from a traffic file's
parameters and ``--seed``, made on the device.

Two kinds of traffic, named by the file's ``kind``:

- ``fleet_hits``: many 4-channel streams, each a periodic train of
  decaying 5 kHz bursts from the stream's own phase, the same burst on
  every channel, over Gaussian noise, cut into chunks.  A ring of
  ``ring_chunks`` chunks is one period of every stream, so that the chunks
  can be sent again and again and the streams stay continuous.  A burst
  that would not lie whole inside its chunk (with ``lead`` samples before
  its onset) is left out, so that every hit's window lies in the chunk
  its onset falls in.
- ``drum_strikes``: a batch of 3-sensor drum streams; each stream is
  struck every ``strike_period`` samples from its own phase, at a random
  point of the head, and each sensor hears the burst after the strike's
  distance to it.

Small random draws (which stream gets which phase, strike points) come
from a NumPy generator of the seed; the audio is made on the device from
a ``torch.Generator`` of the same seed, in a few large calls.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


def burst(n: int, freq: float, decay: float, amp: float, sr: int,
          device=None) -> torch.Tensor:
    t = torch.arange(n, device=device, dtype=torch.float32)
    return torch.sin(2 * math.pi * freq / sr * t) * torch.exp(-t / decay) \
        * amp


def spread_phases(rng, n: int, period: int) -> np.ndarray:
    """``n`` streams' phases: the same evenly spread set of ``n`` phases
    over the period for every seed, dealt to the streams in the seed's
    order, so that every seed sends the same arrivals and the same amount
    of work."""
    return rng.permutation((np.arange(n) * period) // n)


def _torch_gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (2 ** 63))
    return g


@dataclass
class FleetAudio:
    """``ring [R, S·cps]`` float32 on the device, ``lead_in [L, S·cps]``
    (the ring's last samples, which precede its first in every stream),
    ``counts [chunks, S]`` the bursts whose onset lies in each chunk, and
    ``phases [S]``."""

    ring: torch.Tensor
    lead_in: torch.Tensor
    counts: np.ndarray
    phases: np.ndarray
    chunk: int

    def chunk_view(self, j: int) -> torch.Tensor:
        return self.ring[j * self.chunk:(j + 1) * self.chunk]


def fleet_hits(tr: dict, cfg: dict, seed: int, device) -> FleetAudio:
    """The fleet's audio as ``onset_fingerprinting_torch.workload`` makes
    it (the same burst on every channel of a stream, over noise), with each
    stream's train of hits at its own phase and at the traffic's rate."""
    s, cps = cfg["streams"], cfg["channels_per_stream"]
    chunk, sr = cfg["chunk_samples"], cfg["sr"]
    period, blen = tr["hit_period"], tr["burst_len"]
    ring_len = chunk * tr["ring_chunks"]
    if ring_len % period:
        raise ValueError("the ring must hold whole hit periods")
    n_hit = ring_len // period
    last = chunk - blen - tr["burst_margin"]
    rng = np.random.default_rng(seed)
    phases = spread_phases(rng, s, period)
    # the truth: every onset of the ring and whether its burst is in
    onsets = phases[:, None] + period * np.arange(n_hit)[None, :]  # [S, H]
    pos = onsets % chunk
    inside = (pos >= tr["lead"]) & (pos <= last)
    counts = np.zeros((tr["ring_chunks"], s), np.int64)
    np.add.at(counts, (onsets // chunk, np.broadcast_to(
        np.arange(s)[:, None], onsets.shape)), inside.astype(np.int64))
    g = _torch_gen(seed, device)
    ring = torch.randn((ring_len, s * cps), generator=g, device=device,
                       dtype=torch.float32)
    ring.mul_(tr["noise"])
    wave = burst(blen, tr["burst_freq"], tr["burst_decay"], tr["burst_amp"],
                 sr, device)
    ph = torch.as_tensor(phases, device=device)
    keep = torch.as_tensor(inside.reshape(-1), device=device)
    first = torch.arange(s, device=device)[None, :] * n_hit
    step = 2048
    for t0 in range(0, ring_len, step):
        t = torch.arange(t0, min(t0 + step, ring_len), device=device)[:, None]
        rel = torch.remainder(t - ph[None, :], period)  # [T, S]
        k = torch.remainder(torch.div(t - ph[None, :] - rel, period,
                                      rounding_mode="floor"), n_hit)
        on = (rel < blen) & keep[first + k]
        hit = torch.where(on, wave[rel.clamp(max=blen - 1)], 0.0)
        ring[t0:t0 + hit.shape[0]].view(-1, s, cps).add_(hit[..., None])
    lead = tr["lead_in_blocks"] * cfg["detector"]["block_size"]
    lead_in = ring[ring_len - lead:].clone()
    return FleetAudio(ring, lead_in, counts, phases, chunk)


@dataclass
class DrumAudio:
    """``batches [B, S, T, 3]`` float32 on the device, ``lead_in [L, 3]``
    noise that precedes every stream, and per batch and stream the
    strikes ``(onset, x cm, y cm)``."""

    batches: torch.Tensor
    lead_in: torch.Tensor
    strikes: list


def sensor_xyz(polar, radius: float) -> np.ndarray:
    out = []
    for r, phi, theta in polar:
        incl = math.radians(-theta if theta < 0 else 90.0 - theta)
        p = math.radians(phi)
        out.append((r * radius * math.cos(p) * math.sin(incl),
                    r * radius * math.sin(p) * math.sin(incl),
                    r * radius * math.cos(incl)))
    return np.asarray(out)


def drum_strikes(tr: dict, cfg: dict, seed: int, device) -> DrumAudio:
    s, sr = cfg["streams"], cfg["sr"]
    t = int(cfg["seconds"] * sr) // 128 * 128
    nb, period, blen = tr["batches"], tr["strike_period"], tr["burst_len"]
    radius = cfg["diameter_cm"] / 2
    xyz = sensor_xyz(cfg["sensors_polar"], radius)
    c = cfg["wave_speed_m_s"] * 100
    rng = np.random.default_rng(seed)
    lo, hi = tr["radius_share"]
    strikes, flat = [], []
    for b in range(nb):
        per_b = []
        phases = spread_phases(rng, s, period)
        for i in range(s):
            bases = np.arange(phases[i], t - tr["tail_guard"], period)
            r = np.sqrt(rng.uniform(lo * lo, hi * hi, len(bases))) * radius
            ang = rng.uniform(0, 2 * np.pi, len(bases))
            x, y = r * np.cos(ang), r * np.sin(ang)
            per_b.append(list(zip(bases.tolist(), x.tolist(), y.tolist())))
            d = np.hypot(x[:, None] - xyz[None, :, 0],
                         y[:, None] - xyz[None, :, 1])
            on = bases[:, None] + np.round(d / c * sr).astype(np.int64)
            # flat index of each burst's first sample in [B, S, T, 3]
            base = ((b * s + i) * t + on) * 3 + np.arange(3)[None, :]
            flat.append(base.reshape(-1))
        strikes.append(per_b)
    g = _torch_gen(seed, device)
    x = torch.randn((nb, s, t, 3), generator=g, device=device,
                    dtype=torch.float32)
    x.mul_(tr["noise"])
    lead = tr["lead_in_blocks"] * 128
    lead_in = torch.randn((lead, 3), generator=g, device=device,
                          dtype=torch.float32).mul_(tr["noise"])
    starts = torch.as_tensor(np.concatenate(flat), device=device)
    wave = burst(blen, tr["burst_freq"], tr["burst_decay"], tr["burst_amp"],
                 sr, device)
    idx = starts[:, None] + 3 * torch.arange(blen, device=device)[None, :]
    x.view(-1).index_add_(0, idx.reshape(-1),
                          wave.repeat(starts.shape[0]))
    return DrumAudio(x, lead_in, strikes)


KINDS = {"fleet_hits": fleet_hits, "drum_strikes": drum_strikes}


def make(tr: dict, cfg: dict, seed: int, device):
    return KINDS[tr["kind"]](tr, cfg, seed, device)
