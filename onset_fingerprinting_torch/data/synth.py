"""A copy of ``onset_fingerprinting_tpu.data.synth`` (no jax in it), with
only its imports changed.

Physical modal-drum synthesis for fixtures with LEARNABLE location signal.

The reference validates its fingerprinting models on real multi-sensor drum
recordings (refresh.org: 1240 hits, 4 sensors), where the waveform each
sensor observes depends on the hit position through the membrane's modal
Green's function and through propagation (arrival delay, geometric
attenuation, distance-dependent high-frequency damping).  The CCCNN family
(model.py:443-629) consumes per-channel *self*-correlations — features that
are shift-invariant, so a fixture whose channels carry the SAME waveform at
different delays (pure-TDOA synthesis) contains literally zero signal for
it.  This module synthesizes hits whose per-sensor waveform *content*
varies with position, the way real drums do:

- mode (m, n) excited at ``(r, phi)`` and observed at sensor ``(r_s,
  phi_s)`` carries the Green's-function shape product ``J_m(a_mn r) *
  J_m(a_mn r_s) * cos(m (phi - phi_s))`` — sensors at different bearings
  hear different modal balances for the same hit;
- propagation applies a fractional-sample arrival delay ``d/c``, geometric
  spreading ``1/(1 + d/r0)``, and dispersive damping ``exp(-beta_k d)``
  growing with mode index — far sensors hear a darker, later, quieter hit;
- the strike adds a broadband attack transient, low-passed with distance;
- velocity scales amplitude and brightness (harder hits ring the upper
  modes disproportionately), and each hit draws random mode phases.

All of those are continuous functions of hit position, so raw onset
windows carry genuinely learnable regression signal — the synthetic stand-
in for the reference's real recordings (data mined per
mining_mc_hits.org:51-63).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from onset_fingerprinting_torch.core import posd


def _polar_to_cartesian(r, phi_deg):
    # host-side numpy twin of core.coords.polar_to_cartesian (which is
    # jnp-based and would dispatch to the device per synthesized hit)
    a = np.radians(phi_deg)
    return r * np.cos(a), r * np.sin(a)


def _speed_of_sound_air_cm_s(temperature=20.0, humidity=50.0):
    # numpy twin of core.coords.speed_of_sound(100, medium="air")
    return 100.0 * (331.3 + 0.606 * temperature) * (1 + 0.0124 * humidity)

#: circular-membrane modes (m, frequency ratio to (0,1), n-th positive zero
#: of J_m) — the classic ideal-membrane table
MODES = [
    (0, 1.000, 2.405),
    (1, 1.594, 3.832),
    (2, 2.136, 5.136),
    (0, 2.296, 5.520),
    (3, 2.653, 6.380),
    (1, 2.918, 7.016),
    (4, 3.156, 7.588),
    (2, 3.501, 8.417),
]

#: default sensor bearings: 4 rim sensors at 0/90/180/270 degrees
DEFAULT_SENSORS = [(0.9, 0.0), (0.9, 90.0), (0.9, 180.0), (0.9, 270.0)]


def modal_hit(
    rng: np.random.Generator,
    r: float,
    phi: float,
    *,
    sensors=DEFAULT_SENSORS,
    sr: int = 96000,
    n: int = 1024,
    velocity: float = 1.0,
    radius_cm: float = 17.78,
    f0: float = 900.0,
    c_cm_s: float | None = None,
    transient: float = 0.25,
) -> tuple[np.ndarray, np.ndarray]:
    """Synthesize one strike at ``(r, phi)`` as heard by each sensor.

    :param r: hit radius fraction in [0, 1]
    :param phi: hit bearing in degrees
    :param sensors: list of ``(r_frac, phi_deg)`` sensor positions
    :param n: samples per channel
    :param velocity: strike velocity in (0, 1]; scales amplitude AND
        brightness
    :param f0: fundamental of the (0,1) mode in Hz.  The default 900 Hz is
        a high-tension head: a 256-sample window at 96 kHz (2.67 ms) then
        holds 2.4–8 periods of the mode stack, so self-correlation features
        can resolve the modal balance (a 140 Hz concert tom would need
        wider windows than the reference's w=256, train.py:24).
    :param c_cm_s: propagation speed in cm/s (default: speed_of_sound in
        humid air — near-field mics; keeps the max inter-sensor lag ~90
        samples at 96 kHz, inside a 256 window)
    :param transient: attack-transient level relative to the modal sum
    :returns: ``(audio [n, n_sensors] float32, delays [n_sensors] float
        samples)``
    """
    from scipy.special import jv

    if c_cm_s is None:
        c_cm_s = _speed_of_sound_air_cm_s()
    n_sens = len(sensors)
    hx, hy = _polar_to_cartesian(r * radius_cm, phi)
    t = np.arange(n, dtype=np.float64) / sr
    out = np.zeros((n, n_sens), dtype=np.float64)
    delays = np.zeros(n_sens, dtype=np.float64)

    phases = rng.uniform(0, 2 * np.pi, len(MODES))
    # one broadband transient waveform per hit, shared across sensors
    # before per-sensor propagation filtering
    tr_len = 160
    tr = rng.normal(0, 1, tr_len) * np.exp(-np.arange(tr_len) / 30.0)

    for s, (rs, ps) in enumerate(sensors):
        sx, sy = _polar_to_cartesian(rs * radius_cm, ps)
        d = float(np.hypot(hx - sx, hy - sy))  # cm
        delay = d / c_cm_s * sr  # fractional samples
        delays[s] = delay
        ts = t - delay / sr
        live = ts > 0
        tl = np.where(live, ts, 0.0)
        atten = 1.0 / (1.0 + d / 12.0)  # geometric spreading
        attack = (1.0 - np.exp(-tl / (10.0 / sr))) * live

        sig = np.zeros(n, dtype=np.float64)
        for k, (m, ratio, alpha) in enumerate(MODES):
            shape = jv(m, alpha * r) * jv(m, alpha * rs) * np.cos(
                m * np.radians(phi - ps)
            )
            amp = shape * velocity ** (1.0 + 0.2 * k)
            # dispersive damping: upper modes die faster with distance
            amp *= np.exp(-0.012 * k * d)
            tau = 0.004 * (1.0 + 0.4 * k) ** -1 + 0.004
            sig += amp * np.sin(
                2 * np.pi * f0 * ratio * tl + phases[k]
            ) * np.exp(-tl / tau)
        sig *= attack

        # attack transient: arrival-aligned, distance-lowpassed (one-pole
        # with distance-dependent time constant) and attenuated
        idx = int(np.floor(delay))
        frac = delay - idx
        tr_f = (1 - frac) * tr
        tr_f[1:] += frac * tr[:-1]
        from scipy.signal import lfilter

        smooth = max(1.0 - 0.02 * d, 0.15)
        lp = lfilter([smooth], [1.0, -(1.0 - smooth)], tr_f)
        stop = min(idx + tr_len, n)
        if stop > idx >= 0:
            # final per-sensor atten below applies to the transient too
            sig[idx:stop] += transient * velocity * lp[: stop - idx]

        out[:, s] = 1.5 * atten * sig
    return out.astype(np.float32), delays


def synth_location_session(
    folder: str | Path,
    name: str = "combined0",
    *,
    n_hits: int = 256,
    sr: int = 96000,
    seed: int = 0,
    sensors=DEFAULT_SENSORS,
    radius_cm: float = 17.78,
    spacing: int = 4000,
    noise: float = 1e-4,
    velocity_range: tuple[float, float] = (0.4, 1.0),
    f0: float = 900.0,
    r_range: tuple[float, float] = (0.1, 0.9),
    phi_range: tuple[float, float] = (0.0, 360.0),
) -> tuple[np.ndarray, np.ndarray]:
    """Write a POSD session of modal-drum hits at random locations.

    Onset annotation is the first arrival (min per-sensor delay), matching
    how the reference's mined datasets anchor windows (data.py:55-120).

    ``r_range``/``phi_range`` confine hits to a patch of the head (radius
    fractions / bearing degrees; sampling stays uniform-over-area within
    the patch).  Useful for fixtures that need a constant sensor arrival
    order — e.g. training data for the serve loop's learned-trilateration
    bypass, whose FCNN input is the pair of arrival-order sample lags.

    :returns: ``(onsets [n_hits] int, locations [n_hits, 2] cm)``
    """
    rng = np.random.default_rng(seed)
    n_sens = len(sensors)
    n = spacing * (n_hits + 2)
    audio = rng.normal(0, noise, (n, n_sens)).astype(np.float32)
    hit_len = 1024
    onsets = np.zeros(n_hits, dtype=np.int64)
    locs = np.zeros((n_hits, 2), dtype=np.float32)
    for i in range(n_hits):
        base = spacing + i * spacing
        # uniform over the (patch of the) head
        r = np.sqrt(rng.uniform(r_range[0] ** 2, r_range[1] ** 2))
        phi = rng.uniform(*phi_range)
        velocity = rng.uniform(*velocity_range)
        hit, delays = modal_hit(
            rng, r, phi, sensors=sensors, sr=sr, n=hit_len,
            velocity=velocity, radius_cm=radius_cm, f0=f0,
        )
        audio[base : base + hit_len] += hit
        onsets[i] = base + int(round(delays.min()))
        x, y = _polar_to_cartesian(r * radius_cm, phi)
        locs[i] = (x, y)
    posd.save_session(
        Path(folder), name, audio, sr,
        posd.make_hits(onsets, locations=locs),
    )
    return onsets, locs
