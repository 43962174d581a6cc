"""End-to-end serve-loop run: synthetic drum → detect → group → locate
(port of examples/e2e_locate_demo.py).

Simulates a 3-sensor drumhead, generates hits at known polar locations with
physically consistent per-sensor arrival delays, runs the amplitude onset
detector (on the card K1: one launch for the 0.5 s warmup, one over the
recording, both on the coupled pipe), clusters onsets into per-hit groups,
and feeds the events in time order through the host ``Multilaterate3D``
locator.  Reports localization error in cm.

Gate (the demo's): at least 0.75 of the hits matched and a median error
below 3.0 cm.

Run: python -m onset_fingerprinting_torch.tools.e2e_locate [--cpu]
[--hits N] [--seed S]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from onset_fingerprinting_torch.core.coords import (
    DIAMETER,
    polar_to_cartesian,
    speed_of_sound,
)
from onset_fingerprinting_torch.detect import (
    detect_onsets_amplitude,
    find_onset_groups,
)
from onset_fingerprinting_torch.device import resolve_device
from onset_fingerprinting_torch.locate import Multilaterate3D

SR = 96000
#: the demo's detector settings (no high-pass, a -70 dB floor)
DETECT = dict(hipass_freq=0.0, floor=-70.0, fast_ar=(3.0, 383.0),
              slow_ar=(2205.0, 2205.0))


def synth_drum(n_hits: int = 8, sr: int = SR,
               diameter_cm: float = DIAMETER, seed: int = 0):
    """A multi-sensor drum recording with hits at known spots (the demo's
    synthesizer) → ``(audio [N, 3] float32, sensor polar, truths [(base,
    x, y)], sr, diameter)``."""
    rng = np.random.default_rng(seed)
    radius = diameter_cm / 2
    # three drumhead sensors near the rim (relative polar + elevation 0)
    sensor_polar = [(0.9, 0.0, 0.0), (0.9, 120.0, 0.0), (0.9, 240.0, 0.0)]
    c = speed_of_sound(100, medium="drumhead")  # cm/s
    # float32, as the JAX package's coords compute
    sensors_xy = [
        tuple(np.float32(v) for v in polar_to_cartesian(r * radius, phi))
        for (r, phi, _) in sensor_polar
    ]
    spacing = int(0.25 * sr)  # 250 ms between hits
    n = spacing * (n_hits + 2)
    audio = rng.normal(0, 1e-4, size=(n, 3)).astype(np.float32)

    truths = []
    burst_len = 600
    t = np.arange(burst_len)
    for h in range(n_hits):
        r = rng.uniform(0.1, 0.85) * radius
        phi = rng.uniform(0, 360)
        x, y = (np.float32(v) for v in polar_to_cartesian(r, phi))
        base = spacing * (h + 1)
        burst = (
            np.sin(2 * np.pi * 4000 / sr * t)
            * np.exp(-t / 150.0)
            * rng.uniform(0.4, 0.9)
        )
        for ch, (sx, sy) in enumerate(sensors_xy):
            dist = np.hypot(x - float(sx), y - float(sy))
            delay = int(round(dist / c * sr))
            audio[base + delay : base + delay + burst_len, ch] += burst
        truths.append((base, float(x), float(y)))
    return audio, sensor_polar, truths, sr, diameter_cm


def locate_events(locator: Multilaterate3D, onsets, channels) -> list:
    """Events in time order through the host locator, as the realtime
    engine would feed them → ``[(onset, (x, y))]`` of the completed
    hits."""
    results = []
    for onset, ch in sorted(zip(onsets, channels)):
        res = locator.locate(int(ch), int(onset))
        if res is not None:
            results.append((int(onset), (float(res[0]), float(res[1]))))
    return results


def match_errors(truths, results) -> np.ndarray:
    """Each truth's error (cm) against the last located hit within 2000
    samples of it; unmatched truths are left out (the demo's matching)."""
    errs = []
    for (base, tx, ty) in truths:
        best = None
        for onset, (px, py) in results:
            if abs(onset - base) < 2000:
                best = (px, py)
        if best is not None:
            errs.append(float(np.hypot(best[0] - tx, best[1] - ty)))
    return np.asarray(errs)


def run(hits: int = 8, seed: int = 0, sr: int = SR, device=None,
        log=print) -> dict:
    """The demo's steps on ``device`` (None = the card): synth, detect,
    group, locate.  Returns the events, groups, located hits, errors, the
    gate's inputs and the host seconds of each step."""
    dev = resolve_device(device)
    audio, sensor_polar, truths, sr, diameter = synth_drum(hits, sr,
                                                           seed=seed)
    log(f"synth: {audio.shape[0] / sr:.1f}s, {audio.shape[1]} sensors, "
        f"{len(truths)} hits")
    seconds = {}
    t0 = time.perf_counter()
    channels, onsets, _ = detect_onsets_amplitude(audio, sr=sr, device=dev,
                                                  **DETECT)
    seconds["detect"] = time.perf_counter() - t0
    log(f"detected {len(onsets)} onsets on {len(set(channels))} channels")
    t0 = time.perf_counter()
    groups = find_onset_groups(onsets, channels, max_distance=200,
                               min_channels=3)
    seconds["group"] = time.perf_counter() - t0
    res = dict(audio=audio, truths=truths, channels=channels, onsets=onsets,
               groups=groups, results=[], errs=np.zeros(0), seconds=seconds)
    if groups is None:
        log("no onset groups found")
        return res
    log(f"grouped into {len(groups)} hits (expected {len(truths)})")
    locator = Multilaterate3D(sensor_locations=sensor_polar,
                              drum_diameter=diameter, medium="drumhead",
                              sr=sr)
    t0 = time.perf_counter()
    res["results"] = locate_events(locator, onsets, channels)
    seconds["locate"] = time.perf_counter() - t0
    log(f"located {len(res['results'])} hits")
    res["errs"] = match_errors(truths, res["results"])
    return res


def gate(res: dict) -> bool:
    """At least 0.75 of the hits matched and a median error below 3 cm."""
    errs = res["errs"]
    return (res["groups"] is not None and len(errs) > 0
            and len(errs) >= 0.75 * len(res["truths"])
            and float(np.median(errs)) < 3.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hits", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    res = run(args.hits, args.seed, device="cpu" if args.cpu else None)
    errs = res["errs"]
    if len(errs):
        print(f"matched {len(errs)}/{len(res['truths'])} hits | "
              f"localization error: mean {errs.mean():.2f} cm, "
              f"median {np.median(errs):.2f} cm, max {errs.max():.2f} cm")
    else:
        print("no located hit matched ground truth")
    print("host seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in res["seconds"].items()))
    ok = gate(res)
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
