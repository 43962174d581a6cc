"""Fleet-scale offline dataset mining: sharded detection → locate → POSD
(port of examples/fleet_detect_demo.py).

A batch of multi-sensor recordings is split over the mesh's ``data`` axis
(one rank per card; on one card the whole batch), each rank folds its
streams into the channel axis of one per-channel detector (K1 on the card,
one launch; ``parallel.sharding.detect_offline_sharded``), and each
stream's onset events are located by the host ``Multilaterate3D`` and
written out as a POSD session.

Gate (the demo's): at least 0.75 of the hits located within 2 cm, and one
POSD session per stream.

Run: python -m onset_fingerprinting_torch.tools.fleet_detect [--cpu]
[--streams N] [--seconds S]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from onset_fingerprinting_torch.core import posd
from onset_fingerprinting_torch.core.config import DetectorConfig
from onset_fingerprinting_torch.core.coords import (
    DIAMETER,
    cartesian_to_polar,
    speed_of_sound,
    spherical_to_cartesian,
)
from onset_fingerprinting_torch.detect.amplitude import detector_init
from onset_fingerprinting_torch.locate import Multilaterate3D
from onset_fingerprinting_torch.ops import _cuda
from onset_fingerprinting_torch.parallel import (
    default_mesh,
    detect_offline_sharded,
)
from onset_fingerprinting_torch.parallel.sharding import events_from_dense

SR = 96000
BLOCK = 128


def synth_fleet(n_streams: int, seconds: float = 1.0, seed: int = 0):
    """The demo's fleet: ``n_streams`` 3-sensor drum recordings with a hit
    every 0.25 s → ``(streams [S, N, 3] float32, sensor polar, truths per
    stream [(base, x, y)])``."""
    radius = DIAMETER / 2
    polar = [(0.9, 0.0, 0.0), (0.9, 120.0, 0.0), (0.9, 240.0, 0.0)]
    xyz = [
        tuple(float(v) for v in spherical_to_cartesian(r * radius, p, t))
        for (r, p, t) in polar
    ]
    c = speed_of_sound(100, medium="drumhead")
    rng = np.random.default_rng(seed)
    n = int(seconds * SR) // 128 * 128
    t = np.arange(600)
    burst = (np.sin(2 * np.pi * 5000 / SR * t) * np.exp(-t / 150) * 0.6)
    streams = np.empty((n_streams, n, 3), np.float32)
    truths = []
    for s in range(n_streams):
        audio = rng.normal(0, 1e-4, (n, 3)).astype(np.float32)
        hits = []
        for base in range(SR // 4, n - 2000, SR // 4):
            x, y = rng.uniform(-radius * 0.7, radius * 0.7, 2)
            for ch, (sx, sy, _) in enumerate(xyz):
                d = np.hypot(x - sx, y - sy)
                at = base + int(round(d / c * SR))
                audio[at : at + 600, ch] += burst.astype(np.float32)
            hits.append((base, x, y))
        streams[s] = audio
        truths.append(hits)
    return streams, polar, truths


def locate_stream(locator: Multilaterate3D, on, deltas) -> list:
    """One stream's dense events through the host locator, in time order
    → ``[(onset, x, y, r, phi)]`` of the completed hits."""
    channels, onsets = events_from_dense(on, deltas, BLOCK)
    locator.ongoing = []
    hits = []
    for onset, ch in sorted(zip(onsets, channels)):
        res = locator.locate(int(ch), int(onset))
        if res is not None:
            r, phi = cartesian_to_polar(res[0], res[1], locator.radius)
            hits.append((int(onset), float(res[0]), float(res[1]),
                         float(r), float(phi)))
    return hits


def run(streams: int = 8, seconds: float = 1.0, mesh=None, device=None,
        log=print) -> dict:
    """The demo's steps: the fleet, one sharded detection over ``mesh``
    (default ``parallel.default_mesh`` on ``device``, None = the card),
    then per stream the host locator and a POSD session.  Returns the
    dense events, the located hits, the matched count, the sessions
    written and the host seconds of each step."""
    mesh = default_mesh(device=device) if mesh is None else mesh
    audio, polar, truths = synth_fleet(streams, seconds)
    # the demo's per-stream detector: 3 channels, no high-pass
    static, params, state = detector_init(DetectorConfig(
        n_channels=3, block_size=BLOCK, hipass_freq=0.0, sr=SR), mesh.device)
    log(f"mesh: {dict(mesh.shape)} on {mesh.device}; {streams} streams of "
        f"{audio.shape[1]} samples")
    seconds_ = {}
    t0 = time.perf_counter()
    on, deltas, _ = detect_offline_sharded(static, params, state,
                                           torch.as_tensor(audio), mesh)
    on, deltas = on.cpu().numpy(), deltas.cpu().numpy()
    seconds_["detect"] = time.perf_counter() - t0
    log(f"detected {int(on.sum())} onsets across {streams} streams")
    locator = Multilaterate3D(polar, drum_diameter=DIAMETER,
                              medium="drumhead", sr=SR)
    located, matched, n_hits = [], 0, 0
    seconds_["locate"] = seconds_["save"] = 0.0
    with tempfile.TemporaryDirectory() as td:
        for s in range(streams):
            t0 = time.perf_counter()
            hits = locate_stream(locator, on[s], deltas[s])
            t1 = time.perf_counter()
            posd.save_session(
                Path(td), f"stream{s}", audio[s], SR,
                posd.make_hits(
                    np.asarray([h[0] for h in hits], dtype=np.int64),
                    locations=np.asarray([[h[3], h[4]] for h in hits],
                                         np.float32),
                ),
            )
            seconds_["locate"] += t1 - t0
            seconds_["save"] += time.perf_counter() - t1
            located.append(hits)
            matched += sum(
                any(np.hypot(h[1] - x, h[2] - y) < 2.0 for h in hits)
                for (_, x, y) in truths[s])
            n_hits += len(truths[s])
        sessions = len(posd.find_sessions(td))
    log(f"wrote {sessions} POSD sessions")
    log(f"located {matched}/{n_hits} hits within 2 cm")
    return dict(audio=audio, truths=truths, on=on, deltas=deltas,
                located=located, matched=matched, n_hits=n_hits,
                sessions=sessions, seconds=seconds_)


def gate(res: dict) -> bool:
    """At least 0.75 of the hits within 2 cm and one session per stream."""
    return (res["matched"] >= 0.75 * res["n_hits"]
            and res["sessions"] == len(res["audio"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    _cuda.reset_counts()
    res = run(args.streams, args.seconds,
              device="cpu" if args.cpu else None)
    # the kernel that ran: launches on the card, plain calls on the CPU
    print("kernels: " + ", ".join(
        f"{k.name} {k.launches} launches, {k.plain_calls} plain"
        for k in _cuda.KERNELS if k.launches or k.plain_calls))
    print("host seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in res["seconds"].items()))
    ok = gate(res)
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
