"""A simulated realtime serve loop: a synthetic 3-sensor drum stream
through the realtime engine, every located hit classified from the
device audio ring.

Port of ``examples/realtime_sim_demo.py``'s stream and configuration:
3 sensors at 96 kHz, 128-sample blocks, no high-pass, the coupled
off-gate; ``Multilaterate3D`` with feasibility tiers of 1 and 2 cm; a
16 s ring, a 512-slot event queue, 8 locator slots; the classifier on
512-sample windows, 384 before the onset, 16 hits per call.  The demo's
trained zone CNN is a JAX model; here the classifier is the flagship
CCCNN in bfloat16 for 3 channels and 512-sample windows, with random
weights drawn in flax layout and carried across (``workload.
cccnn_flax_params``, ``models.jax_import``), so its predictions are
checked for agreement, not for zones.  The native ring, the block
executor's realtime pacing and sounddevice are left out: blocks go in
as fast as the engine takes them.

Run on the card (full size) or on the CPU at a small size::

    python -m onset_fingerprinting_torch.tools.realtime_sim
    python -m onset_fingerprinting_torch.tools.realtime_sim --cpu
    python -m onset_fingerprinting_torch.tools.realtime_sim --cc-refine

It prints the locate gates (at least 95% of the strikes located, median
error at most 1 cm, the demo's own) and exits 1 if they fail.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from onset_fingerprinting_torch.core.config import DetectorConfig
from onset_fingerprinting_torch.core.coords import (
    speed_of_sound,
    spherical_to_cartesian,
)
from onset_fingerprinting_torch.locate.multilaterate import Multilaterate3D
from onset_fingerprinting_torch.models.cccnn import CCCNN
from onset_fingerprinting_torch.models.jax_import import (
    cccnn_state_dict_from_flax,
)
from onset_fingerprinting_torch.realtime.engine import RealtimeEngine
from onset_fingerprinting_torch.workload import FLAGSHIP, cccnn_flax_params

SR = 96000
DIAM = 14 * 2.54
N_ZONES = 3  # angular sectors
#: the classifier's window: it must cover the largest inter-sensor lag,
#: anchored at the completing (last) arrival's onset
CLS_WINDOW = 512
CLS_PRE = 384
CLS_CAPACITY = 16
#: the demo's feasibility cascade (1 → 2 cm)
FEASIBILITY_TOLS = (1.0, 2.0)
RING_SECONDS = 16.0
EVENT_QUEUE = 512
#: the warmup: the stream's first quarter second
WARMUP = SR // 4
#: blocks between harvests
HARVEST_EVERY = 64
#: the locate gates (realtime_sim_demo.py, its CPU bounds)
MIN_LOCATED = 0.95
MAX_MEDIAN_CM = 1.0
#: the classifier: the flagship CCCNN for 3 channels
CLASSIFIER = dict(FLAGSHIP, channels=3, output_size=N_ZONES)


def zone_of(x: float, y: float) -> int:
    return int(np.degrees(np.arctan2(y, x)) % 360.0 // (360 // N_ZONES))


def _geometry():
    radius = DIAM / 2
    polar = [(0.9, 0.0, 0.0), (0.9, 120.0, 0.0), (0.9, 240.0, 0.0)]
    xyz = [tuple(float(v) for v in spherical_to_cartesian(r * radius, phi,
                                                          th))
           for (r, phi, th) in polar]
    c = speed_of_sound(100, medium="drumhead")
    return radius, polar, xyz, c


def _burst(amp: float = 0.6) -> np.ndarray:
    t = np.arange(600)
    return (np.sin(2 * np.pi * 5000 / SR * t) * np.exp(-t / 150) * amp
            ).astype(np.float32)


def synth_stream(seconds: float, seed: int = 0):
    """``(audio [n, 3] float32, polar sensor positions, hits)``: a strike
    every quarter second at a random point of the head (r in 0.2-0.74 of
    the radius), each sensor's burst delayed by its distance; ``hits`` are
    ``(onset sample, x, y, zone)``."""
    radius, polar, xyz, c = _geometry()
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    audio = rng.normal(0, 1e-4, (n, 3)).astype(np.float32)
    burst = _burst()
    hits = []
    for base in range(SR // 4, n - 6000, SR // 4):
        r = np.sqrt(rng.uniform(0.04, 0.55)) * radius
        ang = rng.uniform(0, 2 * np.pi)
        x, y = r * np.cos(ang), r * np.sin(ang)
        for ch, (sx, sy, _) in enumerate(xyz):
            d = np.hypot(x - sx, y - sy)
            s = base + int(round(d / c * SR))
            audio[s: s + 600, ch] += burst
        hits.append((base, x, y, zone_of(x, y)))
    return audio, polar, hits


def build_engine(device=None, ring_seconds: float = RING_SECONDS,
                 event_queue: int = EVENT_QUEUE,
                 cc_refine: bool = False) -> RealtimeEngine:
    """The demo's engine (``device=None``: the card); ``cc_refine`` turns
    on the locator's onset refinement by cross-correlation."""
    _, polar, _, _ = _geometry()
    cfg = DetectorConfig(n_channels=3, block_size=128, hipass_freq=0.0,
                         sr=SR)
    locator = Multilaterate3D(polar, drum_diameter=DIAM, medium="drumhead",
                              sr=SR, feasibility_tols=FEASIBILITY_TOLS)
    return RealtimeEngine(cfg, locator, ring_seconds=ring_seconds,
                          event_queue=event_queue, cc_refine=cc_refine,
                          device=device)


def classifier(seed: int = 0, dtype=torch.bfloat16) -> CCCNN:
    """The flagship CCCNN for 3 channels on 512-sample windows, random
    weights from ``seed`` in flax layout."""
    model = CCCNN(input_size=CLS_WINDOW, dtype=dtype, **CLASSIFIER)
    model.load_state_dict(cccnn_state_dict_from_flax(
        cccnn_flax_params(CLASSIFIER, seed=seed, window=CLS_WINDOW)))
    return model.eval()


def blocks_of(audio: np.ndarray):
    """The stream's 128-sample blocks, from its start (the engine's sample
    counter then counts stream samples)."""
    return [audio[i: i + 128] for i in range(0, len(audio) - 127, 128)]


def run(engine: RealtimeEngine, audio: np.ndarray, classify: bool = True):
    """Warm the engine on the first quarter second, then drive every block
    from the stream's start (as the demo feeds its ring) through
    ``process_nosync`` and harvest every ``HARVEST_EVERY`` blocks,
    classifying each harvested batch right away.  Returns ``(events
    [(onset, Location)], predictions [n, out] or None, wall seconds of the
    block loop)``."""
    engine.warmup(audio[:WARMUP])
    events, preds = [], []
    t0 = time.perf_counter()
    for i, blk in enumerate(blocks_of(audio)):
        engine.process_nosync(blk)
        if (i + 1) % HARVEST_EVERY == 0:
            new = engine.harvest()
            events.extend(new)
            if classify and new:
                preds.append(engine.classify_hits(new))
    new = engine.harvest()
    events.extend(new)
    if classify and new:
        preds.append(engine.classify_hits(new))
    wall = time.perf_counter() - t0
    return events, (np.concatenate(preds) if preds else None), wall


def locate_gates(hits, events):
    """The demo's acceptance: each synthesized strike matched to the
    nearest located hit within 2400 samples.  Returns ``(matched, median
    error in cm, passed)``."""
    errs = []
    for base, x, y, _ in hits:
        best = min((np.hypot(loc.x - x, loc.y - y)
                    for onset, loc in events if abs(onset - base) < 2400),
                   default=None)
        if best is not None:
            errs.append(best)
    med = float(np.median(errs)) if errs else float("nan")
    ok = len(errs) >= MIN_LOCATED * len(hits) and med <= MAX_MEDIAN_CM
    return len(errs), med, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU (default 1 s)")
    ap.add_argument("--seconds", type=float, default=None,
                    help="stream length (default 20 on the card)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cc-refine", action="store_true",
                    help="refine each onset by cross-correlation in the "
                    "locator")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    seconds = args.seconds or (1.0 if args.cpu else 20.0)
    audio, _, hits = synth_stream(seconds, args.seed)
    engine = build_engine(device, cc_refine=args.cc_refine)
    engine.attach_classifier(classifier(args.seed), window=CLS_WINDOW,
                             pre=CLS_PRE, capacity=CLS_CAPACITY)
    events, preds, wall = run(engine, audio)
    matched, med, ok = locate_gates(hits, events)
    n_blocks = len(blocks_of(audio))
    where = "cpu" if args.cpu else torch.cuda.get_device_name(0)
    print(f"{where}: {n_blocks} blocks in {wall:.2f} s "
          f"({1e3 * wall / n_blocks:.3f} ms per block incl. harvests and "
          f"classification); located {len(events)} hits, matched "
          f"{matched}/{len(hits)} strikes, median error {med:.3f} cm; "
          f"predictions {None if preds is None else preds.shape}, "
          f"{engine.classify_stale} stale")
    ok = ok and preds is not None and bool(np.isfinite(preds).all())
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
