"""Where the serve loop's audio thread waits: the native executor at
realtime pacing over the realtime demo's stream (``tools/realtime_sim``),
its Python callback's latency as the serve loop's other threads join one
at a time:

- ``noop``: the callback does nothing and no other thread runs: the cost
  of entering Python from the executor's thread;
- ``dispatch``: the callback enqueues each block
  (``engine.process_pipelined``) and the engine's dispatcher thread runs
  the steps;
- ``harvest``: the same and the harvester thread at the serve loop's
  period (``realtime_sim.harvest_period``);
- ``serve``: the serve loop's stream (``realtime_sim.serve_stream``): the
  same and the classifier thread.

Each configuration streams the same ``--seconds`` of the demo's stream
through one engine (the serve loop's, zone CNN attached, warmed).  Run on
the card from the repository root, or on the CPU at a small size::

    python -m onset_fingerprinting_torch.tools.serve_split
    python -m onset_fingerprinting_torch.tools.serve_split --cpu --seconds 1

It prints one JSON line per configuration: the executor's blocks,
deadline misses and p50/p99/max in ms, and ``Metrics``' enqueue and
dispatch p50/p99 where the engine ran.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from onset_fingerprinting_torch.runtime_native import (
    NativeExecutor,
    NativeRing,
)
from onset_fingerprinting_torch.tools import realtime_sim as sim
from onset_fingerprinting_torch.utils.metrics import Metrics

CONFIGS = ("noop", "dispatch", "harvest", "serve")


def executor_stream(engine, audio, callback, harvest_period=None) -> dict:
    """``audio`` through the native ring and executor at realtime pacing,
    ``callback`` on the executor's thread; with ``harvest_period`` the
    engine's harvester runs beside it.  Returns the executor's numbers."""
    ring = NativeRing(sim.NATIVE_RING, 3)
    ex = NativeExecutor(ring, 128, callback, sample_rate=float(sim.SR))
    if harvest_period is not None:
        engine.start_harvester(lambda ev: None, period=harvest_period)
    try:
        ex.start()
        fed = sim.feed(ring, ex, audio)
    finally:
        ex.stop()
        engine.stop_harvester()
    return dict(fed=fed, blocks=ex.blocks_processed,
                deadline_misses=ex.deadline_misses, stats=ex.latency_stats())


def run_config(name: str, engine, audio, floor_ms: float) -> dict:
    """One configuration of :data:`CONFIGS` on a warmed serve engine."""
    cpu = engine.device.type == "cpu"
    engine.metrics = Metrics()
    if name == "serve":
        res = sim.serve_stream(engine, audio, floor_ms)
    elif name == "noop":
        res = executor_stream(engine, audio, lambda block, idx: None)
    else:
        engine.start_pipeline(depth=16384 if cpu else 512)
        try:
            res = executor_stream(
                engine, audio,
                lambda block, idx: engine.process_pipelined(block),
                sim.harvest_period(floor_ms, cpu) if name == "harvest"
                else None)
        finally:
            engine.stop_pipeline(timeout=30 + (
                0.25 * engine.pipeline_backlog if cpu else 0))
    lat = engine.metrics.summary()["latency"]
    out = dict(config=name, blocks=res["blocks"], fed=res["fed"],
               deadline_misses=res["deadline_misses"],
               audio_p50_ms=res["stats"]["p50_us"] / 1e3,
               audio_p99_ms=res["stats"]["p99_us"] / 1e3,
               audio_max_ms=res["stats"]["max_us"] / 1e3)
    for key in ("engine.enqueue", "engine.dispatch"):
        if key in lat:
            out[key] = [lat[key]["p50_ms"], lat[key]["p99_ms"]]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="the plain engine on the CPU")
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="the stream's length per configuration")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    audio, _, _ = sim.synth_stream(args.seconds, args.seed)
    engine, _, _ = sim.serve_engine("cpu" if args.cpu else None, args.seed)
    engine.warmup(audio[: sim.WARMUP])
    floor_ms = sim.serve_measures(engine, audio)["floor_ms"]
    where = ("cpu" if args.cpu else torch.cuda.get_device_name(0))
    for name in CONFIGS:
        print(json.dumps(dict(run_config(name, engine, audio, floor_ms),
                              device=where, floor_ms=floor_ms)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
