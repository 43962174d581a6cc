"""A simulated realtime serve loop: a synthetic 3-sensor drum stream
through the realtime engine, every located hit classified from the
device audio ring.

Port of ``examples/realtime_sim_demo.py``'s stream and configuration:
3 sensors at 96 kHz, 128-sample blocks, no high-pass, the coupled
off-gate; ``Multilaterate3D`` with feasibility tiers of 1 and 2 cm; a
16 s ring, a 512-slot event queue, 8 locator slots; the classifier on
512-sample windows, 384 before the onset, 16 hits per call.

Two entries:

- :func:`run` feeds the blocks as fast as the engine takes them through
  ``process_nosync``, harvests every 64 blocks and classifies each
  harvest with the flagship CCCNN in bfloat16 for 3 channels (random
  weights drawn in flax layout and carried across, ``workload.
  cccnn_flax_params``, ``models.jax_import``: its predictions are checked
  for agreement, not for zones).
- :func:`serve` is the demo's serving stack: the zone CNN trained on the
  demo's windows (:func:`zone_windows`), the engine with ``utils.metrics.
  Metrics``, a producer thread writing the stream into the native ring
  (``runtime_native.NativeRing``) at realtime pacing, the native block
  executor whose thread enqueues each block for the pipelined
  dispatcher, the harvester thread, a classifier thread, and a
  ParameterChange action per located hit.  Beside the stream it measures
  the readback floor (host clock) and, on the card, the device time of
  the event pack, of a step (in a graph of steps, as ``tools/step_bench``
  times it) and of a classify batch: their sum is the north-star
  estimate of one hit's localize + classify.

Both hold the demo's gates, by device: on the card at least 99% of the
strikes located at a median error of at most 0.2 cm; on the CPU, whose
engine shares the host's cores with the stream's threads, 95% and 1 cm.
:func:`serve` adds the zone accuracy (>= 0.8), zero dropped blocks and
harvest overflows and, on the card, the audio thread's p99 under the
block's budget, the hit latency's p50 under its backlog bound and the
north-star estimate under 1 ms.  Run on the card (full size) or on the
CPU at a small size::

    python -m onset_fingerprinting_torch.tools.realtime_sim
    python -m onset_fingerprinting_torch.tools.realtime_sim --cpu
    python -m onset_fingerprinting_torch.tools.realtime_sim --cc-refine
    python -m onset_fingerprinting_torch.tools.realtime_sim --serve
    python -m onset_fingerprinting_torch.tools.realtime_sim --serve --cpu \
        --seconds 1.5

Each exits 1 if a gate fails.
"""

from __future__ import annotations

import argparse
import collections
import itertools
import json
import sys
import threading
import time
import traceback

import numpy as np
import torch

from onset_fingerprinting_torch.core.config import DetectorConfig, TrainConfig
from onset_fingerprinting_torch.core.coords import (
    speed_of_sound,
    spherical_to_cartesian,
)
from onset_fingerprinting_torch.locate.multilaterate import Multilaterate3D
from onset_fingerprinting_torch.models.cccnn import CCCNN
from onset_fingerprinting_torch.models.cnn import CNN
from onset_fingerprinting_torch.models.jax_import import (
    cccnn_state_dict_from_flax,
)
from onset_fingerprinting_torch.models.train import Trainer
from onset_fingerprinting_torch.realtime.actions import (
    Actions,
    Bounds,
    FxParams,
    ParameterChange,
    ParameterMapper,
)
from onset_fingerprinting_torch.realtime.engine import (
    RealtimeEngine,
    _pack_events,
)
from onset_fingerprinting_torch.utils.metrics import Metrics
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
#: the demo's locate gates (realtime_sim_demo.py:618-619), by device:
#: (least share of the strikes located, largest median error in cm); the
#: CPU's engine shares the host's cores with the stream's threads
LOCATE_BARS = {"cuda": (0.99, 0.2), "cpu": (0.95, 1.0)}
#: the demo's zone-accuracy gate over the served hits
MIN_ZONE_ACCURACY = 0.8
#: the north star: one hit's localize + classify on the card, in ms
NORTH_STAR_MS = 1.0
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
                 event_queue: int = EVENT_QUEUE, cc_refine: bool = False,
                 actions=None, metrics=None) -> RealtimeEngine:
    """The demo's engine (``device=None``: the card); ``cc_refine`` turns
    on the locator's onset refinement by cross-correlation."""
    _, polar, _, _ = _geometry()
    cfg = DetectorConfig(n_channels=3, block_size=128, hipass_freq=0.0,
                         sr=SR)
    locator = Multilaterate3D(polar, drum_diameter=DIAM, medium="drumhead",
                              sr=SR, feasibility_tols=FEASIBILITY_TOLS)
    return RealtimeEngine(cfg, locator, actions=actions, metrics=metrics,
                          ring_seconds=ring_seconds, event_queue=event_queue,
                          cc_refine=cc_refine, device=device)


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


def match_strikes(hits, events):
    """Each synthesized strike matched to the nearest located hit within
    2400 samples (the demo's matching): ``[(strike index, onset of its
    hit, error in cm)]`` of the matched strikes."""
    out = []
    for i, (base, x, y, _) in enumerate(hits):
        best = min(((np.hypot(ev[1].x - x, ev[1].y - y), ev[0])
                    for ev in events if abs(ev[0] - base) < 2400),
                   default=None)
        if best is not None:
            out.append((i, best[1], best[0]))
    return out


def locate_gates(hits, events, cpu: bool = False):
    """The demo's locate acceptance at its bars for the device
    (:data:`LOCATE_BARS`).  Returns ``(matched, median error in cm,
    passed)``."""
    errs = [e for _, _, e in match_strikes(hits, events)]
    med = float(np.median(errs)) if errs else float("nan")
    min_frac, med_cm = LOCATE_BARS["cpu" if cpu else "cuda"]
    ok = len(errs) >= min_frac * len(hits) and med <= med_cm
    return len(errs), med, ok


# -- the demo's serving stack ---------------------------------------------

#: the serve loop's zone CNN and its training (realtime_sim_demo.py:162-168)
ZONE_CNN = dict(output_size=N_ZONES, layer_sizes=(8, 16), kernel_size=7,
                pool=True, dropout_rate=0.0)
ZONE_TRAIN = TrainConfig(lr=2e-3, num_epochs=250, min_epochs=0,
                         patience=250, loss="xent", seed=0, optimizer="adam")
ZONE_EPOCHS_PER_STEP = 50
#: the native ring's frames (4 s)
NATIVE_RING = SR * 4
#: the producer's writes: 1024 frames (8 blocks) a time, as the demo's
PRODUCER_CHUNK = 1024
#: --fast: the producer's pace (4x realtime)
FAST_PACE = 0.25
#: device-timed repeats beside the stream: event packs, classify batches,
#: steps in one graph
PACKS, CLASSIFIES, GRAPH_STEPS = 200, 100, 256


def zone_windows(seed: int = 1, n_per_zone: int = 120):
    """The demo's training windows for the zone classifier
    (realtime_sim_demo.py:117-160): ``(x [n, 3, CLS_WINDOW] float32,
    zones [n] int32)``.  A window is anchored at the completing (last)
    arrival's onset, ``CLS_PRE`` samples in, with +-8 samples of jitter;
    the other channels' bursts start earlier by their lags."""
    radius, _, xyz, c = _geometry()
    rng = np.random.default_rng(seed)
    burst = _burst()
    xs, ys = [], []
    for _ in range(n_per_zone * N_ZONES):
        r = np.sqrt(rng.uniform(0.04, 0.55)) * radius
        ang = rng.uniform(0, 2 * np.pi)
        x, y = r * np.cos(ang), r * np.sin(ang)
        d = [np.hypot(x - sx, y - sy) for (sx, sy, _) in xyz]
        lags = np.array([int(round(di / c * SR)) for di in d])
        lags -= lags.max()
        w = rng.normal(0, 1e-4, (CLS_WINDOW, 3)).astype(np.float32)
        anchor = CLS_PRE + int(rng.integers(-8, 9))
        for ch in range(3):
            s = anchor + lags[ch]
            m = min(600, CLS_WINDOW - s)
            if m > 0 and s >= 0:
                w[s: s + m, ch] += burst[:m] * rng.uniform(0.8, 1.2)
        xs.append(w.T)
        ys.append(zone_of(x, y))
    return np.stack(xs), np.array(ys, np.int32)


def train_zone_classifier(device=None, seed: int = 1):
    """The demo's zone CNN trained with the port's ``Trainer`` on
    :func:`zone_windows`: ``(model in eval mode, train accuracy)``."""
    xs, ys = zone_windows(seed)
    trainer = Trainer(CNN(input_size=CLS_WINDOW, channels=3, **ZONE_CNN),
                      ZONE_TRAIN, device=device)
    state = trainer.fit((xs, ys), epochs_per_step=ZONE_EPOCHS_PER_STEP)
    acc = float(np.mean(np.argmax(trainer.predict(state, xs), axis=1) == ys))
    return state.module.eval(), acc


def serve_engine(device=None, seed: int = 0):
    """The demo's engine for :func:`serve`: ``Metrics``, a ParameterChange
    of an FX cutoff by the hit's angle, the 16 s ring, 512 event slots and
    the zone CNN attached.  Returns ``(engine, fx, zone CNN's train
    accuracy)``."""
    fx = FxParams(["cutoff"])
    b = Bounds(phi=[0, 360])
    actions = Actions()
    actions.append(ParameterChange(
        [b], fx, [ParameterMapper.from_bounds_fx(b, fx, "phi", ["cutoff"])]))
    engine = build_engine(device, actions=actions, metrics=Metrics())
    model, acc = train_zone_classifier(engine.device, seed + 1)
    engine.attach_classifier(model, window=CLS_WINDOW, pre=CLS_PRE,
                             capacity=CLS_CAPACITY)
    return engine, fx, acc


def serve_measures(engine: RealtimeEngine, audio: np.ndarray) -> dict:
    """What the demo measures beside the stream (realtime_sim_demo.py:
    240-440), on a warmed engine before the stream: ``floor_ms``, the
    median host time of 20 harvests; on the card also, by CUDA events,
    ``readback_ms`` (one event pack, median over PACKS packs, each between
    its own events behind a spin kernel), ``payload_bytes``, ``step_ms``
    (per step in one graph of GRAPH_STEPS steps over the stream's blocks,
    on a copy of the state) and ``classify_ms`` (one batch of
    ``CLS_CAPACITY`` hits, median over CLASSIFIES batches).  Nothing here
    changes the engine's state, and the kernels' launch counts are
    restored after it (capturing the graph of steps calls their wrappers
    without launching; its replays are measurements)."""
    floor = []
    for _ in range(20):
        t0 = time.perf_counter()
        engine.harvest()
        floor.append(time.perf_counter() - t0)
    out = dict(floor_ms=1e3 * float(np.median(floor)))
    if engine.device.type != "cuda":
        return out
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.tools.step_bench import (
        per_launch_ms,
        step_graph,
    )

    counts = [(k, k.launches, collections.Counter(k.variants))
              for k in _cuda.KERNELS]
    st, dev = engine.state, engine.device
    try:
        with engine._on_stream():
            ons = (st.ev_onsets[None, :] + torch.arange(
                PACKS, dtype=torch.int32, device=dev)[:, None])
            out["readback_ms"] = per_launch_ms(lambda i: _pack_events(
                st.ev_count, st.ev_points, ons[i], st.ev_emits), PACKS)[0]
            out["payload_bytes"] = 4 * _pack_events(
                st.ev_count, st.ev_points, st.ev_onsets, st.ev_emits).numel()
            cap = engine._classify_capacity
            cls_on = (torch.arange(CLASSIFIES, dtype=torch.int32,
                                   device=dev)[:, None] * 8
                      + torch.zeros(cap, dtype=torch.int32, device=dev))
            valid = torch.ones(cap, dtype=torch.bool, device=dev)
            # a batch is ~20 launches: chunks of 25 batches stay inside the
            # card's queue of pending launches, so that the host has
            # enqueued a chunk before the card reaches it (a full queue
            # paces the events at the host's rate: 0.512 ms a batch in
            # chunks of 100, on an H100 80GB HBM3 at 700 W)
            out["classify_ms"] = per_launch_ms(lambda i: engine._classify(
                st.ring, cls_on[i], valid), CLASSIFIES, chunk=25)[0]
            blocks = torch.as_tensor(np.stack(blocks_of(
                audio[WARMUP: WARMUP + 128 * GRAPH_STEPS])), device=dev)
            out["step_ms"] = step_graph(engine, blocks,
                                        GRAPH_STEPS)["step_ms"]
    finally:
        for k, launches, variants in counts:
            k.launches, k.variants = launches, variants
    return out


def serve_stream(engine: RealtimeEngine, audio: np.ndarray, floor_ms: float,
                 pace: float = 1.0) -> dict:
    """The demo's stream (realtime_sim_demo.py:441-491): a producer writes
    ``audio`` into the native ring 8 blocks a time against a wall-clock
    schedule (``pace`` 1 is realtime); the native executor's thread hands
    each 128-sample block to ``engine.process_pipelined``; the harvester
    thread drains located hits every ``max(4 x floor, 1 ms)`` (20 ms on
    the CPU) into a list, and a classifier thread classifies each from the
    device ring once the engine has written its whole window.  Then the
    pipeline and the harvester stop, a last harvest runs, and each hit runs
    the engine's actions.  Returns ``events
    [(onset, Location, host time harvested)]``, ``classified {onset: (zone,
    host time)}``, the executor's ``blocks``, ``deadline_misses`` and
    latency ``stats``, the blocks ``fed`` and ``thread_errors``."""
    from onset_fingerprinting_torch.runtime_native import (
        NativeExecutor,
        NativeRing,
    )

    cpu = engine.device.type == "cpu"
    located, lock = [], threading.Lock()
    classified, errors = {}, []
    cls_stop = threading.Event()

    def sink(ev):
        with lock:
            located.append((ev[0], ev[1], time.monotonic()))

    def classify_loop():
        done = 0
        try:
            while not cls_stop.is_set() or done < len(located):
                # a hit waits until the engine has written its whole window
                # into the ring (a window past the write head would be moved
                # back to end there); after the stream every window is in
                head = engine.current_index - (CLS_WINDOW - CLS_PRE)
                with lock:
                    pending = located[done:]
                if not cls_stop.is_set():
                    pending = list(itertools.takewhile(
                        lambda ev: ev[0] <= head, pending))
                if not pending:
                    time.sleep(0.005)
                    continue
                preds = engine.classify_hits([(o, l) for o, l, _ in pending])
                t_done = time.monotonic()
                # stale rows (the ring overwritten first) carry zeros and are
                # counted in engine.classify_stale: they are not scored
                for (onset, _, _), p, fresh in zip(
                        pending, preds, engine.last_classify_fresh):
                    if fresh:
                        classified[onset] = (int(np.argmax(p)), t_done)
                done += len(pending)
        except Exception:  # the thread's boundary: serve() fails its gate
            errors.append(traceback.format_exc())

    def on_block(block, idx):
        engine.process_pipelined(block)

    cls_thread = threading.Thread(target=classify_loop, daemon=True)
    ring = NativeRing(NATIVE_RING, 3)
    ex = NativeExecutor(ring, 128, on_block, sample_rate=float(SR))
    try:
        # a CPU engine computes on the host's cores: its queue must absorb
        # the whole stream, and a near-spinning harvester would starve it
        engine.start_pipeline(depth=16384 if cpu else 512)
        engine.start_harvester(sink, period=harvest_period(floor_ms, cpu))
        cls_thread.start()
        ex.start()
        fed = feed(ring, ex, audio, pace)
    finally:
        ex.stop()
        # the dispatcher drains its queue: ~50 ms a block for a CPU engine
        engine.stop_pipeline(timeout=30 + (0.25 * engine.pipeline_backlog
                                           if cpu else 0))
        engine.stop_harvester()
        for ev in engine.harvest():
            sink(ev)
        cls_stop.set()
        if cls_thread.is_alive():
            cls_thread.join(timeout=60 + (0.25 * len(located) if cpu
                                          else 0))
    if cls_thread.is_alive():
        errors.append("the classifier thread did not finish")
    with lock:
        events = list(located)
    for _, loc, _ in events:
        engine.actions.run(np.zeros((128, 2), np.float32), loc)
    return dict(events=events, classified=classified, fed=fed,
                blocks=ex.blocks_processed,
                deadline_misses=ex.deadline_misses,
                stats=ex.latency_stats(), thread_errors=errors)


def feed(ring, executor, audio: np.ndarray, pace: float = 1.0) -> int:
    """The demo's producer: write ``audio`` into the native ``ring``
    PRODUCER_CHUNK frames a time against a wall-clock schedule (``pace`` 1
    is realtime), then wait up to 15 s for the ``executor`` to take every
    block.  Returns the blocks fed."""
    fed = 0
    t_start = time.monotonic()
    for i in range(0, len(audio) - PRODUCER_CHUNK + 1, PRODUCER_CHUNK):
        ring.write(audio[i: i + PRODUCER_CHUNK])
        fed = i + PRODUCER_CHUNK
        delay = t_start + fed / SR * pace - time.monotonic()
        if delay > 0:
            time.sleep(delay)
    deadline = time.monotonic() + 15
    while (executor.blocks_processed < fed // 128
           and time.monotonic() < deadline):
        time.sleep(0.05)
    return fed // 128


def harvest_period(floor_ms: float, cpu: bool) -> float:
    """The demo's harvest period in seconds (realtime_sim_demo.py:451-455):
    four readback floors, at least 1 ms (20 ms on the CPU, whose engine
    computes on the cores the harvester would spin on)."""
    return max(4.0 * floor_ms / 1e3, 0.02 if cpu else 0.001)


def serve_summary(engine: RealtimeEngine, hits, res: dict,
                  measures: dict) -> dict:
    """The numbers the demo prints and gates, from :func:`serve_stream`'s
    result and :func:`serve_measures`."""
    events, classified = res["events"], res["classified"]
    matches = match_strikes(hits, events)
    zone = [classified[o][0] == hits[i][3] for i, o, _ in matches
            if o in classified]
    lat = np.asarray(engine.hit_latencies_ms, np.float64)
    fin = lat[np.isfinite(lat)]
    # hit latency incl. classify: the harvest latency + the classify
    # turnaround of the same hit
    cls_lat = [lat[k] + 1e3 * (classified[o][1] - t)
               for k, (o, _, t) in enumerate(events)
               if k < len(lat) and np.isfinite(lat[k]) and o in classified]
    disp = engine.metrics.summary()["latency"].get("engine.dispatch", {})
    s = dict(
        strikes=len(hits), located=len(events), matched=len(matches),
        median_cm=(float(np.median([e for _, _, e in matches]))
                   if matches else float("nan")),
        zone_correct=int(sum(zone)), zone_total=len(zone),
        stale=engine.classify_stale, thread_errors=res["thread_errors"],
        blocks=res["blocks"], fed=res["fed"],
        deadline_misses=res["deadline_misses"],
        drops=engine.pipeline_drops,
        overflows=engine.harvest_drops,
        budget_ms=engine.budget_ms,
        audio_p50_ms=res["stats"]["p50_us"] / 1e3,
        audio_p99_ms=res["stats"]["p99_us"] / 1e3,
        audio_max_ms=res["stats"]["max_us"] / 1e3,
        dispatch_p50_ms=disp.get("p50_ms", float("nan")),
        dispatch_p99_ms=disp.get("p99_ms", float("nan")),
        hit_p50_ms=float(np.percentile(fin, 50)) if fin.size else float("nan"),
        hit_p99_ms=float(np.percentile(fin, 99)) if fin.size else float("nan"),
        hit_cls_p50_ms=(float(np.percentile(cls_lat, 50)) if cls_lat
                        else float("nan")),
        **measures)
    if "step_ms" in measures:
        s["north_star_ms"] = (measures["step_ms"] + measures["readback_ms"]
                              + measures["classify_ms"])
    return s


def serve_failures(s: dict, cpu: bool, fast: bool = False) -> list[str]:
    """The demo's gates on a :func:`serve_summary` (realtime_sim_demo.py:
    520-640), by device: every failed one, worded."""
    fails = []
    min_frac, med_cm = LOCATE_BARS["cpu" if cpu else "cuda"]
    if s["matched"] < min_frac * s["strikes"]:
        fails.append(f"located {s['matched']}/{s['strikes']} < "
                     f"{min_frac:.0%}")
    if not s["median_cm"] <= med_cm:
        fails.append(f"median error {s['median_cm']:.3f} cm > {med_cm} cm")
    if s["thread_errors"]:
        fails.append(f"a serve thread failed: {s['thread_errors']}")
    if s["matched"] and not s["zone_total"]:
        fails.append("no located hit was classified")
    elif (s["zone_total"]
          and s["zone_correct"] < MIN_ZONE_ACCURACY * s["zone_total"]):
        fails.append(f"zone accuracy {s['zone_correct']}/{s['zone_total']}"
                     f" < {MIN_ZONE_ACCURACY}")
    if s["drops"]:
        fails.append(f"{s['drops']} dropped blocks")
    if s["overflows"]:
        fails.append(f"{s['overflows']} harvest overflows")
    if cpu:
        return fails
    # the card alone: the CPU's engine computes on the cores the audio
    # thread runs on, so neither its budget nor a backlog bound holds there
    if not s["audio_p99_ms"] < s["budget_ms"]:
        fails.append(f"audio-thread p99 {s['audio_p99_ms']:.3f} ms >= "
                     f"budget {s['budget_ms']:.3f} ms")
    if fast:
        return fails
    bound = 8.0 * max(s["floor_ms"], 1.0) + 16.0
    if not s["hit_p50_ms"] < bound:
        fails.append(f"hit-latency p50 {s['hit_p50_ms']:.3f} ms >= "
                     f"{bound:.0f} ms (device backlog)")
    if not s["north_star_ms"] < NORTH_STAR_MS:
        fails.append(f"north-star localize + classify "
                     f"{s['north_star_ms']:.3f} ms >= {NORTH_STAR_MS} ms")
    return fails


def serve_report(s: dict, metrics_report: str, log=print) -> None:
    """Print what the demo prints."""
    log(f"blocks: {s['blocks']} of {s['fed']} fed, audio-thread deadline "
        f"misses (>{s['budget_ms']:.3f} ms): {s['deadline_misses']}, "
        f"drops: {s['drops']}, harvest overflows: {s['overflows']}")
    log(f"audio-thread latency: p50 {s['audio_p50_ms']:.4f} ms, p99 "
        f"{s['audio_p99_ms']:.4f} ms, max {s['audio_max_ms']:.4f} ms")
    log(f"device dispatch: p50 {s['dispatch_p50_ms']:.4f} ms, p99 "
        f"{s['dispatch_p99_ms']:.4f} ms (Metrics 'engine.dispatch')")
    log(f"hit latency (completing block enqueued -> located on host): p50 "
        f"{s['hit_p50_ms']:.4f} ms, p99 {s['hit_p99_ms']:.4f} ms; incl. "
        f"classify p50 {s['hit_cls_p50_ms']:.4f} ms; readback floor "
        f"{s['floor_ms']:.4f} ms (host clock)")
    if "north_star_ms" in s:
        log(f"north-star estimate: step {s['step_ms']:.5f} + event readback "
            f"{s['readback_ms']:.5f} ({s['payload_bytes']} B) + classify "
            f"batch {s['classify_ms']:.5f} = {s['north_star_ms']:.5f} ms "
            f"(device times, CUDA events)")
    log(f"located {s['located']} hits; matched {s['matched']}/"
        f"{s['strikes']} strikes, median error {s['median_cm']:.4f} cm; "
        f"zone classifier {s['zone_correct']}/{s['zone_total']} correct, "
        f"{s['stale']} stale")
    log(metrics_report)


def serve(seconds: float = 60.0, seed: int = 0, device=None,
          fast: bool = False, log=print) -> tuple[bool, dict]:
    """The demo's serve loop end to end (``device=None``: the card):
    :func:`serve_engine`, the warmup on the first quarter second,
    :func:`serve_measures`, :func:`serve_stream` over ``seconds`` of the
    demo's stream (``fast``: at 4x realtime, the latency bounds not
    gated), :func:`serve_report` and :func:`serve_failures`.  Returns
    ``(passed, summary)``."""
    audio, _, hits = synth_stream(seconds, seed)
    engine, fx, acc = serve_engine(device, seed)
    log(f"zone classifier trained: {acc:.2f} train accuracy")
    engine.warmup(audio[:WARMUP])
    measures = serve_measures(engine, audio)
    res = serve_stream(engine, audio, measures["floor_ms"],
                       FAST_PACE if fast else 1.0)
    s = serve_summary(engine, hits, res, measures)
    serve_report(s, engine.metrics.report(), log)
    log(f"fx cutoff now {fx.parameters['cutoff'].raw_value:.3f}")
    fails = serve_failures(s, engine.device.type == "cpu", fast)
    for f in fails:
        log(f"FAIL: {f}")
    return not fails, s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU (default 1 s)")
    ap.add_argument("--seconds", type=float, default=None,
                    help="stream length (default 20 on the card, 60 with "
                    "--serve)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cc-refine", action="store_true",
                    help="refine each onset by cross-correlation in the "
                    "locator")
    ap.add_argument("--serve", action="store_true",
                    help="the demo's serving stack at realtime pacing")
    ap.add_argument("--fast", action="store_true",
                    help="with --serve: feed at 4x realtime (the latency "
                    "bounds not gated)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    if args.serve:
        from onset_fingerprinting_torch.ops import _cuda

        _cuda.reset_counts()
        ok, s = serve(args.seconds or (1.0 if args.cpu else 60.0), args.seed,
                      device, args.fast)
        # the summary and the kernels' (launches, plain calls), one line
        print(json.dumps({"serve": s, "launches": {
            k.name: [k.launches, k.plain_calls] for k in _cuda.KERNELS},
            "ring_writes": _cuda.ring_writes(_cuda.LOCATE_BLOCK.variants)}))
        print("PASS" if ok else "FAIL")
        return 0 if ok else 1
    seconds = args.seconds or (1.0 if args.cpu else 20.0)
    audio, _, hits = synth_stream(seconds, args.seed)
    engine = build_engine(device, cc_refine=args.cc_refine)
    engine.attach_classifier(classifier(args.seed), window=CLS_WINDOW,
                             pre=CLS_PRE, capacity=CLS_CAPACITY)
    events, preds, wall = run(engine, audio)
    matched, med, ok = locate_gates(hits, events, cpu=args.cpu)
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
