"""The serve application (port of ``onset_fingerprinting_tpu.realtime.main``;
reference: realtime/main.py:20-105).

Load a saved setup (sensor geometry and location model), build the engine
on the card (the learned locator inside its locate kernel), arm a
whole-surface ``ParameterChange`` mapping phi to an FX parameter, attach
the analysis side channel, and run: against a live PortAudio stream where
sounddevice exists, otherwise against a WAV file streamed through the
native block executor (``runtime_native``).

The JAX package enables JAX's persistent compile cache here; the port's
counterpart is ``ops/_cuda``'s build cache (libraries keyed by a hash of
source and flags under ``build/torch_kernels/``), which needs no switch.

Run from the repository root:

    python -m onset_fingerprinting_torch.realtime.main <setup_dir> \
        [--wav f.wav] [--sr 96000] [--cpu]
"""

from __future__ import annotations

import argparse
import queue as _queue
import sys
import time
from pathlib import Path

import numpy as np

from onset_fingerprinting_torch.core.config import DetectorConfig
from onset_fingerprinting_torch.locate.multilaterate import Multilaterate3D
from onset_fingerprinting_torch.realtime.actions import (
    Actions,
    BackCaptureTrigger,
    Bounds,
    FxParams,
    ParameterChange,
    ParameterMapper,
    RecordTrigger,
)
from onset_fingerprinting_torch.realtime.engine import RealtimeEngine
from onset_fingerprinting_torch.realtime.setup_io import load_setup


def build_engine(setup_dir: str | Path, sr: int = 96000,
                 blocksize: int = 128, fx=None, rt_cfg=None,
                 device=None) -> RealtimeEngine:
    """Setup → locator → engine on ``device`` (None = the card) → actions
    (realtime/main.py:66-98 of the reference)."""
    conf, model = load_setup(Path(setup_dir), device=device)
    model_input = conf.get("model_input", "arrival")
    locator_kw = {}
    if conf.get("drum_diameter"):  # the head size (cm) of the legality maps
        locator_kw["drum_diameter"] = float(conf["drum_diameter"])
    if conf.get("feasibility_tols"):
        locator_kw["feasibility_tols"] = tuple(
            float(t) for t in conf["feasibility_tols"])
    locator = Multilaterate3D(
        sensor_locations=conf["sensor_locations"], sr=sr,
        medium=conf["medium"], c=conf["c"], model=model,
        model_input=model_input, **locator_kw)
    cfg = DetectorConfig(
        n_channels=len(conf["sensor_locations"]), block_size=blocksize,
        hipass_freq=0.0, fast_attack=0.3, fast_release=800.0,
        slow_attack=8000.0, slow_release=8000.0, on_threshold=0.45,
        off_threshold=0.45, cooldown=1323, sr=sr)
    if fx is None:
        fx = FxParams(["svf_cutoff_hz"])
    actions = Actions()
    b = Bounds(phi=[0, 360])
    pm = ParameterMapper.from_bounds_fx(b, fx, "phi", ["svf_cutoff_hz"])
    actions.append(ParameterChange([b], fx, [pm]))
    # the saved FCNN runs inside the locate kernel: no host round trip
    engine = RealtimeEngine(cfg, locator, actions=actions, fx=[fx],
                            model=model, model_input=model_input,
                            device=device)
    # the analysis side channel (the reference's AnalysisOnDemand process,
    # realtime/main.py:72-76)
    engine.attach_analysis(rt_cfg)
    return engine


def drain_plans(engine: RealtimeEngine, capture_dir=None) -> bool:
    """Handle pending plan-queue triggers: the reference's plan_callback
    thread (realtime/main.py:20-41) as a synchronous drain between
    blocks.  A RecordTrigger toggles recording (the start quantized to a
    strong onset, the end extrapolated to whole beats with the BPM); a
    BackCaptureTrigger dumps the audio ring to ``capture_dir``.  Triggers
    whose ``at_sample`` is still ahead wait.  Returns False once a quit
    sentinel (None or a bool) was seen."""
    alive = True
    deferred = []
    while True:
        try:
            trig = engine.actions.plans.get_nowait()
        except _queue.Empty:
            break
        if trig is None or isinstance(trig, bool):
            alive = False
            continue
        at = getattr(trig, "at_sample", None)
        if at is not None and engine.current_index < at:
            deferred.append(trig)
            continue
        if isinstance(trig, RecordTrigger):
            if not engine.recording_active:
                start = engine.start_recording()
                print(f"recording started @ sample {start}")
            else:
                start, end, bpm = engine.stop_recording()
                print(f"recording [{start}:{end}] "
                      f"({(end - start) / engine.cfg.sr:.2f} s) "
                      f"bpm={bpm:.1f}")
        elif isinstance(trig, BackCaptureTrigger) and capture_dir is not None:
            out = engine.analysis.save_audio_rotating(capture_dir)
            print(f"captured ring -> {out}")
    for trig in deferred:
        engine.actions.plans.put_nowait(trig)
    return alive


def run_wav(engine: RealtimeEngine, wav: str | Path, capture_dir=None,
            on_hit=None, depth: int = 32, stop_timeout: float = 30.0
            ) -> dict:
    """Stream every full block of a WAV through the native executor at
    audio rate.

    The executor's thread only enqueues each block
    (``process_pipelined``; a full queue of ``depth`` blocks drops one);
    the engine's dispatcher thread replays the step with no host read;
    this thread writes the audio into the native ring, drains the device
    event queue (``harvest``: one packed read), runs the actions, paces the
    analysis side channel and drains the plan queue.  ``on_hit(onset,
    Location)`` sees every harvested hit.  Unlike the JAX package's, no
    block of zeros goes first to compile the step: the engine built its
    kernels and captured its step when it was constructed.  Returns the
    executor's counts and latency statistics."""
    from onset_fingerprinting_torch.core.audio_io import read_wav
    from onset_fingerprinting_torch.runtime_native import (
        NativeExecutor,
        NativeRing,
    )

    audio, sr = read_wav(wav)
    if audio.ndim == 1:
        audio = audio[:, None]
    c = engine.cfg.n_channels
    bsz = engine.cfg.block_size
    audio = np.ascontiguousarray(audio[:, :c], np.float32)
    engine.start_pipeline(depth=depth)

    def on_block(block, idx):
        engine.process_pipelined(block)

    out_buf = np.zeros((bsz, engine.monitor_channels), np.float32)

    def drain():
        for onset, loc in engine.harvest():
            print(f"hit @ sample {onset}: {loc}")
            engine.actions.run(out_buf, loc)
            if on_hit is not None:
                on_hit(onset, loc)
        if engine.analysis is not None:
            engine.analysis.poll()
        drain_plans(engine, capture_dir)

    ring = NativeRing(sr * 4, c)
    ex = NativeExecutor(ring, bsz, on_block, sample_rate=float(sr))
    ex.start()
    chunk = 4096
    n_full = (len(audio) // bsz) * bsz
    for i in range(0, n_full, chunk):
        ring.write(audio[i: min(i + chunk, n_full)])
        time.sleep(chunk / sr)
        drain()
    while ring.readable >= bsz:
        time.sleep(0.05)
        drain()
    ex.stop()
    engine.stop_pipeline(timeout=stop_timeout)
    drain()
    stats = ex.latency_stats()
    stats.update(blocks=ex.blocks_processed, misses=ex.deadline_misses,
                 drops=engine.pipeline_drops)
    print(f"{ex.blocks_processed} blocks, {ex.deadline_misses} deadline "
          f"misses, {engine.pipeline_drops} drops, p50 "
          f"{stats['p50_us'] / 1000:.3f} ms p99 "
          f"{stats['p99_us'] / 1000:.3f} ms")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("setup_dir")
    ap.add_argument("--wav", default=None,
                    help="stream a wav instead of live audio")
    ap.add_argument("--sr", type=int, default=96000)
    ap.add_argument("--cpu", action="store_true",
                    help="run the engine's plain version on the CPU")
    args = ap.parse_args(argv)
    engine = build_engine(args.setup_dir, sr=args.sr,
                          device="cpu" if args.cpu else None)
    if args.wav:
        run_wav(engine, args.wav)
        return 0
    try:
        stream = engine.stream()
    except RuntimeError as e:
        print(f"{e}; use --wav for file streaming", file=sys.stderr)
        return 2
    from onset_fingerprinting_torch.realtime.analysis import AnalysisWorker

    with stream:
        print("serving -- ctrl-c to stop")
        worker = AnalysisWorker(engine.analysis).start()
        out_buf = np.zeros((engine.cfg.block_size, engine.monitor_channels),
                           np.float32)
        try:
            # the plan drain loop (the reference's plan_callback thread)
            while drain_plans(engine):
                for onset, loc in engine.harvest():
                    engine.actions.run(out_buf, loc)
                time.sleep(0.05)
        finally:
            worker.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
