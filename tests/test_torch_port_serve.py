"""The realtime demo's serve loop in the port (``tools/realtime_sim.serve``)
on the CPU: the whole stack as a subprocess at realtime pacing under the
demo's CPU gates (as tests/test_sim_demo.py runs the demo), the gate
function's cases by device, and the zone classifier's training windows
equal to the demo's."""

import importlib.util
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from onset_fingerprinting_torch.realtime.actions import Location
from onset_fingerprinting_torch.tools import realtime_sim as sim

REPO = Path(__file__).resolve().parent.parent
#: the CPU serve run's stream: the plain engine takes ~50 ms a block on
#: one core, so 1.5 s (1125 blocks, 5 strikes: one zone miss stays inside
#: the 0.8 bar) keeps the run near a minute
SERVE_CPU_SECONDS = 1.5


def test_serve_cpu_passes_its_gates():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "onset_fingerprinting_torch.tools.realtime_sim",
         "--serve", "--cpu", "--seconds", str(SERVE_CPU_SECONDS)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-3000:]
    assert res.stdout.rstrip().endswith("PASS"), out[-3000:]
    assert "drops: 0, harvest overflows: 0" in res.stdout
    assert "matched 5/5 strikes" in res.stdout, out[-3000:]
    assert "engine.dispatch: p50" in res.stdout  # Metrics.report()


def test_native_executor_keeps_its_thread_state():
    """The executor's thread keeps one Python thread state across blocks
    (a thread-local set in one callback is there in the next): ctypes
    would otherwise make and free one per block."""
    import threading
    import time

    from onset_fingerprinting_torch.runtime_native import (
        NativeExecutor,
        NativeRing,
    )

    local, seen = threading.local(), []

    def on_block(block, idx):
        seen.append(getattr(local, "last", None))
        local.last = idx

    ring = NativeRing(4096, 3)
    ex = NativeExecutor(ring, 128, on_block, sample_rate=96000.0)
    ex.start()
    try:
        ring.write(np.zeros((128 * 8, 3), np.float32))
        deadline = time.monotonic() + 10
        while ex.blocks_processed < 8 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        ex.stop()
    assert seen == [None, 0, 1, 2, 3, 4, 5, 6]


@pytest.mark.parametrize("floor_ms, cpu, want", [
    (0.07, False, 0.001), (1.0, False, 0.004), (0.07, True, 0.02),
    (10.0, True, 0.04)])
def test_harvest_period_is_the_demos(floor_ms, cpu, want):
    assert sim.harvest_period(floor_ms, cpu) == pytest.approx(want)


@pytest.mark.parametrize("config", ["noop", "dispatch", "harvest"])
def test_serve_split_configs_on_the_cpu(config):
    """tools/serve_split's executor configurations on a small CPU engine:
    every fed block reaches the callback, and the engine's enqueue and
    dispatch are read where it ran."""
    from onset_fingerprinting_torch.tools import serve_split

    audio, _, _ = sim.synth_stream(0.3, 0)
    engine = sim.build_engine("cpu")
    engine.warmup(audio[: sim.WARMUP])
    out = serve_split.run_config(config, engine, audio, floor_ms=0.1)
    assert out["config"] == config
    assert out["blocks"] == out["fed"] == len(audio) // 1024 * 8
    assert ("engine.dispatch" in out) == (config != "noop")
    assert ("engine.enqueue" in out) == (config != "noop")
    assert 0 < out["audio_p50_ms"] <= out["audio_p99_ms"]


def summary(**kw):
    """A serve summary that passes every gate on either device."""
    s = dict(strikes=100, matched=100, median_cm=0.05, thread_errors=[],
             zone_correct=90, zone_total=100, drops=0, overflows=0,
             audio_p99_ms=0.2, budget_ms=128 / 96000 * 1e3, floor_ms=0.1,
             hit_p50_ms=2.0, north_star_ms=0.3)
    s.update(kw)
    return s


#: (summary changes, the failure's words, fails on the card, on the CPU,
#: on the card with --fast)
GATE_CASES = [
    ({}, None, False, False, False),
    ({"matched": 98}, "located 98/100", True, False, True),
    ({"matched": 94}, "located 94/100", True, True, True),
    ({"median_cm": 0.3}, "median error", True, False, True),
    ({"median_cm": 1.5}, "median error", True, True, True),
    ({"median_cm": math.nan}, "median error", True, True, True),
    ({"zone_correct": 79}, "zone accuracy", True, True, True),
    ({"zone_total": 0, "zone_correct": 0}, "no located hit", True, True,
     True),
    ({"thread_errors": ["boom"]}, "serve thread", True, True, True),
    ({"drops": 1}, "dropped blocks", True, True, True),
    ({"overflows": 2}, "harvest overflows", True, True, True),
    ({"audio_p99_ms": 1.4}, "audio-thread p99", True, False, True),
    ({"hit_p50_ms": 30.0}, "hit-latency p50", True, False, False),
    ({"north_star_ms": 1.0}, "north-star", True, False, False),
]


@pytest.mark.parametrize("case", GATE_CASES, ids=[
    "pass", "located-98", "located-94", "median-0.3", "median-1.5",
    "median-nan", "zone", "unclassified", "thread-error", "drops",
    "overflows", "audio-p99", "hit-latency", "north-star"])
def test_serve_gates(case):
    change, words, card, cpu, fast = case
    s = summary(**change)
    for is_cpu, is_fast, want in ((False, False, card), (True, False, cpu),
                                  (False, True, fast)):
        fails = sim.serve_failures(s, cpu=is_cpu, fast=is_fast)
        assert bool(fails) == want, (is_cpu, is_fast, fails)
        if want:
            assert len(fails) == 1 and words in fails[0], fails


def test_locate_gates_by_device():
    hits = [(10000 * i, 0.0, 0.0, 0) for i in range(1, 101)]

    def events(n, err):
        return [(10000 * i + 3, Location(x=err, y=0.0))
                for i in range(1, n + 1)]

    assert sim.locate_gates(hits, events(100, 0.1)) == (100, 0.1, True)
    # 98% located: the CPU's bar, not the card's
    assert not sim.locate_gates(hits, events(98, 0.1))[2]
    assert sim.locate_gates(hits, events(98, 0.1), cpu=True)[2]
    # a 0.5 cm median: inside the CPU's 1 cm, outside the card's 0.2 cm
    assert not sim.locate_gates(hits, events(100, 0.5))[2]
    assert sim.locate_gates(hits, events(100, 0.5), cpu=True)[2]
    assert not sim.locate_gates(hits, events(94, 0.1), cpu=True)[2]
    # a hit more than 2400 samples from its strike does not match it
    far = [(o + 2500, loc) for o, loc in events(100, 0.1)]
    assert sim.locate_gates(hits, far, cpu=True)[0] == 0


class _Captured(Exception):
    pass


def test_zone_windows_equal_the_demo(monkeypatch):
    """The demo's train_zone_classifier builds its windows and hands them
    to the JAX Trainer; a stand-in Trainer catches them there."""
    import onset_fingerprinting_tpu.models.train as jtrain

    seen = {}

    class Catch:
        def __init__(self, model, cfg):
            seen.update(model=model, cfg=cfg)

        def fit(self, data, epochs_per_step=1):
            seen.update(data=data, epochs_per_step=epochs_per_step)
            raise _Captured

    monkeypatch.setattr(jtrain, "Trainer", Catch)
    spec = importlib.util.spec_from_file_location(
        "realtime_sim_demo", REPO / "examples" / "realtime_sim_demo.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    with pytest.raises(_Captured):
        demo.train_zone_classifier(seed=1, n_per_zone=12)
    xs, ys = sim.zone_windows(seed=1, n_per_zone=12)
    assert xs.dtype == seen["data"][0].dtype and ys.dtype == np.int32
    assert np.array_equal(xs, seen["data"][0])
    assert np.array_equal(ys, seen["data"][1])
    # the demo's model and training settings
    m, cfg = seen["model"], seen["cfg"]
    for k, v in sim.ZONE_CNN.items():
        assert getattr(m, k) == v, k
    for k in ("lr", "num_epochs", "min_epochs", "patience", "loss", "seed",
              "optimizer"):
        assert getattr(cfg, k) == getattr(sim.ZONE_TRAIN, k), k
    assert seen["epochs_per_step"] == sim.ZONE_EPOCHS_PER_STEP
