"""Structured metrics, tracing and TensorBoard logging (port of
``onset_fingerprinting_tpu.utils.metrics``).

- :func:`trace` / :func:`trace_span` — a span inside
  ``torch.profiler.record_function`` (it names the span in a profiler
  trace) that doubles as a wall-clock timer.
- :func:`profile_trace` — a ``torch.profiler`` capture of the card (and the
  host) around a region, written as a Chrome trace under a directory.
- :class:`Metrics` — a process-local registry of counters and latency
  observations with percentile summaries (a copy: it is numpy).
- :class:`TBWriter` — a TensorBoard writer (scalars and matplotlib
  figures), with a JSONL fallback where tensorboard is absent.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from onset_fingerprinting_torch.device import resolve_device


@contextlib.contextmanager
def trace(name: str, metrics: Optional["Metrics"] = None):
    """Profiler-annotated, timed span."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    if metrics is not None:
        metrics.observe(name, (time.perf_counter() - t0) * 1e3)


trace_span = trace


@contextlib.contextmanager
def profile_trace(logdir: str | Path, device=None):
    """Capture a profiler trace around a region into ``logdir`` (a Chrome
    trace, ``*.pt.trace.json``, through
    ``torch.profiler.tensorboard_trace_handler``).  ``device=None`` means
    the card: the host and CUDA activities, raising without CUDA;
    ``device="cpu"`` profiles the host alone."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class Metrics:
    """Counters + latency observations with percentile summaries."""

    def __init__(self):
        self.counters: dict[str, float] = defaultdict(float)
        self.observations: dict[str, list[float]] = defaultdict(list)
        self._t0 = time.perf_counter()

    def count(self, name: str, n: float = 1.0) -> None:
        self.counters[name] += n

    def observe(self, name: str, value_ms: float) -> None:
        self.observations[name].append(value_ms)

    def observe_deadline(
        self, name: str, value_ms: float, budget_ms: float
    ) -> None:
        """Observe a latency and count ``<name>.miss`` when it exceeds the
        budget (the serve loop's hard per-block deadline,
        reference realtime/config.py:33-36)."""
        self.observe(name, value_ms)
        if value_ms > budget_ms:
            self.count(name + ".miss")

    def misses(self, name: str) -> int:
        return int(self.counters.get(name + ".miss", 0))

    def rate(self, name: str) -> float:
        """Counter per wall-clock second since creation."""
        dt = time.perf_counter() - self._t0
        return self.counters[name] / dt if dt > 0 else 0.0

    def summary(self) -> dict:
        out: dict = {"counters": dict(self.counters)}
        lat = {}
        for name, vals in self.observations.items():
            v = np.asarray(vals)
            lat[name] = {
                "count": int(v.size),
                "p50_ms": float(np.percentile(v, 50)),
                "p99_ms": float(np.percentile(v, 99)),
                "max_ms": float(v.max()),
            }
        out["latency"] = lat
        return out

    def report(self) -> str:
        s = self.summary()
        lines = [
            *(f"{k}: {v:g} ({self.rate(k):.1f}/s)" for k, v in
              s["counters"].items()),
            *(
                f"{k}: p50 {d['p50_ms']:.3f}ms p99 {d['p99_ms']:.3f}ms "
                f"max {d['max_ms']:.3f}ms (n={d['count']})"
                for k, d in s["latency"].items()
            ),
        ]
        return "\n".join(lines)


class TBWriter:
    """TensorBoard scalar/figure writer with a JSONL fallback."""

    def __init__(self, logdir: str | Path):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(str(self.logdir))
        except ImportError:
            self._tb = None
            self._jsonl = open(self.logdir / "events.jsonl", "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        else:
            self._jsonl.write(
                json.dumps({"tag": tag, "value": float(value), "step": step})
                + "\n"
            )
            self._jsonl.flush()

    def add_figure(self, tag: str, figure, step: int) -> None:
        if self._tb is not None:
            self._tb.add_figure(tag, figure, step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()
