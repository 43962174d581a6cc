"""Structured metrics, tracing and TensorBoard logging (port of
``onset_fingerprinting_tpu.utils.metrics``).

- :func:`trace` — a span: while a profiler records, a profiler range of
  that name (a ``cpu_op`` in the trace, on the same timeline as the
  card's events, so that each launch inside it links to it); with
  ``metrics``, also a wall-clock timer.  With no profiler running it is a
  flag check.  :data:`SPANS` names every span the program opens.
- :func:`count` / :func:`counters` / :func:`reset_counters` — process-local
  counts at the same boundaries, kept only while a profiler records.
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
from torch._C._profiler import _RecordFunctionFast

from onset_fingerprinting_torch.device import resolve_device


#: every span the program opens: the fleet's stages
#: (``pipeline.DetectFingerprint``), the drum batch's
#: (``parallel.sharding.make_detect_locate_sharded``), the CCCNN's two
#: halves (``models.cccnn.CCCNN.forward``) and the parts of its head's
#: chain (``CCCNN.chain_head``)
SPANS = (
    "fleet.call", "fleet.detect", "fleet.hit_list", "fleet.windows",
    "fleet.predict", "fleet.dropped_read",
    "drum.call", "drum.detect", "drum.events", "drum.locate",
    "drum.windows", "drum.classify",
    "cccnn.features", "cccnn.head",
    "cccnn.head_spectrum", "cccnn.head_inverse", "cccnn.head_dense",
)

_NO_SPAN = contextlib.nullcontext()
_COUNTS: dict[str, int] = defaultdict(int)


def _recording() -> bool:
    """Whether a profiler records: ``torch.profiler.profile`` sets this
    flag on entry and clears it on exit (reading it costs a third of
    ``torch.autograd._profiler_enabled()``)."""
    return torch.autograd.profiler._is_profiler_enabled


def trace(name: str, metrics: Optional["Metrics"] = None):
    """A span named ``name`` (a context manager): a profiler range while a
    profiler records, timed into ``metrics`` when given."""
    if metrics is None and not _recording():
        return _NO_SPAN
    return _span(name, metrics)


@contextlib.contextmanager
def _span(name: str, metrics: Optional["Metrics"]):
    # an op-scope range: a ``record_function`` range is a user annotation,
    # which the profiler copies onto the card's timeline as if it were
    # device work, and a kernel launched from C inside it links to no op
    t0 = time.perf_counter()
    with _RecordFunctionFast(name) if _recording() else _NO_SPAN:
        yield
    if metrics is not None:
        metrics.observe(name, (time.perf_counter() - t0) * 1e3)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if _recording():
        _COUNTS[name] += n


def counters() -> dict[str, int]:
    """The counts kept since the last :func:`reset_counters`."""
    return dict(_COUNTS)


def reset_counters() -> None:
    _COUNTS.clear()


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
