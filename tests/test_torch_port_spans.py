"""The port's spans and counters (``utils.metrics.trace`` / ``count``), the
benchmark's reading of them (``portbench.spans.attribute`` on a synthetic
profiler timeline, the ``slot_use`` reader) and the kernels' build counts,
on the CPU."""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from onset_fingerprinting_torch.ops import _cuda
from onset_fingerprinting_torch.utils import metrics as pmetrics

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "onset_fingerprinting_torch"
SENSORS = [(0.9, 0.0, 0.0), (0.9, 120.0, 0.0), (0.9, 240.0, 0.0)]
#: each span's parent, and how often a call opens it
FLEET = {"fleet.call": None, "fleet.detect": "fleet.call",
         "fleet.hit_list": "fleet.call", "fleet.windows": "fleet.call",
         "fleet.predict": "fleet.call", "fleet.dropped_read": "fleet.call",
         "cccnn.features": "fleet.predict", "cccnn.head": "fleet.predict"}
DRUM = {"drum.call": None, "drum.detect": "drum.call",
        "drum.events": "drum.call", "drum.locate": "drum.call",
        "drum.windows": "drum.call", "drum.classify": "drum.call",
        "cccnn.features": "drum.classify", "cccnn.head": "drum.classify"}
#: the head's chain (the CPU's float32 DFT head)
HEAD = {"cccnn.head_spectrum": "cccnn.head",
        "cccnn.head_inverse": "cccnn.head",
        "cccnn.head_dense": "cccnn.head"}
FLEET.update(HEAD)
DRUM.update(HEAD)


@pytest.fixture
def clean_counters():
    pmetrics.reset_counters()
    yield
    pmetrics.reset_counters()


def _model(channels, window, out=2):
    from onset_fingerprinting_torch.models.cccnn import CCCNN

    torch.manual_seed(0)
    return CCCNN(input_size=window, output_size=out, channels=channels,
                 layer_sizes=(2, 2), kernel_sizes=(3, 5), dropout_rate=0.0,
                 cc_impl="dft", cc_norm=True)


def _fleet():
    """A tiny fleet pipeline on the CPU and one call of it: ``(call,
    rows)``, the rows its model runs on a call."""
    from onset_fingerprinting_torch.pipeline import (
        fleet_detector_config,
        make_detect_fingerprint,
    )
    from onset_fingerprinting_torch.workload import WINDOW

    run = make_detect_fingerprint(fleet_detector_config(2),
                                  _model(4, WINDOW), 2, 512, 16,
                                  device="cpu")
    x = torch.as_tensor(np.random.default_rng(0).normal(
        0, 1e-3, (512, 8)).astype(np.float32))
    state = run.init_state()
    return lambda: run(state, x), 16


def _drum():
    """A tiny drum batch on a one-rank mesh on the CPU: ``(call, rows)``."""
    from onset_fingerprinting_torch.core.config import DetectorConfig
    from onset_fingerprinting_torch.detect.amplitude import detector_init
    from onset_fingerprinting_torch.locate.multilaterate import (
        Multilaterate3D,
    )
    from onset_fingerprinting_torch.parallel import (
        make_detect_locate_sharded,
        make_mesh,
    )

    static, params, state = detector_init(
        DetectorConfig(n_channels=3, hipass_freq=0.0), "cpu")
    locator = Multilaterate3D(SENSORS, drum_diameter=14 * 2.54,
                              medium="drumhead", sr=96000)
    mesh = make_mesh((1,), ("data",), device="cpu")
    shape = (2, 128 * 4, 3)
    run = make_detect_locate_sharded(static, params, state, shape, mesh,
                                     locator, model=_model(3, 128, 3),
                                     event_capacity=4, window=128, pre=32)
    x = torch.as_tensor(np.random.default_rng(1).normal(
        0, 1e-3, shape).astype(np.float32))
    return lambda: run(x), 2 * 4


def _spans_of(prof):
    """The program's spans in a profile: ``[(name, start, end)]``."""
    return sorted((e.name(), e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name() in pmetrics.SPANS)


def test_spans_and_counts_off_touch_no_profiler(monkeypatch, clean_counters):
    """With no profiler running, a span enters no profiler range (whether
    or not it times into ``Metrics``) and a count keeps nothing, also
    through a whole fleet call."""
    entered = []

    class Range:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            pass

        def __exit__(self, *a):
            pass
    monkeypatch.setattr(pmetrics, "_RecordFunctionFast", Range)
    monkeypatch.setattr(torch.profiler, "record_function", Range)
    m = pmetrics.Metrics()
    with pmetrics.trace("fleet.call"):
        with pmetrics.trace("fleet.detect", m):
            pmetrics.count("model_rows", 5)
    call, _ = _fleet()
    call()
    assert entered == []
    assert pmetrics.counters() == {}
    assert m.summary()["latency"]["fleet.detect"]["count"] == 1


@pytest.mark.parametrize("path", ["fleet", "drum"])
def test_a_call_opens_every_span_once_nested(path, clean_counters):
    """Under a profiler each call opens each of its path's spans once,
    nested as the path nests them, and counts the rows its CCCNN ran
    on."""
    call, rows = {"fleet": _fleet, "drum": _drum}[path]()
    want = {"fleet": FLEET, "drum": DRUM}[path]
    call()  # the first call's set-up is not under the profiler
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            call()
    spans = _spans_of(prof)
    # op-scope ranges: the profiler copies user annotations, not ops, onto
    # the device's timeline
    assert not any(e.is_user_annotation()
                   for e in prof.profiler.kineto_results.events()
                   if e.name() in pmetrics.SPANS)
    got = {}
    for n, *_ in spans:
        got[n] = got.get(n, 0) + 1
    assert got == {n: 2 for n in want}
    for n, s, t in spans:
        holders = [(m, a, b) for m, a, b in spans
                   if a <= s and t <= b and (m, a, b) != (n, s, t)]
        inner = max(holders, key=lambda h: h[1], default=(None,))[0]
        assert inner == want[n], (n, holders)
    assert pmetrics.counters() == {"model_rows": 2 * rows}


_TRACE_CALL = re.compile(r"\btrace\(\s*([^,)]+)")


def test_spans_names_every_span_the_program_opens():
    opened = set()
    for f in PACKAGE.rglob("*.py"):
        for arg in _TRACE_CALL.findall(f.read_text()):
            if f.name == "metrics.py" and f.parent.name == "utils":
                continue  # the helper's own definition
            assert re.fullmatch(r'"[a-z_]+\.[a-z_]+"', arg), (f, arg)
            opened.add(arg.strip('"'))
    assert opened == set(pmetrics.SPANS)


class _Ev:
    """One event of a profiler timeline (the accessors ``attribute``
    reads)."""

    def __init__(self, name, start, end, dev=False, corr=0, linked=0,
                 tid=1):
        self._v = (name, start, end, dev, corr, linked, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


def _timeline():
    """A window (host 0-1000, its device copy 100-900, taken as the window)
    with one call: ``fleet.call`` 10-800 holding ``fleet.detect`` 20-100
    (a ctypes launch at 30, its kernel 100-300), ``fleet.predict`` 110-700
    holding ``cccnn.head`` 200-600 (an op at 210 launching a kernel
    350-400 and a copy 420-440) and, after them, an op at 705 (its kernel
    750-760); a harness copy at 850 onto the device 860-900; another
    thread's span."""
    E = _Ev
    return [
        E("portbench.window", 0, 1000),
        E("fleet.call", 10, 800, corr=1),
        E("fleet.detect", 20, 100, corr=2),
        E("cudaLaunchKernel", 30, 35, corr=900, linked=0),
        E("detector_pipe_kernel", 100, 300, dev=True, corr=900, linked=0),
        E("fleet.predict", 110, 700, corr=3),
        E("cccnn.head", 200, 600, corr=4),
        E("aten::mm", 210, 260, corr=5),
        E("cudaLaunchKernel", 215, 220, corr=901, linked=5),
        E("gemm_kernel", 350, 400, dev=True, corr=901, linked=5),
        # a copy whose runtime call the trace lost: linked to its op
        E("Memcpy DtoD", 420, 440, dev=True, corr=950, linked=5),
        E("aten::sum", 705, 720, corr=6),
        E("cudaLaunchKernel", 706, 710, corr=903, linked=6),
        E("sum_kernel", 750, 760, dev=True, corr=903, linked=6),
        E("aten::copy_", 850, 870, corr=7),
        E("cudaMemcpyAsync", 852, 860, corr=902, linked=7),
        E("Memcpy DtoH", 860, 900, dev=True, corr=902, linked=7),
        E("fleet.call", 0, 1000, corr=8, tid=2),  # another thread
        E("portbench.window", 100, 900, dev=True, corr=9),
    ]


def test_attribute_puts_device_time_and_idle_under_spans():
    """Inclusive, self and idle time per span on a synthetic timeline;
    the device time no span claims and the idle outside every span; a
    span's device-side copy (a user annotation's) claims nothing."""
    from portbench.spans import attribute
    from portbench.tracing import Trace

    tr = Trace(cuda=True)
    gaps = []
    tr._label_gaps = lambda g, host: gaps.extend(g)
    tr._read(_timeline())
    assert tr.window_s == pytest.approx(800e-9)
    assert tr.busy_s == pytest.approx((200 + 50 + 20 + 10 + 40) * 1e-9)
    assert set(tr.kernels) == {"detector_pipe_kernel", "gemm_kernel",
                               "Memcpy DtoD", "sum_kernel", "Memcpy DtoH"}
    assert gaps == [(300, 350), (400, 420), (440, 750), (760, 860)]
    copy = _Ev("cccnn.head", 350, 400, dev=True, corr=4)
    spans, unclaimed, outside = attribute(_timeline() + [copy],
                                          pmetrics.SPANS, gaps)
    ns = 1e-9
    idle = (50 + 20 + 310) * ns
    want = {"fleet.call": (280, 10), "fleet.detect": (200, 200),
            "fleet.predict": (70, 0), "cccnn.head": (70, 70)}
    assert set(spans) == set(want)
    for name, (incl, own) in want.items():
        assert spans[name] == dict(
            count=1, incl_s=pytest.approx(incl * ns),
            self_s=pytest.approx(own * ns),
            idle_s=pytest.approx(0.0 if name == "fleet.detect" else idle))
    assert unclaimed == pytest.approx(40 * ns)  # the harness's copy
    assert outside == pytest.approx(100 * ns)  # the gap 760-860


def test_attribute_without_program_spans_reads_nothing():
    from portbench.spans import attribute

    spans, unclaimed, outside = attribute(_timeline(), (), [(300, 350)])
    assert spans == {} and unclaimed == pytest.approx(320e-9)
    assert outside == pytest.approx(50e-9)
    assert attribute([], pmetrics.SPANS, []) == ({}, 0.0, 0.0)


def test_slot_use_reads_the_model_rows_counter(monkeypatch):
    from portbench.run import load_reader

    read = load_reader(REPO, "slot_use")
    ctx = SimpleNamespace(calls=10, items_per_call=24.5, trace=object())
    monkeypatch.setattr(pmetrics, "counters", lambda: {"model_rows": 320})
    assert read(ctx) == pytest.approx(100 * 24.5 * 10 / 320)
    monkeypatch.setattr(pmetrics, "counters", lambda: {})
    assert read(ctx) is None
    monkeypatch.setattr(pmetrics, "counters", lambda: {"model_rows": 320})
    ctx.trace = None
    assert read(ctx) is None


def test_build_counts_each_compile_and_its_seconds(tmp_path, monkeypatch):
    """``build`` counts each compile of a record and its compiler's wall
    seconds (a stand-in compiler that takes 0.2 s)."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nsleep 0.2\nwhile [ "$1" != "-o" ]; do '
                    'shift; done\ntouch "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_cuda, "nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(_cuda.Kernel, "_load", lambda self, path: None)
    k = _cuda.Kernel("probe", "gather.cu", {})
    assert (k.builds, k.build_s) == (0, 0.0)
    _cuda.build([k])
    assert k.builds == 1 and 0.2 <= k.build_s < 30
    assert k.library_path().exists()
