"""The program's spans in a traced run: device time, self time and device
idle per span, attributed from the profiler's own events.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

runs the cell once as ``portbench/run.py --trace 1`` does, with
:class:`SpanTrace` reading the profiler in place of ``tracing.Trace`` (the
same readings, and the spans besides), and prints the same result line
and check lines, then two more:

- ``detail spans``: for each span the program opened (``onset_fingerprinting
  _torch.utils.metrics.SPANS``), ``name:count:incl:self:idle``, the times
  in ms per call of the window; then ``unclaimed:<ms>``, the device time
  that no span claims, and ``outside:<ms>``, the device idle whose gap
  midpoint lies in no span (the harness's share);
- ``detail build_s``: the kernels this process compiled, each with its
  ``nvcc`` wall seconds (``_cuda.Kernel.build_s``).

The benchmark's own runs never run this.

How a device event (kernel, copy, fill) finds its span: its host launch is
the CUDA API call (``cuda*``, ``cu*``) with the same CUPTI correlation id,
else the op that its ``linked_correlation_id`` names; the innermost
program span on the caller's thread that encloses the launch claims it.
Device events and idle gaps are those ``Trace._read`` builds the busy
union from, clipped to the same window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = str(Path(__file__).resolve().parent)
if sys.path and sys.path[0] == HERE:
    sys.path.pop(0)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import tracing  # noqa: E402
from portbench.tracing import WINDOW_SPAN, Trace  # noqa: E402


def program_spans() -> tuple:
    """The names of the spans the program opens (none in a program
    without them)."""
    try:
        from onset_fingerprinting_torch.utils.metrics import SPANS
    except ImportError:
        return ()
    return SPANS


def attribute(events, names, gaps) -> tuple[dict, float, float]:
    """``(spans, unclaimed_s, outside_s)`` from the profiler's events:
    ``spans[name]`` holds ``count``, ``incl_s`` (device seconds claimed by
    the span or a span inside it), ``self_s`` (by the span alone) and
    ``idle_s`` (seconds of the idle ``gaps`` whose midpoint lies inside
    it), summed over the span's instances; ``unclaimed_s``: device
    seconds no span claims; ``outside_s``: idle seconds whose gap midpoint
    lies in no span.  ``gaps``: the idle intervals ``(start_ns, end_ns)``
    of the window."""
    names = set(names)
    ws = we = tid = None
    spans, launch, op_start, dev = [], {}, {}, []
    for e in events:
        name = e.name()
        on_dev = "CUDA" in str(e.device_type())
        if name == WINDOW_SPAN:  # the last one is the window, as in Trace
            ws, we = e.start_ns(), e.end_ns()
            if not on_dev:
                tid = e.start_thread_id()
            continue
        if on_dev:
            if name not in names:  # a span's device-side copy is no work
                dev.append(e)
        elif name.startswith("cu"):  # a CUDA API call
            launch[e.correlation_id()] = e.start_ns()
        else:
            op_start.setdefault(e.correlation_id(), e.start_ns())
            if name in names:
                spans.append(e)
    if ws is None:
        return {}, 0.0, 0.0
    spans = [s for s in spans if tid is None or s.start_thread_id() == tid]
    spans.sort(key=lambda s: (s.start_ns(), -s.end_ns()))
    starts = [s.start_ns() for s in spans]
    ends = [s.end_ns() for s in spans]
    parent, stack = [], []
    for i, s0 in enumerate(starts):
        while stack and ends[stack[-1]] <= s0:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)

    def enclosing(t: int) -> int:
        """The innermost span that holds ``t``, -1 for none (spans on one
        thread nest, so it is the latest to start before ``t`` or one of
        its ancestors)."""
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and ends[i] < t:
            i = parent[i]
        return i

    own = [0] * len(spans)
    idle = [0] * len(spans)
    unclaimed = outside = 0
    for d in dev:
        s, t = max(d.start_ns(), ws), min(d.end_ns(), we)
        if t <= s:
            continue
        at = launch.get(d.correlation_id())
        if at is None and d.linked_correlation_id() > 0:
            at = op_start.get(d.linked_correlation_id())
        j = -1 if at is None else enclosing(at)
        if j < 0:
            unclaimed += t - s
        else:
            own[j] += t - s
    for gs, ge in gaps:
        j = enclosing((gs + ge) // 2)
        if j < 0:
            outside += ge - gs
        while j >= 0:
            idle[j] += ge - gs
            j = parent[j]
    incl = list(own)
    for i in reversed(range(len(spans))):  # children sort after parents
        if parent[i] >= 0:
            incl[parent[i]] += incl[i]
    out = {}
    for i, s in enumerate(spans):
        r = out.setdefault(s.name(), dict(count=0, incl_s=0.0, self_s=0.0,
                                          idle_s=0.0))
        r["count"] += 1
        r["incl_s"] += incl[i] / 1e9
        r["self_s"] += own[i] / 1e9
        r["idle_s"] += idle[i] / 1e9
    return out, unclaimed / 1e9, outside / 1e9


class SpanTrace(Trace):
    """``Trace`` that also attributes the window's device time and idle
    gaps to the program's spans (:func:`attribute`); ``last`` is the
    latest one read."""

    last = None

    def __init__(self, cuda: bool):
        super().__init__(cuda)
        self.spans = {}
        self.unclaimed_s = 0.0
        self.outside_s = 0.0
        self._gap_iv = []

    def _label_gaps(self, gaps, host) -> None:
        self._gap_iv = list(gaps)
        super()._label_gaps(gaps, host)

    def _read(self, events) -> None:
        super()._read(events)
        self.spans, self.unclaimed_s, self.outside_s = attribute(
            events, program_spans(), self._gap_iv)
        SpanTrace.last = self


def spans_line(trace: SpanTrace, calls: int) -> str:
    """The ``detail spans`` line (see the module's docstring)."""
    per = 1e3 / max(calls, 1)
    parts = [f"{n}:{r['count']}:{r['incl_s'] * per:.4f}:"
             f"{r['self_s'] * per:.4f}:{r['idle_s'] * per:.4f}"
             for n, r in trace.spans.items()]
    parts += [f"unclaimed:{trace.unclaimed_s * per:.4f}",
              f"outside:{trace.outside_s * per:.4f}"]
    return "detail spans " + ",".join(parts)


def build_line() -> str:
    """The ``detail build_s`` line: each kernel compiled in this process
    and its ``nvcc`` wall seconds."""
    from onset_fingerprinting_torch.ops import _cuda

    built = [f"{k.name}={k.build_s:.3f}" for k in _cuda.KERNELS
             if getattr(k, "builds", 0)]
    return "detail build_s " + (",".join(built) or "none")


def main(argv=None) -> int:
    from portbench.run import _cache_dirs, load_cell, run_cell

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args(argv)
    _cache_dirs()
    import torch

    _, cell, *_ = load_cell(ROOT, a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{a.workload} needs {cell['chips']} CUDA device(s)",
              file=sys.stderr)
        return 2
    tracing.Trace = SpanTrace  # run_cell imports Trace at its call
    result, lines = run_cell(ROOT, a.workload, a.seed, a.seconds, True,
                             t_start=T_START)
    calls = result["attempted"] - result["failed"]
    lines += [spans_line(SpanTrace.last, calls), build_line()]
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
