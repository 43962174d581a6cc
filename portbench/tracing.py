"""The traced run's reading of the profiler: device time by kernel, the
device's busy time over the traced window, the longest idle gaps by what
the host was doing, and the check that every kernel the program counted
as launched appears in the trace."""

from __future__ import annotations

import re
from collections import defaultdict

import numpy as np

WINDOW_SPAN = "portbench.window"


class Trace:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.kernels = {}  # name -> [seconds, count]
        self.busy_s = 0.0
        self.window_s = 0.0
        self._gaps = []

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = torch.profiler.record_function(WINDOW_SPAN)
        self._span.__enter__()

    def stop(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._read(self._prof.profiler.kineto_results.events())
        del self._prof, self._span

    def _read(self, events) -> None:
        ws = we = None
        dev, host = [], []
        for e in events:
            name = e.name()
            if name == WINDOW_SPAN:
                ws, we = e.start_ns(), e.end_ns()
                continue
            if "CUDA" in str(e.device_type()):
                dev.append((e.start_ns(), e.end_ns(), name))
            else:
                host.append((e.start_ns(), e.end_ns(), name))
        if ws is None:
            return
        self.window_s = (we - ws) / 1e9
        kern = defaultdict(lambda: [0.0, 0])
        iv = []
        for s, t, name in dev:
            s, t = max(s, ws), min(t, we)
            if t <= s:
                continue
            iv.append((s, t))
            k = kern[name]
            k[0] += (t - s) / 1e9
            k[1] += 1
        self.kernels = dict(kern)
        iv.sort()
        busy, gaps, cur_s, cur_t = 0, [], None, None
        for s, t in iv:
            if cur_t is None:
                gaps.append((ws, s))
                cur_s, cur_t = s, t
            elif s > cur_t:
                busy += cur_t - cur_s
                gaps.append((cur_t, s))
                cur_s, cur_t = s, t
            else:
                cur_t = max(cur_t, t)
        if cur_t is None:
            gaps.append((ws, we))
        else:
            busy += cur_t - cur_s
            gaps.append((cur_t, we))
        self.busy_s = busy / 1e9
        self._label_gaps([g for g in gaps if g[1] > g[0]], host)

    def _label_gaps(self, gaps, host) -> None:
        """Each idle gap labelled by the innermost host event under its
        midpoint."""
        if not host:
            self._gaps = [("idle", (t - s) / 1e9) for s, t in gaps]
            return
        host.sort()
        starts = np.array([h[0] for h in host])
        ends = np.array([h[1] for h in host])
        out = []
        for s, t in gaps:
            mid = (s + t) // 2
            i = int(np.searchsorted(starts, mid, side="right")) - 1
            label = "host idle"
            for j in range(i, max(i - 4096, -1), -1):
                if ends[j] >= mid:
                    label = host[j][2]
                    break
            out.append((label, (t - s) / 1e9))
        self._gaps = out

    def kernel_seconds(self, pattern: str) -> tuple[float, int]:
        """Device seconds and count of the kernels whose name contains
        ``pattern``."""
        tot, n = 0.0, 0
        for name, (sec, cnt) in self.kernels.items():
            if pattern in name:
                tot += sec
                n += cnt
        return tot, n

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        by = defaultdict(float)
        for label, sec in self._gaps:
            by[label] += sec
        gaps = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], v[0]] for n, v in ops],
                "idle_gaps": [[n[:120], v] for n, v in gaps]}


_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(",
    re.S)


def kernel_names(source) -> list:
    """The ``__global__`` functions a CUDA source defines."""
    return _GLOBAL.findall(source.read_text())


def kernel_presence(trace: Trace, cuda_mod) -> list:
    """The program's kernel sources that it counted as launched in the
    traced window more often than the trace shows their kernels."""
    by_src = defaultdict(int)
    for k in cuda_mod.KERNELS:
        by_src[k.source] += k.launches
    missing = []
    for src, n in sorted(by_src.items()):
        if not n:
            continue
        names = kernel_names(cuda_mod.CSRC / src)
        seen = sum(cnt for name, (_, cnt) in trace.kernels.items()
                   if any(g in name for g in names))
        if seen < n:
            missing.append(f"{src} ({n} launches, {seen} in the trace)")
    return missing
