"""ctypes bindings for the native host runtime (port of
``onset_fingerprinting_tpu.runtime_native``, with its own copy of the C++
source, ``csrc/ofrt.cpp``).

Native replacements for the reference's host-side layer (c/circular_array.h,
the shared-memory transport of realtime/recording.py:65-158 there): a
lock-free single-producer single-consumer ring of float32 frames with
monotonic counters, and a paced block executor on a thread of its own that
calls a Python callback per block and keeps per-block latency statistics.

The library is compiled at first use with ``g++`` into ``build/ofrt/``
beside the package (git-ignored), under a name that carries a hash of the
source and the flags, so an edited source rebuilds.

The executor's callback runs on the executor's thread: a callback that
touches the card must name its stream (the realtime engine replays its
captured step on the stream it was built on, ``realtime/engine``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

import numpy as np

_SOURCE = Path(__file__).resolve().parent / "csrc" / "ofrt.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "ofrt"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

_BLOCK_CB = ctypes.CFUNCTYPE(
    None,
    ctypes.POINTER(ctypes.c_float),
    ctypes.c_int64,
    ctypes.c_int64,
    ctypes.c_int64,
    ctypes.c_void_p,
)


def library_path() -> Path:
    h = hashlib.sha256(_SOURCE.read_bytes()
                       + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libofrt_{h}.so"


def build() -> Path:
    """Compile ``csrc/ofrt.cpp`` unless this source's library exists."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build csrc/ofrt.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SOURCE),
                           "-lpthread"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {_SOURCE.name} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.ofrt_ring_create.restype = ctypes.c_void_p
    lib.ofrt_ring_create.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.ofrt_ring_destroy.argtypes = [ctypes.c_void_p]
    for name in ("write_counter", "read_counter", "readable"):
        fn = getattr(lib, f"ofrt_ring_{name}")
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    for name in ("write", "read", "peek_last"):
        fn = getattr(lib, f"ofrt_ring_{name}")
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                       ctypes.c_int64]
    lib.ofrt_executor_create.restype = ctypes.c_void_p
    lib.ofrt_executor_create.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, _BLOCK_CB,
        ctypes.c_void_p]
    for name in ("start", "stop", "destroy"):
        getattr(lib, f"ofrt_executor_{name}").argtypes = [ctypes.c_void_p]
    for name in ("blocks", "misses"):
        fn = getattr(lib, f"ofrt_executor_{name}")
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.ofrt_executor_latency_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
    return lib


_lib: Optional[ctypes.CDLL] = None


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


class NativeRing:
    """Lock-free SPSC float32 frame ring (native)."""

    def __init__(self, capacity_frames: int, channels: int):
        self._lib = lib()
        self._ptr = self._lib.ofrt_ring_create(capacity_frames, channels)
        self.channels = channels
        self.capacity = capacity_frames

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.ofrt_ring_destroy(self._ptr)
            self._ptr = None

    @property
    def write_counter(self) -> int:
        return self._lib.ofrt_ring_write_counter(self._ptr)

    @property
    def read_counter(self) -> int:
        return self._lib.ofrt_ring_read_counter(self._ptr)

    @property
    def readable(self) -> int:
        return self._lib.ofrt_ring_readable(self._ptr)

    def write(self, frames: np.ndarray) -> int:
        frames = np.ascontiguousarray(frames, dtype=np.float32)
        return self._lib.ofrt_ring_write(
            self._ptr, frames.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            frames.shape[0])

    def read(self, n: int) -> Optional[np.ndarray]:
        out = np.empty((n, self.channels), dtype=np.float32)
        got = self._lib.ofrt_ring_read(
            self._ptr, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
        return out if got == n else None

    def peek_last(self, n: int) -> np.ndarray:
        out = np.empty((n, self.channels), dtype=np.float32)
        self._lib.ofrt_ring_peek_last(
            self._ptr, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
        return out


class NativeExecutor:
    """Block executor on a thread of its own, pulling from a
    :class:`NativeRing`.  ``callback(block [B, C] ndarray, block_index)``
    runs on the executor's thread; per-block latency (µs) and the deadline
    misses against ``block_size / sample_rate`` are kept natively.

    The executor's thread keeps one Python thread state from its first
    block on.  Without it ctypes makes and frees a thread state, and its
    frame stack (an mmap), for every block: on the host of an NVIDIA H100
    80GB HBM3 (700 W) a callback that does nothing took 0.170-0.183 ms at
    p50 and 0.548-0.650 ms at p99 that way, 0.006 and 0.113-0.124 ms with
    the state kept (``tools/serve_split``, ``noop``)."""

    def __init__(self, ring: NativeRing, block_size: int,
                 callback: Callable[[np.ndarray, int], None],
                 sample_rate: float = 0.0):
        self._lib = lib()
        self.ring = ring
        self.block_size = block_size
        held = threading.local()

        def _cb(ptr, frames, channels, idx, _user):
            if not getattr(held, "pinned", False):
                # a second hold on this thread's state: ctypes' release
                # after each call then keeps it (one per executor thread)
                ctypes.pythonapi.PyGILState_Ensure()
                held.pinned = True
            block = np.ctypeslib.as_array(ptr, shape=(frames, channels))
            callback(block, idx)

        self._cb = _BLOCK_CB(_cb)  # keep alive
        self._ptr = self._lib.ofrt_executor_create(
            ring._ptr, block_size, sample_rate, self._cb, None)

    def start(self) -> None:
        self._lib.ofrt_executor_start(self._ptr)

    def stop(self) -> None:
        self._lib.ofrt_executor_stop(self._ptr)

    def __del__(self):
        if getattr(self, "_ptr", None):
            self._lib.ofrt_executor_destroy(self._ptr)
            self._ptr = None

    @property
    def blocks_processed(self) -> int:
        return self._lib.ofrt_executor_blocks(self._ptr)

    @property
    def deadline_misses(self) -> int:
        return self._lib.ofrt_executor_misses(self._ptr)

    def latency_stats(self) -> dict:
        out = (ctypes.c_double * 4)()
        self._lib.ofrt_executor_latency_stats(self._ptr, out)
        return {"count": int(out[0]), "p50_us": out[1], "p99_us": out[2],
                "max_us": out[3]}
