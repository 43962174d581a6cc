"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled at first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
ctypes (no PyTorch headers: a build takes seconds, not minutes).  The
library name carries a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused.  Libraries go to
``build/torch_kernels/`` beside the package (git-ignored).

Every kernel has a :class:`Kernel` record here with two plain integer
counters: ``launches`` (its wrapper adds one each time it launches the
kernel, and nowhere else), ``plain_calls`` (its plain PyTorch version
adds one per call) and ``backward_recomputes`` (K3's backward adds one
each time it recomputes the plain chain to differentiate it), and
``variants``, the launches by instantiation where a wrapper names one, and
``plain_variants``, the plain calls by part where a plain version names
one (the locate step's plain ring write).  ``chip_smoke.py`` reads them to
show which path ran.  ``builds`` and ``build_s`` count the compiles
:func:`build` ran for the record's library in this process and their
``nvcc`` wall seconds (a fresh checkout's first run pays them in its
set-up).

Every C entry point returns ``cudaGetLastError()`` after its launch; a
non-zero code raises here, since a refused launch never runs and a later
``torch.cuda.synchronize()`` would not report it.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int


class Kernel:
    """One ``.cu`` source: its C entry points, build flags and counters.
    ``library``: another record whose library holds these entries too (one
    source, two routes counted apart, built once)."""

    def __init__(self, name: str, source: str, entries: dict,
                 extra_flags: tuple = (), library: Kernel | None = None):
        self.name = name
        self.source = source
        self.entries = entries
        self.flags = NVCC_FLAGS + tuple(extra_flags)
        self.library = library
        self.launches = 0
        self.plain_calls = 0
        self.backward_recomputes = 0
        self.variants = collections.Counter()
        self.plain_variants = collections.Counter()
        self.builds = 0
        self.build_s = 0.0
        self._lib = None

    def library_path(self) -> Path:
        if self.library is not None:
            return self.library.library_path()
        h = hashlib.sha256(
            (CSRC / self.source).read_bytes() + " ".join(self.flags).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}_{h}.so"

    def _load(self, path: Path) -> None:
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in self.entries.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.ofpt_error_string.argtypes = [ctypes.c_int]
        lib.ofpt_error_string.restype = ctypes.c_char_p
        self._lib = lib

    def launch(self, entry: str, *args, variant: str = "") -> None:
        """Call C entry ``entry`` (which launches the kernel on the given
        stream), raise on a CUDA error, count the launch (and, under
        ``variant``, the instantiation it took)."""
        if self._lib is None:
            build([self])
        rc = getattr(self._lib, entry)(*args)
        if rc != 0:
            msg = self._lib.ofpt_error_string(rc).decode()
            raise RuntimeError(f"{self.name}.{entry}: CUDA error {rc} ({msg})")
        self.launches += 1
        if variant:
            self.variants[variant] += 1


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from source at first use"
        )
    return path


def build(kernels=None) -> dict[str, str]:
    """Compile (one ``nvcc`` per source, all started together) and load the
    given kernels, default all.  Returns each newly compiled kernel's
    compiler output (``-Xptxas -v``: registers, shared memory, spills)."""
    kernels = list(KERNELS if kernels is None else kernels)
    kernels += [k.library for k in kernels
                if k.library is not None and k.library not in kernels]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for k in kernels:
        out = k.library_path()
        if k._lib is not None or out.exists() or k.library is not None:
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *k.flags, "-o", str(tmp), str(CSRC / k.source)]
        procs[k.name] = (k, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))

    def finish(proc):  # each compiler's output and end, as it ends
        log, _ = proc.communicate()
        return log, time.perf_counter()
    with ThreadPoolExecutor(max(len(procs), 1)) as pool:
        ends = {name: pool.submit(finish, v[3]) for name, v in procs.items()}
    logs = {}
    failed = []
    for name, (k, tmp, t0, proc) in procs.items():
        log, t1 = ends[name].result()
        logs[name] = log
        k.builds += 1
        k.build_s += t1 - t0
        if proc.returncode != 0:
            failed.append(f"{k.source}:\n{log}")
        else:
            os.replace(tmp, k.library_path())
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for k in kernels:
        if k._lib is None:
            k._load(k.library_path())
    return logs


def stream() -> int:
    """Handle of PyTorch's current CUDA stream (kernels launch on it)."""
    return torch.cuda.current_stream().cuda_stream


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.plain_calls = 0
        k.backward_recomputes = 0
        k.variants.clear()
        k.plain_variants.clear()


DETECTOR = Kernel(
    "detector", "detector.cu",
    {"ofpt_detect": [_P] * 19 + [_I, _P], "ofpt_empty": [_P]},
    # every multiply and add rounds on its own, as in the plain version
    extra_flags=("-fmad=false",),
)
# K1 in the coupled mode at C <= 32, one warp per channel
DETECTOR_WARP = Kernel(
    "detector_warp", "detector_warp.cu",
    {"ofpt_detect_warp": [_P] * 19,
     "ofpt_detect_warp_streams": [_P, _I] + [_P] * 18},
    # the same rounding as detector.cu and the plain version
    extra_flags=("-fmad=false",),
)
DETECTOR_PIPE = Kernel(
    "detector_pipe", "detector_pipe.cu",
    {"ofpt_detect_pipe": [_P] * 19},
    # the same rounding as detector.cu and the plain version
    extra_flags=("-fmad=false",),
)
# K1 in the coupled mode over more than one block at C <= 32: the pipe's
# coupled instantiation (lane groups), from the same library; variants
# "coupled" (one recording) and "coupled_streams" (a batch of streams)
DETECTOR_PIPE_COUPLED = Kernel(
    "detector_pipe_coupled", "detector_pipe.cu",
    {"ofpt_detect_pipe_coupled": [_P, _I, _I] + [_P] * 18},
    extra_flags=("-fmad=false",), library=DETECTOR_PIPE,
)
GATHER = Kernel(
    "gather", "gather.cu",
    {"ofpt_gather": [_P, _P, _P, _P] + [_I] * 7 + [_P]},
)
CONV_STACK = Kernel(
    "conv_stack", "conv_stack.cu",
    {"ofpt_conv_stack": [_P] * 5, "ofpt_conv_stack_occupancy": [_P, _P]},
)
CONV_STACK_MMA = Kernel(
    "conv_stack_mma", "conv_stack_mma.cu",
    {"ofpt_conv_stack_mma": [_P, _P, _P, _P, _P, _P]},
)
# K3 bf16 for a batch that cannot fill the card: a thread-block cluster
# per 16 signals splits the time axis (the route: ops/conv_stack.kernel_for)
CONV_STACK_MMA_CLUSTER = Kernel(
    "conv_stack_mma_cluster", "conv_stack_mma_cluster.cu",
    {"ofpt_conv_stack_mma_cluster": [_P, _P, _P, _P, _P, _P],
     "ofpt_conv_stack_mma_cluster_occupancy": [_P, _P]},
)
GATHER_ROLL = Kernel(
    "gather_roll", "gather_roll.cu",
    {"ofpt_gather_roll": [_P, _P, _P, _P] + [_I] * 5 + [_P]},
)
# K2 and K4 again, as row-vector copies; the plain versions count their
# calls on GATHER and GATHER_ROLL.
GATHER_VEC = Kernel(
    "gather_vec", "gather_vec.cu",
    {"ofpt_gather_vec": [_P, _P, _P, _P] + [_I] * 7 + [_P]},
)
GATHER_ROLL_VEC = Kernel(
    "gather_roll_vec", "gather_roll_vec.cu",
    {"ofpt_gather_roll_vec": [_P, _P, _P, _P] + [_I] * 5 + [_P]},
)
# the realtime engine's ring write and locate step (no TPU kernel: the JAX
# engine's XLA program), in place; the plain version counts its calls here
# too, its ring writes under plain_variants["ring_write"]
LOCATE_BLOCK = Kernel(
    "locate_block", "locate_block.cu",
    {"ofpt_locate_block": [_P] * 28,
     "ofpt_locate_streams": [_P, _I, _I] + [_P] * 12},
    # every multiply and add rounds on its own, as in the plain version
    extra_flags=("-fmad=false",),
)
# the CCCNN's bf16 DFT head, K3's features to the dense layer's outputs
# (no TPU kernel: XLA runs the JAX package's head)
CCCNN_HEAD = Kernel(
    "cccnn_head", "cccnn_head.cu",
    {"ofpt_cccnn_head": [_P] * 8},
)
KERNELS = (DETECTOR, DETECTOR_WARP, DETECTOR_PIPE, DETECTOR_PIPE_COUPLED,
           GATHER, CONV_STACK,
           CONV_STACK_MMA, CONV_STACK_MMA_CLUSTER, GATHER_ROLL, GATHER_VEC,
           GATHER_ROLL_VEC, LOCATE_BLOCK, CCCNN_HEAD)


def ring_writes(variants) -> int:
    """The launches of ``LOCATE_BLOCK`` (``variants``, its launches by
    instantiation) that wrote the ring: the variants named ``"ring"``."""
    return sum(n for v, n in variants.items() if "ring" in v.split("+"))
