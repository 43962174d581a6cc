"""Fused streaming amplitude detector: the wrapper of kernel K1.

Port of ``onset_fingerprinting_tpu.ops.pallas_detector``.  One launch runs
a whole chunk ``x [T, C]`` with all state carried; the plain version is
``detect.amplitude.detect_offline`` / ``warmup_minmax``.  Three kernels
(four routes), and :func:`kernel_for` (a static test of the config and
the chunk's length T, no fallback) says which:

- ``coupled_off=False`` (the fleet path) with a block a multiple of
  ``PIPE_SUB_ROWS``: ``csrc/detector_pipe.cu`` (counter
  ``_cuda.DETECTOR_PIPE``), a warp-specialised pipeline.  A CTA owns 32
  channels, one per lane, and runs three warps over them, one chain of the
  per-sample scan each, handing sub-blocks of 16 rows through rings in
  shared memory (:func:`pipe_plan`);
- ``coupled_off=True`` (the off check couples a detector's channels) at
  most ``WARP_MAX_CHANNELS`` channels over more than one block (mining,
  the tuner, the engine's warmup, time sharding): the same pipe's coupled
  instantiation (counter ``_cuda.DETECTOR_PIPE_COUPLED``, variant
  ``"coupled"``), its lanes in groups of C, one detector per group
  (:func:`coupled_plan`); :func:`fused_detect_streams` runs it over a
  batch of independent streams in one launch, several streams a CTA
  (variant ``"coupled_streams"``: the sharded serve path's);
- the same at one block (T equal to the block size: the realtime engine's
  step, captured in its CUDA graph): ``csrc/detector_warp.cu`` (counter
  ``_cuda.DETECTOR_WARP``), one CTA, one warp per channel, the
  element-wise passes spread over the lanes.  It takes the step because
  a ``[128, 3]`` launch is latency, not throughput: PR 7 shaped it for
  that, and the pipe's three-stage hand-off only pays over many
  sub-blocks (``PERF.md`` times both there);
- ``coupled_off=True`` with more channels (at most 1024):
  ``csrc/detector.cu`` (counter ``_cuda.DETECTOR``), one thread per
  channel.  So does a block size the pipe has no plan for (not a multiple
  of 16, or above 1712 samples).  That route exists only to keep such
  block sizes working: every config in this package and in the JAX one
  uses 128, 64 or 32.

Dispatch is by device: a CPU tensor runs the plain version (counted in
the ``plain_calls`` of the kernel ``kernel_for`` names), a CUDA tensor
launches that kernel (or raises on what it does not take; a failed build
or launch raises too).  The kernels update the state buffers they are
given in place.  Without ``out=`` the wrappers hand them fresh copies and
the caller's state is left as it was; with ``out=`` (which may be the
input state itself) the new state is written there, on the CPU by
``copy_``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from onset_fingerprinting_torch.core.config import DetectorConfig
from onset_fingerprinting_torch.core.tree import write_into
from onset_fingerprinting_torch.detect.amplitude import (
    DetectorParams,
    DetectorState,
    _Static,
    detect_offline,
    detector_init,
    sample_constants,
    warmup_minmax,
)
from onset_fingerprinting_torch.ops import _cuda

ORDER = 4
#: detector.cu: threads per CTA (one channel each) outside coupled_off
THREADS = 64
#: detector.cu: largest shared-memory block stage; above it a device
#: scratch is used
_MAX_SMEM = 200 * 1024
#: coupled_off runs every channel in one CTA (pallas_detector.py:551-555)
MAX_COUPLED_CHANNELS = 1024
#: detector_warp.cu: one warp per channel in one CTA
WARP_MAX_CHANNELS = 32

# detector_pipe.cu's launch constants (its G, SB, NX, ND, THREADS, MIN_CTAS)
#: channels per CTA, one per lane
PIPE_CHANNELS = 32
#: the warps of a CTA, in order, and the chain each runs
PIPE_ROLES = ("iir_db", "envelopes_rel", "minmax_events")
#: rows of one sub-block, the unit the warps hand each other
PIPE_SUB_ROWS = 16
#: slots of warp 0's x ring (cp.async prefetch) and of the dB ring
PIPE_X_SLOTS = 3
PIPE_DB_SLOTS = 2
#: registers per thread that ``__launch_bounds__(96, 8)`` leaves
PIPE_REGS = 80
#: the coupled instantiation: ``__launch_bounds__(96, 4)``
COUPLED_REGS = 168
#: the coupled instantiation's rel ring, in blocks (its REL_BLOCKS); the
#: most live lanes at which it spreads the dB and exp2 over all lanes (its
#: SPREAD_LANES), and the rows of a sub-block then, where the block size
#: allows (its SB_FEW)
COUPLED_REL_BLOCKS = 2
COUPLED_SPREAD_LANES = 8
COUPLED_FEW_SUB_ROWS = 64
#: the H100's per-SM limits: shared memory (and the 1 KB the system
#: reserves of it per CTA), resident threads, CTAs, registers; its SMs
SM_SMEM, CTA_SMEM_RESERVED, CTA_SMEM_MAX = 233472, 1024, 232448
SM_THREADS, SM_CTAS, SM_REGS, SMS = 2048, 32, 65536, 132


class FusedDetectorStatic(NamedTuple):
    plain: _Static
    iir_b: tuple  # 5 float32 values; identity filter when hipass is off
    iir_a: tuple


class _DetParams(ctypes.Structure):
    # must match csrc/detector.cu::DetParams field for field
    _fields_ = [(n, ctypes.c_int) for n in (
        "T", "C", "bsz", "use_iir", "manual", "coupled", "backtrack",
        "warmup", "emit_rel", "nbt",
    )] + [(n, ctypes.c_float) for n in (
        "cooldown", "floor_db", "eps", "k_db", "k_lin", "fa", "fr", "sa",
        "sr", "am", "ax", "iam", "iax", "minmin", "b0", "b1", "b2", "b3",
        "b4", "a1", "a2", "a3", "a4", "bt_alpha", "bt_omba", "bt_tol",
    )]


class PipePlan(NamedTuple):
    """How ``csrc/detector_pipe.cu`` lays a detector out on the card."""

    channels_per_cta: int
    roles: tuple          # one warp per role, in warp order
    threads: int
    sub_rows: int
    x_slots: int          # warp 0's own ring of x sub-blocks
    db_slots: int         # dB sub-blocks, warp 0 -> warp 1
    rel_slots: int        # rel sub-blocks, warp 1 -> warp 2: a whole block
    smem_bytes: int       # dynamic shared memory of one CTA
    ctas: int
    ctas_per_sm: int      # the least of the shared-memory, thread, CTA and
    #                       register limits
    waves: int


def pipe_plan(n_channels: int, block_size: int, rel_blocks: int = 1,
              sub_rows: int = PIPE_SUB_ROWS) -> PipePlan | None:
    """The pipelined kernel's launch plan, or None where it takes no such
    block size (not a multiple of ``sub_rows``, or ``rel_blocks`` whole
    blocks of rel that would not fit one CTA's shared memory).  Mirrors
    ``csrc/detector_pipe.cu::pipe_smem_bytes`` and its launch."""
    if block_size <= 0 or block_size % sub_rows:
        return None
    rel_slots = rel_blocks * block_size // sub_rows
    slot = sub_rows * PIPE_CHANNELS * 4
    n_bars = 2 * PIPE_DB_SLOTS + 2 * rel_slots
    smem = (-(-8 * n_bars // 16) * 16
            + (PIPE_X_SLOTS + PIPE_DB_SLOTS + rel_slots) * slot)
    if smem > CTA_SMEM_MAX:
        return None
    threads = 32 * len(PIPE_ROLES)
    ctas = -(-n_channels // PIPE_CHANNELS)
    per_sm = min(SM_SMEM // (smem + CTA_SMEM_RESERVED), SM_THREADS // threads,
                 SM_CTAS, SM_REGS // (threads * PIPE_REGS))
    return PipePlan(PIPE_CHANNELS, PIPE_ROLES, threads, sub_rows,
                    PIPE_X_SLOTS, PIPE_DB_SLOTS, rel_slots, smem, ctas, per_sm,
                    -(-ctas // (SMS * per_sm)))


class CoupledPlan(NamedTuple):
    """How the pipe's coupled instantiation lays S detectors of C coupled
    channels out on the card (its rings are :func:`pipe_plan`'s)."""

    channels: int         # C, one lane each
    groups_per_cta: int   # detectors (streams) a CTA holds, a lane group
    #                       each
    live_lanes: int       # groups_per_cta * C: a ring row's width
    spread: bool          # dB and exp2 across all lanes (few live lanes)
    sub_rows: int         # rows of a sub-block (more with few live lanes)
    rel_slots: int        # the rel ring: COUPLED_REL_BLOCKS blocks
    threads: int
    smem_bytes: int       # dynamic shared memory of one CTA
    ctas: int
    ctas_per_sm: int      # the least of the shared-memory, thread, CTA and
    #                       register limits
    waves: int


def coupled_plan(n_streams: int, n_channels: int, block_size: int,
                 groups_per_cta: int | None = None) -> CoupledPlan | None:
    """The coupled pipe's launch plan for ``n_streams`` detectors of
    ``n_channels`` coupled channels, or None where it takes no such
    detector (more than 32 channels, or a block size with no pipe plan).
    By default a CTA takes ``ceil(S / SMS)`` groups, at most ``32 // C``:
    one CTA per SM first, then more groups a CTA (at 1024 streams of 3,
    8 a CTA and 10 a CTA read alike on the H100).  At most
    ``COUPLED_SPREAD_LANES`` live lanes spread the dB and exp2 and take
    sub-blocks of ``COUPLED_FEW_SUB_ROWS``.  ``groups_per_cta`` overrides
    the layout (a measurement compares layouts).  Mirrors
    ``csrc/detector_pipe.cu``'s ``ofpt_detect_pipe_coupled``."""
    if (pipe_plan(n_channels, block_size) is None
            or not 1 <= n_channels <= WARP_MAX_CHANNELS):
        return None
    most = PIPE_CHANNELS // n_channels
    gpc = (min(most, max(1, -(-n_streams // SMS))) if groups_per_cta is None
           else groups_per_cta)
    if not 1 <= gpc <= most:
        raise ValueError(f"{gpc} groups of {n_channels} channels do not fit "
                         f"{PIPE_CHANNELS} lanes")
    few = gpc * n_channels <= COUPLED_SPREAD_LANES
    rows = (COUPLED_FEW_SUB_ROWS
            if few and block_size % COUPLED_FEW_SUB_ROWS == 0
            else PIPE_SUB_ROWS)
    pipe = pipe_plan(n_channels, block_size, COUPLED_REL_BLOCKS, rows)
    if pipe is None:
        return None
    ctas = -(-n_streams // gpc)
    per_sm = min(SM_SMEM // (pipe.smem_bytes + CTA_SMEM_RESERVED),
                 SM_THREADS // pipe.threads, SM_CTAS,
                 SM_REGS // (pipe.threads * COUPLED_REGS))
    return CoupledPlan(n_channels, gpc, gpc * n_channels, few, rows,
                       pipe.rel_slots, pipe.threads, pipe.smem_bytes, ctas,
                       per_sm, -(-ctas // (SMS * per_sm)))


def warp_smem_bytes(n_channels: int, block_size: int) -> int:
    """``csrc/detector_warp.cu``'s dynamic shared memory: two stages of a
    block, one padded column of ``block_size + 1`` floats per channel."""
    return 2 * n_channels * (block_size + 1) * 4


def kernel_for(static: _Static, t: int | None = None) -> _cuda.Kernel:
    """The kernel a CUDA chunk of ``t`` samples (default one block) of this
    detector runs on: the pipe for per-channel gating; for the coupled
    off-gate at up to ``WARP_MAX_CHANNELS`` channels the pipe's coupled
    instantiation over more than one block, the warp-per-channel kernel
    for one block (the engine's step); else ``detector.cu`` (more coupled
    channels, or a block size whose rings exceed one CTA's shared memory:
    the pipe's, the coupled pipe's two blocks of rel, the warp kernel's two
    stages; no config uses such a size).  A static test; no launch ever
    swaps kernels."""
    c, bsz = static.n_channels, static.block_size
    t = bsz if t is None else t
    if pipe_plan(c, bsz) is None:
        return _cuda.DETECTOR
    if not static.coupled_off:
        return _cuda.DETECTOR_PIPE
    if c > WARP_MAX_CHANNELS:
        return _cuda.DETECTOR
    if t > bsz:
        return (_cuda.DETECTOR_PIPE_COUPLED if coupled_plan(1, c, bsz)
                else _cuda.DETECTOR)
    if warp_smem_bytes(c, bsz) <= CTA_SMEM_MAX:
        return _cuda.DETECTOR_WARP
    return _cuda.DETECTOR


def detector_static(static: _Static, params: DetectorParams
                    ) -> FusedDetectorStatic:
    """Bake a detector config and its designed IIR into kernel constants."""
    if static.use_hipass:
        iir_b = tuple(float(v) for v in params.b.cpu())
        iir_a = tuple(float(v) for v in params.a.cpu())
    else:
        iir_b = (1.0, 0.0, 0.0, 0.0, 0.0)
        iir_a = (1.0, 0.0, 0.0, 0.0, 0.0)
    if len(iir_b) != ORDER + 1 or len(iir_a) != ORDER + 1:
        raise ValueError(f"the kernel takes a 4th-order IIR, got {iir_b}")
    return FusedDetectorStatic(static, iir_b, iir_a)


def _check(fstatic: FusedDetectorStatic, params: DetectorParams,
           state: DetectorState, x: torch.Tensor, out=None) -> None:
    s = fstatic.plain
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 [T, C] tensor")
    t, c = x.shape
    if t % s.block_size:
        raise ValueError(f"T={t} is not a multiple of the block size "
                         f"{s.block_size}")
    if c != s.n_channels:
        raise ValueError(f"x has {c} channels, the detector {s.n_channels}")
    if s.coupled_off and c > MAX_COUPLED_CHANNELS:
        raise ValueError(
            f"coupled_off couples all channels in one CTA: at most "
            f"{MAX_COUPLED_CHANNELS} channels, got {c}"
        )
    tensors = list(state) + [params.on_threshold, params.off_threshold]
    if any(v.device != x.device for v in tensors):
        raise ValueError("state, params and x must be on one device")
    for v in (params.on_threshold, params.off_threshold, state.fast,
              state.slow, state.min_val, state.max_val, state.prev_rel):
        if v.dtype != torch.float32 or v.shape != (c,):
            raise ValueError("thresholds and state vectors must be float32 "
                             f"[{c}]")
    if state.gate.dtype != torch.bool or state.debounce.dtype != torch.int32:
        raise ValueError("gate must be bool and debounce int32")
    want_zi = (ORDER, c) if s.use_hipass else (0, c)
    if tuple(state.zi.shape) != want_zi:
        raise ValueError(f"zi must be {want_zi}, got {tuple(state.zi.shape)}")
    if tuple(state.bt_buffer.shape) != (s.bt_size, c):
        raise ValueError("bt_buffer must be [bt_size, C]")
    if out is not None and any(
            o.shape != v.shape or o.dtype != v.dtype or o.device != v.device
            or not o.is_contiguous() for o, v in zip(out, state, strict=True)):
        raise ValueError("out must be a contiguous state like the input's")


def _det_params(fstatic: FusedDetectorStatic, t: int, c: int,
                emit_rel: bool, warmup: bool) -> _DetParams:
    """The kernels' parameter block for a chunk of ``t`` samples of ``c``
    channels."""
    s = fstatic.plain
    k = sample_constants(s)
    return _DetParams(
        T=t, C=c, bsz=s.block_size, use_iir=int(s.use_hipass),
        manual=int(s.manual), coupled=int(s.coupled_off),
        backtrack=int(s.backtrack), warmup=int(warmup),
        emit_rel=int(emit_rel and not warmup), nbt=s.bt_size,
        cooldown=float(s.cooldown), floor_db=k["floor"], eps=k["eps"],
        k_db=k["k_db"], k_lin=k["k_lin"], fa=k["fa"], fr=k["fr"],
        sa=k["sa"], sr=k["sr"], am=k["am"], ax=k["ax"], iam=k["iam"],
        iax=k["iax"], minmin=k["minmin"],
        b0=fstatic.iir_b[0], b1=fstatic.iir_b[1], b2=fstatic.iir_b[2],
        b3=fstatic.iir_b[3], b4=fstatic.iir_b[4], a1=fstatic.iir_a[1],
        a2=fstatic.iir_a[2], a3=fstatic.iir_a[3], a4=fstatic.iir_a[4],
        bt_alpha=k["bt_alpha"], bt_omba=k["bt_omba"], bt_tol=k["bt_tol"],
    )


def _launch(fstatic: FusedDetectorStatic, params: DetectorParams,
            state: DetectorState, x: torch.Tensor, emit_rel: bool,
            warmup: bool, kernel: _cuda.Kernel | None = None, out=None):
    """Launch ``kernel`` (default: :func:`kernel_for`'s) over the chunk.
    Only a measurement names another kernel, to time one kernel on a shape
    another one takes."""
    kernel, entry, args, res, _keep = launch_args(
        fstatic, params, state, x, emit_rel, warmup, kernel, out)
    kernel.launch(entry, *args, variant="coupled"
                  if entry == "ofpt_detect_pipe_coupled" else "")
    return res


def launch_args(fstatic: FusedDetectorStatic, params: DetectorParams,
                state: DetectorState, x: torch.Tensor, emit_rel: bool,
                warmup: bool, kernel: _cuda.Kernel | None = None, out=None):
    """``(kernel, C entry, its arguments, (new_state, (on, deltas, rel)),
    keep)`` of one launch: the outputs allocated (the new state is ``out``,
    or fresh copies of ``state``), nothing launched.  Hold ``keep`` (the
    parameter block and scratch the arguments point to) until the launch.
    The kernel updates the new state in place, so calling the entry again
    carries it on (a measurement times the bare entry so)."""
    _check(fstatic, params, state, x, out)
    s = fstatic.plain
    if kernel is None:
        kernel = kernel_for(s, x.shape[0])
    pipe = "ofpt_detect_pipe" in kernel.entries
    coupled = "ofpt_detect_pipe_coupled" in kernel.entries
    warp = "ofpt_detect_warp" in kernel.entries
    if (pipe or coupled) and pipe_plan(s.n_channels, s.block_size) is None:
        raise ValueError(f"the pipelined detector takes no block size "
                         f"{s.block_size}")
    if pipe and s.coupled_off:
        raise ValueError("the per-channel pipe does not couple channels")
    if coupled and (not s.coupled_off
                    or s.n_channels > WARP_MAX_CHANNELS):
        raise ValueError(f"the coupled pipe takes a coupled detector of at "
                         f"most {WARP_MAX_CHANNELS} channels")
    if warp and (s.n_channels > WARP_MAX_CHANNELS or warp_smem_bytes(
            s.n_channels, s.block_size) > CTA_SMEM_MAX):
        raise ValueError(f"the warp-per-channel detector takes at most "
                         f"{WARP_MAX_CHANNELS} channels and a block that "
                         "fits its shared memory")
    t, c = x.shape
    bsz = s.block_size
    nb = t // bsz
    p = _det_params(fstatic, t, c, emit_rel, warmup)
    # the kernel updates these buffers in place
    if out is None:
        new = DetectorState(*(v.clone() for v in state))
    else:
        new = write_into(out, state)
    bt_in = state.bt_pos
    if (s.backtrack and not (warp or coupled)
            and bt_in.data_ptr() == new.bt_pos.data_ptr()):
        # many CTAs read it while the first one writes it
        bt_in = bt_in.clone()
    dev = x.device
    on = deltas = rel = None
    if not warmup:
        on = torch.empty((nb, c), dtype=torch.bool, device=dev)
        deltas = torch.empty((nb, c), dtype=torch.int32, device=dev)
        if emit_rel:
            rel = torch.empty((t, c), dtype=torch.float32, device=dev)

    def ptr(v):
        return None if v is None else v.data_ptr()

    bt = s.backtrack or warp  # the warp kernel always carries bt_pos
    args = (
        ctypes.addressof(p), x.data_ptr(),
        params.on_threshold.contiguous().data_ptr(),
        params.off_threshold.contiguous().data_ptr(),
        ptr(new.zi) if s.use_hipass else None, new.fast.data_ptr(),
        new.slow.data_ptr(), new.min_val.data_ptr(), new.max_val.data_ptr(),
        new.gate.data_ptr(), new.prev_rel.data_ptr(), new.debounce.data_ptr(),
        ptr(new.bt_buffer) if s.backtrack else None,
        ptr(bt_in) if bt else None, ptr(new.bt_pos) if bt else None,
        ptr(on), ptr(deltas), ptr(rel),
    )
    res = (new, (on, deltas, rel))
    if pipe:
        return (kernel, "ofpt_detect_pipe", (*args, _cuda.stream()), res,
                (p, bt_in))
    if coupled:  # one recording: one stream, one lane group
        return (kernel, "ofpt_detect_pipe_coupled",
                (args[0], 1, 1, *args[1:], _cuda.stream()), res, (p, bt_in))
    if warp:
        return (kernel, "ofpt_detect_warp", (*args, _cuda.stream()), res,
                (p, bt_in))
    if s.coupled_off:
        threads = -(-c // 32) * 32
        blocks = 1
    else:
        threads = THREADS
        blocks = -(-c // threads)
    scratch = None
    if bsz * threads * 4 > _MAX_SMEM:
        scratch = torch.empty((bsz, blocks * threads), dtype=torch.float32,
                              device=dev)
    return (kernel, "ofpt_detect", (*args, ptr(scratch), threads,
                                    _cuda.stream()), res, (p, bt_in, scratch))


def fused_detect_offline(fstatic: FusedDetectorStatic, params: DetectorParams,
                         state: DetectorState, x: torch.Tensor,
                         emit_rel: bool = True, out=None):
    """Detector over ``x [T, C]`` (T a multiple of the block size) →
    ``(new_state, (on [nb, C] bool, deltas [nb, C] int32, rel [T, C] or
    None))``, the contract of ``detect_offline``.  ``emit_rel=False``
    writes no relative envelope.  ``out``: a state to write the new state
    into (it may be ``state``); the new state is then ``out``."""
    if x.device.type == "cpu":
        kernel_for(fstatic.plain, x.shape[0]).plain_calls += 1
        st, (on, d, rel) = detect_offline(fstatic.plain, params, state, x,
                                          out=out)
        return st, (on, d, rel if emit_rel else None)
    return _launch(fstatic, params, state, x, emit_rel, warmup=False,
                   out=out)


def fused_detect_streams(fstatic: FusedDetectorStatic,
                         params: DetectorParams, states: DetectorState,
                         x: torch.Tensor, emit_rel: bool = False,
                         groups_per_cta: int | None = None,
                         kernel: _cuda.Kernel | None = None):
    """The coupled detector over a batch of independent streams ``x [S, T,
    C]``, each from its own state (``states``: every field with a leading
    stream axis), in ONE launch of the kernel :func:`kernel_for` names for
    T: over more than one block the pipe's coupled instantiation, several
    streams a CTA, one lane group each (:func:`coupled_plan`, variant
    ``"coupled_streams"``; ``groups_per_cta`` overrides the plan's layout
    for a measurement), at one block ``csrc/detector_warp.cu``, one CTA per
    stream (variant ``"streams"``); the plain version runs
    ``detect_offline`` stream by stream.  Only a measurement names
    ``kernel``, to time one kernel at a length the other takes.  Returns
    ``(new states, (on [S, nb, C], deltas [S, nb, C], rel [S, T, C] or
    None))``; ``states`` stay as they were."""
    s = fstatic.plain
    if x.dim() != 3:
        raise ValueError("x must be [S, T, C]")
    n, t, c = x.shape
    if x.device.type == "cpu":
        kernel_for(s, t).plain_calls += 1
        res = [detect_offline(s, params, DetectorState(*(v[i] for v in
                                                         states)), x[i])
               for i in range(n)]
        new = DetectorState(*(torch.stack(f) for f in zip(
            *(r[0] for r in res))))
        on, d, rel = (torch.stack(f) for f in zip(*(r[1] for r in res)))
        return new, (on, d, rel if emit_rel else None)
    kernel = kernel_for(s, t) if kernel is None else kernel
    warp = "ofpt_detect_warp_streams" in kernel.entries
    if not (warp or "ofpt_detect_pipe_coupled" in kernel.entries):
        raise ValueError(
            "the stream-batched detector takes a coupled config of at most "
            f"{WARP_MAX_CHANNELS} channels")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32 [S, T, C] tensor")
    if t % s.block_size or c != s.n_channels:
        raise ValueError(f"x [{n}, {t}, {c}] does not fit the detector "
                         f"({s.n_channels} channels, block {s.block_size})")
    want = DetectorState(
        zi=(n, ORDER if s.use_hipass else 0, c), fast=(n, c), slow=(n, c),
        min_val=(n, c), max_val=(n, c), gate=(n, c), prev_rel=(n, c),
        debounce=(n, c), bt_buffer=(n, s.bt_size, c), bt_pos=(n,))
    if any(tuple(v.shape) != w or v.device != x.device
           or not v.is_contiguous() for v, w in zip(states, want)):
        raise ValueError("states must be contiguous, on x's device, with a "
                         f"leading stream axis of {n}")
    new = DetectorState(*(v.clone() for v in states))
    nb = t // s.block_size
    on = torch.empty((n, nb, c), dtype=torch.bool, device=x.device)
    deltas = torch.empty((n, nb, c), dtype=torch.int32, device=x.device)
    rel = (torch.empty((n, t, c), dtype=torch.float32, device=x.device)
           if emit_rel else None)
    p = _det_params(fstatic, t, c, emit_rel, False)
    tail = (params.on_threshold.contiguous().data_ptr(),
            params.off_threshold.contiguous().data_ptr(),
            new.zi.data_ptr() if s.use_hipass else None, new.fast.data_ptr(),
            new.slow.data_ptr(), new.min_val.data_ptr(),
            new.max_val.data_ptr(), new.gate.data_ptr(),
            new.prev_rel.data_ptr(), new.debounce.data_ptr(),
            new.bt_buffer.data_ptr() if s.backtrack else None,
            new.bt_pos.data_ptr(), new.bt_pos.data_ptr(), on.data_ptr(),
            deltas.data_ptr(), None if rel is None else rel.data_ptr(),
            _cuda.stream())
    if warp:
        kernel.launch("ofpt_detect_warp_streams", ctypes.addressof(p), n,
                      x.data_ptr(), *tail, variant="streams")
    else:
        plan = coupled_plan(n, c, s.block_size, groups_per_cta)
        kernel.launch("ofpt_detect_pipe_coupled", ctypes.addressof(p), n,
                      plan.groups_per_cta, x.data_ptr(), *tail,
                      variant="coupled_streams")
    return new, (on, deltas, rel)


def fused_warmup_minmax(fstatic: FusedDetectorStatic, params: DetectorParams,
                        state: DetectorState, x: torch.Tensor, out=None
                        ) -> DetectorState:
    """``warmup_minmax`` through the kernel's warmup mode: advances the
    filter, envelopes and min/max tracker only, writes no events.
    ``out`` as for :func:`fused_detect_offline`."""
    if x.device.type == "cpu":
        kernel_for(fstatic.plain, x.shape[0]).plain_calls += 1
        new = warmup_minmax(fstatic.plain, params, state, x)
        return new if out is None else write_into(out, new)
    new, _ = _launch(fstatic, params, state, x, False, warmup=True, out=out)
    return new


def make_fused_detector(cfg: DetectorConfig, emit_rel: bool = True,
                        device=None):
    """``(static, params, state, run)`` on ``device`` (None = the card);
    ``run(state, x)`` mirrors ``detect_offline``.  ``static`` is the
    :class:`FusedDetectorStatic` that ``fused_warmup_minmax`` takes."""
    static, params, state = detector_init(cfg, device)
    fstatic = detector_static(static, params)

    def run(state: DetectorState, x: torch.Tensor):
        return fused_detect_offline(fstatic, params, state, x, emit_rel)

    return fstatic, params, state, run
