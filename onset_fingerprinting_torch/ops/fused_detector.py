"""Fused streaming amplitude detector: the wrapper of kernel K1.

Port of ``onset_fingerprinting_tpu.ops.pallas_detector``.  The kernel
(``csrc/detector.cu``) runs a whole chunk ``x [T, C]`` in one launch with
one thread per channel and all state carried in registers; the plain
version is ``detect.amplitude.detect_offline`` / ``warmup_minmax``.

Dispatch is by device: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel (or raises on what the kernel does not take).  State
is functional: the kernel updates fresh copies of the state tensors, and
the caller's state is left as it was.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from onset_fingerprinting_torch.core.config import DetectorConfig
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
#: threads per CTA (one channel each) outside the coupled_off mode
THREADS = 64
#: largest shared-memory block stage; above it a device scratch is used
_MAX_SMEM = 200 * 1024
#: coupled_off runs every channel in one CTA (pallas_detector.py:551-555)
MAX_COUPLED_CHANNELS = 1024


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
           state: DetectorState, x: torch.Tensor) -> None:
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


def _launch(fstatic: FusedDetectorStatic, params: DetectorParams,
            state: DetectorState, x: torch.Tensor, emit_rel: bool,
            warmup: bool):
    _check(fstatic, params, state, x)
    s = fstatic.plain
    t, c = x.shape
    bsz = s.block_size
    nb = t // bsz
    k = sample_constants(s)
    p = _DetParams(
        T=t, C=c, bsz=bsz, use_iir=int(s.use_hipass), manual=int(s.manual),
        coupled=int(s.coupled_off), backtrack=int(s.backtrack),
        warmup=int(warmup), emit_rel=int(emit_rel and not warmup),
        nbt=s.bt_size, cooldown=float(s.cooldown), floor_db=k["floor"],
        eps=k["eps"], k_db=k["k_db"], k_lin=k["k_lin"], fa=k["fa"],
        fr=k["fr"], sa=k["sa"], sr=k["sr"], am=k["am"], ax=k["ax"],
        iam=k["iam"], iax=k["iax"], minmin=k["minmin"],
        b0=fstatic.iir_b[0], b1=fstatic.iir_b[1], b2=fstatic.iir_b[2],
        b3=fstatic.iir_b[3], b4=fstatic.iir_b[4], a1=fstatic.iir_a[1],
        a2=fstatic.iir_a[2], a3=fstatic.iir_a[3], a4=fstatic.iir_a[4],
        bt_alpha=k["bt_alpha"], bt_omba=k["bt_omba"], bt_tol=k["bt_tol"],
    )
    # the kernel updates these copies in place; the caller's state stays
    new = DetectorState(*(v.clone() for v in state))
    dev = x.device
    on = deltas = rel = None
    if not warmup:
        on = torch.empty((nb, c), dtype=torch.bool, device=dev)
        deltas = torch.empty((nb, c), dtype=torch.int32, device=dev)
        if emit_rel:
            rel = torch.empty((t, c), dtype=torch.float32, device=dev)
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

    def ptr(v):
        return None if v is None else v.data_ptr()

    bt = s.backtrack
    _cuda.DETECTOR.launch(
        "ofpt_detect", ctypes.addressof(p), x.data_ptr(),
        params.on_threshold.contiguous().data_ptr(),
        params.off_threshold.contiguous().data_ptr(),
        ptr(new.zi) if s.use_hipass else None, new.fast.data_ptr(),
        new.slow.data_ptr(), new.min_val.data_ptr(), new.max_val.data_ptr(),
        new.gate.data_ptr(), new.prev_rel.data_ptr(), new.debounce.data_ptr(),
        ptr(new.bt_buffer) if bt else None,
        ptr(state.bt_pos) if bt else None, ptr(new.bt_pos) if bt else None,
        ptr(on), ptr(deltas), ptr(rel), ptr(scratch), threads, _cuda.stream(),
    )
    return new, (on, deltas, rel)


def fused_detect_offline(fstatic: FusedDetectorStatic, params: DetectorParams,
                         state: DetectorState, x: torch.Tensor,
                         emit_rel: bool = True):
    """Detector over ``x [T, C]`` (T a multiple of the block size) →
    ``(new_state, (on [nb, C] bool, deltas [nb, C] int32, rel [T, C] or
    None))``, the contract of ``detect_offline``.  ``emit_rel=False``
    writes no relative envelope."""
    if x.device.type == "cpu":
        st, (on, d, rel) = detect_offline(fstatic.plain, params, state, x)
        return st, (on, d, rel if emit_rel else None)
    return _launch(fstatic, params, state, x, emit_rel, warmup=False)


def fused_warmup_minmax(fstatic: FusedDetectorStatic, params: DetectorParams,
                        state: DetectorState, x: torch.Tensor
                        ) -> DetectorState:
    """``warmup_minmax`` through the kernel's warmup mode: advances the
    filter, envelopes and min/max tracker only, writes no events."""
    if x.device.type == "cpu":
        return warmup_minmax(fstatic.plain, params, state, x)
    new, _ = _launch(fstatic, params, state, x, False, warmup=True)
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
