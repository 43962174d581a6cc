"""The offline detect → fingerprint fleet path (single device).

Port of bench.py:218-318 and 520-524 (the single-device form of
``parallel/sharding.py``): per chunk of fleet audio ``x [T, S·cps]``,

1. the fused detector (kernel K1) turns the audio into per-block events,
   carrying its state to the next chunk;
2. ``top_hit_blocks`` → ``compact_hit_list`` build a global hit list of
   fixed capacity G with sample-anchored starts;
3. the window gather (kernel K2) cuts ``[G, cps, W]`` windows with the
   onset at index ``PRE``;
4. the flagship CCCNN (conv stack = kernel K3) maps every window to
   ``[G, 2]`` coordinates.

Calling the pipeline returns ``(state, preds, n_hits, n_dropped)`` and
reads ``n_dropped`` once: a truncated hit list raises
:class:`HitCapacityError`, never silently.

Spans (``utils.metrics.trace``, profiler ranges while a profiler records):
``fleet.call`` around a call, ``fleet.detect``, ``fleet.hit_list``,
``fleet.windows`` and ``fleet.predict`` inside the stage methods, and
``fleet.dropped_read`` around the read of ``n_dropped``.
"""

from __future__ import annotations

import torch

from onset_fingerprinting_torch.core.config import DetectorConfig
from onset_fingerprinting_torch.detect.amplitude import DetectorState
from onset_fingerprinting_torch.device import resolve_device
from onset_fingerprinting_torch.models.cccnn import CCCNN
from onset_fingerprinting_torch.ops.fused_detector import (
    fused_detect_offline,
    fused_warmup_minmax,
    make_fused_detector,
)
from onset_fingerprinting_torch.ops.windows import (
    compact_hit_list,
    gather_hit_windows,
    top_hit_blocks,
)
from onset_fingerprinting_torch.workload import (
    CHANNELS_PER_STREAM,
    PRE,
    SR,
    WINDOW,
    chunk_capacities,
)
from onset_fingerprinting_torch.utils.metrics import trace


class HitCapacityError(RuntimeError):
    """The compacted hit list truncated real hits — a capacity-sizing bug,
    counted and failed on, never silent (bench.py:117-122)."""


def fleet_detector_config(n_streams: int) -> DetectorConfig:
    """The fleet detector (bench.py:339-344): block 128, 2 kHz high-pass,
    and per-channel off-gating so independent streams do not couple."""
    return DetectorConfig(
        n_channels=n_streams * CHANNELS_PER_STREAM, block_size=128,
        hipass_freq=2000.0, sr=SR, coupled_off_gate=False,
    )


class DetectFingerprint:
    """The fleet path with its stages exposed (see module docstring)."""

    def __init__(self, cfg: DetectorConfig, model: CCCNN, n_streams: int,
                 chunk_samples: int, global_capacity: int, device=None):
        self.device = resolve_device(device)
        if cfg.n_channels != n_streams * CHANNELS_PER_STREAM:
            raise ValueError("cfg.n_channels must be n_streams * 4")
        if chunk_samples % cfg.block_size:
            raise ValueError("chunk_samples must be a block multiple")
        self.cfg = cfg
        self.model = model.to(self.device).eval()
        self.n_streams = n_streams
        self.chunk_samples = chunk_samples
        self.global_capacity = global_capacity
        self.max_hits = chunk_capacities(n_streams, chunk_samples)[0]
        self.static, self.params, self._state0, _ = make_fused_detector(
            cfg, emit_rel=False, device=self.device
        )

    def init_state(self) -> DetectorState:
        return DetectorState(*(v.clone() for v in self._state0))

    def warmup(self, state: DetectorState, x: torch.Tensor) -> DetectorState:
        """Warm the envelopes and min/max tracker on lead-in audio (T a
        block multiple) without detecting (bench.py:402-405)."""
        return fused_warmup_minmax(self.static, self.params, state, x)

    def detect(self, state: DetectorState, x: torch.Tensor):
        """→ ``(state, on [nb, C] bool, deltas [nb, C] int32)``."""
        with trace("fleet.detect"):
            state, (on, deltas, _) = fused_detect_offline(
                self.static, self.params, state, x, emit_rel=False
            )
        return state, on, deltas

    def hit_list(self, on: torch.Tensor, deltas: torch.Tensor):
        """→ ``(starts [G], stream_ids [G], valid [G], n_dropped)`` with
        sample-anchored starts."""
        with trace("fleet.hit_list"):
            st, v = top_hit_blocks(on, self.cfg.block_size, self.n_streams,
                                   self.max_hits, deltas)
            return compact_hit_list(st, v, self.global_capacity)

    def windows(self, x: torch.Tensor, starts: torch.Tensor,
                stream_ids: torch.Tensor) -> torch.Tensor:
        with trace("fleet.windows"):
            return gather_hit_windows(x, starts, stream_ids,
                                      CHANNELS_PER_STREAM, WINDOW, pre=PRE,
                                      anchored=True)

    def predict(self, windows: torch.Tensor, valid: torch.Tensor
                ) -> torch.Tensor:
        with trace("fleet.predict"):
            with torch.inference_mode():
                preds = self.model(windows)
            return torch.where(valid[:, None], preds, 0.0)

    def fingerprint(self, x: torch.Tensor, on: torch.Tensor,
                    deltas: torch.Tensor):
        """→ ``(preds [G, 2], n_hits, n_dropped)`` (device scalars)."""
        starts, sids, valid, n_dropped = self.hit_list(on, deltas)
        preds = self.predict(self.windows(x, starts, sids), valid)
        return preds, valid.sum(), n_dropped

    def __call__(self, state: DetectorState, x: torch.Tensor):
        """One chunk ``x [chunk_samples, C]`` → ``(state, preds [G, 2],
        n_hits, n_dropped)``; raises :class:`HitCapacityError` when the
        hit list dropped hits (one device→host read per call)."""
        if tuple(x.shape) != (self.chunk_samples, self.cfg.n_channels):
            raise ValueError(
                f"x must be [{self.chunk_samples}, {self.cfg.n_channels}]"
            )
        with trace("fleet.call"):
            state, on, deltas = self.detect(state, x)
            preds, n_hits, n_dropped = self.fingerprint(x, on, deltas)
            with trace("fleet.dropped_read"):
                dropped = int(n_dropped)
        if dropped > 0:
            raise HitCapacityError(
                f"compacted hit list dropped {dropped} hits "
                f"(capacity {self.global_capacity})"
            )
        return state, preds, n_hits, n_dropped


def make_detect_fingerprint(cfg: DetectorConfig, model: CCCNN,
                            n_streams: int, chunk_samples: int,
                            global_capacity: int, device=None
                            ) -> DetectFingerprint:
    """The fleet pipeline on ``device`` (None = the card): call it as
    ``run(state, x) → (state, preds [G, 2], n_hits, n_dropped)``."""
    return DetectFingerprint(cfg, model, n_streams, chunk_samples,
                             global_capacity, device)
