"""Unified configuration tree.

One dataclass tree, JSON round-trippable, replacing the reference's four
config mechanisms (module constants realtime/config.py:14-60, ml_conf.json
config.py:87-108, physics module constants multilateration.py:10-20, argparse
flags in the editors) — see SURVEY.md §5.6.

Also *defines* the analysis constants the reference uses but never declares
(``MAX_OFFSET``/``MAX_LENGTH``/``AVG_OFFSET``/``AVG_LENGTH``/``DELTA``/
``WAIT``/``ONSET_DET_OFFSET`` referenced at realtime/recording.py:304-310,
407-423,498 — the R5 latent defect in SURVEY.md §2.5).  Values follow
librosa's onset_detect defaults scaled to the configured sr/hop.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional


@dataclass
class DetectorConfig:
    """Amplitude onset detector operating point (detection.py:631-646)."""

    n_channels: int = 3
    block_size: int = 128
    floor: float = -70.0
    hipass_freq: float = 2000.0
    fast_attack: float = 3.0
    fast_release: float = 383.0
    slow_attack: float = 2205.0
    slow_release: float = 2205.0
    on_threshold: float = 0.5
    off_threshold: float = 0.1
    cooldown: int = 1323
    backtrack: bool = False
    backtrack_buffer_size: int = 128
    backtrack_smooth_size: int = 5
    minmax_alpha_min: float = 1e-4
    minmax_alpha_max: float = 1e-5
    minmax_floor: float = 2.0
    sr: int = 96000
    #: keep the reference's cross-channel off-gate quirk (detection.py:790);
    #: set False when batching independent streams as channels
    coupled_off_gate: bool = True


@dataclass
class GeometryConfig:
    """Drum + sensor geometry (multilateration.py:319-361)."""

    #: relative polar/spherical sensor locations: (r, phi) or (r, phi, theta)
    sensor_locations: list = field(default_factory=list)
    drum_diameter: float = 14 * 2.54
    medium: str = "drumhead"
    sr: int = 96000
    #: speed of sound in m/s; None → derive from medium
    c: Optional[float] = None
    onset_tolerance: int = 50
    normalization_cutoff: int = 10


@dataclass
class RealtimeConfig:
    """Realtime engine settings (realtime/config.py:14-60), with the missing
    analysis constants defined (see module docstring)."""

    sr: int = 96000
    channels: list = field(default_factory=lambda: [0, 1, 2])
    blocksize: int = 128
    latency: float = 0.001
    max_recording_seconds: int = 60
    n_fft: int = 2048
    hop_length: int = 128
    tg_win_length: int = 1024
    blend_length: float = 0.05
    quantize_ms: float = 0.2

    @property
    def n_channels(self) -> int:
        return max(self.channels) + 1

    @property
    def rec_n(self) -> int:
        return self.max_recording_seconds * self.sr

    @property
    def n_stft(self) -> int:
        import math

        return math.ceil(self.rec_n / self.hop_length)

    @property
    def tg_pad(self) -> int:
        return 2 * self.tg_win_length - 1

    # -- onset picking constants (librosa onset_detect defaults @ sr/hop),
    #    fixing the reference's undefined-config defect (SURVEY §2.5 R5).
    @property
    def max_offset(self) -> int:  # pre_max: 0.03 s
        return int(0.03 * self.sr // self.hop_length)

    @property
    def max_length(self) -> int:  # pre_max + post_max window
        return int(0.03 * self.sr // self.hop_length) * 2 + 1

    @property
    def avg_offset(self) -> int:  # pre_avg: 0.1 s
        return int(0.1 * self.sr // self.hop_length)

    @property
    def avg_length(self) -> int:
        return int(0.1 * self.sr // self.hop_length) * 2 + 1

    #: onset-strength threshold above moving average
    delta: float = 0.07

    @property
    def wait(self) -> int:  # 0.03 s debounce between picked onsets
        return int(0.03 * self.sr // self.hop_length)

    @property
    def onset_det_offset(self) -> int:
        """Frames of lookahead the online picker needs before reporting."""
        return int(0.03 * self.sr // self.hop_length) + 1


@dataclass
class TrainConfig:
    """Model training settings (train.py:92-105, calibration.py:563-605)."""

    lr: float = 1e-3
    num_epochs: int = 1000
    min_epochs: int = 0
    patience: int = 500
    eps: float = 1e-9
    batch_size: Optional[int] = None  # None = full batch, like the reference
    loss: str = "l1"
    seed: int = 0
    optimizer: str = "nadam"
    grad_clip: float = 1.0
    #: L2 weight decay (optax.add_decayed_weights); 0 = off
    weight_decay: float = 0.0


@dataclass
class PipelineConfig:
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    geometry: GeometryConfig = field(default_factory=GeometryConfig)
    realtime: RealtimeConfig = field(default_factory=RealtimeConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def _to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def save_config(cfg, path: str | Path) -> None:
    """Serialize any config dataclass (or the full tree) to JSON."""
    d = {"__type__": type(cfg).__name__, **_to_dict(cfg)}
    Path(path).write_text(json.dumps(d, indent=2))


_TYPES = {
    c.__name__: c
    for c in (
        DetectorConfig,
        GeometryConfig,
        RealtimeConfig,
        TrainConfig,
        PipelineConfig,
    )
}


def load_config(path: str | Path):
    d = json.loads(Path(path).read_text())
    name = d.pop("__type__", "PipelineConfig")
    cls = _TYPES[name]
    if cls is PipelineConfig:
        return PipelineConfig(
            detector=DetectorConfig(**d["detector"]),
            geometry=GeometryConfig(**d["geometry"]),
            realtime=RealtimeConfig(**d["realtime"]),
            train=TrainConfig(**d["train"]),
        )
    return cls(**d)
