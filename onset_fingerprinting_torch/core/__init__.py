"""The configuration tree, coordinates, the device audio ring and the POSD
file helpers (port of ``onset_fingerprinting_tpu.core``; ``config`` is a
jax-free copy)."""

from onset_fingerprinting_torch.core.ring_buffer import (
    CircularArray,
    RingBuffer,
    query_circular,
    ring_init,
    ring_read_last,
    ring_slice,
    ring_write,
)
from onset_fingerprinting_torch.core.coords import (
    cartesian_to_cylindrical,
    cartesian_to_polar,
    cartesian_to_spherical,
    cylindrical_to_cartesian,
    polar_to_cartesian,
    speed_of_sound,
    spherical_to_cartesian,
)
from onset_fingerprinting_torch.core.config import (
    DetectorConfig,
    GeometryConfig,
    PipelineConfig,
    RealtimeConfig,
    TrainConfig,
    load_config,
    save_config,
)
from onset_fingerprinting_torch.core import posd
