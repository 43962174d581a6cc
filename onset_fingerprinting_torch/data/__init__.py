"""Data: the synthetic modal-drum sessions, frame extraction, the
augmentations, the MCPOSD location dataset and the POSD classification
dataset (pandas only where a DataFrame is made)."""

from onset_fingerprinting_torch.data.frames import (
    FastFrameExtractor,
    FrameExtractor,
    StretchFrameExtractor,
    extract_frames,
)
from onset_fingerprinting_torch.data.augment import (
    AUGMENTATIONS,
    air_absorption,
    gaussian_noise,
    seven_band_eq,
    some_of,
    tanh_distortion,
)
from onset_fingerprinting_torch.data.datasets import MCPOSD, POSD
