"""Onset detectors: the streaming amplitude detector (K1 on the card), the
spectral-flux detector, grouping and refinement."""

from onset_fingerprinting_torch.detect.amplitude import (
    AmplitudeOnsetDetector,
    DetectorState,
    detect_block,
    detect_offline,
    detect_offline_chunked,
    detect_onsets_amplitude,
    detector_init,
    warmup_minmax,
)
from onset_fingerprinting_torch.detect.spectral import (
    detect_onsets_spectral,
    peak_pick,
)
from onset_fingerprinting_torch.detect.grouping import find_onset_groups
from onset_fingerprinting_torch.detect.refine import (
    adjust_onset,
    adjust_onset_rel,
    detect_onset_region,
    filter_data,
    fix_onsets,
)


def detect_onsets(x, sr: int = 96000, method: str = "amp", **kwargs):
    """Dispatcher (reference detection.py:12-16): ``"amp"`` → the amplitude
    detector (K1 on the card), anything else → the spectral detector.
    ``device`` (None = the card) goes through ``kwargs``."""
    if method == "amp":
        return detect_onsets_amplitude(x, sr=sr, **kwargs)
    return detect_onsets_spectral(x, sr=sr, **kwargs)
