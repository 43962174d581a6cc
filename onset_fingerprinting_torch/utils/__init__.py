"""Evaluation helpers, metrics and tracing, and plots (port of
``onset_fingerprinting_tpu.utils``).  ``plots`` needs matplotlib and is
imported at first use (``utils.plots``), so that the package imports where
matplotlib is absent."""

import importlib

from onset_fingerprinting_torch.utils.eval import (
    butter_highpass,
    butter_highpass_filter,
    clipping_audio,
    drum_frequency,
    knn_metrics,
    wave_speed,
)


def __getattr__(name):
    if name == "plots":
        return importlib.import_module(f"{__name__}.plots")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
