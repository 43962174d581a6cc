"""The realtime serving path: the per-block engine on the card, its
classifier, and the location-triggered actions (port of
``onset_fingerprinting_tpu.realtime``)."""

from onset_fingerprinting_torch.realtime.actions import (
    Action,
    Actions,
    Bounds,
    Location,
    ParameterChange,
    ParameterMapper,
    Sample,
)
from onset_fingerprinting_torch.realtime.engine import (
    EngineState,
    RealtimeEngine,
    make_engine_step,
)
from onset_fingerprinting_torch.realtime.analysis import (
    OnlineAnalysis,
    detect_onsets_online,
    find_offset,
    quantize_onsets,
    tempo,
)
from onset_fingerprinting_torch.realtime.setup_io import load_setup, save_setup
