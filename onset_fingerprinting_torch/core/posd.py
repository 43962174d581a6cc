"""A copy of ``onset_fingerprinting_tpu.core.posd`` (no jax in it), with
only its imports changed (pandas is imported where a DataFrame is made).

POSD (Percussive Onset Sound Dataset) format I/O.

Implements the dataset contract specified in the reference's
notebooks/dataset_spec_draft.org:86-291 and consumed by data.py:330-559:

- ``instruments.json``: instrument zone/condition declarations.
- per-session ``<session>.json``::

      {"meta": {"channels": [...], "instrument": ..., "sr": ...},
       "hits": [{"i": 0, "onset_start": int | [int per channel, -1 = missing],
                 "zone": str, "location": [r, phi],  # polar, r ∈ [0,1],
                                                     # phi ° ccw from East
                 "velocity": float, "conditions": {...}}, ...]}

- audio as ``<session>_<channel>.wav`` (single channel) or a single
  multichannel ``<session>.wav``.

Hit tables are plain pandas DataFrames (like the reference's ``parse_hits``,
data.py:40-52); onset arrays use -1 sentinels for missing per-channel onsets.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

from onset_fingerprinting_torch.core.audio_io import read_wav, write_wav


def read_json(path: str | Path) -> dict:
    with open(path, "r") as f:
        return json.load(f)


def write_json(d: dict, path: str | Path) -> None:
    with open(path, "w") as f:
        json.dump(d, f, indent=2)


def parse_hits(hits: dict | list):
    """Hits dict/list → DataFrame, unwrapping the nested conditions mapping
    (reference data.py:40-52).  pandas is imported here, not with the
    module: the card's machine has none, and only the DataFrame APIs need
    it."""
    import pandas as pd

    if isinstance(hits, list):
        hits = {
            k: [h.get(k) for h in hits]
            for k in {k for h in hits for k in h}
        }
    d = dict(hits)
    if "conditions" in d:
        conds = d.pop("conditions")
        if isinstance(conds, dict):
            for name, vals in conds.items():
                d[name] = vals
    return pd.DataFrame(d)


def load_instruments(path: str | Path) -> dict:
    """Load the dataset-level ``instruments.json`` declaring per-instrument
    zones and condition vocabularies (dataset_spec_draft.org:86-155).

    Shape: ``{"<instrument>": {"zones": [...], "conditions": {name: [...]}}}``
    """
    return read_json(Path(path) / "instruments.json")


def validate_hits(hits: list[dict], instrument: dict) -> list[str]:
    """Check hit zones/conditions against an instrument declaration;
    returns a list of human-readable violations (empty = valid)."""
    problems = []
    zones = set(instrument.get("zones", []))
    conds = instrument.get("conditions", {})
    for i, h in enumerate(hits):
        if zones and "zone" in h and h["zone"] not in zones:
            problems.append(f"hit {i}: unknown zone {h['zone']!r}")
        for name, value in (h.get("conditions") or {}).items():
            if name not in conds:
                problems.append(f"hit {i}: unknown condition {name!r}")
            elif conds[name] and value not in conds[name]:
                problems.append(
                    f"hit {i}: condition {name}={value!r} not in vocabulary"
                )
    return problems


def find_sessions(path: str | Path) -> list[Path]:
    """Recursively find session JSON files (those with a ``meta`` key),
    mirroring data.py:385-393."""
    out = []
    for f in sorted(Path(path).rglob("*.json")):
        try:
            if "meta" in read_json(f):
                out.append(f)
        except (json.JSONDecodeError, UnicodeDecodeError):
            continue
    return out


def load_session(
    json_path: str | Path, channel: Optional[str] = None
) -> tuple[np.ndarray, int, dict]:
    """Load one session → (audio [N] or [N, C], sr, session dict).

    If ``channel`` is given, loads ``<session>_<channel>.wav``; otherwise the
    multichannel ``<session>.wav``.
    """
    json_path = Path(json_path)
    session = read_json(json_path)
    if channel is not None:
        wav = json_path.with_name(f"{json_path.stem}_{channel}.wav")
    else:
        wav = json_path.with_suffix(".wav")
    audio, sr = read_wav(wav)
    return audio, sr, session


def onsets_array(hits: Iterable[dict], n_channels: Optional[int] = None) -> np.ndarray:
    """Extract ``onset_start`` per hit into an int array.

    Scalar onsets → ``[n_hits]``; per-channel lists → ``[n_hits, C]`` with -1
    sentinels preserved (dataset_spec_draft.org:246-251).
    """
    starts = [h["onset_start"] for h in hits]
    if starts and isinstance(starts[0], (list, tuple)):
        c = n_channels or max(len(s) for s in starts)
        arr = np.full((len(starts), c), -1, dtype=np.int64)
        for i, s in enumerate(starts):
            arr[i, : len(s)] = s
        return arr
    return np.asarray(starts, dtype=np.int64)


def locations_array(hits: Iterable[dict]) -> np.ndarray:
    """Extract ``location`` (polar [r, phi] or cartesian pairs) per hit."""
    return np.asarray([h["location"] for h in hits], dtype=np.float32)


def save_session(
    path: str | Path,
    name: str,
    audio: np.ndarray,
    sr: int,
    hits: list[dict],
    meta: Optional[dict] = None,
) -> Path:
    """Write a session (multichannel wav + json). Returns the json path."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    write_wav(path / f"{name}.wav", audio, sr)
    channels = (
        [str(i) for i in range(audio.shape[1])] if audio.ndim == 2 else ["0"]
    )
    meta = dict(meta or {})
    meta.setdefault("channels", channels)
    meta.setdefault("sr", sr)
    jp = path / f"{name}.json"
    write_json({"meta": meta, "hits": hits}, jp)
    return jp


def make_hits(
    onsets: np.ndarray,
    locations: Optional[np.ndarray] = None,
    zones: Optional[list] = None,
    velocities: Optional[np.ndarray] = None,
    conditions: Optional[dict] = None,
) -> list[dict]:
    """Assemble a POSD hits list from parallel arrays."""
    hits = []
    for i in range(len(onsets)):
        o = onsets[i]
        h: dict = {
            "i": i,
            "onset_start": o.tolist() if isinstance(o, np.ndarray) else int(o),
        }
        if locations is not None:
            h["location"] = [float(v) for v in locations[i]]
        if zones is not None:
            h["zone"] = zones[i]
        if velocities is not None:
            h["velocity"] = float(velocities[i])
        if conditions is not None:
            h["conditions"] = {k: v[i] for k, v in conditions.items()}
        hits.append(h)
    return hits
