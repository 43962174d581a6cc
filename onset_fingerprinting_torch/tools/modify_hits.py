"""Interactive single-channel onset label editor (port of
``onset_fingerprinting_tpu.tools.modify_hits``).

Equivalent of the reference's Tk/matplotlib editor (reference:
modify_hits.py:28-354): drag/create/delete onset markers, edit per-hit zone
and condition labels, keyboard navigation, optional audio playback (gated on
sounddevice), saving to ``<session>-mod.json``.

The data-model half (wide↔long hit-dict conversion, marker editing, save) is
plain Python and unit-testable; the GUI half requires a display and
imports matplotlib when it starts.

Run: python -m onset_fingerprinting_torch.tools.modify_hits <data_dir> <session>
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
import numpy as np

from onset_fingerprinting_torch.core import posd as posd_io


def hits_to_long(hits: dict) -> list[dict]:
    """Column-wise (wide) hits dict → per-hit records
    (modify_hits.py:231-248 equivalent)."""
    keys = [k for k in hits if k != "conditions"]
    n = len(hits[keys[0]]) if keys else 0
    records = []
    for i in range(n):
        rec = {k: hits[k][i] for k in keys}
        if "conditions" in hits:
            rec["conditions"] = {
                c: v[i] for c, v in hits["conditions"].items()
            }
        records.append(rec)
    return records


def long_to_hits(records: list[dict]) -> dict:
    """Per-hit records → column-wise hits dict (modify_hits.py:251-266)."""
    if not records:
        return {}
    out: dict = {}
    cond_keys = set()
    for rec in records:
        if isinstance(rec.get("conditions"), dict):
            cond_keys |= set(rec["conditions"])
    plain_keys = {k for rec in records for k in rec if k != "conditions"}
    for k in sorted(plain_keys):
        out[k] = [rec.get(k) for rec in records]
    if cond_keys:
        out["conditions"] = {
            c: [rec.get("conditions", {}).get(c) for rec in records]
            for c in sorted(cond_keys)
        }
    return out


class HitEditorModel:
    """Editable hit list backed by a POSD session json."""

    def __init__(self, session_path: str | Path):
        self.path = Path(session_path)
        self.session = posd_io.read_json(self.path)
        hits = self.session["hits"]
        self.records = (
            hits_to_long(hits) if isinstance(hits, dict) else list(hits)
        )
        self.selected = 0

    # -- edits -----------------------------------------------------------------

    def move_onset(self, index: int, new_start: int) -> None:
        self.records[index]["onset_start"] = int(new_start)

    def add_hit(self, onset_start: int, **fields) -> int:
        rec = {"onset_start": int(onset_start), **fields}
        self.records.append(rec)
        self.records.sort(key=lambda r: _first_onset(r))
        return next(
            i for i, r in enumerate(self.records) if r is rec
        )

    def delete_hit(self, index: int) -> None:
        del self.records[index]
        self.selected = min(self.selected, len(self.records) - 1)

    def set_label(self, index: int, key: str, value) -> None:
        if key == "zone" or key in self.records[index]:
            self.records[index][key] = value
        else:
            self.records[index].setdefault("conditions", {})[key] = value

    def save(self, suffix: str = "-mod") -> Path:
        """Write ``<session><suffix>.json`` (modify_hits.py:205-212)."""
        out = self.path.with_name(self.path.stem + suffix + ".json")
        session = dict(self.session)
        session["hits"] = self.records
        with open(out, "w") as f:
            json.dump(session, f, indent=2)
        return out


def _first_onset(rec: dict) -> int:
    o = rec["onset_start"]
    if isinstance(o, (list, tuple)):
        valid = [v for v in o if v >= 0]
        return min(valid) if valid else -1
    return o


class HitEditorGUI:  # pragma: no cover - interactive
    """matplotlib front end: click to select, drag to move, 'a' add,
    'd' delete, 'p' play, left/right navigate, 'w' save."""

    def __init__(self, model: HitEditorModel, audio: np.ndarray, sr: int,
                 window: int = 4096):
        import matplotlib.pyplot as plt

        self.m = model
        self.audio = audio if audio.ndim == 1 else audio.mean(1)
        self.sr = sr
        self.window = window
        self.fig, self.ax = plt.subplots(figsize=(14, 5))
        self.fig.canvas.mpl_connect("key_press_event", self.on_key)
        self.fig.canvas.mpl_connect("button_press_event", self.on_click)
        self.redraw()

    def redraw(self):
        self.ax.clear()
        i = self.m.selected
        onset = _first_onset(self.m.records[i])
        lo = max(onset - self.window // 2, 0)
        hi = min(onset + self.window // 2, len(self.audio))
        self.ax.plot(np.arange(lo, hi), self.audio[lo:hi], lw=0.5)
        for j, rec in enumerate(self.m.records):
            o = _first_onset(rec)
            if lo <= o < hi:
                self.ax.axvline(
                    o, color="r" if j == i else "g",
                    ls="-" if j == i else "--",
                )
        zone = self.m.records[i].get("zone", "?")
        self.ax.set_title(
            f"hit {i + 1}/{len(self.m.records)} zone={zone} onset={onset}"
        )
        self.fig.canvas.draw_idle()

    def on_key(self, event):
        i = self.m.selected
        if event.key == "right":
            self.m.selected = min(i + 1, len(self.m.records) - 1)
        elif event.key == "left":
            self.m.selected = max(i - 1, 0)
        elif event.key == "d":
            self.m.delete_hit(i)
        elif event.key == "a" and event.xdata:
            self.m.selected = self.m.add_hit(int(event.xdata))
        elif event.key == "w":
            out = self.m.save()
            print(f"saved {out}")
        elif event.key == "p":
            try:
                import sounddevice as sd

                onset = _first_onset(self.m.records[i])
                sd.play(self.audio[onset : onset + self.sr // 2], self.sr)
            except ImportError:
                print("sounddevice not available")
        self.redraw()

    def on_click(self, event):
        if event.xdata is None:
            return
        self.m.move_onset(self.m.selected, int(event.xdata))
        self.redraw()


def main():  # pragma: no cover - CLI
    import matplotlib.pyplot as plt

    data_dir, session = Path(sys.argv[1]), sys.argv[2]
    jp = data_dir / f"{session}.json"
    model = HitEditorModel(jp)
    meta = model.session.get("meta", {})
    channel = (meta.get("channels") or ["0"])[0]
    try:
        audio, sr, _ = posd_io.load_session(jp, channel=channel)
    except FileNotFoundError:
        audio, sr, _ = posd_io.load_session(jp)
    HitEditorGUI(model, audio, sr)
    plt.show()


if __name__ == "__main__":  # pragma: no cover
    main()
