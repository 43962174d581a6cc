"""Interactive multi-channel onset group editor (port of
``onset_fingerprinting_tpu.tools.modify_hits_mc``).

Equivalent of the reference's per-channel subplot editor (reference:
modify_hits_mc.py:32-265): one subplot per channel around the current onset
group, group paging (f/b), zoom, -1-sentinel channels drawn dashed at the
group minimum, autosave on close.

Run: python -m onset_fingerprinting_torch.tools.modify_hits_mc <data_dir> <session>
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from onset_fingerprinting_torch.core import posd as posd_io
from onset_fingerprinting_torch.tools.modify_hits import HitEditorModel


class GroupEditorModel(HitEditorModel):
    """Hit editor over per-channel onset lists (-1 = missing)."""

    def n_channels(self) -> int:
        for rec in self.records:
            if isinstance(rec["onset_start"], (list, tuple)):
                return len(rec["onset_start"])
        return 1

    def group(self, index: int) -> np.ndarray:
        o = self.records[index]["onset_start"]
        if not isinstance(o, (list, tuple)):
            o = [o]
        return np.asarray(o, dtype=np.int64)

    def set_channel_onset(self, index: int, channel: int, onset: int) -> None:
        o = self.records[index]["onset_start"]
        if isinstance(o, (list, tuple)):
            o = list(o)
            o[channel] = int(onset)
            self.records[index]["onset_start"] = o
        else:
            self.records[index]["onset_start"] = int(onset)

    def clear_channel(self, index: int, channel: int) -> None:
        """Mark a channel's onset missing with the -1 sentinel."""
        self.set_channel_onset(index, channel, -1)


class GroupEditorGUI:  # pragma: no cover - interactive
    """Keys: f/b page groups, +/- zoom, number keys select channel,
    click moves selected channel's onset, 'x' clears it, 'w' saves;
    autosaves on window close (modify_hits_mc.py:92-96)."""

    def __init__(self, model: GroupEditorModel, audio: np.ndarray, sr: int,
                 window: int = 2048):
        import matplotlib.pyplot as plt

        self.m = model
        self.audio = audio if audio.ndim == 2 else audio[:, None]
        self.sr = sr
        self.window = window
        self.channel = 0
        c = self.m.n_channels()
        self.fig, self.axs = plt.subplots(
            c, 1, sharex=True, figsize=(14, 2 * c), squeeze=False
        )
        self.fig.canvas.mpl_connect("key_press_event", self.on_key)
        self.fig.canvas.mpl_connect("button_press_event", self.on_click)
        self.fig.canvas.mpl_connect("close_event", lambda e: self.m.save())
        self.redraw()

    def redraw(self):
        group = self.m.group(self.m.selected)
        valid = group[group >= 0]
        center = int(valid.min()) if len(valid) else 0
        lo = max(center - self.window // 4, 0)
        hi = min(center + self.window, self.audio.shape[0])
        for ch, ax in enumerate(self.axs[:, 0]):
            ax.clear()
            ax.plot(np.arange(lo, hi), self.audio[lo:hi, ch], lw=0.5)
            onset = group[ch] if ch < len(group) else -1
            if onset >= 0:
                ax.axvline(onset, color="r")
            else:
                # -1 sentinel: dashed marker at the group minimum
                ax.axvline(center, color="r", ls="--", alpha=0.5)
            sel = " *" if ch == self.channel else ""
            ax.set_ylabel(f"ch {ch}{sel}")
        self.axs[0, 0].set_title(
            f"group {self.m.selected + 1}/{len(self.m.records)}"
        )
        self.fig.canvas.draw_idle()

    def on_key(self, event):
        if event.key == "f":
            self.m.selected = min(
                self.m.selected + 1, len(self.m.records) - 1
            )
        elif event.key == "b":
            self.m.selected = max(self.m.selected - 1, 0)
        elif event.key == "+":
            self.window = max(self.window // 2, 256)
        elif event.key == "-":
            self.window = min(self.window * 2, self.audio.shape[0])
        elif event.key == "x":
            self.m.clear_channel(self.m.selected, self.channel)
        elif event.key == "w":
            print(f"saved {self.m.save()}")
        elif event.key and event.key.isdigit():
            ch = int(event.key)
            if ch < self.m.n_channels():
                self.channel = ch
        self.redraw()

    def on_click(self, event):
        if event.xdata is None:
            return
        self.m.set_channel_onset(
            self.m.selected, self.channel, int(event.xdata)
        )
        self.redraw()


def main():  # pragma: no cover - CLI
    import matplotlib.pyplot as plt

    data_dir, session = Path(sys.argv[1]), sys.argv[2]
    jp = data_dir / f"{session}.json"
    model = GroupEditorModel(jp)
    audio, sr, _ = posd_io.load_session(jp)
    GroupEditorGUI(model, audio, sr)
    plt.show()


if __name__ == "__main__":  # pragma: no cover
    main()
