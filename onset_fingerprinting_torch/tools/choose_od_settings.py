"""Interactive detector-tuning tool: sliders re-run detection live (port
of ``onset_fingerprinting_tpu.tools.choose_od_settings``).

Equivalent of the reference's tuning GUI (reference:
choose_od_settings.py:28-221): load calibration audio, adjust detector
hyperparameters with matplotlib sliders, watch detections + onset groups
update live.  The recompute path is ``detect_onsets_amplitude`` on the
card: each slider change is the detector kernel's two launches over the
recording (the 0.5 s warmup, then every full block), then the host's
onset grouping.  The slider GUI imports matplotlib when it starts.

Run on the card (``--cpu`` for the plain detector on the CPU):

    python -m onset_fingerprinting_torch.tools.choose_od_settings <wav> [sr]
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from onset_fingerprinting_torch.detect import (
    detect_onsets_amplitude,
    find_onset_groups,
)
from onset_fingerprinting_torch.device import resolve_device


class DetectorTuner:
    """Slider GUI over detect_onsets_amplitude + find_onset_groups.
    ``device=None`` means the card (raising without CUDA); ``"cpu"`` runs
    the plain detector."""

    SLIDERS = [
        # name, min, max, default, log
        ("on_threshold", 0.01, 1.0, 0.5, False),
        ("off_threshold", 0.01, 1.0, 0.1, False),
        ("fast_attack", 1.0, 50.0, 3.0, True),
        ("fast_release", 50.0, 2000.0, 383.0, True),
        ("slow_attack", 200.0, 8000.0, 2205.0, True),
        ("slow_release", 200.0, 8000.0, 2205.0, True),
        ("floor", -90.0, -30.0, -70.0, False),
        ("hipass_freq", 0.0, 8000.0, 2000.0, False),
        ("cooldown", 128.0, 8192.0, 1323.0, False),
        ("max_distance", 50.0, 4000.0, 1000.0, False),
    ]

    def __init__(self, audio: np.ndarray, sr: int = 96000,
                 min_channels: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self.audio = np.asarray(audio, np.float32)
        if self.audio.ndim == 1:
            self.audio = self.audio[:, None]
        self.sr = sr
        self.min_channels = min_channels or self.audio.shape[1]
        self.values = {name: d for name, _, _, d, _ in self.SLIDERS}

    def detect(self) -> tuple[list, list, Optional[np.ndarray]]:
        v = self.values
        channels, onsets, _ = detect_onsets_amplitude(
            self.audio,
            sr=self.sr,
            floor=v["floor"],
            hipass_freq=v["hipass_freq"],
            fast_ar=(v["fast_attack"], v["fast_release"]),
            slow_ar=(v["slow_attack"], v["slow_release"]),
            on_threshold=v["on_threshold"],
            off_threshold=v["off_threshold"],
            cooldown=int(v["cooldown"]),
            device=self.device,
        )
        groups = (
            find_onset_groups(
                onsets, channels, int(v["max_distance"]), self.min_channels
            )
            if onsets
            else None
        )
        return channels, onsets, groups

    def run(self):  # pragma: no cover - interactive
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Slider

        fig, ax = plt.subplots(figsize=(14, 6))
        plt.subplots_adjust(bottom=0.08 + 0.035 * len(self.SLIDERS))
        t = np.arange(len(self.audio)) / self.sr
        for ch in range(self.audio.shape[1]):
            ax.plot(t, self.audio[:, ch] + 2 * ch, lw=0.4, color=f"C{ch}")
        markers = ax.plot([], [], "kv", ms=6)[0]
        title = ax.set_title("")

        sliders = []
        for i, (name, lo, hi, default, _) in enumerate(self.SLIDERS):
            sax = fig.add_axes([0.15, 0.02 + 0.033 * i, 0.7, 0.022])
            s = Slider(sax, name, lo, hi, valinit=default)
            sliders.append((name, s))

        def update(_=None):
            for name, s in sliders:
                self.values[name] = s.val
            channels, onsets, groups = self.detect()
            ys = [2 * c + 1.2 for c in channels]
            markers.set_data(np.asarray(onsets) / self.sr, ys)
            n_groups = 0 if groups is None else len(groups)
            title.set_text(
                f"{len(onsets)} onsets, {n_groups} groups "
                f"(≥{self.min_channels} channels)"
            )
            fig.canvas.draw_idle()

        for _, s in sliders:
            s.on_changed(update)
        update()
        plt.show()


def main():  # pragma: no cover - CLI
    from onset_fingerprinting_torch.core.audio_io import read_wav

    args = [a for a in sys.argv[1:] if a != "--cpu"]
    audio, sr = read_wav(args[0])
    if len(args) > 1:
        sr = int(args[1])
    DetectorTuner(audio, sr,
                  device="cpu" if "--cpu" in sys.argv else None).run()


if __name__ == "__main__":  # pragma: no cover
    main()
