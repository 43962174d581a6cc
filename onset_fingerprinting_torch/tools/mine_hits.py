"""Dataset mining: recordings → detected, grouped, aligned POSD hits (port of
``onset_fingerprinting_tpu.tools.mine_hits``).

The reference's notebook mining flow (notebooks/mining_mc_hits.org there):
the amplitude detector over each multichannel WAV (on the card one K1
launch for the warmup and one for the whole recording,
``detect.amplitude.detect_onsets_amplitude``), per-hit onset groups across
channels (``detect.grouping.find_onset_groups``), the onsets CC-aligned
across channels (``detect.refine.fix_onsets``), written as POSD session
JSONs for the label editors and the datasets.

Run from the repository root (on the card; ``--cpu`` for the plain
detector on the CPU):

    python -m onset_fingerprinting_torch.tools.mine_hits <wav...> \
        [--out DIR] [--min-channels 3] [--max-distance 1000] [--fix]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from onset_fingerprinting_torch.core import posd
from onset_fingerprinting_torch.core.audio_io import read_wav
from onset_fingerprinting_torch.detect.amplitude import (
    detect_onsets_amplitude,
)
from onset_fingerprinting_torch.detect.grouping import find_onset_groups
from onset_fingerprinting_torch.detect.refine import fix_onsets


def mine_file(
    wav: str | Path,
    out_dir: str | Path,
    min_channels: Optional[int] = None,
    max_distance: int = 1000,
    fix: bool = False,
    backend: str = "scan",
    on_threshold: float = 0.5,
    off_threshold: float = 0.1,
    hipass_freq: float = 2000.0,
    sr_override: Optional[int] = None,
    device=None,
) -> Optional[Path]:
    """Mine one recording on ``device`` (None = the card); returns the
    written session json, or None if no groups were found."""
    wav = Path(wav)
    audio, sr = read_wav(wav)
    if sr_override:
        sr = sr_override
    if audio.ndim == 1:
        audio = audio[:, None]
    channels, onsets, _ = detect_onsets_amplitude(
        audio, sr=sr, hipass_freq=hipass_freq, on_threshold=on_threshold,
        off_threshold=off_threshold, backend=backend, device=device)
    groups = find_onset_groups(
        onsets, channels, max_distance=max_distance,
        min_channels=min_channels or audio.shape[1])
    if groups is None:
        print(f"{wav.name}: {len(onsets)} onsets, no qualifying groups")
        return None
    if fix:
        groups = fix_onsets(audio.astype(np.float64), groups, take_abs=True,
                            d=1)
    hits = posd.make_hits(groups)
    jp = posd.save_session(Path(out_dir), wav.stem, audio, sr, hits,
                           meta={"source": str(wav)})
    print(f"{wav.name}: {len(onsets)} onsets -> {len(groups)} hits -> "
          f"{jp.name}")
    return jp


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("wavs", nargs="+")
    ap.add_argument("--out", default="mined", help="output directory")
    ap.add_argument("--min-channels", type=int, default=None)
    ap.add_argument("--max-distance", type=int, default=1000)
    ap.add_argument("--fix", action="store_true",
                    help="CC-align onsets across channels")
    ap.add_argument("--backend", choices=["scan", "pallas"], default="scan")
    ap.add_argument("--on-threshold", type=float, default=0.5)
    ap.add_argument("--off-threshold", type=float, default=0.1)
    ap.add_argument("--hipass", type=float, default=2000.0)
    ap.add_argument("--sr", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain detector on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    written = 0
    for wav in args.wavs:
        if mine_file(wav, args.out, args.min_channels, args.max_distance,
                     args.fix, args.backend, args.on_threshold,
                     args.off_threshold, args.hipass, args.sr,
                     device=device):
            written += 1
    print(f"wrote {written} sessions to {args.out}/")
    return 0 if written else 1


if __name__ == "__main__":
    sys.exit(main())
