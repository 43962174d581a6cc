"""The multichannel location dataset (port of ``MCPOSD`` from
``onset_fingerprinting_tpu.data.datasets``, JAX datasets.py:34-170).

A tiny full-batch dataset backed by a device-resident
:class:`~onset_fingerprinting_torch.data.frames.FastFrameExtractor`, with
optional random-shift re-extraction (``n_extractions`` rounds), a window
split and the leakage-safe hit split.  ``x`` and ``y`` are tensors on the
dataset's device (None = the card).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from onset_fingerprinting_torch.core import posd as posd_io
from onset_fingerprinting_torch.core.audio_io import read_wav
from onset_fingerprinting_torch.data.frames import FastFrameExtractor
from onset_fingerprinting_torch.device import resolve_device


class MCPOSD:
    """Multichannel location dataset; ``ds[0]`` is the full batch ``(x [N,
    C, frame], y [N, 2])`` (the reference trains full batch,
    train.py:34-43)."""

    def __init__(self, data: np.ndarray, onsets: np.ndarray,
                 sound_positions: np.ndarray, frame_length: int = 256,
                 pre_samples: int = 0, max_shift: int = 0,
                 n_extractions: int = 1,
                 channels: Optional[Sequence[int]] = None, device=None):
        if channels is not None:
            data = data[:, list(channels)]
        self.device = resolve_device(device)
        self.data = data
        self._onsets = np.asarray(onsets)
        self._positions = np.asarray(sound_positions)
        self._frame_length = frame_length
        self._pre_samples = pre_samples
        self._max_shift = max_shift
        self.frame_extractor = FastFrameExtractor(
            data, onsets, frame_length, pre_samples, max_shift,
            device=self.device)
        self.n_extractions = n_extractions
        positions = np.asarray(sound_positions, np.float32)
        if n_extractions == 1 and max_shift == 0:
            self.y = torch.as_tensor(positions, device=self.device)
            self.x = self.frame_extractor()
            self.straight = True
        else:
            self.y = torch.as_tensor(
                np.concatenate([positions] * n_extractions),
                device=self.device)
            self.straight = False

    def __len__(self) -> int:
        return 1

    def __getitem__(self, index):
        if self.straight:
            return self.x, self.y
        x = torch.cat([self.frame_extractor()
                       for _ in range(self.n_extractions)])
        return x, self.y

    def batch(self):
        return self[0]

    @classmethod
    def from_file(cls, folder: str | Path, name: str,
                  frame_length: int = 256, pre_samples: int = 0,
                  max_shift: int = 0, n_extractions: int = 1, channels=None,
                  device=None) -> "MCPOSD":
        """Load ``<folder>/<name>.wav`` and ``.json`` (data.py:285-311 of the
        reference)."""
        folder = Path(folder)
        data, _ = read_wav(folder / f"{name}.wav")
        hits = posd_io.read_json(folder / f"{name}.json")["hits"]
        return cls(data, posd_io.onsets_array(hits),
                   posd_io.locations_array(hits), frame_length, pre_samples,
                   max_shift, n_extractions, channels=channels,
                   device=device)

    @classmethod
    def from_xy(cls, x: torch.Tensor, y: torch.Tensor) -> "MCPOSD":
        ds = cls.__new__(cls)
        ds.device = x.device
        ds.x = x
        ds.y = y
        ds.straight = True
        ds.n_extractions = 1
        return ds

    def split(self, r: float = 0.8, seed: int = 0):
        """Random WINDOW-level split (data.py:321-327 of the reference).

        .. warning:: leakage-safe only when each hit gives one window
            (``n_extractions == 1``, ``max_shift == 0``); otherwise use
            :meth:`split_hits`.
        """
        n = len(self.y)
        idx = torch.as_tensor(np.random.default_rng(seed).permutation(n),
                              device=self.device)
        cut = int(n * r)
        return (self.from_xy(self.x[idx[:cut]], self.y[idx[:cut]]),
                self.from_xy(self.x[idx[cut:]], self.y[idx[cut:]]))

    def split_hits(self, r: float = 0.8, seed: int = 0):
        """HIT-level train/eval split, the leakage-safe one: the train set
        keeps this dataset's shift and extraction settings over its hits,
        the eval set extracts its held-out hits once with no shift.

        :returns: ``(train MCPOSD, eval MCPOSD)`` over disjoint hits
        """
        n = len(self._onsets)
        idx = np.random.default_rng(seed).permutation(n)
        cut = int(n * r)
        tr, ev = np.sort(idx[:cut]), np.sort(idx[cut:])
        train = MCPOSD(self.data, self._onsets[tr], self._positions[tr],
                       self._frame_length, self._pre_samples, self._max_shift,
                       self.n_extractions, device=self.device)
        evald = MCPOSD(self.data, self._onsets[ev], self._positions[ev],
                       self._frame_length, self._pre_samples, 0, 1,
                       device=self.device)
        return train, evald
