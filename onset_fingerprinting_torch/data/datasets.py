"""POSD datasets (port of ``onset_fingerprinting_tpu.data.datasets``):

- :class:`MCPOSD` (JAX datasets.py:34-170), the multichannel location
  dataset: a tiny full-batch dataset backed by a device-resident
  :class:`~onset_fingerprinting_torch.data.frames.FastFrameExtractor`, with
  optional random-shift re-extraction (``n_extractions`` rounds), a window
  split and the leakage-safe hit split.  ``x`` and ``y`` are tensors on the
  dataset's device (None = the card).
- :class:`POSD` (JAX datasets.py:172-335), the onset classification
  dataset: onset frames of one channel per session plus ``n_rounds_aug``
  augmented copies, ``audio`` a tensor on the dataset's device and
  ``labels`` a pandas DataFrame aligned with its rows.  Its device half,
  :func:`posd_rows` (frame extraction and the augmented rounds, in the JAX
  package's row order), needs no pandas.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from onset_fingerprinting_torch.core import posd as posd_io
from onset_fingerprinting_torch.core.audio_io import read_wav
from onset_fingerprinting_torch.data.augment import AUGMENTATIONS, some_of
from onset_fingerprinting_torch.data.frames import (
    FastFrameExtractor,
    FrameExtractor,
)
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


def posd_rows(audios: Sequence[np.ndarray], onsets: Sequence[np.ndarray],
              rates: Sequence[int], frame_extractor: FrameExtractor,
              extractors: Sequence, augmentations: Sequence,
              n_rounds_aug: int, generator: torch.Generator) -> torch.Tensor:
    """POSD's rows on the generator's device, in the JAX package's order:
    per session its exact frames, then per extractor ``n_rounds_aug``
    rounds of ``some_of`` over that extractor's frames (one draw per row
    and round, from ``generator`` in that order).

    :param audios: one recording ``[N]`` per session
    :param onsets: the onset samples of each session
    :param rates: each session's sample rate (the augmentations' ``sr``)
    :returns: ``[sessions · hits · (1 + len(extractors)·n_rounds_aug),
        frame_length + pre_samples]`` float32
    """
    dev = generator.device
    rows = []
    for audio, onset, sr in zip(audios, onsets, rates):
        onset = np.asarray(onset)
        rows.append(torch.as_tensor(frame_extractor(audio, onset),
                                    dtype=torch.float32, device=dev))
        for extractor in extractors:
            base = torch.as_tensor(extractor(audio, onset),
                                   dtype=torch.float32, device=dev)
            for _ in range(n_rounds_aug):
                rows.append(some_of(generator, base, sr, augmentations))
    return torch.cat(rows)


class POSD:
    """Percussive onset classification dataset (data.py:330-559 of the
    reference).

    Loads every session JSON under ``path`` (files with a ``meta`` key),
    extracts onset frames of ``channel`` and adds ``n_rounds_aug``
    augmented copies per extractor (:func:`posd_rows`), on ``device``
    (None = the card).  ``transform(audio, posd)`` maps the rows tensor to
    the features the dataset keeps.  ``labels`` is a pandas DataFrame
    aligned with the ``audio`` rows.
    """

    def __init__(self, path: str | Path, frame_length: int, channel: str,
                 transform: Optional[Callable] = None, pre_samples: int = 0,
                 extra_extractors: list = (),
                 augmentations: Sequence = AUGMENTATIONS,
                 n_rounds_aug: int = 5, seed: int = 0, device=None):
        path = Path(path)
        session_files = posd_io.find_sessions(path)
        sessions = [posd_io.read_json(f) for f in session_files]
        self.sessions = [s["meta"] for s in sessions]
        self.hit_tables = [posd_io.parse_hits(s["hits"]) for s in sessions]
        if not all(channel in s["channels"] for s in self.sessions):
            raise ValueError(f"channel {channel!r} is missing from a session")
        self.files = [f.with_name(f.stem + f"_{channel}.wav")
                      for f in session_files]
        self._setup(frame_length, pre_samples, extra_extractors,
                    augmentations, n_rounds_aug, seed, device)
        self._load_audio()
        if transform is not None:
            self.audio = transform(self.audio, self)

    def _setup(self, frame_length, pre_samples, extra_extractors,
               augmentations, n_rounds_aug, seed, device):
        self.device = resolve_device(device)
        self.frame_length = frame_length
        self.pre_samples = pre_samples
        # add_pre_samples=True so rows really are frame_length +
        # pre_samples wide (the reference allocates that width but extracts
        # frame_length when pre_samples > 0, data.py:421-427 there)
        self.frame_extractor = FrameExtractor(
            frame_length, pre_samples, add_pre_samples=True,
            device=self.device)
        self.extra_extractors = ([self.frame_extractor]
                                 + list(extra_extractors))
        self.augmentations = augmentations
        self.n_rounds_aug = n_rounds_aug
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _rows(self, audios, onsets, rates) -> torch.Tensor:
        return posd_rows(audios, onsets, rates, self.frame_extractor,
                         self.extra_extractors, self.augmentations,
                         self.n_rounds_aug, self.generator)

    def _labels_of(self, tables):
        """Each session's hit table once per row block of that session."""
        import pandas as pd

        n = 1 + len(self.extra_extractors) * self.n_rounds_aug
        return pd.concat([t for t in tables for _ in range(n)],
                         ignore_index=True)

    @property
    def labels(self):
        """The pandas DataFrame aligned with ``audio``'s rows; a dataset
        made by :meth:`from_audio_onsets` builds it at first use, so that
        the rows are made without pandas."""
        if self._labels is None:
            import pandas as pd

            self._labels = self._labels_of([
                pd.DataFrame({"onset_start": np.asarray(o), "zone": z})
                for o, z in self._zone_onsets])
        return self._labels

    @labels.setter
    def labels(self, value):
        self._labels = value

    def _load_audio(self):
        audios, onsets, rates = [], [], []
        for file, hits in zip(self.files, self.hit_tables):
            audio, sr = read_wav(file)
            audios.append(audio)
            onsets.append(hits["onset_start"].to_numpy())
            rates.append(sr)
        self.audio = self._rows(audios, onsets, rates)
        self.labels = self._labels_of(self.hit_tables)

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_audio_onsets(cls, audios: list[np.ndarray],
                          onsets: list[Sequence[int]], sr: int,
                          frame_length: int,
                          transform: Optional[Callable] = None,
                          pre_samples: int = 0, extra_extractors: list = (),
                          augmentations: Sequence = AUGMENTATIONS,
                          n_rounds_aug: int = 5,
                          zone_names: Optional[list] = None, seed: int = 0,
                          device=None) -> "POSD":
        """In-memory constructor: one recording and onset list per zone
        (data.py:462-537 of the reference).  Needs no pandas until
        ``labels`` is read."""
        if len(audios) != len(onsets):
            raise ValueError("one onset list per recording")
        ds = cls.__new__(cls)
        ds._setup(frame_length, pre_samples, extra_extractors, augmentations,
                  n_rounds_aug, seed, device)
        if zone_names is None:
            zone_names = list(range(len(audios)))
        ds._labels = None
        ds._zone_onsets = list(zip(onsets, zone_names))
        ds.audio = ds._rows(audios, onsets, [sr] * len(audios))
        if transform is not None:
            ds.audio = transform(ds.audio, ds)
        return ds

    @classmethod
    def from_subset(cls, audio, labels) -> "POSD":
        ds = cls.__new__(cls)
        ds.audio = audio
        ds.labels = labels
        return ds

    def query(self, query: str) -> "POSD":
        """Label-conditioned sub-dataset (data.py:546-553 of the
        reference)."""
        new_labels = self.labels.query(query)
        idx = torch.tensor(new_labels.index.to_numpy(),
                           device=self.audio.device)
        return POSD.from_subset(self.audio[idx], new_labels)

    def __getitem__(self, index):
        return self.audio[index], self.labels.iloc[index]

    def __len__(self) -> int:
        return self.audio.shape[0]
