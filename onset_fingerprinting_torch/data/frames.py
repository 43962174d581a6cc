"""Frame extraction: onset-anchored windows gathered from recordings (port
of ``onset_fingerprinting_tpu.data.frames``, JAX frames.py:19-176).

The gather is plain indexing, ``audio[starts[:, None] + arange(frame)]``
with the starts clipped to ``[0, N - frame]``, as the JAX package's is an
XLA gather (no kernel of either package computes it).  Windows come out
``[O, C, frame]``.

:class:`FastFrameExtractor` keeps the audio on the device and draws its
random shifts from a ``torch.Generator`` on it (they cannot equal JAX's
``jax.random`` draws); the last draw is kept in ``last_shifts``.
:class:`FrameExtractor` and :class:`StretchFrameExtractor` draw theirs from
numpy's ``default_rng(seed)``, as the JAX package does, so they match it
draw for draw.
"""

from __future__ import annotations

import numpy as np
import torch

from onset_fingerprinting_torch.device import resolve_device


def extract_frames(audio: torch.Tensor, starts: torch.Tensor,
                   frame_length: int) -> torch.Tensor:
    """Gather ``[len(starts), frame_length, ...]`` windows from ``audio``
    (``[N]`` or ``[N, C]``); starts are clipped to the valid range."""
    starts = torch.clamp(starts, 0, audio.shape[0] - frame_length)
    idx = starts[:, None] + torch.arange(frame_length, device=audio.device)
    return audio[idx]


class FrameExtractor:
    """Onset-window extractor for possibly large recordings (data.py:55-120
    of the reference): numpy in, numpy out, the gather on ``device``
    (None = the card).

    ``use_min_onset=True`` extracts one shared window per onset group
    (starting at the earliest channel); otherwise per-channel windows.
    """

    def __init__(self, frame_length: int, pre_samples: int,
                 max_shift: int = 0, add_pre_samples: bool = False,
                 use_min_onset: bool = True, seed: int = 0, device=None):
        self.frame_length = frame_length + (pre_samples if add_pre_samples
                                            else 0)
        self.pre_samples = pre_samples
        self.max_shift = max_shift
        self.use_min_onset = use_min_onset
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(seed)

    def _gather(self, audio, starts) -> np.ndarray:
        return extract_frames(
            audio, torch.as_tensor(np.asarray(starts), device=self.device),
            self.frame_length).cpu().numpy()

    def __call__(self, audio: np.ndarray, onsets: np.ndarray) -> np.ndarray:
        audio = torch.as_tensor(np.asarray(audio), device=self.device)
        onsets = np.asarray(onsets)
        offset = self.pre_samples
        if self.max_shift:
            shifts = self._rng.integers(-self.max_shift, self.max_shift + 1,
                                        len(onsets))
            offset = offset - shifts
        if audio.dim() == 2:
            if self.use_min_onset:
                # [O, frame, C] → the reference's [O, C, frame]
                return np.swapaxes(
                    self._gather(audio, onsets.min(axis=1) - offset), 1, 2)
            if self.max_shift and np.ndim(offset) == 1:
                offset = offset[:, None]
            starts = onsets - offset
            return np.stack([self._gather(audio[:, c], starts[:, c])
                             for c in range(audio.shape[1])], axis=1)
        return self._gather(audio, onsets - offset)


class FastFrameExtractor:
    """Device-resident extractor for small datasets (data.py:123-192 of the
    reference): the audio lives on ``device`` (None = the card) and each
    call is one gather, with fresh random shifts when ``max_shift > 0``."""

    def __init__(self, audio: np.ndarray, onsets: np.ndarray,
                 frame_length: int, pre_samples: int, max_shift: int = 0,
                 add_pre_samples: bool = False, seed: int = 0, device=None):
        self.frame_length = frame_length + (pre_samples if add_pre_samples
                                            else 0)
        self.pre_samples = pre_samples
        self.max_shift = max_shift
        self.device = resolve_device(device)
        onsets = np.asarray(onsets)
        if onsets.ndim == 2:
            onsets = onsets.min(axis=1)
        self.onsets = torch.as_tensor(onsets, device=self.device)
        self.audio = torch.as_tensor(np.asarray(audio), dtype=torch.float32,
                                     device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.last_shifts = None
        if max_shift == 0:
            self.frames = self._gather(self.onsets - pre_samples)

    def _gather(self, starts: torch.Tensor) -> torch.Tensor:
        f = extract_frames(self.audio, starts, self.frame_length)
        # [O, frame, C] → [O, C, frame], the models' input layout
        return f.transpose(1, 2) if f.dim() == 3 else f

    def __call__(self) -> torch.Tensor:
        if self.max_shift:
            self.last_shifts = torch.randint(
                -self.max_shift, self.max_shift + 1, (len(self.onsets),),
                generator=self.generator, device=self.device)
            return self._gather(self.onsets - self.pre_samples
                                + self.last_shifts)
        return self.frames


class StretchFrameExtractor(FrameExtractor):
    """Random time-stretch augmentation (data.py:195-223 of the reference):
    extracts a slightly longer or shorter window and resamples it to
    ``frame_length`` by rFFT resampling (``scipy.signal.resample``'s
    method), in numpy."""

    def __init__(self, frame_length: int, pre_samples: int,
                 max_stretch: float = 0.03, use_min_onset: bool = True,
                 seed: int = 0):
        super().__init__(frame_length, pre_samples, seed=seed, device="cpu")
        if not use_min_onset:
            raise NotImplementedError("use_min_onset=False not supported")
        self.max_shift = max(int(self.frame_length * max_stretch), 2)

    @staticmethod
    def _resample_fft(x: np.ndarray, num: int) -> np.ndarray:
        """``scipy.signal.resample``-style Fourier resampling along axis
        0."""
        n = x.shape[0]
        X = np.fft.rfft(x, axis=0)
        out_bins = num // 2 + 1
        Y = np.zeros((out_bins,) + X.shape[1:], dtype=X.dtype)
        m = min(out_bins, X.shape[0])
        Y[:m] = X[:m]
        return np.fft.irfft(Y, num, axis=0) * (num / n)

    def __call__(self, audio: np.ndarray, onsets: np.ndarray) -> np.ndarray:
        onsets = np.asarray(onsets)
        shifts = self._rng.integers(1, self.max_shift, len(onsets))
        shifts *= self._rng.choice((-1, 1), size=len(shifts))
        if audio.ndim == 2:
            group_starts = onsets.min(axis=1) - self.pre_samples
        else:
            group_starts = onsets - self.pre_samples
        out = np.empty(onsets.shape + (self.frame_length,), dtype=np.float32)
        for i, (onset, shift) in enumerate(zip(group_starts, shifts)):
            seg = audio[onset: onset + self.frame_length + shift]
            out[i] = self._resample_fft(np.asarray(seg), self.frame_length).T
        return out
