"""Online analysis side-channel: STFT, onset strength, tempogram, quantize
(port of ``onset_fingerprinting_tpu.realtime.analysis``; reference:
realtime/recording.py:121-604).

The reference spawns processes that spin-wait on shared counters and keep
per-hop STFT/onset-envelope/tempogram rings in shared memory; here, as in
the JAX package, the analysis is an ordinary stateful host object over the
engine's host audio ring.  Its per-hop math (the STFT frame, the log
spectrum, the spectral flux and the tempogram frame) runs in torch on
``device`` (None = the card, the engine's device); the trackers, rings and
the peak picker stay on the host.  The picker constants the reference
leaves undefined (recording.py:304-310, 407-423) come from
:class:`core.config.RealtimeConfig`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy import optimize as sciopt
from scipy.spatial import distance_matrix

from onset_fingerprinting_torch.core.config import RealtimeConfig
from onset_fingerprinting_torch.core.ring_buffer import (
    CircularArray,
    query_circular,
)
from onset_fingerprinting_torch.device import resolve_device


def closest_distance(onsets: np.ndarray, grid: np.ndarray) -> float:
    """Mean distance of each grid point to its two closest onsets
    (recording.py:25-33)."""
    dm = distance_matrix(onsets[:, None], grid[:, None])
    return float(np.mean(np.sort(dm, axis=0)[:2, :].round()))


def find_offset(
    onsets: np.ndarray, bpm: float, sr: int = 48000, x0: float = 0.0, **kwargs
) -> int:
    """Offset aligning onsets to a BPM grid (recording.py:36-62)."""
    if len(onsets) == 0:
        return 0
    beat_len = sr // (bpm / 60)
    n = np.ceil(onsets[-1] / beat_len)
    grid = np.arange(0, n * beat_len, beat_len)
    res = sciopt.minimize(
        lambda off: closest_distance(onsets + off, grid), x0=x0, **kwargs
    )
    return int(np.ravel(res.x)[0])


def tempo_frequencies(n_bins: int, hop_length: int, sr: int) -> np.ndarray:
    """BPM value of each tempogram bin (librosa convention; bin 0 -> inf)."""
    bins = np.arange(n_bins, dtype=np.float64)
    bins[0] = 1e-16
    return 60.0 * sr / (hop_length * bins)


# -- small streaming-utility parity helpers (loopmate.utils rebuilds; the
#    reference imports these, recording.py:8-15 / audio.py:6) ---------------

def samples_to_frames(samples, hop_length: int):
    """Sample index -> STFT frame index."""
    return np.asarray(samples) // hop_length


def frames_to_samples(frames, hop_length: int):
    """STFT frame index -> sample index."""
    return np.asarray(frames) * hop_length


def magsquared(x: np.ndarray) -> np.ndarray:
    """|x|^2 for complex spectra without the sqrt of abs()."""
    return x.real**2 + x.imag**2


def channels_to_int(channels) -> int:
    """Encode a channel subset as a bitmask (loopmate convention used for
    the shared 'record_channels' word, recording.py:88-90)."""
    mask = 0
    for c in channels:
        mask |= 1 << int(c)
    return mask


def int_to_channels(mask: int) -> list[int]:
    out = []
    i = 0
    while mask:
        if mask & 1:
            out.append(i)
        mask >>= 1
        i += 1
    return out


def make_clave(sr: int = 96000, freq: float = 2500.0,
               length_s: float = 0.02) -> np.ndarray:
    """Synthesized clave click (the reference plays loopmate's CLAVE sample
    for count-ins; here generated: exponentially-decayed sine burst)."""
    t = np.arange(int(sr * length_s))
    return (
        np.sin(2 * np.pi * freq / sr * t) * np.exp(-t / (0.004 * sr))
    ).astype(np.float32)


def detect_onsets_online(
    onset_env: np.ndarray,
    mov_max: np.ndarray,
    mov_avg: np.ndarray,
    delta: float,
    wait: int,
) -> np.ndarray:
    """Greedy streaming peak picker over precomputed moving max/avg rings --
    librosa onset_detect's online counterpart (recording.py:397-428)."""
    detections = onset_env * (onset_env == mov_max)
    detections = detections * (detections >= mov_avg + delta)
    peaks = []
    last = -np.inf
    for i in np.nonzero(detections)[0]:
        if i > last + wait:
            peaks.append(i)
            last = i
    return np.asarray(peaks, dtype=np.int64)


def quantize_onsets(
    onsets: np.ndarray,
    offset: int,
    onset_envelope: np.ndarray,
    hop_length: int,
    sr: int,
    lenience: Optional[int] = None,
    strength_weight: float = 0.5,
    window_size: int = 5,
) -> tuple[int, int]:
    """Snap a recording marker to a nearby strong onset, weighting distance
    against onset strength (recording.py:430-493)."""
    if lenience is None:
        lenience = round(sr * 0.1)
    if len(onsets) == 0:
        return 0, 0
    offset_f = offset // hop_length
    strengths = []
    for onset in onsets // hop_length:
        start = max(0, offset_f + onset - window_size)
        end = min(len(onset_envelope), offset_f + onset + window_size)
        strengths.append(np.max(onset_envelope[start:end]))
    strengths = np.asarray(strengths)
    distances = np.abs(onsets)
    weighted = distances ** (1 - strength_weight) * (
        1 - strengths
    ) ** strength_weight
    i = int(np.argmin(weighted))
    move = int(onsets[i]) if distances[i] < lenience else 0
    return move, move


def tempo(
    tg: np.ndarray, tf: np.ndarray, bpm_logprior: np.ndarray, agg=np.mean
) -> np.ndarray:
    """BPM estimate from a tempogram slice with a log-normal prior around
    100 BPM (recording.py:571-589, librosa.feature.rhythm lineage)."""
    if agg is not None:
        tg = agg(tg, axis=-1, keepdims=True)
    best_period = np.argmax(np.log1p(1e6 * tg) + bpm_logprior, axis=-2)
    return np.take(tf, best_period)


class _EMAMinMax:
    """Scalar EMA min/max normalizer (loopmate EMA_MinMaxTracker rebuild)."""

    def __init__(self, min0=0.0, max0=1.0, minmin=0.0, alpha=0.001):
        self.min_val = float(min0)
        self.max_val = float(max0)
        self.minmin = float(minmin)
        self.alpha = float(alpha)

    def add(self, x: float) -> None:
        if x < self.minmin:
            self.min_val = self.minmin
        elif x < self.min_val:
            self.min_val = x
        else:
            self.min_val += self.alpha * (x - self.min_val)
        if x > self.max_val:
            self.max_val = x
        else:
            self.max_val += self.alpha * (x - self.max_val)

    def normalize(self, x: float) -> float:
        rng = self.max_val - self.min_val
        return (x - self.min_val) / rng if rng > 0 else 0.0


def _stft_hop(window: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
    return torch.fft.rfft(window * frame)


def _log_spec(mag: torch.Tensor):
    """dB log-spectrum and its (unclamped) max."""
    s = 10.0 * torch.log10(torch.clamp(mag, min=1e-10))
    return s, s.max()


def _flux_hop(s: torch.Tensor, sm1: torch.Tensor, ref_max: float):
    """Positive spectral-flux mean with both frames floored at
    ``ref_max - 80`` -- ``ref_max`` must already include the current
    frame's max (the reference adds to the tracker BEFORE clamping,
    recording.py:291-293)."""
    floor = torch.tensor(ref_max, dtype=torch.float32,
                         device=s.device) - 80
    s = torch.maximum(s, floor)
    sm1 = torch.maximum(sm1, floor)
    return torch.clamp(s - sm1, min=0.0).mean()


def _tempogram_hop(window: torch.Tensor, env: torch.Tensor, pad: int):
    f = torch.fft.rfft(window * env, n=pad)
    tg = torch.fft.irfft(torch.abs(f) ** 2, n=pad)[: env.shape[0]]
    return tg / (tg.max() + 1e-10)


class OnlineAnalysis:
    """Incremental per-hop analysis over a live audio ring
    (recording.py:161-347 RecAnalysis + 349-604 AnalysisOnDemand, merged).

    Call :meth:`hop` once per hop_length new samples; query BPM, onsets,
    quantized markers at any time.
    """

    def __init__(self, cfg: RealtimeConfig, audio_ring: CircularArray,
                 device=None):
        self.cfg = cfg
        self.audio = audio_ring
        self.device = resolve_device(device)
        self.n_stft = cfg.n_stft
        self.window = torch.as_tensor(np.hanning(cfg.n_fft + 1)[:-1],
                                      dtype=torch.float32, device=self.device)
        self.tg_window = torch.as_tensor(
            np.hanning(cfg.tg_win_length + 1)[:-1], dtype=torch.float32,
            device=self.device)
        bins = 1 + cfg.n_fft // 2
        self.stft = CircularArray(
            np.zeros((self.n_stft, bins), dtype=np.complex64)
        )
        self.onset_env = CircularArray(
            np.zeros(self.n_stft, dtype=np.float32)
        )
        self.mov_max = np.zeros(self.n_stft, dtype=np.float32)
        self.mov_avg = np.zeros(self.n_stft, dtype=np.float32)
        self.tg = CircularArray(
            np.zeros((self.n_stft, cfg.tg_win_length), dtype=np.float32)
        )
        self.onset_env_minmax = _EMAMinMax(0, 1, 0, alpha=0.001)
        self.logspec_minmax = _EMAMinMax(0, 10, 0, alpha=0.0005)
        self.tf = tempo_frequencies(cfg.tg_win_length, cfg.hop_length, cfg.sr)
        self.bpm_logprior = (
            -0.5 * ((np.log2(self.tf) - np.log2(100)) / 1.0) ** 2
        )[:, None]
        self.recording_start = 0
        self.recording_end = 0
        self.last_bpm: Optional[float] = None
        self._hopped = audio_ring.counter  # poll() cursor
        self._prev_logspec = None  # last hop's unclamped log-spectrum
        self._prev_logspec_end = None  # absolute end counter of that hop

    # -- per-hop updates ------------------------------------------------------

    def hop(self, end: Optional[int] = None) -> None:
        """Compute one STFT frame + onset strength + tempogram frame from the
        most recent audio (recording.py:273-327).

        ``end`` pins the frame to the window ending at that ABSOLUTE write
        counter -- lets a catching-up worker process each pending hop at its
        true stream position even while the audio thread keeps writing (a
        cursor-relative lag would shift with every concurrent write).
        Default: the window ending at the live cursor.
        """
        nf = self.cfg.n_fft
        if end is None:
            end = int(self.audio.counter)
        frame = torch.as_tensor(
            np.asarray(
                query_circular(
                    self.audio.data, slice(-nf, None), end, self.audio.axis
                )
            ).mean(-1),
            dtype=torch.float32, device=self.device,
        )
        spec = _stft_hop(self.window, frame).cpu().numpy()
        self.stft.write(spec[None])
        self._onset_strength(int(end))
        self._tempogram()

    def _onset_strength(self, end: int) -> None:
        mag = magsquared(self.stft[-1])
        s, smax = _log_spec(self._t(mag))
        # previous frame's UNclamped log-spec: cached from the last hop
        # when that hop was at exactly one hop_length earlier (live and
        # poll() catch-up alike) -- recomputing it from stft[-2] every hop
        # would double the log work and add a dispatch on the per-hop
        # realtime path.  hop(end=...) permits arbitrary positions, so the
        # cache is keyed by the absolute end counter and falls back to the
        # stft[-2] recompute whenever the stream position does not follow
        # consecutively (a stale cached frame would silently corrupt flux).
        sm1 = self._prev_logspec
        if sm1 is None or self._prev_logspec_end != end - self.cfg.hop_length:
            sm1, _ = _log_spec(self._t(magsquared(self.stft[-2])))
        self._prev_logspec = s
        self._prev_logspec_end = end
        # reference order (recording.py:291-293): feed the UNclamped frame
        # max to the tracker first, then clamp both frames at the UPDATED
        # tracker max - 80
        self.logspec_minmax.add(float(smax))
        env = float(
            _flux_hop(s, sm1, float(np.float32(self.logspec_minmax.max_val)))
        )
        self.onset_env_minmax.add(env)
        self.onset_env.write(
            np.asarray([self.onset_env_minmax.normalize(env)], np.float32)
        )
        cfg = self.cfg
        cur_max = self.onset_env.index_offset(-cfg.max_offset - 1)
        self.mov_max[cur_max] = np.max(self.onset_env[-cfg.max_length :])
        cur_avg = self.onset_env.index_offset(-cfg.avg_offset - 1)
        self.mov_avg[cur_avg] = np.mean(self.onset_env[-cfg.avg_length :])

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _tempogram(self) -> None:
        env = self._t(self.onset_env[-self.cfg.tg_win_length :])
        tg = _tempogram_hop(self.tg_window, env, self.cfg.tg_pad)
        self.tg.write(tg.cpu().numpy()[None])

    # -- on-demand queries (AnalysisOnDemand equivalents) ---------------------

    def detect_onsets(self, start: int) -> tuple[np.ndarray, np.ndarray]:
        """Onsets since relative frame ``start`` (negative)
        (recording.py:397-428)."""
        o = -self.cfg.onset_det_offset
        onset_env = self.onset_env[start:o]
        wc = self.onset_env.write_counter
        mov_max = query_circular(self.mov_max, slice(start, o), wc)
        mov_avg = query_circular(self.mov_avg, slice(start, o), wc)
        peaks = detect_onsets_online(
            onset_env, mov_max, mov_avg, self.cfg.delta, self.cfg.wait
        )
        return peaks, onset_env

    def bpm(self, start: int, end: int = 0) -> float:
        """BPM estimate over tempogram frames [start:end] (relative)."""
        tg = self.tg[start : end if end != 0 else None].T
        return float(tempo(tg, self.tf, self.bpm_logprior)[0])

    def quantize_start(self, lookaround_samples: Optional[int] = None) -> int:
        """Snap recording_start to a nearby strong onset
        (recording.py:495-529). Returns the applied move in samples."""
        cfg = self.cfg
        if lookaround_samples is None:
            lookaround_samples = int(0.25 * cfg.sr)
        ref = self.audio.elements_since(self.recording_start)
        start = ref + lookaround_samples
        start_frames = -(start // cfg.hop_length)
        onsets, onset_env = self.detect_onsets(start_frames)
        onsets = (
            onsets - lookaround_samples // cfg.hop_length
        ) * cfg.hop_length
        _, move = quantize_onsets(
            onsets, lookaround_samples, onset_env, cfg.hop_length, cfg.sr
        )
        self.recording_start += move
        return move

    def quantize_end(self) -> int:
        """Extrapolate recording_end to a whole number of beats from the BPM
        estimate (recording.py:531-569). Returns the new end counter."""
        cfg = self.cfg
        ref_start = self.audio.elements_since(self.recording_start)
        start_frame = -(ref_start // cfg.hop_length)
        n = self.recording_end - self.recording_start
        end_frame = min(start_frame + n // cfg.hop_length, 0)
        onsets, _ = self.detect_onsets(start_frame)
        bpm = self.bpm(start_frame, end_frame)
        self.last_bpm = bpm
        beat_len = int(cfg.sr / (bpm / 60))
        offset = find_offset(
            onsets * cfg.hop_length, bpm, cfg.sr, method="Powell"
        )
        if abs(offset) > 512 and beat_len / 2 - abs(offset) < 0.1 * cfg.sr:
            offset = offset - np.sign(offset) * beat_len / 2
        n_beats = round(n / beat_len)
        self.recording_end = self.recording_start + n_beats * beat_len
        return self.recording_end

    def poll(self) -> int:
        """Catch up on all pending hops from the audio ring.

        Each pending hop is computed at its true stream position (via
        ``hop(end=...)``), so a caller that polls less often than once per
        hop still produces the exact per-hop analysis sequence.  Returns the
        number of hops processed.
        """
        hop = self.cfg.hop_length
        wc = self.audio.counter
        n = 0
        while self._hopped + hop <= wc:
            self._hopped += hop
            self.hop(end=self._hopped)
            n += 1
        return n

    def save_audio(self, path) -> None:
        """Dump the current audio ring to a wav (recording.py:597-604)."""
        from onset_fingerprinting_torch.core.audio_io import write_wav

        write_wav(path, self.audio[-self.audio.N :], self.cfg.sr)

    def save_audio_rotating(self, directory) -> "Path":
        """Numbered-wav rotation dump (recording.py:371-377,597-604):
        continues from the highest existing ``<n>.wav`` in ``directory``."""
        from pathlib import Path

        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        # numeric max, not lexicographic sort ('9.wav' > '10.wav' as
        # strings); ignore non-numeric wavs instead of crashing on them
        nums = [
            int(p.stem) for p in directory.glob("*.wav") if p.stem.isdigit()
        ]
        nxt = max(nums) + 1 if nums else 0
        out = directory / f"{nxt}.wav"
        self.save_audio(out)
        return out


class AnalysisWorker:
    """Background thread pacing :meth:`OnlineAnalysis.poll` -- the
    single-program replacement of the reference's spin-waiting analysis
    process (recording.py:264-270): same producer/consumer shape, but over a
    local ring instead of shared memory, so there is nothing to race on but
    the monotonic write counter.

    For deterministic consumers (tests, the WAV serve loop) call
    ``analysis.poll()`` directly instead of starting the thread.
    """

    def __init__(self, analysis: OnlineAnalysis, interval_s: float = 0.01):
        import threading

        self.analysis = analysis
        self.interval_s = interval_s
        self._quit = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._quit.is_set():
            if self.analysis.poll() == 0:
                self._quit.wait(self.interval_s)

    def start(self) -> "AnalysisWorker":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._quit.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)
