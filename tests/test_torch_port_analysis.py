"""The online analysis side channel (``realtime/analysis``) and the
engine's recording commands against the JAX package on the CPU: a click
track through ``OnlineAnalysis`` hop by hop (live and by ``poll``), the
onset envelope, the tempogram, the picked onsets, the BPM and the
quantized recording markers; the numpy helpers exactly.

Tolerances: the onset envelope and the tempogram within 1e-4 absolute
(float32 FFTs of another library, normalised to [0, 1]); picked onsets,
quantized markers and BPM estimates exactly."""

import numpy as np
import pytest

from onset_fingerprinting_tpu.core.config import RealtimeConfig as JCfg
from onset_fingerprinting_tpu.core.ring_buffer import CircularArray as JRing
from onset_fingerprinting_tpu.realtime import analysis as ja
from onset_fingerprinting_torch.core.config import RealtimeConfig as TCfg
from onset_fingerprinting_torch.core.ring_buffer import CircularArray as TRing
from onset_fingerprinting_torch.realtime import analysis as ta

SR = 48000
KW = dict(sr=SR, blocksize=256, hop_length=256, n_fft=1024,
          tg_win_length=384, max_recording_seconds=8)


def click_track(bpm=120, seconds=6, sr=SR, seed=0):
    n = sr * seconds
    audio = np.random.default_rng(seed).normal(0, 1e-3, n).astype(
        np.float32)
    beat = int(sr * 60 / bpm)
    t = np.arange(256)
    click = (np.sin(2 * np.pi * 2000 / sr * t) * np.exp(-t / 40)).astype(
        np.float32)
    for s in range(sr // 2, n - 300, beat):
        audio[s: s + 256] += click
    return audio


def _pair(seconds=6, bpm=120, poll=False):
    audio = click_track(bpm, seconds)
    jr = JRing(np.zeros((JCfg(**KW).rec_n, 1), np.float32))
    tr = TRing(np.zeros((TCfg(**KW).rec_n, 1), np.float32))
    jana = ja.OnlineAnalysis(JCfg(**KW), jr)
    tana = ta.OnlineAnalysis(TCfg(**KW), tr, device="cpu")
    hop = KW["hop_length"]
    for i in range(len(audio) // hop):
        blk = audio[i * hop:(i + 1) * hop, None]
        jr.write(blk)
        tr.write(blk)
        if poll and i % 5:
            continue
        if poll:
            assert tana.poll() == jana.poll()
        else:
            jana.hop()
            tana.hop()
    if poll:
        tana.poll()
        jana.poll()
    return jana, tana


@pytest.mark.parametrize("poll", [False, True])
def test_online_analysis_matches_jax(poll):
    jana, tana = _pair(poll=poll)
    np.testing.assert_allclose(tana.onset_env[-900:], jana.onset_env[-900:],
                               atol=1e-4)
    np.testing.assert_allclose(tana.tg[-800:], jana.tg[-800:], atol=1e-4)
    np.testing.assert_allclose(tana.mov_max, jana.mov_max, atol=1e-4)
    np.testing.assert_allclose(tana.mov_avg, jana.mov_avg, atol=1e-4)
    tp, _ = tana.detect_onsets(-900)
    jp, _ = jana.detect_onsets(-900)
    np.testing.assert_array_equal(tp, jp)
    assert len(tp) >= 6
    assert tana.bpm(-800) == jana.bpm(-800)
    assert 110 < tana.bpm(-800) < 130 or 55 < tana.bpm(-800) < 65


def test_quantized_markers_match_jax():
    jana, tana = _pair(seconds=7)
    for ana in (jana, tana):
        ana.recording_start = SR * 2 + 3000
        ana.recording_end = SR * 6 + 1000
    assert tana.quantize_start() == jana.quantize_start()
    assert tana.recording_start == jana.recording_start
    assert tana.quantize_end() == jana.quantize_end()
    assert tana.last_bpm == jana.last_bpm


def test_helpers_match_jax():
    rng = np.random.default_rng(2)
    onsets = np.sort(rng.integers(0, 96000, 20))
    assert ta.find_offset(onsets, 120, SR, method="Powell") == \
        ja.find_offset(onsets, 120, SR, method="Powell")
    assert ta.closest_distance(onsets, onsets + 7) == \
        ja.closest_distance(onsets, onsets + 7)
    np.testing.assert_array_equal(ta.tempo_frequencies(64, 256, SR),
                                  ja.tempo_frequencies(64, 256, SR))
    assert ta.int_to_channels(ta.channels_to_int([0, 2, 5])) == [0, 2, 5]
    np.testing.assert_array_equal(ta.make_clave(SR), ja.make_clave(SR))
    env = rng.uniform(0, 1, 200).astype(np.float32)
    env[::17] = 1.5
    mx = np.maximum.accumulate(env)
    np.testing.assert_array_equal(
        ta.detect_onsets_online(env, mx, env * 0.5, 0.07, 3),
        ja.detect_onsets_online(env, mx, env * 0.5, 0.07, 3))


def test_engine_recording_commands():
    """attach_analysis, start_recording, stop_recording and bpm on the
    port's engine (on the CPU): the markers the side channel quantizes,
    as the JAX engine computes them on the same blocks."""
    from onset_fingerprinting_tpu.core.config import DetectorConfig as JD
    from onset_fingerprinting_tpu.locate import Multilaterate3D as JM
    from onset_fingerprinting_tpu.realtime.engine import RealtimeEngine as JE
    from onset_fingerprinting_torch.core.config import DetectorConfig as TD
    from onset_fingerprinting_torch.locate.multilaterate import (
        Multilaterate3D as TM,
    )
    from onset_fingerprinting_torch.realtime.engine import (
        RealtimeEngine as TE,
    )

    polar = [(0.9, 0.0, 0.0), (0.9, 120.0, 0.0), (0.9, 240.0, 0.0)]
    audio = np.repeat(click_track(120, 3)[:, None], 3, axis=1)
    cfg = dict(n_channels=3, block_size=256, hipass_freq=0.0, sr=SR)
    kw = dict(KW, max_recording_seconds=6)
    je = JE(JD(**cfg), JM(polar, sr=SR), use_pallas=False)
    te = TE(TD(**cfg), TM(polar, sr=SR), device="cpu")
    je.attach_analysis(JCfg(**kw))
    assert te.attach_analysis(TCfg(**kw)) is te.analysis
    recs = []
    for eng in (je, te):
        for i in range(len(audio) // 256):
            eng.process_nosync(audio[i * 256:(i + 1) * 256])
            if i == 3 * SR // 2 // 256:
                start = eng.start_recording()
        assert eng.recording_active
        recs.append((start, eng.stop_recording(), eng.bpm(1.0)))
        assert not eng.recording_active
    assert recs[1] == recs[0]
    assert te.recordings == je.recordings
