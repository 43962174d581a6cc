"""The mining path (``detect/amplitude``'s host wrappers,
``detect/grouping``, ``detect/refine``'s host functions,
``tools/mine_hits``) against the JAX package on the CPU, on numpy-seeded
synthetic recordings at a small size.

Tolerances: events (channels, onsets, groups, aligned onsets, the mined
hits JSON) exactly; ``rel`` within atol 2e-2 (the JAX suite's own bound,
tests/test_pallas.py:41-46: the CPU's and XLA's log2 and exp2 differ in
the last bits), and behind the 2 kHz high-pass also within 1e-3 relative
(the 4th-order IIR carries the two backends' rounding from sample to
sample, which the JAX suite exempts from its own golden test,
tests/test_detect.py:127-130); calibrated thresholds within 1e-4
relative."""

import json

import numpy as np
import pytest

from onset_fingerprinting_tpu.data.synth import synth_location_session
from onset_fingerprinting_tpu.detect import amplitude as jamp
from onset_fingerprinting_tpu.detect import grouping as jgrp
from onset_fingerprinting_tpu.detect import refine as jref
from onset_fingerprinting_tpu.tools import mine_hits as jmine
from onset_fingerprinting_torch.detect import amplitude as tamp
from onset_fingerprinting_torch.detect import grouping as tgrp
from onset_fingerprinting_torch.detect import refine as tref
from onset_fingerprinting_torch.tools import mine_hits as tmine

SR = 96000
SENSORS = [(0.9, 0.0), (0.9, 120.0), (0.9, 240.0)]


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """Three strikes 4000 samples apart (20000 samples: the warmup covers
    the whole recording, as for any recording under 0.5 s)."""
    d = tmp_path_factory.mktemp("session")
    on, loc = synth_location_session(d, "s0", n_hits=3, sr=SR, seed=3,
                                     sensors=SENSORS, spacing=4000)
    return d / "s0.wav", on


def test_detect_onsets_amplitude_matches_jax(session):
    from onset_fingerprinting_torch.core.audio_io import read_wav

    audio, sr = read_wav(session[0])
    jc, jo, jr = jamp.detect_onsets_amplitude(audio, sr=sr, backend="scan")
    tc, to, tr = tamp.detect_onsets_amplitude(audio, sr=sr, device="cpu")
    assert len(jo) >= 9
    assert [int(v) for v in tc] == [int(v) for v in jc]
    assert [int(v) for v in to] == [int(v) for v in jo]
    np.testing.assert_allclose(tr, np.asarray(jr), rtol=1e-3, atol=2e-2)
    with pytest.raises(ValueError, match="backend"):
        tamp.detect_onsets_amplitude(audio, backend="nope", device="cpu")


def test_amplitude_detector_blocks_and_init_match_jax():
    rng = np.random.default_rng(6)
    n = SR // 2
    x = rng.normal(0, 1e-3, (n, 2)).astype(np.float32)
    t = np.arange(400)
    burst = (np.sin(2 * np.pi * 3000 / SR * t) * np.exp(-t / 90)).astype(
        np.float32)
    for s in (14000, 30000, 41000):
        x[s: s + 400] += burst[:, None] * np.array([1.0, 0.7], np.float32)
    kw = dict(hipass_freq=0.0, sr=SR)
    jd = jamp.AmplitudeOnsetDetector(2, 128, **kw)
    td = tamp.AmplitudeOnsetDetector(2, 128, device="cpu", **kw)
    jd.init_minmax_tracker(x[:12800])
    td.init_minmax_tracker(x[:12800])
    found = 0
    for i in range(100, 180):
        blk = x[i * 128:(i + 1) * 128]
        jc, jdl, jr = jd(blk)
        tc, tdl, tr = td(blk)
        assert [int(v) for v in tc] == [int(v) for v in jc]
        assert [int(v) for v in tdl] == [int(v) for v in jdl]
        np.testing.assert_allclose(tr, jr, atol=2e-2)
        found += len(tc)
    assert found >= 2
    jn = jamp.AmplitudeOnsetDetector(2, 128, **kw).init(x, verbose=False)
    tdet = tamp.AmplitudeOnsetDetector(2, 128, device="cpu", **kw)
    tn = tdet.init(x, verbose=False)
    assert tdet.static.manual
    np.testing.assert_allclose(tn, jn, rtol=1e-4)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kw", [dict(), dict(max_distance=300),
                                dict(min_channels=2, close_channel=1)])
def test_find_onset_groups_matches_jax(seed, kw):
    rng = np.random.default_rng(seed)
    onsets, channels = [], []
    t = 0
    for _ in range(40):
        t += int(rng.integers(200, 3000))
        for ch in rng.permutation(3)[: int(rng.integers(1, 4))]:
            onsets.append(t + int(rng.integers(0, 500)))
            channels.append(int(ch))
    order = np.argsort(onsets, kind="stable")
    onsets = [onsets[i] for i in order]
    channels = [channels[i] for i in order]
    got = tgrp.find_onset_groups(onsets, channels, **kw)
    want = jgrp.find_onset_groups(onsets, channels, **kw)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)
    assert tgrp.find_onset_groups([], []) is None


@pytest.mark.parametrize("kw", [dict(take_abs=True, d=1),
                                dict(onset_direction="down", zero_left=True),
                                dict(onset_direction="up", shift_onsets=3)])
def test_fix_onsets_and_host_helpers_match_jax(session, kw):
    from onset_fingerprinting_torch.core.audio_io import read_wav

    audio, _ = read_wav(session[0])
    audio = audio.astype(np.float64)
    true_on = session[1]
    rng = np.random.default_rng(1)
    groups = np.stack([true_on + rng.integers(-20, 20, len(true_on))
                       + 40 * k for k in range(3)], axis=1)
    np.testing.assert_array_equal(tref.fix_onsets(audio, groups, **kw),
                                  jref.fix_onsets(audio, groups, **kw))
    for direction in ("up", "down"):
        np.testing.assert_array_equal(
            tref.filter_data(audio[:3000].copy(), direction),
            jref.filter_data(audio[:3000].copy(), direction))
    for o in true_on:
        assert tref.detect_onset_region(audio[:, 0], int(o)) == \
            jref.detect_onset_region(audio[:, 0], int(o))


def test_mine_file_writes_jax_hits(session, tmp_path):
    wav = session[0]
    jp = jmine.mine_file(wav, tmp_path / "j", min_channels=3, fix=True,
                         backend="scan")
    tp = tmine.mine_file(wav, tmp_path / "t", min_channels=3, fix=True,
                         device="cpu")
    want = json.loads(jp.read_text())
    got = json.loads(tp.read_text())
    assert len(want["hits"]) == 3
    assert got["hits"] == want["hits"]
    assert got["meta"]["sr"] == want["meta"]["sr"] == SR
    assert tmine.main([str(wav), "--out", str(tmp_path / "cli"), "--fix",
                       "--cpu"]) == 0
