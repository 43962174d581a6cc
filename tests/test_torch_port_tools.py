"""The port's hit editors and detector tuner against the JAX package's, on
the CPU: the wide/long hit-dict conversions, the editor models' edits and
their saved sessions, and ``DetectorTuner(device="cpu").detect()`` over
three slider settings on tests/test_tools_utils.py's fixture."""

import json

import numpy as np
import pytest

from onset_fingerprinting_tpu.tools import choose_od_settings as jtune
from onset_fingerprinting_tpu.tools import modify_hits as jhits
from onset_fingerprinting_tpu.tools import modify_hits_mc as jhits_mc
from onset_fingerprinting_torch.core import posd as posd_io
from onset_fingerprinting_torch.tools import choose_od_settings as ptune
from onset_fingerprinting_torch.tools import modify_hits as phits
from onset_fingerprinting_torch.tools import modify_hits_mc as phits_mc

WIDE = [
    {"onset_start": [10, 20], "zone": ["a", "b"],
     "conditions": {"stick": ["w", "n"]}},
    {"onset_start": [[100, 104, -1], [900, 905, 911]], "zone": ["c", "c"],
     "location": [[1.0, 2.0], [3.0, 4.0]]},
    {"onset_start": [5], "conditions": {"stick": ["w"], "dyn": ["ff"]}},
]


@pytest.mark.parametrize("case", range(len(WIDE)))
def test_hit_dict_round_trip_equals_jax(case):
    wide = WIDE[case]
    long = phits.hits_to_long(wide)
    assert long == jhits.hits_to_long(wide)
    back = phits.long_to_hits(long)
    assert back == jhits.long_to_hits(long)
    assert back == wide
    assert phits.hits_to_long(back) == long


def test_long_to_hits_ragged_and_empty_equal_jax():
    recs = [{"onset_start": 3, "zone": "a"},
            {"onset_start": 9, "conditions": {"stick": "n"}}]
    assert phits.long_to_hits(recs) == jhits.long_to_hits(recs)
    assert phits.long_to_hits([]) == jhits.long_to_hits([]) == {}


@pytest.fixture
def session(tmp_path, rng):
    audio = rng.normal(0, 1e-3, (24000, 2)).astype(np.float32)
    hits = posd_io.make_hits(
        np.array([[1000, 1010], [8000, 8020], [15000, -1]]),
        zones=["a", "b", "a"],
    )
    return posd_io.save_session(tmp_path, "sess", audio, 96000, hits)


def _saved(model):
    return json.loads(model.save().read_text())


def _edit_hits(m):
    m.move_onset(0, 1234)
    m.set_label(0, "zone", "rim")
    m.set_label(1, "stick", "brush")
    new = m.add_hit(5000, zone="new")
    m.selected = 3
    m.delete_hit(3)
    return new, m.selected


def test_hit_editor_edits_and_save_equal_jax(session):
    p, j = phits.HitEditorModel(session), jhits.HitEditorModel(session)
    assert p.records == j.records and len(p.records) == 3
    assert _edit_hits(p) == _edit_hits(j) == (1, 2)
    assert p.records == j.records
    saved = _saved(p)
    assert saved == _saved(j)
    assert [h["zone"] for h in saved["hits"]] == ["rim", "new", "b"]


def _edit_groups(m):
    out = [m.n_channels(), m.group(2).tolist()]
    m.set_channel_onset(0, 1, 1040)
    m.clear_channel(1, 0)
    m.set_channel_onset(2, 1, 15007)
    out.append([m.group(i).tolist() for i in range(len(m.records))])
    return out


def test_group_editor_edits_and_save_equal_jax(session):
    p, j = phits_mc.GroupEditorModel(session), jhits_mc.GroupEditorModel(
        session)
    got = _edit_groups(p)
    assert got == _edit_groups(j)
    assert got[0] == 2 and got[2] == [[1000, 1040], [-1, 8020],
                                      [15000, 15007]]
    assert _saved(p) == _saved(j)


@pytest.fixture
def tuner_audio(rng):
    """tests/test_tools_utils.py's tuner fixture: three bursts on both
    channels of half a second of noise."""
    audio = rng.normal(0, 1e-4, (48000, 2)).astype(np.float32)
    t = np.arange(500)
    burst = (np.sin(2 * np.pi * 0.3 * t) * np.exp(-t / 100) * 0.5)
    for base in (10000, 25000, 40000):
        audio[base: base + 500] += burst[:, None].astype(np.float32)
    return audio


#: the slider settings: the fixture's (no high-pass), a lower on-threshold
#: with a longer cooldown and a tighter grouping, and the high-pass on
TUNER_SETTINGS = [
    {"hipass_freq": 0.0},
    {"hipass_freq": 0.0, "on_threshold": 0.3, "off_threshold": 0.05,
     "cooldown": 2000.0, "max_distance": 500.0},
    {"floor": -60.0, "fast_attack": 5.0, "fast_release": 200.0},
]


@pytest.mark.parametrize("values", TUNER_SETTINGS)
def test_detector_tuner_equals_jax(tuner_audio, values):
    p = ptune.DetectorTuner(tuner_audio, 96000, min_channels=2,
                            device="cpu")
    j = jtune.DetectorTuner(tuner_audio, 96000, min_channels=2)
    assert p.SLIDERS == j.SLIDERS and p.values == j.values
    p.values.update(values)
    j.values.update(values)
    pc, po, pg = p.detect()
    jc, jo, jg = j.detect()
    assert [int(c) for c in pc] == [int(c) for c in jc]
    assert [int(o) for o in po] == [int(o) for o in jo]
    assert (pg is None) == (jg is None)
    if jg is not None:
        assert np.array_equal(pg, jg)
    assert po
    if values == TUNER_SETTINGS[0]:  # tests/test_tools_utils.py's bars
        assert len(po) >= 4 and pg is not None and len(pg) >= 2
