"""The port's data path against the JAX package's: the copied modules
(synth, POSD I/O, WAV I/O, the HPO study) give the same files and draws;
``extract_frames`` and the extractors give the same windows (the numpy-
seeded ones draw for draw); ``MCPOSD.from_file``, ``split`` and
``split_hits`` give equal x and y at ``max_shift=0``, and shifted windows
equal the unshifted gather at the shifts the port drew.  Bar: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.core import audio_io as jaudio
from onset_fingerprinting_tpu.core import posd as jposd
from onset_fingerprinting_tpu.data import frames as jframes
from onset_fingerprinting_tpu.data.datasets import MCPOSD as JMCPOSD
from onset_fingerprinting_tpu.data.synth import (
    synth_location_session as jsynth,
)
from onset_fingerprinting_tpu.models import hpo as jhpo
from onset_fingerprinting_torch.core import audio_io as taudio
from onset_fingerprinting_torch.core import posd as tposd
from onset_fingerprinting_torch.data import frames as tframes
from onset_fingerprinting_torch.data.datasets import MCPOSD
from onset_fingerprinting_torch.data.synth import (
    synth_location_session as tsynth,
)
from onset_fingerprinting_torch.models import hpo as thpo


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """A small synth session written by each package."""
    root = tmp_path_factory.mktemp("synth")
    jsynth(root / "jax", n_hits=24, sr=96000, seed=0)
    tsynth(root / "torch", n_hits=24, sr=96000, seed=0)
    return root


def test_synth_session_files_are_identical(session):
    for name in ("combined0.wav", "combined0.json"):
        assert (session / "jax" / name).read_bytes() == \
            (session / "torch" / name).read_bytes()
    data, sr = taudio.read_wav(session / "torch" / "combined0.wav")
    jdata, jsr = jaudio.read_wav(session / "jax" / "combined0.wav")
    assert sr == jsr and np.array_equal(data, jdata)
    hits = tposd.read_json(session / "torch" / "combined0.json")["hits"]
    jhits = jposd.read_json(session / "jax" / "combined0.json")["hits"]
    np.testing.assert_array_equal(tposd.onsets_array(hits),
                                  jposd.onsets_array(jhits))
    np.testing.assert_array_equal(tposd.locations_array(hits),
                                  jposd.locations_array(jhits))


def test_wav_round_trip_equals_jax(tmp_path):
    x = np.random.default_rng(0).uniform(-1, 1, (500, 3)).astype(np.float32)
    taudio.write_wav(tmp_path / "t.wav", x, 48000)
    jaudio.write_wav(tmp_path / "j.wav", x, 48000)
    assert (tmp_path / "t.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()


@pytest.mark.parametrize("shape", [(300,), (300, 4)])
def test_extract_frames_clips_like_jax(shape):
    audio = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    starts = np.array([-5, 0, 17, 280, 299], np.int64)
    want = np.asarray(jframes.extract_frames(jnp.asarray(audio),
                                             jnp.asarray(starts), 32))
    got = tframes.extract_frames(torch.as_tensor(audio),
                                 torch.as_tensor(starts), 32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kw,mono", [
    (dict(), False), (dict(max_shift=5), False),
    (dict(use_min_onset=False), False),
    (dict(use_min_onset=False, max_shift=3), False),
    (dict(add_pre_samples=True), False),
    (dict(), True), (dict(max_shift=5), True),
    (dict(add_pre_samples=True), True)], ids=str)
def test_frame_extractor_matches_jax(kw, mono):
    rng = np.random.default_rng(2)
    audio = rng.normal(size=(2000, 3)).astype(np.float32)
    onsets = rng.integers(10, 1900, (7, 3))
    if mono:
        audio, onsets = audio[:, 0], onsets[:, 0]
    j = jframes.FrameExtractor(40, 8, seed=3, **kw)
    t = tframes.FrameExtractor(40, 8, seed=3, device="cpu", **kw)
    for _ in range(2):  # two draws of the shared numpy generator
        np.testing.assert_array_equal(t(audio, onsets), j(audio, onsets))


def test_stretch_extractor_matches_jax():
    rng = np.random.default_rng(4)
    audio = rng.normal(size=(3000, 2)).astype(np.float32)
    onsets = rng.integers(50, 2500, (5, 2))
    j = jframes.StretchFrameExtractor(64, 8, seed=5)
    t = tframes.StretchFrameExtractor(64, 8, seed=5)
    np.testing.assert_allclose(t(audio, onsets), j(audio, onsets),
                               atol=1e-6)


def test_mcposd_matches_jax_at_max_shift_0(session):
    folder = session / "torch"
    j = JMCPOSD.from_file(folder, "combined0", 256, 8)
    t = MCPOSD.from_file(folder, "combined0", 256, 8, device="cpu")
    for a, b in zip(t[0], j[0]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for ta, ja in zip(t.split(0.75, seed=1), j.split(0.75, seed=1)):
        np.testing.assert_array_equal(ta.x.numpy(), np.asarray(ja.x))
        np.testing.assert_array_equal(ta.y.numpy(), np.asarray(ja.y))
    jt_, je = JMCPOSD.from_file(folder, "combined0", 256, 8, 0,
                                2).split_hits(0.75, seed=1)
    tt_, te = MCPOSD.from_file(folder, "combined0", 256, 8, 0, 2,
                               device="cpu").split_hits(0.75, seed=1)
    for a, b in zip(tt_[0], jt_[0]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(te[0], je[0]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert te.straight and not tt_.straight


def test_shifted_windows_are_the_gather_at_the_drawn_shifts(session):
    folder = session / "torch"
    full = MCPOSD.from_file(folder, "combined0", 256, 8, 16, 3,
                            device="cpu")
    train, evald = full.split_hits(0.75, seed=1)
    x, y = train[0]
    n = len(train._onsets)
    assert x.shape == (3 * n, 4, 256) and y.shape == (3 * n, 2)
    assert torch.equal(y[:n], y[n:2 * n])
    shifts = train.frame_extractor.last_shifts  # the third round's
    assert shifts.abs().max() <= 16 and shifts.unique().numel() > 1
    fe = train.frame_extractor
    want = tframes.extract_frames(fe.audio, fe.onsets - 8 + shifts, 256)
    assert torch.equal(x[2 * n:], want.transpose(1, 2))
    # the eval hits: extracted once, unshifted, as JAX extracts them
    jfull = JMCPOSD.from_file(folder, "combined0", 256, 8, 16, 3)
    je = jfull.split_hits(0.75, seed=1)[1]
    np.testing.assert_array_equal(evald.x.numpy(), np.asarray(je.x))


def test_hpo_study_is_the_same_copy():
    def objective(study_mod):
        def f(trial):
            a = trial.suggest_float("a", 1e-3, 1.0, log=True)
            b = trial.suggest_categorical("b", [None, "x", "y"])
            return a + (0.5 if b is None else 0.0)
        return f

    studies = []
    for mod in (thpo, jhpo):
        s = mod.Study(seed=3, sampler="tpe")
        s.optimize(objective(mod), n_trials=12)
        studies.append(s)
    assert studies[0].best_params == studies[1].best_params
    assert studies[0].best_value == studies[1].best_value
