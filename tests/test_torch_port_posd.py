"""The port's POSD classification dataset against the JAX package's, on the
CPU: ``POSD(path)`` over sessions written with the port's ``core.posd`` and
``POSD.from_audio_onsets``, without augmentation equal to JAX's (audio
exactly, ``labels`` equal); with augmentation the exact rows and the labels
equal to JAX's and each augmented row equal to the port's ``some_of_apply``
at the draws its generator made; the transform hook and ``query``."""

import numpy as np
import pandas as pd
import pytest
import torch

from onset_fingerprinting_tpu.data.datasets import POSD as JPOSD
from onset_fingerprinting_torch.core import posd as posd_io
from onset_fingerprinting_torch.core.audio_io import write_wav
from onset_fingerprinting_torch.data.augment import (
    some_of_apply,
    some_of_draws,
)
from onset_fingerprinting_torch.data.datasets import POSD, posd_rows

SR = 48000
FRAME, PRE = 64, 8


def recording(seed, n=4000):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 0.2, n).astype(np.float32)


def onsets(seed, n_hits):
    rng = np.random.default_rng(100 + seed)
    return np.sort(rng.choice(np.arange(20, 3900), n_hits, replace=False))


@pytest.fixture
def sessions(tmp_path):
    """Two mono sessions on channel "0" (their hit tables carry zones and a
    condition) written as the POSD format lays them out."""
    for s, n_hits in ((0, 5), (1, 3)):
        name = f"sess{s}"
        audio = recording(s)
        on = onsets(s, n_hits)
        hits = posd_io.make_hits(
            on, zones=[f"z{i % 2}" for i in range(n_hits)],
            conditions={"stick": ["hard"] * n_hits})
        posd_io.save_session(tmp_path / f"d{s}", name, audio, SR, hits)
        write_wav(tmp_path / f"d{s}" / f"{name}_0.wav", audio, SR)
    return tmp_path


def test_posd_from_sessions_equals_jax(sessions):
    ds = POSD(sessions, FRAME, "0", pre_samples=PRE, n_rounds_aug=0,
              device="cpu")
    ref = JPOSD(sessions, FRAME, "0", pre_samples=PRE, n_rounds_aug=0)
    assert ds.audio.shape == (8, FRAME + PRE) and len(ds) == 8
    np.testing.assert_array_equal(ds.audio.numpy(), ref.audio)
    pd.testing.assert_frame_equal(ds.labels, ref.labels)
    x, row = ds[3]
    np.testing.assert_array_equal(x.numpy(), ref[3][0])
    assert row.equals(ref[3][1])


def test_posd_augmented_rows(sessions):
    """Rows per session: its hits' exact frames, then two rounds of
    ``some_of`` over them."""
    ds = POSD(sessions, FRAME, "0", pre_samples=PRE, n_rounds_aug=2,
              seed=4, device="cpu")
    ref = JPOSD(sessions, FRAME, "0", pre_samples=PRE, n_rounds_aug=2)
    assert ds.audio.shape == ref.audio.shape == (24, FRAME + PRE)
    pd.testing.assert_frame_equal(ds.labels, ref.labels)
    g = torch.Generator().manual_seed(4)
    i = 0
    for n_hits in (5, 3):
        exact = ds.audio[i:i + n_hits]
        np.testing.assert_array_equal(exact.numpy(), ref.audio[i:i + n_hits])
        i += n_hits
        for _ in range(2):
            chosen, draws = some_of_draws(g, exact)
            want = some_of_apply(exact, chosen, draws, SR)
            torch.testing.assert_close(ds.audio[i:i + n_hits], want,
                                       rtol=0, atol=0)
            assert not torch.equal(want, exact) or not chosen.any()
            i += n_hits
    assert i == len(ds)


def test_from_audio_onsets_equals_jax():
    audios = [recording(s) for s in range(3)]
    ons = [onsets(s, 4) for s in range(3)]
    kw = dict(sr=SR, frame_length=FRAME, pre_samples=PRE, n_rounds_aug=0,
              zone_names=["a", "b", "c"])
    ds = POSD.from_audio_onsets(audios, ons, device="cpu", **kw)
    ref = JPOSD.from_audio_onsets(audios, ons, **kw)
    np.testing.assert_array_equal(ds.audio.numpy(), ref.audio)
    pd.testing.assert_frame_equal(ds.labels, ref.labels)
    sub, jsub = ds.query("zone == 'b'"), ref.query("zone == 'b'")
    np.testing.assert_array_equal(sub.audio.numpy(), jsub.audio)
    pd.testing.assert_frame_equal(sub.labels, jsub.labels)


def test_from_audio_onsets_transform_and_rows():
    """The transform hook sees the rows tensor and the dataset; the device
    half alone gives the same rows; the labels are built at first use."""
    audios = [recording(s) for s in range(2)]
    ons = [onsets(s, 3) for s in range(2)]
    seen = {}

    def transform(audio, posd):
        seen["pre"] = posd.pre_samples
        return audio[:, None, :16] * 2

    ds = POSD.from_audio_onsets(audios, ons, SR, FRAME, transform,
                                pre_samples=PRE, n_rounds_aug=1, seed=2,
                                device="cpu")
    assert ds.audio.shape == (12, 1, 16) and seen == {"pre": PRE}
    assert ds._labels is None
    assert list(ds.labels["zone"]) == [0] * 6 + [1] * 6
    plain = POSD.from_audio_onsets(audios, ons, SR, FRAME, pre_samples=PRE,
                                   n_rounds_aug=1, seed=2, device="cpu")
    rows = posd_rows(audios, ons, [SR, SR], plain.frame_extractor,
                     [plain.frame_extractor], plain.augmentations, 1,
                     torch.Generator().manual_seed(2))
    torch.testing.assert_close(rows, plain.audio, rtol=0, atol=0)
    torch.testing.assert_close(ds.audio, rows[:, None, :16] * 2, rtol=0,
                               atol=0)
