"""The port's zone-classifier loop (``tools/zone_classifier.py``) on the CPU
at a small size: the fixture equal to the JAX demo's
(``examples/zone_classifier_demo.py``), both transforms against the demo's
on the same rows (within 1e-5 of their scale), the hit-level holdout, and
a short training run's shapes."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_torch.tools import zone_classifier as zc

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def demo():
    spec = importlib.util.spec_from_file_location(
        "zone_classifier_demo", REPO / "examples" / "zone_classifier_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def close(port, ref, rel=1e-5):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() <= rel * np.abs(ref).max()


def test_fixture_and_transforms_match_the_demo(demo):
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    for z in zc.ZONES:
        a, on = zc.synth_zone_session(rng, z, 4)
        ja, jon = demo.synth_zone_session(jrng, z, 4)
        np.testing.assert_array_equal(a, ja)
        assert on == jon
    ds, y, _ = zc.make_rows(4, 3, "cpu", n_rounds_aug=1)
    rows = ds.audio.numpy()
    assert rows.shape == (24, zc.FRAME + zc.PRE)
    np.testing.assert_array_equal(y, np.repeat([0, 1, 2], 8))
    close(zc.modal_transform(ds.audio, ds), demo.modal_transform(rows, ds))
    mfcc = zc.mfcc_transform(ds.audio, ds)
    assert mfcc.shape == (24, 14, 5)
    ref = demo.cspec_to_mfcc(demo.onset_stft(
        jnp.asarray(rows), zc.PRE, frame_length=256, hop_length=64,
        n_fft=512, method="zerozero"), sr=zc.SR)
    close(mfcc, ref)


def test_holdout_is_hit_level():
    hits, rounds = 12, 4
    tr, te = zc.holdout(hits, rounds, np.random.default_rng(0))
    n_rows = 3 * hits * rounds
    assert tr.shape == te.shape == (n_rows,)
    hit = np.concatenate([z * hits + np.arange(hits * rounds) % hits
                          for z in range(3)])
    exact = np.tile(np.arange(hits * rounds) < hits, 3)
    assert set(hit[tr]).isdisjoint(hit[te])
    assert exact[te].all() and te.sum() == (3 * hits) // 4
    assert tr.sum() == (3 * hits - te.sum()) * rounds


def test_short_run_on_the_cpu():
    res = zc.run(hits=6, seed=1, epochs=2, device="cpu", log=lambda *a: None)
    assert res["x"].shape == (72, 5, 140) and res["x"].dtype == torch.float32
    assert res["confusion"].sum() == res["n_test"] == 4
    assert res["n_train_rows"] == 14 * 4
    assert 0.0 <= res["accuracy"] <= 1.0 and res["epochs"] == 2
    assert set(res["seconds"]) == {"augment", "transform", "train"}
