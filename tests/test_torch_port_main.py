"""The serve application's port (``realtime/main``, ``runtime_native``,
``tools/train_setup``) against the JAX package on the CPU.

- ``build_engine`` from one setup directory (a reference ``model.pt``,
  which both packages load), then about 0.75 s of strikes: the port streams
  them through ``run_wav`` (the native executor, the pipelined dispatcher,
  the harvests, the analysis side channel), the JAX package through its
  ``build_engine`` and ``process``; the harvested events equal, onsets
  exactly, points within 1e-3 cm (float32 sums in another order).
- ``train_setup``'s ``session_lags_and_targets`` equal to JAX's exactly, in
  both representations and location formats; ``train_setup`` writes a
  setup ``build_engine`` serves.
- The native ring against the JAX package's on the same writes and reads,
  exactly, and the executor's block order.
"""

import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu import runtime_native as jrn
from onset_fingerprinting_tpu.core.coords import (
    speed_of_sound,
    spherical_to_cartesian,
)
from onset_fingerprinting_tpu.realtime import main as jmain
from onset_fingerprinting_tpu.tools import train_setup as jts
from onset_fingerprinting_torch import runtime_native as trn
from onset_fingerprinting_torch.core import posd
from onset_fingerprinting_torch.core.audio_io import write_wav
from onset_fingerprinting_torch.realtime import main as tmain
from onset_fingerprinting_torch.tools import train_setup as tts

SR = 96000
DIAM = 14 * 2.54
SENSORS = [[0.9, 0.0, 0.0], [0.9, 120.0, 0.0], [0.9, 240.0, 0.0]]


def _strikes(seconds=0.75, seed=2):
    """Bursts at three points of the head, each sensor's delayed by its
    distance (drumhead wave speed)."""
    radius = DIAM / 2
    xyz = [spherical_to_cartesian(r * radius, phi, th)
           for (r, phi, th) in SENSORS]
    c = speed_of_sound(100, medium="drumhead")
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    audio = rng.normal(0, 1e-4, (n, 3)).astype(np.float32)
    t = np.arange(600)
    burst = (np.sin(2 * np.pi * 5000 / SR * t) * np.exp(-t / 150)
             * 0.6).astype(np.float32)
    for base, (x, y) in zip((SR // 8, SR // 3, SR // 2),
                            ((4.0, -3.0), (-6.0, 2.0), (1.0, 7.5))):
        for ch, (sx, sy, _) in enumerate(xyz):
            d = np.hypot(x - float(sx), y - float(sy))
            s = base + int(round(d / c * SR))
            audio[s: s + 600, ch] += burst
    return audio


def _reference_setup(path):
    from test_torch_port_setup_io import reference_mlp, write_reference_setup

    net = reference_mlp(2, [10, 10, 10], seed=4)
    with torch.no_grad():
        net.network[0].weight /= 50
        net.network[-1].weight /= 20
    write_reference_setup(path, net, {"output_size": 2,
                                      "hidden_layers": [10, 10, 10],
                                      "batch_norm": True})


def test_run_wav_matches_jax_build_engine_and_process(tmp_path):
    _reference_setup(tmp_path / "setup")
    audio = _strikes()
    write_wav(tmp_path / "s.wav", audio, SR)
    n = len(audio) // 128

    jeng = jmain.build_engine(tmp_path / "setup", sr=SR)
    for i in range(n):
        jeng.process(audio[i * 128:(i + 1) * 128])
    want = jeng.harvest()

    torch.set_num_threads(1)
    eng = tmain.build_engine(tmp_path / "setup", sr=SR, device="cpu")
    assert eng.locator.model is not None and eng.analysis is not None
    got = []
    stats = tmain.run_wav(eng, tmp_path / "s.wav", depth=n + 1,
                          stop_timeout=300,
                          on_hit=lambda o, loc: got.append((o, loc)))
    assert stats["blocks"] == n and stats["drops"] == 0
    assert eng.current_index == 128 * n
    assert eng.analysis._hopped == 128 * n  # every hop of the side channel
    assert len(want) >= 3 and len(got) == len(want)
    for (ot, lt), (oj, lj) in zip(got, want):
        assert ot == oj
        np.testing.assert_allclose([lt.x, lt.y], [lj.x, lj.y], atol=1e-3)


def _session(rng, n=24):
    hits = []
    for i in range(n):
        on = (rng.integers(0, 200, 3) + 1000 * i).tolist()
        if i % 7 == 3:
            on[int(rng.integers(3))] = -1
        h = {"i": i, "onset_start": on,
             "location": [float(rng.uniform(0, 1)),
                          float(rng.uniform(0, 360))]}
        if i % 9 == 5:
            h.pop("location")
        hits.append(h)
    return {"meta": {}, "hits": hits}


@pytest.mark.parametrize("mode", ["arrival", "by_channel"])
@pytest.mark.parametrize("fmt", ["polar", "xy_cm"])
def test_session_lags_and_targets_match_jax(mode, fmt):
    session = _session(np.random.default_rng(0))
    got = tts.session_lags_and_targets(session, mode, fmt, 17.78)
    want = jts.session_lags_and_targets(session, mode, fmt, 17.78)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="model_input"):
        tts.session_lags_and_targets(session, "nope")


def test_train_setup_writes_a_served_setup(tmp_path):
    rng = np.random.default_rng(1)
    session = _session(rng, 40)
    posd.write_json(session, tmp_path / "s.json")
    err = tts.train_setup(tmp_path / "s.json", tmp_path / "setup", SENSORS,
                          model_input="by_channel", epochs=100,
                          epochs_per_step=50, device="cpu")
    assert np.isfinite(err)
    eng = tmain.build_engine(tmp_path / "setup", sr=SR, device="cpu")
    assert eng.locator.model_input == "by_channel"
    assert eng.locator.radius == pytest.approx(17.78)


def test_native_ring_matches_jax():
    rng = np.random.default_rng(3)
    rings = [trn.NativeRing(100, 3), jrn.NativeRing(100, 3)]
    for _ in range(12):
        x = rng.normal(size=(int(rng.integers(1, 40)), 3)).astype(
            np.float32)
        k = int(rng.integers(1, 60))
        outs = []
        for r in rings:
            r.write(x)
            outs.append((r.readable, r.read(k), r.peek_last(50),
                         r.write_counter, r.read_counter))
        (ta, tb, tc, td, te), (ja, jb, jc, jd, je) = outs
        assert (ta, td, te) == (ja, jd, je)
        assert (tb is None) == (jb is None)
        if tb is not None:
            np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tc, jc)


def test_native_executor_runs_blocks_in_order():
    ring = trn.NativeRing(4096, 2)
    seen = []
    ex = trn.NativeExecutor(ring, 64, lambda b, i: seen.append(
        (i, float(b[0, 0]))))
    ex.start()
    x = np.repeat(np.arange(1024, dtype=np.float32)[:, None], 2, axis=1)
    ring.write(x)
    import time

    t0 = time.time()
    while ex.blocks_processed < 16 and time.time() - t0 < 10:
        time.sleep(0.01)
    ex.stop()
    assert seen == [(i, 64.0 * i) for i in range(16)]
    assert ex.latency_stats()["count"] == 16
