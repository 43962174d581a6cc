"""The realtime engine against the JAX package's on the CPU: the step's
events and state block by block on a synthetic 3-sensor stream (the demo's
configuration: 96 kHz, 128-sample blocks, no high-pass, coupled off-gate,
feasibility tiers 1 and 2 cm), the packed event vector, harvest past
overflow and past 2^24 hits, the classifier (stale hits included), the
pipelined dispatcher and the harvester thread.

Tolerances: on, onsets, emits, the event queue's counts, onsets and emit
stamps, the locator state and the detector's integer and boolean state
exactly; the detector's float state within 2e-3 relative (the plain
detector's dB and linear conversions differ from XLA's in the last bit,
and the slow envelopes carry that over thousands of samples: 5e-4 after
the quarter-second warmup); located points within 1e-3 cm (float32 sums
in another order); classifier predictions within 1e-4 (float32 CCCNN)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.core.config import DetectorConfig as JCfg
from onset_fingerprinting_tpu.locate import Multilaterate3D as JLoc
from onset_fingerprinting_tpu.models.cccnn import CCCNN as JCCCNN
from onset_fingerprinting_tpu.realtime import engine as je
from onset_fingerprinting_torch.core.config import DetectorConfig
from onset_fingerprinting_torch.locate.multilaterate import Multilaterate3D
from onset_fingerprinting_torch.models.cccnn import CCCNN
from onset_fingerprinting_torch.models.jax_import import (
    cccnn_state_dict_from_flax,
)
from onset_fingerprinting_torch.ops import _cuda
from onset_fingerprinting_torch.realtime import engine as te
from onset_fingerprinting_torch.tools import realtime_sim as sim
from onset_fingerprinting_torch.workload import cccnn_flax_params

from test_torch_port_locate import NoHostRead, np_

SR = sim.SR
KW = dict(n_channels=3, block_size=128, hipass_freq=0.0, sr=SR)
LOC = dict(drum_diameter=sim.DIAM, medium="drumhead", sr=SR,
           feasibility_tols=sim.FEASIBILITY_TOLS)


def engines(ring_seconds=0.5, event_queue=64):
    _, polar, _, _ = sim._geometry()
    t = te.RealtimeEngine(DetectorConfig(**KW), Multilaterate3D(polar, **LOC),
                          ring_seconds=ring_seconds, event_queue=event_queue,
                          device="cpu")
    j = je.RealtimeEngine(JCfg(**KW), JLoc(polar, **LOC),
                          ring_seconds=ring_seconds, event_queue=event_queue,
                          use_pallas=False)
    return t, j


def assert_tree_equal(t, j, what):
    for name, a in zip(type(t)._fields, t):
        b = getattr(j, name)
        if hasattr(a, "_fields"):
            assert_tree_equal(a, b, f"{what}.{name}")
        elif name == "ring":
            continue
        elif a.dtype.is_floating_point and "detector" in what:
            np.testing.assert_allclose(np_(a), np.asarray(b), rtol=2e-3,
                                       atol=1e-5, err_msg=f"{what}.{name}")
        elif name == "ev_points":
            np.testing.assert_allclose(np_(a), np.asarray(b), atol=1e-3,
                                       err_msg=f"{what}.{name}")
        else:
            np.testing.assert_array_equal(np_(a), np.asarray(b),
                                          err_msg=f"{what}.{name}")


@pytest.fixture(scope="module")
def stream():
    """0.57 s of the demo's stream: two strikes after the 0.25 s
    warmup."""
    audio, _, hits = sim.synth_stream(0.57, seed=3)
    return audio, hits


def test_engine_step_matches_jax(stream):
    """Block by block: the same on, onsets and emits, points within 1e-3
    cm, and after the stream the same detector, locator and queue state;
    both locate the two strikes within 1 cm."""
    audio, hits = stream
    t, j = engines()
    warm = SR // 4
    t.warmup(audio[:warm])
    j.warmup(audio[:warm])
    assert_tree_equal(t.state.detector, j.state.detector, "warmup.detector")
    n_emit = 0
    for i in range(warm // 128, len(audio) // 128):
        blk = audio[i * 128:(i + 1) * 128]
        t.state, tev = t._step(t.state, torch.as_tensor(blk), t.params)
        j.state, jev = j._step(j.state, jnp.asarray(blk), j.params)
        for name in ("on", "onsets", "emits"):
            np.testing.assert_array_equal(
                np_(getattr(tev, name)), np.asarray(getattr(jev, name)),
                err_msg=f"block {i} {name}")
        np.testing.assert_allclose(np_(tev.points), np.asarray(jev.points),
                                   atol=1e-3)
        n_emit += int(np_(tev.emits).sum())
    assert n_emit == len(hits) == 2
    assert_tree_equal(t.state, j.state, "state")
    np.testing.assert_array_equal(np_(t.state.ring.data),
                                  np.asarray(j.state.ring.data))
    tl, jl = t.harvest(), j.harvest()
    assert [o for o, _ in tl] == [o for o, _ in jl]
    for (_, a), (_, b), (_, x, y, _) in zip(tl, jl, hits):
        assert abs(a.x - b.x) < 1e-3 and abs(a.y - b.y) < 1e-3
        assert np.hypot(a.x - x, a.y - y) < 1.0


def test_process_and_pipeline_give_the_same_hits(stream):
    """process (a read per block), process_nosync + harvest, and the
    pipelined dispatcher with the harvester thread: the same located
    hits, no drops, on the stream's first strike."""
    audio, _ = stream
    warm = SR // 4
    blocks = [audio[i * 128:(i + 1) * 128]
              for i in range(warm // 128, 26000 // 128)]
    t, _ = engines()
    t.warmup(audio[:warm])
    sync = []
    for b in blocks:
        _, locs = t.process(b)
        sync.extend((loc.x, loc.y) for loc in locs)
    assert len(sync) == 1
    p, _ = engines()
    p.warmup(audio[:warm])
    got = []
    p.start_harvester(got.append, period=0.001)
    p.start_pipeline(depth=len(blocks) + 1)
    for b in blocks:
        p.process_pipelined(b)
    p.stop_pipeline(timeout=120)
    p.stop_harvester(timeout=30)
    got.extend(p.harvest())
    assert p.pipeline_drops == 0 and p.harvest_drops == 0
    assert [(loc.x, loc.y) for _, loc in got] == sync
    assert p.current_index == len(blocks) * 128
    assert len(p.hit_latencies_ms) == 1
    assert all(np.isfinite(p.hit_latencies_ms))


def test_pack_events_roundtrip_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(8, 2)).astype(np.float32)
    ons = rng.integers(0, 2 ** 31 - 1, 8).astype(np.int32)
    ems = rng.integers(0, 2 ** 31 - 1, 8).astype(np.int32)
    count = np.int32(2 ** 24 + 1)
    got = np_(te._pack_events(torch.tensor(count), torch.as_tensor(pts),
                              torch.as_tensor(ons), torch.as_tensor(ems)))
    want = np.asarray(je._pack_events(jnp.int32(count), jnp.asarray(pts),
                                      jnp.asarray(ons), jnp.asarray(ems)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert int(got[0]) == count
    np.testing.assert_array_equal(got[1:17].view(np.float32).reshape(8, 2),
                                  pts)


def test_harvest_overflow_warns_and_counts():
    t, _ = engines()
    eq = t.state.ev_points.shape[0]
    t.state = t.state._replace(
        ev_points=torch.arange(eq * 2, dtype=torch.float32).reshape(eq, 2),
        ev_onsets=torch.arange(eq, dtype=torch.int32),
        ev_count=torch.tensor(eq + 3, dtype=torch.int32))
    with pytest.warns(UserWarning, match="overflowed"):
        events = t.harvest()
    assert len(events) == eq and t.harvest_drops == 3
    assert events[0][0] == 3 % eq


def test_harvest_count_exact_past_f32_integers():
    """ev_count rides the packed int32 read bit for bit: a float cast would
    round past 2^24 hits."""
    t, _ = engines()
    big = 2 ** 24 + 1
    t._harvested = big - 2
    t.state = t.state._replace(ev_count=torch.tensor(big, dtype=torch.int32))
    assert len(t.harvest()) == 2 and t.harvest_drops == 0


CLS = dict(output_size=3, channels=3, layer_sizes=(4, 4),
           kernel_sizes=(5, 3), dropout_rate=0.0, cc_impl="dft",
           cc_norm=True)


def test_classify_matches_jax_with_stale_hits():
    """The classifier over a wrapped ring: the same fresh mask and
    predictions (zero where stale or invalid) as JAX's, from the same
    windows: fresh hits, an early onset (window start < 0, clamped, fresh),
    an onset near the head (shifted back), an overwritten one (stale)."""
    window, pre, cap = 64, 16, 8
    params = cccnn_flax_params(CLS, seed=2, window=window)
    tm = CCCNN(input_size=window, **CLS)
    tm.load_state_dict(cccnn_state_dict_from_flax(params))
    tfn = te.make_classify_fn(tm, window=window, pre=pre, capacity=cap,
                              device="cpu")
    jfn = je.make_classify_fn(JCCCNN(**CLS), params, window=window, pre=pre,
                              capacity=cap)
    from onset_fingerprinting_tpu.core.ring_buffer import ring_init, ring_write
    from onset_fingerprinting_torch.core import ring_buffer as trb

    rng = np.random.default_rng(4)
    audio = rng.normal(size=(700, 3)).astype(np.float32)
    jr, tr = ring_init(300, (3,)), trb.ring_init(300, (3,))
    for blk in np.split(audio, 7):
        jr = ring_write(jr, jnp.asarray(blk))
        tr = trb.ring_write(tr, torch.as_tensor(blk))
    onsets = np.array([500, 650, 10, 690, 380, 420, 699, 0], np.int32)
    valid = np.array([1, 1, 1, 1, 1, 1, 1, 0], bool)
    wp, wf = jfn(jr, jnp.asarray(onsets), jnp.asarray(valid))
    tp, tf = tfn(tr, torch.as_tensor(onsets), torch.as_tensor(valid))
    np.testing.assert_array_equal(np_(tf), np.asarray(wf))
    assert np_(tf).tolist() == [True, True, False, True, False, True, True,
                                False]
    np.testing.assert_allclose(np_(tp), np.asarray(wp), atol=1e-4,
                               rtol=1e-4)
    assert np.all(np_(tp)[~np_(tf)] == 0)
    with pytest.raises(ValueError, match="ring capacity"):
        tfn(trb.ring_init(32, (3,)), torch.as_tensor(onsets),
            torch.as_tensor(valid))


def test_classify_hits_flags_stale(stream):
    audio, _ = stream
    t, _ = engines(ring_seconds=0.01)  # 960 samples of history
    tm = CCCNN(input_size=64, **CLS)
    t.attach_classifier(tm, window=64, pre=16, capacity=4)
    for i in range(20):
        t.process_nosync(audio[i * 128:(i + 1) * 128])
    now = 20 * 128
    with pytest.warns(UserWarning, match="fell out"):
        preds = t.classify_hits([(now - 100, None), (now - 2000, None),
                                 (now - 50, None), (now - 300, None),
                                 (now - 900, None)])
    assert preds.shape == (5, 3)
    assert t.last_classify_fresh.tolist() == [True, False, True, True, True]
    assert t.classify_stale == 1 and np.all(preds[1] == 0)


def test_engine_step_reads_nothing_on_the_host(stream):
    """The step that the card captures in a CUDA graph: no host read and
    no value-dependent shape, on a block where every channel fires."""
    audio, hits = stream
    t, _ = engines()
    t.warmup(audio[: SR // 4])
    base = hits[0][0]
    blk = torch.as_tensor(audio[base // 128 * 128 + 256:
                                base // 128 * 128 + 384])
    with NoHostRead():
        for _ in range(3):
            t.state, _ = t._step(t.state, blk, t.params)


def test_engine_counts_plain_calls_on_the_cpu(stream):
    audio, _ = stream
    t, _ = engines()
    _cuda.reset_counts()
    for i in range(4):
        t.process_nosync(audio[i * 128:(i + 1) * 128])
    # the engine's K1 (coupled, 3 channels) is the warp-per-channel kernel
    assert _cuda.DETECTOR_WARP.plain_calls == 4
    assert _cuda.LOCATE_BLOCK.plain_calls == 4
    # the plain ring write runs inside the plain locate step
    assert _cuda.LOCATE_BLOCK.plain_variants["ring_write"] == 4
    assert _cuda.DETECTOR.plain_calls == 0
    assert all(k.launches == 0 for k in _cuda.KERNELS)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    _, polar, _, _ = sim._geometry()
    cfg = DetectorConfig(**KW)
    loc = Multilaterate3D(polar, **LOC)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        te.RealtimeEngine(cfg, loc)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        te.make_engine_step(cfg, loc)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        te.make_classify_fn(CCCNN(input_size=64, **CLS), window=64)
