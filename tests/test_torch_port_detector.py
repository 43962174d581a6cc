"""The port's plain detector (the plain version of kernel K1) against the
JAX scan detector and the Pallas kernel in interpret mode.

Bar: ``on`` and deltas exact, ``rel`` within atol 2e-2 (the JAX suite's own
bound, tests/test_pallas.py:41-46), carried state within float32 noise.
State enters the port through ``models.jax_import``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.core.config import DetectorConfig as JCfg
from onset_fingerprinting_tpu.detect import amplitude as jamp
from onset_fingerprinting_tpu.ops.pallas_detector import make_pallas_detector
from onset_fingerprinting_torch.core.config import DetectorConfig
from onset_fingerprinting_torch.detect import amplitude as tamp
from onset_fingerprinting_torch.models.jax_import import (
    detector_params_from_numpy,
    detector_state_from_numpy,
    detector_state_to_numpy,
)
from onset_fingerprinting_torch.ops import _cuda
from onset_fingerprinting_torch.ops.fused_detector import (
    detector_static,
    fused_detect_offline,
    fused_warmup_minmax,
    kernel_for,
    make_fused_detector,
)


def synth(T, C, seed=0, spacing=1900):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1e-4, (T, C)).astype(np.float32)
    t = np.arange(600)
    burst = np.sin(2 * np.pi * 5000 / 96000 * t) * np.exp(-t / 120) * 0.5
    for k, base in enumerate(range(1500, T - 700, spacing)):
        # per-channel arrival offsets so channels fire in different rows
        for ch in range(C):
            off = base + (k * 7 + ch * 13) % 90
            x[off: off + 600, ch] += burst.astype(np.float32)
    return x


def jax_state_numpy(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def both_from_jax(cfg_kwargs, warm):
    """JAX (static, params, state) warmed on ``warm``, and the port's
    twins with params and state carried across through jax_import."""
    jstatic, jparams, jstate = jamp.detector_init(JCfg(**cfg_kwargs))
    jstate = jamp.warmup_minmax(jstatic, jparams, jstate, jnp.asarray(warm))
    tstatic, _, _ = tamp.detector_init(DetectorConfig(**cfg_kwargs),
                                       device="cpu")
    tparams = detector_params_from_numpy(
        {k: np.asarray(v) for k, v in jparams._asdict().items()}, "cpu")
    tstate = detector_state_from_numpy(jax_state_numpy(jstate), "cpu")
    return (jstatic, jparams, jstate), (tstatic, tparams, tstate)


def assert_state_close(tstate, jstate_np, atol=1e-4):
    got = detector_state_to_numpy(tstate)
    for k, want in jstate_np.items():
        if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got[k], want, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want, atol=atol, rtol=1e-4,
                                       err_msg=k)


CASES = [
    dict(hipass_freq=h, coupled_off_gate=co, backtrack=bt)
    for h in (0.0, 2000.0) for co in (True, False) for bt in (False, True)
]


@pytest.mark.parametrize(
    "opts", CASES,
    ids=[f"hp{int(c['hipass_freq'])}-co{int(c['coupled_off_gate'])}"
         f"-bt{int(c['backtrack'])}" for c in CASES],
)
def test_plain_detector_matches_jax_scan(opts):
    C, T = 3, 128 * 24
    x = synth(T + 128 * 8, C, seed=1)
    kw = dict(n_channels=C, block_size=128, sr=96000,
              backtrack_buffer_size=256, **opts)
    (js, jp, jst), (ts, tp, tst) = both_from_jax(kw, x[: 128 * 8])
    xd = x[128 * 8:]
    jst2, (on_j, d_j, rel_j) = jamp.detect_offline(js, jp, jst,
                                                   jnp.asarray(xd))
    # the wrapper runs the plain version on the CPU and counts it on the
    # kernel a CUDA chunk of this length would take
    kernel = kernel_for(ts, xd.shape[0])
    assert kernel is (_cuda.DETECTOR_PIPE_COUPLED if opts["coupled_off_gate"]
                      else _cuda.DETECTOR_PIPE)
    before = kernel.plain_calls
    tst2, (on_t, d_t, rel_t) = fused_detect_offline(
        detector_static(ts, tp), tp, tst, torch.as_tensor(xd))
    assert kernel.plain_calls == before + 1
    assert np.asarray(on_j).sum() > 0
    np.testing.assert_array_equal(on_t.numpy(), np.asarray(on_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_allclose(rel_t.numpy(), np.asarray(rel_j), atol=2e-2)
    assert_state_close(tst2, jax_state_numpy(jst2))


@pytest.mark.parametrize("hipass", [0.0, 2000.0])
@pytest.mark.parametrize("backtrack", [False, True])
def test_plain_detector_matches_pallas_interpret(hipass, backtrack):
    C, T = 3, 128 * 20
    x = synth(T, C, seed=2)
    kw = dict(n_channels=C, block_size=128, sr=96000, hipass_freq=hipass,
              backtrack=backtrack, backtrack_buffer_size=128)
    jstatic, jparams, jstate, run = make_pallas_detector(
        JCfg(**kw), interpret=True, emit_rel=True)
    jst2, (on_j, d_j, rel_j) = run(jstate, jnp.asarray(x))
    ts, tp, tst = tamp.detector_init(DetectorConfig(**kw), device="cpu")
    tst2, (on_t, d_t, rel_t) = tamp.detect_offline(ts, tp, tst,
                                                   torch.as_tensor(x))
    assert np.asarray(on_j).sum() > 0
    np.testing.assert_array_equal(on_t.numpy(), np.asarray(on_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_allclose(rel_t.numpy(), np.asarray(rel_j), atol=2e-2)
    want = jax_state_numpy(jst2)
    got = detector_state_to_numpy(tst2)
    if backtrack:
        # the Pallas kernel returns the history chronological (pos 0); the
        # port keeps the scan path's ring + cursor
        n = ts.bt_size
        lin = (int(got["bt_pos"]) + np.arange(n)) % n
        np.testing.assert_allclose(got["bt_buffer"][lin], want["bt_buffer"],
                                   atol=2e-2)
    for k in ("zi", "fast", "slow", "min_val", "max_val", "prev_rel"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-4)
    for k in ("gate", "debounce"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("backtrack", [False, True])
def test_two_halves_equal_one_call(backtrack):
    C, T = 2, 128 * 40
    x = torch.as_tensor(synth(T, C, seed=3))
    cfg = DetectorConfig(n_channels=C, hipass_freq=2000.0,
                         backtrack=backtrack, backtrack_buffer_size=128)
    fst, params, st, run = make_fused_detector(cfg, emit_rel=True,
                                               device="cpu")
    st = fused_warmup_minmax(fst, params, st, x[: 128 * 8])
    st_full, (on_full, d_full, rel_full) = run(st, x)
    s1, (on1, d1, r1) = run(st, x[: T // 2])
    s2, (on2, d2, r2) = run(s1, x[T // 2:])
    assert on_full.sum() > 0
    assert torch.equal(torch.cat([on1, on2]), on_full)
    assert torch.equal(torch.cat([d1, d2]), d_full)
    assert torch.equal(torch.cat([r1, r2]), rel_full)
    for a, b in zip(s2, st_full):
        assert torch.equal(a, b)


def test_warmup_minmax_matches_jax():
    C, T = 4, 128 * 12
    x = synth(T, C, seed=4)
    kw = dict(n_channels=C, block_size=128, sr=96000, hipass_freq=2000.0)
    js, jp, jst = jamp.detector_init(JCfg(**kw))
    jw = jamp.warmup_minmax(js, jp, jst, jnp.asarray(x))
    ts, tp, tst = tamp.detector_init(DetectorConfig(**kw), device="cpu")
    fst = detector_static(ts, tp)
    tw = fused_warmup_minmax(fst, tp, tst, torch.as_tensor(x))
    assert_state_close(tw, jax_state_numpy(jw))
    # warmup leaves the event state alone
    for k in ("gate", "prev_rel", "debounce"):
        assert torch.equal(getattr(tw, k), getattr(tst, k))


def test_emit_rel_false_and_manual_thresholds():
    C, T = 3, 128 * 10
    x = synth(T, C, seed=5)
    kw = dict(n_channels=C, on_threshold=3.0, off_threshold=1.0,
              hipass_freq=0.0)
    js, jp, jst = jamp.detector_init(JCfg(**kw))
    _, (on_j, d_j, _) = jamp.detect_offline(js, jp, jst, jnp.asarray(x))
    ts, tp, tst = tamp.detector_init(DetectorConfig(**kw), device="cpu")
    assert ts.manual
    _, (on_t, d_t, rel) = fused_detect_offline(
        detector_static(ts, tp), tp, tst, torch.as_tensor(x), emit_rel=False)
    assert rel is None
    np.testing.assert_array_equal(on_t.numpy(), np.asarray(on_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


def test_chunked_matches_jax_chunked():
    C, T = 3, 128 * 14
    x = synth(T + 50, C, seed=6)  # trailing partial block is dropped
    kw = dict(n_channels=C, hipass_freq=2000.0)
    js, jp, jst = jamp.detector_init(JCfg(**kw))
    _, (on_j, d_j, rel_j) = jamp.detect_offline_chunked(
        js, jp, jst, x, chunk_blocks=5)
    ts, tp, tst = tamp.detector_init(DetectorConfig(**kw), device="cpu")
    _, (on_t, d_t, rel_t) = tamp.detect_offline_chunked(
        ts, tp, tst, x, chunk_blocks=5)
    np.testing.assert_array_equal(on_t, on_j)
    np.testing.assert_array_equal(d_t, d_j)
    np.testing.assert_allclose(rel_t, rel_j, atol=2e-2)


def test_static_matches_jax():
    cfg = dict(n_channels=5, backtrack=True, backtrack_buffer_size=200,
               hipass_freq=1500.0)
    js = jamp._make_static(JCfg(**cfg))
    ts = tamp._make_static(DetectorConfig(**cfg))
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    with pytest.raises(ValueError, match="backtrack_buffer_size"):
        tamp._make_static(DetectorConfig(backtrack=True,
                                         backtrack_buffer_size=64))


def test_iir_apply_matches_jax_and_scipy():
    from scipy import signal

    from onset_fingerprinting_tpu.ops import filters as jf
    from onset_fingerprinting_torch.ops import filters as tf

    x = np.random.default_rng(7).normal(size=(300, 3)).astype(np.float32)
    js = jf.butterworth(2000.0, 3, order=4, sr=96000)
    ts = tf.butterworth(2000.0, 3, order=4, sr=96000, device="cpu")
    np.testing.assert_array_equal(ts.b.numpy(), np.asarray(js.b))
    np.testing.assert_array_equal(ts.a.numpy(), np.asarray(js.a))
    y1, s1 = tf.iir_apply(ts, torch.as_tensor(x[:120]))
    y2, s2 = tf.iir_apply(s1, torch.as_tensor(x[120:]))
    y = torch.cat([y1, y2]).numpy()
    y_one, s_one = tf.iir_apply(ts, torch.as_tensor(x))
    np.testing.assert_array_equal(y, y_one.numpy())
    np.testing.assert_array_equal(s2.zi.numpy(), s_one.zi.numpy())
    # per-op float32 rounding: equal to scipy's float32 lfilter
    want = signal.lfilter(np.asarray(js.b), np.asarray(js.a), x, axis=0)
    assert want.dtype == np.float32
    np.testing.assert_allclose(y, want, atol=1e-6)
    # XLA contracts the DF2T updates into FMAs; the filter's poles near the
    # unit circle amplify that float32 difference to ~6e-4 (both sides stay
    # within 9e-4 of scipy's float64 lfilter)
    yj, sj = jf.iir_apply(js, jnp.asarray(x))
    np.testing.assert_allclose(y, np.asarray(yj), atol=2e-3)
    np.testing.assert_allclose(s2.zi.numpy(), np.asarray(sj.zi), atol=2e-3)


def test_params_round_trip_through_numpy():
    from onset_fingerprinting_torch.models.jax_import import (
        detector_params_to_numpy,
    )

    js, jp, jst = jamp.detector_init(JCfg(n_channels=3, hipass_freq=2000.0))
    arrays = {k: np.asarray(v) for k, v in jp._asdict().items()}
    tp = detector_params_from_numpy(arrays, "cpu")
    back = detector_params_to_numpy(tp)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
    # the port designs the same filter and thresholds itself
    _, own, _ = tamp.detector_init(DetectorConfig(n_channels=3,
                                                  hipass_freq=2000.0),
                                   device="cpu")
    for k, v in detector_params_to_numpy(own).items():
        np.testing.assert_array_equal(v, arrays[k])
