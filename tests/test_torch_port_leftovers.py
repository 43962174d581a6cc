"""The port's leftover ops and locators against the JAX package's, on the
CPU: ``ema_smooth``, ``sliding_mean``, ``binary_opening_1d`` (exactly),
the envelope followers (``ops/envelope.py``), ``batch_cross_correlate_dft``
and the streaming CC, and the 2D and neighbour-pair locators
(``Multilaterate``, ``MultilateratePaired``) on a synthetic onset stream.
Bar: within 1e-5 of the result's scale; locations within 1e-4 (cm and
radius fractions, degrees within 1e-2)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.locate import multilaterate as JM
from onset_fingerprinting_tpu.ops import envelope as JE
from onset_fingerprinting_tpu.ops import filters as JF
from onset_fingerprinting_torch.locate import multilaterate as PM
from onset_fingerprinting_torch.ops import envelope as PE
from onset_fingerprinting_torch.ops import filters as PF

# both packages' ops/__init__ may shadow module names with functions
JX = importlib.import_module("onset_fingerprinting_tpu.ops.xcorr")
PX = importlib.import_module("onset_fingerprinting_torch.ops.xcorr")


def close(port, ref, rel=1e-5):
    port = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() <= rel * max(np.abs(ref).max(), 1e-30)


def sig(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def test_filters_leftovers():
    x = sig((200, 3))
    y0 = sig(3, seed=1)
    close(PF.ema_smooth(torch.tensor(x), 0.07, torch.tensor(y0)),
          JF.ema_smooth(jnp.asarray(x), 0.07, jnp.asarray(y0)))
    for size in (1, 4, 7):
        np.testing.assert_array_equal(
            PF._sliding_windows(torch.tensor(x), size).numpy(),
            np.asarray(JF._sliding_windows(jnp.asarray(x), size)))
        close(PF.sliding_mean(torch.tensor(x), size),
              JF.sliding_mean(jnp.asarray(x), size))
    b = np.random.default_rng(2).random(300) < 0.7
    for size in (1, 3, 4, 9):
        np.testing.assert_array_equal(
            PF.binary_opening_1d(torch.tensor(b), size).numpy(),
            np.asarray(JF.binary_opening_1d(jnp.asarray(b), size)))


def test_envelopes():
    x = np.abs(sig((300, 4), seed=3))
    x[100:110] += 20.0
    y0 = np.zeros(4, np.float32)
    env = PE.ar_envelope(torch.tensor(x), torch.tensor(y0), 1 / 3, 1 / 383)
    close(env, JE.ar_envelope(jnp.asarray(x), jnp.asarray(y0), 1 / 3,
                              1 / 383))
    ys, last = PE.ar_envelope_block(torch.tensor(x), torch.tensor(y0), 0.5,
                                    0.01)
    jys, jlast = JE.ar_envelope_block(jnp.asarray(x), jnp.asarray(y0), 0.5,
                                      0.01)
    close(ys, jys)
    close(last, jlast)
    st = PE.minmax_init(4, device="cpu")
    jst = JE.minmax_init(4)
    close(st.min_val, jst.min_val)
    close(st.max_val, jst.max_val)
    for kw in (dict(), dict(alpha_min=1e-2, alpha_max=1e-3, minmin=0.5)):
        out = PE.minmax_envelope(torch.tensor(x), st, **kw)
        ref = JE.minmax_envelope(jnp.asarray(x), jst, **kw)
        close(out.min_val, ref.min_val)
        close(out.max_val, ref.max_val)


@pytest.mark.parametrize("sum_axis", [None, 1])
def test_batch_cross_correlate_dft(sum_axis):
    a, b = sig((3, 4, 50), seed=4), sig((3, 4, 50), seed=5)
    out = PX.batch_cross_correlate_dft(torch.tensor(a), torch.tensor(b),
                                       sum_axis=sum_axis)
    close(out, JX.batch_cross_correlate_dft(jnp.asarray(a), jnp.asarray(b),
                                            sum_axis=sum_axis))
    full = PX.batch_full_correlate(torch.tensor(a), torch.tensor(b))
    close(out, full if sum_axis is None else full.sum(dim=1), rel=1e-4)


def test_streaming_cc():
    blocks_a, blocks_b = sig((6, 2, 16), seed=6), sig((6, 2, 16), seed=7)
    st = PX.streaming_cc_init(64, (2,), device="cpu")
    jst = JX.streaming_cc_init(64, (2,))
    st, ccs = PX.streaming_cc_scan(st, torch.tensor(blocks_a),
                                   torch.tensor(blocks_b))
    jst, jccs = JX.streaming_cc_scan(jst, jnp.asarray(blocks_a),
                                     jnp.asarray(blocks_b))
    close(ccs, jccs)
    close(st.buf_a, jst.buf_a)
    st2, cc = PX.streaming_cc_update(st, torch.tensor(blocks_a[0]),
                                     torch.tensor(blocks_b[0]))
    jst2, jcc = JX.streaming_cc_update(jst, jnp.asarray(blocks_a[0]),
                                       jnp.asarray(blocks_b[0]))
    close(cc, jcc)
    close(st2.buf_b, jst2.buf_b)


SENSORS = [(0.9, 0.0), (0.9, 120.0), (0.9, 240.0)]
SR = 96000


def onset_stream(n_hits=8, seed=0):
    """Each strike's arrivals at the three 2D sensors (cm geometry, the
    drumhead's speed), events in time order: ``[(sensor, onset)]``."""
    from onset_fingerprinting_torch.core.coords import (
        DIAMETER,
        polar_to_cartesian,
        speed_of_sound,
    )

    rng = np.random.default_rng(seed)
    radius = DIAMETER / 2
    locs = [tuple(float(v) for v in polar_to_cartesian(r * radius, p))
            for r, p in SENSORS]
    c = speed_of_sound(100, medium="drumhead")
    events = []
    for h in range(n_hits):
        r, phi = rng.uniform(0.1, 0.8), rng.uniform(0, 360)
        x, y = (float(v) for v in polar_to_cartesian(r * radius, phi))
        t0 = 5000 + 20000 * h
        arr = [t0 + int(round(np.hypot(x - sx, y - sy) / c * SR))
               for sx, sy in locs]
        events += sorted(((a, s) for s, a in enumerate(arr)))
    return [(s, a) for a, s in events]


def test_multilaterate_2d():
    port = PM.Multilaterate(SENSORS, sr=SR)
    ref = JM.Multilaterate(SENSORS, sr=SR)
    found = 0
    for s, onset in onset_stream():
        a, b = port.locate(s, onset), ref.locate(s, onset)
        assert (a is None) == (b is None)
        if a is not None:
            found += 1
            assert a[0] == pytest.approx(b[0], abs=1e-4)
            assert a[1] == pytest.approx(b[1], abs=1e-2)
    assert found >= 6


def test_multilaterate_paired():
    port = PM.MultilateratePaired(SENSORS, sr=SR)
    ref = JM.MultilateratePaired(SENSORS, sr=SR)
    for i, m in enumerate(port.lag_maps):
        for j in m:
            np.testing.assert_array_equal(m[j], np.asarray(ref.lag_maps[i][j]))
    for lags, i in (([10, -25], 0), ([40, 12], 1), ([-5, -30], 2)):
        a, b = port.locate(lags, i), ref.locate(lags, i)
        assert (a is None) == (b is None)
        if a is not None:
            assert a[0] == pytest.approx(b[0], abs=1e-4)
            assert a[1] == pytest.approx(b[1], abs=1e-2)
    x = sig((2000, 3), seed=8)
    x[1000:1100] += np.hanning(100)[:, None] * 5
    for i in range(3):
        assert port.locate_cc(x, 990, i) == pytest.approx(
            ref.locate_cc(x, 990, i), abs=1e-4)
