"""Slice B's locator modules against the JAX package on the same
numpy-seeded inputs: coordinates, ring buffers, lag maps, trilateration,
the median filter, the lag pickers, CC refinement, the host
``Multilaterate3D`` and the fixed-capacity locate step (fuzzed against
JAX's jitted step and against the port's own host locator).

Tolerances: integer results, masks and events exactly; lag maps exactly
(the same float32 operations); Newton points within 1e-3 cm (float32
sums taken in another order); float helpers within 1e-5 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from onset_fingerprinting_tpu.core import coords as jc
from onset_fingerprinting_tpu.core import ring_buffer as jrb
from onset_fingerprinting_tpu.detect import refine as jref
from onset_fingerprinting_tpu.locate import geometry as jgeo
from onset_fingerprinting_tpu.locate import multilaterate as jml
from onset_fingerprinting_tpu.locate import trilateration as jtri
from onset_fingerprinting_tpu.ops import filters as jfilt
from onset_fingerprinting_tpu.ops import xcorr as jx
from onset_fingerprinting_torch.core import coords as tc
from onset_fingerprinting_torch.core import ring_buffer as trb
from onset_fingerprinting_torch.detect import refine as tref
from onset_fingerprinting_torch.locate import geometry as tgeo
from onset_fingerprinting_torch.locate import multilaterate as tml
from onset_fingerprinting_torch.locate import trilateration as ttri
from onset_fingerprinting_torch.ops import filters as tfilt
from onset_fingerprinting_torch.ops import xcorr as tx

SR = 96000
DIAM = 14 * 2.54
POLAR = [(0.9, 0.0, 0.0), (0.9, 120.0, 0.0), (0.9, 240.0, 0.0)]
TOLS = (1.0, 2.0)


def np_(v):
    return np.asarray(v.cpu().numpy() if isinstance(v, torch.Tensor) else v)


class NoHostRead(TorchDispatchMode):
    """Fails on any operator that reads a tensor's value on the host or
    gives an output shape that depends on values: the ops a CUDA graph
    cannot capture."""

    BANNED = ("_local_scalar_dense", "nonzero", "masked_select", "unique",
              "item", "repeat_interleave")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__
        if any(name.startswith(b) for b in self.BANNED):
            raise AssertionError(f"host read in the step: {name}")
        return func(*args, **(kwargs or {}))


# -- coordinates ------------------------------------------------------------

@pytest.mark.parametrize("fn,args", [
    ("cartesian_to_polar", (np.array([3.0, -1.0, 0.5]),
                            np.array([4.0, 2.0, -0.25]))),
    ("polar_to_cartesian", (np.array([2.0, 1.5]), np.array([30.0, 250.0]))),
    ("spherical_to_cartesian", (np.array([10.0, 3.0]), np.array([0.0, 120.0]),
                                np.array([0.0, -20.0]))),
    ("cartesian_to_spherical", (np.array([1.0, -2.0]), np.array([2.0, 0.5]),
                                np.array([0.5, 3.0]))),
    ("cartesian_to_cylindrical", (np.array([1.0, -2.0]),
                                  np.array([2.0, 0.5]), np.array([0.5, 3.0]))),
    ("cylindrical_to_cartesian", (np.array([2.0, 1.0]), np.array([45.0, 300.0]),
                                  np.array([1.0, 2.0]))),
])
def test_coords_match_jax(fn, args):
    f32 = [a.astype(np.float32) for a in args]
    want = getattr(jc, fn)(*[jnp.asarray(a) for a in f32])
    got = getattr(tc, fn)(*[torch.as_tensor(a) for a in f32])
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    for medium in ("air", "drumhead"):
        assert tc.speed_of_sound(100, medium=medium) == jc.speed_of_sound(
            100, medium=medium)


def test_sensor_positions_equal_jax():
    """The engine's geometry: the same float32 sensor positions."""
    radius = DIAM / 2
    for r, phi, th in POLAR:
        want = [float(v) for v in jc.spherical_to_cartesian(r * radius, phi,
                                                             th)]
        got = [float(v) for v in tc.spherical_to_cartesian(r * radius, phi,
                                                           th)]
        assert got == want


# -- ring buffers -----------------------------------------------------------

def test_ring_buffer_wrap_and_reads_match_jax():
    rng = np.random.default_rng(0)
    jr = jrb.ring_init(50, (3,))
    tr = trb.ring_init(50, (3,))
    for b in (20, 37, 128, 5):  # wraps, and a block longer than the ring
        blk = rng.normal(size=(b, 3)).astype(np.float32)
        if b > 50:
            blk = blk[-50:]
        jr = jrb.ring_write(jr, jnp.asarray(blk))
        tr = trb.ring_write(tr, torch.as_tensor(blk))
        assert int(tr.counter) == int(jr.counter)
        np.testing.assert_array_equal(np_(tr.data), np.asarray(jr.data))
        for n in (1, 17, 50):
            np.testing.assert_array_equal(
                np_(trb.ring_read_last(tr, n)),
                np.asarray(jrb.ring_read_last(jr, n)))
        np.testing.assert_array_equal(np_(trb.ring_slice(tr, -30, -4)),
                                      np.asarray(jrb.ring_slice(jr, -30, -4)))
    assert tr.counter.dtype == torch.int32


def test_circular_array_matches_jax():
    rng = np.random.default_rng(1)
    a = trb.CircularArray(np.zeros((40, 2), np.float32))
    b = jrb.CircularArray(np.zeros((40, 2), np.float32))
    for n in (15, 30, 7):
        blk = rng.normal(size=(n, 2)).astype(np.float32)
        a.write(blk)
        b.write(blk)
    for key in (slice(-10, None), slice(-40, -5), -1, -3):
        np.testing.assert_array_equal(a[key], b[key])
    np.testing.assert_array_equal(a.rearrange(), b.rearrange())
    assert a.index_offset(-3) == b.index_offset(-3)
    assert a.elements_since(20) == b.elements_since(20)
    data = np.arange(24.0).reshape(12, 2)
    np.testing.assert_array_equal(
        trb.query_circular(data, slice(-5, -1), 30),
        jrb.query_circular(data, slice(-5, -1), 30))


# -- lag maps ---------------------------------------------------------------

def _mics():
    radius = DIAM / 2
    return [tuple(float(v) for v in jc.spherical_to_cartesian(
        r * radius, phi, th)) for r, phi, th in POLAR]


@pytest.mark.parametrize("scale", [1, 10])
def test_lag_maps_match_jax(scale):
    """Values and the NaN pattern exactly."""
    mics = _mics()
    for a, b in ((0, 1), (2, 0)):
        kw = dict(d=DIAM, sr=SR, scale=scale, medium="drumhead", tol=2)
        want = np.asarray(jgeo.lag_map_3d(mics[a], mics[b], **kw))
        got = np_(tgeo.lag_map_3d(mics[a], mics[b], **kw))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(got, want)
        m2a, m2b = mics[a][:2], mics[b][:2]
        want = np.asarray(jgeo.lag_map_2d(m2a, m2b, d=DIAM, sr=SR,
                                          scale=scale))
        got = np_(tgeo.lag_map_2d(m2a, m2b, d=DIAM, sr=SR, scale=scale))
        np.testing.assert_array_equal(got, want)


def test_intensity_maps_match_jax():
    mics = _mics()
    want = jgeo.lag_intensity_map(mics[0], mics[1], d=DIAM, sr=SR)
    got = tgeo.lag_intensity_map(mics[0], mics[1], d=DIAM, sr=SR)
    np.testing.assert_array_equal(np_(got[0]), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(np_(g), np.asarray(w), rtol=1e-5)
    src = (np.array([1.0, -3.0], np.float32), np.array([2.0, 0.5],
                                                         np.float32), 0.0)
    wa, wt = jgeo.attenuate_intensity(src, jnp.asarray(mics[2]), 0.5, 1.0)
    ga, gt = tgeo.attenuate_intensity(src, mics[2], 0.5, 1.0)
    np.testing.assert_allclose(np_(ga), np.asarray(wa), rtol=1e-5)
    np.testing.assert_allclose(np_(gt), np.asarray(wt), rtol=1e-5)


# -- trilateration ----------------------------------------------------------

def _tdoa_problems(n, seed):
    rng = np.random.default_rng(seed)
    mics = np.asarray(_mics(), np.float32)
    c = jc.speed_of_sound(100, medium="drumhead")
    sensors, deltas, guesses, truth = [], [], [], []
    for _ in range(n):
        order = rng.permutation(3)
        p = rng.uniform(-12, 12, 2).astype(np.float32)
        d = np.hypot(*(p[None] - mics[order, :2]).T)
        lags = np.round((d - d[0]) / c * SR)[1:]
        sensors.append(mics[order])
        deltas.append((lags / SR * c).astype(np.float32))
        guesses.append((p + rng.normal(0, 3, 2)).astype(np.float32))
        truth.append(p)
    return (np.stack(sensors), np.stack(deltas), np.stack(guesses),
            np.stack(truth))


@pytest.mark.parametrize("unroll", [True, False])
def test_solve_tdoa_matches_jax(unroll):
    s, d, g, _ = _tdoa_problems(24, 2)
    for i in range(len(s)):
        wp, wok = jtri.solve_tdoa(jnp.asarray(s[i]), jnp.asarray(d[i]),
                                  jnp.asarray(g[i]), unroll=unroll)
        gp, gok = ttri.solve_tdoa(torch.as_tensor(s[i]),
                                  torch.as_tensor(d[i]),
                                  torch.as_tensor(g[i]), unroll=unroll)
        assert bool(gok) == bool(wok)
        if bool(wok):  # a diverged solve is chaotic: its flag is the result
            np.testing.assert_allclose(np_(gp), np.asarray(wp), atol=1e-3)


def test_trilaterate_batch_matches_jax():
    s, d, g, truth = _tdoa_problems(64, 3)
    wp, wok = jtri.trilaterate_batch(jnp.asarray(s), jnp.asarray(d),
                                     jnp.asarray(g))
    gp, gok = ttri.trilaterate_batch(torch.as_tensor(s), torch.as_tensor(d),
                                     torch.as_tensor(g))
    np.testing.assert_array_equal(np_(gok), np.asarray(wok))
    ok = np.asarray(wok)
    np.testing.assert_allclose(np_(gp)[ok], np.asarray(wp)[ok], atol=1e-3)
    assert ok.mean() > 0.8
    # the host APIs
    mics = _mics()
    c = jc.speed_of_sound(100, medium="drumhead")
    args = (mics[1], mics[2], mics[0], 3.0 / SR * c * 40,
            -2.0 / SR * c * 40, np.array([1.0, 1.0]))
    assert (ttri.solve_trilateration_3d(*args) is None) == (
        jtri.solve_trilateration_3d(*args) is None)
    a2 = (mics[1][:2], mics[2][:2], mics[0][:2], *args[3:])
    w, t = jtri.solve_trilateration(*a2), ttri.solve_trilateration(*a2)
    assert (w is None) == (t is None)
    if w is not None:
        np.testing.assert_allclose(t, w, atol=1e-3)


# -- filters, lag pickers, refinement ---------------------------------------

@pytest.mark.parametrize("size", [3, 4, 5])
def test_median_filter_matches_jax(size):
    x = np.random.default_rng(4).normal(size=(40, 2)).astype(np.float32)
    np.testing.assert_allclose(
        np_(tfilt.median_filter_1d(torch.as_tensor(x), size)),
        np.asarray(jfilt.median_filter_1d(jnp.asarray(x), size)), rtol=1e-6)


def _pair(seed, n=300, shift=23):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=n + shift).astype(np.float32)
    return base[shift:].copy(), base[:n].copy()


def test_lag_pickers_match_jax():
    a, b = _pair(5)
    assert tx.find_lag(a, b) == jx.find_lag(a, b)
    np.testing.assert_array_equal(
        np_(tx.find_lag_jax(torch.as_tensor(a), torch.as_tensor(b))),
        np.asarray(jx.find_lag_jax(jnp.asarray(a), jnp.asarray(b))))
    for t, w in zip(tx.find_lag_multi(a, b), jx.find_lag_multi(a, b)):
        np.testing.assert_allclose(t, w, rtol=1e-4)
    np.testing.assert_allclose(
        np_(tx.full_correlate(torch.as_tensor(a), torch.as_tensor(b))),
        np.asarray(jx.full_correlate(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-3)


@pytest.mark.parametrize("onsets", [(10, 33), (40, 35), (100, 180)])
def test_cross_correlation_lag_matches_jax(onsets):
    a, b = _pair(6)
    for kw in (dict(onsets=onsets), dict(legal_lags=(-30, 30)), dict(),
               dict(onsets=onsets, d=1, take_abs=True)):
        assert tx.cross_correlation_lag(a, b, **kw) == \
            jx.cross_correlation_lag(a, b, **kw)
    for d in (0, 1):
        w = jx.cross_correlation_lag_jax(jnp.asarray(a), jnp.asarray(b),
                                         jnp.array(onsets), d=d)
        g = tx.cross_correlation_lag_jax(torch.as_tensor(a),
                                         torch.as_tensor(b),
                                         torch.tensor(onsets), d=d)
        assert int(g[0]) == int(w[0]) and bool(g[1]) == bool(w[1])
        assert g[0].dtype == torch.int32


def _onset_window(seed, w=400, p0=120, lag=37):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1e-3, (w, 2)).astype(np.float32)
    t = np.arange(200)
    burst = (np.sin(2 * np.pi * 5000 / SR * t) * np.exp(-t / 60)
             ).astype(np.float32)
    x[p0:p0 + 200, 0] += burst
    x[p0 + lag:p0 + lag + 200, 1] += 0.8 * burst[: w - p0 - lag]
    return x


@pytest.mark.parametrize("pos", [(120, 150), (120, 170), (60, 100),
                                 (30, 90)])
def test_cc_refine_matches_jax(pos):
    x = _onset_window(7)
    p0, p1 = pos
    w = jref.cc_refine_lag_jax(jnp.asarray(x), jnp.int32(p0), jnp.int32(p1))
    g = tref.cc_refine_lag_jax(torch.as_tensor(x), torch.tensor(p0),
                               torch.tensor(p1))
    assert (int(g[0]), bool(g[1])) == (int(w[0]), bool(w[1]))
    w = jref.cc_refine_adjust_jax(jnp.asarray(x), jnp.int32(p0),
                                  jnp.int32(p1))
    g = tref.cc_refine_adjust_jax(torch.as_tensor(x), torch.tensor(p0),
                                  torch.tensor(p1))
    assert [int(v) for v in g] == [int(v) for v in w]
    sec = np.abs(np.diff(x, axis=0))
    for lag in (20, 37, 45):
        assert tref.adjust_onset([p0, p1], sec[:, 0], sec[:, 1], lag) == \
            jref.adjust_onset([p0, p1], sec[:, 0], sec[:, 1], lag)
        assert tref.adjust_onset_rel([p0, p1], sec[:, 0], sec[:, 1], lag) == \
            jref.adjust_onset_rel([p0, p1], sec[:, 0], sec[:, 1], lag)


# -- the locators -----------------------------------------------------------

def _locators(tols=TOLS):
    kw = dict(drum_diameter=DIAM, medium="drumhead", sr=SR,
              feasibility_tols=tols)
    return tml.Multilaterate3D(POLAR, **kw), jml.Multilaterate3D(POLAR, **kw)


def test_host_locator_tables_match_jax():
    t, j = _locators()
    assert t.sensor_locs == j.sensor_locs
    assert t.max_max_lags == j.max_max_lags
    for i in range(3):
        for k, lm in j.lag_maps[i].items():
            np.testing.assert_array_equal(t.lag_maps[i][k], lm)
            assert t.min_lags[i][k] == j.min_lags[i][k]
    for a, b in zip(tml.build_locator_tables(t, device="cpu"),
                    jml.build_locator_tables(j)):
        np.testing.assert_array_equal(np_(a), np.asarray(b))
    # the learned locator is ported (test_torch_port_learned_locator); its
    # input modes are checked as JAX checks them
    with pytest.raises(ValueError, match="model_input"):
        tml.Multilaterate3D(POLAR, model_input="nope")
    with pytest.raises(ValueError, match="3 sensors"):
        tml.Multilaterate3D(POLAR + [(0.9, 60.0, 0.0)],
                            model_input="by_channel")
    with pytest.raises(ValueError, match="3 sensors"):
        tml.make_locate_update(tml.Multilaterate3D(
            POLAR + [(0.9, 60.0, 0.0)]), model_input="by_channel",
            device="cpu")


def _strike_events(rng, t, xyz, c):
    """One strike's (onset, channel) events, with the JAX fuzz's garbage
    seeds and out-of-order deliveries (tests/test_locate.py:422)."""
    radius = DIAM / 2
    r = np.sqrt(rng.uniform(0.01, 0.64)) * radius
    ang = rng.uniform(0, 2 * np.pi)
    x, y = r * np.cos(ang), r * np.sin(ang)
    d = [np.hypot(x - sx, y - sy) for (sx, sy, _) in xyz]
    ev = sorted((t + int(round(di / c * SR)), ch) for ch, di in enumerate(d))
    events = list(ev)
    if rng.random() < 0.4:
        gch = int(rng.integers(3))
        events = [(ev[0][0] - int(rng.integers(20, 150)), gch)] + events
    elif rng.random() < 0.5:
        first = events.pop(0)
        events.insert(int(rng.integers(1, 3)), first)
    return events


def _states_equal(t, j):
    for name, a in zip(tml.LocatorState._fields, t):
        np.testing.assert_array_equal(np_(a), np.asarray(getattr(j, name)),
                                      err_msg=name)


@pytest.mark.parametrize("tols,seed", [((1.0,), 7), (TOLS, 8)])
def test_locate_update_fuzz_vs_jax_and_host(tols, seed):
    """Random strikes with garbage onsets and out-of-order deliveries
    through the port's step, JAX's jitted step and the port's host
    locator: the whole state and every emit exactly, points within 1e-3 cm
    of JAX's and 0.1 cm of the host's (the JAX fuzz's bar)."""
    th, jh = _locators(tols)
    tup = tml.make_locate_update(th, device="cpu")
    jup = jml.make_locate_update(jh)
    ts, js = tml.locator_init(8, device="cpu"), jml.locator_init(8)
    c = jc.speed_of_sound(100, medium="drumhead")
    rng = np.random.default_rng(seed)
    t = 20000
    mml = int(max(th.max_max_lags))
    n_emit = 0
    for k in range(50):
        for onset, ch in _strike_events(rng, t, jh.sensor_locs, c):
            res = th.locate(ch, int(onset))
            js, jp, je = jup(js, jnp.int32(ch), jnp.int32(onset))
            ts, tp, te = tup(ts, torch.tensor(ch, dtype=torch.int32),
                             torch.tensor(onset, dtype=torch.int32))
            _states_equal(ts, js)
            assert bool(te) == bool(je) == (res is not None), (k, onset, ch)
            if res is not None:
                n_emit += 1
                np.testing.assert_allclose(np_(tp), np.asarray(jp),
                                           atol=1e-3)
                assert np.hypot(*(np_(tp) - np.asarray(res))) < 0.1
        t += mml * 3 + int(rng.integers(0, 500))
    assert n_emit >= 35


def test_locate_update_cc_refine_matches_jax():
    """``cc_refine=True`` on live audio windows: the same state, emits and
    points as JAX's step."""
    th, jh = _locators()
    tup = tml.make_locate_update(th, cc_refine=True, device="cpu")
    jup = jml.make_locate_update(jh, cc_refine=True)
    wl = tup.window_len
    assert wl == jup.window_len
    ts, js = tml.locator_init(8, device="cpu"), jml.locator_init(8)
    c = jc.speed_of_sound(100, medium="drumhead")
    rng = np.random.default_rng(9)
    t0 = 2000
    audio = rng.normal(0, 1e-4, (t0 + 40 * 3000, 3)).astype(np.float32)
    tt = np.arange(600)
    burst = (np.sin(2 * np.pi * 5000 / SR * tt) * np.exp(-tt / 150) * 0.6
             ).astype(np.float32)
    n_emit = 0
    for k in range(40):
        base = t0 + k * 3000
        events = _strike_events(rng, base, jh.sensor_locs, c)
        for onset, ch in events:
            audio[onset:onset + 600, ch] += burst
        now = max(o for o, _ in events) + 128
        start = now - wl
        win = audio[start:now]
        for onset, ch in events:
            js, jp, je = jup(js, jnp.int32(ch), jnp.int32(onset),
                             jnp.asarray(win), jnp.int32(start))
            ts, tp, te = tup(ts, torch.tensor(ch, dtype=torch.int32),
                             torch.tensor(onset, dtype=torch.int32),
                             torch.as_tensor(win),
                             torch.tensor(start, dtype=torch.int32))
            _states_equal(ts, js)
            assert bool(te) == bool(je)
            if bool(je):
                n_emit += 1
                np.testing.assert_allclose(np_(tp), np.asarray(jp),
                                           atol=1e-3)
    assert n_emit >= 25


def test_locate_update_reads_nothing_on_the_host():
    """The step a CUDA graph captures: no ``.item()``, no data-dependent
    shape, for both forms."""
    th, _ = _locators()
    for cc in (False, True):
        up = tml.make_locate_update(th, cc_refine=cc, device="cpu")
        st = tml.locator_init(8, device="cpu")
        extra = (torch.zeros(up.window_len, 3), torch.tensor(0)) if cc else ()
        with NoHostRead():
            for ch, onset in ((0, 5000), (1, 5030), (2, 5061)):
                st, _, _ = up(st, torch.tensor(ch), torch.tensor(onset),
                              *extra)
