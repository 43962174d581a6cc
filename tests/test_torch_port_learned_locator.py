"""The learned locator (``model=FCNNBundle``) against the JAX package on the
same numpy-seeded inputs: the host ``Multilaterate3D.locate`` and the
fixed-capacity ``make_locate_update`` in both ``model_input`` modes (fuzzed
onset streams against JAX's host locator and jitted step), the engine's
plain step with a model against JAX's, the folded and packed FCNN buffer
of the locate kernel (evaluated on the CPU in the kernel's order of
rounding) against ``FCNN.eval()``, and the kernel's plan.

The FCNN weights are flax's, perturbed off their init and carried across
with ``models.jax_import``; the layers are scaled so that sample lags map
to points of a few cm, as a trained locator's do.  Tolerances: locator
states, emits and events exactly; points within 1e-3 cm (float32 sums in
another order); the packed FCNN within 1e-5 relative of ``FCNN.eval()``
(BatchNorm folded in float64, rounded once)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_tpu.core import coords as jc
from onset_fingerprinting_tpu.locate import multilaterate as jml
from onset_fingerprinting_tpu.models.fcnn import FCNN as JFCNN
from onset_fingerprinting_tpu.models.fcnn import FCNNBundle as JBundle
from onset_fingerprinting_torch.locate import multilaterate as tml
from onset_fingerprinting_torch.models.fcnn import FCNN, FCNNBundle
from onset_fingerprinting_torch.models.jax_import import (
    fcnn_state_dict_from_flax,
)
from onset_fingerprinting_torch.ops import locate_block as tlb

SR = 96000
DIAM = 14 * 2.54
POLAR = [(0.9, 0.0, 0.0), (0.9, 120.0, 0.0), (0.9, 240.0, 0.0)]
MODES = ("arrival", "by_channel")


def np_(v):
    return np.asarray(v.cpu().numpy() if isinstance(v, torch.Tensor) else v)


def make_models(seed=0, **cfg):
    """(JAX bundle, port bundle) of one FCNN: flax's init, every leaf
    perturbed, the first Dense scaled by 1/50 (lags of tens of samples) and
    the last by 1/20 (points of a few cm)."""
    cfg = {"hidden_layers": (10, 10, 10), **cfg}
    jm = JFCNN(**cfg)
    v = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 2))))
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(
        lambda a: np.abs(a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        if a.ndim == 1 else (a + rng.normal(0, 0.05, a.shape)).astype(
            np.float32), v)
    dense = sorted(k for k in v["params"] if k.startswith("Dense_"))
    v["params"][dense[0]]["kernel"] = v["params"][dense[0]]["kernel"] / 50
    v["params"][dense[-1]]["kernel"] = v["params"][dense[-1]]["kernel"] / 20
    tm = FCNN(2, **cfg)
    tm.load_state_dict(fcnn_state_dict_from_flax(v))
    return JBundle(jm, v), FCNNBundle(tm)


def _locators(mode, jb, tb, tols=(1.0,)):
    kw = dict(drum_diameter=DIAM, medium="drumhead", sr=SR,
              feasibility_tols=tols, model_input=mode)
    return (tml.Multilaterate3D(POLAR, model=tb, **kw),
            jml.Multilaterate3D(POLAR, model=jb, **kw))


def _strike_events(rng, t, xyz, c):
    """One strike's (onset, channel) events, with garbage seeds and
    out-of-order deliveries (the JAX fuzz's, tests/test_locate.py:422)."""
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


@pytest.mark.parametrize("mode", MODES)
def test_host_locator_with_model_matches_jax(mode):
    """``Multilaterate3D.locate`` with an FCNN: the same completions as
    JAX's host locator, points within 1e-3 cm."""
    jb, tb = make_models(1)
    th, jh = _locators(mode, jb, tb)
    c = jc.speed_of_sound(100, medium="drumhead")
    rng = np.random.default_rng(3)
    t, n_emit = 20000, 0
    mml = int(max(th.max_max_lags))
    for _ in range(30):
        for onset, ch in _strike_events(rng, t, jh.sensor_locs, c):
            rt = th.locate(ch, int(onset))
            rj = jh.locate(ch, int(onset))
            assert (rt is None) == (rj is None)
            if rt is not None:
                n_emit += 1
                np.testing.assert_allclose(np.asarray(rt), np.asarray(rj),
                                           atol=1e-3)
        assert [(list(g[0]), list(g[1])) for g in th.ongoing] == \
            [(list(g[0]), list(g[1])) for g in jh.ongoing]
        t += mml * 3 + int(rng.integers(0, 500))
    assert n_emit >= 20


@pytest.mark.parametrize("mode,tols,seed", [
    ("arrival", (1.0,), 7), ("by_channel", (1.0, 2.0), 8)])
def test_locate_update_with_model_matches_jax(mode, tols, seed):
    """The fixed-capacity step with an FCNN against JAX's jitted step and
    the port's host locator: the whole state and every emit exactly,
    points within 1e-3 cm of JAX's and of the host's."""
    jb, tb = make_models(seed)
    th, jh = _locators(mode, jb, tb, tols)
    tup = tml.make_locate_update(th, model=tb, model_input=mode,
                                 device="cpu")
    jup = jml.make_locate_update(jh, model=jb, model_input=mode)
    ts, js = tml.locator_init(8, device="cpu"), jml.locator_init(8)
    c = jc.speed_of_sound(100, medium="drumhead")
    rng = np.random.default_rng(seed)
    t, n_emit = 20000, 0
    mml = int(max(th.max_max_lags))
    for k in range(40):
        for onset, ch in _strike_events(rng, t, jh.sensor_locs, c):
            res = th.locate(ch, int(onset))
            js, jp, je = jup(js, jnp.int32(ch), jnp.int32(onset))
            ts, tp, te = tup(ts, torch.tensor(ch, dtype=torch.int32),
                             torch.tensor(onset, dtype=torch.int32))
            for name, a in zip(tml.LocatorState._fields, ts):
                np.testing.assert_array_equal(
                    np_(a), np.asarray(getattr(js, name)), err_msg=name)
            assert bool(te) == bool(je) == (res is not None), (k, onset)
            if bool(te):
                n_emit += 1
                np.testing.assert_allclose(np_(tp), np.asarray(jp),
                                           atol=1e-3)
                np.testing.assert_allclose(np_(tp), np.asarray(res),
                                           atol=1e-3)
        t += mml * 3 + int(rng.integers(0, 500))
    assert n_emit >= 25


@pytest.mark.parametrize("mode,hidden", [
    pytest.param("arrival", (10, 10, 10), id="arrival"),
    pytest.param("by_channel", (10, 10, 10), id="by_channel"),
    # past the old kernel plan's 64 units and 8 hidden layers
    pytest.param("arrival", (128, 128), id="arrival-wide"),
    pytest.param("by_channel", (16,) * 12, id="by_channel-deep"),
])
def test_locate_block_reference_with_model_matches_jax_engine(mode, hidden):
    """The engine's plain step with an FCNN (``ops/locate_block``'s plain
    version behind the plain detector) against JAX's engine step over a
    stream of strikes: events exactly, points within 1e-3 cm; also for a
    wide and a deep FCNN, which the kernel's plan takes too."""
    from onset_fingerprinting_tpu.core.config import DetectorConfig as JCfg
    from onset_fingerprinting_tpu.realtime.engine import (
        make_engine_step as jmake,
    )
    from onset_fingerprinting_torch.core.config import DetectorConfig
    from onset_fingerprinting_torch.realtime.engine import make_engine_step

    jb, tb = make_models(4, hidden_layers=hidden)
    th, jh = _locators(mode, jb, tb)
    tlb.fcnn_plan(tb.model)  # the kernel's plan takes it
    kw = dict(n_channels=3, block_size=128, hipass_freq=0.0, sr=SR)
    tstate, tparams, tstep = make_engine_step(
        DetectorConfig(**kw), th, model=tb, model_input=mode, device="cpu")
    jstate, jparams, jstep = jmake(JCfg(**kw), jh, model=jb,
                                   model_input=mode, use_pallas=False)
    c = jc.speed_of_sound(100, medium="drumhead")
    rng = np.random.default_rng(5)
    n = 128 * 150
    audio = rng.normal(0, 1e-4, (n, 3)).astype(np.float32)
    tt = np.arange(600)
    burst = (np.sin(2 * np.pi * 5000 / SR * tt) * np.exp(-tt / 150)
             * 0.6).astype(np.float32)
    for base in (3000, 9000, 15000):
        for onset, ch in _strike_events(rng, base, jh.sensor_locs, c)[-3:]:
            audio[onset:onset + 600, ch] += burst[: n - onset]
    for i in range(n // 128):
        blk = audio[i * 128:(i + 1) * 128]
        tstate, tev = tstep(tstate, torch.as_tensor(blk), tparams)
        jstate, jev = jstep(jstate, jnp.asarray(blk), jparams)
        np.testing.assert_array_equal(np_(tev.on), np.asarray(jev.on))
        np.testing.assert_array_equal(np_(tev.emits), np.asarray(jev.emits))
    k = int(tstate.ev_count)
    assert k == int(jstate.ev_count) >= 2
    np.testing.assert_array_equal(np_(tstate.ev_onsets)[:k],
                                  np.asarray(jstate.ev_onsets)[:k])
    np.testing.assert_allclose(np_(tstate.ev_points)[:k],
                               np.asarray(jstate.ev_points)[:k], atol=1e-3)


FCNN_CASES = [
    dict(hidden_layers=(10, 10, 10)),
    dict(hidden_layers=(32, 32)),
    dict(hidden_layers=(64,), activation="tanh"),
    dict(hidden_layers=(40, 33), activation="silu", batch_norm=False),
    dict(hidden_layers=(8,) * 8, activation="elu"),
    dict(hidden_layers=(12, 12), activation="leakyrelu", bias=False),
    dict(hidden_layers=(16,), activation="sigmoid"),
]


@pytest.mark.parametrize("cfg", FCNN_CASES, ids=str)
def test_packed_fcnn_matches_eval(cfg):
    """The locate kernel's FCNN buffer (BatchNorm folded, layers packed)
    evaluated in the kernel's order against ``FCNN.eval()``."""
    _, tb = make_models(2, **cfg)
    plan, packed = tlb.pack_fcnn(tb.model)
    assert plan.widths == (2, *cfg["hidden_layers"], 2)
    assert packed.dtype == torch.float32 and packed.numel() == sum(
        (a + 1) * b for a, b in zip(plan.widths[:-1], plan.widths[1:]))
    x = torch.as_tensor(np.random.default_rng(0).uniform(
        -120, 120, (64, 2)).astype(np.float32))
    got = tlb.fcnn_packed_reference(plan, packed, x)
    want = tb(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_fcnn_plan_bounds():
    """What the kernel takes: 2 lag features in, a point out, any depth,
    and any width whose two activation vectors fit the launch's shared
    memory beside the CC refinement's sections; anything else raises,
    naming the bytes where the width is at fault."""
    for hidden in ((64,) * 8, (65,), (8,) * 9, (128, 128), (16,) * 12):
        plan = tlb.fcnn_plan(FCNN(2, hidden_layers=hidden))
        assert plan.widths == (2, *hidden, 2)
        words = [len(hidden) + 1, 2, *hidden, 2]
        head = plan.header().tolist()
        assert head[:len(words)] == words and len(head) >= tlb.FW_LANES
        assert not any(head[len(words):])
        assert plan.smem == 8 * max(hidden)
    room = tlb.SMEM_OPTIN - tlb.STATIC_SMEM
    widest = room // 8
    assert tlb.fcnn_plan(FCNN(2, hidden_layers=(widest,))).smem <= room
    for bad, used, match in (
            (FCNN(2, hidden_layers=(widest + 1,)), 0,
             f"{8 * (widest + 1)} bytes, past the launch's {room} bytes"),
            # the refinement's two sections of 640 doubles take 10240
            (FCNN(2, hidden_layers=(widest - 1000,)), 10240,
             f"past the launch's {room - 10240} bytes"),
            (FCNN(3, hidden_layers=(8,)), 0, "2 lag features"),
            (FCNN(2, hidden_layers=(8,), output_size=3), 0,
             "2 lag features")):
        with pytest.raises(ValueError, match=match):
            tlb.fcnn_plan(bad, used)


def test_locate_block_on_the_cpu_takes_any_fcnn():
    """On the CPU the plain version runs, so an FCNN outside the kernel's
    plan (here: wider than its shared memory) builds (and would raise on
    the card: the hermetic test)."""
    tb = FCNNBundle(FCNN(2, hidden_layers=(30000,)))
    jb, _ = make_models(0)
    th, _ = _locators("arrival", jb, tb)
    lb = tlb.LocateBlock(th, 3, 128, model=tb, device="cpu")
    assert lb.fcnn is None
    with pytest.raises(ValueError, match="30000 units"):
        lb.check_kernel_shape()
