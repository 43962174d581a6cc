"""The realtime engine's step with CC refinement (``cc_refine=True``)
against the JAX package's, on the CPU: the port's ``make_engine_step``
(the locate step's plain version reading the refinement window from the
audio ring) and JAX's ``make_engine_step(cc_refine=True)`` over the same
synthetic drum stream from the same warmed detector.  Bar: every block's
events (on, onsets, emits) and the event queue exactly, points within
1e-4 cm; and the refinement moves the points off the unrefined
engine's."""

import jax.numpy as jnp
import numpy as np
import torch

from onset_fingerprinting_tpu.core.config import (
    DetectorConfig as JDetectorConfig,
)
from onset_fingerprinting_tpu.detect.amplitude import (
    warmup_minmax as j_warmup,
)
from onset_fingerprinting_tpu.locate.multilaterate import (
    Multilaterate3D as JMultilaterate3D,
)
from onset_fingerprinting_tpu.realtime.engine import (
    make_engine_step as j_make_engine_step,
)
from onset_fingerprinting_torch.core.config import DetectorConfig
from onset_fingerprinting_torch.detect.amplitude import warmup_minmax
from onset_fingerprinting_torch.locate.multilaterate import Multilaterate3D
from onset_fingerprinting_torch.realtime.engine import make_engine_step
from onset_fingerprinting_torch.tools import realtime_sim as sim

SECONDS = 0.8


def _engines(cc_refine=True):
    _, polar, _, _ = sim._geometry()
    kw = dict(drum_diameter=sim.DIAM, medium="drumhead", sr=sim.SR,
              feasibility_tols=sim.FEASIBILITY_TOLS)
    cfg = dict(n_channels=3, block_size=128, hipass_freq=0.0, sr=sim.SR)
    j = j_make_engine_step(JDetectorConfig(**cfg), JMultilaterate3D(
        polar, **kw), ring_seconds=1.0, event_queue=64, cc_refine=cc_refine)
    t = make_engine_step(DetectorConfig(**cfg), Multilaterate3D(polar, **kw),
                         ring_seconds=1.0, event_queue=64, cc_refine=True,
                         device="cpu")
    return j, t


def test_cc_refine_engine_matches_jax():
    from onset_fingerprinting_torch.detect.amplitude import detector_init
    from onset_fingerprinting_tpu.detect.amplitude import (
        detector_init as j_detector_init,
    )

    audio, _, hits = sim.synth_stream(SECONDS, seed=2)
    (jstate, jparams, jstep), (tstate, tparams, tstep) = _engines()
    cfg = dict(n_channels=3, block_size=128, hipass_freq=0.0, sr=sim.SR)
    warm = audio[: sim.WARMUP // 128 * 128]
    jst, _, _ = j_detector_init(JDetectorConfig(**cfg))
    tst, _, _ = detector_init(DetectorConfig(**cfg), "cpu")
    jstate = jstate._replace(detector=j_warmup(
        jst, jparams, jstate.detector, jnp.asarray(warm)))
    tstate = tstate._replace(detector=warmup_minmax(
        tst, tparams, tstate.detector, torch.as_tensor(warm)))
    n_on = n_emit = 0
    for blk in sim.blocks_of(audio):
        jstate, jev = jstep(jstate, jnp.asarray(blk), jparams)
        tstate, tev = tstep(tstate, torch.as_tensor(blk), tparams)
        np.testing.assert_array_equal(tev.on.numpy(), np.asarray(jev.on))
        np.testing.assert_array_equal(tev.emits.numpy(),
                                      np.asarray(jev.emits))
        on = np.asarray(jev.on)
        np.testing.assert_array_equal(tev.onsets.numpy()[on],
                                      np.asarray(jev.onsets)[on])
        np.testing.assert_allclose(tev.points.numpy(), np.asarray(jev.points),
                                   atol=1e-4)
        n_on += int(on.sum())
        n_emit += int(np.asarray(jev.emits).sum())
    n = int(jstate.ev_count)
    assert int(tstate.ev_count) == n and n == n_emit >= 2
    np.testing.assert_array_equal(tstate.ev_onsets.numpy()[:n],
                                  np.asarray(jstate.ev_onsets)[:n])
    np.testing.assert_array_equal(tstate.ev_emits.numpy()[:n],
                                  np.asarray(jstate.ev_emits)[:n])
    np.testing.assert_allclose(tstate.ev_points.numpy()[:n],
                               np.asarray(jstate.ev_points)[:n], atol=1e-4)
    assert n_on >= 6
    # the refinement is no no-op on this stream: JAX's unrefined engine
    # locates the same hits elsewhere
    ustate, uparams, ustep = _engines(cc_refine=False)[0]
    ustate = ustate._replace(detector=j_warmup(
        jst, uparams, ustate.detector, jnp.asarray(warm)))
    for blk in sim.blocks_of(audio):
        ustate, _ = ustep(ustate, jnp.asarray(blk), uparams)
    assert int(ustate.ev_count) == n
    assert np.abs(np.asarray(ustate.ev_points)[:n]
                  - tstate.ev_points.numpy()[:n]).max() > 1e-3



def _refine_cases():
    """Refinement pairs over a ring that has wrapped: the window ending
    just after the first strike, each later-arriving channel paired with
    the first at its true arrival and at shifted ones."""
    from onset_fingerprinting_torch.core.ring_buffer import (
        ring_init,
        ring_write,
    )
    from onset_fingerprinting_torch.ops.locate_block import LocateBlock

    audio, _, hits = sim.synth_stream(0.4, seed=3)
    lb = LocateBlock(sim.build_engine("cpu", ring_seconds=0.01).locator, 3,
                     128, cc_refine=True, device="cpu")
    arrive = [hits[0][0] - 10 + int(np.argmax(
        np.abs(audio[hits[0][0] - 10:, ch]) > 1e-2)) for ch in range(3)]
    first = int(np.argmin(arrive))
    end = (max(arrive) + 100 + 127) // 128 * 128
    ring = ring_init(4096, (3,), device="cpu")
    for s in range(0, end, 128):
        ring = ring_write(ring, torch.as_tensor(audio[s: s + 128]))
    start = end - lb.window_len
    cases = [(first, ch, arrive[first] - start, arrive[ch] - start + shift)
             for ch in range(3) if ch != first for shift in (0, 9, -4, 31)]
    return lb, ring, audio[start:end], cases


def test_refine_reference_matches_jax_and_checks_a_log():
    """``refine_reference`` (the locate kernel's refinement check) on a
    wrapped ring against JAX's ``cc_refine_adjust_jax`` on the same
    window: corrections and validity exactly.  ``check_refinements`` takes
    a log equal to the plain refinements with no tie, and rejects one whose
    argmax or validity differs where the CC is no tie."""
    import pytest

    from onset_fingerprinting_torch.ops.locate_block import (
        LOG_FIELDS,
        LOG_W,
        check_refinements,
        refine_reference,
    )
    from onset_fingerprinting_tpu.detect.refine import (
        cc_refine_adjust_jax as j_adjust,
    )

    lb, ring, window, cases = _refine_cases()
    rows, moved = [], 0
    for ch0, ch1, p0, p1 in cases:
        ref = refine_reference(ring, lb.window_len, ch0, ch1, p0, p1)
        j = j_adjust(jnp.asarray(window[:, [ch0, ch1]]), jnp.int32(p0),
                     jnp.int32(p1), lookaround=60, onset_tolerance=50,
                     normalization_cutoff=10)
        assert (ref["c_seed"], ref["c_new"], ref["ok"]) == (
            int(j[0]), int(j[1]), bool(j[2])), (ch0, ch1, p0, p1)
        moved += ref["ok"] and (ref["c_seed"], ref["c_new"]) != (0, 0)
        rows.append([1, 1, ch0, ch1, p0, p1, ref["c_seed"], ref["c_new"],
                     int(ref["ok"]), ref["arg"]])
    assert moved >= 2
    log = torch.tensor(rows, dtype=torch.int32)
    assert log.shape[1] == LOG_W == len(LOG_FIELDS)
    assert check_refinements(lb, log, ring) == (len(rows), [])
    bad = log.clone()
    bad[0, LOG_FIELDS.index("arg")] += 20  # 20 lags from the peak
    with pytest.raises(AssertionError):
        check_refinements(lb, bad, ring)
    bad = log.clone()
    bad[0, LOG_FIELDS.index("ok")] ^= 1
    with pytest.raises(AssertionError):
        check_refinements(lb, bad, ring)


def _seeded_pairs(seed, n_cases=12):
    """Pair windows ``[W, 2]`` of noise with a decaying burst in each
    channel, the second channel's later by a random lag, and window
    positions near the bursts' starts (some off by a few samples, some out
    of the refinement's bounds): ``[(pair, pos0, pos1)]``."""
    from onset_fingerprinting_torch.ops.locate_block import LocateBlock

    w = LocateBlock(sim.build_engine("cpu", ring_seconds=0.01).locator, 3,
                    128, cc_refine=True, device="cpu").window_len
    rng = np.random.default_rng(seed)
    n = np.arange(600)
    cases = []
    for _ in range(n_cases):
        pair = rng.normal(0, rng.uniform(1e-4, 1e-2),
                          (w, 2)).astype(np.float32)
        s0 = int(rng.integers(40, w // 2))
        s1 = s0 + int(rng.integers(0, 45))
        f = rng.uniform(800, 6000)
        for ch, s in enumerate((s0, s1)):
            m = n[: w - s]
            pair[s:, ch] += (np.sin(2 * np.pi * f / 96000 * m + ch)
                             * np.exp(-m / rng.uniform(40, 200))
                             * rng.uniform(0.1, 1.0)).astype(np.float32)
        p0 = s0 + int(rng.integers(-6, 7))
        p1 = s1 + int(rng.integers(-12, 13))
        cases.append((pair, p0, max(p1, p0 + 1)))
    return cases


def test_cc_schedule_matches_jax_refinement():
    """The locate kernel's refinement schedule on the CPU
    (``cc_schedule_reference``: its CC's order of double sums, its first
    argmax, its heuristic) against JAX's ``cc_refine_adjust_jax`` on the
    synthetic drum's pairs and on seeded burst pairs: the same validity,
    and the same corrections except where the plain CC ties (the model's
    argmax within the plain CC's float32 rounding of the plain one's) or
    the heuristic's energies tie (within 1e-5).  The model's CC is within
    that rounding of the plain CC at every lag of the window."""
    from onset_fingerprinting_torch.detect.refine import cc_refine_terms
    from onset_fingerprinting_torch.ops.locate_block import (
        cc_schedule_reference,
        refine_pair_reference,
    )
    from onset_fingerprinting_tpu.detect.refine import (
        cc_refine_adjust_jax as j_adjust,
    )

    _, _, window, drum = _refine_cases()
    pairs = [(window[:, [a, b]], p0, p1) for a, b, p0, p1 in drum]
    for seed in range(3):
        pairs += _seeded_pairs(seed)
    n_ok = moved = 0
    ties = []
    for pair, p0, p1 in pairs:
        t = cc_refine_terms(torch.as_tensor(pair), torch.tensor(p0),
                            torch.tensor(p1))
        got = cc_schedule_reference(t.x.numpy(), t.y.numpy(), p0, p1)
        ref = refine_pair_reference(torch.as_tensor(pair), p0, p1)
        j = j_adjust(jnp.asarray(pair), jnp.int32(p0), jnp.int32(p1),
                     lookaround=60, onset_tolerance=50,
                     normalization_cutoff=10)
        assert got["ok"] == ref["ok"] == bool(j[2]), (p0, p1)
        lo = t.x.shape[0] - (p1 - p0) - 50
        for k, v in enumerate(got["cc"]):
            if np.isfinite(v) and 0 <= lo + k:
                assert abs(v - ref["cc"][lo + k]) <= ref["tie_tol"](
                    lo + k, lo + k), (p0, p1, k)
        if not got["ok"]:
            continue
        n_ok += 1
        want = (int(j[0]), int(j[1]))
        moved += want != (0, 0)
        if (got["c_seed"], got["c_new"]) == want:
            continue
        if got["arg"] != ref["arg"]:
            gap = float(ref["cc"][ref["arg"]] - ref["cc"][got["arg"]])
            assert 0.0 <= gap <= ref["tie_tol"](ref["arg"], got["arg"]), (
                p0, p1, got["arg"], ref["arg"], gap)
        else:
            assert abs(ref["da"] - ref["db"]) <= 1e-5 * max(
                abs(ref["da"]), abs(ref["db"])), (p0, p1)
        ties.append((p0, p1))
    assert n_ok >= 20 and moved >= 10 and len(ties) <= 2, (n_ok, moved,
                                                           ties)
