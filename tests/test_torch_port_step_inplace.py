"""The realtime step's in-place contract on the CPU: the plain detector and
the plain locate step given ``out=`` (the input state itself) against
their functional results, the routing of the coupled detector, the ring
write of the locate step (``block=``) in place against the JAX package's,
before the locate step reads the ring, and the in-place engine step
against the JAX engine's step.

Inputs are made with numpy from a seed.  Tolerances: the in-place and
functional runs of one plain version are equal bit for bit (the same
operations on the same inputs); against JAX the engine test's own
(``test_torch_port_engine``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onset_fingerprinting_torch.core.config import DetectorConfig
from onset_fingerprinting_torch.core.ring_buffer import ring_init
from onset_fingerprinting_torch.core.tree import leaves, write_into
from onset_fingerprinting_torch.detect import amplitude as tamp
from onset_fingerprinting_torch.locate.multilaterate import (
    Multilaterate3D,
    locator_init,
)
from onset_fingerprinting_torch.ops import _cuda
from onset_fingerprinting_torch.ops.fused_detector import (
    CTA_SMEM_MAX,
    WARP_MAX_CHANNELS,
    detector_static,
    fused_detect_offline,
    fused_warmup_minmax,
    kernel_for,
    launch_args,
    pipe_plan,
    warp_smem_bytes,
)
from onset_fingerprinting_torch.ops.locate_block import (
    EventQueue,
    LocateBlock,
    locate_block,
    locate_block_reference,
)
from onset_fingerprinting_torch.realtime import engine as te
from onset_fingerprinting_torch.tools import realtime_sim as sim

from test_torch_port_engine import KW, LOC, assert_tree_equal, engines
from test_torch_port_locate import NoHostRead, np_


def _stream(t, c, seed):
    """Noise with decaying bursts at random rows of random channels: quiet
    blocks and fired ones."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1e-4, (t, c)).astype(np.float32)
    burst = (np.sin(2 * np.pi * 5000 / 96000 * np.arange(600))
             * np.exp(-np.arange(600) / 150) * 0.5).astype(np.float32)
    for start in rng.integers(200, t - 700, size=t // 900):
        for ch in rng.choice(c, size=rng.integers(1, c + 1), replace=False):
            s = start + int(rng.integers(0, 60))
            x[s: s + 600, ch] += burst
    return torch.as_tensor(x)


def _equal(a, b):
    return all(torch.equal(u, v) for u, v in zip(a, b, strict=True))


@pytest.mark.parametrize("c,backtrack,hipass", [
    (3, False, 0.0), (4, True, 2000.0), (8, False, 2000.0)])
def test_plain_detector_in_place_equals_functional(c, backtrack, hipass):
    """Block by block over a fuzzed stream: the detector written into its
    own input state (``out=state``) gives the functional run's events and
    state, and its tensors stay the input's."""
    cfg = DetectorConfig(n_channels=c, backtrack=backtrack,
                         backtrack_buffer_size=256, hipass_freq=hipass)
    static, params, state0 = tamp.detector_init(cfg, device="cpu")
    fst = detector_static(static, params)
    x = _stream(128 * 80, c, seed=c)
    warm = fused_warmup_minmax(fst, params, state0, x[: 128 * 20])
    inplace = tamp.DetectorState(*(v.clone() for v in state0))
    got = fused_warmup_minmax(fst, params, inplace, x[: 128 * 20],
                              out=inplace)
    assert got is inplace and _equal(inplace, warm)
    inplace = tamp.DetectorState(*(v.clone() for v in warm))
    ids = [id(v) for v in inplace]
    func = warm
    fired = quiet = 0
    for i in range(20, 80):
        blk = x[128 * i: 128 * (i + 1)]
        func, (on_f, d_f, r_f) = fused_detect_offline(fst, params, func, blk)
        got, (on_i, d_i, r_i) = fused_detect_offline(
            fst, params, inplace, blk, False, out=inplace)
        assert got is inplace and [id(v) for v in got] == ids
        assert r_i is None
        assert torch.equal(on_i, on_f) and torch.equal(d_i, d_f)
        assert _equal(inplace, func), i
        fired += int(on_f.any())
        quiet += int(not on_f.any())
    assert fired >= 5 and quiet >= 5, (fired, quiet)
    # the plain function itself, into another state
    other = tamp.DetectorState(*(torch.empty_like(v) for v in warm))
    blk = x[128 * 20: 128 * 30]
    want, ev = tamp.detect_offline(static, params, warm, blk)
    got, ev2 = tamp.detect_offline(static, params, warm, blk, out=other)
    assert got is other and _equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(ev, ev2))


def _strike_blocks(seed, n_strikes=30):
    """Per-block (on, deltas) of random strikes on the demo's drum, with
    garbage onsets and out-of-order channels, and a quiet block before
    every fired one: ``[(block start, on [3], deltas [3])]``."""
    _, _, xyz, c = sim._geometry()
    rng = np.random.default_rng(seed)
    events = []
    t = 20000
    for _ in range(n_strikes):
        r = np.sqrt(rng.uniform(0.01, 0.64)) * sim.DIAM / 2
        ang = rng.uniform(0, 2 * np.pi)
        x, y = r * np.cos(ang), r * np.sin(ang)
        for ch, (sx, sy, _) in enumerate(xyz):
            events.append((t + int(round(np.hypot(x - sx, y - sy) / c
                                         * sim.SR)), ch))
        if rng.random() < 0.4:
            events.append((t - int(rng.integers(20, 150)),
                           int(rng.integers(3))))
        t += 1500 + int(rng.integers(0, 500))
    blocks = {}
    for onset, ch in sorted(events):
        b = onset // 128
        blocks.setdefault(b - 1, ([False] * 3, [0] * 3))
        on, d = blocks.setdefault(b, ([False] * 3, [0] * 3))
        if not on[ch]:
            on[ch], d[ch] = True, onset - b * 128
    return [(b * 128, on, d) for b, (on, d) in sorted(blocks.items())]


def test_plain_locate_in_place_equals_functional():
    """locate_block (the plain version on the CPU) writing into its own
    inputs (``out=(locator, queue, counter)``) against the functional
    plain version, over quiet and fired blocks: the same state, queue,
    counter and hits, bit for bit, in the input's tensors."""
    _, polar, _, _ = sim._geometry()
    loc = Multilaterate3D(polar, **LOC)
    lb = LocateBlock(loc, 3, 128, device="cpu")

    def queue():
        i32 = dict(dtype=torch.int32)
        return EventQueue(torch.zeros((16, 2)), torch.zeros(16, **i32),
                          torch.zeros(16, **i32), torch.zeros((), **i32))

    lf, qf = locator_init(8, "cpu"), queue()
    li, qi, ci = locator_init(8, "cpu"), queue(), torch.zeros(
        (), dtype=torch.int32)
    ids = [id(v) for v in (*li, *qi, ci)]
    n_emit = n_quiet = 0
    for count, on, d in _strike_blocks(11):
        on_t = torch.tensor(on)
        d_t = torch.tensor(d, dtype=torch.int32)
        c_t = torch.tensor(count, dtype=torch.int32)
        ci.fill_(count)
        lf, qf, hf, cf = locate_block_reference(lb, lf, qf, on_t, d_t, c_t)
        got = locate_block(lb, li, qi, on_t, d_t, ci, out=(li, qi, ci))
        assert [id(v) for v in (*got[0], *got[1], got[3])] == ids
        assert _equal((*li, *qi, ci), (*lf, *qf, cf)), count
        assert int(ci) == count + 128
        assert all(torch.equal(a, b) for a, b in zip(got[2], hf))
        n_emit += int(hf.emits.sum())
        n_quiet += int(not any(on))
    assert n_emit >= 20 and n_quiet >= 20, (n_emit, n_quiet)


@pytest.mark.parametrize("coupled,bsz,c,want", [
    (True, 128, 3, "detector_warp"), (True, 128, WARP_MAX_CHANNELS,
                                      "detector_warp"),
    (True, 128, WARP_MAX_CHANNELS + 1, "detector"),
    (True, 896, 32, "detector_warp"), (True, 912, 32, "detector"),
    (True, 100, 3, "detector"), (False, 128, 3, "detector_pipe")])
def test_coupled_routing_by_channels_and_shared_memory(coupled, bsz, c,
                                                       want):
    """The warp kernel takes the coupled detector while it has a warp per
    channel and two stages of the block fit one CTA's shared memory, at
    block sizes the pipe plans for; detector.cu takes the rest."""
    static, _, _ = tamp.detector_init(
        DetectorConfig(n_channels=c, block_size=bsz,
                       coupled_off_gate=coupled), device="cpu")
    assert kernel_for(static).name == want
    if want == "detector_warp":
        assert warp_smem_bytes(c, bsz) <= CTA_SMEM_MAX
        assert pipe_plan(c, bsz) is not None
    if (c, bsz) == (32, 912):
        assert pipe_plan(c, bsz) is not None
        assert warp_smem_bytes(c, bsz) > CTA_SMEM_MAX


def _ring_step(c, b, cc_refine=False):
    """A locate step of ``c`` channels and ``b``-sample blocks (a locator
    of max(c, 2) sensors on the demo's drum), its empty state and queue,
    and a quiet block's ``(on, deltas)``."""
    loc = Multilaterate3D([(0.9, 360.0 * i / max(c, 2), 0.0)
                           for i in range(max(c, 2))], **LOC)
    lb = LocateBlock(loc, c, b, cc_refine=cc_refine, device="cpu")
    i32 = dict(dtype=torch.int32)
    queue = EventQueue(torch.zeros((4, 2)), torch.zeros(4, **i32),
                       torch.zeros(4, **i32), torch.zeros((), **i32))
    return (lb, locator_init(8, "cpu"), queue,
            torch.zeros(c, dtype=torch.bool), torch.zeros(c, **i32))


def test_launch_args_refuse_what_the_kernels_do_not_take():
    """``out`` must be a state shaped like the input, and the locate
    step's ring write takes a ring of its channels with an int32 counter
    and a block of its block size that fits the ring once, and a block
    only with a ring: each refused before anything is launched or
    written."""
    cfg = DetectorConfig(n_channels=3)
    static, params, state = tamp.detector_init(cfg, device="cpu")
    fst = detector_static(static, params)
    x = torch.zeros((128, 3))
    bad = state._replace(fast=torch.zeros(4))
    with pytest.raises(ValueError, match="out must be"):
        launch_args(fst, params, state, x, False, False, out=bad)
    lb, lstate, queue, on, d = _ring_step(3, 128)
    count = torch.zeros((), dtype=torch.int32)
    calls = (_cuda.LOCATE_BLOCK.plain_calls,
             _cuda.LOCATE_BLOCK.plain_variants["ring_write"])
    for ring, blk, match in (
            (ring_init(100, (3,)), x, "does not fit"),
            (ring_init(256, (3,)), torch.zeros((64, 3)), "the block must be"),
            (ring_init(256, (4,)), x, "the ring must be"),
            (ring_init(256, (3,))._replace(
                counter=torch.zeros((), dtype=torch.int64)), x,
             "counter must be"),
            (None, x, "give ring=")):
        with pytest.raises(ValueError, match=match):
            locate_block(lb, lstate, queue, on, d, count, ring, block=blk)
    assert (_cuda.LOCATE_BLOCK.plain_calls,
            _cuda.LOCATE_BLOCK.plain_variants["ring_write"]) == calls


@pytest.mark.parametrize("cap,b,c,head", [
    (1000, 128, 3, 0), (1000, 128, 3, 950), (300, 300, 1, 299),
    (257, 64, 5, 5000)])
def test_write_block_matches_jax_ring_write(cap, b, c, head):
    """The ring write the engine's step runs (``locate_block(block=)``,
    in place), block by block from a head ``head`` frames along, against
    the JAX package's ``ring_write``: the same data and counter, bit for
    bit, the head wrapping past the ring's end; the ring's tensors stay
    its own; one plain ring write per step."""
    from onset_fingerprinting_tpu.core.ring_buffer import (
        RingBuffer as JRing,
        ring_write as jax_ring_write,
    )

    rng = np.random.default_rng(cap + b + c)
    data0 = rng.normal(size=(cap, c)).astype(np.float32)
    ring = ring_init(cap, (c,))
    ring.data.copy_(torch.as_tensor(data0))
    ring.counter.fill_(head)
    ids = (id(ring.data), id(ring.counter))
    jr = JRing(jnp.asarray(data0), jnp.asarray(head, dtype=jnp.int32))
    lb, lstate, queue, on, d = _ring_step(c, b)
    count = torch.zeros((), dtype=torch.int32)
    calls = _cuda.LOCATE_BLOCK.plain_variants["ring_write"]
    for i in range(7):
        blk = rng.normal(size=(b, c)).astype(np.float32)
        locate_block(lb, lstate, queue, on, d, count, ring,
                     out=(lstate, queue, count), block=torch.as_tensor(blk))
        jr = jax_ring_write(jr, jnp.asarray(blk))
        assert (id(ring.data), id(ring.counter)) == ids
        np.testing.assert_array_equal(ring.data.numpy(),
                                      np.asarray(jr.data), err_msg=str(i))
        assert int(ring.counter) == int(jr.counter) == head + (i + 1) * b
    assert _cuda.LOCATE_BLOCK.plain_variants["ring_write"] == calls + 7


@pytest.mark.parametrize("cap,b,c,head", [
    (6000, 128, 3, 5950), (300, 300, 1, 299), (257, 64, 5, 2 ** 31 - 100),
    (700, 128, 3, 0)])
def test_step_writes_the_ring_then_locates_as_jax(cap, b, c, head,
                                                  monkeypatch):
    """The locate step with the block (the engine's call, ``cc_refine``
    on) runs the ring write, then the locate step over the written ring:
    at the plain locate step's call the ring's counter has advanced and
    its last ``window_len`` frames (what the refinement reads) equal the
    JAX package's ``ring_read_last`` after its ``ring_write``, bit for bit,
    the head wrapping and the int32 counter passing its largest value."""
    from onset_fingerprinting_torch.core.ring_buffer import ring_read_last
    from onset_fingerprinting_torch.ops import locate_block as tlb
    from onset_fingerprinting_tpu.core.ring_buffer import (
        RingBuffer as JRing,
        ring_read_last as jax_ring_read_last,
        ring_write as jax_ring_write,
    )

    rng = np.random.default_rng(cap + b + c + 1)
    data0 = rng.normal(size=(cap, c)).astype(np.float32)
    ring = ring_init(cap, (c,))
    ring.data.copy_(torch.as_tensor(data0))
    ring.counter.fill_(head)
    jr = JRing(jnp.asarray(data0), jnp.asarray(head, dtype=jnp.int32))
    lb, lstate, queue, on, d = _ring_step(c, b, cc_refine=True)
    win = min(lb.window_len, cap)
    seen = []
    plain = tlb.locate_block_reference

    def spy(lb_, lstate_, queue_, on_, d_, count_, ring_, out_):
        seen.append((int(ring_.counter), ring_read_last(ring_, win).clone()))
        return plain(lb_, lstate_, queue_, on_, d_, count_, ring_, out_)

    monkeypatch.setattr(tlb, "locate_block_reference", spy)
    count = torch.zeros((), dtype=torch.int32)
    for i in range(4):
        blk = rng.normal(size=(b, c)).astype(np.float32)
        locate_block(lb, lstate, queue, on, d, count, ring,
                     out=(lstate, queue, count), block=torch.as_tensor(blk))
        jr = jax_ring_write(jr, jnp.asarray(blk))
        got_count, window = seen[-1]
        assert got_count == int(jr.counter) == int(np.int32(
            np.int64(head) + (i + 1) * b - 2 ** 32 * (
                head + (i + 1) * b >= 2 ** 31)))
        np.testing.assert_array_equal(
            window.numpy(), np.asarray(jax_ring_read_last(jr, win)),
            err_msg=str(i))
        np.testing.assert_array_equal(ring.data.numpy(),
                                      np.asarray(jr.data), err_msg=str(i))
    assert len(seen) == 4 and int(count) == 4 * b


def test_write_into_skips_shared_leaves():
    a = (torch.zeros(3), (torch.ones(2), torch.zeros(())))
    b = (torch.arange(3.0), (a[1][0], torch.tensor(5.0)))
    out = write_into(a, b)
    assert out is a and torch.equal(a[0], b[0]) and float(a[1][1]) == 5.0
    with pytest.raises(ValueError):
        write_into((torch.zeros(1),), (torch.zeros(1), torch.zeros(1)))


@pytest.fixture(scope="module")
def stream():
    audio, _, hits = sim.synth_stream(0.57, seed=3)
    return audio, hits


def test_in_place_engine_step_matches_jax(stream):
    """The step in place (every state tensor written where it lies, as the
    card's captured graph needs) on the CPU, block by block against the
    JAX engine's step: the same events, the same final state, and the
    state's tensors never replaced; no host read inside the step."""
    audio, hits = stream
    _, polar, _, _ = sim._geometry()
    state, params, step = te.make_engine_step(
        DetectorConfig(**KW), Multilaterate3D(polar, **LOC),
        ring_seconds=0.5, device="cpu")
    _, j = engines()
    warm = sim.SR // 4
    static, _, _ = tamp.detector_init(DetectorConfig(**KW), device="cpu")
    fused_warmup_minmax(detector_static(static, params), params,
                        state.detector,
                        torch.as_tensor(audio[: warm // 128 * 128]),
                        out=state.detector)
    j.warmup(audio[:warm])
    ids = [id(v) for v in leaves(state)]
    n_emit = 0
    for i in range(warm // 128, len(audio) // 128):
        blk = torch.as_tensor(audio[i * 128:(i + 1) * 128])
        with NoHostRead():
            new, tev = step(state, blk, params)
        assert [id(v) for v in leaves(new)] == ids
        j.state, jev = j._step(j.state, jnp.asarray(blk.numpy()), j.params)
        for name in ("on", "onsets", "emits"):
            np.testing.assert_array_equal(
                np_(getattr(tev, name)), np.asarray(getattr(jev, name)),
                err_msg=f"block {i} {name}")
        np.testing.assert_allclose(np_(tev.points), np.asarray(jev.points),
                                   atol=1e-3)
        n_emit += int(np_(tev.emits).sum())
    assert n_emit == len(hits) == 2
    assert_tree_equal(state, j.state, "state")
    np.testing.assert_array_equal(np_(state.ring.data),
                                  np.asarray(j.state.ring.data))


@pytest.mark.parametrize("source,steps", [
    ("detector_warp.cu", "K1_STEPS"), ("locate_block.cu", "LOCATE_STEPS"),
    ("locate_block.cu", "REFINE_STEPS")])
def test_step_split_variants_apply_to_the_sources(source, steps):
    """tools/step_split.py cuts the kernels at anchors in their sources:
    each anchor is there exactly once, and each cut changes the source."""
    from onset_fingerprinting_torch.tools import step_split

    src = (_cuda.CSRC / source).read_text()
    for name, old, new in getattr(step_split, steps):
        assert src.count(old) == 1, name
        assert src.replace(old, new) != src, name
