"""The pipelined detector kernel (``csrc/detector_pipe.cu``), emulated on
the CPU: its launch plan, its routing, and the hand-off of sub-blocks
between its three warps.

The emulation runs the kernel's three warps as Python generators over
rings shaped like the kernel's (``[slots, SB rows, channels]``), with its
slot and parity arithmetic, ``mbarrier`` semantics (a wait on parity p
passes once the phase of that parity has completed) and ``cp.async``
groups that land only at ``wait_group``.  A scheduler interleaves the
warps in several orders; every slot is filled with NaN when its consumer
releases it, and x rows read before their group landed are NaN too, so a
read after release, or before arrival, shows in the result.  Each warp
runs the plain detector's own stage functions (``detect.amplitude``), so
the result must equal ``detect_offline`` / ``warmup_minmax`` bit for bit.
Idle lanes of a ragged last CTA store nothing and are not modelled.
"""

import random

import numpy as np
import pytest
import torch

from onset_fingerprinting_torch.core.config import DetectorConfig
from onset_fingerprinting_torch.detect import amplitude as tamp
from onset_fingerprinting_torch.ops import _cuda
from onset_fingerprinting_torch.ops.fused_detector import (
    CTA_SMEM_MAX,
    PIPE_DB_SLOTS,
    PIPE_SUB_ROWS,
    PIPE_X_SLOTS,
    SMS,
    detector_static,
    fused_detect_offline,
    fused_warmup_minmax,
    kernel_for,
    pipe_plan,
)

SB, NX, ND = PIPE_SUB_ROWS, PIPE_X_SLOTS, PIPE_DB_SLOTS


def synth(t, c, seed):
    """Low noise with decaying 5 kHz bursts, per-channel offsets."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1e-4, (t, c)).astype(np.float32)
    n = np.arange(600)
    burst = (np.sin(2 * np.pi * 5000 / 96000 * n) * np.exp(-n / 120) * 0.5
             ).astype(np.float32)
    for k, base in enumerate(range(400, t - 700, 1200)):
        for ch in range(c):
            off = base + (k * 7 + ch * 13) % 90
            x[off: off + 600, ch] += burst
    return torch.as_tensor(x)


# ---- the plan ----

@pytest.mark.parametrize("c", [32768, 32748, 1000, 37])
def test_plan_fits_one_cta_and_one_wave(c):
    plan = pipe_plan(c, 128)
    assert plan.channels_per_cta == 32 and plan.threads == 96
    assert plan.roles == ("iir_db", "envelopes_rel", "minmax_events")
    assert (plan.sub_rows, plan.x_slots, plan.db_slots, plan.rel_slots) == (
        16, 3, 2, 8)
    # barriers (2 per dB slot, 2 per rel slot, 16-byte aligned) + rings
    assert plan.smem_bytes == 160 + (3 + 2 + 8) * 16 * 32 * 4 == 26784
    assert plan.smem_bytes <= CTA_SMEM_MAX
    assert plan.ctas == -(-c // 32)
    # shared memory, threads and 80 registers a thread all allow 8
    assert plan.ctas_per_sm == 8
    assert plan.waves == 1 and plan.ctas <= SMS * plan.ctas_per_sm


def test_plan_at_the_fleet_width_is_resident_at_once():
    plan = pipe_plan(32768, 128)
    assert plan.ctas == 1024 and SMS * plan.ctas_per_sm >= 1024
    # per channel: about 837 bytes of shared memory, 240 registers
    assert plan.smem_bytes / plan.channels_per_cta < 900
    assert plan.threads * 80 / plan.channels_per_cta == 240


@pytest.mark.parametrize("bsz,ok", [(128, True), (16, True), (512, True),
                                    (100, False), (8, False), (16384, False)])
def test_plan_block_sizes(bsz, ok):
    plan = pipe_plan(4096, bsz)
    assert (plan is not None) == ok
    if ok:
        assert plan.rel_slots * plan.sub_rows == bsz


@pytest.mark.parametrize("coupled,bsz,c,want", [
    (False, 128, 8, "detector_pipe"), (True, 128, 8, "detector_warp"),
    (False, 100, 8, "detector"), (True, 100, 8, "detector"),
    (True, 128, 1, "detector_warp"), (True, 128, 32, "detector_warp"),
    (True, 128, 33, "detector"), (True, 1024, 32, "detector"),
    (False, 128, 33, "detector_pipe")])
def test_kernel_for_routes_by_config(coupled, bsz, c, want):
    """Per-channel gating: the pipe; coupled at up to 32 channels: one warp
    per channel, while two stages of the block fit shared memory; else
    (and at block sizes with no pipe plan) detector.cu."""
    static, _, _ = tamp.detector_init(
        DetectorConfig(n_channels=c, block_size=bsz,
                       coupled_off_gate=coupled), device="cpu")
    assert kernel_for(static).name == want


def test_fleet_detector_routes_to_the_pipe():
    from onset_fingerprinting_torch.pipeline import fleet_detector_config

    static, _, _ = tamp.detector_init(fleet_detector_config(8192),
                                      device="cpu")
    assert kernel_for(static) is _cuda.DETECTOR_PIPE


def test_plain_version_counts_on_the_routed_kernel():
    cfg = DetectorConfig(n_channels=5, coupled_off_gate=False)
    static, params, state = tamp.detector_init(cfg, device="cpu")
    x = synth(128 * 4, 5, 0)
    pipe, old = _cuda.DETECTOR_PIPE, _cuda.DETECTOR
    before = (pipe.plain_calls, old.plain_calls, pipe.launches, old.launches)
    fst = detector_static(static, params)
    fused_detect_offline(fst, params, state, x)
    fused_warmup_minmax(fst, params, state, x)
    assert (pipe.plain_calls, old.plain_calls, pipe.launches,
            old.launches) == (before[0] + 2, *before[1:])


def test_coupled_plain_version_counts_on_the_old_kernel():
    # the wrappers count; the plain functions called directly do not.  At
    # 40 channels the coupled detector runs on detector.cu (above 32, the
    # warp-per-channel kernel's limit)
    cfg = DetectorConfig(n_channels=40, coupled_off_gate=True)
    static, params, state = tamp.detector_init(cfg, device="cpu")
    x = synth(128 * 4, 40, 0)
    pipe, old = _cuda.DETECTOR_PIPE, _cuda.DETECTOR
    before = (pipe.plain_calls, old.plain_calls, pipe.launches, old.launches)
    fst = detector_static(static, params)
    fused_detect_offline(fst, params, state, x)
    fused_warmup_minmax(fst, params, state, x)
    tamp.detect_offline(static, params, state, x)
    tamp.warmup_minmax(static, params, state, x)
    assert (pipe.plain_calls, old.plain_calls, pipe.launches,
            old.launches) == (before[0], before[1] + 2, *before[2:])


# ---- the ring hand-off ----

class Barrier:
    """An mbarrier whose count is one warp (all its lanes arrive at once)."""

    def __init__(self):
        self.phase = 0  # completed phases

    def arrive(self):
        self.phase += 1

    def passed(self, parity):
        return (self.phase & 1) != parity


def wait(bar, parity):
    """Block until ``bar.passed(parity)``, as ``bar_wait`` spins: the
    scheduler resumes a warp only once what it yielded has passed."""
    while not bar.passed(parity):
        yield bar, parity


def warp0(k, s, params, x, st, ring, out):
    """IIR and dB (detector_pipe.cu, ``warp == 0``)."""
    xs, db, d_full, d_empty, ng = (ring["xs"], ring["db"], ring["d_full"],
                                   ring["d_empty"], ring["ng"])
    b, a = params.b.tolist(), params.a.tolist()
    z = list(st.zi.unbind(0))
    pending = []  # committed cp.async groups, oldest first

    def load(g):
        rows = x[g * SB:(g + 1) * SB].clone() if g < ng else None
        pending.append((g, rows))

    def copy_wait(n):
        while len(pending) > n:
            g, rows = pending.pop(0)
            if rows is not None:
                xs[g % NX] = rows

    for g in range(NX - 1):
        load(g)
    for g in range(ng):
        load(g + NX - 1)
        copy_wait(NX - 1)
        ds = g % ND
        yield from wait(d_empty[ds], ((g // ND) & 1) ^ 1)
        for r in range(SB):
            z, xdb = tamp.iir_db_step(k, b, a, z, xs[g % NX, r], s.use_hipass)
            db[ds, r] = xdb
            yield
        xs[g % NX] = float("nan")  # read: the next load may refill it
        d_full[ds].arrive()
    copy_wait(0)
    out["zi"] = torch.stack(z) if s.use_hipass else st.zi


def warp1(k, s, st, ring, out, emit):
    """Envelopes and linear rel (``warp == 1``)."""
    db, rel, ng, nsb = ring["db"], ring["rel"], ring["ng"], ring["nsb"]
    yf, ys = st.fast, st.slow
    for g in range(ng):
        ds = g % ND
        blk = g // nsb
        j = g - blk * nsb
        yield from wait(ring["d_full"][ds], (g // ND) & 1)
        yield from wait(ring["r_empty"][j], (blk & 1) ^ 1)
        for r in range(SB):
            yf, ys, rr = tamp.envelope_rel_step(k, yf, ys, db[ds, r])
            rel[j, r] = rr
            if emit:
                out["rel"][g * SB + r] = rr
            yield
        db[ds] = float("nan")
        ring["d_empty"][ds].arrive()
        ring["r_full"][j].arrive()
    out["fast"], out["slow"] = yf, ys


def warp2(k, s, params, st, ring, out, warmup):
    """Min/max, pass 2 as one scan, backtracking, events (``warp == 2``)."""
    rel, ng, nsb = ring["rel"], ring["ng"], ring["nsb"]
    bsz = s.block_size
    mn, mx, gate, prev = st.min_val, st.max_val, st.gate, st.prev_rel
    deb = st.debounce
    bt = st.bt_buffer.clone()
    pos = int(st.bt_pos) if s.backtrack else 0
    ons, deltas = [], []
    for g in range(ng):
        blk = g // nsb
        j = g - blk * nsb
        yield from wait(ring["r_full"][j], blk & 1)
        if not s.manual:
            for r in range(SB):
                mn, mx = tamp.minmax_step(k, mn, mx, rel[j, r])
                yield
        if warmup:
            rel[j] = float("nan")
            ring["r_empty"][j].arrive()
            continue
        if j < nsb - 1:
            continue
        if s.manual:
            on_th, off_th = params.on_threshold, params.off_threshold
        else:
            on_th = mx * params.on_threshold + mn
            off_th = mx * params.off_threshold + mn
        can_fire = ~gate & (deb < 1)
        first = torch.full_like(deb, bsz)
        off_all = torch.zeros_like(gate)
        off_from = torch.zeros_like(gate)
        pv = prev
        for jj in range(nsb):
            for r in range(SB):
                rr = rel[jj, r].clone()  # the slot is released below
                t = jj * SB + r
                if s.backtrack:
                    bt[(pos + t) % s.bt_size] = rr
                cross = (first == bsz) & can_fire & (rr > on_th) & (pv < on_th)
                first = torch.where(cross, t, first)
                off_from = off_from & ~cross
                lo = rr < off_th
                off_all = off_all | lo
                off_from = off_from | lo
                pv = rr
                yield
            rel[jj] = float("nan")
            ring["r_empty"][jj].arrive()
        if s.backtrack:
            pos = (pos + bsz) % s.bt_size
        on = first < bsz
        on_idx = torch.where(on, first, 0).to(torch.int32)
        gate = gate | on
        deb = torch.where(on, s.cooldown, deb)
        deb = torch.where(deb > 0, deb - bsz, deb).to(torch.int32)
        gate = torch.where(torch.where(on, off_from, off_all), False, gate)
        prev = pv
        delta = on_idx
        if s.backtrack:
            lin = (pos + torch.arange(s.bt_size)) % s.bt_size
            walked = tamp._backtrack(s, bt[lin], on_idx)
            delta = torch.where(on, walked, on_idx).to(torch.int32)
        ons.append(on)
        deltas.append(delta)
    out.update(min_val=mn, max_val=mx, gate=gate, prev_rel=prev,
               debounce=deb, bt_buffer=bt,
               bt_pos=torch.tensor(pos, dtype=torch.int32) if s.backtrack
               else st.bt_pos, ons=ons, deltas=deltas)


def schedule(warps, policy, seed):
    """Run one CTA's warps (generators) to the end, interleaved by
    ``policy``: a warp resumes only once what it yielded has passed."""
    rng = random.Random(seed)
    blocked = dict.fromkeys(range(len(warps)))  # live warps: what each waits on
    while blocked:
        ready = [w for w, b in blocked.items() if b is None or b[0].passed(b[1])]
        assert ready, "deadlock: every warp waits on a barrier"
        if policy == "random":
            w = rng.choice(ready)
        elif policy == "producers_first":
            w = min(ready)
        else:  # consumers_first
            w = max(ready)
        try:
            blocked[w] = next(warps[w])
        except StopIteration:
            del blocked[w]


def run_pipe(s, params, st, x, emit, warmup, policy, seed=0, w2=warp2):
    """The kernel's schedule over one chunk → what ``_launch`` returns."""
    k = tamp.sample_constants(s)
    t, c = x.shape
    nsb = s.block_size // SB
    nan = float("nan")
    ring = dict(
        xs=torch.full((NX, SB, c), nan), db=torch.full((ND, SB, c), nan),
        rel=torch.full((nsb, SB, c), nan), nsb=nsb,
        ng=(t // s.block_size) * nsb,
        d_full=[Barrier() for _ in range(ND)],
        d_empty=[Barrier() for _ in range(ND)],
        r_full=[Barrier() for _ in range(nsb)],
        r_empty=[Barrier() for _ in range(nsb)],
    )
    out = dict(rel=torch.full((t, c), nan) if emit else None)
    schedule([warp0(k, s, params, x, st, ring, out),
              warp1(k, s, st, ring, out, emit),
              w2(k, s, params, st, ring, out, warmup)], policy, seed)
    state = tamp.DetectorState(
        zi=out["zi"], fast=out["fast"], slow=out["slow"],
        min_val=out["min_val"], max_val=out["max_val"], gate=out["gate"],
        prev_rel=out["prev_rel"], debounce=out["debounce"],
        bt_buffer=out["bt_buffer"], bt_pos=out["bt_pos"])
    if warmup:
        return state
    return state, (torch.stack(out["ons"]), torch.stack(out["deltas"]),
                   out["rel"])


def assert_states_equal(a, b):
    for name, u, v in zip(a._fields, a, b):
        assert torch.equal(u, v), name


MODES = {
    "fleet": dict(hipass_freq=2000.0),
    "no_hipass": dict(hipass_freq=0.0),
    "manual": dict(hipass_freq=2000.0, on_threshold=3.0, off_threshold=1.0),
    "backtrack": dict(hipass_freq=2000.0, backtrack=True,
                      backtrack_buffer_size=256),
    "backtrack_no_hipass": dict(hipass_freq=0.0, backtrack=True,
                                backtrack_buffer_size=200),
}
POLICIES = ["random", "producers_first", "consumers_first"]


def detector(mode, c=37, bsz=128):
    cfg = DetectorConfig(n_channels=c, block_size=bsz, sr=96000,
                         coupled_off_gate=False, **MODES[mode])
    return tamp.detector_init(cfg, device="cpu")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mode", list(MODES))
def test_pipe_schedule_equals_detect_offline(mode, policy):
    c = 37  # a ragged last CTA: 5 of 32 lanes
    s, params, st = detector(mode, c)
    x = synth(128 * 10, c, seed=1)
    st = tamp.warmup_minmax(s, params, st, x[: 128 * 3])
    want_st, (on, d, rel) = tamp.detect_offline(s, params, st, x)
    assert int(on.sum()) > 0
    got_st, (on_g, d_g, rel_g) = run_pipe(s, params, st, x, True, False,
                                          policy, seed=3)
    assert torch.equal(on_g, on) and torch.equal(d_g, d)
    assert torch.equal(rel_g, rel)
    assert_states_equal(got_st, want_st)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mode", ["fleet", "no_hipass", "manual"])
def test_pipe_warmup_schedule_equals_warmup_minmax(mode, policy):
    s, params, st = detector(mode, 37)
    x = synth(128 * 6, 37, seed=2)
    want = tamp.warmup_minmax(s, params, st, x)
    got = run_pipe(s, params, st, x, False, True, policy, seed=4)
    assert_states_equal(got, want)


def test_pipe_schedule_without_rel_and_at_other_block_sizes():
    # emit_rel off, and blocks of 2 and 4 sub-blocks (rel rings of 2, 4)
    for bsz in (32, 64):
        s, params, st = detector("fleet", 40, bsz)
        x = synth(bsz * 30, 40, seed=5)
        want_st, (on, d, _) = tamp.detect_offline(s, params, st, x)
        got_st, (on_g, d_g, rel_g) = run_pipe(s, params, st, x, False, False,
                                              "random", seed=bsz)
        assert rel_g is None
        assert torch.equal(on_g, on) and torch.equal(d_g, d)
        assert_states_equal(got_st, want_st)


def test_emulation_catches_an_early_release():
    """The NaN fill is what makes the check bite: let rel slot 0 be
    released as soon as warp 1 fills it, before warp 2 has read it, and the
    events differ."""
    s, params, st = detector("fleet", 8)
    x = synth(128 * 20, 8, seed=6)
    st = tamp.warmup_minmax(s, params, st, x[: 128 * 3])
    _, (on, d, rel) = tamp.detect_offline(s, params, st, x)
    assert int(on.sum()) > 0

    def early(k, s_, params_, st_, ring, out, warmup):
        full = ring["r_full"][0]
        arrive = full.arrive

        def arrive_and_release():
            arrive()
            ring["rel"][0] = float("nan")
        full.arrive = arrive_and_release
        yield from warp2(k, s_, params_, st_, ring, out, warmup)

    _, (on_g, d_g, rel_g) = run_pipe(s, params, st, x, True, False,
                                     "producers_first", w2=early)
    assert torch.equal(rel_g, rel)  # warp 1's own output is untouched
    assert not (torch.equal(on_g, on) and torch.equal(d_g, d))


# ---- tools/detector_split.py: its variants still apply, its SASS count ----

@pytest.mark.parametrize("name", ["compute", "loads"])
def test_split_variants_patch_the_current_sources(name):
    from onset_fingerprinting_torch.tools import detector_split as ds

    src = (_cuda.CSRC / "detector.cu").read_text()
    out = ds.variant_source(src, name)
    assert out != src


def test_split_counts_an_inner_loop_per_sample():
    from onset_fingerprinting_torch.tools.detector_split import inner_loops

    sass = """
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDS R2, [R3] ;
        /*0020*/                   FADD R2, R2, R4 ;
        /*0030*/                   MUFU.EX2 R2, R2 ;
        /*0040*/                   STS [R3], R2 ;
        /*0050*/                   LDS R5, [R3+0x80] ;
        /*0060*/                   FMUL R5, R5, R4 ;
        /*0070*/                   STS [R3+0x80], R5 ;
        /*0080*/               @P0 BRA 0x10 ;
        /*0090*/                   EXIT ;
"""
    (loop,) = inner_loops(sass.splitlines())
    assert (loop["start"], loop["n"], loop["fp"], loop["samples"]) == (
        "0x10", 8, 3, 2)
    assert loop["per_sample"] == 4.0 and loop["mufu"] == 1
