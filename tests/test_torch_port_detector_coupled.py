"""K1's coupled pipe (``csrc/detector_pipe.cu`` with ``COUPLED``), emulated
on the CPU: its launch plan, its routing, and its schedule with lane
groups.

The emulation extends ``test_torch_port_detector_pipe``'s (mbarrier
parities, ``cp.async`` groups that land at ``wait_group``, NaN-filled
released slots, three scheduling policies) to the coupled layout: a CTA's
32 lanes hold ``gpc`` detectors of C channels, lane ``grp * C + ch``
channel ``ch`` of stream ``gpc * cta + grp``; a ring slot is a flat
``rows * 32`` floats holding ``[rows][gpc * C]`` (the kernel's compact
rows; 64 rows a sub-block at few live lanes, where the kernel spreads the
dB and the linear rel across all lanes over a sub-block's values in its
order, element ``e`` at lane ``e % 32``; a rel ring of two blocks); idle
lanes compute on a clamped stream and store nothing.  (One group's x
and rel move in 16-byte pieces on the card; the emulation lands every
lane's rows at ``wait_group`` either way.)  Warp 2
tracks each lane's last row below off and takes the off check from its
group's largest first-onset row.  The plain detector's own stage functions
do the arithmetic; the transcendental ones element by element, as the
plain detector's few-channel vectors run them, so the result must equal
``detect_offline`` / ``warmup_minmax`` stream by stream, bit for bit.
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_detector_pipe import (
    MODES,
    ND,
    NX,
    POLICIES,
    Barrier,
    assert_states_equal,
    schedule,
    synth,
    wait,
)

from onset_fingerprinting_tpu.core.config import DetectorConfig as JCfg
from onset_fingerprinting_tpu.ops.pallas_detector import make_pallas_detector
from onset_fingerprinting_torch.core.config import DetectorConfig
from onset_fingerprinting_torch.detect import amplitude as tamp
from onset_fingerprinting_torch.ops import _cuda
from onset_fingerprinting_torch.ops.fused_detector import (
    COUPLED_REGS,
    COUPLED_REL_BLOCKS,
    COUPLED_SPREAD_LANES,
    PIPE_CHANNELS,
    SMS,
    coupled_plan,
    detector_static,
    fused_detect_offline,
    fused_detect_streams,
    fused_warmup_minmax,
    kernel_for,
    pipe_plan,
)

NAN = float("nan")
LANES = 32


# ---- the plan and the routes ----

@pytest.mark.parametrize("s,c,gpc,ctas", [
    (1, 3, 1, 1),          # one recording: one group, one CTA
    (7, 3, 1, 7),          # few streams: one CTA per SM first
    (1024, 3, 8, 128),     # 8c's batch: 8 streams a CTA, 128 CTAs
    (1320, 3, 10, 132),    # 10 groups a CTA, one per SM
    (5000, 3, 10, 500),    # more: 10 a CTA (30 of 32 lanes), 4 CTAs an SM
    (64, 32, 1, 64),       # 32 channels: one group a CTA
    (300, 5, 3, 100),
])
def test_coupled_plan(s, c, gpc, ctas):
    plan = coupled_plan(s, c, 128)
    assert (plan.channels, plan.groups_per_cta, plan.ctas) == (c, gpc, ctas)
    assert plan.live_lanes == gpc * c <= PIPE_CHANNELS
    assert COUPLED_REGS * 96 * 4 <= 65536 < COUPLED_REGS * 96 * 5
    assert plan.threads == 96
    few = gpc * c <= 8
    assert plan.spread == few
    if few:  # sub-blocks of 64 rows: 3 x and 2 dB slots, 2 blocks of rel
        assert (plan.sub_rows, plan.rel_slots) == (64, 4)
        assert plan.smem_bytes == 8 * (4 + 8) + (3 + 2 + 4) * 64 * 32 * 4
        assert plan.smem_bytes == 73824 and plan.ctas_per_sm == 3
    else:  # the pipe's sub-blocks of 16 rows, 2 blocks of rel
        pipe = pipe_plan(c, 128)
        assert (plan.sub_rows, plan.rel_slots) == (16, 16)
        assert plan.smem_bytes == 288 + (3 + 2 + 16) * 16 * 32 * 4
        assert plan.smem_bytes == pipe.smem_bytes + 8 * 16 + 8 * 2048
        # __launch_bounds__(96, 4): 168 registers a thread
        assert plan.ctas_per_sm == 4
    assert plan.waves == -(-ctas // (SMS * plan.ctas_per_sm)) == 1


def test_coupled_plan_sub_rows_follow_the_block():
    """Few live lanes take 64-row sub-blocks where the block is a multiple
    of 64, else the pipe's 16."""
    assert [coupled_plan(1, 3, b).sub_rows for b in (32, 64, 128, 256)] == [
        16, 64, 64, 64]
    assert coupled_plan(1, 3, 32).rel_slots == 4


def test_coupled_plan_limits():
    assert coupled_plan(1, 33, 128) is None  # detector.cu's
    assert coupled_plan(1, 3, 100) is None   # no pipe plan
    assert coupled_plan(7, 3, 128, groups_per_cta=10).ctas == 1
    for bad in (0, 11):
        with pytest.raises(ValueError):
            coupled_plan(7, 3, 128, groups_per_cta=bad)


@pytest.mark.parametrize("coupled,bsz,c,t,want", [
    (True, 128, 3, 128 * 375, "detector_pipe_coupled"),  # the warmup
    (True, 128, 3, 299904, "detector_pipe_coupled"),     # mining
    (True, 128, 32, 256, "detector_pipe_coupled"),
    (True, 128, 3, 128, "detector_warp"),                 # the engine's step
    (True, 128, 3, None, "detector_warp"),                # default: a block
    (True, 128, 3, 0, "detector_warp"),
    (True, 128, 33, 128 * 40, "detector"),
    (True, 128, 40, 128, "detector"),
    (True, 1024, 32, 1024, "detector"),      # the step's stages do not fit
    (True, 1024, 32, 2048, "detector"),      # nor two blocks of rel
    (True, 512, 32, 1024, "detector_pipe_coupled"),
    (True, 100, 3, 1000, "detector"),         # no pipe plan
    (False, 128, 3, 128 * 40, "detector_pipe"),
    (False, 128, 3, 128, "detector_pipe"),
])
def test_kernel_for_routes_by_config_and_length(coupled, bsz, c, t, want):
    """Coupled calls of more than one block at up to 32 channels take the
    coupled pipe, a one-block step the warp kernel, more channels
    detector.cu; per-channel gating the pipe at any length."""
    static, _, _ = tamp.detector_init(
        DetectorConfig(n_channels=c, block_size=bsz,
                       coupled_off_gate=coupled), device="cpu")
    assert kernel_for(static, t).name == want


def test_coupled_plain_version_counts_on_the_routed_kernel():
    """On the CPU each wrapper runs the plain version and counts it on the
    kernel a CUDA call of that length takes; nothing launches."""
    cfg = DetectorConfig(n_channels=3, coupled_off_gate=True)
    static, params, state = tamp.detector_init(cfg, device="cpu")
    fst = detector_static(static, params)
    x = synth(128 * 4, 3, 0)
    ks = (_cuda.DETECTOR_PIPE_COUPLED, _cuda.DETECTOR_WARP, _cuda.DETECTOR,
          _cuda.DETECTOR_PIPE)
    before = [(k.plain_calls, k.launches) for k in ks]
    fused_warmup_minmax(fst, params, state, x)
    fused_detect_offline(fst, params, state, x)
    states = tamp.DetectorState(*(v.expand((2,) + tuple(v.shape)).clone()
                                  for v in state))
    fused_detect_streams(fst, params, states, torch.stack([x, x]))
    fused_detect_offline(fst, params, state, x[:128])  # one block: the step
    fused_detect_streams(fst, params, states, torch.stack([x, x])[:, :128])
    after = [(k.plain_calls, k.launches) for k in ks]
    assert after == [(before[0][0] + 3, before[0][1]),
                     (before[1][0] + 2, before[1][1]), before[2], before[3]]


# ---- the schedule with lane groups ----

class Lanes(NamedTuple):
    """One CTA's lanes (``detector_pipe.cu``, COUPLED)."""

    s: torch.Tensor       # [32] stream, clamped to a valid one
    ch: torch.Tensor      # [32] channel
    grp: torch.Tensor     # [32] lane group
    active: torch.Tensor  # [32] stores its results
    lw: torch.Tensor      # [32] owns a ring column
    ld: int               # a ring row's width, gpc * C


def lanes(cta, n_streams, c, gpc):
    lane = torch.arange(LANES)
    grp = lane // c
    ld = gpc * c
    s = cta * gpc + grp
    return Lanes(s.clamp(max=n_streams - 1), lane - grp * c, grp,
                 (lane < ld) & (s < n_streams), lane < ld, ld)


def scalarwise(fn, v):
    """``fn`` element by element (the plain detector's 3-channel vectors run
    log2 and exp2 on PyTorch's scalar path; its vector path rounds exp2
    differently)."""
    return torch.stack([fn(e) for e in v.unbind()]) if v.numel() else v


def cwarp0(k, s, params, xl, zl, lay, ring, out, spread):
    """IIR and dB, coupled (``warp == 0``): x rows land in the lane's own
    column; with SPREAD the IIR writes y over x and the dB runs across the
    lanes over the sub-block's sb * ld values."""
    xs, db, ng, ld, sb = (ring["xs"], ring["db"], ring["ng"], lay.ld,
                          ring["sb"])
    lane = torch.arange(LANES)
    own = lane[lay.lw]
    b, a = params.b.tolist(), params.a.tolist()
    z = list(zl.unbind(0))
    pending = []  # committed cp.async groups, oldest first

    def load(g):
        pending.append((g, xl[g * sb:(g + 1) * sb].clone() if g < ng
                        else None))

    def copy_wait(n):
        while len(pending) > n:
            g, rows = pending.pop(0)
            if rows is not None:
                for r in range(sb):
                    xs[g % NX, r * ld + own] = rows[r, lay.lw]

    def db_of(y):
        return scalarwise(lambda v: tamp.db_step(k, v), y)

    for g in range(NX - 1):
        load(g)
    for g in range(ng):
        load(g + NX - 1)
        copy_wait(NX - 1)
        ds = g % ND
        yield from wait(ring["d_empty"][ds], ((g // ND) & 1) ^ 1)
        xin, dout = xs[g % NX], db[ds]
        if spread:
            for r in range(sb):
                z, y = tamp.iir_step(b, a, z, xin[r * ld + lane].clone(),
                                     s.use_hipass)
                xin[r * ld + own] = y[lay.lw]
                yield
            for e0 in range(0, sb * ld, LANES):
                e = torch.arange(e0, min(e0 + LANES, sb * ld))
                dout[e] = db_of(xin[e])
                yield
        else:
            for r in range(sb):
                z, y = tamp.iir_step(b, a, z, xin[r * ld + lane].clone(),
                                     s.use_hipass)
                dout[r * ld + own] = db_of(y)[lay.lw]
                yield
        xs[g % NX] = NAN  # read: the next load may refill it
        ring["d_full"][ds].arrive()
    copy_wait(0)
    out["zi"] = torch.stack(z) if s.use_hipass else zl


def cwarp1(k, s, yf, ys, lay, ring, out, emit, spread):
    """Envelopes and linear rel, coupled (``warp == 1``): with SPREAD the
    envelopes' dB difference goes to the rel slot, the exp2 across the
    lanes, then each lane reads its column back for the rel output."""
    db, rel, ng, ld, sb = (ring["db"], ring["rel"], ring["ng"], lay.ld,
                           ring["sb"])
    lane = torch.arange(LANES)
    own = lane[lay.lw]

    def rel_of(d):
        return scalarwise(lambda v: tamp.rel_step(k, v), d)

    nrel = ring["nrel"]
    for g in range(ng):
        ds = g % ND
        jr = g % nrel  # its rel slot
        yield from wait(ring["d_full"][ds], (g // ND) & 1)
        yield from wait(ring["r_empty"][jr], ((g // nrel) & 1) ^ 1)
        # the lane's column into registers, and the dB slot released
        col = [db[ds, r * ld + lane].clone() for r in range(sb)]
        db[ds] = NAN
        ring["d_empty"][ds].arrive()
        rout = rel[jr]
        for r in range(sb):
            yf, ys, d = tamp.envelope_step(k, yf, ys, col[r])
            rout[r * ld + own] = (d if spread else rel_of(d))[lay.lw]
            yield
        if spread:
            for e0 in range(0, sb * ld, LANES):
                e = torch.arange(e0, min(e0 + LANES, sb * ld))
                rout[e] = rel_of(rout[e])
                yield
        if emit:
            for r in range(sb):
                out["rel"][g * sb + r] = rout[r * ld + lane]
        ring["r_full"][jr].arrive()
    out["fast"], out["slow"] = yf, ys


def group_max(v, grp):
    """``__reduce_max_sync`` with each lane's group mask."""
    m = torch.full((LANES + 1,), -1, dtype=v.dtype).scatter_reduce(
        0, grp, v, "amax")
    return m[grp]


def cwarp2(k, s, on_p, off_p, st, lay, ring, out, warmup, reduce=group_max):
    """Min/max, pass 2 as one scan with the last below-off row, the coupled
    off check from the group's largest first row, backtracking, events
    (``warp == 2``)."""
    rel, ng, nsb, ld, sb = (ring["rel"], ring["ng"], ring["nsb"], lay.ld,
                            ring["sb"])
    lane = torch.arange(LANES)
    bsz, n = s.block_size, s.bt_size
    mn, mx, gate, prev = st["min_val"], st["max_val"], st["gate"], st[
        "prev_rel"]
    deb = st["debounce"]
    bt = st["bt_buffer"].clone()
    pos = st["bt_pos"].long() if s.backtrack else torch.zeros(LANES,
                                                             dtype=torch.long)
    ons, deltas = [], []
    nrel = ring["nrel"]
    for g in range(ng):
        blk = g // nsb
        j = g - blk * nsb  # in its block
        jr = g % nrel  # its rel slot; the block's first is jr - j
        yield from wait(ring["r_full"][jr], (g // nrel) & 1)
        if not s.manual:
            for r in range(sb):
                mn, mx = tamp.minmax_step(k, mn, mx, rel[jr, r * ld + lane])
                yield
        if warmup:
            rel[jr] = NAN
            ring["r_empty"][jr].arrive()
            continue
        if j < nsb - 1:
            continue
        if s.manual:
            on_th, off_th = on_p, off_p
        else:
            on_th, off_th = mx * on_p + mn, mx * off_p + mn
        can_fire = ~gate & (deb < 1)
        first = torch.full((LANES,), bsz)
        last_lo = torch.full((LANES,), -1)
        pv = prev
        for jj in range(jr - j, jr - j + nsb):
            # the slot's column into registers, the slot released at once
            col = [rel[jj, r * ld + lane].clone() for r in range(sb)]
            rel[jj] = NAN
            ring["r_empty"][jj].arrive()
            for r in range(sb):
                rr = col[r]
                t = (jj - jr + j) * sb + r
                if s.backtrack:
                    bt[(pos + t) % n, lane] = rr
                cross = (first == bsz) & can_fire & (rr > on_th) & (pv < on_th)
                first = torch.where(cross, t, first)
                last_lo = torch.where(rr < off_th, t, last_lo)
                pv = rr
                yield
        if s.backtrack:
            pos = (pos + bsz) % n
        on = first < bsz
        on_idx = torch.where(on, first, 0)
        gate = gate | on
        deb = torch.where(on, s.cooldown, deb)
        deb = torch.where(deb > 0, deb - bsz, deb).to(torch.int32)
        gate = torch.where(last_lo >= reduce(on_idx, lay.grp), False, gate)
        prev = pv
        delta = on_idx.to(torch.int32)
        if s.backtrack:
            lin = bt[(pos[None, :] + torch.arange(n)[:, None]) % n, lane]
            walked = tamp._backtrack(s, lin, on_idx)
            delta = torch.where(on, walked, on_idx).to(torch.int32)
        ons.append(on)
        deltas.append(delta)
    out.update(min_val=mn, max_val=mx, gate=gate, prev_rel=prev,
               debounce=deb, bt_buffer=bt,
               bt_pos=pos.to(torch.int32) if s.backtrack else st["bt_pos"],
               ons=ons, deltas=deltas)


FIELDS = tamp.DetectorState._fields


def run_coupled(s, params, states, x, emit, warmup, policy, gpc, seed=0,
                spread=None, reduce=group_max):
    """The coupled kernel's schedule over ``x [S, T, C]`` from ``states``
    (a leading stream axis), CTA by CTA → what ``fused_detect_streams``
    returns (the new states alone for the warmup mode).  ``spread``:
    default the kernel's choice (at most COUPLED_SPREAD_LANES live
    lanes)."""
    k = tamp.sample_constants(s)
    n_s, t, c = x.shape
    plan = coupled_plan(n_s, c, s.block_size, gpc)
    sb = plan.sub_rows
    nsb = s.block_size // sb
    nrel = plan.rel_slots
    assert nrel == COUPLED_REL_BLOCKS * nsb
    if spread is None:
        spread = plan.spread
    nb = t // s.block_size
    new = {f: v.clone() for f, v in zip(FIELDS, states)}
    on_all = torch.zeros((n_s, nb, c), dtype=torch.bool)
    d_all = torch.zeros((n_s, nb, c), dtype=torch.int32)
    rel_all = torch.full((n_s, t, c), NAN) if emit else None
    for cta in range(-(-n_s // gpc)):
        lay = lanes(cta, n_s, c, gpc)
        si, ci = lay.s, lay.ch

        def per_lane(v):  # [S, ..., C] -> [..., 32]
            return v[si, ..., ci].movedim(0, -1)

        st = {f: per_lane(v) for f, v in zip(FIELDS, states)
              if f not in ("bt_pos",)}
        st["bt_pos"] = states.bt_pos[si]
        ring = dict(
            xs=torch.full((NX, sb * LANES), NAN),
            db=torch.full((ND, sb * LANES), NAN),
            rel=torch.full((nrel, sb * LANES), NAN), nsb=nsb, nrel=nrel,
            sb=sb,
            ng=nb * nsb,
            d_full=[Barrier() for _ in range(ND)],
            d_empty=[Barrier() for _ in range(ND)],
            r_full=[Barrier() for _ in range(nrel)],
            r_empty=[Barrier() for _ in range(nrel)],
        )
        out = dict(rel=torch.full((t, LANES), NAN) if emit else None)
        schedule([
            cwarp0(k, s, params, per_lane(x), st["zi"], lay, ring, out,
                   spread),
            cwarp1(k, s, st["fast"], st["slow"], lay, ring, out, emit,
                   spread),
            cwarp2(k, s, params.on_threshold[ci], params.off_threshold[ci],
                   st, lay, ring, out, warmup, reduce),
        ], policy, seed + cta)
        a = lay.active
        sa, ca = si[a], ci[a]
        for f in FIELDS:
            if f == "bt_pos":
                if s.backtrack:
                    new[f][sa[ca == 0]] = out[f][a][ca == 0]
            elif f == "zi" and not s.use_hipass:
                continue
            else:
                new[f][sa, ..., ca] = out[f].movedim(-1, 0)[a]
        if not warmup:
            on_all[sa, :, ca] = torch.stack(out["ons"]).T[a]
            d_all[sa, :, ca] = torch.stack(out["deltas"]).T[a]
            if emit:
                rel_all[sa, :, ca] = out["rel"].T[a]
    new = tamp.DetectorState(**new)
    if warmup:
        return new
    return new, (on_all, d_all, rel_all)


def stream_inputs(mode, n_s, c, t, seed, **extra):
    """A coupled detector, ``x [S, T, C]`` and per-stream states, each
    stream warmed on its own noise (so that the lanes' states differ)."""
    cfg = DetectorConfig(n_channels=c, block_size=extra.pop("bsz", 128),
                         sr=96000, coupled_off_gate=True,
                         **dict(MODES[mode], **extra))
    s, params, st0 = tamp.detector_init(cfg, device="cpu")
    xs, states = [], []
    for i in range(n_s):
        xs.append(synth(t, c, seed + i))
        states.append(tamp.warmup_minmax(s, params, st0,
                                          synth(s.block_size * 3, c,
                                                seed + 100 + i)))
    return s, params, tamp.DetectorState(*(torch.stack(f) for f in zip(
        *states))), torch.stack(xs)


def reference(s, params, states, x, warmup=False):
    """The plain detector stream by stream."""
    res = []
    for i in range(x.shape[0]):
        st = tamp.DetectorState(*(v[i] for v in states))
        res.append(tamp.warmup_minmax(s, params, st, x[i]) if warmup
                   else tamp.detect_offline(s, params, st, x[i]))
    if warmup:
        return tamp.DetectorState(*(torch.stack(f) for f in zip(*res)))
    new = tamp.DetectorState(*(torch.stack(f) for f in zip(
        *(r[0] for r in res))))
    return new, tuple(torch.stack(f) for f in zip(*(r[1] for r in res)))


def assert_detect_equal(got, want, emit=True):
    (gst, (on, d, rel)), (wst, (won, wd, wrel)) = got, want
    assert torch.equal(on, won) and torch.equal(d, wd)
    if emit:
        assert torch.equal(rel, wrel)
    assert_states_equal(gst, wst)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mode", list(MODES))
def test_coupled_schedule_equals_detect_offline(mode, policy):
    """5 streams of 3 channels, 2 a CTA (6 live lanes: the dB and exp2
    spread over all 32), the last CTA's second group past the last
    stream."""
    s, params, states, x = stream_inputs(mode, 5, 3, 128 * 10, seed=1)
    want = reference(s, params, states, x)
    assert int(want[1][0].sum()) > 0
    got = run_coupled(s, params, states, x, True, False, policy, gpc=2,
                      seed=3)
    assert_detect_equal(got, want)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mode", ["fleet", "no_hipass", "manual"])
def test_coupled_warmup_schedule_equals_warmup_minmax(mode, policy):
    s, params, states, x = stream_inputs(mode, 5, 3, 128 * 10, seed=2)
    want = reference(s, params, states, x, warmup=True)
    got = run_coupled(s, params, states, x, False, True, policy, gpc=2,
                      seed=4)
    assert_states_equal(got, want)


@pytest.mark.parametrize("n_s,c,gpc,bsz,emit,mode", [
    (1, 3, 1, 128, True, "fleet"),        # one recording: one group
    (7, 3, 10, 128, True, "no_hipass"),   # 3 groups past the last stream
    (7, 3, 3, 64, False, "backtrack"),    # 3 CTAs, the last with 1 stream
    (7, 3, 7, 128, True, "backtrack"),    # 21 live lanes, 11 idle
    (4, 5, 6, 32, True, "no_hipass"),     # 30 live lanes, 2 idle
    (3, 7, 4, 128, False, "manual"),      # 28 live lanes, a stream short
])
def test_coupled_schedule_layouts(n_s, c, gpc, bsz, emit, mode):
    """Per-lane dB and exp2 above 8 live lanes, spread at or below."""
    s, params, states, x = stream_inputs(mode, n_s, c, 1280, seed=c,
                                         bsz=bsz)
    want = reference(s, params, states, x)
    got = run_coupled(s, params, states, x, emit, False, "random", gpc,
                      seed=gpc)
    assert (got[1][2] is None) == (not emit)
    assert_detect_equal(got, want, emit)


def test_coupled_spread_over_many_lanes_equals_detect_offline():
    """The dB and exp2 spread at 30 live lanes (``tools/detector_split.py``'s
    ``spread_all``) give the same bits."""
    s, params, states, x = stream_inputs("backtrack", 3, 3, 1280, seed=5)
    want = reference(s, params, states, x)
    got = run_coupled(s, params, states, x, True, False, "random", gpc=10,
                      spread=True)
    assert_detect_equal(got, want)


# ---- an input where the coupled off check changes the events ----

CROSS_KW = dict(n_channels=3, block_size=128, sr=96000, hipass_freq=0.0,
                fast_attack=0.5, fast_release=20.0, slow_attack=50.0,
                slow_release=50.0, cooldown=128)


def crossing_input(lead=128 * 8):
    """Noise; in block ``lead // 128 + 3`` channel 0 fires at row 2 and its
    envelope falls below off, a tone ramps channel 0 up again from row 80,
    and channels 1 and 2 fire at rows 100 and 103.  Per channel, channel
    0's off check from row 2 turns its gate off and the tone fires it in
    the next block; coupled, the check starts at row 103, where the tone
    holds channel 0 above off, and the gate stays on."""
    rng = np.random.default_rng(0)
    t = lead + 128 * 16
    x = rng.normal(0, 1e-4, (t, 3)).astype(np.float32)
    n = np.arange(600)

    def burst(tau, amp=0.5):
        return (np.sin(2 * np.pi * 5000 / 96000 * n) * np.exp(-n / tau)
                * amp).astype(np.float32)

    b = lead + 128 * 3
    x[b + 2: b + 602, 0] += burst(8)
    k = np.arange(t - (b + 80))
    x[b + 80:, 0] += (np.sin(2 * np.pi * 3000 / 96000 * k)
                      * np.minimum(k / 40, 1.0) * 3.0).astype(np.float32)
    x[b + 100: b + 700, 1] += burst(60)
    x[b + 103: b + 703, 2] += burst(60)
    return x


def test_coupled_off_check_changes_events_and_equals_pallas():
    """On ``crossing_input`` the coupled schedule equals the plain coupled
    detector and JAX's Pallas detector in interpret mode (coupled_off_gate
    on), and its events differ from the per-channel detector's."""
    x = crossing_input()
    s, params, st = tamp.detector_init(DetectorConfig(**CROSS_KW),
                                       device="cpu")
    xt = torch.as_tensor(x)
    states = tamp.DetectorState(*(v[None] for v in st))
    got = run_coupled(s, params, states, xt[None], True, False, "random",
                      gpc=1, seed=7)
    want = reference(s, params, states, xt[None])
    assert_detect_equal(got, want)
    on, d = got[1][0][0], got[1][1][0]
    # per-channel gating fires channel 0 once more
    sp, pp, stp = tamp.detector_init(
        DetectorConfig(**dict(CROSS_KW, coupled_off_gate=False)),
        device="cpu")
    _, (on_pc, _, _) = tamp.detect_offline(sp, pp, stp, xt)
    assert int(on.sum()) >= 3 and int(on_pc.sum()) == int(on.sum()) + 1
    assert not torch.equal(on, on_pc)
    # JAX's Pallas detector, interpret mode, coupled
    _, _, jstate, run = make_pallas_detector(
        JCfg(coupled_off_gate=True, **CROSS_KW), interpret=True,
        emit_rel=True)
    _, (on_j, d_j, rel_j) = run(jstate, jnp.asarray(x))
    np.testing.assert_array_equal(on.numpy(), np.asarray(on_j))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))
    np.testing.assert_allclose(got[1][2][0].numpy(), np.asarray(rel_j),
                               atol=2e-2)


def test_emulation_catches_a_per_channel_off_check():
    """The in-group max is what the crossing input tests: a kernel that took
    each lane's own first row (no reduction) fires channel 0 again."""
    x = torch.as_tensor(crossing_input())[None]
    s, params, st = tamp.detector_init(DetectorConfig(**CROSS_KW),
                                       device="cpu")
    states = tamp.DetectorState(*(v[None] for v in st))
    want = reference(s, params, states, x)
    _, (on, _, _) = run_coupled(s, params, states, x, False, False,
                                "producers_first", gpc=1,
                                reduce=lambda v, grp: v)
    assert not torch.equal(on, want[1][0])
