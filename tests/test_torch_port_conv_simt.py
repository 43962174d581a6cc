"""K3's CUDA-core kernel (``csrc/conv_stack.cu``) on the CPU: its schedule
(``ops/conv_stack.simt_plan``), its packed weights, its route, and an
emulation of its lane tasks (register window along the taps, skewed rows,
padded feature groups) against the plain version.  The kernel itself runs
only on the card (tests/test_torch_port_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from onset_fingerprinting_torch.ops import _cuda
from onset_fingerprinting_torch.ops.conv_stack import (
    _ACTIVATIONS,
    CTA_RESERVED,
    SIMT_MAX_WARPS,
    SIMT_TT,
    SM_SMEM,
    SMEM_LIMIT,
    _pack,
    conv_stack_reference,
    kernel_for,
    simt_plan,
    simt_tasks,
    skew,
)

FLAGSHIP_KS = (1, 33, 64, 15, 15, 15, 1)


def shapes_of(ks, widths):
    out, cin = [], 1
    for o, k in zip(widths, ks):
        out.append((o, cin, k))
        cin = o
    return out


def stack(ks, widths, seed=0):
    g = torch.Generator().manual_seed(seed)
    ws = [torch.randn(s, generator=g) / (s[1] * s[2]) ** 0.5
          for s in shapes_of(ks, widths)]
    bs = [0.1 * torch.randn(w.shape[0], generator=g) for w in ws]
    return ws, bs


@st.composite
def stacks(draw):
    n = draw(st.integers(1, 4))
    widths = draw(st.lists(st.integers(1, 16), min_size=n, max_size=n))
    ks = draw(st.lists(st.integers(1, 64), min_size=n, max_size=n))
    pad = draw(st.integers(0, 3))
    length = draw(st.integers(16, 512))
    t = length
    for k in ks:
        t = t + 2 * pad - k + 1
        if t <= 0:
            ks = [1] * n  # a chain that fits: pointwise layers
            break
    elem = draw(st.sampled_from((4, 2)))
    return ks, widths, pad, length, elem


@settings(max_examples=300, deadline=None, database=None)
@given(stacks())
def test_plan_fits_and_covers_every_output_once(case):
    ks, widths, pad, length, elem = case
    shapes = shapes_of(ks, widths)
    plan = simt_plan(length, shapes, pad, elem)
    # shared memory: two weight buffers and two buffers per signal
    per_signal = 2 * plan.max_feat * plan.pitch * elem
    assert plan.smem == 2 * plan.w_max * 4 + plan.ns * per_signal
    assert plan.smem <= SMEM_LIMIT
    # resident warps as designed: the most any signals-per-CTA choice keeps
    # on an SM under its shared memory and the register cap
    def resident(ns):
        smem = 2 * plan.w_max * 4 + ns * per_signal
        if smem > SMEM_LIMIT:
            return 0
        return ns * min(SM_SMEM // (smem + CTA_RESERVED),
                        SIMT_MAX_WARPS // ns)
    assert plan.resident_warps == resident(plan.ns)
    assert plan.resident_warps == max(resident(n) for n in (1, 2, 4, 8, 16))
    assert plan.threads == 32 * plan.ns <= 512
    assert skew(plan.buf_rows - 1) < plan.pitch and plan.pitch % 8 == 0
    t_in = length
    assert length + 2 * pad <= plan.buf_rows
    for lp, (o, i, k) in zip(plan.layers, shapes):
        assert (lp.out_feat, lp.in_feat, lp.k) == (o, i, k)
        assert lp.t_out == t_in + 2 * pad - k + 1
        assert lp.tt in SIMT_TT and 1 <= lp.ow <= 8
        assert lp.owp in (4, 8) and lp.ow <= lp.owp
        assert lp.n_og * lp.ow >= o > (lp.n_og - 1) * lp.ow
        assert lp.w_off % 4 == 0 and lp.w_len % 4 == 0
        assert lp.w_len <= plan.w_max
        # every (position, output feature) written exactly once
        hits = np.zeros((lp.t_out, o), np.int64)
        for lane in simt_tasks(lp):
            for g, t0 in lane:
                ts = np.arange(t0, t0 + lp.tt)
                fs = np.arange(g * lp.ow, (g + 1) * lp.ow)
                ts, fs = ts[ts < lp.t_out], fs[fs < o]
                hits[np.ix_(ts, fs)] += 1
                # rows read (the tap window one row ahead) and written
                assert t0 + lp.tt + k - 1 < lp.rows_read <= plan.buf_rows
        assert (hits == 1).all()
        assert 2 * pad + lp.t_out <= plan.buf_rows
        t_in = lp.t_out


def test_flagship_plan_keeps_16_warps_per_sm():
    for elem in (4, 2):
        plan = simt_plan(256, shapes_of(FLAGSHIP_KS, (5,) * 7), 1, elem)
        assert plan.ns == 8 and plan.ctas_per_sm == 2
        assert plan.resident_warps >= 16
    # each layer's tasks fill most of the warp's lanes in one or two rounds
    for lp in plan.layers:
        n = lp.n_chunks * lp.n_og
        assert n / (32 * -(-n // 32)) >= 0.8


@pytest.mark.parametrize("tt", SIMT_TT)
def test_skewed_rows_meet_at_most_two_lanes_per_bank(tt):
    for m in range(64):
        banks = np.bincount([skew(c * tt + m) % 32 for c in range(32)],
                            minlength=32)
        assert banks.max() <= 2


def test_too_large_a_stack_raises():
    with pytest.raises(ValueError, match="too large"):
        simt_plan(4096, shapes_of((3, 3), (64, 64)), 1, 4)


@pytest.mark.parametrize("ks,widths", [
    (FLAGSHIP_KS, (5,) * 7), ((3, 7), (9, 9)), ((1, 64), (9, 1)),
    ((5,), (16,))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_weights_round_trip(ks, widths, dtype):
    ws, bs = stack(ks, widths)
    plan = simt_plan(256, [tuple(w.shape) for w in ws], 1, dtype.itemsize)
    flat = _pack(ws, bs, dtype, plan)
    assert flat.dtype == torch.float32
    assert flat.numel() == sum(lp.w_len for lp in plan.layers)
    for w, b, lp in zip(ws, bs, plan.layers):
        o, i, k = w.shape
        blk = flat[lp.w_off: lp.w_off + lp.w_len]
        nw = lp.n_og * i * k * lp.owp
        wp = blk[:nw].reshape(lp.n_og, i, k, lp.owp)[..., :lp.ow]
        back = wp.permute(0, 3, 1, 2).reshape(lp.n_og * lp.ow, i, k)
        assert torch.equal(back[:o], w.to(dtype).float())
        assert not back[o:].any()
        bias = blk[nw:].reshape(lp.n_og, lp.owp)[:, :lp.ow].reshape(-1)
        assert torch.equal(bias[:o], b) and not bias[o:].any()


def test_route_rule():
    ws, _ = stack(FLAGSHIP_KS, (5,) * 7)
    wide, _ = stack(FLAGSHIP_KS, (16,) * 7)
    assert kernel_for(256, ws, 1, torch.float32) is _cuda.CONV_STACK
    assert kernel_for(256, ws, 1, torch.bfloat16) is _cuda.CONV_STACK_MMA
    assert kernel_for(256, wide, 1, torch.bfloat16) is _cuda.CONV_STACK
    assert kernel_for(256, wide, 1, torch.float32) is _cuda.CONV_STACK


def emulate(x, ws, bs, padding, activation, dtype):
    """The kernel's arithmetic on the CPU, lane task by lane task: buffers
    whose pad rows alone start as zeros, skewed rows, the register window loaded one row per tap (a tap block
    of ``tt`` rows ahead, then the tail taps one at a time), f32 FMAs
    into ``[tt, ow]`` accumulators over the padded feature groups."""
    plan = simt_plan(x.shape[1], [tuple(w.shape) for w in ws], padding,
                     dtype.itemsize)
    flat = _pack(ws, bs, dtype, plan).numpy()
    act = _ACTIVATIONS[activation]
    store = lambda v: torch.as_tensor(v).to(dtype).float().numpy()  # noqa
    outs = []
    for sig in x:
        # what the kernel leaves unwritten holds anything: NaN here, so a
        # stale row that reached a kept output would show
        bufs = np.full((2, plan.max_feat, plan.pitch), np.nan, np.float32)
        for r in range(padding):
            bufs[:, :, skew(r)] = 0.0
            bufs[0, 0, skew(padding + x.shape[1] + r)] = 0.0
        rows = padding + np.arange(x.shape[1])
        bufs[0, 0, [skew(r) for r in rows]] = store(sig.numpy())
        cur, nxt = 0, 1
        for lp in plan.layers:
            blk = flat[lp.w_off: lp.w_off + lp.w_len]
            nw = lp.n_og * lp.in_feat * lp.k * lp.owp
            wl = blk[:nw].reshape(lp.n_og, lp.in_feat, lp.k, lp.owp)
            bl = blk[nw:].reshape(lp.n_og, lp.owp)
            tt, ow, k_n = lp.tt, lp.ow, lp.k
            for lane in simt_tasks(lp):
                for g, t0 in lane:
                    acc = np.zeros((tt, ow), np.float32)
                    for i in range(lp.in_feat):
                        col = bufs[cur, i]

                        def row(r):
                            return col[skew(r)]
                        a = [row(t0 + m) for m in range(tt)]
                        k = 0
                        while k + tt <= k_n:
                            b = [row(t0 + k + tt + m) for m in range(tt)]
                            win = np.array(a + b, np.float32)
                            for kk in range(tt):
                                acc += (win[kk: kk + tt, None]
                                        * wl[g, i, k + kk, None, :ow])
                            a = b
                            k += tt
                        while k < k_n:
                            acc += (np.array(a, np.float32)[:, None]
                                    * wl[g, i, k, None, :ow])
                            a = a[1:] + [row(t0 + k + tt)]
                            k += 1
                    y = act(torch.as_tensor(acc + bl[g, :ow])).numpy()
                    for j in range(tt):
                        t = t0 + j
                        for o in range(ow):
                            f = g * ow + o
                            if t < lp.t_out and f < lp.out_feat:
                                bufs[nxt, f, skew(padding + t)] = store(
                                    y[j, o])
            for f in range(lp.out_feat):
                for r in range(padding):
                    bufs[nxt, f, skew(padding + lp.t_out + r)] = 0.0
            cur, nxt = nxt, cur
        last = plan.layers[-1]
        idx = [skew(padding + t) for t in range(last.t_out)]
        outs.append(bufs[cur, :last.out_feat][:, idx].T)
    return torch.as_tensor(np.stack(outs))


@pytest.mark.parametrize("ks,widths,pad,length,act", [
    ((5, 33, 15), (5, 5, 1), 1, 80, "silu"),  # O = 1, a tail of taps
    ((3, 7), (9, 9), 2, 50, "tanh"),  # ragged feature groups
    ((16, 1), (4, 6), 0, 40, "relu"),  # K a multiple of the lane tile
])
@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, 5e-4, 1e-4), (torch.bfloat16, 3e-2, 2e-2)])
def test_emulated_lane_tasks_match_plain(ks, widths, pad, length, act, dtype,
                                         atol, rtol):
    ws, bs = stack(ks, widths, seed=2)
    x = torch.as_tensor(np.random.default_rng(3).normal(
        size=(2, length)).astype(np.float32))
    got = emulate(x, ws, bs, pad, act, dtype)
    want = conv_stack_reference(x, ws, bs, pad, act, dtype)
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
